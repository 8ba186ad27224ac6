"""Build and load the port's hand-written CUDA kernels.

``lvt_tpu_torch/csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded through ``ctypes``. The
build runs at first use, into ``build/lvt_tpu_torch/`` at the repository
root, and is redone whenever the sources change (the library's file name
carries a hash of them). Nothing here runs at import time: this module is
imported on machines with no CUDA toolkit, where only the kernels' plain
versions run.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "lvt_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "lvt_block_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "lvt_decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "lvt_block_attention_bwd": [_P] * 11 + [_I] * 6 + [_F, _P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of lvt_tpu_torch cannot be built")
    return found


class KernelLibrary:
    """The compiled library, built once per process and per source hash."""

    def __init__(self):
        self._lib = None
        self._lock = threading.Lock()
        self.build_seconds = 0.0
        self.build_log = ""
        self.path = ""

    def sources(self):
        return sorted(glob.glob(os.path.join(CSRC, "*.cu")))

    def _digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in self.sources():
            with open(src, "rb") as f:
                h.update(os.path.basename(src).encode() + b"\0" + f.read())
        return h.hexdigest()[:16]

    def build(self) -> str:
        """Compile csrc/*.cu unless a library of the same sources exists."""
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, f"liblvt_kernels_{self._digest()}.so")
        if os.path.exists(path):
            return path
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *self.sources()]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{self.build_log}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        self.build_seconds = time.perf_counter() - t0
        return path

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.path = self.build()
                lib = ctypes.CDLL(self.path)
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


LIBRARY = KernelLibrary()


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel's launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
