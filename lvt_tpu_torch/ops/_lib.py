"""Build and load the port's hand-written CUDA kernels.

Each ``lvt_tpu_torch/csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, loaded through
``ctypes``; the compilers run side by side. The build runs at first use,
into ``build/lvt_tpu_torch/`` at the repository root, and is redone whenever
a source or a header (``*.cuh``) changes (the libraries' file names carry a
hash of them all). Nothing here runs at import time: this module is
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
import types

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "lvt_tpu_torch")
CARD_SMS = 132  # streaming multiprocessors of the NVIDIA H100 SXM: the launch plans' unit
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of csrc/*.cu (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "lvt_block_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "lvt_decode_attention": [_P] * 5 + [_I] * 7 + [_F, _P],
    "lvt_block_attention_bwd": [_P] * 11 + [_I] * 6 + [_F, _P],
    "lvt_fused_layer_fwd": [_P] * 17 + [_I] * 7 + [_F, _P],
    "lvt_ffn_half_bwd": [_P] * 14 + [_I] * 4 + [_P],
    "lvt_attn_half_bwd": [_P] * 19 + [_I] * 8 + [_F, _P],
    "lvt_decode_attention_i8": [_P] * 8 + [_I] * 10 + [_F, _P],
    "lvt_decode_attention_i8_live": [_P] * 8 + [_I] * 12 + [_F, _P],
    "lvt_decode_attention_i8_step": [_P, _P, _L, _L] + [_P] * 8 + [_I] * 10 + [_F, _P],
    "lvt_decode_attention_i8_live_step": [_P, _P, _L, _L] + [_P] * 8 + [_I] * 12 + [_F, _P],
    "lvt_cache_attention_i8": [_P] * 7 + [_I] * 11 + [_F, _P],
    "lvt_matmul_i8w": [_P] * 5 + [_I] * 7 + [_P],
    "lvt_nearest_indices_grouped": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I, _P],
    "lvt_decode_attention_i8kv": [_P] * 7 + [_I] * 11 + [_F, _P],
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
    """The compiled libraries, built once per process and per source hash."""

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
        for src in self.sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
            with open(src, "rb") as f:
                h.update(os.path.basename(src).encode() + b"\0" + f.read())
        return h.hexdigest()[:16]

    def build(self):
        """Compile each csrc/*.cu, all at once, unless a library of the same
        sources exists. Returns the libraries' paths."""
        os.makedirs(BUILD_DIR, exist_ok=True)
        digest = self._digest()
        paths, running = [], []
        t0 = time.perf_counter()
        for src in self.sources():
            stem = os.path.splitext(os.path.basename(src))[0]
            path = os.path.join(BUILD_DIR, f"liblvt_{stem}_{digest}.so")
            paths.append(path)
            if os.path.exists(path):
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            running.append((cmd, tmp, path, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for cmd, tmp, path, proc in running:
            log = proc.communicate()[0]
            self.build_log += log
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
            else:
                os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        if failed:
            raise RuntimeError("\n".join(failed))
        if running:
            self.build_seconds = time.perf_counter() - t0
        return paths

    def get(self) -> types.SimpleNamespace:
        """The C functions of every library, by name."""
        with self._lock:
            if self._lib is None:
                paths = self.build()
                self.path = os.path.dirname(paths[0])
                libs = [ctypes.CDLL(p) for p in paths]
                fns = types.SimpleNamespace()
                for name, argtypes in _SIGNATURES.items():
                    fn = next((getattr(lib, name) for lib in libs if hasattr(lib, name)), None)
                    if fn is None:
                        raise RuntimeError(f"{name}: in none of {paths}")
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    setattr(fns, name, fn)
                self._lib = fns
            return self._lib


LIBRARY = KernelLibrary()


# every kernel wrapper, each with its count of launches ``fn.launches``
COUNTED = []


def counted(fn):
    """Give a kernel's wrapper its launch count, ``fn.launches``, which the
    wrapper raises by one where it launches its kernel, and list it in
    ``COUNTED``: a CUDA graph that replays launches adds them to the counts
    (``models/rollout_graph.py``), so a count stays one of launches on the
    device."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel's launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
