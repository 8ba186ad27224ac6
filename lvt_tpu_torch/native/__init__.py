"""ctypes bindings for the native IO functions of ``lvt_io.cpp`` (counterpart
of lvt_tpu/native/__init__.py; the source is a copy of lvt_tpu's).

``read_png_rgb`` decodes an 8-bit non-interlaced PNG (gray, RGB, palette,
RGBA) to (H, W, 3) uint8 with zlib, the same pixels PIL's
``convert("RGB")`` gives; ``load_npy_sequence_i32`` reads a video's latent
``.npy`` files into one int32 buffer. Each returns None where the native
path cannot serve the file (or the library is not there), and the caller
falls back to PIL / numpy.

The library is built with g++ at first use, into ``build/lvt_tpu_torch/`` at
the repository root, under a name that carries a hash of the source and the
flags; it is written to a temporary file and renamed into place, so that
processes that build at once never load a half-written file. The data
loader builds it in the parent before its worker processes start
(``data/build.py``). Where g++ or zlib is missing, the first call logs one
WARNING and every call returns None.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lvt_io.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(SOURCE))), "build",
                         "lvt_tpu_torch")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


class NativeIO:
    """The compiled library, built and loaded once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self._tried = False
        self.path = ""

    def build(self) -> str:
        """Compile lvt_io.cpp unless a library of the same source exists;
        returns its path. Raises if g++ fails or is missing."""
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + f.read()).hexdigest()
        path = os.path.join(BUILD_DIR, f"liblvt_io_{digest[:16]}.so")
        if os.path.exists(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp, "-lz"], check=True,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    def get(self):
        """The loaded library, or None (with one WARNING) where it cannot be
        built or loaded."""
        with self._lock:
            if not self._tried:
                self._tried = True
                try:
                    self.path = self.build()
                    lib = ctypes.CDLL(self.path)
                except (OSError, subprocess.CalledProcessError) as e:
                    detail = getattr(e, "output", "") or e
                    logger.warning(f"native lvt_io unavailable, frames and latents are read with "
                                   f"PIL and numpy: {detail}")
                    return None
                lib.decode_png_file_rgb.restype = ctypes.c_int
                lib.decode_png_file_rgb.argtypes = [
                    ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long,
                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
                lib.load_npy_i32_sequence.restype = ctypes.c_long
                lib.load_npy_i32_sequence.argtypes = [
                    ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_long]
                self._lib = lib
            return self._lib


LIBRARY = NativeIO()


def available() -> bool:
    """Whether the native library is built and loaded (building it if not)."""
    return LIBRARY.get() is not None


def read_png_rgb(path: str) -> Optional[np.ndarray]:
    """Decode a PNG to (H, W, 3) uint8, or None if the native path can't."""
    lib = LIBRARY.get()
    if lib is None:
        return None
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    name = path.encode()
    if lib.decode_png_file_rgb(name, None, 0, ctypes.byref(w), ctypes.byref(h)) != 0:
        return None  # the dimensions only
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.decode_png_file_rgb(name, out.ctypes.data, out.nbytes, ctypes.byref(w),
                               ctypes.byref(h)) != 0:
        return None
    return out


def load_npy_sequence_i32(paths: List[str], per_file_shape) -> Optional[np.ndarray]:
    """Load N same-shape int32 or int64 .npy files -> (N, *per_file_shape)
    int32, or None if the native path can't."""
    lib = LIBRARY.get()
    if lib is None:
        return None
    per = int(np.prod(per_file_shape))
    out = np.empty((len(paths), per), np.int32)
    joined = "\n".join(paths).encode()
    if lib.load_npy_i32_sequence(joined, len(paths), out.ctypes.data, out.size) != per:
        return None
    return out.reshape((len(paths),) + tuple(per_file_shape))
