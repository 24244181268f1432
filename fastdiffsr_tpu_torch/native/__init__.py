"""The port's native image decoder: ctypes bindings for ``loader.cc``.

Counterpart of ``fastdiffsr_tpu/native`` with the same three functions
and signatures: :func:`image_dims`, :func:`decode_rgb` (uint8 HWC RGB,
libpng / libjpeg) and :func:`load_batch_f32` (a float32 NHWC batch
``x / 255 * scale + offset``, per-image horizontal flips, decoded on
``n_threads`` threads). Each returns None where the library is
unavailable or the file does not decode, and the caller then decodes
with PIL, as ``data/dataset.py`` does.

The library is built from this directory's ``loader.cc`` at first use
with the system ``g++`` into ``build/native/<digest>/`` at the
repository root (listed in ``.gitignore``), ``<digest>`` hashing the
source and the flags, so an edited source is rebuilt; processes that
reach the first use together build once, behind a file lock. A build
that fails is logged once, with the compiler's message, and the process
then decodes with PIL.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "loader.cc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parent.parent.parent
             / "build" / "native")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lpng", "-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# why the library is missing (None once it loaded or before the first use)
FAILURE: Optional[str] = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / _digest() / "libfdsr_loader.so"


def build() -> pathlib.Path:
    """Compile ``loader.cc`` (unless this source was built already) and
    return the library's path; raises RuntimeError with the compiler's
    message when ``g++`` fails or is missing."""
    lib_path = library_path()
    if lib_path.is_file():
        return lib_path
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with open(lib_path.parent.parent / f"{lib_path.parent.name}.lock",
              "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)         # released when it closes
        if lib_path.is_file():
            return lib_path
        tmp = lib_path.with_name(f"libfdsr_loader.{os.getpid()}.so")
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
        try:
            res = subprocess.run(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True,
                                 timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):"
                               f"\n{res.stdout}")
        os.replace(tmp, lib_path)
    return lib_path


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first call; None (logged once, the
    reason in ``FAILURE``) where it does not build or load."""
    global _lib, _tried, FAILURE
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            FAILURE = str(e)
            logging.getLogger(__name__).warning(
                "the native PNG/JPEG decoder is unavailable, images decode "
                "with PIL: %s", FAILURE)
            return None
        c_int_p = ctypes.POINTER(ctypes.c_int)
        lib.image_dims.argtypes = [ctypes.c_char_p, c_int_p, c_int_p]
        lib.image_dims.restype = ctypes.c_int
        lib.decode_rgb.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.c_int, ctypes.c_int]
        lib.decode_rgb.restype = ctypes.c_int
        lib.load_batch_f32.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.load_batch_f32.restype = ctypes.c_int
        _lib = lib
        return _lib


def image_dims(path: str):
    """(width, height) of a PNG or JPEG file, or None."""
    lib = get_lib()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.image_dims(path.encode(), ctypes.byref(w), ctypes.byref(h)):
        return None
    return w.value, h.value


def decode_rgb(path: str):
    """uint8 (H, W, 3), or None on failure."""
    lib = get_lib()
    dims = None if lib is None else image_dims(path)
    if dims is None:
        return None
    w, h = dims
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.decode_rgb(path.encode(),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        w, h)
    return out if rc == 0 else None


def load_batch_f32(paths, width: int, height: int, scale: float = 2.0,
                   offset: float = -1.0, flips=None, n_threads: int = 4):
    """float32 (N, H, W, 3) batch: y = x/255*scale + offset, image i
    flipped horizontally where ``flips[i]``; or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    out = np.empty((n, height, width, 3), np.float32)
    if flips is not None:
        flips = np.ascontiguousarray(flips, np.uint8)
        if flips.shape != (n,):
            raise ValueError(f"flips of shape {flips.shape} for {n} paths")
        fptr = flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    else:
        fptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
    rc = lib.load_batch_f32(
        arr, n, width, height, ctypes.c_float(scale),
        ctypes.c_float(offset), fptr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    return out if rc == 0 else None
