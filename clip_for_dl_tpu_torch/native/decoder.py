"""JPEG, BMP, TIFF and Netpbm decoding on the host: the C++ library of
``native/src/`` (``decode.cpp`` for JPEG and BMP, ``tiff.cpp``, ``pnm.cpp``),
built with g++ at first use and called through ctypes.

The JAX package decodes every format but PNG with cv2 (``cv2.imread`` for a
file, ``cv2.imdecode`` for a request body); the port may not import cv2, so
this library decodes these formats to what cv2 returns, byte for byte (each
source's header says how). JPEG's Huffman decoding and TIFF's LZW run one
symbol after another, which Python would take seconds over for a 2320 x 2828
radiograph; in C++ it takes milliseconds, and ctypes drops the interpreter
lock for the call, so a thread pool decodes in parallel.

The build: ``$CXX`` (else ``g++`` on ``PATH``) with :data:`CXX_FLAGS`, the
sources and :data:`LIBS` (zlib, for TIFF's Deflate), into ``_kernel_build/``
as ``build_cache.cached_library`` names and shares it. A missing compiler or
a failed build raises; nothing falls back to a zero image.

A decode is two calls: the headers give the image's size, numpy allocates
it, and the library decodes into it; nothing else the size of the image is
held but what libjpeg holds, or one TIFF strip or tile (the sources' headers
say what).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .build_cache import BUILD_DIR, cached_library

SRC = Path(__file__).resolve().parent / "src"
SOURCES = tuple(SRC / name for name in ("decode.cpp", "tiff.cpp", "pnm.cpp"))
HEADERS = (SRC / "common.h",)
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-lz",)

# the status codes of cxr_open and cxr_finish
_OK, _UNDECODABLE, _REFUSED = 0, 1, 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}


class UnportedFormat(ValueError):
    """An image format (or a JPEG or TIFF variant) that cv2 reads and the
    port does not decode yet; the message names ROADMAP A2c."""


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the image decoder needs a C++ compiler: set CXX or put g++ on PATH")
    return cxx


def compile_library(path: Path, cxx: Optional[str] = None) -> str:
    """Compile the sources into ``path`` with one compiler call (through a
    temporary file renamed into place); returns the compiler's output.
    Raises if it fails."""
    cxx = cxx or _compiler()
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES), *LIBS],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the image decoder failed ({proc.returncode}):\n{log}")
    os.replace(tmp, path)
    return log


def library() -> ctypes.CDLL:
    """Compile (if needed) and load the decoder library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path, log = cached_library("cxr_decode", _compiler(), CXX_FLAGS + LIBS,
                                   SOURCES + HEADERS,
                                   lambda cxx, path: compile_library(path, cxx), BUILD_DIR)
        lib = ctypes.CDLL(str(path))
        lib.cxr_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
        lib.cxr_finish.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int]
        lib.cxr_open.restype = lib.cxr_finish.restype = ctypes.c_int
        lib.cxr_close.argtypes = [ctypes.c_void_p]
        lib.cxr_close.restype = None
        build_info.update(path=str(path), log=log)
        _lib = lib
        return lib


def decode(data: bytes, file: bool = False) -> Optional[np.ndarray]:
    """JPEG, BMP, TIFF or Netpbm bytes → RGB uint8 [H, W, 3], what cv2
    returns with its channels reversed, or None where cv2 returns None.
    ``file`` decodes as ``cv2.imread`` reads a file (a JPEG cut short reads
    on as libjpeg's fake EOI markers; an uncompressed TIFF tile reads whole)
    instead of as ``cv2.imdecode`` decodes a buffer (a JPEG cut short gives
    None; so does an uncompressed TIFF tile whose byte count rounded up to
    1024 is not its size). Raises :class:`UnportedFormat` for a variant cv2
    reads and this library does not."""
    lib = library()
    handle, h, w = ctypes.c_void_p(), ctypes.c_int(), ctypes.c_int()
    message = ctypes.create_string_buffer(256)
    status = lib.cxr_open(data, len(data), int(file), ctypes.byref(handle), ctypes.byref(h),
                          ctypes.byref(w), message, len(message))
    if status == _OK:
        try:
            out = np.empty((h.value, w.value, 3), np.uint8)
        except BaseException:
            lib.cxr_close(handle)
            raise
        status = lib.cxr_finish(handle, out.ctypes.data, message, len(message))
    if status == _REFUSED:
        raise UnportedFormat(message.value.decode())
    return out if status == _OK else None


__all__ = ["UnportedFormat", "compile_library", "decode", "library"]
