"""ctypes loader for the native encoder library ``native/libfastimg.so``
(libpng PNG writer, libheif AVIF writer; source ``native/fastimg.cpp``,
built by ``native/Makefile``).  When the library is missing, it is built
once with ``make``; if that fails, ``available()`` is False and Pillow
encodes instead.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "native", "libfastimg.so")


def _try_build(path: str) -> None:
    src_dir = os.path.dirname(path)
    if not os.path.exists(os.path.join(src_dir, "fastimg.cpp")) \
            or shutil.which("make") is None:
        return
    try:
        subprocess.run(["make", "-C", src_dir, "libfastimg.so"],
                       capture_output=True, timeout=120, check=False)
    except (OSError, subprocess.TimeoutExpired):
        pass


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        _try_build(path)
    if not os.path.exists(path):
        return None
    u8p, i = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int
    try:
        lib = ctypes.CDLL(path)
        lib.fastimg_write_png.argtypes = [ctypes.c_char_p, u8p, i, i, i]
        lib.fastimg_write_png.restype = i
        lib.fastimg_avif_available.argtypes = []
        lib.fastimg_avif_available.restype = i
        lib.fastimg_write_avif.argtypes = [ctypes.c_char_p, u8p, i, i, i, i]
        lib.fastimg_write_avif.restype = i
    except (OSError, AttributeError):
        return None
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def avif_available() -> bool:
    lib = _load()
    return lib is not None and bool(lib.fastimg_avif_available())


def _checked(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    return img


def write_png(img: np.ndarray, path: str, compression: int = 6) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError("native encoder not built")
    img = _checked(img)
    h, w, _ = img.shape
    rc = lib.fastimg_write_png(path.encode(),
                               img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                               w, h, compression)
    if rc != 0:
        raise RuntimeError(f"native PNG encode failed (rc={rc})")


def write_avif(img: np.ndarray, path: str, quality: int = 100,
               speed: int = 8) -> None:
    lib = _load()
    if lib is None or not lib.fastimg_avif_available():
        raise RuntimeError("native AVIF encoder not available")
    img = _checked(img)
    h, w, _ = img.shape
    rc = lib.fastimg_write_avif(path.encode(),
                                img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                w, h, quality, speed)
    if rc != 0:
        raise RuntimeError(f"native AVIF encode failed (rc={rc})")
