"""ctypes bindings for the native host kernels (native/tsar_native.cpp).

Auto-builds the shared library on first use (g++ is in the image); all
callers fall back to numpy/scipy implementations when the library is
unavailable.

The port's own copy of ``tsar_mvs_tpu.utils.native``
(same semantics, no jax).
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libtsar_native.so"
_lib = None
_tried = False


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not _LIB_PATH.exists():
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.tsar_cc_label.restype = ctypes.c_int32
        lib.tsar_cc_label.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
        lib.tsar_roberts.restype = None
        lib.tsar_roberts.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)]
        for name in ("tsar_hough_accumulate", "tsar_hough_subtract"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def cc_label(edges: np.ndarray) -> tuple[np.ndarray, int] | None:
    """Native Connect-semantics labeling; None if unavailable."""
    lib = load()
    if lib is None:
        return None
    edges = np.ascontiguousarray(edges, np.uint8)
    h, w = edges.shape
    labels = np.zeros((h, w), np.int32)
    n = lib.tsar_cc_label(_ptr(edges, ctypes.c_uint8), h, w,
                          _ptr(labels, ctypes.c_int32))
    return labels, int(n)


def roberts(img: np.ndarray) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    img = np.ascontiguousarray(np.clip(img, 0, 255), np.uint8)
    h, w = img.shape
    out = np.zeros((h, w), np.uint8)
    lib.tsar_roberts(_ptr(img, ctypes.c_uint8), h, w,
                     _ptr(out, ctypes.c_uint8))
    return out


def hough_accumulate(xs: np.ndarray, ys: np.ndarray, diag: int,
                     cos_t: np.ndarray, sin_t: np.ndarray,
                     acc: np.ndarray, subtract: bool = False) -> bool:
    lib = load()
    if lib is None:
        return False
    xs = np.ascontiguousarray(xs, np.int32)
    ys = np.ascontiguousarray(ys, np.int32)
    cos_t = np.ascontiguousarray(cos_t, np.float32)
    sin_t = np.ascontiguousarray(sin_t, np.float32)
    assert acc.dtype == np.int32 and acc.flags.c_contiguous
    fn = lib.tsar_hough_subtract if subtract else lib.tsar_hough_accumulate
    fn(_ptr(xs, ctypes.c_int32), _ptr(ys, ctypes.c_int32),
       np.int64(xs.size), np.int32(diag), np.int32(len(cos_t)),
       _ptr(cos_t, ctypes.c_float), _ptr(sin_t, ctypes.c_float),
       _ptr(acc, ctypes.c_int32))
    return True
