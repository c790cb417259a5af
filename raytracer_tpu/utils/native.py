"""ctypes bindings for the C++ host runtime (native/libraytpu_host.so).

The reference is a fully native (Rust) binary; in this framework the device
compute path is JAX/XLA, and the host-side runtime around it — sRGB
encoding, PNG export, percentile statistics — is C++ (native/src/host.cpp),
bound here via ctypes.  Every entry point has a pure-Python fallback so the
framework works before/without building the library.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False

_CANDIDATES = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "libraytpu_host.so"),
    os.path.join(os.path.dirname(__file__), "libraytpu_host.so"),
]


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("RAYTPU_NO_NATIVE"):
        return None
    for cand in _CANDIDATES:
        path = os.path.abspath(cand)
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                continue
            lib.rt_srgb_encode_u8.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_size_t,
            ]
            lib.rt_write_png_atomic.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_uint32,
                ctypes.c_uint32,
            ]
            lib.rt_write_png_atomic.restype = ctypes.c_int
            lib.rt_luma_percentile.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_size_t,
                ctypes.c_float,
            ]
            lib.rt_luma_percentile.restype = ctypes.c_float
            _LIB = lib
            break
    return _LIB


def available() -> bool:
    return _load() is not None


def srgb_encode_u8(linear: np.ndarray) -> np.ndarray:
    """Linear f32 [..., 3] -> sRGB u8, via the native runtime."""
    lib = _load()
    linear = np.ascontiguousarray(linear, dtype=np.float32)
    out = np.empty(linear.shape, dtype=np.uint8)
    lib.rt_srgb_encode_u8(
        linear.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        linear.size,
    )
    return out


def write_png_atomic(path: str, rgb: np.ndarray) -> None:
    lib = _load()
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    rc = lib.rt_write_png_atomic(
        path.encode(), rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h
    )
    if rc != 0:
        raise OSError(f"native PNG write failed (rc={rc}) for {path}")


def luma_percentile(rgb_flat: np.ndarray, q: float) -> float:
    """Percentile of per-pixel luma with Rust is_normal() filtering.

    Host-side implementation of the tone normalizer statistic
    (reference: src/main.rs:748-762).
    """
    lib = _load()
    rgb_flat = np.ascontiguousarray(rgb_flat, dtype=np.float32)
    n = rgb_flat.size // 3
    return float(
        lib.rt_luma_percentile(
            rgb_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, q
        )
    )
