"""Color-space substrate: linear sRGB working space -> display sRGB.

Equivalent of the reference's use of the `palette` crate
(reference: src/image.rs:50-88 conversion, src/consts.rs named colors).
All colors are [..., 3] float32 arrays in *linear* sRGB, exactly like the
reference's LinSrgb working space.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Luminance weights of linear sRGB primaries (D65), matching palette's
# LinSrgb::into_luma() used by the percentile tone normalizer
# (reference: src/main.rs:748-762).
LUMA_WEIGHTS = np.array([0.212656, 0.715158, 0.072186], dtype=np.float32)

# Named colors (reference: src/consts.rs:2-22).
BLACK = np.array([0.0, 0.0, 0.0], dtype=np.float32)
WHITE = np.array([1.0, 1.0, 1.0], dtype=np.float32)
RED = np.array([1.0, 0.0, 0.0], dtype=np.float32)
GREEN = np.array([0.0, 1.0, 0.0], dtype=np.float32)
BLUE = np.array([0.0, 0.0, 1.0], dtype=np.float32)
YELLOW = np.array([1.0, 1.0, 0.0], dtype=np.float32)
CYAN = np.array([0.0, 1.0, 1.0], dtype=np.float32)
MAGENTA = np.array([1.0, 0.0, 1.0], dtype=np.float32)


def luma(rgb):
    """Linear-light luminance of [..., 3] linear sRGB."""
    w = jnp.asarray(LUMA_WEIGHTS, dtype=rgb.dtype)
    return jnp.sum(rgb * w, axis=-1)


def srgb_encode(linear):
    """Linear -> sRGB transfer function (gamma encode), clamped to [0, 1].

    Matches palette's Srgb encoding used when writing the PNG
    (reference: src/main.rs:766, src/image.rs:55-66).
    """
    x = jnp.clip(linear, 0.0, 1.0)
    lo = 12.92 * x
    hi = 1.055 * jnp.power(x, 1.0 / 2.4) - 0.055
    return jnp.where(x <= 0.0031308, lo, hi)


def srgb_decode(encoded):
    """sRGB -> linear transfer function (for loading golden images)."""
    x = jnp.clip(encoded, 0.0, 1.0)
    lo = x / 12.92
    hi = jnp.power((x + 0.055) / 1.055, 2.4)
    return jnp.where(x <= 0.04045, lo, hi)


def linear_to_u8(linear):
    """Linear [..., 3] f32 -> display sRGB u8, round-to-nearest."""
    enc = srgb_encode(linear)
    return jnp.round(enc * 255.0).astype(jnp.uint8)


def srgb_u8_to_linear(u8):
    """Display sRGB u8 -> linear f32 (inverse of linear_to_u8)."""
    return srgb_decode(u8.astype(jnp.float32) / 255.0)
