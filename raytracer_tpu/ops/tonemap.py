"""Percentile tone normalization.

Batched post_process (src/main.rs:748-762): collect per-pixel luma,
drop values failing Rust's f32::is_normal(), sort ascending, take the value
at index floor(0.99 * count), and divide the whole buffer by it when it
exceeds f32 EPSILON.  The reference runs this on the *accumulated* buffer
after every epoch (in-place renormalization) — callers here must do the
same (see parallel/progressive.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from raytracer_tpu.utils import color, vec


def luma_percentile_scale(img_flat, percentile: float = 0.99):
    """Return the reference's p98 divisor for [N, 3] linear RGB.

    Lanes failing is_normal() are excluded from the statistic (main.rs:751).
    Returns (value, valid_count).
    """
    l = color.luma(img_flat)
    valid = vec.is_normal_f32(l)
    count = jnp.sum(valid.astype(jnp.int32))
    sorted_l = jnp.sort(jnp.where(valid, l, jnp.inf))
    idx = (count.astype(jnp.float32) * percentile).astype(jnp.int32)  # trunc
    idx = jnp.clip(idx, 0, l.shape[0] - 1)
    return sorted_l[idx], count


def post_process(img, percentile: float = 0.99):
    """Normalize a [..., 3] linear image exactly like the reference."""
    flat = img.reshape(-1, 3)
    p98, count = luma_percentile_scale(flat, percentile)
    do = (p98 > vec.F32_EPS) & (count > 0)
    scale = jnp.where(do, 1.0 / p98, 1.0)
    return img * scale
