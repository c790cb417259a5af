"""Procedural texture registry.

The reference's GenerativeMaterial holds Rust closures diffuse_fn/normal_fn
evaluated per hit (src/materials.rs:69-103).  Here a texture is a
pair of pure batched functions uv[N,2] -> rgb[N,3] / normal[N,3]; materials
carry an integer texture id and evaluation is a branchless select over the
(small, static) texture set, so the whole material system stays vectorized.

Texture id 0 is reserved: "use the constant material table entry".
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Texture:
    name: str
    diffuse: Callable[[jnp.ndarray], jnp.ndarray]  # uv [N,2] -> rgb [N,3]
    normal: Callable[[jnp.ndarray], jnp.ndarray]  # uv [N,2] -> tangent n [N,3]


def _const_normal(uv):
    n = uv.shape[0]
    return jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 1.0], dtype=jnp.float32), (n, 3)
    )


def _trunc_i32(x):
    """Rust `as i32`: truncation toward zero."""
    return x.astype(jnp.int32)


def stripes_diffuse(uv):
    """Striped wall diffuse (reference: src/main.rs:848-854)."""
    band = _trunc_i32(uv[:, 1] * 20.0) % 2 == 0
    white = jnp.asarray([1.0, 1.0, 1.0], dtype=jnp.float32)
    blueish = jnp.asarray([0.5, 0.5, 1.0], dtype=jnp.float32)
    return jnp.where(band[:, None], white, blueish)


def stripes_normal(uv):
    """Corrugated bump normal (reference: src/main.rs:855-863)."""
    angle = uv[:, 0] * 10.0 * 2.0 * np.pi
    v = jnp.stack([jnp.sin(angle), jnp.zeros_like(angle), jnp.cos(angle)], axis=-1)
    # if v.z <= 0 flip so the tangent-space normal points outward
    flip = (v[:, 2] <= 0.0)[:, None]
    return jnp.where(flip, -v, v)


def checker_diffuse(uv):
    """Diagonal checker sphere diffuse (reference: src/main.rs:1019-1025)."""
    band = _trunc_i32((uv[:, 0] + uv[:, 1]) * 10.0) % 2 == 0
    red = jnp.asarray([1.0, 0.1, 0.1], dtype=jnp.float32)
    blue = jnp.asarray([0.1, 0.1, 1.0], dtype=jnp.float32)
    return jnp.where(band[:, None], red, blue)


# The default texture set used by the demo scenes.  Index 0 is the constant
# placeholder (its functions are never selected — material tables win).
DEFAULT_TEXTURES: Tuple[Texture, ...] = (
    Texture("const", diffuse=lambda uv: jnp.zeros((uv.shape[0], 3), jnp.float32), normal=_const_normal),
    Texture("stripes", diffuse=stripes_diffuse, normal=stripes_normal),
    Texture("checker", diffuse=checker_diffuse, normal=_const_normal),
)

TEXTURE_CONST = 0
TEXTURE_STRIPES = 1
TEXTURE_CHECKER = 2
