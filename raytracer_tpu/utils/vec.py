"""Batched 3-vector math on trailing-dim-3 arrays.

Substrate for the reference's cgmath usage (reference:
src/geometric.rs, src/main.rs).  Everything here operates on arrays of shape
[..., 3] so the whole renderer stays SoA / vectorized — there is no scalar
Vec3 type anywhere in the framework.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# f32 machine epsilon — mirrors Rust's std::f32::EPSILON used throughout the
# reference (materials.rs:61, lights.rs:63-64).
F32_EPS = float(np.finfo(np.float32).eps)
# Smallest positive normal f32 — Rust's f32::is_normal() lower bound
# (main.rs:1157-1160 photon filter, main.rs:751 luma filter).
F32_TINY = float(np.finfo(np.float32).tiny)


def dot(a, b):
    """Row-wise dot product of [..., 3] arrays -> [...]."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    """Row-wise cross product of [..., 3] arrays."""
    return jnp.cross(a, b)


def norm(a):
    """Euclidean length of [..., 3] -> [...]."""
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a):
    """Normalize [..., 3]; zero vectors produce inf/nan like cgmath would."""
    return a / norm(a)[..., None]


def normalize_safe(a, eps: float = 0.0):
    """Normalize, returning the input scaled by 1/(|a|+eps)."""
    return a / (norm(a)[..., None] + eps)


def reflect(direction, normal):
    """Mirror `direction` about `normal`: l - 2 (l.n) n.

    Semantics of the reference reflect closure (main.rs:329).
    """
    return direction - 2.0 * dot(direction, normal)[..., None] * normal


def rotate_from_z(n, v):
    """Apply to `v` the rotation that takes +z onto `n` (both [..., 3]).

    Replicates cgmath's Quaternion::from_arc(z, n, None) followed by
    quaternion rotation, as used for tangent-space bump mapping
    (materials.rs:40-44) and lobe scattering (main.rs:545-549).

    For the antiparallel case (n ~ -z) cgmath picks the fallback axis
    normalize(unit_x × z) = (0, -1, 0) and rotates by pi, which maps
    v -> (-v.x, v.y, -v.z).
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    # Quaternion q = (w, xyz) with w = 1 + z.n, xyz = z × n (unnormalized).
    qw = 1.0 + nz
    qx = -ny
    qy = nx
    # qz = 0 by construction (z × n has zero z-component).
    # Guarded against the antiparallel singularity (that branch is replaced
    # by the explicit flip below anyway).
    q2 = jnp.maximum(qw * qw + qx * qx + qy * qy, 1e-12)  # |q|^2
    qv = jnp.stack([qx, qy, jnp.zeros_like(qx)], axis=-1)
    # v' = v + (2/|q|^2) * qv × (qv × v + w v)
    t = cross(qv, v) + qw[..., None] * v
    rotated = v + (2.0 / q2)[..., None] * cross(qv, t)

    # Antiparallel fallback: rotation by pi around (0, -1, 0).
    flipped = jnp.stack([-v[..., 0], v[..., 1], -v[..., 2]], axis=-1)

    anti = (nz < -1.0 + 1e-6)[..., None]
    return jnp.where(anti, flipped, rotated)


def distance(a, b):
    """|a - b| for [..., 3] arrays."""
    return norm(a - b)


def is_normal_f32(x):
    """Rust f32::is_normal(): finite, non-zero, non-subnormal."""
    return jnp.isfinite(x) & (jnp.abs(x) >= F32_TINY)
