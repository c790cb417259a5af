"""Vectorized light evaluation.

Batched form of ApproximateIntoDirectional (src/lights.rs:44-93): every
light type collapses to a per-shading-point directional sample {direction,
color, validity}, evaluated for all (point, light) pairs at once.  Note the
reference's 1/d (not 1/d^2) distance attenuation for spot and point lights
(lights.rs:64, 76) — kept as-is for parity.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from raytracer_tpu.scene.types import (
    LIGHT_DIRECTIONAL,
    LIGHT_SPOT,
    Scene,
)
from raytracer_tpu.utils import vec

F32_EPS = vec.F32_EPS


@dataclasses.dataclass(frozen=True)
class LightSamples:
    """Directional approximations for all (point, light) pairs."""

    valid: jnp.ndarray  # [N, L] (False: spot cone cutoff, lights.rs:58-61)
    direction: jnp.ndarray  # [N, L, 3] from light toward the point
    color: jnp.ndarray  # [N, L, 3] attenuated color
    has_origin: jnp.ndarray  # [L] bool-ish float (1.0 for spot/point)
    origin: jnp.ndarray  # [L, 3]


LightSamples = partial(
    jax.tree_util.register_dataclass,
    data_fields=["valid", "direction", "color", "has_origin", "origin"],
    meta_fields=[],
)(LightSamples)


def approximate_directional(scene: Scene, position) -> LightSamples:
    """position: [N, 3] -> samples for every light (lights.rs:85-93)."""
    n = position.shape[0]
    L = scene.n_light
    ltype = scene.light_type[None, :]  # [1, L]

    offset = position[:, None, :] - scene.light_origin[None, :, :]  # [N, L, 3]
    mag = vec.norm(offset)  # [N, L]
    offset_dir = offset / jnp.maximum(mag, 1e-30)[..., None]

    # Spot: angle between cone axis and offset (lights.rs:54-71)
    cos_ang = jnp.sum(scene.light_dir[None, :, :] * offset, axis=-1) / jnp.maximum(
        mag, 1e-30
    )
    angle = jnp.abs(jnp.arccos(jnp.clip(cos_ang, -1.0, 1.0)))
    spread = scene.light_angle[None, :]
    in_cone = angle <= spread
    ang_att = jnp.power(
        jnp.maximum(1.0 - angle / jnp.maximum(spread, 1e-30), 0.0),
        scene.light_softness[None, :] + F32_EPS,
    )
    dist_att = 1.0 / (mag + F32_EPS)

    is_dir = ltype == LIGHT_DIRECTIONAL
    is_spot = ltype == LIGHT_SPOT

    att = jnp.where(is_dir, 1.0, jnp.where(is_spot, ang_att * dist_att, dist_att))
    direction = jnp.where(
        is_dir[..., None],
        jnp.broadcast_to(scene.light_dir[None, :, :], (n, L, 3)),
        offset_dir,
    )
    color = scene.light_color[None, :, :] * att[..., None]
    valid = jnp.where(is_spot, in_cone, True)

    return LightSamples(
        valid=valid,
        direction=direction,
        color=color,
        has_origin=scene.light_has_origin,
        origin=scene.light_origin,
    )
