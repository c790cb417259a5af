"""Vectorized material system.

Re-design of the reference's Material trait (src/materials.rs).
The reference point-evaluates trait objects (`approx(at) -> ColorMaterial`,
materials.rs:33-37/85-103); here evaluation gathers the per-object material
table and then applies every procedural texture branchlessly, selecting by
texture id — so GenerativeMaterial closures become pure batched functions
with no per-ray dispatch.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.scene.types import Scene
from raytracer_tpu.utils import vec

F32_EPS = vec.F32_EPS


@dataclasses.dataclass(frozen=True)
class MatSample:
    """Per-ray flattened material sample (ColorMaterial, materials.rs:20-31)."""

    diffuse: jnp.ndarray  # [N, 3]
    shiness: jnp.ndarray  # [N]
    specular: jnp.ndarray  # [N, 3]
    smoothness: jnp.ndarray  # [N]
    transparency: jnp.ndarray  # [N]
    refraction: jnp.ndarray  # [N]
    decay: jnp.ndarray  # [N] opaque_decay
    normal: jnp.ndarray  # [N, 3] tangent-space normal


MatSample = partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "diffuse", "shiness", "specular", "smoothness", "transparency",
        "refraction", "decay", "normal",
    ],
    meta_fields=[],
)(MatSample)


def eval_material(scene: Scene, textures, obj, uv) -> MatSample:
    """Gather + texture-evaluate materials for a hit batch.

    `textures` is the static texture tuple (scene/textures.py); texture id 0
    keeps the table's constant diffuse/normal.  All fields are packed into
    one [O, 14] table so a hit batch pays one row gather.
    """
    table = jnp.concatenate(
        [
            scene.mat_diffuse,  # 0:3
            scene.mat_shiness[:, None],  # 3
            scene.mat_specular,  # 4:7
            scene.mat_smoothness[:, None],  # 7
            scene.mat_transparency[:, None],  # 8
            scene.mat_refraction[:, None],  # 9
            scene.mat_decay[:, None],  # 10
            scene.mat_normal,  # 11:14
        ],
        axis=1,
    )  # [O, 14]
    m = table[obj]  # [N, 14]

    diffuse = m[:, 0:3]
    normal = m[:, 11:14]
    tex_id = scene.mat_tex[obj]
    for k in range(1, len(textures)):
        sel = (tex_id == k)[:, None]
        diffuse = jnp.where(sel, textures[k].diffuse(uv), diffuse)
        normal = jnp.where(sel, textures[k].normal(uv), normal)
    return MatSample(
        diffuse=diffuse,
        shiness=m[:, 3],
        specular=m[:, 4:7],
        smoothness=m[:, 7],
        transparency=m[:, 8],
        refraction=m[:, 9],
        decay=m[:, 10],
        normal=normal,
    )


def adjust_normal(mat: MatSample, hit_normal):
    """Bump mapping: rotate the tangent-space material normal into the frame
    whose +z is the shading normal (materials.rs:40-44)."""
    return vec.rotate_from_z(hit_normal, mat.normal)


def get_diffuse(mat: MatSample, normal, light_dir):
    """Lambert term (materials.rs:46-53); light_dir points toward the light."""
    cosine = vec.dot(light_dir, normal)
    return jnp.where((cosine > 0.0)[:, None], mat.diffuse * cosine[:, None], 0.0)


def get_specular(mat: MatSample, normal, light_dir, view_dir):
    """Phong lobe with exponent 1/(smoothness+eps) and (n+8)/(8pi) energy
    factor (materials.rs:55-66)."""
    cosine = vec.dot(light_dir, normal)
    reflected = 2.0 * cosine[:, None] * normal - light_dir
    e = 1.0 / (mat.smoothness + F32_EPS)
    energy = (e + 8.0) / (8.0 * np.pi)
    amount = jnp.power(jnp.maximum(vec.dot(reflected, view_dir), 0.0), e) * energy
    spec = mat.specular * amount[:, None]
    return jnp.where((cosine > 0.0)[:, None], spec, 0.0)
