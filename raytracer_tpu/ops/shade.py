"""Direct lighting with batched shadow rays.

Batched World::get_shade (src/main.rs:407-464): bump-map the normal,
approximate each light to a directional sample, test occlusion per light
(the reference's nearest-hit-vs-light-origin check is equivalent to an
any-hit predicate bounded by the light distance, src/main.rs:435-448), then
Lambert + Phong blended by shiness (450-462).
"""

from __future__ import annotations

import jax.numpy as jnp

from raytracer_tpu.ops import materials as mat_ops
from raytracer_tpu.ops.intersect import cast_any_hit
from raytracer_tpu.ops.lights import approximate_directional
from raytracer_tpu.scene.types import FACE_BACK, Hits, Rays, Scene
from raytracer_tpu.utils import vec


def get_shade(
    scene: Scene,
    textures,
    pos,
    normal,
    uv,
    prim,
    obj,
    ray_d,
    active,
    counters=None,
):
    """Direct radiance at a hit batch.

    pos/normal/uv/prim/obj describe the hits; ray_d is the incoming ray
    direction (for the view vector).  Lanes with active=False return 0.
    Returns [N, 3].
    """
    n = pos.shape[0]
    L = scene.n_light
    mat = mat_ops.eval_material(scene, textures, obj, uv)
    n_adj = mat_ops.adjust_normal(mat, normal)

    lights = approximate_directional(scene, pos)

    # Per-light shadow-ray parameters (reference loop body, 413-448)
    considers = []
    limits = []
    cosines = []
    for li in range(L):
        ldir = lights.direction[:, li]
        cosine = -vec.dot(ldir, n_adj)
        consider = active & lights.valid[:, li] & (cosine > 0.0)
        has_origin = lights.has_origin[li] > 0.5
        light_dist = vec.distance(pos, lights.origin[li][None, :])
        limit = jnp.where(has_origin, light_dist, jnp.inf)
        considers.append(consider)
        limits.append(limit)
        cosines.append(cosine)

    blocked_list = []
    for li in range(L):
        shadow_rays = Rays(
            o=pos,
            d=-lights.direction[:, li],
            face=jnp.full((n,), FACE_BACK, jnp.int32),
            excl_prim=prim,
            excl_face=jnp.full((n,), FACE_BACK, jnp.int32),
        )
        blocked_list.append(
            cast_any_hit(scene, shadow_rays, active=considers[li],
                         limit=limits[li])
        )

    total = jnp.zeros((n, 3), pos.dtype)
    for li in range(L):
        if counters is not None:
            counters.append(jnp.sum(considers[li]))
        lit = considers[li] & ~blocked_list[li]
        lcol = lights.color[:, li]
        light_to_point = -lights.direction[:, li]  # probe.light_direction
        view = -ray_d
        diffuse = mat_ops.get_diffuse(mat, n_adj, light_to_point) * lcol
        specular = mat_ops.get_specular(mat, n_adj, light_to_point, view) * lcol
        contrib = (
            diffuse * (1.0 - mat.shiness)[:, None]
            + specular * mat.shiness[:, None]
        )
        total = total + jnp.where(lit[:, None], contrib, 0.0)

    return total


def get_shade_hits(scene, textures, hits: Hits, ray_d, active, counters=None):
    return get_shade(
        scene, textures, hits.pos, hits.normal, hits.uv, hits.prim, hits.obj,
        ray_d, active, counters,
    )
