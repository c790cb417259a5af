"""Distributed (Monte-Carlo) tracer — DoF + stochastic scatter pass.

Re-design of World::distributed_ray_trace (src/main.rs:521-614).
The reference recursion picks ONE branch per bounce by Russian roulette and
combines results as ret = A + B * ret_child with per-branch (A, B):

  diffuse/reflect hit   : A = 0.5*shade(next),        B = 0.5*brdf
  diffuse/reflect miss  : A = shade(scattered self),  B = 0
  refract escape + hit  : A = decay^t * shade(next),  B = decay^t
  cosine<=0 / trapped / escape-miss / refract-escape-miss: A = B = 0
  depth exhausted       : A = shade(self),            B = 0

That linear recurrence unrolls forward: walk the path keeping (accum,
scale); per bounce accum += scale*A and scale *= B.  All three branches are
evaluated masked in one pass over the ray batch: the refract lanes run the
shared interior march (ops/trace.refract_march), then ONE advance cast and
ONE merged shade evaluation serve every branch.

RNG: the reference keeps 1.2M persistent IsaacRngs seeded y*2^33+x
(src/main.rs:1117-1127); here keys are counter-based jax.random, folded
per (epoch, bounce), so checkpoint/resume needs only the epoch index.
The roulette (652-666) and the scatter lobe phi=acos((1-u)^exp),
theta~U(-pi,pi) rotated from +z (539-554) match the reference exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.config import RenderConfig
from raytracer_tpu.ops import materials as mat_ops
from raytracer_tpu.ops.intersect import cast
from raytracer_tpu.ops.shade import get_shade
from raytracer_tpu.ops.trace import refract_march
from raytracer_tpu.scene.types import (
    FACE_BACK,
    FACE_FRONT,
    Rays,
    Scene,
)
from raytracer_tpu.utils import vec

SEL_DIFFUSE = 0
SEL_REFLECT = 1
SEL_REFRACT = 2


def roulette(u, w0, w1, w2):
    """weighted_select over 3 weights (src/main.rs:652-666): r ~ U(0, sum),
    first cumulative bucket wins."""
    r = u * (w0 + w1 + w2)
    return jnp.where(r < w0, SEL_DIFFUSE, jnp.where(r < w0 + w1, SEL_REFLECT, SEL_REFRACT))


def scatter_direction(u_phi, u_theta, axis, exponent):
    """Lobe sample around `axis` (src/main.rs:539-554): phi =
    acos((1-u)^exponent), theta ~ U(-pi, pi), rotated from +z onto axis."""
    phi = jnp.arccos(jnp.power(1.0 - u_phi, exponent))
    theta = u_theta  # already in (-pi, pi)
    sp = jnp.sin(phi)
    sph = jnp.stack([sp * jnp.cos(theta), sp * jnp.sin(theta), jnp.cos(phi)], axis=-1)
    axis_n = axis / jnp.maximum(vec.norm(axis), 1e-30)[:, None]
    return vec.rotate_from_z(axis_n, sph)


class MCResult(NamedTuple):
    photon: jnp.ndarray  # [N, 3] (non-is_normal photons zeroed)
    casts: jnp.ndarray  # scalar
    filtered: jnp.ndarray  # scalar: photons dropped by the is_normal filter


def trace_distributed(
    scene: Scene,
    textures,
    ray_o,
    ray_d,
    key,
    cfg: RenderConfig,
) -> MCResult:
    """One stochastic sample per primary ray (one reference 'epoch' worth).

    Matches main.rs:1150-1160: primary cast, distributed_ray_trace(depth),
    then the f32::is_normal photon filter (drops any photon with a zero /
    subnormal / non-finite channel — including all-black misses).
    """
    n = ray_o.shape[0]

    # Pre-draw the 3 per-bounce uniforms: fold_in per step, split 3.
    # Threefry draws are counter-based, so every backend walks the same
    # random decisions for the same key.
    draws = []
    for step in range(cfg.depth):
        kstep = jax.random.fold_in(key, step)
        k_sel, k_phi, k_theta = jax.random.split(kstep, 3)
        draws.append(jnp.stack([
            jax.random.uniform(k_sel, (n,), ray_o.dtype),
            jax.random.uniform(k_phi, (n,), ray_o.dtype),
            jax.random.uniform(k_theta, (n,), ray_o.dtype,
                               minval=-np.pi, maxval=np.pi),
        ]))
    unifs = (jnp.stack(draws) if draws
             else jnp.zeros((0, 3, n), ray_o.dtype))

    casts = jnp.zeros((), jnp.int32)

    rays = Rays.primary(ray_o, ray_d)
    h = cast(scene, rays)
    casts = casts + n

    state = dict(
        alive=h.valid,
        accum=jnp.zeros((n, 3), ray_o.dtype),
        scale=jnp.ones((n, 3), ray_o.dtype),
        cur_pos=h.pos, cur_normal=h.normal, cur_uv=h.uv,
        cur_prim=h.prim, cur_obj=h.obj, cur_back=h.backface,
        cur_ray_d=ray_d,
        cur_ray_face=jnp.full((n,), FACE_FRONT, jnp.int32),
        casts=casts,
    )

    def step_body(step, s):
        # One bounce of the roulette walk; a single traced body executed
        # cfg.depth times keeps the XLA graph small.
        alive, accum, scale = s["alive"], s["accum"], s["scale"]
        cur_pos, cur_normal, cur_uv = s["cur_pos"], s["cur_normal"], s["cur_uv"]
        cur_prim, cur_obj, cur_back = s["cur_prim"], s["cur_obj"], s["cur_back"]
        cur_ray_d, cur_ray_face = s["cur_ray_d"], s["cur_ray_face"]
        casts = s["casts"]

        mat = mat_ops.eval_material(scene, textures, cur_obj, cur_uv)
        w0 = (1.0 - mat.shiness) * (1.0 - mat.transparency)
        w1 = mat.shiness * (1.0 - mat.transparency)
        w2 = mat.transparency
        u = unifs[step, 0]
        sel = roulette(u, w0, w1, w2)

        # Scatter lobe: diffuse around -normal with exponent 1, glossy
        # around the incoming direction with exponent smoothness (558, 577,
        # 596).
        exponent = jnp.where(sel == SEL_DIFFUSE, 1.0, mat.smoothness)
        axis = jnp.where((sel == SEL_DIFFUSE)[:, None], -cur_normal, cur_ray_d)
        u_phi = unifs[step, 1]
        u_theta = unifs[step, 2]
        sdir = scatter_direction(u_phi, u_theta, axis, exponent)

        cosine = -vec.dot(cur_normal, sdir)
        live = alive & (cosine > 0.0)  # cosine<=0 kills the path (560, 579, 598)

        # Advance ray per branch:
        #  - diffuse/reflect: mirror the scattered direction about the
        #    normal (get_reflect on the scattered hit, 563/582)
        refl = vec.reflect(sdir, cur_normal)
        refl = refl / jnp.maximum(vec.norm(refl), 1e-30)[:, None]
        excl_face_r = jnp.where(cur_back, FACE_FRONT, FACE_BACK).astype(jnp.int32)
        #  - refract: interior march on the scattered hit (601)
        want_refract = live & (sel == SEL_REFRACT)
        march = refract_march(
            scene, cur_pos, cur_normal, sdir, cur_prim, mat.refraction,
            want_refract, cfg,
        )
        casts = casts + march.casts

        is_refract = (sel == SEL_REFRACT)[:, None]
        adv_o = jnp.where(is_refract, march.esc_o, cur_pos)
        adv_d = jnp.where(is_refract, march.esc_d, refl)
        adv_face = jnp.where(
            sel == SEL_REFRACT, FACE_FRONT, cur_ray_face
        ).astype(jnp.int32)
        adv_excl_prim = jnp.where(sel == SEL_REFRACT, march.esc_prim, cur_prim)
        adv_excl_face = jnp.where(sel == SEL_REFRACT, FACE_BACK, excl_face_r).astype(
            jnp.int32
        )
        adv_active = live & jnp.where(sel == SEL_REFRACT, march.escaped, True)

        nxt = cast(
            scene,
            Rays(o=adv_o, d=adv_d, face=adv_face,
                 excl_prim=adv_excl_prim, excl_face=adv_excl_face),
            active=adv_active,
        )
        casts = casts + jnp.sum(adv_active)

        # Merged shade: next-hit shade where the advance cast hit, else the
        # scattered self-shade (the miss terminal of 571-573/590-592, whose
        # specular uses the scattered direction as the view ray).
        use_next = nxt.valid
        s_pos = jnp.where(use_next[:, None], nxt.pos, cur_pos)
        s_normal = jnp.where(use_next[:, None], nxt.normal, cur_normal)
        s_uv = jnp.where(use_next[:, None], nxt.uv, cur_uv)
        s_prim = jnp.where(use_next, nxt.prim, cur_prim)
        s_obj = jnp.where(use_next, nxt.obj, cur_obj)
        s_ray_d = jnp.where(use_next[:, None], adv_d, sdir)
        # refract lanes whose escape cast missed contribute black (607)
        need_shade = adv_active & (use_next | (sel != SEL_REFRACT))
        counters = []
        shade = get_shade(
            scene, textures, s_pos, s_normal, s_uv, s_prim, s_obj, s_ray_d,
            need_shade, counters,
        )
        for c in counters:
            casts = casts + c

        # BRDF factors against the *unadjusted* hit normal (probe.at is the
        # scattered hit, 566-570/585-589), view = the original incoming ray.
        brdf_d = mat_ops.get_diffuse(mat, cur_normal, refl)
        brdf_s = mat_ops.get_specular(mat, cur_normal, refl, -cur_ray_d)
        brdf = jnp.where((sel == SEL_DIFFUSE)[:, None], brdf_d, brdf_s)
        decay = jnp.power(mat.decay, march.travel)[:, None]

        half = jnp.asarray(0.5, ray_o.dtype)
        is_refl_branch = (sel != SEL_REFRACT)[:, None]
        # A/B per the recurrence table above
        A = jnp.where(
            is_refl_branch,
            jnp.where(use_next[:, None], half * shade, shade),
            decay * shade,
        )
        B = jnp.where(
            is_refl_branch,
            jnp.where(use_next[:, None], half * brdf, 0.0),
            decay,
        )

        contribute = need_shade  # lanes that produce a nonzero A
        accum = accum + jnp.where(contribute[:, None], scale * A, 0.0)
        scale = scale * jnp.where(adv_active[:, None], B, 0.0)

        return dict(
            alive=adv_active & use_next,
            accum=accum, scale=scale,
            cur_pos=nxt.pos, cur_normal=nxt.normal, cur_uv=nxt.uv,
            cur_prim=nxt.prim, cur_obj=nxt.obj, cur_back=nxt.backface,
            cur_ray_d=adv_d, cur_ray_face=adv_face,
            casts=casts,
        )

    if cfg.depth > 0:  # fori_loop would trace the body against empty unifs
        state = jax.lax.fori_loop(0, cfg.depth, step_body, state)

    # Depth exhausted: surviving paths terminate with shade(self)
    # (main.rs:524-527).
    alive, accum, scale = state["alive"], state["accum"], state["scale"]
    counters: list = []
    shade = get_shade(
        scene, textures, state["cur_pos"], state["cur_normal"], state["cur_uv"],
        state["cur_prim"], state["cur_obj"], state["cur_ray_d"], alive, counters,
    )
    casts = state["casts"]
    for c in counters:
        casts = casts + c
    accum = accum + jnp.where(alive[:, None], scale * shade, 0.0)

    # f32::is_normal photon filter (main.rs:1157-1160)
    ok = jnp.all(vec.is_normal_f32(accum), axis=-1)
    photon = jnp.where(ok[:, None], accum, 0.0)
    filtered = jnp.sum(~ok)
    return MCResult(photon=photon, casts=casts, filtered=filtered)
