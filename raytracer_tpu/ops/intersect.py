"""Vectorized nearest-hit intersector.

Re-design of World::cast (reference: src/main.rs:180-326).  The
reference scans primitives per ray on the CPU call stack; here a whole ray
batch is tested against the whole primitive table at once as masked [N, P]
elementwise math, and the nearest hit is a masked reduction.  The winner's
attributes are gathered from the per-primitive tables.

Every geometry product runs at Precision.HIGHEST: at the default
precision a GPU may evaluate a float32 matmul in TF32 (about 10 mantissa
bits), which moves hit distances and normals far more than reordering
does.  The plane products stay [N,3] x [3,T] matmuls: the plane test of a
ray leaving a surface against that surface's coplanar neighbour is
ill-conditioned, and the matmul's accumulation order is the one the
committed oracle goldens agree with.

Three entry points by decreasing work:
  * cast(..., attrs="full") — everything (normal, uv, obj);
  * cast(..., attrs="geom") — pos/normal/prim only (the TIR interior march
    needs no uv/material, src/main.rs:371-388);
  * cast_any_hit(..., limit) — occlusion predicate for shadow rays: the
    reference takes the nearest hit then accepts it only if nearer than the
    light (src/main.rs:435-448), which is equivalent to "exists a valid hit
    with t < limit" and needs no reduction tie-break at all.

Semantic parity notes (all from src/main.rs):
  * face-direction culling (184-188, 273-281): FRONT rays only hit front
    faces of triangles and the near sphere shell; BACK rays only hit back
    faces / far shell; BOTH picks the sphere shell by sign of tc - k.
  * exclusion (190-200, 286-296): a ray may exclude one primitive on one
    side — this replaces epsilon-offset self-hit avoidance and is kept
    exactly (ids compare in a lane, no epsilon anywhere).
  * tie-break (229-233, 298-302): a later primitive replaces an equal-t
    earlier one (update on t <= nearest); spheres come after triangles.
  * triangle inside test (218-227): three signed areas against the face
    normal, reject if any < 0.
  * interpolated triangle normal is NOT renormalized (248-251); it is
    negated on backface hits.  Sphere uv comes from the (already flipped)
    unit normal (310-313).
  * deviation: rays exactly parallel to a triangle plane (N.D == 0) produce
    t = +/-inf in the reference and can record a bogus infinite hit if
    nothing else is hit; we treat non-finite t as a miss instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracer_tpu.scene.types import (
    FACE_BACK,
    FACE_FRONT,
    Hits,
    Rays,
    Scene,
)

_INF = jnp.inf
_HIGHEST = jax.lax.Precision.HIGHEST


def _dots(a, b):
    """Every row pair's dot product: [N, 3] x [T, 3] -> [N, T], at full
    float32 (never TF32)."""
    return jnp.matmul(a, b.T, precision=_HIGHEST)


def _exclusion_mask(excl_prim, excl_face, prim_ids, backface):
    """Replicates the exclusion criteria match (src/main.rs:190-200).

    excl_prim/excl_face: [N]; prim_ids: [P]; backface: [N, P] bool.
    Returns [N, P] bool — True where the primitive must be skipped.
    """
    same = excl_prim[:, None] == prim_ids[None, :]
    ef = excl_face[:, None]
    crit = jnp.where(
        ef == FACE_FRONT,
        ~backface,
        jnp.where(ef == FACE_BACK, backface, True),
    )
    return same & crit


def _tri_candidates(scene: Scene, rays: Rays, active):
    """Masked candidate distances for all triangles.

    Returns (t_masked [N,T] with inf at invalid lanes, backface [N,T],
    areas (a0,a1,a2) each [N,T]) — areas are reused for barycentric
    reconstruction of the winner.
    """
    T = scene.n_tri
    face = rays.face[:, None]
    no_d = _dots(rays.d, scene.tri_fn)
    backface = no_d > 0.0
    cull = (backface & (face == FACE_FRONT)) | ((~backface) & (face == FACE_BACK))
    excl = _exclusion_mask(
        rays.excl_prim, rays.excl_face, jnp.arange(T, dtype=jnp.int32), backface
    )
    o_fn = _dots(rays.o, scene.tri_fn)
    t = (scene.tri_d[None, :] - o_fn) / no_d
    # Signed-area inside test, affine in the hit point p = o + t d:
    #   area_e = g_e.o + h_e + t * (g_e.d)
    areas = []
    inside = True
    for e in range(3):
        g_e = scene.tri_g[:, e, :]  # [T, 3]
        a = _dots(rays.o, g_e) + scene.tri_h[:, e][None, :] + t * _dots(rays.d, g_e)
        areas.append(a)
        inside = inside & (a >= 0.0)
    valid = (
        active[:, None] & ~cull & ~excl & (t > 0.0) & jnp.isfinite(t) & inside
    )
    return jnp.where(valid, t, _INF), backface, tuple(areas)


def _sph_candidates(scene: Scene, rays: Rays, active):
    """Masked candidate distances for all spheres: (t_masked, backface)."""
    T, S = scene.n_tri, scene.n_sph
    face = rays.face[:, None]
    w = scene.sph_c[None, :, :] - rays.o[:, None, :]  # [N, S, 3]
    d = rays.d[:, None, :]
    cx = jnp.cross(w, d)
    dist2 = jnp.sum(cx * cx, axis=-1)
    r2 = scene.sph_r[None, :] ** 2
    hit_shell = dist2 <= r2  # line_sphere_distance <= radius (265-268)
    tc = jnp.sum(d * w, axis=-1)
    k = jnp.sqrt(jnp.maximum(r2 - dist2, 0.0))
    backface = jnp.where(
        face == FACE_FRONT, False, jnp.where(face == FACE_BACK, True, tc < k)
    )
    t = jnp.where(backface, tc + k, tc - k)
    prim_ids = T + jnp.arange(S, dtype=jnp.int32)
    excl = _exclusion_mask(rays.excl_prim, rays.excl_face, prim_ids, backface)
    valid = active[:, None] & hit_shell & (t > 0.0) & ~excl & jnp.isfinite(t)
    return jnp.where(valid, t, _INF), backface


def cast_any_hit(scene: Scene, rays: Rays, active=None, limit=None):
    """Occlusion predicate: does any valid hit exist with t < limit?

    Equivalent to the reference's shadow test (nearest hit accepted iff
    nearer than the light origin, any hit for directional lights,
    src/main.rs:435-448).  limit: [N] or None (any hit at all).
    Returns bool [N].
    """
    n = rays.o.shape[0]
    if active is None:
        active = jnp.ones((n,), dtype=bool)

    if scene.bvh_node_min is not None:
        hit = _cast_bvh(scene, rays, active, attrs="geom")
        lim = jnp.inf if limit is None else limit
        return hit.valid & (hit.t < lim)

    lim = _INF if limit is None else limit[:, None]
    blocked = jnp.zeros((n,), bool)
    if scene.n_tri > 0:
        t, _, _ = _tri_candidates(scene, rays, active)
        blocked = blocked | jnp.any(t < lim, axis=1)
    if scene.n_sph > 0:
        t, _ = _sph_candidates(scene, rays, active)
        blocked = blocked | jnp.any(t < lim, axis=1)
    return blocked


def _empty_hits(n, dtype):
    z3 = jnp.zeros((n, 3), dtype)
    return Hits(
        valid=jnp.zeros((n,), bool),
        t=jnp.full((n,), _INF, dtype),
        prim=jnp.full((n,), -1, jnp.int32),
        obj=jnp.zeros((n,), jnp.int32),
        pos=z3,
        normal=z3,
        uv=jnp.zeros((n, 2), dtype),
        backface=jnp.zeros((n,), bool),
    )


def _cast_bvh(scene: Scene, rays: Rays, active, attrs: str) -> Hits:
    """Large-scene path: BVH for triangles, dense sweep for spheres."""
    from raytracer_tpu.ops.intersect_bvh import tri_nearest_bvh

    n = rays.o.shape[0]
    T, S = scene.n_tri, scene.n_sph

    t_tri, i_tri, bf_tri = tri_nearest_bvh(scene, rays, active)

    t_sph = jnp.full((n,), _INF)
    i_sph = jnp.zeros((n,), jnp.int32)
    bf_sph = jnp.zeros((n,), bool)
    if S > 0:
        tm, back = _sph_candidates(scene, rays, active)
        t_sph = jnp.min(tm, axis=1)
        ids = jnp.arange(S, dtype=jnp.int32)[None, :]
        i_sph = jnp.max(jnp.where(tm == t_sph[:, None], ids, -1), axis=1)
        bf_sph = (
            jnp.sum(jnp.where(ids == i_sph[:, None], back, False), axis=1) > 0
        )

    # Sphere wins exact ties (scanned after triangles, update-on-<=,
    # src/main.rs:298-302).
    use_sph = (t_sph <= t_tri) & jnp.isfinite(t_sph)
    t_min = jnp.where(use_sph, t_sph, t_tri)
    valid = active & jnp.isfinite(t_min)
    backface = jnp.where(use_sph, bf_sph, bf_tri)
    win_global = jnp.where(use_sph, T + i_sph, i_tri)

    pos = rays.o + jnp.where(valid, t_min, 0.0)[:, None] * rays.d

    ti = jnp.clip(jnp.where(use_sph, 0, i_tri), 0, max(T - 1, 0))
    g = scene.tri_g[ti]  # [N, 3, 3]
    h = scene.tri_h[ti]
    area = jnp.einsum("nej,nj->ne", g, pos, precision=_HIGHEST) + h
    bary = area / scene.tri_area2[ti][:, None]
    n_tri_i = jnp.einsum("ne,nej->nj", bary, scene.tri_n[ti],
                         precision=_HIGHEST)
    n_tri_i = jnp.where(backface[:, None], -n_tri_i, n_tri_i)
    uv_tri = jnp.einsum("ne,nek->nk", bary, scene.tri_uv[ti],
                        precision=_HIGHEST)

    normal = n_tri_i
    uv = uv_tri
    if S > 0:
        c = scene.sph_c[jnp.clip(i_sph, 0, S - 1)]
        n_raw = pos - c
        n_unit = n_raw / jnp.sqrt(
            jnp.maximum(jnp.sum(n_raw * n_raw, axis=-1, keepdims=True), 1e-30)
        )
        n_sph = jnp.where(backface[:, None], -n_unit, n_unit)
        u = jnp.arccos(jnp.clip(n_sph[:, 1], -1.0, 1.0)) / jnp.pi
        v = jnp.arctan2(n_sph[:, 2], n_sph[:, 0]) / (2.0 * jnp.pi) + 0.5
        normal = jnp.where(use_sph[:, None], n_sph, normal)
        uv = jnp.where(use_sph[:, None], jnp.stack([u, v], -1), uv)

    obj = jnp.where(valid, scene.prim_obj[jnp.clip(win_global, 0, T + S - 1)], 0)
    return Hits(
        valid=valid,
        t=jnp.where(valid, t_min, _INF),
        prim=jnp.where(valid, win_global, -1),
        obj=obj if attrs == "full" else jnp.zeros((n,), jnp.int32),
        pos=pos,
        normal=normal,
        uv=uv if attrs == "full" else jnp.zeros((n, 2), rays.o.dtype),
        backface=backface & valid,
    )


def cast(scene: Scene, rays: Rays, active=None, attrs: str = "full") -> Hits:
    """Nearest-hit cast of a ray batch against the whole scene.

    attrs="geom" skips uv/obj reconstruction (Hits.uv/obj are zeros) for
    callers that only need geometry (the interior march).
    `active` masks out dead lanes (their result is valid=False).
    """
    n = rays.o.shape[0]
    T, S = scene.n_tri, scene.n_sph
    P = T + S
    if active is None:
        active = jnp.ones((n,), dtype=bool)
    if P == 0:
        return _empty_hits(n, rays.o.dtype)

    if scene.bvh_node_min is not None:
        return _cast_bvh(scene, rays, active, attrs)

    t_parts = []
    back_parts = []
    if T > 0:
        t_tri, back_tri, _ = _tri_candidates(scene, rays, active)
        t_parts.append(t_tri)
        back_parts.append(back_tri)
    if S > 0:
        t_sph, back_sph = _sph_candidates(scene, rays, active)
        t_parts.append(t_sph)
        back_parts.append(back_sph)

    t_all = jnp.concatenate(t_parts, axis=1) if len(t_parts) > 1 else t_parts[0]
    back_all = (
        jnp.concatenate(back_parts, axis=1)
        if len(back_parts) > 1
        else back_parts[0]
    )

    t_min = jnp.min(t_all, axis=1)
    hit_any = jnp.isfinite(t_min)
    # Last index among the minima: reference updates nearest on t <= the
    # current best so later primitives win exact ties
    # (src/main.rs:229-233, 298-302).
    ids = jnp.arange(P, dtype=jnp.int32)[None, :]
    win_idx = jnp.max(jnp.where(t_all == t_min[:, None], ids, -1), axis=1)
    win_idx = jnp.maximum(win_idx, 0)  # misses: any row, masked below
    backface = jnp.take_along_axis(back_all, win_idx[:, None], axis=1)[:, 0]

    pos = rays.o + t_min[:, None] * rays.d

    is_tri = win_idx < T if T > 0 else jnp.zeros((n,), bool)
    normal = jnp.zeros((n, 3), rays.o.dtype)
    uv = jnp.zeros((n, 2), rays.o.dtype)

    if T > 0:
        ti = jnp.minimum(win_idx, T - 1)
        # Barycentric areas recomputed at the winner from the hit point:
        # area_e = g_e . p + h_e (same affine form the reference divides by
        # area2, main.rs:235-236).
        area = jnp.sum(scene.tri_g[ti] * pos[:, None, :], axis=-1) + scene.tri_h[ti]
        bary = area / scene.tri_area2[ti][:, None]  # [N, 3]
        n_interp = jnp.sum(bary[:, :, None] * scene.tri_n[ti], axis=1)
        n_tri = jnp.where(backface[:, None], -n_interp, n_interp)
        normal = jnp.where(is_tri[:, None], n_tri, normal)
        if attrs == "full":
            uv_interp = jnp.sum(bary[:, :, None] * scene.tri_uv[ti], axis=1)
            uv = jnp.where(is_tri[:, None], uv_interp, uv)

    if S > 0:
        c = scene.sph_c[jnp.clip(win_idx - T, 0, S - 1)]  # [N, 3]
        n_raw = pos - c
        n_unit = n_raw / jnp.sqrt(jnp.sum(n_raw * n_raw, axis=-1, keepdims=True))
        n_sph = jnp.where(backface[:, None], -n_unit, n_unit)
        normal = jnp.where(is_tri[:, None], normal, n_sph)
        if attrs == "full":
            # Spherical uv from the flipped unit normal (310-313).
            u = jnp.arccos(jnp.clip(n_sph[:, 1], -1.0, 1.0)) / jnp.pi
            v = jnp.arctan2(n_sph[:, 2], n_sph[:, 0]) / (2.0 * jnp.pi) + 0.5
            uv_sph = jnp.stack([u, v], axis=-1)
            uv = jnp.where(is_tri[:, None], uv, uv_sph)

    valid = active & hit_any
    if attrs == "full":
        obj = jnp.where(valid, scene.prim_obj[win_idx], 0)
    else:
        obj = jnp.zeros((n,), jnp.int32)

    return Hits(
        valid=valid,
        t=t_min,
        prim=jnp.where(valid, win_idx, -1),
        obj=obj,
        pos=pos,
        normal=normal,
        uv=uv,
        backface=backface & valid,
    )
