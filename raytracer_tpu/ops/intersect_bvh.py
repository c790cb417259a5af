"""BVH traversal path for large triangle meshes.

The dense [rays x prims] sweep (ops/intersect.py) suits reference-scale
scenes (tens of primitives, every lane busy).  Past a few hundred
triangles it is O(T) per ray, so large scenes traverse a host-built BVH
(scene/bvh.py) instead: a masked per-ray stack loop under lax.while_loop —
every ray pops its own node, inner nodes push children, leaves run the
exact reference triangle test on gathered rows.  The loop runs until the
last ray of the batch empties its stack.

Semantics match World::cast exactly, including the tie-break: the
reference scans triangles in index order updating on t <= best, so equal-t
ties go to the HIGHER index (src/main.rs:229-233); the BVH visits in
arbitrary order, so the update rule compares (t, index) lexicographically.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracer_tpu.scene.types import FACE_BACK, FACE_FRONT, Rays, Scene

_BIG = 3.0e38


def _leaf_test(scene: Scene, rays: Rays, tri_ids, live):
    """Reference triangle test on gathered rows.

    tri_ids: [N, L] triangle indices (clamped); live: [N, L] mask.
    Returns (t [N,L] masked with _BIG, backface [N,L]).
    """
    fn = scene.tri_fn[tri_ids]  # [N, L, 3]
    d_pl = scene.tri_d[tri_ids]  # [N, L]
    o = rays.o[:, None, :]
    d = rays.d[:, None, :]
    face = rays.face[:, None]

    no_d = jnp.sum(fn * d, axis=-1)
    backface = no_d > 0.0
    cull = (backface & (face == FACE_FRONT)) | ((~backface) & (face == FACE_BACK))
    t = (d_pl - jnp.sum(fn * o, axis=-1)) / no_d
    ok = t > 0.0
    for e in range(3):
        g = scene.tri_g[tri_ids, e]  # [N, L, 3]
        h = scene.tri_h[tri_ids, e]  # [N, L]
        a = jnp.sum(g * o, axis=-1) + h + t * jnp.sum(g * d, axis=-1)
        ok = ok & (a >= 0.0)
    same = rays.excl_prim[:, None] == tri_ids
    ef = rays.excl_face[:, None]
    crit = (
        ((ef == FACE_FRONT) & ~backface)
        | ((ef == FACE_BACK) & backface)
        | ((ef != FACE_FRONT) & (ef != FACE_BACK))
    )
    valid = live & ~cull & ~(same & crit) & jnp.isfinite(t) & ok
    return jnp.where(valid, t, _BIG), backface


def tri_nearest_bvh(scene: Scene, rays: Rays, active, leaf_size: int = 8):
    """Nearest triangle via BVH traversal.

    Requires scene.bvh_* arrays (scene/builder.py build(use_bvh=True)).
    Returns (t [N], idx [N] triangle index, backface [N]); t == +inf on miss.
    """
    n = rays.o.shape[0]
    depth = int(scene.bvh_depth)
    stack_size = depth + 2

    inv_d = 1.0 / rays.d  # +-inf on zero components: slab test still correct

    state = dict(
        stack=jnp.zeros((n, stack_size), jnp.int32),
        sp=jnp.where(active, 1, 0).astype(jnp.int32),
        best_t=jnp.full((n,), _BIG, jnp.float32),
        best_i=jnp.full((n,), -1, jnp.int32),
        best_bf=jnp.zeros((n,), bool),
    )

    def cond(s):
        return jnp.any(s["sp"] > 0)

    def body(s):
        sp = s["sp"]
        live = sp > 0
        sp_i = jnp.maximum(sp - 1, 0)
        node = jnp.take_along_axis(s["stack"], sp_i[:, None], axis=1)[:, 0]
        node = jnp.where(live, node, 0)
        sp = sp_i

        nmin = scene.bvh_node_min[node]  # [N, 3]
        nmax = scene.bvh_node_max[node]
        right = scene.bvh_node_right[node]
        count = scene.bvh_node_count[node]

        # Slab test bounded by the current best hit.
        t0 = (nmin - rays.o) * inv_d
        t1 = (nmax - rays.o) * inv_d
        t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
        t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
        hit_box = live & (t_near <= jnp.minimum(t_far, s["best_t"])) & (t_far >= 0.0)

        is_leaf = count > 0

        # Leaf: test up to leaf_size triangles.
        lane = jnp.arange(leaf_size, dtype=jnp.int32)[None, :]
        pid = jnp.clip(right[:, None] + lane, 0, scene.bvh_prim_order.shape[0] - 1)
        tri_ids = scene.bvh_prim_order[pid]
        leaf_live = (hit_box & is_leaf)[:, None] & (lane < count[:, None])
        t_l, bf_l = _leaf_test(scene, rays, tri_ids, leaf_live)
        t_min = jnp.min(t_l, axis=1)
        # lexicographic (t, index) update: highest index among equal t
        cand = jnp.where(t_l == t_min[:, None], tri_ids, -1)
        cand_i = jnp.max(jnp.where(leaf_live, cand, -1), axis=1)
        cand_bf = (
            jnp.sum(jnp.where((tri_ids == cand_i[:, None]) & leaf_live, bf_l, False),
                    axis=1) > 0
        )
        better = (t_min < s["best_t"]) | (
            (t_min == s["best_t"]) & (cand_i > s["best_i"])
        )
        better = better & (t_min < _BIG)
        best_t = jnp.where(better, t_min, s["best_t"])
        best_i = jnp.where(better, cand_i, s["best_i"])
        best_bf = jnp.where(better, cand_bf, s["best_bf"])

        # Inner: push right child then left (left pops first).
        push = hit_box & ~is_leaf
        stack = s["stack"]
        stack = jnp.where(
            (jnp.arange(stack_size)[None, :] == sp[:, None]) & push[:, None],
            right[:, None],
            stack,
        )
        sp1 = sp + push.astype(jnp.int32)
        stack = jnp.where(
            (jnp.arange(stack_size)[None, :] == sp1[:, None]) & push[:, None],
            (node + 1)[:, None],
            stack,
        )
        sp2 = sp1 + push.astype(jnp.int32)

        return dict(stack=stack, sp=sp2, best_t=best_t, best_i=best_i,
                    best_bf=best_bf)

    out = jax.lax.while_loop(cond, body, state)
    t = out["best_t"]
    return jnp.where(t < _BIG, t, jnp.inf), out["best_i"], out["best_bf"]
