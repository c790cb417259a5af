"""Wavefront Whitted tracer.

Re-design of World::ray_trace (src/main.rs:466-519) and
World::get_refract (343-405).  The reference's CPU call-stack recursion
(shade + reflect-child + refract-child per hit, depth 5) flattens into a
fixed-depth iterative *level loop* over a bounded ray pool:

  level 0 holds the primary rays; processing a level casts all live rays,
  accumulates the weighted direct shade into the framebuffer via a
  scatter-add keyed by each ray's pixel slot, and emits up to two child
  rays per hit (reflect + refract-escape), weighted exactly like the
  reference's contribution products and pruned at the same 0.001 threshold.
  The 2K child candidates are compacted into the K-slot pool with a
  prefix-sum scatter; overflow is counted (zero for the demo scenes with
  capacity_factor=2).

The data-dependent total-internal-reflection interior march (343-405:
up to 10 reflective bounces inside a dielectric, distance budget) runs as a
masked lax.while_loop over the whole pool — iterations continue while any
lane still marches, exactly bounding work the way the reference bounds its
per-ray loop.

Whitted composition parity notes (all src/main.rs):
  * weights: shade=(1-shiness)(1-transparency), reflect=shiness(1-transp),
    refract=transparency (480-503);
  * shade is only *computed* when contribution*shade_c >= 0.001 (482) but
    at depth 0 the recursion returns the UNWEIGHTED shade (488-490) — the
    parent's branch factor applies, the local shade factor does not;
  * reflect children prune at >= threshold (495), refract at > (504);
  * the refract result is scaled by opaque_decay^travel_distance (508).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer_tpu.config import RenderConfig
from raytracer_tpu.ops import materials as mat_ops
from raytracer_tpu.ops.intersect import cast
from raytracer_tpu.ops.shade import get_shade
from raytracer_tpu.scene.types import (
    FACE_BACK,
    FACE_FRONT,
    NO_EXCLUDE,
    Rays,
    Scene,
)
from raytracer_tpu.utils import vec


def refract_dir(normal, direction, k):
    """Snell refraction (src/main.rs:344-352).

    Returns (refracted unit dir [N,3], ok [N]); ok=False is total internal
    reflection.  Condition and formula match the reference exactly:
    cos = -l.n; refract iff k^2 >= 1 - cos^2;
    t = (l + n cos)/k - n sqrt(1 - (1-cos^2)/k^2), then normalized.
    """
    cos = -vec.dot(direction, normal)
    sin2 = 1.0 - cos * cos
    ok = k * k >= sin2
    inner = jnp.maximum(1.0 - sin2 / (k * k), 0.0)
    t = (direction + normal * cos[:, None]) / k[:, None] - normal * jnp.sqrt(inner)[
        :, None
    ]
    t = t / jnp.maximum(vec.norm(t), 1e-30)[:, None]
    return t, ok


class MarchResult(NamedTuple):
    escaped: jnp.ndarray  # [N] bool — Refraction::Escaped
    travel: jnp.ndarray  # [N] accumulated interior distance
    esc_o: jnp.ndarray  # [N, 3] escape origin
    esc_d: jnp.ndarray  # [N, 3] escape direction (unit)
    esc_prim: jnp.ndarray  # [N] primitive to exclude on its BACK face
    casts: jnp.ndarray  # scalar — rays cast during the march


def refract_march(
    scene: Scene,
    pos,
    normal,
    ray_d,
    prim,
    k,
    want,
    cfg: RenderConfig,
) -> MarchResult:
    """World::get_refract flattened (src/main.rs:343-405).

    pos/normal/ray_d/prim: the entry hit; k: refraction index sample;
    want: lanes that need refraction.  Misses inside the dielectric
    (Refraction::Infinite) and still-trapped rays both yield escaped=False,
    matching both call sites treating them as black (508-511, 605-611).

    The march runs as one batch-wide while_loop: it iterates until the
    last lane has escaped, died or spent its retry or distance budget.
    """
    n = pos.shape[0]

    rin, ok_in = refract_dir(normal, ray_d, k)
    active0 = want & ok_in  # TIR at entry -> Trapped

    rays_in = Rays(
        o=pos,
        d=rin,
        face=jnp.full((n,), FACE_BACK, jnp.int32),
        excl_prim=prim,
        excl_face=jnp.full((n,), FACE_FRONT, jnp.int32),
    )
    h = cast(scene, rays_in, active=active0, attrs="geom")
    casts = jnp.sum(active0)
    alive = active0 & h.valid  # miss -> Infinite -> black

    travel = jnp.where(alive, vec.distance(h.pos, pos), 0.0)
    rout, ok_out = refract_dir(h.normal, rin, 1.0 / k)

    # Loop state: current interior hit + current interior direction.
    state = dict(
        cur_pos=h.pos,
        cur_normal=h.normal,
        cur_prim=h.prim,
        cur_d=rin,
        rout=rout,
        has_out=alive & ok_out,
        alive=alive,
        travel=travel,
        retry=jnp.zeros((n,), jnp.int32),
        casts=casts,
    )

    def pending(s):
        return (
            s["alive"]
            & ~s["has_out"]
            & (s["travel"] <= cfg.max_refract_distance)
            & (s["retry"] < cfg.max_tir_retries)
        )

    def cond(s):
        return jnp.any(pending(s))

    def body(s):
        p = pending(s)
        # get_reflect on the interior hit (src/main.rs:380): reflect the
        # interior direction about the (backface-flipped) normal; the new
        # ray keeps face=Back and excludes the hit primitive's FRONT side.
        refl = vec.reflect(s["cur_d"], s["cur_normal"])
        refl = refl / jnp.maximum(vec.norm(refl), 1e-30)[:, None]
        rays = Rays(
            o=s["cur_pos"],
            d=refl,
            face=jnp.full((n,), FACE_BACK, jnp.int32),
            excl_prim=s["cur_prim"],
            excl_face=jnp.full((n,), FACE_FRONT, jnp.int32),
        )
        h2 = cast(scene, rays, active=p, attrs="geom")
        step_alive = p & h2.valid  # interior miss -> Infinite -> dead

        travel2 = s["travel"] + jnp.where(
            step_alive, vec.distance(h2.pos, s["cur_pos"]), 0.0
        )
        rout2, ok2 = refract_dir(h2.normal, refl, 1.0 / k)

        upd = step_alive[:, None]
        return dict(
            cur_pos=jnp.where(upd, h2.pos, s["cur_pos"]),
            cur_normal=jnp.where(upd, h2.normal, s["cur_normal"]),
            cur_prim=jnp.where(step_alive, h2.prim, s["cur_prim"]),
            cur_d=jnp.where(upd, refl, s["cur_d"]),
            rout=jnp.where(upd, rout2, s["rout"]),
            has_out=jnp.where(step_alive, ok2, s["has_out"]),
            alive=jnp.where(p, step_alive, s["alive"]),
            travel=jnp.where(step_alive, travel2, s["travel"]),
            retry=s["retry"] + p.astype(jnp.int32),
            casts=s["casts"] + jnp.sum(p),
        )

    state = jax.lax.while_loop(cond, body, state)

    escaped = state["alive"] & state["has_out"]
    return MarchResult(
        escaped=escaped,
        travel=state["travel"],
        esc_o=state["cur_pos"],
        esc_d=state["rout"],
        esc_prim=state["cur_prim"],
        casts=state["casts"],
    )


# ---------------------------------------------------------------------------
# Wavefront pool
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Pool:
    """Bounded wavefront ray pool (one level of the flattened recursion).

    `pending` is the lane's accumulated-but-undelivered radiance for its
    pixel slot: pooled levels do NOT scatter their shade into the
    framebuffer (that would be one [K]-row scatter-add per level);
    instead the shade rides DOWN the wavefront with exactly one child per
    lane (reflect child by default, refract child when the reflect branch
    is pruned) and the final level delivers everything in ONE scatter.  A
    lane whose children are all pruned becomes a zombie: alive=False but
    pending != 0 — compaction keeps it (it skips all sweep work via the
    alive mask) purely to deliver its radiance at the end.
    """

    o: jnp.ndarray  # [K, 3]
    d: jnp.ndarray  # [K, 3]
    face: jnp.ndarray  # [K]
    excl_prim: jnp.ndarray  # [K]
    excl_face: jnp.ndarray  # [K]
    slot: jnp.ndarray  # [K] output pixel index
    c: jnp.ndarray  # [K] contribution (threshold bookkeeping, main.rs:668-680)
    s: jnp.ndarray  # [K] accumulated scale incl. opaque decay
    pending: jnp.ndarray  # [K, 3] undelivered radiance for `slot`
    alive: jnp.ndarray  # [K]

    def rays(self) -> Rays:
        return Rays(
            o=self.o, d=self.d, face=self.face,
            excl_prim=self.excl_prim, excl_face=self.excl_face,
        )


Pool = partial(
    jax.tree_util.register_dataclass,
    data_fields=["o", "d", "face", "excl_prim", "excl_face", "slot", "c",
                 "s", "pending", "alive"],
    meta_fields=[],
)(Pool)


def _empty_pool(k: int, dtype=jnp.float32) -> dict:
    return dict(
        o=jnp.zeros((k, 3), dtype),
        d=jnp.zeros((k, 3), dtype),
        face=jnp.zeros((k,), jnp.int32),
        excl_prim=jnp.full((k,), NO_EXCLUDE, jnp.int32),
        excl_face=jnp.zeros((k,), jnp.int32),
        slot=jnp.zeros((k,), jnp.int32),
        c=jnp.zeros((k,), dtype),
        s=jnp.zeros((k,), dtype),
        pending=jnp.zeros((k, 3), dtype),
        alive=jnp.zeros((k,), bool),
    )


def _compact(candidates: Pool, k: int, group: int = 8):
    """Block compaction of candidate rays into a fresh K-slot pool.

    Returns (pool, dropped_count).  Rays beyond capacity are dropped —
    callers surface the count so silent truncation is visible.

    The scatter is kept to few, wide rows:
      * all 13 ray fields pack into ONE wide payload (int fields ride as
        raw f32 bits), one scatter instead of one per field;
      * rays compact in GROUPS of `group`: a group is kept iff any member
        is alive and moves as one [13*group]-wide row, cutting scatter
        rows (and time) by `group`x.  Children of adjacent parents are
        adjacent, so live rays cluster and group occupancy stays high;
        the pool capacity ladder absorbs the partially-dead groups, and
        the per-lane `alive` mask rides in the payload (the pool is no
        longer a dense prefix).
    """
    assert k % group == 0, (k, group)
    pad = (-candidates.alive.shape[0]) % group
    if pad:  # dead-lane pad so candidates split into whole groups
        dead = Pool(**_empty_pool(pad, candidates.o.dtype))
        candidates = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), candidates, dead
        )
    alive = candidates.alive
    c = alive.shape[0]
    ng_in, ng_out = c // group, k // group

    ints = jnp.stack(
        [candidates.face, candidates.excl_prim, candidates.excl_face,
         candidates.slot, alive.astype(jnp.int32)],
        axis=1,
    )  # [C, 5] i32
    payload = jnp.concatenate(
        [
            candidates.o,
            candidates.d,
            candidates.c[:, None],
            candidates.s[:, None],
            candidates.pending,
            jax.lax.bitcast_convert_type(ints, jnp.float32),
        ],
        axis=1,
    )  # [C, 16] — int fields ride as raw bits

    # keep groups that still trace OR still owe radiance (zombie lanes);
    # dropped counts BOTH kinds of lost lanes so radiance loss is never
    # silent.  NOTE: with the pending chain, dropping a lane discards
    # radiance ALREADY EARNED at earlier levels (its pending), not just
    # future bounces — dropped > 0 darkens the image, which is why every
    # user-facing path (render.py, bench.py, chip_smoke.py) surfaces/asserts
    # dropped == 0.  Scattering pending at drop time would reintroduce
    # the per-compaction scatter the chain exists to avoid.
    keep = alive | jnp.any(candidates.pending != 0.0, axis=1)
    gkeepl = keep.reshape(ng_in, group)
    gkeep = jnp.any(gkeepl, axis=1)
    gcount = jnp.sum(gkeepl, axis=1, dtype=jnp.int32)
    order = jnp.cumsum(gkeep.astype(jnp.int32)) - 1  # destination group
    dest = jnp.where(gkeep & (order < ng_out), order, ng_out)
    dropped = jnp.sum(jnp.where(gkeep & (order >= ng_out), gcount, 0))

    wide = payload.reshape(ng_in, group * 16)
    new = jnp.zeros((ng_out, group * 16), payload.dtype).at[dest].set(
        wide, mode="drop"
    ).reshape(k, 16)
    new_i = jax.lax.bitcast_convert_type(new[:, 11:16], jnp.int32)

    pool = Pool(
        o=new[:, 0:3],
        d=new[:, 3:6],
        c=new[:, 6],
        s=new[:, 7],
        pending=new[:, 8:11],
        face=new_i[:, 0],
        excl_prim=new_i[:, 1],
        excl_face=new_i[:, 2],
        slot=new_i[:, 3],
        alive=new_i[:, 4] != 0,
    )
    return pool, dropped


class TraceResult(NamedTuple):
    color: jnp.ndarray  # [N, 3]
    casts: jnp.ndarray  # scalar: total rays cast (incl. shadows + marches)
    dropped: jnp.ndarray  # scalar: rays lost to pool overflow (want 0)


def _process_level(scene, textures, cfg, pool: Pool, img, casts, last: bool,
                   identity_slots: bool | str):
    """One wavefront level == one recursion depth of ray_trace.

    Returns (candidate children [2*width], img, casts).  `last` is a
    STATIC python bool (the final level is peeled out of the tail loop);
    children are suppressed at the last level.
    `identity_slots`: True for the primary level (pool.slot == arange(n) —
    plain add), "doubled" for level 1 (slots are arange(n) twice — two
    plain adds), False for general levels.

    Radiance delivery: levels with `direct` (identity/doubled slots, or
    the last level) add/scatter their contribution immediately; other
    pooled levels ride it down the wavefront as `pending` (see Pool) so
    the framebuffer pays ONE scatter-add total instead of one per level.
    """
    thr = cfg.threshold
    width = pool.o.shape[0]
    assert isinstance(last, bool)
    direct = bool(identity_slots) or last

    def deliver(img, contrib):
        if identity_slots == "doubled":
            half = img.shape[0]
            return img + contrib[:half] + contrib[half : 2 * half]
        if identity_slots:
            return img + contrib
        if last:
            return img.at[pool.slot].add(contrib)
        return img  # pooled non-last: rides `pending` with the children

    hits = cast(scene, pool.rays(), active=pool.alive)
    casts = casts + jnp.sum(pool.alive)
    live = pool.alive & hits.valid

    mat = mat_ops.eval_material(scene, textures, hits.obj, hits.uv)
    shade_c = (1.0 - mat.shiness) * (1.0 - mat.transparency)
    refl_c = mat.shiness * (1.0 - mat.transparency)
    refr_c = mat.transparency

    # Direct shade: computed iff c*shade_c >= THRESHOLD (main.rs:482);
    # weighted by shade_c normally, but returned unweighted at depth 0
    # (main.rs:488-490) — the parent factor is already folded into s.
    need_shade = live & (pool.c * shade_c >= thr)
    shadow_counters: list = []
    shade = get_shade(
        scene, textures, hits.pos, hits.normal, hits.uv, hits.prim, hits.obj,
        pool.d, need_shade, counters=shadow_counters,
    )
    for sc in shadow_counters:
        casts = casts + sc
    coef = pool.s if last else pool.s * shade_c
    local = jnp.where(need_shade[:, None], shade * coef[:, None], 0.0)
    p_new = pool.pending + local
    # One delivery rule for every direct level: pending + local.  On
    # identity/doubled levels pending is invariantly zero (their parents
    # delivered directly), so this stays correct if a pooled pool is ever
    # routed into one.
    img = deliver(img, p_new)

    # --- reflect child (main.rs:493-500, get_reflect 328-341) ---
    c_r = pool.c * refl_c
    want_r = live & (c_r >= thr) & (not last)
    refl = vec.reflect(pool.d, hits.normal)
    refl = refl / jnp.maximum(vec.norm(refl), 1e-30)[:, None]
    # exclusion face = hit face inverted (341): FRONT hit -> BACK
    excl_face_r = jnp.where(hits.backface, FACE_FRONT, FACE_BACK).astype(jnp.int32)

    # --- refract child (main.rs:502-514) ---
    c_f = pool.c * refr_c
    want_f = live & (c_f > thr) & (not last)  # strict > (504)
    march = refract_march(
        scene, hits.pos, hits.normal, pool.d, hits.prim, mat.refraction,
        want_f, cfg,
    )
    casts = casts + march.casts
    decay = jnp.power(mat.decay, march.travel)  # opaque_decay^travel (508)
    alive_f = want_f & march.escaped

    # pending carrier: reflect child by default (also when BOTH children
    # are dead — the zombie case), refract child when only it survives.
    # Direct levels deliver immediately and their children start clean.
    if direct:
        zero3 = jnp.zeros((width, 3), pool.o.dtype)
        pend_r, pend_f = zero3, zero3
    else:
        carrier_f = (~want_r) & alive_f
        pend_r = jnp.where(carrier_f[:, None], 0.0, p_new)
        pend_f = jnp.where(carrier_f[:, None], p_new, 0.0)

    child_r = Pool(
        o=hits.pos, d=refl, face=pool.face,
        excl_prim=hits.prim, excl_face=excl_face_r,
        slot=pool.slot, c=c_r, s=pool.s * refl_c, pending=pend_r,
        alive=want_r,
    )
    child_f = Pool(
        o=march.esc_o, d=march.esc_d,
        face=jnp.full((width,), FACE_FRONT, jnp.int32),
        excl_prim=march.esc_prim,
        excl_face=jnp.full((width,), FACE_BACK, jnp.int32),
        slot=pool.slot, c=c_f, s=pool.s * refr_c * decay, pending=pend_f,
        alive=alive_f,
    )

    candidates = jax.tree.map(
        lambda a, b: jnp.concatenate([a, b], axis=0), child_r, child_f
    )
    return candidates, img, casts


def trace_whitted(
    scene: Scene,
    textures,
    ray_o,
    ray_d,
    cfg: RenderConfig,
) -> TraceResult:
    """Whitted-trace a primary ray batch; returns per-ray linear RGB.

    Equivalent to calling World::ray_trace(depth=cfg.depth, contribution=1)
    per pixel (src/main.rs:1096-1102), restructured as a level loop:
    the primary level runs at exact primary width with a scatter-free
    framebuffer add; bounce levels run at pool width K = capacity_factor*N
    with compaction at level ENTRY, so the final level's dead children are
    never scattered.
    """
    n = ray_o.shape[0]
    k = max(128, -(-int(n * cfg.capacity_factor) // 128) * 128)
    group = cfg.compact_group

    img = jnp.zeros((n, 3), ray_o.dtype)
    casts = jnp.zeros((), jnp.int32)
    dropped = jnp.zeros((), jnp.int32)

    primaries = Pool(
        o=ray_o,
        d=ray_d,
        face=jnp.zeros((n,), jnp.int32),
        excl_prim=jnp.full((n,), NO_EXCLUDE, jnp.int32),
        excl_face=jnp.zeros((n,), jnp.int32),
        slot=jnp.arange(n, dtype=jnp.int32),
        c=jnp.ones((n,), ray_o.dtype),
        s=jnp.ones((n,), ray_o.dtype),
        pending=jnp.zeros((n, 3), ray_o.dtype),
        alive=jnp.ones((n,), bool),
    )
    cands, img, casts = _process_level(
        scene, textures, cfg, primaries, img, casts, last=(cfg.depth == 0),
        identity_slots=True,
    )
    if cfg.depth == 0:
        return TraceResult(color=img, casts=casts, dropped=dropped)

    # Level 1 is peeled: level 0 emits exactly 2n candidates, which IS a
    # valid pool (any capacity >= 2n holds them) — compacting it would be a
    # pure-waste scatter.  Pad with dead lanes up to the loop width k.
    pad = k - 2 * n
    if pad > 0:
        dead = Pool(**_empty_pool(pad, ray_o.dtype))
        cands = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), cands, dead
        )
    elif pad < 0:
        # capacity below 2: compact the level-0 candidates after all
        cands, drop = _compact(cands, k, group)
        dropped = dropped + drop
    cands, img, casts = _process_level(
        scene, textures, cfg, cands, img, casts, last=(cfg.depth == 1),
        identity_slots="doubled" if pad >= 0 else False,
    )
    if cfg.depth == 1:
        return TraceResult(color=img, casts=casts, dropped=dropped)

    # Deep bounce levels (>= 2) run in a narrower pool: live rays decay to
    # ~0.3-0.6n there (absorption + threshold pruning), so paying 2n-wide
    # sweeps is waste.  Overflow is counted.
    k2 = max(
        128, -(-(int(n * cfg.deep_capacity) + cfg.deep_slack) // 128) * 128
    )

    pool2, drop = _compact(cands, k2, group)  # level-2 entry
    dropped = dropped + drop
    cands, img, casts = _process_level(
        scene, textures, cfg, pool2, img, casts, last=(cfg.depth == 2),
        identity_slots=False,
    )
    if cfg.depth == 2:
        return TraceResult(color=img, casts=casts, dropped=dropped)

    # Tail levels (>= 3): live rays have decayed again; narrow once more.
    # Fixed slack absorbs zombie-lane (pending-carrier) pressure, which is
    # an absolute overhead that dominates only on small frames.
    k3 = max(
        128, -(-(int(n * cfg.tail_capacity) + cfg.tail_slack) // 128) * 128
    )
    pool3, drop = _compact(cands, k3, group)
    dropped = dropped + drop

    def level_body(i, state):
        pool, img, casts, dropped = state
        cands, img, casts = _process_level(
            scene, textures, cfg, pool, img, casts, last=False,
            identity_slots=False,
        )
        pool, drop = _compact(cands, k3, group)
        dropped = dropped + drop
        return pool, img, casts, dropped

    # Loop runs levels 3..depth-1; the FINAL level is peeled: it emits no
    # children (last=True), so compacting its dead candidates would be a
    # pure-waste 2*k3-row scatter pass per tile.
    pool_last, img, casts, dropped = jax.lax.fori_loop(
        3, cfg.depth, level_body, (pool3, img, casts, dropped)
    )
    _, img, casts = _process_level(
        scene, textures, cfg, pool_last, img, casts, last=True,
        identity_slots=False,
    )
    return TraceResult(color=img, casts=casts, dropped=dropped)
