"""Multi-device rendering over a device mesh.

The reference's entire parallelism story is a rayon thread pool over pixels
on one CPU (src/main.rs:1090, 1131; SURVEY.md §2 C23).  The equivalent
here is a 2D jax.sharding.Mesh:

  * ``dp`` — data parallel over pixel tiles: each device traces its own
    slice of the frame (the shard_map analogue of rayon's par_iter).
  * ``sp`` — sample parallel: every device in the ``sp`` axis renders an
    independent stochastic sample of the SAME pixels with a decorrelated
    RNG key, reduced with a single psum — so one "epoch step"
    accumulates |sp| samples per pixel.  This is the only collective the
    renderer needs (SURVEY.md §5.8).

The scene/material/light tables are tiny and replicated; the frame is the
thing that scales, so only the pixel axis is sharded.  Everything compiles
and runs identically on N virtual CPU devices (tests) and on GPUs.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from raytracer_tpu.config import RenderConfig
from raytracer_tpu.ops import camera as camera_ops
from raytracer_tpu.ops.distributed import trace_distributed
from raytracer_tpu.ops.tonemap import post_process
from raytracer_tpu.ops.trace import trace_whitted
from raytracer_tpu.render import clip_coords
from raytracer_tpu.scene.types import Camera, Scene


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Multi-host (multi-slice) initialization.

    On a multi-host cluster each process calls this before any jax op
    (standard jax.distributed flow); afterwards jax.devices() spans the
    pod and the same (dp, sp) mesh code shards the frame across hosts —
    the scene is replicated, the only cross-host traffic is the sp-axis
    psum and the final tile gather.  Single-host setups skip this.
    """
    import jax

    kwargs = {}
    if coordinator is not None:
        kwargs = dict(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def _global_replicated(tree, mesh: Mesh):
    """Map each leaf of a host pytree to a fully-replicated global array.

    In a multi-controller (multi-host) run, jit inputs must be jax.Arrays
    whose sharding spans the global mesh; plain numpy / process-local
    arrays are only addressable on their own process.  Every process calls
    this with the SAME values (the scene is replicated by construction).
    """
    from jax.sharding import NamedSharding

    rep = NamedSharding(mesh, P())

    def leaf(x):
        x = np.asarray(x)
        if x.ndim == 0:
            # scalars replicate fine as python/numpy values
            return x
        return jax.make_array_from_callback(x.shape, rep, lambda idx: x[idx])

    return jax.tree_util.tree_map(leaf, tree)


def render_whitted_multihost(
    scene: Scene, textures, camera: Camera, cfg: RenderConfig, mesh: Mesh
):
    """render_whitted_sharded for a mesh that spans multiple PROCESSES
    (jax.distributed / init_multihost flow, SURVEY.md §5.8).

    Same compiled computation as the single-controller path; the
    differences are purely data plumbing: the clip grid is materialized as
    a global array sharded over the flattened mesh (each process fills only
    its addressable shards), the replicated scene/camera pytrees are lifted
    to global arrays, and the sharded output image is allgathered back to
    host numpy on every process.
    """
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding

    nflat = mesh.shape["dp"] * mesh.shape["sp"]
    clips, pad = _pad_to(clip_coords(cfg.width, cfg.height), nflat)
    sh = NamedSharding(mesh, P(("dp", "sp")))
    gclips = jax.make_array_from_callback(
        clips.shape, sh, lambda idx: clips[idx]
    )
    gscene = _global_replicated(scene, mesh)
    gcam = _global_replicated(camera, mesh)
    # textures is a static (hashable) argument, not a traced pytree
    color, casts, dropped = _whitted_sharded(
        gscene, gcam, gclips, textures, cfg, mesh
    )
    full = np.asarray(multihost_utils.process_allgather(color, tiled=True))
    n = cfg.width * cfg.height
    img = full[:n].reshape(cfg.height, cfg.width, 3)
    return img, {
        "casts": int(np.asarray(casts)),
        "dropped": int(np.asarray(dropped)),
        "primary_rays": n,
    }


def make_render_mesh(
    n_devices: Optional[int] = None, sp: Optional[int] = None
) -> Mesh:
    """Build a (dp, sp) mesh from the first n_devices devices.

    ``sp`` defaults to 2 when the device count is even (sample-parallel
    pairs), else 1; ``dp`` gets the rest.
    """
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if sp is None:
        sp = 2 if n % 2 == 0 and n >= 2 else 1
    dp = n // sp
    assert dp * sp == n, f"{n} devices do not factor into dp={dp} x sp={sp}"
    return Mesh(np.asarray(devs).reshape(dp, sp), ("dp", "sp"))


def _pad_to(clips: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    n = clips.shape[0]
    pad = (-n) % multiple
    if pad:
        clips = np.concatenate([clips, np.zeros((pad, 2), clips.dtype)])
    return clips, pad


def sharded_clips(cfg: RenderConfig, multiple: int, block_order: bool):
    """Clip grid for a sharded render: (clips [N+pad, 2], perm, inv).

    With `block_order` the clips take the SAME 32x16 block-major pixel
    order the single-device path uses (render.py:_block_perm); sharding
    splits the block-ordered rows contiguously over dp, which keeps whole
    blocks on one device.  perm/inv are None without it; otherwise
    image_flat = sharded_flat[:n][inv] and sharded_flat[:n] =
    image_flat[perm].  Padding rows sit at the tail (dead center rays).
    """
    from raytracer_tpu.render import _block_perm, clip_coords

    clips = clip_coords(cfg.width, cfg.height)
    perm = inv = None
    if block_order:
        perm = _block_perm(cfg.width, cfg.height)
        clips = clips[perm]
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    clips, _pad = _pad_to(clips, multiple)
    return clips, perm, inv


@partial(jax.jit, static_argnums=(3, 4, 5))
def _whitted_sharded(scene: Scene, camera: Camera, clips, textures,
                     cfg: RenderConfig, mesh: Mesh):
    def tile_fn(scene, camera, clips_local):
        o, d = camera_ops.shoot(camera, clips_local)
        res = trace_whitted(scene, textures, o, d, cfg)
        casts = jax.lax.psum(res.casts, ("dp", "sp"))
        dropped = jax.lax.psum(res.dropped, ("dp", "sp"))
        return res.color, casts, dropped

    return jax.shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(("dp", "sp"))),
        out_specs=(P(("dp", "sp")), P(), P()),
        check_vma=False,
    )(scene, camera, clips)


def render_whitted_sharded(
    scene: Scene, textures, camera: Camera, cfg: RenderConfig, mesh: Mesh
):
    """Whitted frame sharded over ALL devices of the mesh.

    The deterministic pass has no use for sample parallelism, so the mesh
    is flattened: pixel tiles shard over the combined (dp, sp) axis and
    every device traces a distinct slice of the frame (the stochastic pass
    re-uses the same mesh with sp as its sample axis)."""
    dp = mesh.shape["dp"] * mesh.shape["sp"]
    clips, _perm, inv = sharded_clips(cfg, dp, True)
    color, casts, dropped = _whitted_sharded(
        scene, camera, jnp.asarray(clips), textures, cfg, mesh
    )
    n = cfg.width * cfg.height
    flat = color[:n]
    if inv is not None:
        flat = flat[inv]
    img = flat.reshape(cfg.height, cfg.width, 3)
    return img, {
        "casts": int(casts),
        "dropped": int(dropped),
        "primary_rays": n,
    }


@partial(jax.jit, static_argnums=(4, 5, 6))
def _mc_epoch_sharded(scene: Scene, camera: Camera, clips, key, textures,
                      cfg: RenderConfig, mesh: Mesh):
    def tile_fn(scene, camera, clips_local, key):
        dp_idx = jax.lax.axis_index("dp")
        sp_idx = jax.lax.axis_index("sp")
        k = jax.random.fold_in(jax.random.fold_in(key, dp_idx), sp_idx)
        k_lens, k_path = jax.random.split(k)
        offsets = (
            jax.random.normal(k_lens, (clips_local.shape[0], 2), clips_local.dtype)
            * cfg.blur
        )
        o, d = camera_ops.shoot_focus(camera, clips_local, offsets, cfg.focus)
        res = trace_distributed(scene, textures, o, d, k_path, cfg)
        # Reduce the sample-parallel axis: |sp| photons per pixel.
        photons = jax.lax.psum(res.photon, "sp")
        casts = jax.lax.psum(res.casts, ("dp", "sp"))
        filtered = jax.lax.psum(res.filtered, ("dp", "sp"))
        return photons, casts, filtered

    return jax.shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P(), P(), P("dp"), P()),
        out_specs=(P("dp"), P(), P()),
        check_vma=False,
    )(scene, camera, clips, key)


def render_mc_epoch_sharded(
    scene: Scene, textures, camera: Camera, cfg: RenderConfig, mesh: Mesh, key
):
    """One sample-parallel stochastic epoch: |sp| samples per pixel."""
    dp = mesh.shape["dp"]
    clips, _perm, inv = sharded_clips(cfg, dp, True)
    photons, casts, filtered = _mc_epoch_sharded(
        scene, camera, jnp.asarray(clips), key, textures, cfg, mesh
    )
    n = cfg.width * cfg.height
    flat = photons[:n]
    if inv is not None:
        flat = flat[inv]
    img = flat.reshape(cfg.height, cfg.width, 3)
    return img, {
        "casts": int(casts),
        "filtered": int(filtered),
        "samples_per_pixel": mesh.shape["sp"],
        "primary_rays": n * mesh.shape["sp"],
    }


@partial(jax.jit, static_argnums=(5, 6, 7), donate_argnums=(2,))
def train_step_sharded(scene: Scene, camera: Camera, accum, clips, key,
                       textures, cfg: RenderConfig, mesh: Mesh):
    """The framework's full "training step": one sample-parallel MC epoch,
    accumulated into the (donated) framebuffer and renormalized exactly like
    the reference's per-epoch post_process (src/main.rs:1163-1172), plus the
    sRGB u8 encode of the result — everything a progressive epoch needs, in
    ONE dispatch.

    accum/clips are flat [H*W(+pad), ...] arrays sharded over ``dp``.
    Returns (accum', u8, counters[2]) where u8 is the display encode of the
    renormalized buffer and counters stacks (casts, filtered) so the caller
    pays one fetch.
    """
    from raytracer_tpu.utils import color as color_utils

    photons, casts, filtered = _mc_epoch_sharded.__wrapped__(
        scene, camera, clips, key, textures, cfg, mesh
    )
    # dp-pad rows carry real photons (their clip coords are zeros = image
    # center); zero them so they never skew the percentile statistic below
    # (zero luma fails is_normal and is excluded, matching the unpadded
    # single-device post_process exactly).
    n_pix = cfg.width * cfg.height
    if photons.shape[0] > n_pix:
        live = (jnp.arange(photons.shape[0]) < n_pix)[:, None]
        photons = jnp.where(live, photons, 0.0)
    accum = accum + photons
    # Global percentile renormalization across the sharded frame: jnp.sort
    # under jit inserts the cross-device collectives automatically.
    accum = post_process(accum, cfg.percentile)
    return accum, color_utils.linear_to_u8(accum), jnp.stack([casts, filtered])


@partial(jax.jit, static_argnums=(5, 6, 7, 8), donate_argnums=(2,))
def train_steps_sharded(scene: Scene, camera: Camera, accum, clips,
                        base_key, textures, cfg: RenderConfig, mesh: Mesh,
                        k: int, start_epoch=0):
    """`k` consecutive sharded train steps in ONE dispatch (the mesh
    analogue of the single-device --png-every group).

    Epoch `start_epoch + i` uses fold_in(base_key, start_epoch + i) — the
    SAME per-epoch key the one-step driver computes on the host — and the
    global percentile renormalization runs per epoch inside the loop
    carry, so the result equals k calls of train_step_sharded while the
    dispatch round-trip and the u8 fetch amortize k-fold.  Returns
    (accum', u8-of-final, counters[2] summed over the group)."""
    from raytracer_tpu.utils import color as color_utils

    n_pix = cfg.width * cfg.height
    npad = clips.shape[0]
    live = (jnp.arange(npad) < n_pix)[:, None] if npad > n_pix else None

    def body(i, carry):
        accum, counters = carry
        ekey = jax.random.fold_in(base_key, i)
        photons, casts, filtered = _mc_epoch_sharded.__wrapped__(
            scene, camera, clips, ekey, textures, cfg, mesh
        )
        if live is not None:
            photons = jnp.where(live, photons, 0.0)
        accum = post_process(accum + photons, cfg.percentile)
        # stats carry in f32: a large group on a large frame can sum past
        # int32 (logging counters only — f32 rounds instead of wrapping)
        cn = jnp.stack([casts, filtered]).astype(jnp.float32)
        return accum, counters + cn

    accum, counters = jax.lax.fori_loop(
        start_epoch, start_epoch + k, body,
        (accum, jnp.zeros((2,), jnp.float32)),
    )
    return accum, color_utils.linear_to_u8(accum), counters
