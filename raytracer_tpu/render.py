"""High-level render API.

Composes the camera, the wavefront Whitted tracer, and (for the stochastic
pass) the distributed tracer into whole-frame renders, tiling the pixel
grid so device buffers stay bounded.  This is the counterpart of the
reference's driver loops in main() (src/main.rs:1084-1173), minus the
progressive accumulation which lives in parallel/progressive.py.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.config import RenderConfig
from raytracer_tpu.ops import camera as camera_ops
from raytracer_tpu.ops.distributed import trace_distributed
from raytracer_tpu.ops.trace import trace_whitted
from raytracer_tpu.scene.types import Camera, Scene


def clip_coords(width: int, height: int) -> np.ndarray:
    """Pixel grid -> clip coords [H*W, 2], row-major (y, x) like the
    reference's iproduct!(0..h, 0..w) (src/main.rs:1089, 1094-1095)."""
    ys, xs = np.mgrid[0:height, 0:width]
    clip_x = (xs - width / 2.0) / height
    clip_y = (height / 2.0 - ys) / height
    return np.stack([clip_x, clip_y], axis=-1).reshape(-1, 2).astype(np.float32)


@partial(jax.jit, static_argnums=(3, 4))
def _whitted_tile(scene: Scene, camera: Camera, clip, textures, cfg: RenderConfig):
    o, d = camera_ops.shoot(camera, clip)
    return trace_whitted(scene, textures, o, d, cfg)


@partial(jax.jit, static_argnums=(4, 5))
def _mc_tile(scene: Scene, camera: Camera, clip, key, textures, cfg: RenderConfig):
    """One stochastic sample per pixel: thin-lens primaries + MC trace
    (reference epoch body, src/main.rs:1131-1156)."""
    k_lens, k_path = jax.random.split(key)
    offsets = (
        jax.random.normal(k_lens, (clip.shape[0], 2), clip.dtype) * cfg.blur
    )
    o, d = camera_ops.shoot_focus(camera, clip, offsets, cfg.focus)
    return trace_distributed(scene, textures, o, d, k_path, cfg)


@partial(jax.jit, static_argnums=(3, 4))
def _whitted_frame(scene: Scene, camera: Camera, clips_tiled, textures,
                   cfg: RenderConfig):
    """Whole frame in ONE dispatch: sequential lax.map over ray tiles.

    One dispatch per frame instead of one per tile; the scan keeps one
    tile's wavefront buffers live at a time.
    """
    def tile(clip):
        o, d = camera_ops.shoot(camera, clip)
        res = trace_whitted(scene, textures, o, d, cfg)
        return res.color, res.casts, res.dropped

    colors, casts, dropped = jax.lax.map(tile, clips_tiled)
    # counters ride as ONE vector: one device-to-host fetch for both
    return colors, jnp.stack([jnp.sum(casts), jnp.sum(dropped)])


@partial(jax.jit, static_argnums=(4, 5))
def _mc_frame(scene: Scene, camera: Camera, clips_tiled, key, textures,
              cfg: RenderConfig):
    """One stochastic epoch for the whole frame in ONE dispatch."""
    n_tiles = clips_tiled.shape[0]
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(n_tiles, dtype=jnp.int32)
    )

    def tile(args):
        clip, tkey = args
        k_lens, k_path = jax.random.split(tkey)
        offsets = (
            jax.random.normal(k_lens, (clip.shape[0], 2), clip.dtype) * cfg.blur
        )
        o, d = camera_ops.shoot_focus(camera, clip, offsets, cfg.focus)
        res = trace_distributed(scene, textures, o, d, k_path, cfg)
        return res.photon, res.casts, res.filtered

    photons, casts, filtered = jax.lax.map(tile, (clips_tiled, keys))
    return photons, jnp.stack([jnp.sum(casts), jnp.sum(filtered)])


_CLIPS_CACHE: dict = {}

# Image-block pixel order: neighbouring rays of a tile come from a compact
# 32x16 pixel block instead of a frame-wide scan strip, so they share a
# narrow frustum.  Every frame uses it; the image is gathered back to scan
# order at the end.
_BLOCK_W, _BLOCK_H = 32, 16


def _block_perm(width: int, height: int) -> np.ndarray:
    """Pixel-index permutation into 32x16 block-major order (ragged edge
    blocks are simply smaller)."""
    idx = np.arange(height * width, dtype=np.int64).reshape(height, width)
    order = [
        idx[by : by + _BLOCK_H, bx : bx + _BLOCK_W].reshape(-1)
        for by in range(0, height, _BLOCK_H)
        for bx in range(0, width, _BLOCK_W)
    ]
    return np.concatenate(order)


def _tiled_clips(cfg: RenderConfig, block_order: bool = False):
    """([n_tiles, tile, 2] clip grid, pad, inverse-order gather or None).

    Padded with dead rays at the tail; cached on device per
    (width, height, tile, order) so a progressive schedule uploads its
    clip grid once, not once per frame.
    """
    n = cfg.width * cfg.height
    tile = min(cfg.tile_rays, n)
    key = (cfg.width, cfg.height, tile, block_order)
    hit = _CLIPS_CACHE.get(key)
    if hit is not None:
        return hit
    clips = clip_coords(cfg.width, cfg.height)
    inv = None
    if block_order:
        perm = _block_perm(cfg.width, cfg.height)
        clips = clips[perm]
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n, dtype=perm.dtype)
        inv = jnp.asarray(inv.astype(np.int32))
    pad = (-n) % tile
    if pad:
        clips = np.concatenate([clips, np.zeros((pad, 2), np.float32)])
    out = (jnp.asarray(clips.reshape(-1, tile, 2)), pad, inv)
    if len(_CLIPS_CACHE) > 16:
        _CLIPS_CACHE.clear()
    _CLIPS_CACHE[key] = out
    return out


def render_whitted(
    scene: Scene, textures, camera: Camera, cfg: RenderConfig
) -> Tuple[jnp.ndarray, dict]:
    """Whitted pass over the full frame.  Returns ([H, W, 3], stats)."""
    n = cfg.width * cfg.height
    clips_tiled, pad, inv = _tiled_clips(
        cfg, block_order=True
    )
    colors, counters = _whitted_frame(scene, camera, clips_tiled,
                                      textures, cfg)
    flat = colors.reshape(-1, 3)[:n]
    if inv is not None:
        flat = flat[inv]
    img = flat.reshape(cfg.height, cfg.width, 3)
    counters = np.asarray(counters)  # one fetch for both counters
    return img, {
        "casts": int(counters[0]),
        "dropped": int(counters[1]),
        "primary_rays": n,
    }


@partial(jax.jit, static_argnums=(4, 5))
def _step_frame(scene: Scene, camera: Camera, clips_tiled, key, textures,
                cfg: RenderConfig):
    """One full progressive step (whitted frame + one MC epoch) in ONE
    dispatch, all four counters in one vector (one fetch)."""
    colors, wc = _whitted_frame(scene, camera, clips_tiled, textures, cfg)
    photons, mc = _mc_frame(scene, camera, clips_tiled, key, textures, cfg)
    return colors, photons, jnp.concatenate([wc, mc])


def render_step(
    scene: Scene, textures, camera: Camera, cfg: RenderConfig, key
) -> Tuple[jnp.ndarray, jnp.ndarray, dict]:
    """Whitted frame + one stochastic epoch fused into a single dispatch.

    Semantically identical to render_whitted followed by
    render_distributed_epoch with the same key; returns
    ([H,W,3] whitted, [H,W,3] photons, stats)."""
    n = cfg.width * cfg.height
    clips_tiled, pad, inv = _tiled_clips(
        cfg, block_order=True
    )
    colors, photons, counters = _step_frame(scene, camera, clips_tiled, key,
                                            textures, cfg)

    def fix(x):
        flat = x.reshape(-1, 3)[:n]
        if inv is not None:
            flat = flat[inv]
        return flat.reshape(cfg.height, cfg.width, 3)

    c = np.asarray(counters)  # one fetch for all four counters
    return fix(colors), fix(photons), {
        "casts": int(c[0]) + int(c[2]),
        "dropped": int(c[1]),
        "filtered": int(c[3]),
        "primary_rays": n,
    }


@partial(jax.jit, static_argnums=(4, 5, 6))
def _steps_frame(scene: Scene, camera: Camera, clips_tiled, key, textures,
                 cfg: RenderConfig, n_steps: int):
    """n_steps full progressive steps (whitted frame + MC epoch each) in
    ONE dispatch, so the per-dispatch and per-fetch host cost is paid once
    per batch (the progressive driver likewise pipelines epochs against
    its writer thread)."""

    def body(i, carry):
        _, photons_prev, counters = carry
        # serial no-op dependence (min(photons) is 0 — photons are
        # non-negative, NaNs are filtered): stops XLA hoisting the
        # loop-invariant whitted pass out of the step loop, so every step
        # honestly pays the full frame.
        eps = jnp.minimum(jnp.min(photons_prev), 0.0).astype(
            clips_tiled.dtype
        )
        clips_i = clips_tiled + eps
        colors, wc = _whitted_frame(scene, camera, clips_i, textures, cfg)
        photons, mc = _mc_frame(
            scene, camera, clips_i, jax.random.fold_in(key, i), textures, cfg
        )
        return colors, photons, counters + jnp.concatenate([wc, mc])

    shape = clips_tiled.shape[:2] + (3,)
    init = (
        jnp.zeros(shape, jnp.float32),
        jnp.zeros(shape, jnp.float32),
        jnp.zeros((4,), jnp.int32),
    )
    return jax.lax.fori_loop(0, n_steps, body, init)


def render_steps(
    scene: Scene, textures, camera: Camera, cfg: RenderConfig, key,
    n_steps: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, dict]:
    """n_steps fused progressive steps in one dispatch (bench harness).

    Step i uses fold_in(key, i); returns the LAST step's (whitted, photons)
    images plus counters summed over all steps."""
    n = cfg.width * cfg.height
    clips_tiled, pad, inv = _tiled_clips(
        cfg, block_order=True
    )
    colors, photons, counters = _steps_frame(
        scene, camera, clips_tiled, key, textures, cfg, n_steps
    )

    def fix(x):
        flat = x.reshape(-1, 3)[:n]
        if inv is not None:
            flat = flat[inv]
        return flat.reshape(cfg.height, cfg.width, 3)

    c = np.asarray(counters)  # one fetch for all four counters
    return fix(colors), fix(photons), {
        "casts": int(c[0]) + int(c[2]),
        "dropped": int(c[1]),
        "filtered": int(c[3]),
        "primary_rays": n * n_steps,
        "steps": n_steps,
    }


@partial(jax.jit, static_argnums=(4, 5, 6))
def _epochs_frame(scene: Scene, camera: Camera, clips_tiled, key, textures,
                  cfg: RenderConfig, n_epochs: int):
    """n_epochs stochastic epochs accumulated in ONE dispatch.

    This is the reference's actual progressive loop body
    (src/main.rs:1129-1156): per epoch ONE distributed
    (MC) frame whose photons add into the running image — the Whitted
    pass runs once as a prologue OUTSIDE this loop (main.rs:1088-1115),
    not per epoch.  Tone-normalization and PNG are post-processing
    outside the reference's own rays/s stopwatch (main.rs:1167-1171) and
    are likewise excluded here."""

    def body(i, carry):
        accum, counters = carry
        photons, mc = _mc_frame(
            scene, camera, clips_tiled, jax.random.fold_in(key, i), textures,
            cfg,
        )
        return accum + photons, counters + mc

    shape = clips_tiled.shape[:2] + (3,)
    init = (jnp.zeros(shape, jnp.float32), jnp.zeros((2,), jnp.int32))
    return jax.lax.fori_loop(0, n_epochs, body, init)


def render_epochs(
    scene: Scene, textures, camera: Camera, cfg: RenderConfig, key,
    n_epochs: int,
) -> Tuple[jnp.ndarray, dict]:
    """n_epochs MC epochs accumulated in one dispatch (bench harness).

    Epoch i uses fold_in(key, i); returns the accumulated photon image
    [H, W, 3] plus counters summed over all epochs."""
    n = cfg.width * cfg.height
    clips_tiled, pad, inv = _tiled_clips(
        cfg, block_order=True
    )
    accum, counters = _epochs_frame(
        scene, camera, clips_tiled, key, textures, cfg, n_epochs
    )
    flat = accum.reshape(-1, 3)[:n]
    if inv is not None:
        flat = flat[inv]
    c = np.asarray(counters)  # one fetch for both counters
    return flat.reshape(cfg.height, cfg.width, 3), {
        "casts": int(c[0]),
        "filtered": int(c[1]),
        "primary_rays": n * n_epochs,
        "epochs": n_epochs,
    }


def render_distributed_epoch(
    scene: Scene, textures, camera: Camera, cfg: RenderConfig, key
) -> Tuple[jnp.ndarray, dict]:
    """One epoch of the stochastic pass: one photon per pixel.

    Returns ([H, W, 3] photons — is_normal-filtered like main.rs:1157-1160 —
    plus stats).  Accumulation/tone-normalization is the caller's job
    (parallel/progressive.py), matching the reference's epoch loop.
    """
    n = cfg.width * cfg.height
    clips_tiled, pad, inv = _tiled_clips(
        cfg, block_order=True
    )
    photons, counters = _mc_frame(scene, camera, clips_tiled, key,
                                  textures, cfg)
    flat = photons.reshape(-1, 3)[:n]
    if inv is not None:
        flat = flat[inv]
    img = flat.reshape(cfg.height, cfg.width, 3)
    counters = np.asarray(counters)  # one fetch for both counters
    # when the pixel count is not tile-aligned, stats include the padding
    # rays (their photons are discarded above)
    return img, {
        "casts": int(counters[0]),
        "filtered": int(counters[1]),
        "primary_rays": n,
    }
