"""Progressive accumulation driver with checkpoint/resume.

The reference's main() (src/main.rs:1084-1173): Whitted pass accumulates
into the framebuffer, then 100 stochastic epochs each add one photon per
pixel, re-run the percentile normalizer on the ACCUMULATED buffer in place
(repeated renormalization is part of the observed output behavior,
main.rs:1171), and atomically rewrite out.png — so killing the process at
any point leaves a valid image (report/Report.md blesses exactly that
workflow).

This driver adds what the reference lacks (SURVEY.md §5.3-5.4): epoch-
granular checkpointing of (accumulator, epoch, seed), so a progressive
render is resumable — trivial here because RNG keys are counter-based,
unlike the reference's 1.2M in-memory IsaacRng states which die with the
process.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from functools import partial

from raytracer_tpu.config import RenderConfig
from raytracer_tpu.ops.tonemap import post_process
from raytracer_tpu.render import (
    _mc_frame,
    _tiled_clips,
    render_whitted,
)
from raytracer_tpu.scene.types import Camera, Scene
from raytracer_tpu.utils import color as color_utils
from raytracer_tpu.utils.png import write_png_atomic


@dataclasses.dataclass
class ProgressiveState:
    img: jnp.ndarray  # [H, W, 3] accumulated (and renormalized) buffer
    epoch: int
    seed: int


@partial(jax.jit, static_argnums=(6, 7))
def _epoch_step(scene: Scene, camera: Camera, clips_tiled, prev_img,
                base_key, epoch, textures, cfg: RenderConfig, inv):
    """One full progressive epoch in ONE dispatch: MC frame + accumulate +
    in-place percentile renorm (main.rs:1163-1171) + sRGB u8 encode.

    The epoch loop's five device steps (fold_in, frame, add, post_process,
    u8) fuse into one jitted call, one dispatch per epoch.
    `prev_img` must NOT be donated: the async writer thread may still be
    serializing the previous epoch's checkpoint from that buffer.
    """
    ekey = jax.random.fold_in(base_key, epoch)
    photons, counters = _mc_frame(scene, camera, clips_tiled, ekey,
                                  textures, cfg)
    n = cfg.width * cfg.height
    flat = photons.reshape(-1, 3)[:n]
    if inv is not None:
        flat = flat[inv]
    img = prev_img + flat.reshape(cfg.height, cfg.width, 3)
    img = post_process(img, cfg.percentile)
    return img, color_utils.linear_to_u8(img), counters


@partial(jax.jit, static_argnums=(6, 7, 9))
def _epoch_group_packed(scene: Scene, camera: Camera, clips_tiled, prev_img,
                        base_key, start_epoch, textures, cfg: RenderConfig,
                        inv, k: int):
    """`k` consecutive progressive epochs in ONE dispatch (--png-every).

    Semantics are IDENTICAL to k calls of _epoch_step_packed: epoch
    `start_epoch + i` draws with fold_in(base_key, start_epoch + i) and
    the percentile renormalization (main.rs:1163-1171) runs per epoch
    inside the loop carry.  The accumulator is carried in the kernels'
    TILED lane order (pad lanes pinned to zero, which is_normal excludes
    from the percentile statistic exactly like the unpadded image path;
    the statistic and the elementwise scale are permutation-invariant) so
    the per-epoch image-order gather is deferred to one gather per group.
    Output is the packed [H*W*3 u8 || 8-byte counters] vector — one fetch,
    one PNG, one checkpoint per group instead of per epoch."""
    n = cfg.width * cfg.height
    shape = clips_tiled.shape[:2] + (3,)
    npad = shape[0] * shape[1]
    flat_prev = prev_img.reshape(-1, 3)
    if inv is not None:
        # image order -> tiled order: tiled[inv[j]] = image[j]
        acc0 = jnp.zeros((npad, 3), jnp.float32).at[inv].set(flat_prev)
    elif npad > n:
        acc0 = jnp.concatenate(
            [flat_prev, jnp.zeros((npad - n, 3), jnp.float32)]
        )
    else:
        acc0 = flat_prev
    live = (jnp.arange(npad) < n)[:, None] if npad > n else None

    def body(i, carry):
        accum, counters = carry
        photons, mc = _mc_frame(scene, camera, clips_tiled,
                                jax.random.fold_in(base_key, i), textures,
                                cfg)
        ph = photons.reshape(npad, 3)
        if live is not None:
            # pad lanes trace real center rays; keep them out of the
            # accumulator and the percentile statistic
            ph = jnp.where(live, ph, 0.0)
        accum = post_process(accum + ph, cfg.percentile)
        # stats carry in f32: a large group on a large frame can sum past
        # int32 (e.g. 100 epochs x ~30M casts); f32 is exact below 2^24
        # per add and merely rounds above — these are logging counters
        return accum, counters + mc.astype(jnp.float32)

    init = (acc0, jnp.zeros((2,), jnp.float32))  # flat [npad, 3] carry
    accum, counters = jax.lax.fori_loop(
        start_epoch, start_epoch + k, body, init
    )
    flat = accum.reshape(-1, 3)[:n]
    if inv is not None:
        flat = flat[inv]
    img = flat.reshape(cfg.height, cfg.width, 3)
    u8 = color_utils.linear_to_u8(img)
    cn8 = jax.lax.bitcast_convert_type(counters, jnp.uint8).reshape(-1)
    return img, jnp.concatenate([u8.reshape(-1), cn8])


@partial(jax.jit, static_argnums=(6, 7))
def _epoch_step_packed(scene: Scene, camera: Camera, clips_tiled, prev_img,
                       base_key, epoch, textures, cfg: RenderConfig, inv):
    """_epoch_step with the epoch's ENTIRE host-bound output packed into a
    single u8 vector: [H*W*3 u8 image || 8 bytes of bitcast counters], so
    each epoch pays one device-to-host transfer instead of two."""
    img, u8, counters = _epoch_step(scene, camera, clips_tiled, prev_img,
                                    base_key, epoch, textures, cfg, inv)
    cn8 = jax.lax.bitcast_convert_type(counters, jnp.uint8).reshape(-1)
    return img, jnp.concatenate([u8.reshape(-1), cn8])


def save_checkpoint(path: str, state: ProgressiveState) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, img=np.asarray(state.img), epoch=state.epoch, seed=state.seed)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Optional[ProgressiveState]:
    if not os.path.exists(path):
        return None
    data = np.load(path)
    return ProgressiveState(
        img=jnp.asarray(data["img"]),
        epoch=int(data["epoch"]),
        seed=int(data["seed"]),
    )


def write_image(path: str, img) -> None:
    """Linear accumulated buffer -> sRGB u8 PNG, atomic (main.rs:764-776)."""
    u8 = np.asarray(color_utils.linear_to_u8(img))
    write_png_atomic(path, u8)


class _AsyncWriter:
    """Single background thread for per-epoch output (PNG + checkpoint).

    The reference writes out.png synchronously after every epoch
    (src/main.rs:1168-1172); here the device→host transfer, PNG encode and
    checkpoint fsync overlap the NEXT epoch's device compute instead of
    serializing with it.  One worker thread + an ordered queue keeps the
    reference's semantics: every epoch's image is written, in order, each
    via atomic rename, so killing the process still leaves a valid PNG of
    some completed epoch.  Queue depth 1 bounds host memory and applies
    backpressure if I/O is slower than tracing.
    """

    def __init__(self) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: list = []
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            if self._err:
                continue  # poisoned: a failed epoch must not be followed
                # by a later epoch's PNG/checkpoint (the error aborts the
                # render; executing queued jobs past it could advance the
                # checkpoint beyond the failure point)
            try:
                job()
            except BaseException as e:  # surfaced on the main thread
                self._err.append(e)

    def submit(self, job: Callable[[], None]) -> None:
        if self._err:
            raise self._err[0]
        self._q.put(job)

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err[0]


def render_progressive(
    scene: Scene,
    textures,
    camera: Camera,
    cfg: RenderConfig,
    out_path: str = "out.png",
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    on_epoch: Optional[Callable[[int, dict], None]] = None,
    log: Callable[[str], None] = print,
    mesh=None,
    png_every: int = 1,
) -> ProgressiveState:
    """Full reference schedule: Whitted pass + cfg.epochs stochastic epochs,
    progressive PNG after each, optional checkpoint each epoch.

    With a `mesh` (parallel/mesh.make_render_mesh), the whitted pass shards
    pixel tiles over the dp axis and each epoch gathers |sp| samples per
    pixel with one psum — the multi-device analogue of the reference's
    rayon pool.

    `png_every=k` (single-device path) batches k epochs into ONE dispatch
    with one packed fetch + PNG + checkpoint per group — the per-dispatch
    round-trip and per-epoch output amortize k-fold, with the SAME image
    as the per-epoch schedule (identical draws, per-epoch renormalization
    inside the loop carry; see _epoch_group_packed).  With a mesh the
    group runs through train_steps_sharded (same equivalence).
    """
    state = load_checkpoint(checkpoint_path) if checkpoint_path else None

    if mesh is not None:
        from raytracer_tpu.parallel.mesh import render_whitted_sharded

        whitted_fn = lambda: render_whitted_sharded(
            scene, textures, camera, cfg, mesh
        )
    else:
        whitted_fn = lambda: render_whitted(scene, textures, camera, cfg)

    if state is None:
        t0 = time.time()
        img, stats = whitted_fn()
        dt = max(time.time() - t0, 1e-9)
        log(
            f"{stats['primary_rays']} rays in {dt * 1e3:.0f} ms "
            f"({stats['casts'] / dt:,.0f} casts/s)"
        )
        img = post_process(img, cfg.percentile)
        write_image(out_path, img)
        state = ProgressiveState(img=img, epoch=0, seed=seed)
        if checkpoint_path:
            save_checkpoint(checkpoint_path, state)
    else:
        log(f"resumed at epoch {state.epoch}")

    base_key = jax.random.PRNGKey(state.seed)
    n_pix = cfg.width * cfg.height
    if mesh is None:
        clips_tiled, _, inv = _tiled_clips(
            cfg, block_order=True
        )
    else:
        # Sharded fused-step setup: flat accumulator + clip grid laid out
        # over the dp axis once, consumed by train_step_sharded (donated
        # accumulator, in-jit sp psum + global renorm + u8 encode).
        from jax.sharding import NamedSharding, PartitionSpec as P

        from raytracer_tpu.parallel.mesh import (
            sharded_clips,
            train_step_sharded,
        )

        clips_np, perm_s, inv_s = sharded_clips(
            cfg, mesh.shape["dp"], True
        )
        dp_sharding = NamedSharding(mesh, P("dp"))
        clips_dev = jax.device_put(jnp.asarray(clips_np), dp_sharding)
        flat = jnp.asarray(state.img).reshape(-1, 3)
        if perm_s is not None:
            # the sharded accumulator lives in the same 32x16 block-major
            # pixel order as the clips (the percentile statistic is
            # permutation-invariant); writes gather back
            flat = flat[perm_s]
        _pad = clips_np.shape[0] - flat.shape[0]
        if _pad:
            flat = jnp.concatenate(
                [flat, jnp.zeros((_pad, 3), flat.dtype)], axis=0
            )
        accum = jax.device_put(flat, dp_sharding)

        def to_image(flat_np):
            """[npad(+), 3] device-layout rows -> [H, W, 3] image order."""
            rows = flat_np[:n_pix] if inv_s is None else flat_np[inv_s]
            return rows.reshape(cfg.height, cfg.width, 3)
    writer = _AsyncWriter()
    try:
        while state.epoch < cfg.epochs:
            t0 = time.time()
            if mesh is not None:
                # One dispatch per epoch; the DONATED accumulator means the
                # linear buffer must not be read by the writer thread —
                # only the (separate) u8 output rides to the writer.  The
                # checkpoint fetch below is synchronous for the same reason.
                k = max(1, min(png_every, cfg.epochs - state.epoch))
                if k > 1:
                    from raytracer_tpu.parallel.mesh import (
                        train_steps_sharded,
                    )

                    accum, u8_dev, counters = train_steps_sharded(
                        scene, camera, accum, clips_dev, base_key, textures,
                        cfg, mesh, k, state.epoch,
                    )
                else:
                    ekey = jax.random.fold_in(base_key, state.epoch)
                    accum, u8_dev, counters = train_step_sharded(
                        scene, camera, accum, clips_dev, ekey, textures,
                        cfg, mesh,
                    )
                state = ProgressiveState(img=None, epoch=state.epoch + k,
                                         seed=state.seed)
                snap_img = None
                if checkpoint_path:
                    # blocking: the next iteration donates `accum` away
                    snap_img = to_image(np.asarray(accum))
                snap = ProgressiveState(img=snap_img, epoch=state.epoch,
                                        seed=state.seed)

                def job(u8_dev=u8_dev, counters=counters, snap=snap, t0=t0,
                        k=k):
                    cn = np.asarray(counters)
                    stats = {
                        "casts": int(cn[0]),
                        "filtered": int(cn[1]),
                        "samples_per_pixel": mesh.shape["sp"],
                        "primary_rays": n_pix * mesh.shape["sp"] * k,
                    }
                    dt = max(time.time() - t0, 1e-9)
                    kept = stats["primary_rays"] - stats["filtered"]
                    log(
                        f"{kept} rays in {dt * 1e3:.0f} ms "
                        f"({stats['casts'] / dt:,.0f} casts/s)"
                    )
                    write_png_atomic(out_path, to_image(np.asarray(u8_dev)))
                    if checkpoint_path:
                        save_checkpoint(checkpoint_path, snap)
                    if on_epoch:
                        on_epoch(snap.epoch, stats)

                writer.submit(job)
                continue

            # Single-device: whole epoch (frame + accumulate + renorm + u8
            # + counters) in ONE dispatch whose host-bound output is ONE
            # packed u8 vector.  The main thread does the single packed
            # fetch while the writer thread handles everything CPU-bound —
            # PNG encode, checkpoint fsync, logging — overlapping the next
            # epoch's dispatch+fetch.  The depth-1 queue bounds the
            # pipeline to two epochs in flight.
            k = max(1, min(png_every, cfg.epochs - state.epoch))
            if k > 1:
                img, packed = _epoch_group_packed(
                    scene, camera, clips_tiled, state.img, base_key,
                    state.epoch, textures, cfg, inv, k,
                )
            else:
                img, packed = _epoch_step_packed(
                    scene, camera, clips_tiled, state.img, base_key,
                    state.epoch, textures, cfg, inv,
                )
            state = ProgressiveState(img=img, epoch=state.epoch + k,
                                     seed=state.seed)
            host = np.asarray(packed)  # the one per-group fetch
            snap = (
                ProgressiveState(img=np.asarray(img), epoch=state.epoch,
                                 seed=state.seed)
                if checkpoint_path else state
            )

            def job(host=host, snap=snap, t0=t0, k=k):
                # group dispatches carry stats in f32 (overflow-safe),
                # single-epoch ones in exact int32
                cn = host[-8:].view(np.float32 if k > 1 else np.int32)
                stats = {"casts": int(cn[0]), "filtered": int(cn[1]),
                         "primary_rays": n_pix * k}
                dt = max(time.time() - t0, 1e-9)
                kept = stats["primary_rays"] - stats["filtered"]
                log(
                    f"{kept} rays in {dt * 1e3:.0f} ms "
                    f"({stats['casts'] / dt:,.0f} casts/s)"
                )
                write_png_atomic(
                    out_path, host[:-8].reshape(cfg.height, cfg.width, 3)
                )
                if checkpoint_path:
                    save_checkpoint(checkpoint_path, snap)
                if on_epoch:
                    on_epoch(snap.epoch, stats)

            writer.submit(job)
    finally:
        writer.close()
    if mesh is not None and state.epoch > 0 and state.img is None:
        # materialize the final accumulator (held flat/sharded in `accum`)
        state = ProgressiveState(
            img=jnp.asarray(to_image(np.asarray(accum))),
            epoch=state.epoch,
            seed=state.seed,
        )
    return state
