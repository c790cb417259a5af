"""Command-line driver.

The reference has no CLI — everything is hardcoded in main()
(src/main.rs:809-1174).  This exposes the same schedule (Whitted pass, then
progressive stochastic epochs, PNG after every epoch) with the reference's
defaults, plus the knobs SURVEY.md §5.6 calls for.

    python -m raytracer_tpu --scene demo --epochs 100 --out out.png
"""

from __future__ import annotations

import argparse
import os
import sys

from raytracer_tpu.config import RenderConfig
from raytracer_tpu.parallel.progressive import render_progressive
from raytracer_tpu.scene.presets import PRESETS, demo_camera


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracer_tpu", description=__doc__)
    p.add_argument("--scene", default="demo", choices=sorted(PRESETS.keys()))
    p.add_argument("--scene-file", default=None, metavar="JSON",
                   help="load a JSON scene (scene/serialize.py format) "
                        "instead of a preset; its camera is used if present")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=960)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--epochs", type=int, default=100,
                   help="stochastic epochs after the Whitted pass (0 = Whitted only)")
    p.add_argument("--focus", type=float, default=3.0)
    p.add_argument("--blur", type=float, default=0.04)
    p.add_argument("--out", default="out.png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None,
                   help="npz path for epoch-granular resume")
    p.add_argument("--tile-rays", type=int, default=1 << 16)
    p.add_argument("--obj", default=None, help="override dodecahedron OBJ path")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="device-trace the render into DIR and print the top"
                        " device ops afterwards (jax.profiler)")
    p.add_argument("--devices", type=int, default=0, metavar="N",
                   help="shard over the first N devices as a (dp, sp) mesh "
                        "(0 = single-device path)")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax_debug_nans (test mode; the reference "
                        "hints at NaN issues by filtering non-normal "
                        "photons, SURVEY.md §5.2)")
    p.add_argument("--warm-cache", action="store_true",
                   help="compile the render programs for this config into "
                        "the persistent compile cache (tiny 1-epoch run, "
                        "no PNG), then exit — a later run of the same "
                        "config starts without compiling")
    p.add_argument("--png-every", type=int, default=1, metavar="K",
                   help="batch K stochastic epochs per device dispatch and "
                        "write PNG/checkpoint once per group — identical "
                        "image (same draws, same per-epoch renorm), K-fold "
                        "fewer host round-trips.  1 = the reference's "
                        "write-after-every-epoch cadence")
    p.add_argument("--retries", type=int, default=0, metavar="N",
                   help="supervise the render: relaunch up to N times if "
                        "it exits with a failure (e.g. a device error or a "
                        "killed process mid-schedule), resuming from "
                        "--checkpoint (auto-derived from --out if not "
                        "given).  A failed device backend cannot be "
                        "re-initialised in-process, so recovery = fresh "
                        "process + epoch-granular resume")
    return p


def _supervise(argv: list[str], retries: int, checkpoint: str | None,
               out: str) -> int:
    """Relaunch the render subprocess on failure, resuming via checkpoint.

    The progressive driver checkpoints each PNG write (atomic npz), so a
    crash at ANY point — a device error (e.g. an Xid fault or out of
    memory), or the render process being killed — loses at most one
    output group (one epoch at the default --png-every 1).  jax cannot
    re-initialize a failed backend inside a live process reliably, so the
    supervisor retries in a FRESH process; counter-based RNG keys make the
    resumed epochs draw exactly the samples the dead run would have.  Two
    consecutive failures with zero checkpoint progress abort early: a
    failure that reproduces from the same state is deterministic (bad
    input, real bug), not a transient fault worth more relaunches.

    The supervisor never touches a device itself: it only parses argv and
    reads the checkpoint with numpy, so the render child is the one
    process that opens the card.
    """
    import subprocess
    import time

    child = [a for i, a in enumerate(argv)
             if a != "--retries" and not a.startswith("--retries=")
             and not (i > 0 and argv[i - 1] == "--retries")]
    auto_ckpt = checkpoint is None
    if auto_ckpt:
        checkpoint = out + ".ckpt.npz"
        child += ["--checkpoint", checkpoint]
        print(f"supervisor: checkpointing to {checkpoint}")
        if os.path.exists(checkpoint):
            # a previous supervised run died and left progress: resume it
            print(f"supervisor: resuming from leftover {checkpoint}")

    def ckpt_epoch() -> int:
        try:
            import numpy as np

            return int(np.load(checkpoint)["epoch"])
        except Exception:
            return -1

    env = dict(os.environ, RAYTPU_SUPERVISED="1")
    delay = float(os.environ.get("RAYTPU_RETRY_DELAY", "30"))
    rc, no_progress = 1, 0
    for attempt in range(retries + 1):
        if attempt:
            print(f"supervisor: attempt {attempt} failed (rc={rc}); "
                  f"relaunching in {delay:.0f}s")
            time.sleep(delay)
        before = ckpt_epoch()
        rc = subprocess.call(
            [sys.executable, "-m", "raytracer_tpu", *child], env=env
        )
        if rc == 0:
            if auto_ckpt:
                # the checkpoint only existed to make retries resumable;
                # leaving it would make a RERUN of the same command load
                # it, skip every epoch, and ignore a changed --seed
                try:
                    os.remove(checkpoint)
                except OSError:
                    pass
            return 0
        if rc == 2:  # argparse/usage error: retrying cannot help
            return rc
        no_progress = no_progress + 1 if ckpt_epoch() <= before else 0
        if no_progress >= 2:
            print("supervisor: two failures with no checkpoint progress — "
                  "deterministic error, giving up")
            return rc
    print(f"supervisor: giving up after {retries + 1} attempts (rc={rc})")
    return rc


def main(argv=None) -> int:
    from raytracer_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    args = build_parser().parse_args(argv)
    if args.retries > 0 and not os.environ.get("RAYTPU_SUPERVISED"):
        raw = list(sys.argv[1:] if argv is None else argv)
        return _supervise(raw, args.retries, args.checkpoint, args.out)
    if args.debug_nans:
        import jax

        jax.config.update("jax_debug_nans", True)
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        depth=args.depth,
        epochs=args.epochs,
        focus=args.focus,
        blur=args.blur,
        tile_rays=args.tile_rays,
    )
    if args.scene_file:
        from raytracer_tpu.scene.serialize import load_scene_file

        scene, textures, camera = load_scene_file(args.scene_file)
        if camera is None:
            camera = demo_camera()
    else:
        preset = PRESETS[args.scene]
        try:
            scene, textures = preset(obj_path=args.obj)  # type: ignore[call-arg]
        except TypeError:
            scene, textures = preset()
        camera = demo_camera()
    log = print
    if os.environ.get("RAYTPU_TEST_FAIL_ALWAYS"):
        # Deterministic-failure injection for the supervisor's no-progress
        # abort test: die on the FIRST throughput line, every process, so
        # the checkpoint never advances and the supervisor must detect the
        # failure as deterministic rather than relaunching forever.
        def log(msg, _p=print):
            _p(msg, flush=True)
            if "rays in" in msg:
                raise RuntimeError(
                    "injected deterministic failure (RAYTPU_TEST_FAIL_ALWAYS)"
                )

    tok = os.environ.get("RAYTPU_TEST_FAIL_TOKEN")
    if tok:
        # Failure-injection hook for the supervisor's end-to-end test: die
        # like a device fault on the SECOND throughput line (after the
        # whitted pass checkpointed), once per token file.
        seen = [0]

        def log(msg, _p=print):
            _p(msg, flush=True)
            if "rays in" in msg:
                seen[0] += 1
                if seen[0] >= 2 and not os.path.exists(tok):
                    open(tok, "w").close()
                    raise RuntimeError(
                        "UNAVAILABLE: injected transient failure "
                        "(RAYTPU_TEST_FAIL_TOKEN)"
                    )

    mesh = None
    if args.devices:
        from raytracer_tpu.parallel.mesh import make_render_mesh

        mesh = make_render_mesh(args.devices)
        print(f"mesh: {dict(mesh.shape)}")
    if args.warm_cache:
        # Compile (and cache) exactly the programs the real run will use
        # (the whitted frame and the fused epoch step at THIS config) by
        # running a 1-epoch schedule to a temp file.  The persistent
        # compile cache keys on the HLO, which does not depend on the
        # epoch count, so the full run later hits the cache.
        import dataclasses
        import os as _os
        import tempfile
        import time

        tmp = _os.path.join(tempfile.gettempdir(), "raytpu_warm.png")
        t0 = time.time()
        # Warm every group size the real run will dispatch: the main
        # k=png_every group AND the tail group when epochs % png_every != 0
        # (k is a static jit arg, so each distinct k is its own program —
        # an unwarmed tail would compile cold mid-schedule).
        ks = {max(1, min(args.png_every, cfg.epochs or 1))}
        if 1 < args.png_every < cfg.epochs and cfg.epochs % args.png_every:
            ks.add(cfg.epochs % args.png_every)
        for kk in sorted(ks):
            render_progressive(
                scene, textures, camera,
                dataclasses.replace(cfg, epochs=kk),
                out_path=tmp, seed=args.seed, mesh=mesh, log=lambda m: None,
                png_every=kk,
            )
        print(f"warm-cache: programs compiled+cached in "
              f"{time.time() - t0:.1f}s")
        return 0
    if args.profile:
        from raytracer_tpu.utils.profiling import print_profile, profile_trace

        with profile_trace(args.profile):
            render_progressive(
                scene, textures, camera, cfg,
                out_path=args.out, seed=args.seed,
                checkpoint_path=args.checkpoint, mesh=mesh, log=log,
                png_every=args.png_every,
            )
        print_profile(args.profile)
    else:
        render_progressive(
            scene, textures, camera, cfg,
            out_path=args.out, seed=args.seed, checkpoint_path=args.checkpoint,
            mesh=mesh, log=log, png_every=args.png_every,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
