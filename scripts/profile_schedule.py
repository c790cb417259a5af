"""Per-phase profile of the full reference schedule's epoch loop.

Reproduces a slice of the 1280x960 schedule (default 20 epochs) with the
epoch pipeline instrumented: per epoch it separates

  dispatch   — jit call returning device futures (host-side cost)
  device     — block_until_ready on the packed output (device compute)
  fetch      — np.asarray(packed): device-to-host copy of the u8 frame
  writer     — PNG encode, on the main thread here so it can be timed
               (the real driver overlaps it on the writer thread; if
               writer > dispatch+fetch the pipeline is writer-bound)

and prints one JSON line with the phase medians.

With --trace DIR it instead takes one jax.profiler trace of --epochs
steady MC epochs (after a compile epoch), reduces it with
utils/profiling (device busy/idle share, top device ops, and the count of
device-to-host predicate copies, one per while-loop iteration) and writes
the reduction to DIR/summary.json.

    python scripts/profile_schedule.py [--epochs 20] [--png-every 1]
    python scripts/profile_schedule.py --trace /tmp/trace --epochs 3 [--scene mesh75]
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Event names counted in the trace: on a GPU each iteration of a
# lax.while_loop (the refraction march, the BVH traversal, the tile map)
# copies its predicate to the host, so these count loop iterations.
TRACE_SCOPES = ("MemcpyD2H",)


def _trace(args, scene, textures, camera, cfg, step):
    """Trace `args.epochs` steady epochs of `step(epoch)`."""
    import jax

    from raytracer_tpu.utils.gpu import card_info, device_record
    from raytracer_tpu.utils.profiling import (
        device_events,
        latest_xplane,
        profile_trace,
        summarize_events,
    )

    jax.block_until_ready(step(0))  # compile epoch, outside the trace
    wall = []
    with profile_trace(args.trace):
        for e in range(1, args.epochs + 1):
            t0 = time.perf_counter()
            jax.block_until_ready(step(e))
            wall.append(time.perf_counter() - t0)
    path = latest_xplane(args.trace)
    events = device_events(path)
    out = {"device": device_record(), "card": card_info(),
           "scene": args.scene, "size": [cfg.width, cfg.height],
           "epochs_traced": args.epochs, "epoch_wall_s": wall,
           "xplane": path, "xplane_bytes": os.path.getsize(path),
           "planes": {}}
    for plane, evs in events.items():
        s = summarize_events(evs, limit=30, scopes=TRACE_SCOPES)
        s["lines"] = sorted({e[0] for e in evs})
        s["n_events"] = len(evs)
        s["sample_events"] = [list(e) for e in evs[:: max(1, len(evs) // 40)]][:40]
        out["planes"][plane] = s
    with open(os.path.join(args.trace, "summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    for plane, s in out["planes"].items():
        print(f"{plane}: window {s['window_ns'] / 1e6:.3f} ms busy "
              f"{s['busy_ns'] / 1e6:.3f} ms idle_share {s['idle_share']} "
              f"events {s['n_events']}", flush=True)
        print(json.dumps(s["scopes"]), flush=True)
        for name, ms, n in s["top_ops"][:15]:
            print(f"  {ms:10.3f} ms {n:7d}x {name[:100]}", flush=True)
    print(json.dumps({"epoch_wall_s": wall, "card": out["card"]}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--png-every", type=int, default=1)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=960)
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="trace --epochs steady MC epochs into DIR instead")
    ap.add_argument("--scene", default="demo",
                    help="demo, or meshN for mesh_scene(grid=N) (--trace)")
    args = ap.parse_args()

    from raytracer_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import numpy as np

    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.parallel.progressive import (
        _epoch_group_packed,
        _epoch_step_packed,
        write_png_atomic,
    )
    from raytracer_tpu.render import _tiled_clips, render_whitted
    from raytracer_tpu.scene.presets import demo_camera, demo_scene, mesh_scene

    print(f"devices: {jax.devices()}", flush=True)
    cfg = RenderConfig(width=args.width, height=args.height, depth=5,
                       epochs=args.epochs, tile_rays=1 << 16)
    if args.scene.startswith("mesh"):
        scene, textures, camera = mesh_scene(grid=int(args.scene[4:]))
    else:
        scene, textures = demo_scene()
        camera = demo_camera()
    clips_tiled, _, inv = _tiled_clips(cfg, block_order=True)
    base_key = jax.random.PRNGKey(0)

    if args.trace:
        prev = jax.numpy.zeros((cfg.height, cfg.width, 3), jax.numpy.float32)
        return _trace(args, scene, textures, camera, cfg, lambda e: (
            _epoch_step_packed(scene, camera, clips_tiled, prev, base_key, e,
                               textures, cfg, inv)))

    t0 = time.time()
    img, _ = render_whitted(scene, textures, camera, cfg)
    img.block_until_ready()
    print(f"whitted compile+frame: {time.time() - t0:.1f}s", flush=True)
    out_png = os.path.join(tempfile.gettempdir(), "profile_schedule.png")

    k = args.png_every
    disp, dev, fetch, writer, total = [], [], [], [], []
    epoch = 0
    while epoch < args.epochs:
        kk = max(1, min(k, args.epochs - epoch))
        t_all = time.time()
        t = time.time()
        if kk > 1:
            img, packed = _epoch_group_packed(
                scene, camera, clips_tiled, img, base_key, epoch, textures,
                cfg, inv, kk,
            )
        else:
            img, packed = _epoch_step_packed(
                scene, camera, clips_tiled, img, base_key, epoch, textures,
                cfg, inv,
            )
        d_disp = time.time() - t
        t = time.time()
        packed.block_until_ready()  # device compute done
        d_dev = time.time() - t
        t = time.time()
        host = np.asarray(packed)  # transfer only
        d_fetch = time.time() - t
        t = time.time()
        write_png_atomic(
            out_png, host[:-8].reshape(cfg.height, cfg.width, 3)
        )
        d_writer = time.time() - t
        d_total = time.time() - t_all
        epoch += kk
        if epoch > kk:  # skip the compile epoch
            disp.append(d_disp)
            dev.append(d_dev)
            fetch.append(d_fetch)
            writer.append(d_writer)
            total.append(d_total)
        print(
            f"epoch {epoch}: dispatch {d_disp * 1e3:.0f} ms, "
            f"device {d_dev * 1e3:.0f} ms, fetch {d_fetch * 1e3:.0f} ms, "
            f"writer {d_writer * 1e3:.0f} ms, total {d_total * 1e3:.0f} ms",
            flush=True,
        )

    med = lambda xs: round(statistics.median(xs), 4) if xs else None
    out = {
        "epochs": args.epochs,
        "png_every": k,
        "dispatch_s": med(disp),
        "device_s": med(dev),
        "fetch_s": med(fetch),
        "writer_s": med(writer),
        "serial_epoch_s": med(total),
        "note": ("real driver overlaps writer on a thread; pipelined "
                 "epoch wall ~= max(dispatch+fetch, writer)"),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
