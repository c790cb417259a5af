"""Focused large-mesh benchmark: whitted frame + MC epoch on the 11k- and
51k-triangle terrains (the BVH path), without the demo-scene portions of
bench.py.  Runs only on a GPU.  Prints one JSON line.

    python scripts/bench_mesh.py [--grids 75,160] [--reps 3]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grids", default="75,160")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--mc-only", action="store_true",
                    help="skip the whitted frames (MC-epoch tuning sweeps)")
    args = ap.parse_args()

    from raytracer_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.render import render_distributed_epoch, render_whitted
    from raytracer_tpu.scene.presets import mesh_scene
    from raytracer_tpu.utils.gpu import card_info, require_gpu

    dev = require_gpu()
    card = card_info()
    print(f"devices: {jax.devices()} card: {card}", flush=True)
    cfg = RenderConfig(width=args.size, height=args.size, depth=args.depth,
                       tile_rays=1 << 16)
    key = jax.random.PRNGKey(7)
    out = {"platform": dev["platform"], "device_kind": dev["kind"],
           "device_count": dev["count"], "card": card}
    for grid in (int(g) for g in args.grids.split(",")):
        scene, tex, cam = mesh_scene(grid=grid)
        tag = f"mesh{scene.n_tri // 1000}k"
        if args.mc_only:
            t0 = time.time()
            ph, _ = render_distributed_epoch(scene, tex, cam, cfg, key)
            ph.block_until_ready()
            print(f"{tag} epoch compile+first: {time.time() - t0:.1f}s",
                  flush=True)
            best = 1e9
            for _ in range(args.reps):
                t0 = time.time()
                ph, estats = render_distributed_epoch(scene, tex, cam, cfg,
                                                      key)
                ph.block_until_ready()
                best = min(best, time.time() - t0)
            out[f"{tag}_mc_epoch_seconds"] = round(best, 4)
            out[f"{tag}_mc_mrays"] = round(estats["casts"] / best / 1e6, 2)
            print(f"{tag} MC epoch: {best * 1e3:.0f} ms, "
                  f"{out[f'{tag}_mc_mrays']} Mrays/s", flush=True)
            out[f"{tag}_tris"] = int(scene.n_tri)
            continue
        t0 = time.time()
        img, _ = render_whitted(scene, tex, cam, cfg)
        img.block_until_ready()
        print(f"{tag} whitted compile+first: {time.time() - t0:.1f}s",
              flush=True)
        best = 1e9
        for _ in range(args.reps):
            t0 = time.time()
            img, stats = render_whitted(scene, tex, cam, cfg)
            img.block_until_ready()
            best = min(best, time.time() - t0)
        assert stats["dropped"] == 0, stats
        out[f"{tag}_whitted_seconds"] = round(best, 4)
        out[f"{tag}_whitted_mrays"] = round(stats["casts"] / best / 1e6, 2)
        print(f"{tag} whitted: {best * 1e3:.0f} ms, "
              f"{out[f'{tag}_whitted_mrays']} Mrays/s, dropped=0", flush=True)

        t0 = time.time()
        ph, _ = render_distributed_epoch(scene, tex, cam, cfg, key)
        ph.block_until_ready()
        print(f"{tag} epoch compile+first: {time.time() - t0:.1f}s",
              flush=True)
        best = 1e9
        for _ in range(args.reps):
            t0 = time.time()
            ph, estats = render_distributed_epoch(scene, tex, cam, cfg, key)
            ph.block_until_ready()
            best = min(best, time.time() - t0)
        out[f"{tag}_mc_epoch_seconds"] = round(best, 4)
        out[f"{tag}_mc_mrays"] = round(estats["casts"] / best / 1e6, 2)
        print(f"{tag} MC epoch: {best * 1e3:.0f} ms, "
              f"{out[f'{tag}_mc_mrays']} Mrays/s", flush=True)
        out[f"{tag}_tris"] = int(scene.n_tri)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
