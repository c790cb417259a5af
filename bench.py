"""Benchmark harness — the BASELINE.json north-star frame.

Renders the full demo scene (reflection + refraction + DoF + photon
scatter) at 1024x1024, bounce depth 5, on the attached GPU (it refuses to
run on any other backend), mirroring the reference's own main loop
(src/main.rs:1084-1173): ONE Whitted pass as the prologue (main.rs:1088-1115), then
stochastic epochs whose photons accumulate into the image
(main.rs:1129-1156).  The headline throughput is the sustained rate over
that epoch loop — the workload the reference spends 100 of its 101
frames on — timed the way the reference's own stopwatch does (trace +
accumulate only; tone-normalization and PNG are post-processing outside
its rays/s counter, main.rs:1157-1171).  The combined Whitted+MC step
latency is reported separately against the < 1 s/frame target.

Prints ONE JSON line:
  {"metric": "mrays_per_sec", "value": ..., "unit": "Mrays/s",
   "vs_baseline": value / 100.0}
vs_baseline is against the 100 Mrays/s north-star target (the reference
publishes no numbers, BASELINE.md); rays counted are actual rays cast
(primary + shadow + bounce + interior-march), the honest throughput unit.
The line also names the device (`platform`, `device_kind`, `device_count`)
and the card's name and power limit (`card`).  Detail lines go to stderr.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> int:
    from raytracer_tpu.utils.cache import enable_compile_cache
    from raytracer_tpu.utils.gpu import card_info, require_gpu

    enable_compile_cache()
    import jax

    dev = require_gpu()
    card = card_info()
    log(f"device: {dev} card: {card}")

    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.render import render_distributed_epoch, render_whitted
    from raytracer_tpu.scene.presets import demo_camera, demo_scene

    cfg = RenderConfig(width=1024, height=1024, depth=5, tile_rays=1 << 16)
    scene, textures = demo_scene()
    camera = demo_camera()

    # --- compile warmup (not timed) ---
    t0 = time.time()
    img, stats = render_whitted(scene, textures, camera, cfg)
    img.block_until_ready()
    log(f"whitted compile+first frame: {time.time() - t0:.1f}s, stats={stats}")
    t0 = time.time()
    key = jax.random.PRNGKey(0)
    photons, mc_stats = render_distributed_epoch(scene, textures, camera, cfg, key)
    photons.block_until_ready()
    log(f"mc compile+first epoch: {time.time() - t0:.1f}s, stats={mc_stats}")

    # --- timed 1: single-step latency (whitted frame + one MC epoch fused
    # into one dispatch: render_step) — the honest <1 s/frame number
    # including the full dispatch+fetch round-trip ---
    from raytracer_tpu.render import render_epochs, render_step, render_steps

    img, photons, _ = render_step(scene, textures, camera, cfg, key)
    best_dt, best_casts = float("inf"), 0
    for r in range(3):
        t0 = time.time()
        img, photons, stats = render_step(
            scene, textures, camera, cfg, jax.random.fold_in(key, r)
        )
        dt = time.time() - t0
        casts = stats["casts"]
        log(f"step rep {r}: {dt * 1e3:.0f} ms, {casts / 1e6:.1f} Mrays, "
            f"{casts / dt / 1e6:.1f} Mrays/s, dropped={stats['dropped']}")
        if dt < best_dt:
            best_dt, best_casts = dt, casts

    # --- timed 2: HEADLINE — sustained throughput over the reference's
    # progressive epoch loop (main.rs:1129-1156): K MC epochs accumulated
    # in ONE dispatch (render_epochs), timed like the reference's own
    # stopwatch (trace + accumulate; renorm/PNG are post-processing
    # outside its rays/s counter, main.rs:1157-1171). ---
    n_epochs = 10
    render_epochs(scene, textures, camera, cfg, key, n_epochs)  # compile
    best_rate, sdt, scasts = 0.0, 0.0, 0
    for r in range(3):
        t0 = time.time()
        _, estats = render_epochs(
            scene, textures, camera, cfg, jax.random.fold_in(key, 100 + r),
            n_epochs,
        )
        dt = time.time() - t0
        rate = estats["casts"] / dt / 1e6
        log(f"batched {n_epochs} MC epochs rep {r}: {dt * 1e3:.0f} ms "
            f"total, {dt / n_epochs * 1e3:.0f} ms/epoch, {rate:.1f} Mrays/s")
        if rate > best_rate:
            best_rate, sdt, scasts = rate, dt, estats["casts"]

    # --- timed 3: combined whitted+MC steps batched (render_steps) —
    # sustained rate when every step re-traces the deterministic pass too
    # (stricter than the reference loop; kept so the whitted path's
    # throughput can't regress invisibly). ---
    n_steps = 5
    render_steps(scene, textures, camera, cfg, key, n_steps)  # compile
    step_rate = 0.0
    for r in range(3):
        t0 = time.time()
        _, _, sstats = render_steps(
            scene, textures, camera, cfg, jax.random.fold_in(key, 200 + r),
            n_steps,
        )
        dt = time.time() - t0
        assert sstats["dropped"] == 0, sstats
        rate = sstats["casts"] / dt / 1e6
        log(f"batched {n_steps} whitted+MC steps rep {r}: "
            f"{dt * 1e3:.0f} ms total, {dt / n_steps * 1e3:.0f} ms/step, "
            f"{rate:.1f} Mrays/s, dropped={sstats['dropped']}")
        step_rate = max(step_rate, rate)

    mrays = best_rate

    # Roofline denominator: attainable casts/s if the device did nothing
    # but the sweep arithmetic for this table size (utils/roofline.py:
    # published f32 peak of this device_kind over the op-count model).
    # Everything else a walk really does — lobe sampling, shading,
    # carries, masked dead lanes — is charged AGAINST the sweep.
    from raytracer_tpu.utils.roofline import dense_attainable_casts, peaks_for

    attainable = dense_attainable_casts(int(scene.n_tri), int(scene.n_sph),
                                        peaks_for(dev["kind"]))
    log(f"roofline: dense-sweep attainable {attainable / 1e6:.0f} Mrays/s "
        f"-> measured/attainable {mrays * 1e6 / attainable:.3f}")

    result = {
        "metric": "mrays_per_sec",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / 100.0, 4),
        "roofline_attainable_mrays": round(attainable / 1e6, 1),
        "roofline_frac": round(mrays * 1e6 / attainable, 4),
        "frame_seconds": round(best_dt, 4),
        "rays_per_frame": int(best_casts),
        "batched_epochs": n_epochs,
        "batched_seconds_per_epoch": round(sdt / n_epochs, 4),
        "whitted_mc_step_mrays_per_sec": round(step_rate, 2),
        "resolution": f"{cfg.width}x{cfg.height}",
        "depth": cfg.depth,
        "platform": dev["platform"],
        "device_kind": dev["kind"],
        "device_count": dev["count"],
        "card": card,
    }

    # --- large-mesh metric: BVH traversal on a >=10k-tri scene
    # (BASELINE.json north-star clause "BVH traversed in-kernel";
    # ops/intersect_bvh.py).  11,262-triangle terrain + dielectrics.
    if not os.environ.get("RAYTPU_BENCH_FAST"):
        from raytracer_tpu.scene.presets import mesh_scene

        m_scene, m_tex, m_cam = mesh_scene(grid=75)
        m_cfg = RenderConfig(width=1024, height=1024, depth=5,
                             tile_rays=1 << 16)
        img_m, _ = render_whitted(m_scene, m_tex, m_cam, m_cfg)
        img_m.block_until_ready()  # compile warmup
        m_best, m_casts = float("inf"), 0
        for _ in range(3):
            t0 = time.time()
            img_m, m_stats = render_whitted(m_scene, m_tex, m_cam, m_cfg)
            img_m.block_until_ready()
            dt = time.time() - t0
            if dt < m_best:
                m_best, m_casts = dt, m_stats["casts"]
        log(f"mesh 11k-tri whitted frame: {m_best * 1e3:.0f} ms, "
            f"{m_casts / m_best / 1e6:.1f} Mrays/s, "
            f"dropped={m_stats['dropped']}")
        result["mesh11k_mrays_per_sec"] = round(m_casts / m_best / 1e6, 2)
        result["mesh11k_frame_seconds"] = round(m_best, 4)
        result["mesh11k_tris"] = int(m_scene.n_tri)

        # large-mesh MC epoch: scattered bounce rays make the BVH walk
        # incoherent.  Recorded so it can never silently regress out of
        # the bench.
        from raytracer_tpu.render import render_distributed_epoch as rde

        ph, _ = rde(m_scene, m_tex, m_cam, m_cfg, key)
        ph.block_until_ready()  # compile warmup
        e_best = float("inf")
        for r in range(3):
            t0 = time.time()
            # stats counters are host ints (fetched inside rde): the call
            # returns only after the device work is done — honest timing
            ph, e_stats = rde(m_scene, m_tex, m_cam, m_cfg,
                              jax.random.fold_in(key, 200 + r))
            dt = time.time() - t0
            e_best = min(e_best, dt)
        log(f"mesh 11k-tri MC epoch: {e_best * 1e3:.0f} ms, "
            f"{e_stats['casts'] / e_best / 1e6:.1f} Mrays/s")
        result["mesh11k_mc_epoch_seconds"] = round(e_best, 4)

        # scale metric: 51,272-tri terrain — the largest scene
        # correctness-pinned on the card (chip_smoke.py mesh160 golden).
        # The reference's brute-force scan handles any size, slowly
        # (src/main.rs:183-262); this keeps the BVH path's throughput on
        # the bench radar at 50k scale.
        s_scene, s_tex, s_cam = mesh_scene(grid=160)
        img_s, _ = render_whitted(s_scene, s_tex, s_cam, m_cfg)
        img_s.block_until_ready()  # compile warmup
        s_best = float("inf")
        for _ in range(2):
            t0 = time.time()
            img_s, s_stats = render_whitted(s_scene, s_tex, s_cam, m_cfg)
            img_s.block_until_ready()
            s_best = min(s_best, time.time() - t0)
        log(f"mesh 51k-tri whitted frame: {s_best * 1e3:.0f} ms, "
            f"{s_stats['casts'] / s_best / 1e6:.1f} Mrays/s, "
            f"dropped={s_stats['dropped']}")
        result["mesh51k_mrays_per_sec"] = round(
            s_stats["casts"] / s_best / 1e6, 2
        )
        result["mesh51k_frame_seconds"] = round(s_best, 4)
        result["mesh51k_tris"] = int(s_scene.n_tri)
        rde(s_scene, s_tex, s_cam, m_cfg, key)[0].block_until_ready()
        se_best = float("inf")
        for r in range(2):
            t0 = time.time()
            _, se_stats = rde(s_scene, s_tex, s_cam, m_cfg,
                              jax.random.fold_in(key, 300 + r))
            se_best = min(se_best, time.time() - t0)
        log(f"mesh 51k-tri MC epoch: {se_best * 1e3:.0f} ms, "
            f"{se_stats['casts'] / se_best / 1e6:.1f} Mrays/s")
        result["mesh51k_mc_epoch_seconds"] = round(se_best, 4)

    # --- second metric: the FULL reference schedule, end-to-end ---
    # Exactly what src/main.rs:1084-1173 does: 1280x960, depth 5, Whitted
    # pass + 100 stochastic epochs, percentile renorm + atomic PNG after
    # every epoch.  Wall clock includes host round-trips, tone-mapping and
    # PNG encodes — the honest number for the workload the reference runs.
    # Skippable for quick perf iterations with RAYTPU_BENCH_FAST=1.
    if not os.environ.get("RAYTPU_BENCH_FAST"):
        from raytracer_tpu.parallel.progressive import render_progressive

        sched_cfg = RenderConfig(width=1280, height=960, depth=5, epochs=100,
                                 tile_rays=1 << 16)
        out_png = os.path.join(tempfile.gettempdir(), "bench_schedule.png")
        # warm the two 1280x960 programs (compile, not timed)
        render_whitted(scene, textures, camera, sched_cfg)
        render_distributed_epoch(scene, textures, camera, sched_cfg, key)
        t0 = time.time()
        render_progressive(scene, textures, camera, sched_cfg,
                           out_path=out_png, seed=0, log=lambda m: None)
        sched_dt = time.time() - t0
        log(f"full schedule (whitted + {sched_cfg.epochs} epochs @1280x960, "
            f"PNG each epoch): {sched_dt:.1f}s")
        result["full_schedule_seconds"] = round(sched_dt, 2)
        result["full_schedule_epochs"] = sched_cfg.epochs

        # batched-group schedule (--png-every 10): same 100 epochs and
        # photon draws, PNG/checkpoint once per 10-epoch group — the
        # framework's amortized progressive workflow vs the reference's
        # per-epoch output loop.
        import dataclasses

        warm_cfg = dataclasses.replace(sched_cfg, epochs=10)
        render_progressive(scene, textures, camera, warm_cfg,
                           out_path=out_png, seed=0, log=lambda m: None,
                           png_every=10)  # compile the k=10 group program
        t0 = time.time()
        render_progressive(scene, textures, camera, sched_cfg,
                           out_path=out_png, seed=0, log=lambda m: None,
                           png_every=10)
        png10_dt = time.time() - t0
        log(f"batched schedule (PNG every 10): {png10_dt:.1f}s")
        result["full_schedule_png10_seconds"] = round(png10_dt, 2)

    result.update(_prior_round_deltas(result))
    print(json.dumps(result))
    return 0


def _prior_round_deltas(result: dict) -> dict:
    """Regression gate: compare this run's metrics to the newest committed
    BENCH_r*.json and flag every metric that worsened more than 10%,
    direction-aware (seconds: lower is better; Mrays/s and roofline_frac:
    higher is better).  A prior run on another `device_kind` is not
    compared at all: numbers from two devices are not a regression."""
    import glob
    import re

    repo = os.path.dirname(os.path.abspath(__file__))
    prev_files = sorted(
        glob.glob(os.path.join(repo, "BENCH_r*.json")),
        key=lambda p: int(re.search(r"BENCH_r(\d+)", p).group(1)),
    )
    if not prev_files:
        return {}
    prev_path = prev_files[-1]
    try:
        with open(prev_path) as f:
            prev = json.load(f)
        # driver files wrap the bench line under "parsed"
        prev = prev.get("parsed", prev) if isinstance(prev, dict) else prev
    except Exception as e:  # unreadable prior file: report, don't fail
        return {"prev_round_file": os.path.basename(prev_path),
                "prev_round_error": str(e)}
    if not isinstance(prev, dict):
        return {}
    if prev.get("device_kind") != result.get("device_kind"):
        return {"prev_round_file": os.path.basename(prev_path),
                "prev_round_skipped": "other device_kind"}
    lower_better = ("_seconds",)
    higher_better = ("mrays", "roofline_frac", "value", "vs_baseline")
    regressions = {}
    for k, now in result.items():
        if not isinstance(now, (int, float)) or k not in prev:
            continue
        old = prev[k]
        if not isinstance(old, (int, float)) or old == 0:
            continue
        if any(k.endswith(s) or s in k for s in lower_better):
            worse_pct = (now - old) / old * 100.0
        elif any(s in k for s in higher_better):
            worse_pct = (old - now) / old * 100.0
        else:
            continue
        if worse_pct > 10.0:
            regressions[k] = {"prev": old, "now": now,
                              "worse_pct": round(worse_pct, 1)}
            log(f"REGRESSION {k}: {old} -> {now} "
                f"({worse_pct:+.1f}% worse than {os.path.basename(prev_path)})")
    return {"prev_round_file": os.path.basename(prev_path),
            "regressions": regressions}


if __name__ == "__main__":
    sys.exit(main())
