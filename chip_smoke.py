#!/usr/bin/env python3
"""Smoke run of the renderer on NVIDIA GPUs: the quickest proof that the
system starts, renders correctly and runs its main path on the card.

    python chip_smoke.py           # one card: phases (a)-(e)
    python chip_smoke.py --multi   # four cards: the sharded path only

One card:
  (a) device    JAX must report platform "gpu"; otherwise exit 2, no render.
  (b) goldens   every committed golden (tests/golden): Whitted 64x48
                depth-5 frames (CPU renders and f64 oracle renders, the
                51k-triangle mesh160 among them) and two fixed-key MC
                epochs, each rendered on the card and compared.
  (c) full      the 1280x960 depth-5 Whitted frame of the card against the
                same program on the CPU backend of this process, on a
                1280-wide band of rows through the glass slabs; linear
                values and the tone map's percentile scale.
  (d) main      the reference schedule through the CLI (`cli.main`): demo
                scene, 1280x960, depth 5, Whitted pass + 3 epochs with a PNG
                each and a checkpoint; the same 3 epochs grouped
                (--png-every 3) must write a byte-identical PNG; then the
                11,262-triangle mesh at 1024x1024 (BVH path): one Whitted
                frame and one MC epoch.  Per step: compile time (set-up),
                steady wall time, dropped, casts, memory_analysis() and
                peak_bytes_in_use.
  (e) gpu tests the `gpu`-marked tests (tests/test_gpu.py), in this process.

Four cards (--multi): render_whitted_sharded on a dp=4 mesh at 1280x960
against the one-card image, and one train_step_sharded plus one
train_steps_sharded group on a (dp=2, sp=2) mesh against the serial
same-keys result, with the collective-bearing steps' wall times.

Every line names the card (`nvidia-smi` name and power limit).  The last
line is one JSON object, printed only when every phase passed:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Any failed phase makes the exit code 1 and suppresses that line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")


# ---------------------------------------------------------------------------
# Tolerances.  A pixel AGREES when every channel is within `atol` of the
# reference (linear radiance); at most `max_bad` of the pixels may differ by
# more.  The cap covers discrete branch flips: a last-ulp difference at a
# total-internal-reflection, threshold-prune or roulette boundary replaces
# a pixel's whole path, so a correct render on another backend differs
# there by O(1) on isolated pixels — a real fault shows as a large
# fraction of pixels (regions), or as agreeing pixels drifting past atol.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Tol:
    atol: float
    max_bad: float
    why: str


TOL_CPU = Tol(1e-3, 0.005, (
    "same program, CPU vs GPU: fp reordering and libdevice vs CPU "
    "transcendentals move agreeing pixels by ~1e-5; 1e-3 is a quarter of one "
    "8-bit step at the demo's tone-map scale. 0.5% covers TIR/threshold "
    "branch flips on isolated pixels"))
TOL_MESH = Tol(1e-3, 0.02, (
    "BVH terrain vs its CPU render: coplanar neighbouring triangles make "
    "shared-edge hits and grazing shadows flip on last-ulp differences "
    "(0.72% of mesh24's pixels on the H100 at full float32)"))
TOL_ORACLE = Tol(1e-3, 0.02, (
    "float64 scalar oracle vs float32 renderer: the CPU render itself "
    "differs from these goldens on up to 0.65% of pixels (02-triangles: "
    "f32 vs f64 texture band edges); 2% leaves room for the GPU's own flips"))
TOL_MC = Tol(1e-3, 0.02, (
    "one fixed-key MC sample per pixel: threefry draws are identical on "
    "every backend, but a branch flip (roulette, TIR) replaces that pixel's "
    "whole walk; 2% of pixels may flip"))


def compare(got, want, tol: Tol) -> dict:
    """Per-pixel comparison of two [..., 3] images under `tol`."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return {"ok": False, "why": f"shape {got.shape} != {want.shape}"}
    finite = bool(np.isfinite(got).all())
    d = np.abs(got - want).reshape(-1, got.shape[-1]).max(axis=-1)
    d = np.where(np.isnan(d), np.inf, d)
    bad = d > tol.atol
    agree = d[~bad]
    bad_frac = float(bad.mean())
    return {
        "ok": finite and bad_frac <= tol.max_bad,
        "finite": finite,
        "bad_frac": bad_frac,
        "max_abs_agreeing": float(agree.max()) if agree.size else 0.0,
        "max_abs": float(d.max()),
        "atol": tol.atol,
        "max_bad": tol.max_bad,
    }


def phases(multi: bool) -> list:
    """The phases a run executes, in order."""
    if multi:
        return ["device", "multi"]
    # main first: its compile times are the cold ones
    return ["device", "main", "full", "goldens", "gpu_tests"]


def result_line(rec: dict) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": rec["platform"], "kind": rec["kind"],
        "count": rec["count"]}})


class Report:
    """Prints one line per result with the card beside it; collects
    failures."""

    def __init__(self, card: str):
        self.card = card
        self.failed: list = []
        self.out = sys.stdout  # kept: tagged() redirects sys.stdout

    def line(self, msg: str) -> None:
        print(f"{msg}  [card: {self.card}]", file=self.out, flush=True)

    def check(self, name: str, res: dict) -> None:
        self.line(f"{name}: {'OK' if res.get('ok') else 'FAIL'} "
                  f"{json.dumps({k: v for k, v in res.items() if k != 'ok'})}")
        if not res.get("ok"):
            self.failed.append(name)

    def fail(self, name: str, why: str) -> None:
        self.line(f"{name}: FAIL {why}")
        self.failed.append(name)

    @contextlib.contextmanager
    def tagged(self, prefix: str):
        """Route what the code inside prints through line(), so the
        CLI's and pytest's own lines name the card too."""
        rep = self

        class _Lines(io.TextIOBase):
            def __init__(self):
                self.buf = ""

            def write(self, text):
                self.buf += text
                *done, self.buf = self.buf.split("\n")
                for ln in done:
                    rep.line(f"{prefix}{ln}")
                return len(text)

        out = _Lines()
        try:
            with contextlib.redirect_stdout(out):
                yield
        finally:
            if out.buf:
                self.line(f"{prefix}{out.buf}")


def _block(x):
    import jax

    return jax.block_until_ready(x)


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _mem(compiled) -> dict:
    ma = compiled.memory_analysis()
    if ma is None:
        return {}
    return {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(ma, k)}


def schedule_cfg(width: int, height: int, epochs: int):
    """The RenderConfig `cli.main` builds for the reference schedule at
    this size (cfg is a static jit argument: one value, one program)."""
    from raytracer_tpu.config import RenderConfig

    return RenderConfig(width=width, height=height, depth=5, epochs=epochs,
                        focus=3.0, blur=0.04, tile_rays=1 << 16)


def aot(fn, *args):
    """(compiled, seconds to lower + compile) — compile time is set-up.
    The compiled program is called without fn's static arguments."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    return compiled, time.perf_counter() - t0


def warm(jobs: dict) -> dict:
    """Compile {name: (jitted fn, args)} concurrently on host threads.

    XLA compiles outside the interpreter lock, so the programs of a run
    build side by side; each lands in the persistent compile cache, where
    the later call through the normal entry point finds it.  Returns
    {name: (compiled, seconds)}; a program's seconds overlap the others'."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max(1, min(len(jobs), os.cpu_count() or 1))) as ex:
        futs = {name: ex.submit(aot, fn, *args)
                for name, (fn, args) in jobs.items()}
        return {name: f.result() for name, f in futs.items()}


def steady(call, reps: int = 2) -> list:
    """Wall seconds of `reps` calls, each ending in block_until_ready."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _block(call())
        out.append(time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------------
# (b) goldens
# ---------------------------------------------------------------------------

GOLDENS = [
    # (kind, scene, file, tolerance)
    ("whitted", "demo", "whitted_demo_64x48.npy", TOL_CPU),
    ("whitted", "mesh24", "whitted_mesh24_64x48.npy", TOL_MESH),
    ("whitted", "mesh96", "whitted_mesh96_64x48.npy", TOL_MESH),
    ("whitted", "mesh160", "whitted_mesh160_64x48.npy", TOL_MESH),
    ("whitted", "demo", "oracle_demo_64x48_d5.npy", TOL_ORACLE),
    ("whitted", "01-spheres", "oracle_01-spheres_64x48_d5.npy", TOL_ORACLE),
    ("whitted", "02-triangles", "oracle_02-triangles_64x48_d5.npy", TOL_ORACLE),
    ("whitted", "03-recursive", "oracle_03-recursive_64x48_d5.npy", TOL_ORACLE),
    ("whitted", "06-obj", "oracle_06-obj_64x48_d5.npy", TOL_ORACLE),
    ("mc", "demo", "mc_demo_64x48.npy", TOL_MC),
    ("mc", "mesh24", "mc_mesh24_64x48.npy", TOL_MC),
]
MC_KEY = 7  # the fixed key the MC goldens were rendered with


def scene_of(name: str):
    """(scene, textures, camera) of a golden's scene name."""
    from raytracer_tpu.scene import presets

    if name.startswith("mesh"):
        return presets.mesh_scene(grid=int(name[4:]))
    scene, textures = presets.PRESETS[name]()[:2]
    return scene, textures, presets.demo_camera()


def golden_cfg():
    from raytracer_tpu.config import RenderConfig

    return RenderConfig(width=64, height=48, depth=5, tile_rays=64 * 48)


def golden_job(kind: str, name: str):
    """(jitted frame program, its arguments) behind a golden's render."""
    import jax

    from raytracer_tpu.render import _mc_frame, _tiled_clips, _whitted_frame

    scene, textures, camera = scene_of(name)
    cfg = golden_cfg()
    clips, _, _ = _tiled_clips(cfg, block_order=True)
    if kind == "whitted":
        return _whitted_frame, (scene, camera, clips, textures, cfg)
    return _mc_frame, (scene, camera, clips, jax.random.PRNGKey(MC_KEY),
                       textures, cfg)


def render_golden(kind: str, name: str):
    """The 64x48 depth-5 frame a golden holds, rendered on the default
    device through render.py's entry points: (image, stats)."""
    import jax

    from raytracer_tpu.render import render_distributed_epoch, render_whitted

    scene, textures, camera = scene_of(name)
    if kind == "whitted":
        return render_whitted(scene, textures, camera, golden_cfg())
    return render_distributed_epoch(scene, textures, camera, golden_cfg(),
                                    jax.random.PRNGKey(MC_KEY))


def phase_goldens(rep: Report, goldens=GOLDENS) -> None:
    t0 = time.perf_counter()
    built = warm({f"{k}:{f}": golden_job(k, n) for k, n, f, _ in goldens})
    rep.line(f"goldens: {len(built)} programs compiled concurrently in "
             f"{time.perf_counter() - t0:.1f}s (set-up; per program "
             f"{ {k: round(v[1], 1) for k, v in built.items()} })")
    for kind, name, fname, tol in goldens:
        t0 = time.perf_counter()
        img, stats = render_golden(kind, name)
        img = np.asarray(img)
        dt = time.perf_counter() - t0
        res = compare(img, np.load(os.path.join(GOLDEN_DIR, fname)), tol)
        if stats.get("dropped", 0):
            res["ok"] = False
        res.update(stats=stats, seconds=round(dt, 3))
        rep.check(f"golden {fname}", res)


# ---------------------------------------------------------------------------
# (c) full width: card vs the CPU backend, same program, same clips
# ---------------------------------------------------------------------------

BAND_ROWS = (416, 464)  # 48 rows of 1280 through the glass slabs


def phase_full(rep: Report, width=1280, height=960, band=BAND_ROWS) -> None:
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.ops.tonemap import luma_percentile_scale
    from raytracer_tpu.render import _whitted_frame, clip_coords, render_whitted
    from raytracer_tpu.scene.presets import demo_camera, demo_scene

    scene, textures = demo_scene()
    camera = demo_camera()
    cfg = schedule_cfg(width, height, 3)
    img, stats = render_whitted(scene, textures, camera, cfg)
    img = np.asarray(img)
    r0, r1 = band
    gpu_band = img[r0:r1].reshape(-1, 3)

    cpu = jax.devices("cpu")[0]
    clips = clip_coords(width, height)[r0 * width:r1 * width]
    cfg_band = dataclasses.replace(cfg, tile_rays=clips.shape[0])
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        colors, counters = _whitted_frame(
            jax.device_put(scene, cpu), jax.device_put(camera, cpu),
            jax.device_put(jnp.asarray(clips)[None], cpu), textures, cfg_band)
        cpu_band = np.asarray(colors)[0]
        counters = np.asarray(counters)
    res = compare(gpu_band, cpu_band, TOL_CPU)
    res.update(rows=list(band), cpu_seconds=round(time.perf_counter() - t0, 2),
               dropped_gpu=stats["dropped"], dropped_cpu=int(counters[1]))
    if stats["dropped"] or counters[1]:
        res["ok"] = False
    rep.check(f"full-width {width}x{height} d5 band linear GPU vs CPU", res)

    # tone map: the card's percentile scale of its frame vs the CPU's of
    # the same frame (the scale of the whole frame hangs on one order
    # statistic, so it is checked apart from the shading above)
    flat = img.reshape(-1, 3)
    s_gpu = float(luma_percentile_scale(jnp.asarray(flat), cfg.percentile)[0])
    with jax.default_device(cpu):
        s_cpu = float(luma_percentile_scale(
            jax.device_put(flat, cpu), cfg.percentile)[0])
    rel = abs(s_gpu - s_cpu) / max(abs(s_cpu), 1e-30)
    rep.check("full-width tone-map p99 luma GPU vs CPU (same frame)",
              {"ok": rel <= 1e-6, "gpu": s_gpu, "cpu": s_cpu, "rel": rel})


# ---------------------------------------------------------------------------
# (d) main path
# ---------------------------------------------------------------------------


def _step_line(rep, name, compiled, compile_s, times, extra):
    rep.line(f"step {name}: compile_s={compile_s:.3f} (set-up, concurrent) "
             f"steady_s={[round(t, 4) for t in times]} {json.dumps(extra)} "
             f"memory_analysis={json.dumps(_mem(compiled))} "
             f"peak_bytes_in_use={_peak_bytes()}")


def phase_main(rep: Report, width=1280, height=960, epochs=3,
               mesh_size=1024, mesh_grid=75, reps=2) -> None:
    import jax
    import jax.numpy as jnp

    from raytracer_tpu import cli
    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.parallel.progressive import (
        _epoch_group_packed,
        _epoch_step_packed,
    )
    from raytracer_tpu.render import _mc_frame, _tiled_clips, _whitted_frame
    from raytracer_tpu.scene.presets import demo_camera, demo_scene, mesh_scene

    scene, textures = demo_scene()
    camera = demo_camera()
    cfg = schedule_cfg(width, height, epochs)
    clips, _, inv = _tiled_clips(cfg, block_order=True)
    key = jax.random.PRNGKey(0)
    prev = jnp.zeros((height, width, 3), jnp.float32)

    m_scene, m_tex, m_cam = mesh_scene(grid=mesh_grid)
    m_cfg = RenderConfig(width=mesh_size, height=mesh_size, depth=5,
                         tile_rays=1 << 16)
    m_clips, _, _ = _tiled_clips(m_cfg, block_order=True)
    t0 = time.perf_counter()
    built = warm({
        "whitted": (_whitted_frame, (scene, camera, clips, textures, cfg)),
        "epoch": (_epoch_step_packed, (scene, camera, clips, prev, key, 0,
                                       textures, cfg, inv)),
        "group": (_epoch_group_packed, (scene, camera, clips, prev, key, 0,
                                        textures, cfg, inv, epochs)),
        "mesh_whitted": (_whitted_frame, (m_scene, m_cam, m_clips, m_tex,
                                          m_cfg)),
        "mesh_mc": (_mc_frame, (m_scene, m_cam, m_clips, key, m_tex, m_cfg)),
    })
    rep.line(f"main path: {len(built)} programs compiled concurrently in "
             f"{time.perf_counter() - t0:.1f}s (set-up)")
    (w_c, w_s), (e_c, e_s), (g_c, g_s) = (
        built["whitted"], built["epoch"], built["group"])
    (mw_c, mw_s), (mm_c, mm_s) = built["mesh_whitted"], built["mesh_mc"]

    with tempfile.TemporaryDirectory() as tmp:
        base = ["--scene", "demo", "--width", str(width), "--height",
                str(height), "--depth", "5", "--epochs", str(epochs)]
        per_epoch = os.path.join(tmp, "per_epoch.png")
        grouped = os.path.join(tmp, "grouped.png")
        t0 = time.perf_counter()
        with rep.tagged("cli per-epoch: "):
            rc1 = cli.main(base + ["--out", per_epoch, "--checkpoint",
                                   os.path.join(tmp, "ck.npz")])
        t1 = time.perf_counter()
        with rep.tagged("cli grouped: "):
            rc2 = cli.main(base + ["--out", grouped, "--png-every",
                                   str(epochs)])
        t2 = time.perf_counter()
        with open(per_epoch, "rb") as f:
            a = f.read()
        with open(grouped, "rb") as f:
            b = f.read()
        ckpt_epoch = int(np.load(os.path.join(tmp, "ck.npz"))["epoch"])
    rep.line(f"schedule {width}x{height} d5 whitted+{epochs} epochs: "
             f"per-epoch PNG wall_s={t1 - t0:.3f}, grouped (--png-every "
             f"{epochs}) wall_s={t2 - t1:.3f} (both incl. their whitted "
             f"pass and PNG writes)")
    rep.check("schedule per-epoch vs grouped PNG", {
        "ok": rc1 == 0 and rc2 == 0 and a == b and ckpt_epoch == epochs,
        "byte_identical": a == b, "png_bytes": len(a), "rc": [rc1, rc2],
        "checkpoint_epoch": ckpt_epoch})

    t = steady(lambda: w_c(scene, camera, clips), reps)
    cn = np.asarray(w_c(scene, camera, clips)[1])
    _step_line(rep, f"demo whitted frame {width}x{height}", w_c, w_s, t,
               {"casts": int(cn[0]), "dropped": int(cn[1])})
    ok_w = int(cn[1]) == 0

    t = steady(lambda: e_c(scene, camera, clips, prev, key, 1, inv), reps)
    packed = np.asarray(e_c(scene, camera, clips, prev, key, 1, inv)[1])
    ec = packed[-8:].view(np.int32)
    _step_line(rep, f"demo epoch (MC frame+renorm+u8) {width}x{height}",
               e_c, e_s, t, {"casts": int(ec[0]), "filtered": int(ec[1]),
                             "dropped": "n/a (MC walk keeps every lane)"})

    t = steady(lambda: g_c(scene, camera, clips, prev, key, 0, inv), reps)
    packed = np.asarray(g_c(scene, camera, clips, prev, key, 0, inv)[1])
    gc_ = packed[-8:].view(np.float32)
    _step_line(rep, f"demo {epochs}-epoch group {width}x{height}", g_c, g_s,
               t, {"casts": int(gc_[0]), "filtered": int(gc_[1])})

    t = steady(lambda: mw_c(m_scene, m_cam, m_clips), reps)
    colors, cn = mw_c(m_scene, m_cam, m_clips)
    cn = np.asarray(cn)
    finite = bool(np.isfinite(np.asarray(colors)).all())
    _step_line(rep, f"mesh {m_scene.n_tri}-tri whitted frame "
               f"{mesh_size}x{mesh_size}", mw_c, mw_s, t,
               {"casts": int(cn[0]), "dropped": int(cn[1])})
    t = steady(lambda: mm_c(m_scene, m_cam, m_clips, key), reps)
    photons, mc = mm_c(m_scene, m_cam, m_clips, key)
    mc = np.asarray(mc)
    finite = finite and bool(np.isfinite(np.asarray(photons)).all())
    _step_line(rep, f"mesh {m_scene.n_tri}-tri MC epoch "
               f"{mesh_size}x{mesh_size}", mm_c, mm_s, t,
               {"casts": int(mc[0]), "filtered": int(mc[1])})
    rep.check("main path counters", {
        "ok": ok_w and int(cn[1]) == 0 and int(cn[0]) > 0
        and int(mc[0]) > 0 and finite,
        "demo_dropped": 0 if ok_w else "nonzero",
        "mesh_tris": int(m_scene.n_tri), "mesh_dropped": int(cn[1]),
        "finite": finite})


# ---------------------------------------------------------------------------
# (e) gpu-marked tests, in this process (one process holds the card)
# ---------------------------------------------------------------------------


def phase_gpu_tests(rep: Report) -> None:
    import pytest

    class Tally:
        def __init__(self):
            self.outcomes = []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.outcomes.append(report.outcome)

    tally = Tally()
    with rep.tagged("pytest: "):
        # -o addopts= drops the ini's xdist flags: this process holds the
        # card, and pytest-xdist need not be installed here
        rc = pytest.main(["-q", "-o", "addopts=", "-m", "gpu", "-p",
                          "no:cacheprovider", "-rs",
                          os.path.join(REPO, "tests", "test_gpu.py")],
                         plugins=[tally])
    n_pass = tally.outcomes.count("passed")
    rep.check("gpu-marked tests", {
        "ok": rc == 0 and n_pass > 0 and n_pass == len(tally.outcomes),
        "pytest_rc": int(rc), "passed": n_pass,
        "other": len(tally.outcomes) - n_pass})


# ---------------------------------------------------------------------------
# --multi: the four-card path and what it is compared with
# ---------------------------------------------------------------------------


def _serial_fn(scene, textures, camera, cfg):
    """One rank's MC photons of the sharded epoch, for a single device:
    jitted (clips of one dp shard, the rank's folded key) -> photons."""
    import jax

    from raytracer_tpu.ops import camera as camera_ops
    from raytracer_tpu.ops.distributed import trace_distributed

    @jax.jit
    def one(local, k):
        k_lens, k_path = jax.random.split(k)
        offsets = jax.random.normal(k_lens, (local.shape[0], 2),
                                    local.dtype) * cfg.blur
        o, d = camera_ops.shoot_focus(camera, local, offsets, cfg.focus)
        return trace_distributed(scene, textures, o, d, k_path, cfg).photon

    return one


def _serial_photons(one, clips, dp, sp, key):
    """Photon sum per pixel row of the sharded MC epoch, recomputed on one
    device with the same per-(dp, sp)-rank folded keys."""
    import jax
    import jax.numpy as jnp

    shard = clips.shape[0] // dp
    parts = []
    for di in range(dp):
        local = jnp.asarray(clips[di * shard:(di + 1) * shard])
        acc = 0.0
        for si in range(sp):
            k = jax.random.fold_in(jax.random.fold_in(key, di), si)
            acc = acc + np.asarray(one(local, k))
        parts.append(acc)
    return np.concatenate(parts)


def phase_multi(rep: Report, width=1280, height=960, n_dev=4) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.ops.tonemap import post_process
    from raytracer_tpu.parallel.mesh import (
        _whitted_sharded,
        make_render_mesh,
        render_whitted_sharded,
        sharded_clips,
        train_step_sharded,
        train_steps_sharded,
    )
    from raytracer_tpu.render import _tiled_clips, _whitted_frame, render_whitted
    from raytracer_tpu.scene.presets import demo_camera, demo_scene

    scene, textures = demo_scene()
    camera = demo_camera()
    cfg = RenderConfig(width=width, height=height, depth=5)
    n = width * height

    mesh_w = make_render_mesh(n_dev, sp=1)
    mesh = make_render_mesh(n_dev, sp=2)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    clips, _perm, inv = sharded_clips(cfg, dp, True)
    sharding = NamedSharding(mesh, P("dp"))
    clips_d = jax.device_put(jnp.asarray(clips), sharding)
    base = jax.random.PRNGKey(0)
    one = _serial_fn(scene, textures, camera, cfg)

    def fresh():
        return jax.device_put(jnp.zeros((clips.shape[0], 3), jnp.float32),
                              sharding)

    t0 = time.perf_counter()
    built = warm({
        "whitted one card": (_whitted_frame, (
            scene, camera, _tiled_clips(cfg, block_order=True)[0], textures,
            cfg)),
        "whitted dp": (_whitted_sharded, (
            scene, camera, jnp.asarray(sharded_clips(cfg, n_dev, True)[0]),
            textures, cfg, mesh_w)),
        "train_step": (train_step_sharded, (
            scene, camera, fresh(), clips_d, base, textures, cfg, mesh)),
        "train_steps": (train_steps_sharded, (
            scene, camera, fresh(), clips_d, base, textures, cfg, mesh, 2,
            1)),
        "serial rank": (one, (jnp.asarray(clips[:clips.shape[0] // dp]),
                              base)),
    })
    rep.line(f"multi: {len(built)} programs compiled concurrently in "
             f"{time.perf_counter() - t0:.1f}s (set-up; per program "
             f"{ {k: round(v[1], 1) for k, v in built.items()} })")

    img_s, st_s = render_whitted_sharded(scene, textures, camera, cfg, mesh_w)
    t = steady(lambda: render_whitted_sharded(scene, textures, camera, cfg,
                                              mesh_w)[0])
    img_1, st_1 = render_whitted(scene, textures, camera, cfg)
    res = compare(img_s, img_1, TOL_CPU)
    res.update(mesh=dict(mesh_w.shape), steady_s=[round(x, 4) for x in t],
               casts=[st_s["casts"], st_1["casts"]],
               dropped=[st_s["dropped"], st_1["dropped"]])
    if st_s["dropped"] or st_1["dropped"]:
        res["ok"] = False
    rep.check(f"multi whitted {width}x{height} d5 dp={n_dev} vs one card", res)

    live = (np.arange(clips.shape[0]) < n)[:, None]
    serial = [np.where(live, _serial_photons(
        one, clips, dp, sp, jax.random.fold_in(base, e)), 0.0)
        for e in range(3)]

    acc, _, cn = train_step_sharded(scene, camera, fresh(), clips_d,
                                    jax.random.fold_in(base, 0), textures,
                                    cfg, mesh)
    acc1 = np.asarray(acc)
    want1 = np.asarray(post_process(jnp.asarray(serial[0]), cfg.percentile))
    res = compare(acc1[:n], want1[:n], TOL_MC)
    res.update(mesh=dict(mesh.shape), casts=int(np.asarray(cn)[0]))
    rep.check(f"multi train_step_sharded {width}x{height} vs serial", res)

    acc, _, cn = train_steps_sharded(scene, camera,
                                     jax.device_put(acc1, sharding),
                                     clips_d, base, textures, cfg, mesh, 2, 1)
    acc3 = np.asarray(acc)
    want = want1
    for e in (1, 2):
        want = np.asarray(post_process(jnp.asarray(want + serial[e]),
                                       cfg.percentile))
    res = compare(acc3[:n], want[:n], TOL_MC)
    res.update(casts=int(np.asarray(cn)[0]))
    rep.check(f"multi train_steps_sharded group k=2 {width}x{height} "
              "vs serial", res)

    t1 = steady(lambda: train_step_sharded(
        scene, camera, fresh(), clips_d, base, textures, cfg, mesh)[0])
    t2 = steady(lambda: train_steps_sharded(
        scene, camera, fresh(), clips_d, base, textures, cfg, mesh, 2, 1)[0])
    rep.line(f"multi collective steps (dp={dp}, sp={sp}) {width}x{height}: "
             f"train_step_sharded steady_s={[round(x, 4) for x in t1]} "
             f"train_steps_sharded(k=2) steady_s={[round(x, 4) for x in t2]}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args(argv)

    from raytracer_tpu.utils.cache import cache_dir, enable_compile_cache
    from raytracer_tpu.utils.gpu import card_info, device_record

    enable_compile_cache()
    import jax

    rec = device_record()
    card = card_info()
    rep = Report(card)
    rep.line(f"card: {card}")
    cdir = cache_dir()
    n_cached = sum(len(f) for _, _, f in os.walk(cdir))
    rep.line(f"jax {jax.__version__} devices: {rec} compile cache: {cdir} "
             f"({n_cached} files at start)")
    want = 4 if args.multi else 1
    if rec["platform"] != "gpu" or rec["count"] < want:
        print(f"(a) device: FAIL need {want} GPU(s), JAX reports {rec}",
              file=sys.stderr, flush=True)
        return 2

    run = {"goldens": phase_goldens, "full": phase_full, "main": phase_main,
           "gpu_tests": phase_gpu_tests, "multi": phase_multi}
    for name in phases(args.multi)[1:]:
        t0 = time.perf_counter()
        try:
            run[name](rep)
        except Exception:  # a phase that raises fails, the rest still run
            traceback.print_exc()
            rep.fail(f"phase {name}", "raised (traceback on stderr)")
        rep.line(f"phase {name} done in {time.perf_counter() - t0:.1f}s")
    if rep.failed:
        print(f"FAILED: {rep.failed}", file=sys.stderr, flush=True)
        return 1
    print(result_line(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
