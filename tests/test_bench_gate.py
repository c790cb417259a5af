"""Units for harness machinery: the bench regression gate and the
compaction group width."""

import importlib.util
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py")
    )
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_prior_round_deltas_flags_direction_aware(tmp_path, monkeypatch):
    """Seconds metrics flag when they grow, rate metrics when they shrink;
    <=10% drifts pass silently."""
    m = _bench()
    prev = {"parsed": {"mesh51k_mc_epoch_seconds": 1.0, "value": 100.0,
                       "roofline_frac": 0.10, "whitted_mc_step_mrays_per_sec": 90.0}}
    f = tmp_path / "BENCH_r99.json"
    f.write_text(json.dumps(prev))
    monkeypatch.setattr(m.os.path, "dirname", lambda p: str(tmp_path))
    out = m._prior_round_deltas({
        "mesh51k_mc_epoch_seconds": 1.2,   # 20% slower -> flag
        "value": 120.0,                     # faster -> no flag
        "roofline_frac": 0.085,             # 15% lower -> flag
        "whitted_mc_step_mrays_per_sec": 89.0,  # 1% lower -> no flag
    })
    assert out["prev_round_file"] == "BENCH_r99.json"
    assert set(out["regressions"]) == {"mesh51k_mc_epoch_seconds",
                                       "roofline_frac"}
    assert out["regressions"]["mesh51k_mc_epoch_seconds"]["worse_pct"] == 20.0


def test_prior_round_deltas_absent_file(tmp_path, monkeypatch):
    m = _bench()
    monkeypatch.setattr(m.os.path, "dirname", lambda p: str(tmp_path))
    assert m._prior_round_deltas({"value": 1.0}) == {}


def test_prior_round_deltas_other_device_kind(tmp_path, monkeypatch):
    """A prior run on another device is never read as a regression."""
    m = _bench()
    f = tmp_path / "BENCH_r7.json"
    f.write_text(json.dumps({"device_kind": "NVIDIA A100-SXM4-80GB", "value": 146.0}))
    monkeypatch.setattr(m.os.path, "dirname", lambda p: str(tmp_path))
    out = m._prior_round_deltas({"device_kind": "NVIDIA H100 80GB HBM3",
                                 "value": 1.0})
    assert out == {"prev_round_file": "BENCH_r7.json",
                   "prev_round_skipped": "other device_kind"}


def test_auto_compact_group_by_tile_size():
    """One compaction group width for every tile size: 32-wide groups
    overflow the pools of sparse small frames and of glass-heavy full
    tiles alike, while 8 keeps every ray."""
    import dataclasses

    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.render import render_whitted
    from raytracer_tpu.scene.presets import demo_camera, demo_scene

    assert RenderConfig().compact_group == 8
    scene, textures = demo_scene()
    cfg = RenderConfig(width=64, height=48, depth=5, tile_rays=64 * 48)
    _, wide = render_whitted(scene, textures, demo_camera(),
                             dataclasses.replace(cfg, compact_group=32))
    _, default = render_whitted(scene, textures, demo_camera(), cfg)
    assert wide["dropped"] > 0
    assert default["dropped"] == 0
