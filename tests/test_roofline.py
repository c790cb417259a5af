"""Roofline peaks table and the trace-to-metrics reduction."""

import pytest

from raytracer_tpu.utils import profiling, roofline


def test_peaks_by_device_kind():
    p = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert p.lane_ops_per_s == 33.5e12  # 67 TFLOP/s FP32, FMA counted once
    assert p.hbm_bytes_per_s == 3.35e12
    assert "data sheet" in p.source


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "cpu", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_kind_is_an_error(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        roofline.peaks_for(kind)


def test_dense_attainable_casts_demo_table():
    # demo scene: 64 triangles, 4 spheres
    ops = roofline.dense_cast_ops(64, 4)
    assert ops == 64 * (62 + 3) + 4 * (34 + 3)
    p = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert roofline.dense_attainable_casts(64, 4, p) == pytest.approx(
        33.5e12 / 4308)


def test_union_ns_counts_overlap_once():
    assert profiling.union_ns([]) == 0
    assert profiling.union_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert profiling.union_ns([(20, 30), (0, 10), (10, 12)]) == 22


def test_summarize_events_idle_share_and_scopes():
    ev = [
        ("Stream #1(Compute)", "fusion.1", 0, 40, ""),
        ("Stream #1(Compute)", "fusion.2", 30, 30, ""),  # overlaps
        ("Stream #2(MemcpyD2H)", "MemcpyD2H", 80, 20, ""),
        ("XLA Ops", "fusion.1", 0, 40,
         "tf_op=jit(f)/refract_march/while/cond/reduce_or"),
        ("XLA Ops", "fusion.2", 30, 30, "tf_op=jit(f)/refract_march/while/body/x"),
        ("XLA Ops", "fusion.1", 60, 10, "tf_op=jit(f)/refract_march/while/cond/reduce_or"),
    ]
    s = profiling.summarize_events(
        ev, scopes=["refract_march/while/cond", "MemcpyD2H"])
    assert s["window_ns"] == 100 and s["busy_ns"] == 80
    assert s["idle_share"] == pytest.approx(0.2)
    assert s["top_ops"][0] == ("fusion.1", 50 / 1e6, 2)
    assert s["scopes"]["refract_march/while/cond"]["op_events"] == 2
    assert s["scopes"]["MemcpyD2H"]["stream_events"] == 1


def test_summarize_events_without_device_lines():
    s = profiling.summarize_events([("python", "x", 0, 5, "")])
    assert s["idle_share"] is None and s["top_ops"] == []
