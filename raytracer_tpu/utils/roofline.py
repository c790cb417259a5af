"""Roofline model: attainable casts/s of the dense sweep on one device.

The reference's only perf surface is a bare rays/s counter
(src/main.rs:1111); this module gives that number a denominator — how far
the measured cast rate is from what the device's arithmetic peak allows
for the scene's table size.  bench.py reports the resulting
`roofline_frac`.

Peaks are kept in one table keyed by `jax.devices()[0].device_kind`, with
their source.  A device missing from the table is an error, never a
default: a fraction against the wrong peak is worse than none.

Op-count model (audited against ops/intersect.py `_tri_candidates`,
`_sph_candidates` and the winner reduction in `cast`)
-----------------------------------------------------------------------
An FMA counts as ONE op (it issues as one instruction), so the peak below
is lane-ops/s: the data sheet's FLOP/s (which counts an FMA as two) halved.

per (triangle, ray lane):
    plane:  no_d = d.fn (3) + backface/cull (5) + exclusion (5)
            + o.fn (3) + t = (d_pl - o.fn) / no_d (2)
    edges:  3 x (o.g 3 + d.g 3 + h add 1 + t fma 1 + cmp 1 + and 1) = 30
    keep:   t > 0, isfinite, validity ands, select, min (~11)
    => ~59, rounded up to 62 for the integer compare/select overheads
per (sphere, ray lane): cross (6) + dist2 (3) + tc (3) + sqrt term (2)
    + face selects (5) + exclusion (5) + validity/select/min (~10) => ~34
winner, per (primitive, ray lane): equality, select, max => 3
(the winner's attributes are then gathered once per ray, O(1) in P).

A "cast" in the counters (primary / shadow / bounce / interior march
iteration) sweeps the whole table once, so

    attainable casts/s = lane_ops_per_s / ops_per_cast(T, S).

Everything else a walk does per cast — lobe sampling, shading, state
carries, masked dead lanes, compaction — is work the model EXCLUDES, so
the attainable number is a ceiling and `roofline_frac` charges those
overheads against the sweep.  The dense sweep keeps its tables in cache
and is compute-bound by construction; the HBM rate is kept for bytes-bound
stages.
"""

from __future__ import annotations

from dataclasses import dataclass

OPS_PER_TRI_LANE = 62.0
OPS_PER_SPH_LANE = 34.0
OPS_WINNER_PER_PRIM_LANE = 3.0


@dataclass(frozen=True)
class Peaks:
    device_kind: str
    lane_ops_per_s: float  # f32 non-tensor-core ops/s, FMA = 1
    hbm_bytes_per_s: float
    source: str


_H100_SXM_SOURCE = (
    "NVIDIA H100 Tensor Core GPU data sheet, SXM5 column, at the 700 W "
    "limit: 67 TFLOP/s FP32 (non-tensor; FMA = 2 FLOP), 3.35 TB/s HBM3"
)

PEAKS = {
    p.device_kind: p
    for p in (
        Peaks("NVIDIA H100 80GB HBM3", 67e12 / 2, 3.35e12, _H100_SXM_SOURCE),
    )
}


def peaks_for(device_kind: str) -> Peaks:
    """The published peaks of `device_kind`; KeyError if not tabled."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it "
            f"to utils/roofline.py PEAKS with its source (known: "
            f"{sorted(PEAKS)})"
        ) from None


def dense_cast_ops(n_tri: int, n_sph: int) -> float:
    """Model lane-ops per cast for the dense sweep."""
    return (
        n_tri * (OPS_PER_TRI_LANE + OPS_WINNER_PER_PRIM_LANE)
        + n_sph * (OPS_PER_SPH_LANE + OPS_WINNER_PER_PRIM_LANE)
    )


def dense_attainable_casts(n_tri: int, n_sph: int, peaks: Peaks) -> float:
    """Attainable casts/s if the device did nothing but sweep arithmetic."""
    return peaks.lane_ops_per_s / dense_cast_ops(n_tri, n_sph)
