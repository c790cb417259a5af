"""Render configuration.

The reference hardcodes every knob in main() (src/main.rs:1084-1174:
1280x960, depth 5, 100 epochs, focus 3.0, blur 0.04, threshold 0.001,
max refract distance 100.0, 10 TIR retries).  Here they are a config
dataclass; the defaults reproduce the reference's values.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1280
    height: int = 960
    # Bounce depth for both the Whitted and the distributed pass
    # (reference: src/main.rs:1098, src/main.rs:1139).
    depth: int = 5
    # Contribution cutoff of the Whitted tracer (src/main.rs:467).
    threshold: float = 0.001
    # Interior-march budget of get_refract (src/main.rs:378, call sites
    # src/main.rs:505/601 pass 100.0).
    max_refract_distance: float = 100.0
    max_tir_retries: int = 10
    # Distributed pass (src/main.rs:1129-1148).
    epochs: int = 100
    focus: float = 3.0
    blur: float = 0.04
    # Tone normalization percentile (src/main.rs:754 uses 0.99).
    percentile: float = 0.99

    # --- Execution knobs (no reference equivalent) ---
    # Rays per device tile; the image is rendered in tiles of this many
    # pixels so wavefront buffers stay bounded.
    tile_rays: int = 1 << 16
    # Wavefront pool capacity factor: the bounce-ray pool holds
    # capacity_factor * tile_rays slots (rounded up to 128).  2.0 is
    # exact by construction (each live ray emits at most 2 children);
    # overflow is counted in TraceResult.dropped, never silent.
    capacity_factor: float = 2.0
    # Pool width for deep bounce levels (level >= 2), as a multiple of the
    # primary count.  Live rays decay fast (demo scene: 0.60n entering
    # level 2, 0.30n at level 5), so deep levels run in a narrower pool.
    # Compaction moves whole groups of `compact_group` rays (ops/trace.py
    # _compact), so the pool also holds each kept group's dead lanes —
    # capacities are sized for that occupancy, not just the live count
    # (demo scene: live candidates entering level 2 are ~0.8n mean /
    # ~1.2n worst tile; 1.25 drops rays, 1.375 + the fixed slack holds
    # dropped=0); overflow is counted in TraceResult.dropped, never silent.
    deep_capacity: float = 1.375
    deep_slack: int = 2048
    # Pool width for tail bounce levels (level >= 3): live rays are at
    # most ~0.45n entering level 3 on the demo scene.  The pool also holds
    # zombie lanes (alive=False, pending radiance undelivered —
    # ops/trace.py Pool) which are compute-free yet occupy capacity; their
    # pressure is mostly a small-frame effect, so trace_whitted adds a
    # fixed `tail_slack` on top of the factor rather than widening large
    # frames.  1.25/4096 holds dropped=0 on every preset and bench scene.
    tail_capacity: float = 1.25
    tail_slack: int = 4096
    # Rays move through compaction in groups of this many (one scatter row
    # per group, so coarser groups make fewer, wider scatter rows at some
    # pool-occupancy cost).  32-wide groups overflow the pools: 260 rays
    # dropped at 64x48, and 14,102 over three glass-heavy tiles of the
    # 1280x960 reference frame (the CPU and the H100 alike); 8 holds
    # dropped=0 on both.
    compact_group: int = 8
    # f32 everywhere (geometry needs it); kept as a knob for experiments.
    dtype: str = "float32"

    @property
    def n_pixels(self) -> int:
        return self.width * self.height


# Preset matching the reference binary exactly.
REFERENCE_CONFIG = RenderConfig()

# The BASELINE.json north-star target frame.
NORTH_STAR_CONFIG = RenderConfig(width=1024, height=1024)
