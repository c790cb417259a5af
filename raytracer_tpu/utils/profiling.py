"""Profiling / observability utilities.

The reference's only observability is a stopwatch print per pass
(SURVEY.md §5.1, src/main.rs:1110-1111); this framework keeps those
counters (rays, ms, casts/s — parallel/progressive.py) and adds device
tracing: `profile_trace()` wraps any render call in a jax.profiler trace,
and `device_summary()` reduces the written `.xplane.pb` with
`jax.profiler.ProfileData` alone (no TensorBoard, no xprof).

On a GPU the trace holds one plane per device (`/device:GPU:<i>`).  Its
stream lines carry the kernels and copies as they ran; an "XLA Ops" line,
where present, carries the same work attributed to HLO ops.  XLA runs
programs as CUDA command buffers by default, and then the trace has no
op line: kernels are named by their fusion and carry
`hlo_op=command_buffer`, so top ops come from the stream's kernel names.
Busy time is the union of the stream events' intervals over the traced
window; idle share is one minus busy over the window.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
from typing import Dict, Iterable, List, Tuple


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Context manager: device-trace everything inside to `log_dir`."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def latest_xplane(log_dir: str) -> str | None:
    files = sorted(glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                             recursive=True))
    return files[-1] if files else None


def union_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    """Total length covered by [start, end) intervals (overlaps once)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _is_op_line(name: str) -> bool:
    return name == "XLA Ops"


def _is_stream_line(name: str) -> bool:
    return name.startswith("Stream")


Event = Tuple[str, str, int, int, str]  # line, name, start_ns, dur_ns, stats


def summarize_events(events: List[Event], limit: int = 20,
                     scopes: Iterable[str] = ()) -> Dict:
    """Reduce one device's events [(line, name, start_ns, dur_ns, stats)].

    Returns the traced window, busy time and idle share (from the stream
    lines), the top ops by total device time (from the "XLA Ops" line, or
    from the stream events when a trace has no op line), and for each
    substring in `scopes` the count and time of the events whose name or
    stat text contains it (e.g. "MemcpyD2H": one per while-loop
    iteration, whose predicate goes to the host)."""
    stream = [(e[2], e[2] + e[3]) for e in events if _is_stream_line(e[0])]
    ops_src = [e for e in events if _is_op_line(e[0])]
    if not ops_src:
        ops_src = [e for e in events if _is_stream_line(e[0])]
    if not stream:
        return {"window_ns": 0, "busy_ns": 0, "idle_share": None,
                "top_ops": [], "scopes": {}}
    start = min(s for s, _ in stream)
    end = max(e for _, e in stream)
    busy = union_ns(stream)
    total = collections.Counter()
    count = collections.Counter()
    for e in ops_src:
        total[e[1]] += e[3]
        count[e[1]] += 1
    top = [(name, total[name] / 1e6, count[name])
           for name, _ in total.most_common(limit)]
    found = {}
    for sc in scopes:
        hits = [e for e in events if sc in e[1] or sc in e[4]]
        on_ops = [e for e in hits if _is_op_line(e[0])]
        found[sc] = {
            "op_events": len(on_ops),
            "op_ms": sum(e[3] for e in on_ops) / 1e6,
            "stream_events": sum(_is_stream_line(e[0]) for e in hits),
        }
    return {"window_ns": end - start, "busy_ns": busy,
            "idle_share": 1.0 - busy / max(end - start, 1),
            "top_ops": top, "scopes": found}


def device_events(xplane_path: str) -> Dict[str, List[Event]]:
    """{device plane name: [(line, event, start_ns, dur_ns, stats)]} of a
    trace; `stats` joins the event's string-valued stats."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        evs = []
        for line in plane.lines:
            for e in line.events:
                text = " ".join(f"{k}={v}" for k, v in e.stats
                                if isinstance(v, str))
                evs.append((line.name, e.name, int(e.start_ns),
                            int(e.duration_ns), text))
        out[plane.name] = evs
    return out


def device_summary(xplane_path: str, limit: int = 20,
                   scopes: Iterable[str] = ()) -> Dict[str, Dict]:
    """summarize_events for every device plane of a trace."""
    return {name: summarize_events(evs, limit, scopes)
            for name, evs in device_events(xplane_path).items()}


def print_profile(log_dir: str, limit: int = 20) -> None:
    path = latest_xplane(log_dir)
    if path is None:
        print(f"no xplane trace found under {log_dir}")
        return
    summary = device_summary(path, limit)
    if not summary:
        print(f"no device plane in {path} (host-only trace)")
    for plane, s in summary.items():
        print(f"{plane}: window {s['window_ns'] / 1e6:.2f} ms, busy "
              f"{s['busy_ns'] / 1e6:.2f} ms, idle share {s['idle_share']:.4f}")
        print(f"  top {limit} device ops by total time:")
        for name, ms, n in s["top_ops"]:
            print(f"  {ms:10.3f} ms  {n:7d}x  {name[:90]}")
