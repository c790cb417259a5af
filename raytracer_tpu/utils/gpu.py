"""The accelerator a measurement ran on.

Every device number this repo prints names its device: JAX's view
(`platform`, `device_kind`, count) and the card's name and power limit as
`nvidia-smi` reports them.  A card set below its maximum power limit runs
slower under load, so a time without the limit beside it cannot be
compared with another.
"""

from __future__ import annotations

import shutil
import subprocess


def card_info() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    one card per line joined with ' | ' ("not measured" without it)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "not measured (no nvidia-smi)"
    r = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        return f"not measured (nvidia-smi rc={r.returncode})"
    return " | ".join(line.strip() for line in r.stdout.splitlines()
                      if line.strip())


def device_record() -> dict:
    """{"platform", "kind", "count"} of JAX's default devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """device_record(), or SystemExit(2) when JAX found no GPU: device
    numbers are never taken on a fallback backend."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {rec['platform']} "
            f"({rec['kind']}); this measurement runs only on the card"
        )
    return rec
