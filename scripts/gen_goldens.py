"""Generate committed oracle goldens for the preset scenes.

The scalar NumPy oracle (tests/oracle.py) mirrors the reference's recursive
structure (src/main.rs:466-519) and is far too slow to run at useful
resolutions inside the test suite (~minutes per 64x48 depth-5 frame), so
this script renders each preset ONCE with multiprocessing and commits the
result under tests/golden/.  tests/test_presets_golden.py then pins the
renderer against these files at full depth 5.

Rerun after any intentional semantic change:
    python scripts/gen_goldens.py
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

W, H, DEPTH = 64, 48, 5

_WORLD = None
_CAM = None


def _init(preset_name: str):
    global _WORLD, _CAM
    import jax

    # Every worker builds its scene tables with JAX; pin them to the CPU so
    # a pool on a GPU machine never opens the card once per worker.
    jax.config.update("jax_platforms", "cpu")
    from oracle import OracleWorld

    from raytracer_tpu.scene import presets

    maker = presets.PRESETS[preset_name]
    out = maker()
    scene, textures = out[:2]
    _CAM = out[2] if len(out) > 2 else presets.demo_camera()
    _WORLD = OracleWorld(scene, textures)


def _render_row(py: int) -> np.ndarray:
    cam, world = _CAM, _WORLD
    fovy = float(cam.fovy)
    center = np.asarray(cam.center, np.float64)
    toward = np.asarray(cam.toward, np.float64)
    toward = toward / np.linalg.norm(toward)
    up0 = np.asarray(cam.up, np.float64)
    right = np.cross(toward, up0)
    right /= np.linalg.norm(right)
    up = np.cross(right, toward)
    up /= np.linalg.norm(up)
    x = np.tan(fovy / 2.0) * right
    y = np.tan(fovy / 2.0) * up
    origin = center + toward * float(cam.near)
    row = np.zeros((W, 3))
    for px in range(W):
        cy = (H / 2.0 - py) / H
        cx = (px - W / 2.0) / H
        d = cx * x + cy * y + toward
        d = d / np.linalg.norm(d)
        row[px] = world.ray_trace(DEPTH, 1.0, origin, d)
    return row


def main() -> int:
    names = ["01-spheres", "02-triangles", "03-recursive", "06-obj", "demo"]
    outdir = os.path.join(ROOT, "tests", "golden")
    os.makedirs(outdir, exist_ok=True)
    for name in names:
        path = os.path.join(outdir, f"oracle_{name}_{W}x{H}_d{DEPTH}.npy")
        t0 = time.time()
        ctx = mp.get_context("spawn")
        with ctx.Pool(os.cpu_count(), initializer=_init,
                      initargs=(name,)) as p:
            rows = p.map(_render_row, range(H))
        img = np.stack(rows).astype(np.float32)
        np.save(path, img)
        print(f"{name}: {time.time() - t0:.1f}s -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
