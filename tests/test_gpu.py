"""Checks that only mean something on the card: the GPU against the CPU
backend of the same process.  They skip elsewhere; `python chip_smoke.py`
runs them on the GPU (phase (e))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.ops import intersect
from raytracer_tpu.ops.intersect import cast
from raytracer_tpu.scene.presets import demo_scene, mesh_scene
from raytracer_tpu.scene.types import FACE_FRONT, NO_EXCLUDE, Rays

pytestmark = pytest.mark.gpu


def _random_rays(n, seed, center, spread, axis_aligned=False):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * spread + np.asarray(center)
    d = rng.normal(size=(n, 3))
    if axis_aligned:  # zero direction components: 1/d = +-inf in the slabs
        rows = np.arange(n // 2)
        d[rows, rng.integers(0, 3, n // 2)] = 0.0  # one zero component
        d[rows[: n // 4], (rows[: n // 4] + 1) % 3] = 0.0  # some have two
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return Rays(
        o=jnp.asarray(o, jnp.float32), d=jnp.asarray(d, jnp.float32),
        face=jnp.full((n,), FACE_FRONT, jnp.int32),
        excl_prim=jnp.full((n,), NO_EXCLUDE, jnp.int32),
        excl_face=jnp.full((n,), FACE_FRONT, jnp.int32),
    )


def test_geometry_product_runs_at_full_f32(gpu):
    """intersect._dots never runs in TF32: its [N,3]x[T,3] products match a
    float64 product to float32 rounding, not TF32's ~1e-3."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4096, 3)).astype(np.float32)
    b = rng.normal(size=(3, 128)).astype(np.float32)
    got = np.asarray(jax.jit(intersect._dots)(a, b.T))
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(got - want).max() < 1e-5


def test_dense_cast_gpu_matches_cpu(gpu):
    scene, _ = demo_scene()
    rays = _random_rays(4096, 1, [0.5, 1.0, 0.5], 2.0)
    cpu = jax.devices("cpu")[0]
    hg = jax.jit(cast)(scene, rays)
    hc = jax.jit(cast)(*jax.device_put((scene, rays), cpu))
    vg, vc = np.asarray(hg.valid), np.asarray(hc.valid)
    assert vg.sum() > 500 and (vg != vc).sum() <= 2
    both = vg & vc
    assert (np.asarray(hg.prim)[both] == np.asarray(hc.prim)[both]).mean() > 0.999
    np.testing.assert_allclose(np.asarray(hg.t)[both], np.asarray(hc.t)[both],
                               rtol=1e-5, atol=1e-5)


def test_bvh_slab_inf_nan_gpu_matches_cpu(gpu):
    """The BVH slab test divides by zero direction components (1/d = +-inf,
    0 * inf = NaN in min/max): the card must miss and hit exactly the boxes
    the CPU does."""
    scene, _, _ = mesh_scene(grid=24)
    rays = _random_rays(4096, 2, [0.0, 1.5, 0.0], 1.0, axis_aligned=True)
    cpu = jax.devices("cpu")[0]
    hg = jax.jit(cast)(scene, rays)
    hc = jax.jit(cast)(*jax.device_put((scene, rays), cpu))
    vg, vc = np.asarray(hg.valid), np.asarray(hc.valid)
    assert vg.sum() > 500 and (vg != vc).sum() <= 2
    both = vg & vc
    assert (np.asarray(hg.prim)[both] == np.asarray(hc.prim)[both]).mean() > 0.999


def test_tonemap_scale_gpu_matches_cpu(gpu):
    from raytracer_tpu.ops.tonemap import post_process

    rng = np.random.default_rng(3)
    img = (rng.gamma(2.0, 0.3, size=(240, 320, 3))).astype(np.float32)
    img[::7, ::5] = 0.0  # non-normal luma lanes are excluded
    cpu = jax.devices("cpu")[0]
    g = np.asarray(jax.jit(post_process)(img))
    c = np.asarray(jax.jit(post_process)(jax.device_put(img, cpu)))
    np.testing.assert_allclose(g, c, rtol=1e-6, atol=0)
