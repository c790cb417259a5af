"""BVH build invariants and traversal parity vs the dense sweep."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.ops.intersect import cast
from raytracer_tpu.scene.builder import MaterialSpec, SceneBuilder, Vertex
from raytracer_tpu.scene.bvh import build_bvh, validate_bvh
from raytracer_tpu.scene.types import NO_EXCLUDE, Rays


def _random_mesh_builder(n_tris=900, seed=0):
    """A soup of small random triangles in [-2,2]^3 plus two spheres."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    obj = b.push_object(MaterialSpec(diffuse_color=(0.8, 0.7, 0.6), shiness=0.3))
    centers = rng.uniform(-2, 2, size=(n_tris, 3)).astype(np.float32)
    for c in centers:
        offs = rng.uniform(-0.15, 0.15, size=(3, 3)).astype(np.float32)
        v = c[None, :] + offs
        a = v[1] - v[0]
        bb = v[2] - v[1]
        n = np.cross(a, bb)
        nn = np.linalg.norm(n)
        if nn < 1e-8:
            v[2] += 0.05
            n = np.cross(v[1] - v[0], v[2] - v[1])
            nn = np.linalg.norm(n)
        n = (n / nn).astype(np.float32)
        obj.push_triangle([Vertex(v[i], n, np.zeros(2, np.float32)) for i in range(3)])
    b.push_object(MaterialSpec(diffuse_color=(1, 0, 0))).push_sphere((0, 0, 0), 0.7)
    b.push_object(MaterialSpec(diffuse_color=(0, 0, 1))).push_sphere((1, 1, 1), 0.4)
    b.push_directional_light((0, -1, 0), (1, 1, 1))
    return b


def test_build_invariants():
    b = _random_mesh_builder(300)
    scene_flat = b.build(use_bvh=False)
    bvh = build_bvh(np.asarray(scene_flat.tri_v))
    validate_bvh(bvh, np.asarray(scene_flat.tri_v))
    assert bvh.depth <= 16


def test_auto_threshold():
    b = _random_mesh_builder(60)
    assert b.build(use_bvh="auto").bvh_node_min is None
    assert b.build(use_bvh=True).bvh_node_min is not None
    big = _random_mesh_builder(600).build(use_bvh="auto")
    assert big.bvh_node_min is not None


@pytest.mark.slow
def test_bvh_cast_matches_dense_sweep():
    b = _random_mesh_builder(900, seed=3)
    dense = b.build(use_bvh=False)
    accel = b.build(use_bvh=True)

    rng = np.random.default_rng(1)
    n = 512
    o = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = Rays(
        o=jnp.asarray(o),
        d=jnp.asarray(d),
        face=jnp.asarray(rng.integers(0, 3, n), jnp.int32),
        excl_prim=jnp.asarray(rng.integers(-1, dense.n_prim, n), jnp.int32),
        excl_face=jnp.asarray(rng.integers(0, 3, n), jnp.int32),
    )

    h_dense = jax.jit(lambda r: cast(dense, r))(rays)
    h_bvh = jax.jit(lambda r: cast(accel, r))(rays)

    va, vb = np.asarray(h_dense.valid), np.asarray(h_bvh.valid)
    assert np.array_equal(va, vb)
    both = va & vb
    # tie flips between equal-t triangles are possible in f32; require
    # identical primitive on >99% and identical t everywhere
    same_prim = np.asarray(h_dense.prim)[both] == np.asarray(h_bvh.prim)[both]
    assert same_prim.mean() > 0.99
    np.testing.assert_allclose(
        np.asarray(h_bvh.t)[both], np.asarray(h_dense.t)[both], rtol=1e-5, atol=1e-5
    )
    sp = same_prim
    np.testing.assert_allclose(
        np.asarray(h_bvh.normal)[both][sp], np.asarray(h_dense.normal)[both][sp],
        atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(h_bvh.pos)[both][sp], np.asarray(h_dense.pos)[both][sp],
        atol=1e-4,
    )
    assert np.array_equal(
        np.asarray(h_bvh.backface)[both][sp], np.asarray(h_dense.backface)[both][sp]
    )


def test_bvh_whitted_render_matches_dense():
    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.render import render_whitted
    from raytracer_tpu.scene.presets import demo_camera
    from raytracer_tpu.scene.textures import DEFAULT_TEXTURES

    b = _random_mesh_builder(600, seed=5)
    dense = b.build(use_bvh=False)
    accel = b.build(use_bvh=True)
    cfg = RenderConfig(width=16, height=12, depth=2, tile_rays=16 * 12)
    cam = demo_camera()
    img_a, _ = render_whitted(dense, DEFAULT_TEXTURES, cam, cfg)
    img_b, _ = render_whitted(accel, DEFAULT_TEXTURES, cam, cfg)
    np.testing.assert_allclose(np.asarray(img_b), np.asarray(img_a),
                               atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("mode", ["full", "geom", "any_hit"])
def test_bvh_matches_dense_by_mode(mode):
    """The BVH path (every scene of >= 512 triangles) against the dense
    sweep, for both attribute sets of `cast` and for the shadow any-hit
    predicate with a distance limit."""
    from raytracer_tpu.ops.intersect import cast_any_hit

    b = _random_mesh_builder(600, seed=7)
    dense = b.build(use_bvh=False)
    accel = b.build(use_bvh=True)
    rng = np.random.default_rng(2)
    n = 256
    o = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    d = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = Rays(
        o=jnp.asarray(o), d=jnp.asarray(d),
        face=jnp.asarray(rng.integers(0, 3, n), jnp.int32),
        excl_prim=jnp.asarray(rng.integers(-1, dense.n_prim, n), jnp.int32),
        excl_face=jnp.asarray(rng.integers(0, 3, n), jnp.int32),
    )
    if mode == "any_hit":
        limit = jnp.asarray(rng.uniform(0.2, 6.0, n), jnp.float32)
        fn = jax.jit(lambda s, r: cast_any_hit(s, r, limit=limit))
        a, b_ = np.asarray(fn(dense, rays)), np.asarray(fn(accel, rays))
        assert a.any() and not a.all()
        assert (a != b_).sum() <= 2
        return

    fn = jax.jit(lambda s, r: cast(s, r, attrs=mode))
    hd, hb = fn(dense, rays), fn(accel, rays)
    va, vb = np.asarray(hd.valid), np.asarray(hb.valid)
    assert va.sum() > 50
    assert (va != vb).sum() <= 2
    both = va & vb
    same = np.asarray(hd.prim)[both] == np.asarray(hb.prim)[both]
    assert same.mean() > 0.99
    np.testing.assert_allclose(np.asarray(hb.t)[both], np.asarray(hd.t)[both],
                               rtol=1e-5, atol=1e-5)
    for k in ("pos", "normal"):
        np.testing.assert_allclose(np.asarray(getattr(hb, k))[both][same],
                                   np.asarray(getattr(hd, k))[both][same],
                                   atol=1e-4)
    if mode == "full":
        np.testing.assert_allclose(np.asarray(hb.uv)[both][same],
                                   np.asarray(hd.uv)[both][same], atol=1e-4)
        np.testing.assert_array_equal(np.asarray(hb.obj)[both],
                                      np.asarray(hd.obj)[both])
