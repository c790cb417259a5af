"""Degenerate scene shapes: sphere-only, triangle-only, empty."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.config import RenderConfig
from raytracer_tpu.ops.intersect import cast, cast_any_hit
from raytracer_tpu.render import render_whitted
from raytracer_tpu.scene.builder import MaterialSpec, SceneBuilder, square
from raytracer_tpu.scene.presets import demo_camera
from raytracer_tpu.scene.textures import DEFAULT_TEXTURES
from raytracer_tpu.scene.types import Rays

from tests.oracle import OracleWorld


def _sphere_only():
    b = SceneBuilder()
    b.push_object(MaterialSpec(diffuse_color=(1, 0, 0), shiness=0.2)).push_sphere(
        (0, 0.5, 0), 0.5
    )
    b.push_directional_light((0, -1, 0), (1, 1, 1))
    return b.build()


def _tri_only():
    b = SceneBuilder()
    b.push_object(MaterialSpec(diffuse_color=(0, 1, 0), shiness=0.3)).push_triangles(
        square([  # wound so the face normal points +y
            ((-2, 0, -2), (0, 0)), ((-2, 0, 2), (0, 1)),
            ((2, 0, 2), (1, 0)), ((2, 0, -2), (1, 1)),
        ])
    )
    b.push_directional_light((0, -1, 0), (1, 1, 1))
    return b.build()


def _empty():
    b = SceneBuilder()
    b.push_directional_light((0, -1, 0), (1, 1, 1))
    return b.build()


@pytest.mark.parametrize("maker", [_sphere_only, _tri_only, _empty],
                         ids=["spheres", "tris", "empty"])
def test_cast_degenerate(maker):
    scene = maker()
    rays = Rays.primary(
        jnp.asarray([[0.0, 3.0, 0.0]] * 4, jnp.float32),
        jnp.asarray([[0.0, -1.0, 0.0]] * 4, jnp.float32),
    )
    h = cast(scene, rays)
    blocked = cast_any_hit(scene, rays)
    if scene.n_prim == 0:
        assert not bool(h.valid.any()) and not bool(blocked.any())
    else:
        assert bool(h.valid.all()) and bool(blocked.all())
        assert np.isfinite(np.asarray(h.pos)).all()


def test_render_whitted_degenerate_scenes():
    cfg = RenderConfig(width=8, height=6, depth=2, tile_rays=48)
    for maker in (_sphere_only, _tri_only, _empty):
        img, stats = render_whitted(maker(), DEFAULT_TEXTURES, demo_camera(), cfg)
        assert np.isfinite(np.asarray(img)).all()
        assert stats["dropped"] == 0


def _glass_sphere_only():
    b = SceneBuilder()
    b.push_object(MaterialSpec(diffuse_color=(1, 1, 1), shiness=1.0,
                               smoothness=0.001, refraction_index=1.12,
                               opaque_decay=0.3, transparency=0.96)
                  ).push_sphere((0, 0.5, 0), 0.5)
    b.push_directional_light((0, -1, 0), (1, 1, 1))
    return b.build()


def _glass_tris_only():
    b = SceneBuilder()
    glass = MaterialSpec(diffuse_color=(1, 0.8, 0.6), shiness=1.0,
                         smoothness=1e-5, refraction_index=1.6,
                         opaque_decay=0.1, transparency=1.0)
    p = b.push_object(glass)
    # closed slab z in [0.0, 0.2]
    p.push_triangles(square([
        ((0.5, 1.5, 0.2), (0, 0)), ((-0.5, 1.5, 0.2), (0, 1)),
        ((-0.5, 0.5, 0.2), (1, 0)), ((0.5, 0.5, 0.2), (0, 1)),
    ]))
    p.push_triangles(square([
        ((0.5, 0.5, 0.0), (0, 1)), ((-0.5, 0.5, 0.0), (1, 0)),
        ((-0.5, 1.5, 0.0), (0, 1)), ((0.5, 1.5, 0.0), (0, 0)),
    ]))
    b.push_directional_light((0, -1, 0), (1, 1, 1))
    return b.build()


@pytest.mark.parametrize("maker", [_glass_sphere_only, _glass_tris_only],
                         ids=["glass-sphere", "glass-tris"])
def test_march_degenerate_glass(maker):
    """The interior march handles sphere-only and triangle-only dielectrics:
    the render matches the scalar oracle (tests/oracle.py), whose
    get_refract walks the same TIR retries one ray at a time in f64."""
    scene = maker()
    cfg = RenderConfig(width=10, height=8, depth=3, tile_rays=80)
    cam = demo_camera()
    img, stats = render_whitted(scene, DEFAULT_TEXTURES, cam, cfg)
    img = np.asarray(img)
    assert np.isfinite(img).all()
    assert stats["dropped"] == 0
    ref = OracleWorld(scene, DEFAULT_TEXTURES).render_whitted(
        cam, cfg.width, cfg.height, depth=cfg.depth
    )
    np.testing.assert_allclose(img, ref, atol=2e-4, rtol=1e-3)
