"""Intersector parity: vectorized cast vs the scalar NumPy oracle,
plus closed-form unit cases for face-direction and exclusion semantics."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracer_tpu.ops.intersect import cast
from raytracer_tpu.scene.builder import MaterialSpec, SceneBuilder, square, triangle
from raytracer_tpu.scene.presets import demo_scene
from raytracer_tpu.scene.types import FACE_BACK, FACE_BOTH, FACE_FRONT, NO_EXCLUDE, Rays

from tests.oracle import OracleWorld

import jax

cast = jax.jit(cast)


def _rays(o, d, face=FACE_FRONT, excl_prim=NO_EXCLUDE, excl_face=FACE_FRONT):
    o = jnp.asarray(o, jnp.float32).reshape(-1, 3)
    d = jnp.asarray(d, jnp.float32).reshape(-1, 3)
    n = o.shape[0]
    mk = lambda v: jnp.full((n,), v, jnp.int32)
    return Rays(o=o, d=d, face=mk(face), excl_prim=mk(excl_prim), excl_face=mk(excl_face))


@pytest.fixture(scope="module")
def simple_scene():
    b = SceneBuilder()
    b.push_object(MaterialSpec(diffuse_color=(1, 0, 0))).push_sphere((0, 0, -3), 1.0)
    # wound so the face normal points +z (toward the origin)
    b.push_object(MaterialSpec(diffuse_color=(0, 1, 0))).push_triangles(
        square([
            ((-2, -2, -6), (0, 0)), ((2, -2, -6), (0, 1)),
            ((2, 2, -6), (1, 0)), ((-2, 2, -6), (1, 1)),
        ])
    )
    b.push_directional_light((0, -1, 0), (1, 1, 1))
    return b.build()


def test_sphere_front_hit(simple_scene):
    h = cast(simple_scene, _rays([0, 0, 0], [0, 0, -1]))
    assert bool(h.valid[0])
    assert float(h.t[0]) == pytest.approx(2.0, abs=1e-5)
    # sphere ids come after triangles
    assert int(h.prim[0]) == simple_scene.n_tri
    np.testing.assert_allclose(np.asarray(h.normal[0]), [0, 0, 1], atol=1e-5)
    assert not bool(h.backface[0])


def test_sphere_back_hit_from_inside(simple_scene):
    h = cast(simple_scene, _rays([0, 0, -3], [0, 0, -1], face=FACE_BACK))
    assert bool(h.valid[0])
    assert float(h.t[0]) == pytest.approx(1.0, abs=1e-5)
    assert bool(h.backface[0])
    # backface normal is flipped: points toward the center side
    np.testing.assert_allclose(np.asarray(h.normal[0]), [0, 0, 1], atol=1e-5)


def test_face_both_picks_far_shell_inside(simple_scene):
    h = cast(simple_scene, _rays([0, 0, -3], [0, 0, -1], face=FACE_BOTH))
    assert bool(h.valid[0]) and bool(h.backface[0])
    assert float(h.t[0]) == pytest.approx(1.0, abs=1e-5)


def test_triangle_hit_behind_sphere(simple_scene):
    # Ray offset so it misses the sphere, hits the wall at z=-6
    h = cast(simple_scene, _rays([0, 1.5, 0], [0, 0, -1]))
    assert bool(h.valid[0])
    assert float(h.t[0]) == pytest.approx(6.0, abs=1e-4)
    assert int(h.prim[0]) < simple_scene.n_tri


def test_exclusion_suppresses_self_hit(simple_scene):
    sphere_id = simple_scene.n_tri
    # From the sphere surface, shooting outward-front would re-hit t=0-ish;
    # the exclusion on the FRONT face suppresses it.
    h = cast(
        simple_scene,
        _rays([0, 0, -2], [0, 0, -1], face=FACE_FRONT,
              excl_prim=sphere_id, excl_face=FACE_FRONT),
    )
    # goes through to the wall? No: FRONT ray from surface along -z would hit
    # the *far* shell as a backface -> culled for FRONT; so the wall at z=-6.
    assert bool(h.valid[0])
    assert int(h.prim[0]) < simple_scene.n_tri


def test_miss(simple_scene):
    h = cast(simple_scene, _rays([0, 0, 0], [0, 0, 1]))
    assert not bool(h.valid[0])


def test_inactive_lane(simple_scene):
    r = _rays([0, 0, 0], [0, 0, -1])
    h = cast(simple_scene, r, active=jnp.asarray([False]))
    assert not bool(h.valid[0])


def test_backface_cull_front_ray():
    b = SceneBuilder()
    b.push_object(MaterialSpec()).push_triangle(
        triangle([((-1, -1, -2), (0, 0)), ((1, -1, -2), (1, 0)), ((0, 1, -2), (0, 1))])
    )
    scene = b.build()
    # winding normal points +z (toward origin): front hit from +z side
    h = cast(scene, _rays([0, 0, 0], [0, 0, -1], face=FACE_FRONT))
    assert bool(h.valid[0])
    # from behind (-z side) it is a backface: FRONT ray culls, BACK ray hits
    h2 = cast(scene, _rays([0, 0, -4], [0, 0, 1], face=FACE_FRONT))
    assert not bool(h2.valid[0])
    h3 = cast(scene, _rays([0, 0, -4], [0, 0, 1], face=FACE_BACK))
    assert bool(h3.valid[0]) and bool(h3.backface[0])
    # backface-flipped normal points back toward the ray origin
    np.testing.assert_allclose(np.asarray(h3.normal[0]), [0, 0, -1], atol=1e-6)


def test_cast_matches_oracle_on_demo_scene():
    scene, textures = demo_scene()
    world = OracleWorld(scene, textures)
    rng = np.random.default_rng(7)
    n = 256
    # random rays from a shell around the scene pointing inward-ish
    o = rng.normal(size=(n, 3)) * 2.0 + np.array([0.5, 1.0, 0.5])
    target = rng.normal(size=(n, 3)) * 1.0 + np.array([0.0, 0.8, 0.0])
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    faces = rng.integers(0, 3, size=n)

    h = cast(scene, _rays(o, d) if False else Rays(
        o=jnp.asarray(o, jnp.float32),
        d=jnp.asarray(d, jnp.float32),
        face=jnp.asarray(faces, jnp.int32),
        excl_prim=jnp.full((n,), NO_EXCLUDE, jnp.int32),
        excl_face=jnp.full((n,), FACE_FRONT, jnp.int32),
    ))

    mismatch = 0
    for i in range(n):
        ref = world.cast(o[i], d[i], int(faces[i]))
        got_valid = bool(h.valid[i])
        if (ref is not None) != got_valid:
            # f32-vs-f64 tie-break flips can happen on grazing hits; forbid
            # more than a tiny fraction
            mismatch += 1
            continue
        if ref is None:
            continue
        if ref.prim != int(h.prim[i]):
            mismatch += 1
            continue
        assert float(h.t[i]) == pytest.approx(ref.t, rel=2e-4, abs=2e-4)
        np.testing.assert_allclose(np.asarray(h.pos[i]), ref.pos, atol=5e-4)
        np.testing.assert_allclose(np.asarray(h.normal[i]), ref.normal, atol=5e-4)
        np.testing.assert_allclose(np.asarray(h.uv[i]), ref.uv, atol=2e-3)
        assert bool(h.backface[i]) == ref.backface
    assert mismatch <= 2, f"{mismatch} mismatches out of {n}"


def test_cast_with_exclusions_matches_oracle():
    scene, textures = demo_scene()
    world = OracleWorld(scene, textures)
    rng = np.random.default_rng(11)
    n = 128
    o = rng.normal(size=(n, 3)) * 1.5 + np.array([0.3, 1.0, 0.3])
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    faces = rng.integers(0, 3, size=n)
    excl_p = rng.integers(-1, scene.n_prim, size=n)
    excl_f = rng.integers(0, 3, size=n)

    h = cast(scene, Rays(
        o=jnp.asarray(o, jnp.float32),
        d=jnp.asarray(d, jnp.float32),
        face=jnp.asarray(faces, jnp.int32),
        excl_prim=jnp.asarray(excl_p, jnp.int32),
        excl_face=jnp.asarray(excl_f, jnp.int32),
    ))

    mismatch = 0
    for i in range(n):
        ref = world.cast(o[i], d[i], int(faces[i]), int(excl_p[i]), int(excl_f[i]))
        if (ref is not None) != bool(h.valid[i]) or (
            ref is not None and ref.prim != int(h.prim[i])
        ):
            mismatch += 1
            continue
        if ref is not None:
            assert float(h.t[i]) == pytest.approx(ref.t, rel=2e-4, abs=2e-4)
    assert mismatch <= 2


# ---------------------------------------------------------------------------
# Lane-by-lane parity with the scalar oracle, by face mode, scene class and
# exclusion (the dense sweep is the one cast implementation for small
# scenes, so these pin it directly against tests/oracle.py).
# ---------------------------------------------------------------------------


def _scene_of_class(kind):
    from raytracer_tpu.scene.presets import demo_scene, spheres_scene

    if kind == "mixed":
        return demo_scene()[0]
    if kind == "spheres":
        b = SceneBuilder()
        for i, (c, r) in enumerate([((-0.9, 0.5, 0.0), 0.5),
                                    ((0.0, 0.5, -0.6), 0.5),
                                    ((0.9, 0.6, 0.1), 0.45)]):
            b.push_object(MaterialSpec(diffuse_color=(1, 0.1 * i, 0))
                          ).push_sphere(c, r)
        b.push_directional_light((0, -1, 0), (1, 1, 1))
        return b.build()
    if kind == "tris":
        # a floor, a wall and one free-standing triangle
        b = SceneBuilder()
        p = b.push_object(MaterialSpec(diffuse_color=(0.8, 0.7, 0.6)))
        p.push_triangles(square([
            ((-4.0, 0.0, -4.0), (0.0, 0.0)), ((-4.0, 0.0, 4.0), (0.0, 1.0)),
            ((4.0, 0.0, 4.0), (1.0, 0.0)), ((4.0, 0.0, -4.0), (0.0, 1.0)),
        ]))
        p.push_triangles(square([
            ((-1.0, 0.0, -1.0), (0.0, 0.0)), ((1.0, 0.0, -1.0), (0.0, 1.0)),
            ((1.0, 2.0, -1.0), (1.0, 0.0)), ((-1.0, 2.0, -1.0), (0.0, 1.0)),
        ]))
        b.push_object(MaterialSpec(diffuse_color=(0.2, 0.9, 0.2))
                      ).push_triangle(triangle([
                          ((-0.5, 0.2, 0.3), (0, 0)), ((0.6, 0.3, 0.1), (1, 0)),
                          ((0.0, 1.4, 0.0), (0, 1))]))
        b.push_directional_light((0, -1, 0), (1, 1, 1))
        return b.build()
    assert kind == "empty"
    b = SceneBuilder()
    b.push_directional_light((0, -1, 0), (1, 1, 1))
    return b.build()


@pytest.mark.parametrize("excl", ["no-excl", "excl"])
@pytest.mark.parametrize("kind", ["spheres", "tris", "mixed", "empty"])
@pytest.mark.parametrize("face", [FACE_FRONT, FACE_BACK, FACE_BOTH],
                         ids=["FRONT", "BACK", "BOTH"])
def test_cast_matches_oracle_by_class(face, kind, excl):
    from raytracer_tpu.scene.textures import DEFAULT_TEXTURES

    scene = _scene_of_class(kind)
    world = OracleWorld(scene, DEFAULT_TEXTURES)
    rng = np.random.default_rng(100 + 7 * face + len(kind))
    n = 64
    o = rng.normal(size=(n, 3)) * 1.5 + np.array([0.2, 0.9, 0.3])
    target = rng.normal(size=(n, 3)) * 0.8 + np.array([0.0, 0.6, 0.0])
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if excl == "excl":
        excl_p = rng.integers(-1, max(scene.n_prim, 1), size=n)
        excl_f = rng.integers(0, 3, size=n)
    else:
        excl_p = np.full(n, NO_EXCLUDE)
        excl_f = np.full(n, FACE_FRONT)

    h = cast(scene, Rays(
        o=jnp.asarray(o, jnp.float32),
        d=jnp.asarray(d, jnp.float32),
        face=jnp.full((n,), face, jnp.int32),
        excl_prim=jnp.asarray(excl_p, jnp.int32),
        excl_face=jnp.asarray(excl_f, jnp.int32),
    ))
    got = {k: np.asarray(getattr(h, k)) for k in
           ("valid", "prim", "obj", "t", "pos", "normal", "uv", "backface")}

    mismatch, hits = 0, 0
    for i in range(n):
        ref = world.cast(o[i], d[i], face, int(excl_p[i]), int(excl_f[i]))
        if (ref is not None) != bool(got["valid"][i]) or (
            ref is not None and ref.prim != int(got["prim"][i])
        ):
            mismatch += 1  # f32-vs-f64 grazing/tie flips only
            continue
        if ref is None:
            assert got["prim"][i] == -1
            continue
        hits += 1
        assert got["t"][i] == pytest.approx(ref.t, rel=2e-4, abs=2e-4)
        np.testing.assert_allclose(got["pos"][i], ref.pos, atol=5e-4)
        np.testing.assert_allclose(got["normal"][i], ref.normal, atol=5e-4)
        np.testing.assert_allclose(got["uv"][i], ref.uv, atol=2e-3)
        assert bool(got["backface"][i]) == ref.backface
        assert int(got["obj"][i]) == ref.obj
    assert mismatch <= 2, f"{mismatch} mismatches out of {n}"
    if kind != "empty":
        assert hits >= 8, f"only {hits} hits: the rays miss the scene"


def _one_light_scene(kind, light):
    """Demo geometry (mixed) or the triangle-only class, with ONE light."""
    import dataclasses

    base = _scene_of_class(kind)
    b = SceneBuilder()
    if light == "directional":
        b.push_directional_light(
            direction=np.asarray([-1.0, -1.0, 0.0]) / np.sqrt(2.0),
            color=(1.0, 0.98, 0.95))
    elif light == "spot":
        b.push_spot_light(origin=(0.0, 10.0, 0.0), direction=(0.0, -1.0, 0.0),
                          angle_rad=np.deg2rad(60.0), softness=1.0,
                          color=(1.0, 0.5, 0.9))
    else:
        b.push_point_light(origin=(0.0, 0.1, 0.0), color=(0.8, 0.8, 1.0))
    lights = b.build()
    return dataclasses.replace(
        base, **{f: getattr(lights, f) for f in (
            "light_type", "light_origin", "light_dir", "light_color",
            "light_angle", "light_softness", "light_has_origin")})


@pytest.mark.parametrize("kind", ["mixed", "tris"])
@pytest.mark.parametrize("light", ["directional", "spot", "point"])
def test_any_hit_matches_oracle_shadow(light, kind):
    """cast_any_hit bounded by the light distance == the oracle's shadow
    test (nearest occluder accepted only if nearer than the light's
    origin; any occluder for directional lights), from real hit points."""
    from raytracer_tpu.ops.intersect import cast_any_hit
    from raytracer_tpu.ops.lights import approximate_directional
    from raytracer_tpu.render import clip_coords
    from raytracer_tpu.scene.presets import demo_camera
    from raytracer_tpu.scene.textures import DEFAULT_TEXTURES
    from raytracer_tpu.ops import camera as camera_ops
    from raytracer_tpu.utils import vec

    scene = _one_light_scene(kind, light)
    world = OracleWorld(scene, DEFAULT_TEXTURES)
    o, d = camera_ops.shoot(demo_camera(), jnp.asarray(clip_coords(12, 9)))
    h = cast(scene, Rays.primary(o, d))
    n = o.shape[0]
    ls = approximate_directional(scene, h.pos)
    ldir = ls.direction[:, 0]
    consider = h.valid & ls.valid[:, 0]
    limit = jnp.where(ls.has_origin[0] > 0.5,
                      vec.distance(h.pos, ls.origin[0][None, :]), jnp.inf)
    shadow = Rays(o=h.pos, d=-ldir, face=jnp.full((n,), FACE_BACK, jnp.int32),
                  excl_prim=h.prim,
                  excl_face=jnp.full((n,), FACE_BACK, jnp.int32))
    blocked = np.asarray(jax.jit(cast_any_hit)(scene, shadow, consider, limit))

    pos, dirs = np.asarray(h.pos, np.float64), -np.asarray(ldir, np.float64)
    prim, cons = np.asarray(h.prim), np.asarray(consider)
    origin = None if light == "directional" else np.asarray(
        scene.light_origin[0], np.float64)
    mismatch = 0
    for i in range(n):
        if not cons[i]:
            assert not blocked[i]
            continue
        occ = world.cast(pos[i], dirs[i], FACE_BACK, int(prim[i]), FACE_BACK)
        want = occ is not None and (
            origin is None
            or np.linalg.norm(pos[i] - occ.pos) < np.linalg.norm(pos[i] - origin)
        )
        mismatch += int(bool(blocked[i]) != want)
    assert int(cons.sum()) >= 20
    assert mismatch <= 2, f"{mismatch} shadow mismatches of {int(cons.sum())}"
