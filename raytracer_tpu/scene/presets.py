"""Scene presets.

`demo_scene()` reproduces the reference's hardcoded scene byte-for-byte in
intent (reference: src/main.rs:809-1083): 9 objects (OBJ dodecahedron, floor,
striped bump-mapped wall, two glass slabs, red/clear/checker/green spheres)
and 3 lights (white directional, pink spot, bluish point), plus the demo
camera.  The BASELINE.json configs 01..08 are subset scenes for testing.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from raytracer_tpu.scene.builder import MaterialSpec, SceneBuilder, square
from raytracer_tpu.scene.geometry import dodecahedron_triangles
from raytracer_tpu.scene.textures import (
    DEFAULT_TEXTURES,
    TEXTURE_CHECKER,
    TEXTURE_STRIPES,
)
from raytracer_tpu.scene.types import Camera, Scene
from raytracer_tpu.utils.obj import load_obj_triangles

WHITE = (1.0, 1.0, 1.0)
YELLOW = (1.0, 1.0, 0.0)
BLUE = (0.0, 0.0, 1.0)

# The demo bake transform for the OBJ mesh (src/main.rs:802).
_DODE_TRANSFORM = lambda p: p / 3.0 + np.asarray([0.7, 1.0, -0.5], np.float32)


def demo_camera() -> Camera:
    """fovy 60deg, center (2, 2.5, 2), toward -(1,1,1)/sqrt(3), up +y,
    near -0.1 (src/main.rs:1077-1083)."""
    return Camera.create(
        fovy_deg=60.0,
        center=(2.0, 2.5, 2.0),
        toward=np.asarray([-1.0, -1.0, -1.0]) / np.sqrt(3.0),
        up=(0.0, 1.0, 0.0),
        near=-0.1,
    )


def _dodecahedron_tris(obj_path=None):
    if obj_path and os.path.exists(obj_path):
        return load_obj_triangles(obj_path, transform=_DODE_TRANSFORM)
    return dodecahedron_triangles(transform=_DODE_TRANSFORM)


def demo_scene(obj_path: str | None = None) -> Tuple[Scene, tuple]:
    b = SceneBuilder()

    # Dodecahedron: white, shiness 0.1 (src/main.rs:812-825)
    b.push_object(
        MaterialSpec(
            diffuse_color=WHITE, shiness=0.1, specular_color=WHITE,
            smoothness=1.0, refraction_index=1.0, opaque_decay=0.0,
            transparency=0.0,
        )
    ).push_triangles(_dodecahedron_tris(obj_path))

    # Floor: tan square, shiness 0.5 (src/main.rs:826-844)
    b.push_object(
        MaterialSpec(
            diffuse_color=(1.0, 0.8, 0.6), shiness=0.5, specular_color=WHITE,
            smoothness=0.01,
        )
    ).push_triangles(
        square([
            ((-2.0, 0.0, -2.0), (0.0, 0.0)),
            ((-2.0, 0.0, 2.0), (0.0, 1.0)),
            ((2.0, 0.0, 2.0), (1.0, 0.0)),
            ((2.0, 0.0, -2.0), (0.0, 1.0)),
        ])
    )

    # Striped wall with procedural bump normal (src/main.rs:845-877)
    b.push_object(
        MaterialSpec(
            shiness=0.0, specular_color=WHITE, smoothness=0.00001,
            texture=TEXTURE_STRIPES,
        )
    ).push_triangles(
        square([
            ((-2.0, 2.0, -2.0), (0.0, 0.0)),
            ((-2.0, 2.0, 2.0), (0.0, 1.0)),
            ((-2.0, -2.0, 2.0), (1.0, 0.0)),
            ((-2.0, -2.0, -2.0), (1.0, 1.0)),
        ])
    )

    glass = MaterialSpec(
        diffuse_color=(1.0, 0.8, 0.6), shiness=1.0, specular_color=WHITE,
        smoothness=0.00001, refraction_index=1.6, opaque_decay=0.1,
        transparency=1.0,
    )

    # Glass slab 1: z in [0.6, 0.7] (src/main.rs:879-927)
    p = b.push_object(glass)
    p.push_triangles(square([
        ((0.5, 1.5, 0.7), (0.0, 0.0)), ((-0.5, 1.5, 0.7), (0.0, 1.0)),
        ((-0.5, 1.0, 0.7), (1.0, 0.0)), ((0.5, 1.0, 0.7), (0.0, 1.0)),
    ]))
    p.push_triangles(square([
        ((0.5, 1.0, 0.6), (0.0, 1.0)), ((-0.5, 1.0, 0.6), (1.0, 0.0)),
        ((-0.5, 1.5, 0.6), (0.0, 1.0)), ((0.5, 1.5, 0.6), (0.0, 0.0)),
    ]))
    p.push_triangles(square([
        ((0.5, 1.5, 0.6), (0.0, 1.0)), ((-0.5, 1.5, 0.6), (1.0, 0.0)),
        ((-0.5, 1.5, 0.7), (0.0, 1.0)), ((0.5, 1.5, 0.7), (0.0, 0.0)),
    ]))
    p.push_triangles(square([
        ((0.5, 1.0, 0.7), (0.0, 1.0)), ((-0.5, 1.0, 0.7), (1.0, 0.0)),
        ((-0.5, 1.0, 0.6), (0.0, 1.0)), ((0.5, 1.0, 0.6), (0.0, 0.0)),
    ]))
    p.push_triangles(square([
        ((-0.5, 1.5, 0.6), (0.0, 1.0)), ((-0.5, 1.0, 0.6), (1.0, 0.0)),
        ((-0.5, 1.0, 0.7), (0.0, 1.0)), ((-0.5, 1.5, 0.7), (0.0, 0.0)),
    ]))
    p.push_triangles(square([
        ((0.5, 1.0, 0.6), (0.0, 1.0)), ((0.5, 1.5, 0.6), (1.0, 0.0)),
        ((0.5, 1.5, 0.7), (0.0, 1.0)), ((0.5, 1.0, 0.7), (0.0, 0.0)),
    ]))

    # Glass slab 2: z in [0.71, 0.81], x in [-0.3, 0.3] (src/main.rs:929-977)
    p = b.push_object(glass)
    p.push_triangles(square([
        ((0.3, 1.5, 0.81), (0.0, 0.0)), ((-0.3, 1.5, 0.81), (0.0, 1.0)),
        ((-0.3, 1.0, 0.81), (1.0, 0.0)), ((0.3, 1.0, 0.81), (0.0, 1.0)),
    ]))
    p.push_triangles(square([
        ((0.3, 1.0, 0.71), (0.0, 1.0)), ((-0.3, 1.0, 0.71), (1.0, 0.0)),
        ((-0.3, 1.5, 0.71), (0.0, 1.0)), ((0.3, 1.5, 0.71), (0.0, 0.0)),
    ]))
    p.push_triangles(square([
        ((0.3, 1.5, 0.71), (0.0, 1.0)), ((-0.3, 1.5, 0.71), (1.0, 0.0)),
        ((-0.3, 1.5, 0.81), (0.0, 1.0)), ((0.3, 1.5, 0.81), (0.0, 0.0)),
    ]))
    p.push_triangles(square([
        ((-0.3, 1.5, 0.71), (0.0, 1.0)), ((-0.3, 1.0, 0.71), (1.0, 0.0)),
        ((-0.3, 1.0, 0.81), (0.0, 1.0)), ((-0.3, 1.5, 0.81), (0.0, 0.0)),
    ]))
    p.push_triangles(square([
        ((0.3, 1.0, 0.81), (0.0, 1.0)), ((-0.3, 1.0, 0.81), (1.0, 0.0)),
        ((-0.3, 1.0, 0.71), (0.0, 1.0)), ((0.3, 1.0, 0.71), (0.0, 0.0)),
    ]))
    p.push_triangles(square([
        ((0.3, 1.0, 0.71), (0.0, 1.0)), ((0.3, 1.5, 0.71), (1.0, 0.0)),
        ((0.3, 1.5, 0.81), (0.0, 1.0)), ((0.3, 1.0, 0.81), (0.0, 0.0)),
    ]))

    # Red sphere, yellow specular (src/main.rs:979-996)
    b.push_object(
        MaterialSpec(
            diffuse_color=(1.0, 0.2, 0.2), shiness=0.2, specular_color=YELLOW,
            smoothness=0.2,
        )
    ).push_sphere((-0.5, 0.5, 0.5 / np.sqrt(3.0)), 0.5)

    # Clear sphere: ior 1.12, transparency 0.96 (src/main.rs:998-1014)
    b.push_object(
        MaterialSpec(
            diffuse_color=WHITE, shiness=1.0, specular_color=WHITE,
            smoothness=0.001, refraction_index=1.12, opaque_decay=0.3,
            transparency=0.96,
        )
    ).push_sphere((0.5, 0.5, 0.5 / np.sqrt(3.0)), 0.5)

    # Diagonal-checker textured sphere (src/main.rs:1016-1038)
    b.push_object(
        MaterialSpec(
            shiness=0.3, specular_color=BLUE, smoothness=0.7,
            texture=TEXTURE_CHECKER,
        )
    ).push_sphere((0.0, 0.5, -1.0 / np.sqrt(3.0)), 0.5)

    # Green sphere on top (src/main.rs:1040-1056)
    b.push_object(
        MaterialSpec(
            diffuse_color=(0.5, 1.0, 0.2), shiness=0.5, specular_color=WHITE,
            smoothness=0.01,
        )
    ).push_sphere((0.0, 0.5 + np.sqrt(2.0 / 3.0), 0.0), 0.5)

    _demo_lights(b)
    return b.build(), DEFAULT_TEXTURES


def _demo_lights(b: SceneBuilder) -> None:
    # White directional (src/main.rs:1058-1062)
    b.push_directional_light(
        direction=np.asarray([-1.0, -1.0, 0.0]) / np.sqrt(2.0),
        color=(1.0, 0.98, 0.95),
    )
    # Pink spot from y=10, 60deg cone, softness 1 (src/main.rs:1064-1070)
    b.push_spot_light(
        origin=(0.0, 10.0, 0.0),
        direction=(0.0, -1.0, 0.0),
        angle_rad=np.deg2rad(60.0),
        softness=1.0,
        color=(1.0, 0.5, 0.9),
    )
    # Bluish point at (0, 0.1, 0) (src/main.rs:1072-1075)
    b.push_point_light(origin=(0.0, 0.1, 0.0), color=(0.8, 0.8, 1.0))


# ---------------------------------------------------------------------------
# BASELINE.json config presets (subsets of the demo scene for testing)
# ---------------------------------------------------------------------------

def spheres_scene() -> Tuple[Scene, tuple]:
    """01-spheres: 3 Phong spheres over a floor, direct lighting only."""
    b = SceneBuilder()
    b.push_object(
        MaterialSpec(diffuse_color=(1.0, 0.8, 0.6), shiness=0.5, smoothness=0.01)
    ).push_triangles(square([
        ((-4.0, 0.0, -4.0), (0.0, 0.0)),
        ((-4.0, 0.0, 4.0), (0.0, 1.0)),
        ((4.0, 0.0, 4.0), (1.0, 0.0)),
        ((4.0, 0.0, -4.0), (0.0, 1.0)),
    ]))
    b.push_object(
        MaterialSpec(diffuse_color=(1.0, 0.2, 0.2), shiness=0.2,
                     specular_color=YELLOW, smoothness=0.2)
    ).push_sphere((-0.9, 0.5, 0.0), 0.5)
    b.push_object(
        MaterialSpec(diffuse_color=(0.2, 1.0, 0.2), shiness=0.4, smoothness=0.1)
    ).push_sphere((0.0, 0.5, -0.6), 0.5)
    b.push_object(
        MaterialSpec(diffuse_color=(0.2, 0.2, 1.0), shiness=0.3, smoothness=0.05)
    ).push_sphere((0.9, 0.5, 0.0), 0.5)
    _demo_lights(b)
    return b.build(), DEFAULT_TEXTURES


def triangles_scene() -> Tuple[Scene, tuple]:
    """02/05: mixed sphere/triangle scene with shadows + speculars."""
    b = SceneBuilder()
    b.push_object(
        MaterialSpec(diffuse_color=(1.0, 0.8, 0.6), shiness=0.5, smoothness=0.01)
    ).push_triangles(square([
        ((-2.0, 0.0, -2.0), (0.0, 0.0)),
        ((-2.0, 0.0, 2.0), (0.0, 1.0)),
        ((2.0, 0.0, 2.0), (1.0, 0.0)),
        ((2.0, 0.0, -2.0), (0.0, 1.0)),
    ]))
    b.push_object(
        MaterialSpec(texture=TEXTURE_STRIPES, shiness=0.0, smoothness=0.00001)
    ).push_triangles(square([
        ((-2.0, 2.0, -2.0), (0.0, 0.0)),
        ((-2.0, 2.0, 2.0), (0.0, 1.0)),
        ((-2.0, -2.0, 2.0), (1.0, 0.0)),
        ((-2.0, -2.0, -2.0), (1.0, 1.0)),
    ]))
    b.push_object(
        MaterialSpec(diffuse_color=(1.0, 0.2, 0.2), shiness=0.2,
                     specular_color=YELLOW, smoothness=0.2)
    ).push_sphere((-0.5, 0.5, 0.3), 0.5)
    b.push_object(
        MaterialSpec(diffuse_color=(0.5, 1.0, 0.2), shiness=0.5, smoothness=0.01)
    ).push_sphere((0.5, 0.5, -0.3), 0.5)
    _demo_lights(b)
    return b.build(), DEFAULT_TEXTURES


def recursive_scene() -> Tuple[Scene, tuple]:
    """03/04: mirror + glass at bounce depth 5."""
    b = SceneBuilder()
    b.push_object(
        MaterialSpec(diffuse_color=(1.0, 0.8, 0.6), shiness=0.5, smoothness=0.01)
    ).push_triangles(square([
        ((-2.0, 0.0, -2.0), (0.0, 0.0)),
        ((-2.0, 0.0, 2.0), (0.0, 1.0)),
        ((2.0, 0.0, 2.0), (1.0, 0.0)),
        ((2.0, 0.0, -2.0), (0.0, 1.0)),
    ]))
    # Mirror sphere
    b.push_object(
        MaterialSpec(diffuse_color=WHITE, shiness=1.0, smoothness=0.00001)
    ).push_sphere((-0.55, 0.5, 0.0), 0.5)
    # Glass sphere
    b.push_object(
        MaterialSpec(diffuse_color=WHITE, shiness=1.0, smoothness=0.001,
                     refraction_index=1.12, opaque_decay=0.3, transparency=0.96)
    ).push_sphere((0.55, 0.5, 0.0), 0.5)
    _demo_lights(b)
    return b.build(), DEFAULT_TEXTURES


def obj_scene() -> Tuple[Scene, tuple]:
    """06/07: OBJ dodecahedron + textured sphere."""
    b = SceneBuilder()
    b.push_object(
        MaterialSpec(diffuse_color=WHITE, shiness=0.1, smoothness=1.0)
    ).push_triangles(dodecahedron_triangles(
        transform=lambda p: p / 2.0 + np.asarray([0.0, 0.8, 0.0], np.float32)))
    b.push_object(
        MaterialSpec(diffuse_color=(1.0, 0.8, 0.6), shiness=0.5, smoothness=0.01)
    ).push_triangles(square([
        ((-2.0, 0.0, -2.0), (0.0, 0.0)),
        ((-2.0, 0.0, 2.0), (0.0, 1.0)),
        ((2.0, 0.0, 2.0), (1.0, 0.0)),
        ((2.0, 0.0, -2.0), (0.0, 1.0)),
    ]))
    b.push_object(
        MaterialSpec(texture=TEXTURE_CHECKER, shiness=0.3, specular_color=BLUE,
                     smoothness=0.7)
    ).push_sphere((1.0, 0.5, 0.8), 0.5)
    _demo_lights(b)
    return b.build(), DEFAULT_TEXTURES


def full_scene(obj_path: str | None = None) -> Tuple[Scene, tuple]:
    """08-full: the complete demo scene (DoF + photon scatter pass)."""
    return demo_scene(obj_path)


def terrain_triangles(grid: int):
    """Smooth-shaded heightfield mesh: 2*grid^2 triangles on x,z in [-3,3].

    Analytic height + gradient give true per-vertex normals (unlike the
    reference's flat-normal OBJ path) so the mesh exercises barycentric
    normal interpolation at scale.  Returns a list of Vertex triples for
    ObjectProxy.push_triangles.
    """
    from raytracer_tpu.scene.builder import Vertex

    def h(x, z):
        return (0.45 * np.sin(1.3 * x) * np.cos(1.1 * z)
                + 0.15 * np.sin(3.1 * x + 1.0) * np.cos(2.7 * z))

    def grad(x, z):
        dx = (0.45 * 1.3 * np.cos(1.3 * x) * np.cos(1.1 * z)
              + 0.15 * 3.1 * np.cos(3.1 * x + 1.0) * np.cos(2.7 * z))
        dz = (-0.45 * 1.1 * np.sin(1.3 * x) * np.sin(1.1 * z)
              - 0.15 * 2.7 * np.sin(3.1 * x + 1.0) * np.sin(2.7 * z))
        return dx, dz

    xs = np.linspace(-3.0, 3.0, grid + 1)
    zs = np.linspace(-3.0, 3.0, grid + 1)

    def vert(i, j):
        x, z = float(xs[i]), float(zs[j])
        y = float(h(x, z))
        dx, dz = grad(x, z)
        n = np.asarray([-dx, 1.0, -dz], np.float32)
        n = n / np.linalg.norm(n)
        uv = np.asarray([i / grid, j / grid], np.float32)
        return Vertex(np.asarray([x, y, z], np.float32), n, uv)

    tris = []
    for i in range(grid):
        for j in range(grid):
            v00, v10 = vert(i, j), vert(i + 1, j)
            v01, v11 = vert(i, j + 1), vert(i + 1, j + 1)
            # wind both CCW seen from +y so face normals point up
            tris.append([v00, v01, v11])
            tris.append([v00, v11, v10])
    return tris


def mesh_scene(grid: int = 24) -> Tuple[Scene, tuple, Camera]:
    """Large-mesh preset: 2*grid^2-triangle terrain + mirror/glass spheres
    + a glass cube (dielectric TRIANGLES, so the interior march runs
    through the BVH too).  grid=24 -> 1,164 tris (test size);
    grid=75 -> 11,262 tris (the bench's >=10k-triangle cells).  Forces the
    BVH build regardless of the auto threshold."""
    b = SceneBuilder()
    b.push_object(
        MaterialSpec(diffuse_color=(0.55, 0.65, 0.45), shiness=0.25,
                     specular_color=WHITE, smoothness=0.03)
    ).push_triangles(terrain_triangles(grid))
    b.push_object(
        MaterialSpec(diffuse_color=(0.9, 0.9, 0.95), shiness=0.85,
                     specular_color=WHITE, smoothness=0.4)
    ).push_sphere((-1.0, 1.2, 0.3), 0.55)
    b.push_object(
        MaterialSpec(diffuse_color=WHITE, transparency=0.95,
                     refraction_index=1.25, opaque_decay=0.6,
                     specular_color=WHITE, smoothness=0.5)
    ).push_sphere((0.9, 1.1, -0.7), 0.45)
    # glass cube: 12 dielectric triangles in the BVH
    glass = b.push_object(
        MaterialSpec(diffuse_color=WHITE, transparency=1.0,
                     refraction_index=1.5, opaque_decay=0.25,
                     specular_color=WHITE, smoothness=0.6)
    )
    c, r = np.asarray([0.1, 1.0, 1.1]), 0.35
    corners = [c + r * np.asarray(s)
               for s in [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
                         (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]]
    uv0 = ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0))
    for face in [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
                 (2, 3, 7, 6), (1, 2, 6, 5), (0, 4, 7, 3)]:
        glass.push_triangles(square(
            [(corners[k], uv0[m]) for m, k in enumerate(face)]
        ))
    _demo_lights(b)
    cam = Camera.create(
        fovy_deg=55.0,
        center=(3.2, 2.6, 3.2),
        toward=np.asarray([-1.0, -0.75, -1.0])
        / np.linalg.norm([-1.0, -0.75, -1.0]),
        up=(0.0, 1.0, 0.0),
        near=-0.1,
    )
    return b.build(use_bvh=True), DEFAULT_TEXTURES, cam


PRESETS = {
    "01-spheres": spheres_scene,
    "02-triangles": triangles_scene,
    "03-recursive": recursive_scene,
    "04-recursive": recursive_scene,  # 03/04 share the BASELINE config
    "05-triangles": triangles_scene,  # 02/05 share the BASELINE config
    "06-obj": obj_scene,
    "07-obj": obj_scene,  # 06/07 share the BASELINE config
    "08-full": full_scene,
    "full": full_scene,
    "demo": demo_scene,
}
