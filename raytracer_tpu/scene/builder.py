"""Host-side scene construction DSL -> device SoA scene.

Counterpart of the reference's World::push_object /
ObjectProxy::push_{triangle,sphere,triangles} builder chain
(src/main.rs:167-178, 700-728) and the triangle()/square() helpers
(src/main.rs:730-746).  Building happens in NumPy on the host; build()
flattens everything into the Scene pytree (one device transfer).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from raytracer_tpu.scene.types import (
    LIGHT_DIRECTIONAL,
    LIGHT_POINT,
    LIGHT_SPOT,
    Scene,
)


def _v3(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).reshape(3)


def _v2(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).reshape(2)


@dataclasses.dataclass
class MaterialSpec:
    """Host-side material description (reference: src/materials.rs:20-31).

    texture=0 means constant diffuse/normal from this spec; texture>0
    selects a procedural texture (scene/textures.py) whose diffuse/normal
    override the constants per hit, like GenerativeMaterial's closures.
    """

    diffuse_color: Sequence[float] = (1.0, 1.0, 1.0)
    shiness: float = 0.0
    specular_color: Sequence[float] = (1.0, 1.0, 1.0)
    smoothness: float = 0.0
    transparency: float = 0.0
    refraction_index: float = 1.0
    opaque_decay: float = 0.0
    normal: Sequence[float] = (0.0, 0.0, 1.0)
    texture: int = 0


@dataclasses.dataclass
class Vertex:
    """PositionNormalUV (reference: src/geometric.rs:43-47)."""

    position: np.ndarray
    normal: np.ndarray
    uv: np.ndarray


def triangle(positions_uvs: Sequence[Tuple[Sequence[float], Sequence[float]]]):
    """Build a flat-normal triangle from 3 (position, uv) pairs.

    Normal from winding: a = v1-v0, b = v2-v1, n = normalize(a x b)
    (reference: src/main.rs:730-739).
    """
    p = [_v3(pu[0]) for pu in positions_uvs]
    uv = [_v2(pu[1]) for pu in positions_uvs]
    a = p[1] - p[0]
    b = p[2] - p[1]
    n = np.cross(a, b)
    n = n / np.linalg.norm(n)
    return [Vertex(p[i], n.copy(), uv[i]) for i in range(3)]


def square(positions_uvs: Sequence[Tuple[Sequence[float], Sequence[float]]]):
    """Two triangles (0,1,2) and (0,2,3) sharing the flat normal of their
    own winding (reference: src/main.rs:741-746)."""
    v = list(positions_uvs)
    return [
        triangle([v[0], v[1], v[2]]),
        triangle([v[0], v[2], v[3]]),
    ]


class ObjectProxy:
    def __init__(self, builder: "SceneBuilder", object_index: int):
        self._b = builder
        self.object_index = object_index

    def push_triangle(self, vertices: Sequence[Vertex]) -> "ObjectProxy":
        assert len(vertices) == 3
        self._b._triangles.append((self.object_index, list(vertices)))
        return self

    def push_triangles(self, triangles: Sequence[Sequence[Vertex]]) -> "ObjectProxy":
        for t in triangles:
            self.push_triangle(t)
        return self

    def push_sphere(self, center, radius: float) -> "ObjectProxy":
        self._b._spheres.append((self.object_index, _v3(center), float(radius)))
        return self


class SceneBuilder:
    """Accumulates objects/primitives/lights, then build() -> Scene."""

    def __init__(self):
        self._materials: List[MaterialSpec] = []
        self._triangles: List[Tuple[int, List[Vertex]]] = []
        self._spheres: List[Tuple[int, np.ndarray, float]] = []
        self._lights: List[dict] = []

    def push_object(self, material: MaterialSpec) -> ObjectProxy:
        self._materials.append(material)
        return ObjectProxy(self, len(self._materials) - 1)

    # --- lights (reference: src/lights.rs) ---
    def push_directional_light(self, direction, color):
        d = _v3(direction)
        self._lights.append(
            dict(
                type=LIGHT_DIRECTIONAL,
                origin=np.zeros(3, np.float32),
                direction=d / np.linalg.norm(d),
                color=_v3(color),
                angle=0.0,
                softness=0.0,
                has_origin=0.0,
            )
        )

    def push_spot_light(self, origin, direction, angle_rad: float, softness: float, color):
        d = _v3(direction)
        self._lights.append(
            dict(
                type=LIGHT_SPOT,
                origin=_v3(origin),
                direction=d / np.linalg.norm(d),
                color=_v3(color),
                angle=float(angle_rad),
                softness=float(softness),
                has_origin=1.0,
            )
        )

    def push_point_light(self, origin, color):
        self._lights.append(
            dict(
                type=LIGHT_POINT,
                origin=_v3(origin),
                direction=np.array([0.0, -1.0, 0.0], np.float32),
                color=_v3(color),
                angle=0.0,
                softness=0.0,
                has_origin=1.0,
            )
        )

    def build(self, use_bvh: bool | str = "auto") -> Scene:
        """Flatten to the device Scene.

        use_bvh: True / False / "auto" (BVH from 512 triangles up — small
        scenes like the reference's 64 triangles stay brute-force,
        SURVEY.md §7.6).
        """
        f32 = np.float32
        T = len(self._triangles)
        S = len(self._spheres)
        O = max(len(self._materials), 1)
        L = len(self._lights)

        tri_v = np.zeros((T, 3, 3), f32)
        tri_n = np.zeros((T, 3, 3), f32)
        tri_uv = np.zeros((T, 3, 2), f32)
        tri_obj = np.zeros((T,), np.int32)
        for i, (obj, verts) in enumerate(self._triangles):
            for j, v in enumerate(verts):
                tri_v[i, j] = v.position
                tri_n[i, j] = v.normal
                tri_uv[i, j] = v.uv
            tri_obj[i] = obj

        # Precomputed intersection quantities (see ops/intersect.py):
        # face normal a x b with a = v1-v0, b = v2-v1 (primitives.rs:37-42)
        a = tri_v[:, 1] - tri_v[:, 0]
        b = tri_v[:, 2] - tri_v[:, 1]
        fn = np.cross(a, b)
        with np.errstate(invalid="ignore", divide="ignore"):
            fn = fn / np.linalg.norm(fn, axis=-1, keepdims=True)
        tri_d = np.einsum("ij,ij->i", fn, tri_v[:, 0])
        # Signed-area edge tests (main.rs:218-227): area_i = g_i.p + h_i with
        # g_i = fn x e_i; edges/anchors in the reference's order:
        #   area_0: e = v2-v1, anchor v1
        #   area_1: e = v0-v2, anchor v2
        #   area_2: e = v1-v0, anchor v0
        edges = np.stack(
            [tri_v[:, 2] - tri_v[:, 1], tri_v[:, 0] - tri_v[:, 2], tri_v[:, 1] - tri_v[:, 0]],
            axis=1,
        )  # [T, 3, 3]
        anchors = np.stack([tri_v[:, 1], tri_v[:, 2], tri_v[:, 0]], axis=1)
        tri_g = np.cross(fn[:, None, :], edges)  # [T, 3, 3]
        tri_h = -np.einsum("tij,tij->ti", tri_g, anchors)  # [T, 3]
        tri_area2 = np.einsum(
            "ij,ij->i", np.cross(tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0]), fn
        )

        sph_c = np.zeros((S, 3), f32)
        sph_r = np.zeros((S,), f32)
        sph_obj = np.zeros((S,), np.int32)
        for i, (obj, c, r) in enumerate(self._spheres):
            sph_c[i] = c
            sph_r[i] = r
            sph_obj[i] = obj

        mats = self._materials or [MaterialSpec()]
        mat = lambda get: np.asarray([get(m) for m in mats], f32)
        mat_diffuse = np.stack([_v3(m.diffuse_color) for m in mats])
        mat_specular = np.stack([_v3(m.specular_color) for m in mats])
        mat_normal = np.stack([_v3(m.normal) for m in mats])
        mat_tex = np.asarray([m.texture for m in mats], np.int32)

        lights = self._lights
        lf = lambda key: np.asarray([l[key] for l in lights], f32).reshape(L, -1)

        bvh_fields: dict = {}
        want_bvh = use_bvh is True or (use_bvh == "auto" and T >= 512)
        if want_bvh and T > 0:
            from raytracer_tpu.scene.bvh import build_bvh

            bvh = build_bvh(tri_v)
            bvh_fields = dict(
                bvh_node_min=jnp.asarray(bvh.node_min),
                bvh_node_max=jnp.asarray(bvh.node_max),
                bvh_node_right=jnp.asarray(bvh.node_right),
                bvh_node_count=jnp.asarray(bvh.node_count),
                bvh_prim_order=jnp.asarray(bvh.prim_order),
                bvh_depth=bvh.depth,
            )

        j = jnp.asarray
        return Scene(
            **bvh_fields,
            tri_v=j(tri_v), tri_n=j(tri_n), tri_uv=j(tri_uv), tri_obj=j(tri_obj),
            tri_fn=j(fn.astype(f32)), tri_d=j(tri_d.astype(f32)),
            tri_g=j(tri_g.astype(f32)), tri_h=j(tri_h.astype(f32)),
            tri_area2=j(tri_area2.astype(f32)),
            sph_c=j(sph_c), sph_r=j(sph_r), sph_obj=j(sph_obj),
            mat_diffuse=j(mat_diffuse), mat_shiness=j(mat(lambda m: m.shiness)),
            mat_specular=j(mat_specular), mat_smoothness=j(mat(lambda m: m.smoothness)),
            mat_transparency=j(mat(lambda m: m.transparency)),
            mat_refraction=j(mat(lambda m: m.refraction_index)),
            mat_decay=j(mat(lambda m: m.opaque_decay)),
            mat_normal=j(mat_normal), mat_tex=j(mat_tex),
            light_type=j(np.asarray([l["type"] for l in lights], np.int32)),
            light_origin=j(lf("origin").reshape(L, 3) if L else np.zeros((0, 3), f32)),
            light_dir=j(lf("direction").reshape(L, 3) if L else np.zeros((0, 3), f32)),
            light_color=j(lf("color").reshape(L, 3) if L else np.zeros((0, 3), f32)),
            light_angle=j(lf("angle").reshape(L) if L else np.zeros((0,), f32)),
            light_softness=j(lf("softness").reshape(L) if L else np.zeros((0,), f32)),
            light_has_origin=j(lf("has_origin").reshape(L) if L else np.zeros((0,), f32)),
        )
