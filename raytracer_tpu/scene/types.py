"""SoA scene representation — the device-side scene pytree.

The reference keeps a heap of per-primitive structs behind Arc<Material>
trait objects (src/primitives.rs, src/main.rs:130-137).  Here the whole
scene is a pytree of flat arrays: triangles, spheres, a material table
indexed by object id, and a light table.  Geometry-derived quantities used
by the intersector (face normals, plane offsets, edge-test vectors) are
precomputed host-side once and shipped to device memory with the scene.

Primitive ids form a single global index space: triangle i has id i,
sphere j has id n_triangles + j.  This replaces the reference's
PrimitiveIndex::{Triangle,Sphere}(usize) tagged enum (src/primitives.rs:32)
with something comparable by plain integer equality in a vector lane.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# FaceDirection encoding (reference: src/main.rs:52-67).
FACE_FRONT = 0
FACE_BACK = 1
FACE_BOTH = 2

# Light type encoding (reference: src/lights.rs:26-30).
LIGHT_DIRECTIONAL = 0
LIGHT_SPOT = 1
LIGHT_POINT = 2

# "No exclusion" sentinel for Ray.exclude (reference: Option::None).
NO_EXCLUDE = -1


def _register(cls, data_fields, meta_fields=()):
    return partial(
        jax.tree_util.register_dataclass,
        data_fields=list(data_fields),
        meta_fields=list(meta_fields),
    )(cls)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Device-side scene: all fields are jnp arrays (see builder.py)."""

    # Triangles (T of them)
    tri_v: jnp.ndarray  # [T, 3, 3] vertex positions
    tri_n: jnp.ndarray  # [T, 3, 3] vertex normals
    tri_uv: jnp.ndarray  # [T, 3, 2] vertex uvs
    tri_obj: jnp.ndarray  # [T] int32 object id
    # Precomputed intersection data
    tri_fn: jnp.ndarray  # [T, 3] unit face normal ((v1-v0)x(v2-v1), primitives.rs:37)
    tri_d: jnp.ndarray  # [T] plane offset fn.v0 (main.rs:203)
    tri_g: jnp.ndarray  # [T, 3, 3] edge-test vectors g_i = fn x e_i
    tri_h: jnp.ndarray  # [T, 3] edge-test offsets -g_i . anchor_i
    tri_area2: jnp.ndarray  # [T] (v1-v0)x(v2-v0).fn (main.rs:235)

    # Spheres (S of them)
    sph_c: jnp.ndarray  # [S, 3]
    sph_r: jnp.ndarray  # [S]
    sph_obj: jnp.ndarray  # [S] int32

    # Material table, indexed by object id (O objects)
    # (reference: src/materials.rs:20-31 ColorMaterial fields)
    mat_diffuse: jnp.ndarray  # [O, 3]
    mat_shiness: jnp.ndarray  # [O]
    mat_specular: jnp.ndarray  # [O, 3]
    mat_smoothness: jnp.ndarray  # [O]
    mat_transparency: jnp.ndarray  # [O]
    mat_refraction: jnp.ndarray  # [O]
    mat_decay: jnp.ndarray  # [O] opaque_decay
    mat_normal: jnp.ndarray  # [O, 3] tangent-space normal
    mat_tex: jnp.ndarray  # [O] int32 texture id (0 = constant material)

    # Lights (L of them) (reference: src/lights.rs)
    light_type: jnp.ndarray  # [L] int32
    light_origin: jnp.ndarray  # [L, 3] (unused lanes 0 for directional)
    light_dir: jnp.ndarray  # [L, 3] normalized
    light_color: jnp.ndarray  # [L, 3]
    light_angle: jnp.ndarray  # [L] spot cone angle (radians)
    light_softness: jnp.ndarray  # [L]
    # 1.0 where the light has an origin (spot/point), else 0.0; kept as a
    # float array so the pytree stays homogeneous.
    light_has_origin: jnp.ndarray  # [L]

    # Optional triangle BVH (scene/bvh.py; None for small scenes where the
    # dense sweep wins).  bvh_depth is static metadata (traversal stack
    # bound), not a traced leaf.
    bvh_node_min: jnp.ndarray | None = None  # [M, 3]
    bvh_node_max: jnp.ndarray | None = None  # [M, 3]
    bvh_node_right: jnp.ndarray | None = None  # [M]
    bvh_node_count: jnp.ndarray | None = None  # [M]
    bvh_prim_order: jnp.ndarray | None = None  # [T]
    bvh_depth: int = 0

    @property
    def n_tri(self) -> int:
        return self.tri_v.shape[0]

    @property
    def n_sph(self) -> int:
        return self.sph_c.shape[0]

    @property
    def n_prim(self) -> int:
        return self.n_tri + self.n_sph

    @property
    def n_obj(self) -> int:
        return self.mat_shiness.shape[0]

    @property
    def n_light(self) -> int:
        return self.light_type.shape[0]

    @property
    def prim_obj(self) -> jnp.ndarray:
        """[T+S] object id per global primitive id."""
        return jnp.concatenate([self.tri_obj, self.sph_obj])


Scene = _register(
    Scene,
    data_fields=[
        f.name for f in dataclasses.fields(Scene) if f.name != "bvh_depth"
    ],
    meta_fields=["bvh_depth"],
)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole / thin-lens camera (reference: src/main.rs:43-127)."""

    fovy: jnp.ndarray  # scalar, radians
    center: jnp.ndarray  # [3]
    toward: jnp.ndarray  # [3]
    up: jnp.ndarray  # [3]
    near: jnp.ndarray  # scalar (reference demo uses -0.1: origin sits
    # slightly *behind* center along toward, src/main.rs:1082)

    @staticmethod
    def create(fovy_deg, center, toward, up, near) -> "Camera":
        f32 = lambda x: jnp.asarray(x, dtype=jnp.float32)
        return Camera(
            fovy=f32(np.deg2rad(fovy_deg)),
            center=f32(center),
            toward=f32(toward),
            up=f32(up),
            near=f32(near),
        )


Camera = _register(Camera, data_fields=["fovy", "center", "toward", "up", "near"])


@dataclasses.dataclass(frozen=True)
class Rays:
    """SoA ray batch (reference Ray struct: src/main.rs:69-81)."""

    o: jnp.ndarray  # [N, 3] origin
    d: jnp.ndarray  # [N, 3] direction (unit)
    face: jnp.ndarray  # [N] int32 FaceDirection
    excl_prim: jnp.ndarray  # [N] int32 global primitive id or NO_EXCLUDE
    excl_face: jnp.ndarray  # [N] int32 FaceDirection of the exclusion

    @staticmethod
    def primary(o, d) -> "Rays":
        n = o.shape[0]
        return Rays(
            o=o,
            d=d,
            face=jnp.full((n,), FACE_FRONT, dtype=jnp.int32),
            excl_prim=jnp.full((n,), NO_EXCLUDE, dtype=jnp.int32),
            excl_face=jnp.full((n,), FACE_FRONT, dtype=jnp.int32),
        )


Rays = _register(Rays, data_fields=["o", "d", "face", "excl_prim", "excl_face"])


@dataclasses.dataclass(frozen=True)
class Hits:
    """SoA hit records (reference Hit struct: src/main.rs:139-147).

    `valid` is False for misses; all other lanes are then garbage and
    must stay masked downstream.
    """

    valid: jnp.ndarray  # [N] bool
    t: jnp.ndarray  # [N] travel distance
    prim: jnp.ndarray  # [N] int32 global primitive id
    obj: jnp.ndarray  # [N] int32 object id
    pos: jnp.ndarray  # [N, 3]
    normal: jnp.ndarray  # [N, 3] interpolated shading normal (backface-flipped,
    # NOT renormalized after barycentric interpolation — matching
    # src/main.rs:248-251)
    uv: jnp.ndarray  # [N, 2]
    backface: jnp.ndarray  # [N] bool (hit.face_direction == Back)


Hits = _register(
    Hits,
    data_fields=["valid", "t", "prim", "obj", "pos", "normal", "uv", "backface"],
)
