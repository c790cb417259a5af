"""raytracer_tpu — a wavefront ray tracer in JAX / XLA, run on NVIDIA GPUs.

Ground-up re-design of foriequal0/homework-18-graphics-raytracer (a Rust
Whitted + distributed ray tracer) for accelerators: SoA ray/scene pytrees,
masked [rays x prims] intersection sweeps and a BVH for large meshes, a
fixed-depth wavefront bounce loop instead of CPU recursion, counter-based
RNG, and shard_map tile sharding for multi-device scaling.
"""

from raytracer_tpu.config import NORTH_STAR_CONFIG, REFERENCE_CONFIG, RenderConfig
from raytracer_tpu.render import (
    clip_coords,
    render_distributed_epoch,
    render_epochs,
    render_step,
    render_steps,
    render_whitted,
)
from raytracer_tpu.scene.builder import MaterialSpec, SceneBuilder, square, triangle
from raytracer_tpu.scene.presets import PRESETS, demo_camera, demo_scene
from raytracer_tpu.scene.types import Camera, Hits, Rays, Scene

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Hits",
    "MaterialSpec",
    "NORTH_STAR_CONFIG",
    "PRESETS",
    "Rays",
    "REFERENCE_CONFIG",
    "RenderConfig",
    "Scene",
    "SceneBuilder",
    "clip_coords",
    "demo_camera",
    "demo_scene",
    "render_distributed_epoch",
    "render_epochs",
    "render_step",
    "render_steps",
    "render_whitted",
    "square",
    "triangle",
]
