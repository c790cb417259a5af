"""Batched pinhole / thin-lens camera.

Batched Camera::shoot / shoot_focus (src/main.rs:84-127): one call maps
a whole clip-coordinate batch to a primary-ray batch.  The clip convention
matches the reference driver (src/main.rs:1094-1095): clip_y = (H/2 - y)/H,
clip_x = (x - W/2)/H — aspect handled by dividing both by height.
"""

from __future__ import annotations

import jax.numpy as jnp

from raytracer_tpu.scene.types import Camera
from raytracer_tpu.utils import vec


def _basis(camera: Camera):
    toward = vec.normalize(camera.toward[None, :])[0]
    right = vec.normalize(jnp.cross(toward, camera.up)[None, :])[0]
    up = vec.normalize(jnp.cross(right, toward)[None, :])[0]
    scale = jnp.tan(camera.fovy / 2.0)
    return toward, right * scale, up * scale  # toward, x, y (main.rs:85-90)


def shoot(camera: Camera, clip):
    """clip [N, 2] -> (origin [N, 3] broadcast, direction [N, 3]).

    origin = center + toward * near (src/main.rs:92; near = -0.1 in the demo
    puts the origin slightly behind center).
    """
    toward, x, y = _basis(camera)
    d = clip[:, 0:1] * x[None, :] + clip[:, 1:2] * y[None, :] + toward[None, :]
    d = vec.normalize(d)
    origin = camera.center + toward * camera.near
    o = jnp.broadcast_to(origin[None, :], d.shape)
    return o, d


def shoot_focus(camera: Camera, clip, lens_offsets, focus):
    """Thin-lens DoF rays (src/main.rs:101-127).

    lens_offsets [N, 2]: Gaussian samples already scaled by `blur`
    (the reference draws Normal(0, blur) per axis, main.rs:112-113).
    Keeps the focal point at distance `focus` fixed while displacing the
    origin by -(x*dx + y*dy).
    """
    toward, x, y = _basis(camera)
    d = clip[:, 0:1] * x[None, :] + clip[:, 1:2] * y[None, :] + toward[None, :]
    d = vec.normalize(d)

    xoff = lens_offsets[:, 0:1]
    yoff = lens_offsets[:, 1:2]
    d_focus = vec.normalize(d * focus + x[None, :] * xoff + y[None, :] * yoff)
    origin = camera.center + toward * camera.near
    o = origin[None, :] - (x[None, :] * xoff + y[None, :] * yoff)
    return o, d_focus
