"""Minimal Wavefront OBJ loader.

Replacement for the reference's tobj usage (src/main.rs:778-807):
the reference takes model 0, triangulates, *ignores* any vn/vt records, and
rebuilds flat normals from winding with uv=(0,0).  This loader reproduces
that behavior; the bake transform p/3 + (0.7, 1.0, -0.5) applied in the demo
scene (src/main.rs:802) lives with the preset, not here.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from raytracer_tpu.scene.builder import Vertex, triangle


def load_obj_triangles(
    path: str,
    transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> List[List[Vertex]]:
    """Parse an OBJ file into a list of flat-normal triangles.

    Faces with more than 3 vertices are fan-triangulated (tobj's
    triangulation strategy for convex polygons).  Only `v` and `f` records
    are used; vertex normals/uvs in the file are ignored to match the
    reference (src/main.rs:791-804).
    """
    positions: List[np.ndarray] = []
    faces: List[List[int]] = []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                positions.append(np.asarray([float(x) for x in parts[1:4]], np.float32))
            elif parts[0] == "f":
                idx = []
                for token in parts[1:]:
                    # v, v/vt, v/vt/vn, v//vn all start with the position index
                    i = int(token.split("/")[0])
                    # OBJ indices are 1-based; negatives are relative
                    idx.append(i - 1 if i > 0 else len(positions) + i)
                faces.append(idx)

    tris: List[List[Vertex]] = []
    for face in faces:
        for k in range(1, len(face) - 1):
            tri_idx = [face[0], face[k], face[k + 1]]
            pts = []
            for i in tri_idx:
                p = positions[i]
                if transform is not None:
                    p = np.asarray(transform(p), np.float32)
                pts.append((p, (0.0, 0.0)))
            tris.append(triangle(pts))
    return tris
