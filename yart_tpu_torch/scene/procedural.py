"""Procedural scenes; port of `yart_tpu/scene/procedural.py` `cornell_box`,
`box_mesh` and `_quad` (the reference's main.cpp Cornell setups,
src/main.cpp:20-77). Other fixtures wait for later slices (ROADMAP.md A.10).
"""

from __future__ import annotations

import numpy as np

from yart_tpu_torch.scene.builder import SceneBuilder


def _quad(p0, p1, p2, p3):
    """Two triangles for a quad given CCW corners."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, idx


def cornell_box(extra_materials: bool = False) -> SceneBuilder:
    """Cornell box in [-1,1]^2 x [0,2]: white walls, red left, green right,
    area light at the ceiling, two boxes (metal + glass with
    `extra_materials`, the "cornell-mat" scene)."""
    b = SceneBuilder()
    white = b.add_material(base_color=(0.73, 0.73, 0.73, 1.0), roughness=1.0)
    red = b.add_material(base_color=(0.65, 0.05, 0.05, 1.0), roughness=1.0)
    green = b.add_material(base_color=(0.12, 0.45, 0.15, 1.0), roughness=1.0)
    light = b.add_material(
        base_color=(0.0, 0.0, 0.0, 1.0),
        roughness=1.0,
        emission=(1.0, 0.85, 0.7),
        emission_strength=15.0,
    )

    s = 1.0
    for verts, idx, mat in [
        (*_quad([-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]), white),
        (*_quad([-s, 2, s], [s, 2, s], [s, 2, -s], [-s, 2, -s]), white),
        (*_quad([-s, 0, -s], [-s, 2, -s], [s, 2, -s], [s, 0, -s]), white),
        (*_quad([-s, 0, s], [-s, 2, s], [-s, 2, -s], [-s, 0, -s]), red),
        (*_quad([s, 0, -s], [s, 2, -s], [s, 2, s], [s, 0, s]), green),
        (
            *_quad(
                [-0.3, 1.995, 0.3], [0.3, 1.995, 0.3],
                [0.3, 1.995, -0.3], [-0.3, 1.995, -0.3],
            ),
            light,
        ),
    ]:
        b.add_mesh(verts, idx, mat)

    if extra_materials:
        metal = b.add_material(base_color=(0.9, 0.7, 0.3, 1.0), metallic=1.0, roughness=0.2)
        glass = b.add_material(
            base_color=(1.0, 1.0, 1.0, 1.0), transmission=1.0, roughness=0.05,
            ior=1.5, thin=False,
        )
        b.add_mesh(*box_mesh([-0.35, 0.0, -0.35], [0.25, 1.2, 0.25], rot_y=0.3), metal)
        b.add_mesh(*box_mesh([0.4, 0.0, 0.35], [0.25, 0.5, 0.25], rot_y=-0.25), glass)
    else:
        b.add_mesh(*box_mesh([-0.35, 0.0, -0.35], [0.25, 1.2, 0.25], rot_y=0.3), white)
        b.add_mesh(*box_mesh([0.4, 0.0, 0.35], [0.25, 0.5, 0.25], rot_y=-0.25), white)
    return b


def box_mesh(base_center, half_extents, rot_y: float = 0.0):
    """Box sitting on y=base_center[1], optionally rotated about +y.
    Returns (verts [24, 3], idx [12, 3]) with sharp normals."""
    cx, cy, cz = base_center
    hx, hy, hz = half_extents
    faces = []
    idx = []

    def face(p0, p1, p2, p3):
        k = 4 * len(faces)
        faces.append([p0, p1, p2, p3])
        idx.append([k, k + 1, k + 2])
        idx.append([k, k + 2, k + 3])

    x0, x1 = -hx, hx
    y0, y1 = 0.0, 2 * hy
    z0, z1 = -hz, hz
    face([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1])  # +z
    face([x1, y0, z0], [x0, y0, z0], [x0, y1, z0], [x1, y1, z0])  # -z
    face([x1, y0, z1], [x1, y0, z0], [x1, y1, z0], [x1, y1, z1])  # +x
    face([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0])  # -x
    face([x0, y1, z1], [x1, y1, z1], [x1, y1, z0], [x0, y1, z0])  # +y
    face([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1])  # -y

    verts = np.asarray([p for f in faces for p in f], np.float32)
    c, s = np.cos(rot_y), np.sin(rot_y)
    rot = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    verts = verts @ rot.T + np.asarray([cx, cy, cz], np.float32)
    return verts, np.asarray(idx, np.int32)
