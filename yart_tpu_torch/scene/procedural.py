"""Procedural scenes; port of `yart_tpu/scene/procedural.py` `cornell_box`,
`box_mesh`, `_quad`, `uv_sphere`, `furnace`, `material_test_spheres` (the
reference's main.cpp setups, src/main.cpp:20-77), `windowed_interior`
(:82-113) and the textured fixture `textured_box_scene` (:239-304). The
flagship scenes are in scene/showcase.py.
"""

from __future__ import annotations

import numpy as np

from yart_tpu_torch.scene.builder import SceneBuilder


def _quad(p0, p1, p2, p3):
    """Two triangles for a quad given CCW corners."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, idx


def cornell_box(extra_materials: bool = False, boxes: bool = True) -> SceneBuilder:
    """Cornell box in [-1,1]^2 x [0,2]: white walls, red left, green right,
    area light at the ceiling, two boxes (metal + glass with
    `extra_materials`, the "cornell-mat" scene; none with `boxes=False`,
    the reference oracle's empty box)."""
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

    if boxes and extra_materials:
        metal = b.add_material(base_color=(0.9, 0.7, 0.3, 1.0), metallic=1.0, roughness=0.2)
        glass = b.add_material(
            base_color=(1.0, 1.0, 1.0, 1.0), transmission=1.0, roughness=0.05,
            ior=1.5, thin=False,
        )
        b.add_mesh(*box_mesh([-0.35, 0.0, -0.35], [0.25, 1.2, 0.25], rot_y=0.3), metal)
        b.add_mesh(*box_mesh([0.4, 0.0, 0.35], [0.25, 0.5, 0.25], rot_y=-0.25), glass)
    elif boxes:
        b.add_mesh(*box_mesh([-0.35, 0.0, -0.35], [0.25, 1.2, 0.25], rot_y=0.3), white)
        b.add_mesh(*box_mesh([0.4, 0.0, 0.35], [0.25, 0.5, 0.25], rot_y=-0.25), white)
    return b


def windowed_interior(window_half: float = 0.25) -> SceneBuilder:
    """A closed room lit only through a small window onto an env light:
    env-lit but mostly enclosed, as Sponza is. The static compaction guess
    for env-lit scenes ("auto" = split at 2) loses here (few lanes escape
    within 2 bounces), and the renderer's per-wave autotune
    (`choose_compaction`) must measure its way off it. The back wall
    (z = -1) has a centred square hole of half-size `window_half`, built
    from 4 border quads."""
    b = SceneBuilder()
    white = b.add_material(base_color=(0.73, 0.73, 0.73, 1.0), roughness=1.0)
    s, w = 1.0, float(window_half)
    cy = 1.0  # window centre height
    quads = [
        # floor, ceiling, left, right
        _quad([-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]),
        _quad([-s, 2, s], [s, 2, s], [s, 2, -s], [-s, 2, -s]),
        _quad([-s, 0, s], [-s, 2, s], [-s, 2, -s], [-s, 0, -s]),
        _quad([s, 0, -s], [s, 2, -s], [s, 2, s], [s, 0, s]),
        # the front wall behind the camera (z = +1) closes the room
        _quad([s, 0, s], [s, 2, s], [-s, 2, s], [-s, 0, s]),
        # the back wall's borders around the window
        _quad([-s, 0, -s], [-s, cy - w, -s], [s, cy - w, -s], [s, 0, -s]),
        _quad([-s, cy + w, -s], [-s, 2, -s], [s, 2, -s], [s, cy + w, -s]),
        _quad([-s, cy - w, -s], [-s, cy + w, -s], [-w, cy + w, -s], [-w, cy - w, -s]),
        _quad([w, cy - w, -s], [w, cy + w, -s], [s, cy + w, -s], [s, cy - w, -s]),
    ]
    for verts, idx in quads:
        b.add_mesh(verts, idx, white)
    b.set_env(np.full((8, 8, 3), 2.0, np.float32))
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


def uv_sphere(center, radius, n_theta: int = 24, n_phi: int = 48):
    """UV-sphere mesh with smooth normals. Returns (verts, normals, idx)."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)[:-1]
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    normals = np.stack([x, y, z], -1).reshape(-1, 3)
    verts = normals * radius + np.asarray(center, np.float32)

    idx = []
    for i in range(n_theta):
        for j in range(n_phi):
            j1 = (j + 1) % n_phi
            a = i * n_phi + j
            b2 = i * n_phi + j1
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + j1
            if i > 0:
                idx.append([a, b2, c])
            if i < n_theta - 1:
                idx.append([b2, d, c])
    return verts.astype(np.float32), normals.astype(np.float32), np.asarray(idx, np.int32)


def furnace(albedo=(1.0, 1.0, 1.0), env_value: float = 0.5, roughness: float = 1.0,
            metallic: float = 0.0, transmission: float = 0.0, ior: float = 1.5,
            clearcoat: float = 0.0, cc_roughness: float = 0.0, thin: bool = False,
            anisotropic: float = 0.0, aniso_rotation: float = 0.0) -> SceneBuilder:
    """Furnace test: a sphere of 3968 triangles inside a uniform 8x8
    environment; a white BSDF must vanish against the background."""
    b = SceneBuilder()
    m = b.add_material(
        base_color=(*albedo, 1.0), roughness=roughness, metallic=metallic,
        transmission=transmission, ior=ior, clearcoat=clearcoat,
        cc_roughness=cc_roughness, thin=thin, anisotropic=anisotropic,
        aniso_rotation=aniso_rotation,
    )
    verts, normals, idx = uv_sphere((0.0, 0.0, 0.0), 1.0, 32, 64)
    b.add_mesh(verts, idx, m, normals=normals)
    b.set_env(np.full((8, 8, 3), env_value, np.float32))
    return b


def material_test_spheres(env_value: float = 0.8) -> SceneBuilder:
    """The CLI's `spheres` scene: three rows of five spheres (metal, glossy,
    glass) sweeping roughness over a floor quad under a constant 8x8
    environment; 15 x 960 + 2 = 14,402 triangles."""
    b = SceneBuilder()
    floor_mat = b.add_material(base_color=(0.5, 0.5, 0.5, 1.0), roughness=0.9)
    fv, fi = _quad([-12, 0, -12], [12, 0, -12], [12, 0, 12], [-12, 0, 12])
    b.add_mesh(fv, fi, floor_mat)
    for row, kind in enumerate(("metal", "glossy", "glass")):
        for i in range(5):
            r = i / 4.0
            if kind == "metal":
                m = b.add_material(base_color=(0.95, 0.78, 0.42, 1.0), metallic=1.0, roughness=r)
            elif kind == "glossy":
                m = b.add_material(base_color=(0.2, 0.3, 0.8, 1.0), roughness=r)
            else:
                m = b.add_material(base_color=(1.0, 1.0, 1.0, 1.0), transmission=1.0,
                                   roughness=r, ior=1.5, thin=False)
            verts, normals, idx = uv_sphere((-2.4 + 1.2 * i, 0.5, -1.2 * row), 0.5, 16, 32)
            b.add_mesh(verts, idx, m, normals=normals)
    b.set_env(np.full((8, 8, 3), env_value, np.float32))
    return b


def textured_box_scene():
    """Textured-PBR fixture: checkerboard albedo, roughness gradient,
    normal-mapped floor, an alpha-cutout panel and a thin-glass panel in
    front of an area light — exercises every texture channel kind plus
    alpha-tested and NEE-transparent shadows (golden_v1 `textured`)."""
    b = SceneBuilder()

    # Checker base color (sRGB-stored: gamma-2 encode of linear values).
    n = 64
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    checker = ((xx // 8 + yy // 8) % 2).astype(np.float32)
    base = np.zeros((n, n, 4), np.float32)
    base[..., 0] = np.sqrt(0.2 + 0.6 * checker)  # gamma-2 storage
    base[..., 1] = np.sqrt(0.4)
    base[..., 2] = np.sqrt(0.8 - 0.6 * checker)
    base[..., 3] = 1.0
    tex_base = b.add_texture("rgba", base)

    # Metallic-roughness 2ch: roughness gradient in x, metallic 0.
    mr = np.zeros((n, n, 2), np.float32)
    mr[..., 0] = np.linspace(0.1, 1.0, n)[None, :]
    mr[..., 1] = 0.0
    tex_mr = b.add_texture("2ch", mr)

    # Normal map: gentle bumps.
    ph = np.sin(xx / 4.0) * 0.2
    nrm = np.zeros((n, n, 3), np.float32)
    nrm[..., 0] = 0.5 + ph * 0.5
    nrm[..., 1] = 0.5
    nrm[..., 2] = 1.0
    tex_normal = b.add_texture("rgb", nrm)

    floor = b.add_material(
        base_color=(1.0, 1.0, 1.0, 1.0),
        roughness=1.0,
        tex_base=tex_base,
        tex_mr=tex_mr,
        tex_normal=tex_normal,
    )

    # Alpha cutout: stripes of alpha 0.
    cut = np.ones((n, n, 4), np.float32) * 0.8
    cut[..., 3] = ((yy // 8) % 2).astype(np.float32)
    tex_cut = b.add_texture("rgba", cut)
    cutout = b.add_material(
        base_color=(1.0, 1.0, 1.0, 1.0),
        roughness=1.0,
        tex_base=tex_cut,
        has_alpha=True,
    )

    glass = b.add_material(
        base_color=(1.0, 0.3, 0.3, 1.0), transmission=1.0, roughness=0.1,
        thin=True,
    )
    light = b.add_material(emission=(1, 1, 1), emission_strength=20.0)

    fv, fi = _quad([-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2])
    b.add_mesh(fv, fi, floor, uvs=np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
    cv, ci = _quad([-1, 0.2, 0.5], [0, 0.2, 0.5], [0, 1.2, 0.5], [-1, 1.2, 0.5])
    b.add_mesh(cv, ci, cutout, uvs=np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
    gv, gi = _quad([0.2, 0.2, 0.5], [1.2, 0.2, 0.5], [1.2, 1.2, 0.5], [0.2, 1.2, 0.5])
    b.add_mesh(gv, gi, glass)
    lv, li = _quad([-0.5, 2.5, 0.6], [0.5, 2.5, 0.6], [0.5, 2.5, -0.4], [-0.5, 2.5, -0.4])
    b.add_mesh(lv, li, light)
    return b
