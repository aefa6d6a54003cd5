"""Flagship showcase scenes at reference scale.

Port of `yart_tpu/scene/showcase.py` (:33-624): the procedural textures
(brick, tile, marble, cloth, the alpha-cutout leaf), the octahedral sky
HDRI `sky_octahedral`, the mesh helpers `cylinder`, `box` and `grid_patch`,
and the scenes `atrium` (optionally with alpha-tested ivy), `roadster` and
`luxball`. The seeds and random streams are the JAX package's, so the
port's builder makes the same tables from them (tests/test_torch_textures.py).
Textures are stored in the reference's encoding: sqrt for sRGB colour
(gamma-2 storage, texture.hpp:80-84), linear for data maps.
"""

from __future__ import annotations

import numpy as np
import torch

from yart_tpu_torch.ops.vecmath import inv_octahedral_uv
from yart_tpu_torch.scene.builder import SceneBuilder
from yart_tpu_torch.scene.procedural import uv_sphere

_PI = np.pi


# ---------------------------------------------------------------------------
# Procedural textures (stored in the reference's encoding: sqrt() for sRGB
# color = gamma-2 storage, texture.hpp:80-84; linear for data maps)
# ---------------------------------------------------------------------------


def _value_noise(n, cells, rng, octaves=4):
    """Deterministic fbm value noise in [0, 1]."""
    out = np.zeros((n, n), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        c = min(cells * (2 ** o), n)
        grid = rng.random((c + 1, c + 1)).astype(np.float32)
        ij = np.linspace(0, c, n, endpoint=False)
        i0 = ij.astype(np.int32)
        f = ij - i0
        f = f * f * (3 - 2 * f)
        a = grid[np.ix_(i0, i0)]
        b = grid[np.ix_(i0, i0 + 1)]
        cc = grid[np.ix_(i0 + 1, i0)]
        d = grid[np.ix_(i0 + 1, i0 + 1)]
        out += amp * ((a * (1 - f[None, :]) + b * f[None, :]) * (1 - f[:, None])
                      + (cc * (1 - f[None, :]) + d * f[None, :]) * f[:, None])
        total += amp
        amp *= 0.5
    return out / total


def _normal_from_height(h, strength=2.0):
    """[n, n] height -> [n, n, 3] tangent-space normal map (0.5-centered)."""
    gx = np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)
    gy = np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)
    n = np.stack([-gx * strength, -gy * strength, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (n * 0.5 + 0.5).astype(np.float32)


def brick_textures(n=512, seed=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    bh, bw = n // 16, n // 8  # brick cell size
    row = yy // bh
    x_off = (xx + (row % 2) * (bw // 2)) % bw
    y_off = yy % bh
    mortar = ((x_off < 3) | (x_off >= bw - 3) | (y_off < 3) | (y_off >= bh - 3))
    tone = 0.55 + 0.25 * _value_noise(n, 8, rng) + 0.15 * rng.standard_normal((n, n)).astype(np.float32) * 0.1
    brick = np.stack([tone * 0.62, tone * 0.34, tone * 0.26], -1)
    mort = np.full((n, n, 3), 0.55, np.float32) * (0.8 + 0.4 * _value_noise(n, 32, rng))[..., None]
    lin = np.where(mortar[..., None], mort, brick).clip(0.02, 1.0)
    rgba = np.concatenate([np.sqrt(lin), np.ones((n, n, 1), np.float32)], -1)
    height = np.where(mortar, 0.0, 1.0).astype(np.float32)
    height = height * (0.7 + 0.3 * _value_noise(n, 16, rng))
    return rgba.astype(np.float32), _normal_from_height(height, 1.5)


def marble_texture(n=512, seed=4):
    rng = np.random.default_rng(seed)
    base = _value_noise(n, 4, rng, octaves=5)
    veins = np.abs(np.sin((base * 9.0 + np.linspace(0, 4, n)[None, :]) * _PI))
    lin = (0.75 - 0.35 * veins ** 8)[..., None] * np.asarray([0.95, 0.93, 0.88])
    rgba = np.concatenate(
        [np.sqrt(lin.clip(0.02, 1.0)), np.ones((n, n, 1))], -1
    )
    return rgba.astype(np.float32)


def tile_textures(n=512, seed=5):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    t = n // 8
    gap = ((xx % t < 2) | (yy % t < 2))
    per_tile = rng.random((8, 8)).astype(np.float32)[yy // t % 8, xx // t % 8]
    tone = (0.45 + 0.25 * per_tile + 0.1 * _value_noise(n, 16, rng))
    lin = tone[..., None] * np.asarray([0.8, 0.78, 0.72])
    lin = np.where(gap[..., None], lin * 0.35, lin).clip(0.02, 1.0)
    rgba = np.concatenate([np.sqrt(lin), np.ones((n, n, 1))], -1)
    # metallic-roughness 2ch (metallic=G slot 0? builder packs (m, r)):
    rough = np.where(gap, 0.9, 0.25 + 0.3 * per_tile)[..., None]
    mr = np.concatenate([np.zeros((n, n, 1), np.float32), rough], -1)
    height = np.where(gap, 0.0, 1.0).astype(np.float32)
    return rgba.astype(np.float32), mr.astype(np.float32), _normal_from_height(height, 1.0)


def cloth_texture(n=256, color=(0.55, 0.08, 0.08), seed=6):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    weave = 0.8 + 0.2 * np.sin(xx * _PI / 2.0) * np.sin(yy * _PI / 2.0)
    stripe = 1.0 - 0.45 * ((yy // (n // 8)) % 2)
    lin = (weave * stripe)[..., None] * np.asarray(color)
    rgba = np.concatenate([np.sqrt(lin.clip(0.01, 1.0)), np.ones((n, n, 1))], -1)
    return rgba.astype(np.float32)


def leaf_texture(n=128, seed=7):
    """Alpha-cutout ivy leaf cluster (binary alpha like game foliage)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, n), np.linspace(-1, 1, n), indexing="ij"
    )
    alpha = np.zeros((n, n), np.float32)
    green = np.zeros((n, n), np.float32)
    for _ in range(14):
        cx, cy = rng.uniform(-0.7, 0.7, 2)
        s = rng.uniform(0.15, 0.35)
        ang = rng.uniform(0, _PI)
        xr = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
        yr = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
        mask = (xr / s) ** 2 + (yr / (0.6 * s)) ** 2 < 1.0
        alpha = np.maximum(alpha, mask.astype(np.float32))
        green = np.where(mask, rng.uniform(0.2, 0.5), green)
    lin = np.stack([green * 0.35, green, green * 0.2], -1).clip(0.01, 1.0)
    rgba = np.concatenate([np.sqrt(lin), alpha[..., None]], -1)
    return rgba.astype(np.float32)


def sky_octahedral(n=512, sun_dir=(0.45, 0.72, 0.3), sun_strength=220.0,
                   sky_scale=1.0):
    """Octahedral-projected sky HDRI: horizon gradient + sun disc with halo
    (the flagship config's HDRI analog, src/main.cpp:81-84)."""
    u = (np.arange(n) + 0.5) / n
    uu, vv = np.meshgrid(u, u, indexing="xy")
    uv = np.stack([uu.reshape(-1), vv.reshape(-1)], -1).astype(np.float32)
    # float32 on the host CPU, whatever the render device.
    d = inv_octahedral_uv(torch.from_numpy(uv)).numpy()
    y = d[:, 1].clip(-1, 1)
    horizon = np.asarray([0.65, 0.65, 0.6])
    zenith = np.asarray([0.18, 0.32, 0.62])
    ground = np.asarray([0.22, 0.18, 0.14])
    t = np.abs(y) ** 0.6
    sky = horizon[None, :] * (1 - t[:, None]) + zenith[None, :] * t[:, None]
    col = np.where(y[:, None] >= 0, sky, ground[None, :] * (0.4 + 0.6 * (1 - t)[:, None]))
    sd = np.asarray(sun_dir, np.float32)
    sd /= np.linalg.norm(sd)
    cosang = (d @ sd).clip(-1, 1)
    disc = (cosang > np.cos(np.radians(1.2))).astype(np.float32)
    halo = np.exp((cosang - 1.0) * 40.0)
    col = col * sky_scale + (disc * sun_strength + halo * 2.0)[:, None] * np.asarray(
        [1.0, 0.92, 0.8]
    )
    return col.reshape(n, n, 3).astype(np.float32)


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------


def cylinder(center, radius, height, seg=32, rings=8, flutes=0.0, cap=True):
    """Y-axis cylinder with optional fluting; returns (pos, nrm, uv, idx)."""
    th = np.linspace(0, 2 * _PI, seg, endpoint=False)
    ys = np.linspace(0, height, rings + 1)
    tt, yy = np.meshgrid(th, ys, indexing="ij")  # [seg, rings+1]
    r = radius * (1.0 + flutes * 0.04 * np.cos(tt * 12))
    x = np.cos(tt) * r
    z = np.sin(tt) * r
    pos = np.stack([x, yy, z], -1).reshape(-1, 3) + np.asarray(center)
    nrm = np.stack([np.cos(tt), np.zeros_like(tt), np.sin(tt)], -1).reshape(-1, 3)
    uv = np.stack([tt / (2 * _PI) * 4.0, yy / max(height, 1e-6)], -1).reshape(-1, 2)
    idx = []
    for i in range(seg):
        i2 = (i + 1) % seg
        for j in range(rings):
            a = i * (rings + 1) + j
            b = i2 * (rings + 1) + j
            idx.append([a, b, a + 1])
            idx.append([b, b + 1, a + 1])
    pos_l, nrm_l, uv_l, idx_l = [pos], [nrm], [uv], [np.asarray(idx, np.int64)]
    if cap:
        base = pos.shape[0]
        top = np.stack([np.cos(th) * radius, np.full(seg, height), np.sin(th) * radius], -1)
        top = top + np.asarray(center)
        centr = np.asarray(center) + np.asarray([0, height, 0])
        pos_l.append(np.concatenate([top, centr[None, :]]))
        nrm_l.append(np.tile(np.asarray([[0.0, 1.0, 0.0]]), (seg + 1, 1)))
        uv_l.append(np.zeros((seg + 1, 2)))
        cap_idx = [[base + i, base + seg, base + (i + 1) % seg] for i in range(seg)]
        idx_l.append(np.asarray(cap_idx, np.int64))
    return (
        np.concatenate(pos_l).astype(np.float32),
        np.concatenate(nrm_l).astype(np.float32),
        np.concatenate(uv_l).astype(np.float32),
        np.concatenate(idx_l),
    )


def box(center, half, uv_scale=1.0):
    """Axis-aligned box; per-face normals/uvs. Returns (pos, nrm, uv, idx)."""
    cx, cy, cz = center
    hx, hy, hz = half
    faces = []
    for axis, sign in [(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]:
        n = np.zeros(3)
        n[axis] = sign
        u_ax, v_ax = [(1, 2), (0, 2), (0, 1)][axis]
        uvec = np.zeros(3)
        vvec = np.zeros(3)
        uvec[u_ax] = [hx, hy, hz][u_ax]
        vvec[v_ax] = [hx, hy, hz][v_ax]
        c = np.asarray(center) + n * [hx, hy, hz][axis]
        corners = [c - uvec - vvec, c + uvec - vvec, c + uvec + vvec, c - uvec + vvec]
        if sign < 0:
            corners = corners[::-1]
        faces.append((np.asarray(corners), n))
    pos, nrm, uv, idx = [], [], [], []
    for k, (corners, n) in enumerate(faces):
        b = 4 * k
        pos.append(corners)
        nrm.append(np.tile(n[None, :], (4, 1)))
        uv.append(np.asarray([[0, 0], [uv_scale, 0], [uv_scale, uv_scale], [0, uv_scale]]))
        idx.append([[b, b + 1, b + 2], [b, b + 2, b + 3]])
    return (
        np.concatenate(pos).astype(np.float32),
        np.concatenate(nrm).astype(np.float32),
        np.concatenate(uv).astype(np.float32),
        np.asarray(idx, np.int64).reshape(-1, 3),
    )


def grid_patch(origin, du, dv, nu, nv, displace=None, uv_scale=1.0):
    """Tessellated quad patch origin + u*du + v*dv, optional displacement
    fn(u, v) -> [..., 3] offset. Returns (pos, uv, idx); normals from faces."""
    us = np.linspace(0, 1, nu + 1)
    vs = np.linspace(0, 1, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    pos = (
        np.asarray(origin)[None, None, :]
        + uu[..., None] * np.asarray(du)[None, None, :]
        + vv[..., None] * np.asarray(dv)[None, None, :]
    )
    if displace is not None:
        pos = pos + displace(uu, vv)
    uv = np.stack([uu * uv_scale, vv * uv_scale], -1).reshape(-1, 2)
    idx = []
    for i in range(nu):
        for j in range(nv):
            a = i * (nv + 1) + j
            b = (i + 1) * (nv + 1) + j
            idx.append([a, b, a + 1])
            idx.append([b, b + 1, a + 1])
    return (
        pos.reshape(-1, 3).astype(np.float32),
        uv.astype(np.float32),
        np.asarray(idx, np.int64),
    )


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------


def atrium(ivy: bool = False, density: int = 1, tex_res: int = 512,
           instanced: bool = False) -> SceneBuilder:
    """Two-story colonnaded courtyard (Sponza-class load; ~125k triangles
    at density=1, ~128k with ivy). `ivy=True` adds 1,500 alpha-tested leaf
    quads (the sponza-new-ivy analog), which route intersection through the
    gated re-cast loop. `instanced=True` shares one column assembly (shaft,
    base, capital) per story as a prototype and places the 52 columns and
    5 planters as instances: the rendered image stays that of the baked
    scene while the stored triangles drop, and every ray goes through B3's
    instanced mode."""
    b = SceneBuilder()
    rng = np.random.default_rng(42)

    brick_rgba, brick_nrm = brick_textures(tex_res)
    t_brick = b.add_texture("rgba", brick_rgba)
    t_brick_n = b.add_texture("rgb", brick_nrm)
    tile_rgba, tile_mr, tile_nrm = tile_textures(tex_res)
    t_tile = b.add_texture("rgba", tile_rgba)
    t_tile_mr = b.add_texture("2ch", tile_mr)
    t_tile_n = b.add_texture("rgb", tile_nrm)
    t_marble = b.add_texture("rgba", marble_texture(tex_res))
    t_cloth_r = b.add_texture("rgba", cloth_texture(tex_res // 2, (0.5, 0.07, 0.07)))
    t_cloth_g = b.add_texture("rgba", cloth_texture(tex_res // 2, (0.1, 0.3, 0.12), seed=8))

    m_brick = b.add_material(roughness=0.9, tex_base=t_brick, tex_normal=t_brick_n)
    m_floor = b.add_material(
        roughness=0.5, tex_base=t_tile, tex_mr=t_tile_mr, tex_normal=t_tile_n
    )
    m_marble = b.add_material(roughness=0.25, tex_base=t_marble)
    m_trim = b.add_material(
        base_color=(0.9, 0.75, 0.35, 1.0), metallic=1.0, roughness=0.35
    )
    m_cloth_r = b.add_material(roughness=1.0, tex_base=t_cloth_r)
    m_cloth_g = b.add_material(roughness=1.0, tex_base=t_cloth_g)
    m_wood = b.add_material(base_color=(0.32, 0.2, 0.1, 1.0), roughness=0.7)

    def add(mesh, mat):
        pos, nrm, uv, idx = mesh
        b.add_mesh(pos, idx, mat, normals=nrm, uvs=uv)

    # Courtyard: 24 x 10 footprint, open roof.
    L, W, H = 12.0, 5.0, 3.2  # half-length, half-width, story height
    seg = 48 * density
    rings = 20 * density

    # Floor
    fp, fuv, fidx = grid_patch([-L, 0, -W], [2 * L, 0, 0], [0, 0, 2 * W],
                               16 * density, 8 * density, uv_scale=8.0)
    b.add_mesh(fp, fidx, m_floor, uvs=fuv)

    # Outer walls (brick), two stories + parapet
    for z in (-W, W):
        wp, wuv, widx = grid_patch(
            [-L, 0, z], [2 * L, 0, 0], [0, 2 * H + 1.2, 0],
            24 * density, 8 * density, uv_scale=6.0,
        )
        b.add_mesh(wp, widx, m_brick, uvs=wuv)
    for x in (-L, L):
        wp, wuv, widx = grid_patch(
            [x, 0, -W], [0, 0, 2 * W], [0, 2 * H + 1.2, 0],
            10 * density, 8 * density, uv_scale=4.0,
        )
        b.add_mesh(wp, widx, m_brick, uvs=wuv)

    # Colonnades: two rows per story.
    def column_proto(r, h):
        """One column assembly at the origin: fluted shaft + marble base +
        metal capital, merged with per-face materials."""
        parts = [
            (cylinder((0, 0.25, 0), r, h - 0.5, seg=seg, rings=rings, flutes=1.0), m_marble),
            (box((0, 0.125, 0), (0.32, 0.125, 0.32)), m_marble),
            (box((0, h - 0.125, 0), (0.34, 0.125, 0.34)), m_trim),
        ]
        pos_l, nrm_l, uv_l, idx_l, mat_l = [], [], [], [], []
        nv = 0
        for (pos, nrm, uv, idx), mat in parts:
            pos_l.append(pos)
            nrm_l.append(nrm)
            uv_l.append(uv)
            idx_l.append(idx + nv)
            mat_l.append(np.full(idx.shape[0], mat, np.int32))
            nv += pos.shape[0]
        return (np.concatenate(pos_l), np.concatenate(nrm_l), np.concatenate(uv_l),
                np.concatenate(idx_l), np.concatenate(mat_l))

    def translate(x, y, z):
        m = np.eye(4)
        m[:3, 3] = (x, y, z)
        return m

    n_cols = 13
    xs = np.linspace(-L + 1.4, L - 1.4, n_cols)
    for y0, r, h in [(0.0, 0.22, H), (H + 0.25, 0.16, H - 0.6)]:
        if instanced:
            cp, cn, cu, ci, cm = column_proto(r, h)
            pid = b.add_prototype(cp, ci, cm, normals=cn, uvs=cu)
        for z in (-W + 1.0, W - 1.0):
            for x in xs:
                if instanced:
                    b.add_instance(pid, translate(x, y0, z))
                    continue
                add(cylinder((x, y0 + 0.25, z), r, h - 0.5, seg=seg,
                             rings=rings, flutes=1.0), m_marble)
                # base + capital
                add(box((x, y0 + 0.125, z), (0.32, 0.125, 0.32)), m_marble)
                add(box((x, y0 + h - 0.125, z), (0.34, 0.125, 0.34)), m_trim)
            # architrave beam along the row
            add(box((0, y0 + h + 0.12, z), (L - 0.8, 0.12, 0.4), uv_scale=12.0),
                m_marble)
        # story slab between rows and walls
        for z0, z1 in [(-W, -W + 1.0), (W - 1.0, W)]:
            sp, suv, sidx = grid_patch(
                [-L, y0 + h + 0.25, z0], [2 * L, 0, 0], [0, 0, z1 - z0],
                16 * density, 2, uv_scale=8.0,
            )
            b.add_mesh(sp, sidx, m_wood, uvs=suv)

    # Hanging cloth between upper columns (Sponza's curtains).
    for i in range(n_cols - 1):
        x0 = (xs[i] + xs[i + 1]) / 2
        for z, mat in [(-W + 1.05, m_cloth_r), (W - 1.05, m_cloth_g)]:
            def disp(uu, vv, ph=rng.uniform(0, _PI)):
                sway = 0.18 * np.sin(uu * _PI) * np.sin(vv * 2.5 + ph)
                return np.stack(
                    [np.zeros_like(uu), np.zeros_like(uu), sway], -1
                ) * np.sign(-z)
            cp, cuv, cidx = grid_patch(
                [x0 - 0.55, H + 0.3, z], [1.1, 0, 0], [0, H - 1.1, 0],
                20 * density, 20 * density, disp, uv_scale=2.0,
            )
            b.add_mesh(cp, cidx, mat, uvs=cuv)

    # Planter boxes and a central fountain bowl.
    if instanced:
        pp, pn, pu, pi = box((0, 0.25, 0), (0.5, 0.25, 0.5), uv_scale=2.0)
        planter = b.add_prototype(pp, pi, m_marble, normals=pn, uvs=pu)
        for x in np.linspace(-L + 3, L - 3, 5):
            b.add_instance(planter, translate(x, 0.0, 0.0))
    else:
        for x in np.linspace(-L + 3, L - 3, 5):
            add(box((x, 0.25, 0.0), (0.5, 0.25, 0.5), uv_scale=2.0), m_marble)
    add(cylinder((0, 0.5, 0), 1.1, 0.22, seg=seg * 2, rings=2), m_marble)

    if ivy:
        t_leaf = b.add_texture("rgba", leaf_texture())
        m_ivy = b.add_material(
            roughness=0.9, tex_base=t_leaf, has_alpha=True, thin=True
        )
        quads_p, quads_uv, quads_i = [], [], []
        nvert = 0
        for _ in range(1500 * density):
            x = rng.uniform(-L + 1, L - 1)
            z = rng.choice([-W + 1.0, W - 1.0]) + rng.uniform(-0.3, 0.3)
            y = rng.uniform(0.5, 2 * H)
            s = rng.uniform(0.25, 0.5)
            a = rng.uniform(0, _PI)
            du = np.asarray([np.cos(a), 0, np.sin(a)]) * s
            dv = np.asarray([0, s, 0])
            c = np.asarray([x, y, z])
            quads_p.append([c - du - dv, c + du - dv, c + du + dv, c - du + dv])
            quads_uv.append([[0, 0], [1, 0], [1, 1], [0, 1]])
            quads_i.append([[nvert, nvert + 1, nvert + 2], [nvert, nvert + 2, nvert + 3]])
            nvert += 4
        b.add_mesh(
            np.asarray(quads_p, np.float32).reshape(-1, 3),
            np.asarray(quads_i, np.int64).reshape(-1, 3),
            m_ivy,
            uvs=np.asarray(quads_uv, np.float32).reshape(-1, 2),
        )

    b.set_env(sky_octahedral(512), scale=1.0)
    return b


def instanced_leaves(builder=SceneBuilder):
    """A small gated instanced scene (the port's own fixture; the JAX
    package has none): one alpha-tested leaf quad under `leaf_texture()`,
    instanced under 40 seeded rotations with non-uniform scale, and
    a thin glass pane instance (NEE transparency through the instance's
    normal matrix), over a baked floor. `builder` is the builder class:
    the JAX package's SceneBuilder has the same interface, which lets the
    tests build the same scene with both."""
    rng = np.random.default_rng(21)

    def rot(axis, a):
        c, s = np.cos(a), np.sin(a)
        i, j = [k for k in range(3) if k != axis]
        m = np.eye(3)
        m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
        return m

    def affine(lin, t):
        m = np.eye(4)
        m[:3, :3] = lin
        m[:3, 3] = t
        return m

    b = builder()
    t_leaf = b.add_texture("rgba", leaf_texture())
    m_ivy = b.add_material(roughness=0.9, tex_base=t_leaf, has_alpha=True, thin=True)
    m_glass = b.add_material(base_color=(0.6, 0.9, 0.7, 1.0), transmission=1.0, roughness=0.05, thin=True)
    m_floor = b.add_material(base_color=(0.5, 0.5, 0.5, 1.0), roughness=0.8)
    qp = np.asarray([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0], [-0.5, 0.5, 0]], np.float32)
    qi = [[0, 1, 2], [0, 2, 3]]
    leaf = b.add_prototype(qp, qi, m_ivy, uvs=[[0, 0], [1, 0], [1, 1], [0, 1]])
    for _ in range(40):
        lin = rot(1, rng.uniform(0, _PI)) @ rot(0, rng.uniform(-0.5, 0.5)) @ np.diag(
            [rng.uniform(0.3, 0.8), rng.uniform(0.3, 0.8), 1.0])
        b.add_instance(leaf, affine(lin, (rng.uniform(-2, 2), rng.uniform(0.3, 2.0), rng.uniform(-2, 2))))
    pane = b.add_prototype(qp, qi, m_glass)
    b.add_instance(pane, affine(rot(1, 0.5) @ np.diag([3.0, 2.0, 1.0]), (0.0, 1.0, 1.5)))
    b.add_mesh(np.asarray([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float32),
               [[0, 2, 1], [0, 3, 2]], m_floor)
    return b


def roadster(paint=(0.62, 0.04, 0.05)) -> SceneBuilder:
    """Stylized sports car: clearcoat paint, dielectric glass canopy with
    volume absorption (KHR_materials_volume analog, gltf.cpp:147-158),
    chrome + rubber wheels, under the sky HDRI (mclaren-red analog)."""
    b = SceneBuilder()

    m_paint = b.add_material(
        base_color=paint + (1.0,), roughness=0.35, clearcoat=1.0,
        cc_roughness=0.03, metallic=0.1,
    )
    m_glass = b.add_material(
        base_color=(1.0, 1.0, 1.0, 1.0), transmission=1.0, roughness=0.02,
        ior=1.5, thin=False, volume_color=(0.35, 0.55, 0.6),
        volume_density=2.0,
    )
    m_chrome = b.add_material(
        base_color=(0.95, 0.95, 0.95, 1.0), metallic=1.0, roughness=0.08
    )
    m_rubber = b.add_material(base_color=(0.04, 0.04, 0.045, 1.0), roughness=0.8)
    m_dark = b.add_material(base_color=(0.08, 0.08, 0.09, 1.0), roughness=0.4,
                            metallic=0.6)
    tile_rgba, tile_mr, tile_nrm = tile_textures(512, seed=9)
    t_floor = b.add_texture("rgba", tile_rgba)
    t_floor_mr = b.add_texture("2ch", tile_mr)
    m_floor = b.add_material(roughness=0.4, tex_base=t_floor, tex_mr=t_floor_mr)

    def body_profile(u):
        """Half-width/height profile along the body (u in [0,1] nose->tail)."""
        w = 0.95 * (0.35 + 0.9 * np.sin(_PI * (0.12 + 0.88 * u)) ** 0.8)
        h = 0.50 * (0.25 + 0.9 * np.sin(_PI * (0.08 + 0.80 * u)) ** 1.2)
        return w, h

    # Body: superellipse cross-sections swept along x.
    nu, nv = 160, 80
    us = np.linspace(0, 1, nu + 1)
    th = np.linspace(0, 2 * _PI, nv, endpoint=False)
    pos = []
    for u in us:
        w, h = body_profile(u)
        x = -2.1 + 4.2 * u
        e = 2.6  # superellipse exponent
        ct, st = np.cos(th), np.sin(th)
        cx = np.sign(ct) * np.abs(ct) ** (2 / e) * w
        cy = np.sign(st) * np.abs(st) ** (2 / e) * h
        y = 0.42 + cy * (1.0 + 0.2 * np.cos(_PI * (u - 0.5)))
        pos.append(np.stack([np.full(nv, x), y, cx], -1))
    pos = np.asarray(pos, np.float32)  # [nu+1, nv, 3]
    idx = []
    for i in range(nu):
        for j in range(nv):
            j2 = (j + 1) % nv
            a = i * nv + j
            bb = (i + 1) * nv + j
            idx.append([a, bb, i * nv + j2])
            idx.append([bb, (i + 1) * nv + j2, i * nv + j2])
    b.add_mesh(pos.reshape(-1, 3), np.asarray(idx, np.int64), m_paint)

    # Glass canopy: scaled shell over the cabin.
    canopy = []
    cus = np.linspace(0.32, 0.78, 48)
    cth = np.linspace(0, _PI, 32)  # upper half only
    for u in cus:
        w, h = body_profile(u)
        x = -2.1 + 4.2 * u
        bulge = np.sin((u - 0.32) / 0.46 * _PI) ** 0.7
        y = 0.46 + np.sin(cth) * (h * 0.9 + 0.42 * bulge)
        z = np.cos(cth) * w * 0.82
        canopy.append(np.stack([np.full_like(cth, x), y, z], -1))
    canopy = np.asarray(canopy, np.float32)
    cidx = []
    for i in range(len(cus) - 1):
        for j in range(len(cth) - 1):
            a = i * len(cth) + j
            bb = (i + 1) * len(cth) + j
            cidx.append([a, bb, a + 1])
            cidx.append([bb, bb + 1, a + 1])
    b.add_mesh(canopy.reshape(-1, 3), np.asarray(cidx, np.int64), m_glass)

    # Wheels: tire torus (big circle in the X-Y plane so wheels roll along
    # the car's long axis) + chrome hubcap (flattened sphere).
    for x, z in [(-1.35, 0.95), (-1.35, -0.95), (1.35, 0.95), (1.35, -0.95)]:
        tth = np.linspace(0, 2 * _PI, 64, endpoint=False)
        pth = np.linspace(0, 2 * _PI, 28, endpoint=False)
        T, P = np.meshgrid(tth, pth, indexing="ij")
        R, r = 0.34, 0.11
        wx = x + (R + r * np.cos(P)) * np.cos(T)
        wy = 0.36 + (R + r * np.cos(P)) * np.sin(T)
        wz = z + r * np.sin(P)
        tor = np.stack([wx, wy, wz], -1).reshape(-1, 3)
        tidx = []
        for i in range(64):
            i2 = (i + 1) % 64
            for j in range(28):
                j2 = (j + 1) % 28
                tidx.append([i * 28 + j, i2 * 28 + j, i * 28 + j2])
                tidx.append([i2 * 28 + j, i2 * 28 + j2, i * 28 + j2])
        b.add_mesh(tor.astype(np.float32), np.asarray(tidx, np.int64), m_rubber)
        hub_pos, hub_nrm, hub_tri = uv_sphere((0, 0, 0), 0.26, n_theta=12,
                                              n_phi=24)
        hub_pos = hub_pos.copy()
        hub_pos[:, 2] *= 0.18  # flatten into a cap
        hub_pos += np.asarray([x, 0.36, z * 1.04], np.float32)
        b.add_mesh(hub_pos, hub_tri, m_chrome, normals=None)

    # Splitter + diffuser accents
    for c, h in [((0.0, 0.16, 0.0), (2.0, 0.05, 1.0))]:
        p, n, u, i = box(c, h)
        b.add_mesh(p, i, m_dark, normals=n, uvs=u)

    # Ground
    gp, guv, gidx = grid_patch([-8, 0, -8], [16, 0, 0], [0, 0, 16], 8, 8,
                               uv_scale=8.0)
    b.add_mesh(gp, gidx, m_floor, uvs=guv)

    b.set_env(sky_octahedral(512, sun_dir=(0.5, 0.6, -0.45)), scale=1.0)
    return b


def luxball() -> SceneBuilder:
    """LuxBall analog (the reference's close-up material showcase,
    src/main.cpp:37: camera {0.12, 0.28, 0.35} -> {0, ~0.05, 0}): a smooth
    glass sphere enclosing an offset gold sphere, on a fluted marble
    pedestal over a tiled floor, under the sky HDRI — exercises smooth
    dielectric F/T splits, TIR, nested closest-hits and clearcoat-free
    metal highlights at macro scale (scene units ~10 cm)."""
    b = SceneBuilder()
    m_glass = b.add_material(
        base_color=(1.0, 1.0, 1.0, 1.0), transmission=1.0, roughness=0.0,
        ior=1.5, thin=False,
    )
    m_gold = b.add_material(
        base_color=(0.95, 0.67, 0.24, 1.0), metallic=1.0, roughness=0.18
    )
    t_marble = b.add_texture("rgba", marble_texture(512))
    m_marble = b.add_material(roughness=0.2, tex_base=t_marble)
    tile_rgba, tile_mr, _ = tile_textures(512, seed=11)
    t_floor = b.add_texture("rgba", tile_rgba)
    t_floor_mr = b.add_texture("2ch", tile_mr)
    m_floor = b.add_material(roughness=0.5, tex_base=t_floor,
                             tex_mr=t_floor_mr)

    # Floor patch (world ~1.2 m across; the subject sits at the origin).
    fp, fuv, fidx = grid_patch((-0.6, 0.0, -0.6), (1.2, 0, 0), (0, 0, 1.2),
                               8, 8, uv_scale=4.0)
    b.add_mesh(fp, fidx, m_floor, uvs=fuv)

    # Fluted pedestal (classic column look).
    cp, cn, cuv, cidx = cylinder((0.0, 0.01, 0.0), 0.085, 0.02, seg=64,
                                 rings=4, flutes=0.012, cap=True)
    b.add_mesh(cp, cidx, m_marble, normals=cn, uvs=cuv)

    # Glass shell + offset gold core.
    gp, gn, gt = uv_sphere((0.0, 0.075, 0.0), 0.055, n_theta=48, n_phi=96)
    b.add_mesh(gp, gt, m_glass, normals=gn)
    ip, inn, it = uv_sphere((0.0, 0.068, 0.0), 0.034, n_theta=32, n_phi=64)
    b.add_mesh(ip, it, m_gold, normals=inn)

    b.set_env(sky_octahedral(512, sun_dir=(0.4, 0.65, 0.5)), scale=1.0)
    return b
