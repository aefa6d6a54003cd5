"""Host-side scene builder -> the port's CompiledScene.

Port of the subset of `yart_tpu/scene/builder.py` the ported render path
needs: materials, textures (`add_texture`, the shelf-packed atlases of
`_stack_from_list`, builder.py:85-121), meshes with authored or
area-weighted normals, uvs, tangents and a transform (:169-223),
`add_material_desc` (:154-156), background, the
environment light (`set_env`, `set_env_uniform`, `_compile_env`,
:280-371) and `compile()`: the SAH BVH and its leaf-order triangle
permutation (:389-399), the area-light table (:401-451), scene center and
radius (:453-457), the packed `tri_pack` / `shade_pack` rows (:481-492),
the cluster tables `clus_pack` (with the alpha-mask words of row 5 when a
material has alpha, :510-526), `clus_first`, bin-trace's coarse BVH8
`coarse_pack` (:505-507) and the block trace's lane-padded `clus_box`
(:527-538), the stack traversals' `node_pack` and triangle BVH8 `wide_pack`
with `max_leaf`, `bvh_depth` and `wide_depth` (:470-480, :493-499,
:539-545, :605-607), the material table (:1028), and instancing:
`add_prototype`, `add_instance` and `_compile_instanced` (:225-278,
:644-1020), with one scene and meta per prototype (`protos`,
`proto_metas`) sharing the instanced scene's material table and atlases.
Numpy on the host, then tensors: the machine with the GPU has no JAX, so
the port builds its own scenes. The triangle BVH and its 8-wide collapse
come from the port's C++ build (`yart_tpu_torch/native.py`), as the JAX
builder's come from its native one; the numpy `scene/bvh.py` functions are
their twins (a test selects them by replacing `native.build_bvh` /
`native.collapse_bvh8`). The coarse BVH over the clusters stays numpy, as
in the JAX builder.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from yart_tpu_torch import native
from yart_tpu_torch.device import resolve
from yart_tpu_torch.ops.distribution import build_alias
from yart_tpu_torch.render.texture import qrows_from_data
from yart_tpu_torch.scene.alphamask import bake_tri_masks, write_mask_rows
from yart_tpu_torch.scene.clusters import build_coarse, cut_clusters, woop_rows
from yart_tpu_torch.scene.types import (LOOKS, CompiledScene, InstancedScene, MaterialTable,
                                        SceneMeta, TextureStack)

_PI = float(np.pi)


@dataclasses.dataclass
class MaterialDesc:
    """Host-side material description (parametric.hpp:16-37 parameters);
    the same fields and defaults as yart_tpu.scene.builder.MaterialDesc."""

    base_color: tuple = (0.8, 0.8, 0.8, 1.0)
    metallic: float = 0.0
    roughness: float = 0.5
    transmission: float = 0.0
    ior: float = 1.5
    anisotropic: float = 0.0
    aniso_rotation: float = 0.0
    clearcoat: float = 0.0
    cc_roughness: float = 0.0
    emission: tuple = (0.0, 0.0, 0.0)
    emission_strength: float = 1.0
    two_sided: bool = False
    normal_scale: float = 1.0
    thin: bool = True
    volume_color: tuple = (1.0, 1.0, 1.0)
    volume_density: float = 0.0
    tex_base: int = -1
    tex_mr: int = -1
    tex_transmission: int = -1
    tex_normal: int = -1
    tex_clearcoat: int = -1
    tex_emission: int = -1
    has_alpha: bool = False

    @property
    def is_emissive(self) -> bool:
        e = np.asarray(self.emission, np.float32) * self.emission_strength
        return bool(np.any(e > 0.0)) or self.tex_emission >= 0


def _face_normals_to_vertices(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (the JAX builder's default for meshes
    without authored normals)."""
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    out = np.zeros_like(positions)
    for k in range(3):
        np.add.at(out, indices[:, k], fn)
    n = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(n, 1e-20)


def _mesh_arrays(positions, indices, material, normals, uvs, tangents) -> dict:
    """A mesh's float64 vertex arrays with their defaults (area-weighted
    normals, zero uvs, +x tangents of handedness 1), int64 triangles and
    the per-face int32 materials."""
    positions = np.asarray(positions, np.float64).reshape(-1, 3)
    indices = np.asarray(indices, np.int64).reshape(-1, 3)
    nv = positions.shape[0]
    if normals is None:
        normals = _face_normals_to_vertices(positions, indices)
    if uvs is None:
        uvs = np.zeros((nv, 2), np.float64)
    if tangents is None:
        tangents = np.zeros((nv, 4), np.float64)
        tangents[:, 0] = 1.0
        tangents[:, 3] = 1.0
    mat = np.broadcast_to(np.asarray(material, np.int32), (indices.shape[0],)).copy()
    return dict(positions=positions, normals=np.asarray(normals, np.float64).reshape(nv, 3),
                uvs=np.asarray(uvs, np.float64).reshape(nv, 2),
                tangents=np.asarray(tangents, np.float64).reshape(nv, 4), tris=indices, tri_mat=mat)


def _stack_from_list(textures: List[np.ndarray], channels: int) -> TextureStack:
    """Shelf-pack [H, W, C] arrays into one atlas (builder.py:85-121):
    tallest first, left to right, on shelves of a power-of-two width of at
    least 64. Repeat wrap happens in the sampler; its bilinear fetch clamps
    inside each rect, so no border duplication is needed. CPU tensors."""
    if not textures:
        return TextureStack(
            torch.zeros((1, 1, channels), dtype=torch.float32),
            torch.zeros((0, 4), dtype=torch.int32),
            torch.zeros((1, 4 * channels), dtype=torch.float32),
        )
    max_w = max(t.shape[1] for t in textures)
    atlas_w = 1
    while atlas_w < max_w:
        atlas_w *= 2
    atlas_w = max(atlas_w, 64)
    order = sorted(range(len(textures)), key=lambda i: -textures[i].shape[0])
    table = np.zeros((len(textures), 4), np.int32)
    x = y = shelf_h = 0
    for i in order:
        th, tw = textures[i].shape[:2]
        if x + tw > atlas_w:
            y += shelf_h
            x = 0
            shelf_h = 0
        table[i] = (x, y, tw, th)
        x += tw
        shelf_h = max(shelf_h, th)
    data = np.zeros((y + shelf_h, atlas_w, channels), np.float32)
    for i, tex in enumerate(textures):
        x0, y0, tw, th = table[i]
        data[y0 : y0 + th, x0 : x0 + tw] = tex.reshape(th, tw, channels)
    data_t = torch.from_numpy(data)
    return TextureStack(data_t, torch.from_numpy(table), qrows_from_data(data_t))


class SceneBuilder:
    def __init__(self) -> None:
        self._materials: List[MaterialDesc] = []
        self._positions: List[np.ndarray] = []
        self._normals: List[np.ndarray] = []
        self._tangents: List[np.ndarray] = []
        self._uvs: List[np.ndarray] = []
        self._tris: List[np.ndarray] = []
        self._tri_mat: List[np.ndarray] = []
        self._vtx_offset = 0
        # Instancing: object-space prototype meshes and (prototype, [4, 4]
        # transform) instances.
        self._protos: List[dict] = []
        self._instances: List[tuple] = []
        self._background = (0.0, 0.0, 0.0)
        self._env_image: Optional[np.ndarray] = None
        self._env_scale = 1.0
        self._env_rotation = np.eye(3, dtype=np.float32)
        self._env_bounds = (0.0, 0.0, 1.0, 1.0)
        self._env_sampleable = True
        # Texture lists by channel class, storage-encoded [H, W, C] arrays.
        self.textures_rgba: List[np.ndarray] = []
        self.textures_rgb: List[np.ndarray] = []
        self.textures_2ch: List[np.ndarray] = []
        # Host seconds of the last `_tables`: the SAH build, the BVH8
        # collapse of the stack traversals' tables, and all of it.
        self.timings: dict = {}
        self.textures_mono: List[np.ndarray] = []

    def add_material(self, **kwargs) -> int:
        self._materials.append(MaterialDesc(**kwargs))
        return len(self._materials) - 1

    def add_material_desc(self, desc: MaterialDesc) -> int:
        self._materials.append(desc)
        return len(self._materials) - 1

    def add_texture(self, kind: str, data: np.ndarray) -> int:
        """Add a storage-encoded texture (gamma-2 for sRGB colour) of `kind`
        rgba, rgb, 2ch or mono; returns its index within that kind."""
        stack = {
            "rgba": self.textures_rgba,
            "rgb": self.textures_rgb,
            "2ch": self.textures_2ch,
            "mono": self.textures_mono,
        }[kind]
        stack.append(np.asarray(data, np.float32))
        return len(stack) - 1

    def add_mesh(self, positions: np.ndarray, indices: np.ndarray, material,
                 normals: Optional[np.ndarray] = None, uvs: Optional[np.ndarray] = None,
                 tangents: Optional[np.ndarray] = None, transform: Optional[np.ndarray] = None) -> None:
        """Add a triangle mesh, pre-transformed to world space; `material`
        is one index or a per-face [T] array. Without `normals` [V, 3] the
        vertex normals are area-weighted face normals; `uvs` [V, 2] default
        to zero and `tangents` [V, 4] (xyz, handedness) to +x with
        handedness 1. `transform`: an optional [4, 4] row-major affine
        matrix, applied in float64 to the positions, by its inverse
        transpose to the normals (src/math/transform.hpp:46-52) and to the
        tangents' xyz, both renormalised."""
        m = _mesh_arrays(positions, indices, material, normals, uvs, tangents)
        pos, nrm, tan = m["positions"], m["normals"], m["tangents"]
        if transform is not None:
            mtx = np.asarray(transform, np.float64).reshape(4, 4)
            pos = pos @ mtx[:3, :3].T + mtx[:3, 3]
            nrm_m = np.linalg.inv(mtx[:3, :3]).T
            nrm = nrm @ nrm_m.T
            nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
            t_xyz = tan[:, :3] @ mtx[:3, :3].T
            t_len = np.linalg.norm(t_xyz, axis=-1, keepdims=True)
            tan = np.concatenate([t_xyz / np.maximum(t_len, 1e-20), tan[:, 3:]], axis=1)
        self._positions.append(pos.astype(np.float32))
        self._normals.append(nrm.astype(np.float32))
        self._tangents.append(tan.astype(np.float32))
        self._uvs.append(m["uvs"].astype(np.float32))
        self._tris.append((m["tris"] + self._vtx_offset).astype(np.int32))
        self._tri_mat.append(m["tri_mat"])
        self._vtx_offset += m["positions"].shape[0]

    def add_prototype(self, positions: np.ndarray, indices: np.ndarray, material,
                      normals: Optional[np.ndarray] = None, uvs: Optional[np.ndarray] = None,
                      tangents: Optional[np.ndarray] = None) -> int:
        """Register an object-space prototype mesh for instancing (the
        reference shares one Mesh across scene-graph Nodes,
        src/core/scene.hpp:48-66): its packs and shading rows are built once
        and every instance adds a transform. Defaults as in add_mesh; kept
        in float64 until the prototype's nested compile. Returns the
        prototype id for `add_instance`."""
        self._protos.append(_mesh_arrays(positions, indices, material, normals, uvs, tangents))
        return len(self._protos) - 1

    def add_instance(self, proto: int, transform=None) -> None:
        """Instance prototype `proto` under an optional [4, 4] row-major
        affine transform. A mirrored transform (determinant <= 0) raises
        ValueError: it would flip the triangles' winding and with it the
        back-side and volume semantics (parametric.cpp:834-838)."""
        m = np.eye(4, dtype=np.float64) if transform is None else np.asarray(transform, np.float64).reshape(4, 4)
        det = np.linalg.det(m[:3, :3])
        if det <= 0:
            raise ValueError(f"instance transform must be orientation-preserving (det={det:g})")
        self._instances.append((int(proto), m))

    def set_env(self, image: np.ndarray, scale: float = 1.0, rotation=None, bounds=None) -> None:
        """Octahedral HDR environment image [H, W, 3] (src/main.cpp:81-84).
        `rotation`: optional [3, 3] world -> map matrix (light.cpp:208-214).
        `bounds`: optional portal crop (u0, v0, u1, v1) in map UV space
        (light.cpp:147-155): radiance and sampling are restricted to the
        rect, with the pdf kept in the octahedral measure."""
        self._env_image = np.asarray(image, np.float32)
        self._env_scale = float(scale)
        self._env_sampleable = True
        if rotation is not None:
            self._env_rotation = np.asarray(rotation, np.float32).reshape(3, 3)
        if bounds is not None:
            self._env_bounds = tuple(float(b) for b in bounds)

    def set_env_uniform(self, color) -> None:
        """UniformInfiniteLight (light.cpp:83-135): constant radiance on a
        miss only. Its pdf is 0 and NEE never samples it, though it keeps
        the light sampler's reserved infinite-light probability."""
        self._env_image = np.broadcast_to(np.asarray(color, np.float32), (1, 1, 3)).copy()
        self._env_scale = 1.0
        self._env_sampleable = False
        self._env_bounds = (0.0, 0.0, 1.0, 1.0)

    def set_background(self, color) -> None:
        self._background = tuple(color)

    def _compile_env(self) -> dict:
        """Environment light tables (light.cpp:137-193): an alias table over
        the (W-1) x (H-1) bilinear base cells, so the sampling cell and the
        radiance fetch share one index; cells weighted by mean RGB (the
        octahedral map covers the sphere uniformly, so no sin(theta))."""
        if self._env_image is None:
            prob, alias, pdf_cells = build_alias(np.ones(1, np.float32))
            env_img = np.zeros((1, 1, 3), np.float32)
            wc = hc = 1
        else:
            env_img = self._env_image * self._env_scale
            h, w = env_img.shape[:2]
            wc, hc = max(w - 1, 1), max(h - 1, 1)
            texw = env_img.mean(axis=-1)
            x1 = np.minimum(np.arange(wc) + 1, w - 1)
            y1 = np.minimum(np.arange(hc) + 1, h - 1)
            weight = 0.25 * (texw[:hc, :wc] + texw[:hc, x1] + texw[y1, :wc] + texw[y1][:, x1])
            u0, v0, u1, v1 = self._env_bounds
            if (u0, v0, u1, v1) != (0.0, 0.0, 1.0, 1.0):
                # Portal: zero weight outside the rect (cell-center test).
                uc = (np.arange(wc) + 0.5) / wc
                vc = (np.arange(hc) + 0.5) / hc
                inside = ((uc >= u0) & (uc < u1))[None, :] & ((vc >= v0) & (vc < v1))[:, None]
                weight = np.where(inside, weight, 0.0)
            prob, alias, pdf_cells = build_alias(weight)
        env_alias = np.stack([prob, alias.view(np.float32), pdf_cells, pdf_cells[alias]], axis=1)
        return dict(env_img=env_img, env_alias=env_alias.astype(np.float32), pdf_cells=pdf_cells,
                    wc=wc, hc=hc)

    def _tables(self, cluster_size: int) -> dict:
        """The numpy tables of the meshes added so far, as compile() builds
        them: triangles in BVH leaf order, the area lights, the packed
        rows and the block-trace cluster tables. A prototype's nested
        compile (`_compile_instanced`) takes exactly these."""
        if not self._tris:
            raise ValueError("scene has no geometry")
        t_start = time.perf_counter()
        positions = np.concatenate(self._positions)
        normals = np.concatenate(self._normals)
        tangents = np.concatenate(self._tangents)
        uvs = np.concatenate(self._uvs)
        tri_v = np.concatenate(self._tris)
        tri_mat = np.concatenate(self._tri_mat)
        v0, v1, v2 = (positions[tri_v[:, k]] for k in range(3))

        # Triangles in BVH leaf order: every cluster is a contiguous range.
        t0 = time.perf_counter()
        hb = native.build_bvh(v0, v1, v2)
        bvh_s = time.perf_counter() - t0
        tri_v = tri_v[hb.tri_order]
        tri_mat = tri_mat[hb.tri_order]
        v0, v1, v2 = v0[hb.tri_order], v1[hb.tri_order], v2[hb.tri_order]

        # Area lights: every triangle of an emissive material
        # (gltf.cpp:299-314), power = |Le| * A * pi * (2 if two-sided)
        # (light.cpp:36-38) — the JAX builder's arithmetic, in float32.
        mats = self._materials
        emissive = np.asarray([m.is_emissive for m in mats], bool)
        light_tri = np.nonzero(emissive[tri_mat])[0].astype(np.int32)
        tri_light = np.full(tri_v.shape[0], -1, np.int32)
        tri_light[light_tri] = np.arange(light_tri.size, dtype=np.int32)
        emission_table = np.asarray(
            [np.asarray(m.emission, np.float32) * np.float32(m.emission_strength) for m in mats],
            np.float32,
        )
        l_emission = emission_table[tri_mat[light_tri]].reshape(-1, 3)
        e1 = v1[light_tri] - v0[light_tri]
        e2 = v2[light_tri] - v0[light_tri]
        l_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1).astype(np.float32)
        two_sided = np.asarray([m.two_sided for m in mats], bool)[tri_mat[light_tri]]
        ltv = tri_v[light_tri]
        l_verts = np.stack([positions[ltv[:, k]] for k in range(3)], axis=1).astype(np.float32)
        l_norms = np.stack([normals[ltv[:, k]] for k in range(3)], axis=1).astype(np.float32)

        bits = lambda a: np.ascontiguousarray(a, np.int32).view(np.float32)
        tri_pack = np.zeros((tri_v.shape[0], 12), np.float32)
        tri_pack[:, 0:3] = v0
        tri_pack[:, 3:6] = v1
        tri_pack[:, 6:9] = v2
        tri_pack[:, 9] = bits(tri_mat)
        tri_pack[:, 10] = bits(tri_light)
        shade_pack = np.zeros((tri_v.shape[0], 32), np.float32)
        shade_pack[:, 0:9] = normals[tri_v].reshape(-1, 9)
        shade_pack[:, 9:15] = uvs[tri_v].reshape(-1, 6)
        shade_pack[:, 15:27] = tangents[tri_v].reshape(-1, 12)
        shade_pack[:, 27] = bits(tri_mat)
        shade_pack[:, 28] = bits(tri_light)

        # Cluster tables: the coarse BVH8 over the clusters (bin-trace), the
        # clusters in its leaf order, their packs, and their boxes SoA,
        # lane-padded (block trace). Pad boxes sit at +3e38: the slab test
        # min/max-normalises inverted bounds, so a lo > hi sentinel would
        # become a real box around the origin, while a far degenerate box is
        # never entered.
        coarse = build_coarse(cut_clusters(hb, cluster_size))
        cut = coarse.cut
        clus_pack = woop_rows(v0, v1, v2, cut, cluster_size)
        if any(m.has_alpha for m in mats):
            # Conservative alpha bitmasks in pack row 5, for B3's `amask`
            # cull of certainly-transparent candidates (scene/alphamask.py).
            masks = bake_tri_masks(
                uvs[tri_v], tri_mat, np.asarray([m.has_alpha for m in mats], bool),
                np.asarray([m.tex_base for m in mats], np.int64), self.textures_rgba,
            )
            write_mask_rows(clus_pack, masks, cut.first, cut.count, cluster_size)
        n_clus = int(cut.first.shape[0])
        clus_box = _box_rows(cut.lo, cut.hi)

        # The stack traversals' tables: the binary tree as rows and its
        # 8-wide collapse.
        node_pack = np.concatenate(
            [hb.node_min, hb.node_max, bits(hb.left)[:, None], bits(hb.count)[:, None]], axis=1
        ).astype(np.float32)
        t0 = time.perf_counter()
        hb8 = native.collapse_bvh8(hb)
        collapse_s = time.perf_counter() - t0
        wide_pack = np.concatenate([hb8.boxes.reshape(-1, 48), bits(hb8.child).reshape(-1, 8)],
                                   axis=1).astype(np.float32)
        self.timings = dict(bvh_s=bvh_s, collapse_s=collapse_s, tables_s=time.perf_counter() - t_start)
        return dict(positions=positions, tri_v=tri_v, tri_mat=tri_mat, tri_light=tri_light,
                    l_emission=l_emission, l_area=l_area, two_sided=two_sided, l_verts=l_verts,
                    l_norms=l_norms, tri_pack=tri_pack, shade_pack=shade_pack, clus_pack=clus_pack,
                    clus_first=cut.first, clus_box=clus_box, n_clus=n_clus,
                    coarse_pack=coarse.wide_pack, coarse_depth=coarse.depth,
                    coarse_max_leaf=coarse.max_leaf, node_pack=node_pack, wide_pack=wide_pack,
                    bvh_depth=hb.depth, wide_depth=hb8.depth)

    def _scene(self, device, geo: dict, lights: tuple, env: dict, center, radius, shared=None,
               **extra) -> CompiledScene:
        """CompiledScene on `device` from numpy tables: `geo` as `_tables`
        returns it (or the instanced scene's), `lights` = (emission, area,
        two_sided, verts, norms), `env` from `_compile_env`, and this
        builder's materials and texture atlases, or those of the scene
        `shared` (by reference); `extra` are the instanced fields."""
        l_emission, l_area, two_sided, l_verts, l_norms = lights
        l_power = (
            np.linalg.norm(l_emission, axis=-1) * l_area * _PI * np.where(two_sided, 2.0, 1.0)
        ).astype(np.float32)
        l_cdf = np.concatenate([[0.0], np.cumsum(l_power)]).astype(np.float32)
        t = lambda a, dtype=None: torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)
        env_img = torch.from_numpy(np.ascontiguousarray(env["env_img"], np.float32))
        from yart_tpu_torch.render.lights import env_rows_from_image

        env_rows = env_rows_from_image(env_img, torch.from_numpy(env["pdf_cells"]))
        if shared is None:
            looks = dict(materials=_material_table(self._materials).to(device),
                         tex_rgba=_stack_from_list(self.textures_rgba, 4).to(device),
                         tex_rgb=_stack_from_list(self.textures_rgb, 3).to(device),
                         tex_2ch=_stack_from_list(self.textures_2ch, 2).to(device),
                         tex_mono=_stack_from_list(self.textures_mono, 1).to(device))
        else:
            looks = {k: getattr(shared, k) for k in LOOKS}
        return (InstancedScene if extra else CompiledScene)(
            tri_pack=t(geo["tri_pack"]),
            positions=t(geo["positions"], np.float32),
            tri_v=t(geo["tri_v"], np.int32),
            shade_pack=t(geo["shade_pack"]),
            tri_mat=t(geo["tri_mat"]),
            tri_light=t(geo["tri_light"]),
            light_emission=t(l_emission, np.float32),
            light_area=t(l_area, np.float32),
            light_power=t(l_power),
            light_cdf=t(l_cdf),
            light_verts=t(l_verts, np.float32),
            light_norms=t(l_norms, np.float32),
            env_image=env_img.to(device),
            env_bounds=t(self._env_bounds, np.float32),
            env_alias=t(env["env_alias"]),
            env_rows=env_rows.to(device),
            env_rotation=t(self._env_rotation, np.float32),
            scene_center=t(center, np.float32),
            scene_radius=t(radius, np.float32),
            background=t(self._background, np.float32),
            clus_pack=t(geo["clus_pack"]),
            clus_first=t(geo["clus_first"]),
            coarse_pack=t(geo["coarse_pack"]),
            clus_box=t(geo["clus_box"]),
            node_pack=t(geo["node_pack"]),
            wide_pack=t(geo["wide_pack"]),
            **looks,
            **{k: t(v) for k, v in extra.items()},
        )

    def _meta(self, env: dict, **fields) -> SceneMeta:
        mats = self._materials
        return SceneMeta(
            n_materials=len(mats),
            has_env=self._env_image is not None,
            env_sampleable=self._env_sampleable,
            env_portal=self._env_bounds != (0.0, 0.0, 1.0, 1.0),
            env_wc=env["wc"],
            env_hc=env["hc"],
            any_alpha=any(m.has_alpha for m in mats),
            any_transparent=any(m.thin and m.transmission > 0.0 for m in mats),
            any_metallic=any(m.metallic > 0.0 or m.tex_mr >= 0 for m in mats),
            any_transmissive=any(m.transmission > 0.0 or m.tex_transmission >= 0 for m in mats),
            any_clearcoat=any(m.clearcoat > 0.0 or m.tex_clearcoat >= 0 for m in mats),
            any_anisotropy=any(m.anisotropic != 0.0 for m in mats),
            any_textures=any(
                max(m.tex_base, m.tex_mr, m.tex_transmission, m.tex_normal,
                    m.tex_clearcoat, m.tex_emission) >= 0
                for m in mats
            ),
            **fields,
        )

    def compile(self, device="cuda", cluster_size: int = 128):
        """-> (CompiledScene on `device`, the card by default; SceneMeta).
        Triangles are permuted into the leaf order of a binned-SAH BVH,
        which is cut into clusters of at most `cluster_size` triangles for
        the block trace. A scene with instances compiles through
        `_compile_instanced`."""
        device = resolve(device)
        if self._instances:
            return self._compile_instanced(device, cluster_size)
        return self._compile_tables(device, self._tables(cluster_size), cluster_size)

    def _compile_tables(self, device, geo: dict, cluster_size: int, shared=None):
        """(scene, meta) of a scene without instances from its `_tables`;
        `shared` as in `_scene`."""
        # Bounding sphere of the scene box: the env light's sample distance.
        positions = geo["positions"]
        lo, hi = positions.min(axis=0), positions.max(axis=0)
        center = (lo + hi) * 0.5
        radius = float(np.linalg.norm(hi - lo) * 0.5)
        lights = tuple(geo[k] for k in ("l_emission", "l_area", "two_sided", "l_verts", "l_norms"))
        env = self._compile_env()
        scene = self._scene(device, geo, lights, env, center, radius, shared)
        meta = self._meta(
            env,
            n_tris=int(geo["tri_v"].shape[0]),
            n_lights=int(lights[1].size),
            n_clusters=geo["n_clus"],
            cluster_size=int(cluster_size),
            n_clus_pad=int(geo["clus_box"].shape[1]),
            coarse_depth=geo["coarse_depth"],
            coarse_max_leaf=geo["coarse_max_leaf"],
            bvh_depth=geo["bvh_depth"],
            wide_depth=geo["wide_depth"],
        )
        return scene, meta

    def _compile_instanced(self, device, cluster_size: int):
        """Compile a scene with instanced prototypes (JAX builder.py:644-1020).

        Each prototype is compiled once, in object space, by a nested
        builder (`_tables`); an instance adds its transform rows, its
        virtual triangles' id maps (`tri_aux`: shade row, instance, light,
        material) and world-space area lights for its emissive triangles.
        Every (instance, prototype cluster) pair becomes one traversal
        cluster of the block trace: the world box of the object box's 8
        transformed corners, the prototype's pack row (`clus_src`), its
        instance (`clus_inst`) and its first virtual triangle
        (`clus_fid`). The inverse and normal matrices are formed in
        float64 and cast last."""
        # Meshes added with add_mesh (already world space) join as identity
        # instances of their own prototypes.
        if self._tris:
            v_off = 0
            for k in range(len(self._tris)):
                nv = self._positions[k].shape[0]
                self._protos.append(dict(
                    positions=self._positions[k].astype(np.float64),
                    normals=self._normals[k].astype(np.float64),
                    uvs=self._uvs[k].astype(np.float64),
                    tangents=self._tangents[k].astype(np.float64),
                    tris=self._tris[k].astype(np.int64) - v_off,
                    tri_mat=self._tri_mat[k],
                ))
                self._instances.append((len(self._protos) - 1, np.eye(4, dtype=np.float64)))
                v_off += nv
            self._positions, self._normals, self._uvs, self._tangents = [], [], [], []
            self._tris, self._tri_mat = [], []
            self._vtx_offset = 0

        # One object-space compile per prototype.
        geo, nested = [], []
        for pr in self._protos:
            sb = SceneBuilder()
            sb._materials = self._materials
            sb.textures_rgba = self.textures_rgba  # the alpha-mask bake reads them
            sb.add_mesh(pr["positions"], pr["tris"], pr["tri_mat"], normals=pr["normals"],
                        uvs=pr["uvs"], tangents=pr["tangents"])
            geo.append(sb._tables(cluster_size))
            nested.append(sb)
        # The prototypes' builds summed: an instanced scene's host build.
        self.timings = {k: sum(sb.timings[k] for sb in nested) for k in ("bvh_s", "collapse_s", "tables_s")}

        mats = self._materials
        inst_proto = tuple(int(p) for p, _ in self._instances)
        n_inst = len(self._instances)
        proto_ntris = [int(g["tri_v"].shape[0]) for g in geo]
        proto_shade_base = np.concatenate([[0], np.cumsum(proto_ntris)]).astype(np.int64)
        inst_tri_base = np.concatenate(
            [[0], np.cumsum([proto_ntris[p] for p in inst_proto])]).astype(np.int64)
        n_virt = int(inst_tri_base[-1])

        emission_table = np.asarray(
            [np.asarray(m.emission, np.float32) * np.float32(m.emission_strength) for m in mats]
            or np.zeros((0, 3), np.float32),
            np.float32,
        )
        emissive_mats = np.asarray([m.is_emissive for m in mats], bool)
        ts_table = np.asarray([m.two_sided for m in mats] or [False], bool)

        inst_rows = np.zeros((n_inst, 40), np.float32)
        tri_aux = np.zeros((max(n_virt, 1), 8), np.int32)
        lights = dict(emission=[], area=[], two=[], verts=[], norms=[])
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        n_light = 0
        for i, (p, m) in enumerate(self._instances):
            inv = np.linalg.inv(m)
            nrm_m = np.linalg.inv(m[:3, :3]).T
            inst_rows[i, 0:12] = inv[:3, :4].reshape(-1)
            inst_rows[i, 12:24] = m[:3, :4].reshape(-1)
            inst_rows[i, 24:33] = nrm_m.reshape(-1)

            base = int(inst_tri_base[i])
            tp = proto_ntris[p]
            proto_mat = geo[p]["tri_mat"]
            tri_aux[base : base + tp, 0] = (proto_shade_base[p] + np.arange(tp)).astype(np.int32)
            tri_aux[base : base + tp, 1] = i
            tri_aux[base : base + tp, 2] = -1
            tri_aux[base : base + tp, 3] = proto_mat

            # World bounds from the 8 transformed corners of the
            # prototype's vertex bounds.
            pl = self._protos[p]["positions"].min(axis=0)
            ph = self._protos[p]["positions"].max(axis=0)
            cs = np.array([[x, y, z] for x in (pl[0], ph[0]) for y in (pl[1], ph[1])
                           for z in (pl[2], ph[2])])
            wc8 = cs @ m[:3, :3].T + m[:3, 3]
            lo = np.minimum(lo, wc8.min(axis=0))
            hi = np.maximum(hi, wc8.max(axis=0))

            # Area lights of the emissive instance triangles, in world space.
            em_mask = emissive_mats[proto_mat] if len(mats) else np.zeros(tp, bool)
            em_idx = np.nonzero(em_mask)[0]
            if em_idx.size:
                v = geo[p]["tri_pack"][em_idx, 0:9].reshape(-1, 3, 3) @ m[:3, :3].T + m[:3, 3]
                nn = geo[p]["shade_pack"][em_idx, 0:9].reshape(-1, 3, 3) @ nrm_m.T
                nn = nn / np.maximum(np.linalg.norm(nn, axis=-1, keepdims=True), 1e-20)
                tri_aux[base + em_idx, 2] = (n_light + np.arange(em_idx.size)).astype(np.int32)
                lights["emission"].append(emission_table[proto_mat[em_idx]])
                e1 = v[:, 1] - v[:, 0]
                e2 = v[:, 2] - v[:, 0]
                lights["area"].append(0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1))
                lights["two"].append(ts_table[proto_mat[em_idx]])
                lights["verts"].append(v)
                lights["norms"].append(nn)
                n_light += em_idx.size

        if n_light:
            light_rows = (
                np.concatenate(lights["emission"]).astype(np.float32),
                np.concatenate(lights["area"]).astype(np.float32),
                np.concatenate(lights["two"]),
                np.concatenate(lights["verts"]).astype(np.float32),
                np.concatenate(lights["norms"]).astype(np.float32),
            )
        else:
            light_rows = (np.zeros((0, 3), np.float32), np.zeros(0, np.float32), np.zeros(0, bool),
                          np.zeros((0, 3, 3), np.float32), np.zeros((0, 3, 3), np.float32))
        center = (lo + hi) * 0.5
        radius = float(np.linalg.norm(hi - lo) * 0.5)

        # The single-pass tables: one traversal cluster per (instance,
        # prototype cluster), sharing the prototype's object-space pack row.
        proto_nclus = [g["n_clus"] for g in geo]
        proto_clus_base = np.concatenate([[0], np.cumsum(proto_nclus)]).astype(np.int64)
        ic_src, ic_inst, ic_fid, ic_lo, ic_hi = [], [], [], [], []
        for i, (p, m) in enumerate(self._instances):
            nc = proto_nclus[p]
            ic_src.append(proto_clus_base[p] + np.arange(nc))
            ic_inst.append(np.full(nc, i))
            ic_fid.append(int(inst_tri_base[i]) + geo[p]["clus_first"])
            plo = geo[p]["clus_box"][0:3, :nc].T
            phi = geo[p]["clus_box"][3:6, :nc].T
            corners = np.stack(
                [np.where(np.asarray([(ix >> a) & 1 for a in range(3)], bool)[None, :], phi, plo)
                 for ix in range(8)],
                axis=1,
            )  # [nc, 8, 3]
            wcor = corners @ m[:3, :3].T + m[:3, 3]
            ic_lo.append(wcor.min(axis=1))
            ic_hi.append(wcor.max(axis=1))
        n_ic = int(sum(proto_nclus[p] for p in inst_proto))
        ic_box = _box_rows(np.concatenate(ic_lo).astype(np.float32),
                           np.concatenate(ic_hi).astype(np.float32))
        pad_i = np.zeros(ic_box.shape[1] - n_ic, np.int32)
        padded = lambda parts: np.concatenate([np.concatenate(parts).astype(np.int32), pad_i])

        z1 = np.zeros(1, np.int32)
        tables = dict(tri_pack=np.zeros((1, 12), np.float32),
                      positions=np.zeros((1, 3), np.float32), tri_v=np.zeros((1, 3), np.int32),
                      shade_pack=np.concatenate([g["shade_pack"] for g in geo]),
                      tri_mat=z1, tri_light=z1,
                      clus_pack=np.concatenate([g["clus_pack"] for g in geo]),
                      clus_first=z1, clus_box=ic_box,
                      # Placeholders: bin-trace and the stack traversals
                      # skip instanced scenes (their prototypes hold these).
                      coarse_pack=np.zeros((1, 56), np.float32),
                      node_pack=np.zeros((1, 8), np.float32),
                      wide_pack=np.zeros((1, 56), np.float32))
        vert_base = np.concatenate([[0], np.cumsum([g["positions"].shape[0] for g in geo])])[:-1]
        env = self._compile_env()
        scene = self._scene(
            device, tables, light_rows, env, center, radius,
            inst_rows=inst_rows,
            inst_tri_base=inst_tri_base[:-1].astype(np.int32),
            tri_aux=tri_aux,
            clus_src=padded(ic_src),
            clus_inst=padded(ic_inst),
            clus_fid=padded(ic_fid),
            inst_flat=inst_rows[:, 0:12].reshape(-1).astype(np.float32),
            proto_pos=np.concatenate([g["positions"] for g in geo]).astype(np.float32),
            proto_tri=np.concatenate(
                [g["tri_v"] + np.int32(b) for g, b in zip(geo, vert_base)]).astype(np.int32),
        )
        # The per-instance loop's prototype scenes (JAX builder.py:685-704,
        # 840-848), sharing this scene's material table and atlases.
        protos = [sb._compile_tables(device, g, cluster_size, shared=scene) for sb, g in zip(nested, geo)]
        scene = dataclasses.replace(scene, protos=tuple(p for p, _ in protos))
        meta = self._meta(
            env,
            n_tris=n_virt,
            n_lights=int(light_rows[1].size),
            cluster_size=int(cluster_size),
            n_clus_pad=int(ic_box.shape[1]),
            wide_depth=1,
            n_instances=n_inst,
            inst_proto=inst_proto,
            proto_metas=tuple(m for _, m in protos),
            n_inst_clusters=n_ic,
        )
        return scene, meta


def _box_rows(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Cluster boxes lo [n, 3], hi [n, 3] as the block trace's SoA rows
    [8, n_pad] (lo.xyz, hi.xyz, 2 zero rows), lane-padded to 128 or a
    multiple of 512, with pad boxes at the far sentinel +3e38."""
    n = lo.shape[0]
    n_pad = max(128, -(-n // 512) * 512 if n > 128 else 128)
    box = np.full((8, n_pad), 3.0e38, np.float32)
    box[6:8] = 0.0
    box[0:3, :n] = lo.T
    box[3:6, :n] = hi.T
    return box


def _material_table(mats: List[MaterialDesc]) -> MaterialTable:
    """builder.py:1028 `_material_table`, as CPU tensors."""
    if not mats:
        mats = [MaterialDesc()]
    f32 = lambda rows: torch.from_numpy(np.asarray(rows, np.float32))
    i32 = lambda rows: torch.from_numpy(np.asarray(rows, np.int32))
    b = lambda rows: torch.from_numpy(np.asarray(rows, bool))
    return MaterialTable(
        base_color=f32([m.base_color for m in mats]),
        metallic=f32([m.metallic for m in mats]),
        roughness=f32([m.roughness for m in mats]),
        transmission=f32([m.transmission for m in mats]),
        ior=f32([m.ior for m in mats]),
        anisotropic=f32([m.anisotropic for m in mats]),
        aniso_rotation=f32([m.aniso_rotation for m in mats]),
        clearcoat=f32([m.clearcoat for m in mats]),
        cc_roughness=f32([m.cc_roughness for m in mats]),
        emission=f32(
            [np.asarray(m.emission, np.float32) * np.float32(m.emission_strength) for m in mats]
        ),
        normal_scale=f32([m.normal_scale for m in mats]),
        thin=b([m.thin for m in mats]),
        volume_color=f32([m.volume_color for m in mats]),
        volume_density=f32([m.volume_density for m in mats]),
        tex_base=i32([m.tex_base for m in mats]),
        tex_mr=i32([m.tex_mr for m in mats]),
        tex_transmission=i32([m.tex_transmission for m in mats]),
        tex_normal=i32([m.tex_normal for m in mats]),
        tex_clearcoat=i32([m.tex_clearcoat for m in mats]),
        tex_emission=i32([m.tex_emission for m in mats]),
        has_alpha=b([m.has_alpha for m in mats]),
    )
