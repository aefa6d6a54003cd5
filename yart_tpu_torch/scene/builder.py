"""Host-side scene builder -> the port's CompiledScene.

Port of the subset of `yart_tpu/scene/builder.py` the brute-force path
needs: materials, world-space meshes, background, and `compile()` with the
area-light table (builder.py:401-451), the packed `tri_pack` / `shade_pack`
rows (:481-492) and the material table (:1028). Pure numpy on the host,
then tensors: the machine with the GPU has no JAX, so the port builds its
own scenes.

Not ported (ROADMAP.md A.6 / A.10): BVH and cluster tables, environment
light, textures, instancing. Unlike the JAX builder, which permutes
triangles into BVH leaf order, triangles here stay in insertion order.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from yart_tpu_torch.scene.types import CompiledScene, MaterialTable, SceneMeta

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
        self._background = (0.0, 0.0, 0.0)

    def add_material(self, **kwargs) -> int:
        self._materials.append(MaterialDesc(**kwargs))
        return len(self._materials) - 1

    def add_mesh(self, positions: np.ndarray, indices: np.ndarray, material) -> None:
        """Add a world-space triangle mesh with area-weighted vertex normals,
        zero uvs and the default +x tangent; `material` is one index or a
        per-face [T] array."""
        positions = np.asarray(positions, np.float64).reshape(-1, 3)
        indices = np.asarray(indices, np.int64).reshape(-1, 3)
        nv = positions.shape[0]
        tangents = np.zeros((nv, 4), np.float32)
        tangents[:, 0] = 1.0
        tangents[:, 3] = 1.0

        t = indices.shape[0]
        self._positions.append(positions.astype(np.float32))
        self._normals.append(_face_normals_to_vertices(positions, indices).astype(np.float32))
        self._tangents.append(tangents)
        self._uvs.append(np.zeros((nv, 2), np.float32))
        self._tris.append((indices + self._vtx_offset).astype(np.int32))
        self._tri_mat.append(np.broadcast_to(np.asarray(material, np.int32), (t,)).copy())
        self._vtx_offset += nv

    def set_background(self, color) -> None:
        self._background = tuple(color)

    def compile(self, device="cpu"):
        """-> (CompiledScene on `device`, SceneMeta)."""
        if not self._tris:
            raise ValueError("scene has no geometry")
        positions = np.concatenate(self._positions)
        normals = np.concatenate(self._normals)
        tangents = np.concatenate(self._tangents)
        uvs = np.concatenate(self._uvs)
        tri_v = np.concatenate(self._tris)
        tri_mat = np.concatenate(self._tri_mat)
        v0, v1, v2 = (positions[tri_v[:, k]] for k in range(3))

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
        l_power = (
            np.linalg.norm(l_emission, axis=-1) * l_area * _PI * np.where(two_sided, 2.0, 1.0)
        ).astype(np.float32)
        l_cdf = np.concatenate([[0.0], np.cumsum(l_power)]).astype(np.float32)
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

        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        scene = CompiledScene(
            tri_pack=t(tri_pack),
            shade_pack=t(shade_pack),
            tri_mat=t(tri_mat),
            tri_light=t(tri_light),
            materials=_material_table(mats).to(device),
            light_emission=t(l_emission),
            light_area=t(l_area),
            light_power=t(l_power),
            light_cdf=t(l_cdf),
            light_verts=t(l_verts),
            light_norms=t(l_norms),
            background=t(np.asarray(self._background, np.float32)),
        )
        meta = SceneMeta(
            n_tris=int(tri_v.shape[0]),
            n_materials=len(mats),
            n_lights=int(light_tri.size),
            has_env=False,
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
        )
        return scene, meta


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
