"""Compiled scene tables of the ported render path.

Port of `yart_tpu/scene/types.py`, holding the fields the ported path
reads (and `env_image` and `scene_center`, which the env rows and the
sample distance derive from), under the JAX package's names; a scene with
instances is an `InstancedScene`, which adds the instanced tables. Triangles are a flat
world-space soup in BVH leaf order; `tri_pack` and `shade_pack` keep the
JAX package's packed row layouts (builder.py:481-492), including the int32
ids bit-cast into float32 columns (`tri_pack[:, 9:11]`,
`shade_pack[:, 27:29]`, `clus_pack[:, 4, 0]`, `env_alias[:, 1]`,
`node_pack[:, 6:8]`, `wide_pack[:, 48:56]`). Those columns are carried
bit-exactly; the render path reads the ids through int32 views or the int
tables.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class MaterialTable(NamedTuple):
    """Parametric uber-material parameters, one row per material
    (src/bsdf/parametric.hpp:16-37). Leading dim [M]."""

    base_color: torch.Tensor  # [M, 4] rgba factor
    metallic: torch.Tensor  # [M]
    roughness: torch.Tensor  # [M]
    transmission: torch.Tensor  # [M]
    ior: torch.Tensor  # [M]
    anisotropic: torch.Tensor  # [M]
    aniso_rotation: torch.Tensor  # [M] radians
    clearcoat: torch.Tensor  # [M]
    cc_roughness: torch.Tensor  # [M]
    emission: torch.Tensor  # [M, 3] (scaled by emission strength)
    normal_scale: torch.Tensor  # [M]
    thin: torch.Tensor  # [M] bool
    volume_color: torch.Tensor  # [M, 3]
    volume_density: torch.Tensor  # [M]
    tex_base: torch.Tensor  # [M] int32, -1 = untextured
    tex_mr: torch.Tensor
    tex_transmission: torch.Tensor
    tex_normal: torch.Tensor
    tex_clearcoat: torch.Tensor
    tex_emission: torch.Tensor
    has_alpha: torch.Tensor  # [M] bool

    def to(self, device) -> "MaterialTable":
        return MaterialTable(*(t.to(device) for t in self))


class TextureStack(NamedTuple):
    """All textures of one channel count, shelf-packed into one atlas
    (scene/builder.py `_stack_from_list`). Bilinear fetches scale by
    (size - 1) and clamp the base texel to size - 2, so a lookup never
    leaves its own rect. Data keeps the storage encoding: gamma-2 for sRGB
    colour, linear otherwise; the caller decodes."""

    data: torch.Tensor  # [H, W, C] float32 atlas
    table: torch.Tensor  # [K, 4] int32 (x0, y0, w, h) rects
    qrows: torch.Tensor  # [H*W, 4C] 2x2 quad rows (render/texture.py)

    def to(self, device) -> "TextureStack":
        return TextureStack(*(t.to(device) for t in self))


# The material table and texture atlases: one set per instanced scene,
# shared by its prototype scenes.
LOOKS = ("materials", "tex_rgba", "tex_rgb", "tex_2ch", "tex_mono")


@dataclasses.dataclass(frozen=True)
class CompiledScene:
    """The scene as tensors; `.to(device)` moves all of them."""

    tri_pack: torch.Tensor  # [T, 12] f32: v0 v1 v2, mat bits, light bits, pad
    # Vertex positions and each triangle's vertex ids in the leaf order of
    # `tri_pack`: only the differentiable path reads them, re-solving hits
    # against vertices that can carry gradients (`cfg.diff_geometry`).
    # An instanced scene holds the JAX builder's one-row placeholders.
    positions: torch.Tensor  # [V, 3] f32
    tri_v: torch.Tensor  # [T, 3] int32 into positions
    shade_pack: torch.Tensor  # [T, 32] f32: n0 n1 n2 uv0 uv1 uv2 t0 t1 t2 mat light
    tri_mat: torch.Tensor  # [T] int32
    tri_light: torch.Tensor  # [T] int32, -1 = not emissive
    materials: MaterialTable
    light_emission: torch.Tensor  # [L, 3]
    light_area: torch.Tensor  # [L]
    light_power: torch.Tensor  # [L]
    light_cdf: torch.Tensor  # [L + 1] cumulative power, unnormalized
    light_verts: torch.Tensor  # [L, 3, 3]
    light_norms: torch.Tensor  # [L, 3, 3]
    # Environment light (octahedral map; light.cpp:137-242). 1x1 zeros when
    # the scene has none. Sampling is an alias table over the (W-1)x(H-1)
    # bilinear base cells; env_rows packs each cell's 2x2 texel quad and
    # its sampling pdf, so radiance and pdf come from one row.
    env_image: torch.Tensor  # [H, W, 3] linear radiance (scale applied)
    env_bounds: torch.Tensor  # [4] portal crop (u0, v0, u1, v1); full = 0,0,1,1
    env_alias: torch.Tensor  # [K, 4] (prob, alias bits, pdf, pdf of alias)
    env_rows: torch.Tensor  # [K, 16] 2x2 rgb quad (12) + pdf + pad(3)
    env_rotation: torch.Tensor  # [3, 3] world -> map rotation
    scene_center: torch.Tensor  # [3]
    scene_radius: torch.Tensor  # [] bounding-sphere radius of the scene box
    background: torch.Tensor  # [3]
    # Texture atlases by channel class (a 1x1 zero atlas with no rects when
    # the class is empty).
    tex_rgba: TextureStack  # base colour (gamma-2) + alpha
    tex_rgb: TextureStack  # normal maps, emission (gamma-2)
    tex_2ch: TextureStack  # metallic-roughness
    tex_mono: TextureStack  # transmission, clearcoat
    # Block-trace and bin-trace tables (scene/clusters.py, render/blocktrace.py,
    # render/bintrace.py):
    clus_pack: torch.Tensor  # [n_clus, 8, 3C] plane/barycentric rows; row 5: alpha-mask words
    clus_first: torch.Tensor  # [n_clus] int32 first triangle of each cluster
    coarse_pack: torch.Tensor  # [G, 56] coarse BVH8 over the cluster boxes (bin-trace)
    clus_box: torch.Tensor  # [8, n_clus_pad] lo.xyz, hi.xyz, pad; pad boxes at +3e38
    # Stack-traversal tables (render/stacktrace.py): the binary tree as rows
    # (min3, max3, left bits, count bits) and its 8-wide collapse, 8 child
    # boxes (min3, max3) then the 8 child refs' bits (scene/bvh.py
    # `collapse_bvh8`: >= 0 group, -1 empty, <= -2 leaf). An instanced
    # scene holds one-row placeholders; its prototypes hold the real ones.
    node_pack: torch.Tensor  # [Nn, 8] f32
    wide_pack: torch.Tensor  # [M8, 56] f32

    def to(self, device, looks=None) -> "CompiledScene":
        """The scene on `device`; `looks` maps LOOKS fields to tables already
        there (a prototype's, shared with its instanced scene)."""
        looks = looks or {}
        return type(self)(**{f.name: looks[f.name] if f.name in looks else getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self) if f.name != "protos"})


@dataclasses.dataclass(frozen=True)
class InstancedScene(CompiledScene):
    """A scene with instances (scene.hpp:48-66; JAX types.py:165-187, where
    these fields are None for a scene without). Prototypes keep their
    object-space packs and shading rows once; an instance adds a transform
    row and its virtual triangle ids. Every (instance, prototype cluster)
    pair is one traversal cluster of the block trace: its world box in
    `clus_box`, the prototype's pack row through `clus_src`, its ray
    transform in `inst_flat`. `tri_pack`, `tri_mat`, `tri_light` and
    `clus_first` are the JAX builder's one-row placeholders; the virtual
    triangles are indexed through `tri_aux`."""

    inst_rows: torch.Tensor  # [I, 40] f32: inverse 3x4 | forward 3x4 | normal 3x3 | pad
    inst_tri_base: torch.Tensor  # [I] int32 first virtual triangle of each instance
    tri_aux: torch.Tensor  # [Tv, 8] int32: shade row, instance, light, material, pad
    clus_src: torch.Tensor  # [n_ic_pad] int32 clus_pack row of each instance cluster
    clus_inst: torch.Tensor  # [n_ic_pad] int32 instance of each instance cluster
    clus_fid: torch.Tensor  # [n_ic_pad] int32 first virtual triangle of each instance cluster
    inst_flat: torch.Tensor  # [I * 12] f32 the inverse 3x4 rows, flat
    # Object-space prototype vertices and leaf-ordered triangles: the
    # differentiable path's `positions` / `tri_v` of an instanced scene.
    proto_pos: torch.Tensor  # [sum V_p, 3] f32
    proto_tri: torch.Tensor  # [sum T_p, 3] int32 into proto_pos
    # One object-space scene per prototype, traversed by the per-instance
    # loop (render/intersect.py `intersect_instanced`); they share this
    # scene's material table and texture atlases.
    protos: tuple = ()

    def to(self, device, looks=None) -> "InstancedScene":
        moved = super().to(device, looks)
        shared = {k: getattr(moved, k) for k in LOOKS}
        return dataclasses.replace(moved, protos=tuple(p.to(device, shared) for p in self.protos))


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static scene facts that select code paths (a subset of
    yart_tpu.scene.types.SceneMeta)."""

    n_tris: int
    n_materials: int
    n_lights: int
    has_env: bool = False
    # UniformInfiniteLight (light.cpp:83-135) when False: radiance on a miss
    # only, pdf 0, never sampled by NEE.
    env_sampleable: bool = True
    env_portal: bool = False  # portal crop active (light.cpp:147-155)
    env_wc: int = 1  # env sampling grid: (W-1) x (H-1) bilinear base cells
    env_hc: int = 1
    any_alpha: bool = False
    any_textures: bool = False
    any_transparent: bool = False
    any_metallic: bool = True
    any_transmissive: bool = True
    any_clearcoat: bool = True
    any_anisotropy: bool = True
    n_clusters: int = 1
    cluster_size: int = 128  # C: triangle capacity of a cluster
    coarse_depth: int = 1  # depth of the coarse BVH8 (bin-trace)
    coarse_max_leaf: int = 2  # most clusters in one coarse leaf
    bintrace_k: int = 12  # K: cluster slots per ray per bin-trace round
    n_clus_pad: int = 128  # clus_box lane padding
    max_leaf: int = 4  # most triangles in a leaf of the triangle BVH
    bvh_depth: int = 1  # binary tree depth (stack bound of intersect_bvh)
    wide_depth: int = 8  # 8-wide tree depth (stack bound 7 * wide_depth + 2)
    n_instances: int = 0
    inst_proto: tuple = ()  # prototype of each instance
    proto_metas: tuple = ()  # SceneMeta of each prototype
    n_inst_clusters: int = 0  # traversal clusters of an instanced scene
