"""Compiled scene tables for the brute-force render path.

Port of `yart_tpu/scene/types.py`, holding only the fields the ported
path reads. Triangles are a flat world-space soup; `tri_pack` and
`shade_pack` keep the JAX package's packed row layouts (builder.py:481-492),
including the int32 ids bit-cast into float32 columns (`tri_pack[:, 9:11]`,
`shade_pack[:, 27:29]`). Those columns are carried bit-exactly but never
read as floats: the render path takes `tri_mat` / `tri_light` directly.
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


@dataclasses.dataclass(frozen=True)
class CompiledScene:
    """The scene as tensors; `.to(device)` moves all of them."""

    tri_pack: torch.Tensor  # [T, 12] f32: v0 v1 v2, mat bits, light bits, pad
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
    background: torch.Tensor  # [3]

    def to(self, device) -> "CompiledScene":
        return CompiledScene(
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            }
        )


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static scene facts that select code paths (a subset of
    yart_tpu.scene.types.SceneMeta)."""

    n_tris: int
    n_materials: int
    n_lights: int
    has_env: bool = False
    any_alpha: bool = False
    any_textures: bool = False
    any_transparent: bool = False
    any_metallic: bool = True
    any_transmissive: bool = True
    any_clearcoat: bool = True
    any_anisotropy: bool = True
    n_instances: int = 0
