"""Carry a scene compiled by the JAX package across to the port.

The test side gets numpy leaves with
`jax.tree_util.tree_map(np.asarray, scene)`; this module imports no jax.
Every leaf is copied bit-exactly (byte copies only, no float conversion),
so the int32 ids bit-cast into float32 columns
survive, NaN patterns and denormals included.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from yart_tpu_torch.scene.types import CompiledScene, MaterialTable, SceneMeta


def _t(a, device) -> torch.Tensor:
    # np.array copies the bytes into a writable, contiguous buffer.
    return torch.from_numpy(np.array(a, order="C")).to(device)


def from_numpy(leaves, meta_fields, device="cpu"):
    """(numpy CompiledScene, SceneMeta fields) -> the port's (scene, meta).

    `leaves` has the JAX `CompiledScene` attributes as numpy arrays;
    `meta_fields` is a mapping of the JAX `SceneMeta` fields (for example
    `dataclasses.asdict(meta)`).
    """
    mats = leaves.materials
    scene = CompiledScene(
        tri_pack=_t(leaves.tri_pack, device),
        shade_pack=_t(leaves.shade_pack, device),
        tri_mat=_t(leaves.tri_mat, device),
        tri_light=_t(leaves.tri_light, device),
        materials=MaterialTable(
            *(_t(getattr(mats, f), device) for f in MaterialTable._fields)
        ),
        light_emission=_t(leaves.light_emission, device),
        light_area=_t(leaves.light_area, device),
        light_power=_t(leaves.light_power, device),
        light_cdf=_t(leaves.light_cdf, device),
        light_verts=_t(leaves.light_verts, device),
        light_norms=_t(leaves.light_norms, device),
        background=_t(leaves.background, device),
    )
    names = {f.name for f in dataclasses.fields(SceneMeta)}
    meta = SceneMeta(**{k: v for k, v in dict(meta_fields).items() if k in names})
    return scene, meta
