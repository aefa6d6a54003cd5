"""Carry a scene compiled by the JAX package across to the port.

The test side gets numpy leaves with
`jax.tree_util.tree_map(np.asarray, scene)`; this module imports no jax.
Every leaf is copied bit-exactly (byte copies only, no float conversion),
so the int32 ids bit-cast into float32 columns
survive, NaN patterns and denormals included. A scene with instances (the
JAX scene's `tri_aux` is not None) becomes an `InstancedScene`, its
instanced tables carried the same way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from yart_tpu_torch.device import resolve
from yart_tpu_torch.scene.types import (CompiledScene, InstancedScene, MaterialTable, SceneMeta,
                                        TextureStack)


def _t(a, device) -> torch.Tensor:
    # np.array copies the bytes into a writable, contiguous buffer.
    return torch.from_numpy(np.array(a, order="C")).to(device)


def from_numpy(leaves, meta_fields, device="cuda"):
    """(numpy CompiledScene, SceneMeta fields) -> the port's (scene, meta).

    `leaves` has the JAX `CompiledScene` attributes as numpy arrays;
    `meta_fields` is a mapping of the JAX `SceneMeta` fields (for example
    `dataclasses.asdict(meta)`). The tensors go to `device`, the card by
    default.
    """
    device = resolve(device)

    def leaf(name):
        v = getattr(leaves, name)
        if name == "materials":
            return MaterialTable(*(_t(getattr(v, g), device) for g in MaterialTable._fields))
        if name.startswith("tex_"):
            return TextureStack(*(_t(getattr(v, g), device) for g in TextureStack._fields))
        return _t(v, device)

    cls = CompiledScene if getattr(leaves, "tri_aux", None) is None else InstancedScene
    scene = cls(**{f.name: leaf(f.name) for f in dataclasses.fields(cls)})
    names = {f.name for f in dataclasses.fields(SceneMeta)}
    meta = SceneMeta(**{k: v for k, v in dict(meta_fields).items() if k in names})
    return scene, meta
