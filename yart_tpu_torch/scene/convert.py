"""Carry a scene compiled by the JAX package across to the port.

The test side gets numpy leaves with
`jax.tree_util.tree_map(np.asarray, scene)`; this module imports no jax.
Every leaf is copied bit-exactly (byte copies only, no float conversion),
so the int32 ids bit-cast into float32 columns
survive, NaN patterns and denormals included. A scene with instances (the
JAX scene's `tri_aux` is not None) becomes an `InstancedScene`, its
instanced tables carried the same way and its prototype scenes and metas
(`protos`, `proto_metas`) recursively, the prototypes sharing the scene's
material table and atlases.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from yart_tpu_torch.device import resolve
from yart_tpu_torch.scene.types import (LOOKS, CompiledScene, InstancedScene, MaterialTable,
                                        SceneMeta, TextureStack)


def _t(a, device) -> torch.Tensor:
    # np.array copies the bytes into a writable, contiguous buffer.
    return torch.from_numpy(np.array(a, order="C")).to(device)


def from_numpy(leaves, meta_fields, device="cuda"):
    """(numpy CompiledScene, SceneMeta fields) -> the port's (scene, meta).

    `leaves` has the JAX `CompiledScene` attributes as numpy arrays;
    `meta_fields` is a mapping of the JAX `SceneMeta` fields (for example
    `dataclasses.asdict(meta)`, whose `proto_metas` are mappings too). The
    tensors go to `device`, the card by default.
    """
    return _scene(leaves, resolve(device)), _meta(meta_fields)


_NAMED = {"materials": MaterialTable, "tex_rgba": TextureStack, "tex_rgb": TextureStack,
          "tex_2ch": TextureStack, "tex_mono": TextureStack}


def _scene(leaves, device, looks=None) -> CompiledScene:
    """The scene of numpy `leaves`; with `looks` (a scene) its material
    table and atlases are that scene's, as a prototype's are the instanced
    scene's in the JAX builder."""
    def leaf(name):
        v = getattr(leaves, name)
        if looks is not None and name in LOOKS:
            return getattr(looks, name)
        if name in _NAMED:
            return _NAMED[name](*(_t(getattr(v, g), device) for g in _NAMED[name]._fields))
        return _t(v, device)

    if getattr(leaves, "tri_aux", None) is None:
        return CompiledScene(**{f.name: leaf(f.name) for f in dataclasses.fields(CompiledScene)})
    scene = InstancedScene(**{f.name: leaf(f.name) for f in dataclasses.fields(InstancedScene)
                              if f.name != "protos"})
    return dataclasses.replace(scene, protos=tuple(_scene(p, device, scene) for p in leaves.protos))


def _meta(fields) -> SceneMeta:
    names = {f.name for f in dataclasses.fields(SceneMeta)}
    kept = {k: v for k, v in dict(fields).items() if k in names}
    kept["proto_metas"] = tuple(_meta(m) for m in kept.get("proto_metas", ()))
    return SceneMeta(**kept)
