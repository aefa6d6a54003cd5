"""Wavefront ray-scene intersection for the brute-force path.

Port of `yart_tpu/render/intersect.py` `Hit`, `intersect_brute` and the
dispatcher `intersect` (:937) for the scenes this slice supports: ungated,
non-instanced scenes of at most 4096 triangles. There every ray — camera,
continuation and NEE shadow — goes to B1 (`kernels/brute.py`): the
Hopper kernel for CUDA tensors, its plain twin for CPU tensors. Shadow
rays of ungated scenes are closest-hit queries too, exactly as in the JAX
package's brute paths.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from yart_tpu_torch.kernels import brute as _brute
from yart_tpu_torch.scene.types import CompiledScene, SceneMeta


class Hit(NamedTuple):
    """SoA hit record (src/cpu/hit.hpp:8-17). All [N]."""

    t: torch.Tensor  # hit distance; t_max on a miss
    tri: torch.Tensor  # int32 triangle index, -1 on a miss
    u: torch.Tensor  # barycentric u
    v: torch.Tensor  # barycentric v
    back_side: torch.Tensor  # bool
    mask: torch.Tensor  # bool, True = real hit


def _hit(t, u, v, back, tri) -> Hit:
    return Hit(t, tri, u, v, back, tri >= 0)


def check_supported(meta: SceneMeta, nee: bool = False) -> None:
    """Raise for scenes the ported intersection path cannot take."""
    if meta.n_instances:
        raise NotImplementedError(
            "instanced scenes need the block-trace kernels B2/B3, not ported "
            "yet (ROADMAP.md A.6)"
        )
    if meta.any_alpha or (nee and meta.any_transparent):
        raise NotImplementedError(
            "alpha-tested or NEE-transparent scenes need the gated traversal, "
            "not ported yet (ROADMAP.md A.6)"
        )
    if meta.n_tris > _brute.MAX_TRIS:
        raise NotImplementedError(
            f"{meta.n_tris} triangles: scenes over {_brute.MAX_TRIS} need the "
            "big-scene traversal (B2/B3), not ported yet (ROADMAP.md A.6)"
        )


def intersect_brute(scene: CompiledScene, meta: SceneMeta, o, d, t_max, t_min: float = 1e-3) -> Hit:
    """Every ray against every triangle with the plain twin, on any device
    (the reference for the kernel)."""
    return _hit(*_brute.brute_plain(scene.tri_pack, o, d, t_max, meta.n_tris, t_min))


def intersect(scene: CompiledScene, meta: SceneMeta, o, d, t_max, t_min: float = 1e-3, nee: bool = False) -> Hit:
    """Dispatch (render/intersect.py:937): B1 for every supported scene."""
    check_supported(meta, nee)
    return _hit(*_brute.brute_intersect(scene.tri_pack, o, d, t_max, meta.n_tris, t_min))
