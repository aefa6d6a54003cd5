"""Wavefront ray-scene intersection.

Port of `yart_tpu/render/intersect.py` `Hit`, `intersect_brute` and the
dispatcher `intersect` (:937-1025) for ungated, non-instanced scenes:

- at most 4096 triangles: every ray goes to B1 (`kernels/brute.py`);
- more triangles, at most 8192 clusters: every ray goes to the block trace
  (`render/blocktrace.py`, kernels B2 and B3).

CUDA tensors run the Hopper kernels, CPU tensors their plain twins, on
every device alike. Shadow rays of ungated scenes are closest-hit queries
for B1 and any-hit queries for the block trace, exactly as in the JAX
package. Gated (alpha-tested, NEE-transparent) and instanced scenes, and
scenes past the cluster cap, raise NotImplementedError with their
ROADMAP.md item.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from yart_tpu_torch.kernels import brute as _brute
from yart_tpu_torch.render import blocktrace
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
    """Raise for scenes the ported intersection paths cannot take."""
    if meta.n_instances:
        raise NotImplementedError(
            "instanced scenes need the instanced block-trace mode of B3, not "
            "ported yet (ROADMAP.md A.6, the atrium slice)"
        )
    if meta.any_alpha or (nee and meta.any_transparent):
        raise NotImplementedError(
            "alpha-tested or NEE-transparent scenes need the gated block-trace "
            "re-cast loop, not ported yet (ROADMAP.md A.6, the atrium slice)"
        )
    if meta.n_tris > _brute.MAX_TRIS and meta.n_clusters > blocktrace.MAX_CLUSTERS:
        raise NotImplementedError(
            f"{meta.n_clusters} clusters: scenes past {blocktrace.MAX_CLUSTERS} "
            "need the bin-trace traversal (B4), not ported yet (ROADMAP.md A.9)"
        )


def intersect_brute(scene: CompiledScene, meta: SceneMeta, o, d, t_max, t_min: float = 1e-3) -> Hit:
    """Every ray against every triangle with B1's plain twin, on any device
    (the reference for both traversals)."""
    return _hit(*_brute.brute_plain(scene.tri_pack, o, d, t_max, meta.n_tris, t_min))


def intersect(scene: CompiledScene, meta: SceneMeta, o, d, t_max, t_min: float = 1e-3, nee: bool = False) -> Hit:
    """Dispatch (render/intersect.py:937): B1 up to 4096 triangles, the
    block trace (B2 + B3) above."""
    check_supported(meta, nee)
    if meta.n_tris <= _brute.MAX_TRIS:
        return _hit(*_brute.brute_intersect(scene.tri_pack, o, d, t_max, meta.n_tris, t_min))
    t, u, v, back, tri, _, _ = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, t_min, nee)
    return _hit(t, u, v, back, tri)
