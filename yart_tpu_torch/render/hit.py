"""The hit record and the ray-order key that every traversal shares.

Port of `yart_tpu/render/intersect.py` `Hit` and `_coherence_key`
(:584-612). The traversals (render/blocktrace.py, render/bintrace.py,
render/stacktrace.py) return a `Hit` and sort their lanes by
`coherence_key`; the dispatcher (render/intersect.py) sits above them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Hit(NamedTuple):
    """SoA hit record (src/cpu/hit.hpp:8-17). All [N]-leading."""

    t: torch.Tensor  # hit distance; t_max on a miss
    tri: torch.Tensor  # int32 triangle index, -1 on a miss
    u: torch.Tensor  # barycentric u
    v: torch.Tensor  # barycentric v
    back_side: torch.Tensor  # bool
    attenuation: torch.Tensor  # [N, 3] NEE transparent-shadow throughput; ones elsewhere
    mask: torch.Tensor  # bool, True = real hit


def part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int64 x with two zero bits between each
    (the Morton helper `_part1by2`)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def coherence_key(scene, o, d) -> torch.Tensor:
    """Per-ray sort key [N] int64 of 24 bits (`_coherence_key`): the
    direction octant, then the Morton code of the origin's cell in a 128^3
    grid over the scene's bounding sphere box."""
    octant = (d[:, 0] < 0).long() | ((d[:, 1] < 0).long() << 1) | ((d[:, 2] < 0).long() << 2)
    lo = scene.scene_center - scene.scene_radius
    inv = 1.0 / torch.clamp_min(2.0 * scene.scene_radius, 1e-20)
    cell = (torch.clamp((o - lo) * inv, 0.0, 1.0) * 127.0).long()
    morton = part1by2(cell[:, 0]) | (part1by2(cell[:, 1]) << 1) | (part1by2(cell[:, 2]) << 2)
    return (octant << 21) | morton
