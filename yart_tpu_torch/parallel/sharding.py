"""A rank's share of a chunk and the collectives of a multi-rank render.

Port of `yart_tpu/parallel/sharding.py`. The JAX package shards a chunk's
lanes over a mesh and lets XLA insert the collectives; here each rank
renders its part of every chunk on its own device with the replicated
scene, and the ranks exchange only:
- the chunk's estimates, all-gathered into the chunk's pixel order
  (`gather_rows`: every part padded to one size, the pad trimmed);
- the ray and live-lane counters, summed (`sum_ranks`);
- a replicated parameter's gradient, summed (`all_reduce_grads`, the
  psum XLA inserts for the JAX package, tests/multihost_worker.py:58-98).
Parts are multiples of PART_ALIGN pixels, so a lane's offset in its
rank's tensors is its offset in the whole chunk's modulo any vector width:
on the CPU a few operations (pow, atan2) round the last, partial vector of
a tensor apart from full vectors, and a part boundary never creates one.
With gloo, collectives on CUDA tensors run on host copies.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

PART_ALIGN = 128  # pixels; a part of a chunk is a whole number of these


def part_size(n: int, world: int) -> int:
    """Pixels in every rank's part of an n-pixel chunk but the last
    non-empty one's: n / world rounded up to PART_ALIGN (n itself for one
    rank)."""
    if world <= 1:
        return n
    per = -(-n // world)
    return -(-per // PART_ALIGN) * PART_ALIGN


def rank_part(n: int, world: int, rank: int) -> tuple[int, int]:
    """[start, end) of `rank`'s pixels in an n-pixel chunk: consecutive
    parts of `part_size` pixels; the last non-empty part may be shorter
    and ranks after it get none."""
    per = part_size(n, world)
    start = min(rank * per, n)
    return start, min(start + per, n)


def _on_host(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


def gather_rows(part: torch.Tensor, n: int) -> torch.Tensor:
    """The [n, ...] rows of a chunk from every rank's `part` (its rows of
    `rank_part`), in chunk order, on every rank."""
    world = dist.get_world_size()
    per = part_size(n, world)
    buf = part.new_zeros((per,) + tuple(part.shape[1:]))
    buf[: part.shape[0]] = part
    host = _on_host(buf)
    if host:
        buf = buf.cpu()
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf)
    # Every part before the last non-empty one is full, so the padded
    # parts laid end to end hold the chunk's rows first.
    out = torch.cat(parts)[:n]
    return out.to(part.device) if host else out


def sum_ranks(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks (a new tensor, on t's device)."""
    host = _on_host(t)
    out = t.detach().cpu().clone() if host else t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out.to(t.device) if host else out


def any_rank(flag: bool, device) -> bool:
    """True on every rank when `flag` is true on any rank."""
    t = torch.tensor([1.0 if flag else 0.0], dtype=torch.float32, device=device)
    return bool(sum_ranks(t).item() > 0)


def all_reduce_grads(tensors):
    """Sum each tensor (a replicated parameter's gradient from this rank's
    lanes) over the ranks, in place; returns them. None entries are
    skipped."""
    for t in tensors:
        if t is not None:
            t.copy_(sum_ranks(t))
    return tensors
