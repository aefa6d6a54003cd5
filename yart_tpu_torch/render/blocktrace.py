"""Block-trace: presorted block traversal for big scenes.

Port of `yart_tpu/render/blocktrace.py` `intersect_blocktrace`, fused path
only (:217-349), for ungated, non-instanced scenes:

1. the rays become one [N, 8] matrix (o, d, t_max, floor), padded to whole
   128-ray blocks with rows at t_max = -1;
2. the presort (kernel B2, kernels/presort.py) gives every ray its sort
   keys and its 4 nearest entered clusters;
3. a stable sort on (primary key << 32 | secondary key) groups rays that
   enter the same clusters, with rays that enter nothing last; blocks whose
   rays all enter nothing get `blive` = 0. This is scheduling only: a
   ray's result does not depend on the order;
4. one row gather in, the fused trace (kernel B3, kernels/fusedtrace.py),
   and one row scatter back to lane order.

CUDA tensors run the kernels, CPU tensors their plain twins. The gated
re-cast loop (`intersect_blocktrace_gated`) needs textures and waits for
the atrium slice (ROADMAP.md A.6).
"""

from __future__ import annotations

import torch

from yart_tpu_torch.kernels import fusedtrace as _ft
from yart_tpu_torch.kernels import presort as _ps

BLOCK = _ft.BLOCK
MAX_CLUSTERS = _ps.MAX_CLUSTERS


def cluster_counts(scene) -> torch.Tensor:
    """Triangles per cluster [n_clus] int32: the clusters are contiguous
    ranges of the leaf-ordered triangles, so each ends where the next
    higher first triangle (or the last triangle) begins."""
    first = scene.clus_first.long()
    start, idx = torch.sort(first)
    n_tris = scene.tri_pack.shape[0]
    end = torch.cat([start[1:], torch.full((1,), n_tris, dtype=torch.long, device=first.device)])
    counts = torch.empty_like(first)
    counts[idx] = end - start
    return counts.to(torch.int32)


def ray_matrix(o, d, t_max, floor=None) -> torch.Tensor:
    """The [Np, 8] ray matrix (o, d, t_max, floor) of o, d [N, 3], padded
    to whole 128-ray blocks with rows at t_max = -1."""
    n = o.shape[0]
    dev = o.device
    t_max_v = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n,))
    floor_v = (torch.zeros(n, dtype=torch.float32, device=dev) if floor is None
               else torch.broadcast_to(torch.as_tensor(floor, dtype=torch.float32, device=dev), (n,)))
    rays = torch.cat([o, d, t_max_v[:, None], floor_v[:, None]], dim=1)
    pad = (-n) % BLOCK
    if pad:
        pad_rows = torch.zeros((pad, 8), dtype=torch.float32, device=dev)
        pad_rows[:, 6] = -1.0
        rays = torch.cat([rays, pad_rows], dim=0)
    return rays.contiguous()


def schedule(pk: torch.Tensor):
    """From B2's rows: the stable two-key sort order of the rays and the
    per-block `blive` flags (1 where a ray of the block enters a cluster)."""
    key = (pk[:, 0].long() << 32) | pk[:, 6].long()
    key_s, order = torch.sort(key, stable=True)
    blive = ((key_s >> 32) < _ps.SKEY_NOTHING).view(-1, BLOCK).any(dim=1).to(torch.int32)
    return order, blive


def intersect_blocktrace(scene, meta, o, d, t_max, t_min: float = 1e-3, nee: bool = False,
                         floor=None):
    """Closest hit (or, with `nee`, any hit) of rays o, d [N, 3] with t_max
    [N] (or a scalar) through B2 + B3. `floor` [N] optionally restricts hits
    to t > floor. Returns the raw per-ray columns
    (t, u, v, back, tri, clusters tested, triangles tested) in lane order."""
    n = o.shape[0]
    rays = ray_matrix(o, d, t_max, floor)
    pk = _ps.presort_keys(rays, scene.clus_box, meta.n_clusters, t_min)
    order, blive = schedule(pk)
    out_s = _ft.fused_trace(
        rays[order], pk[order, 1 : 1 + _ps.N_SLOTS].contiguous(), scene.clus_box,
        scene.clus_pack, cluster_counts(scene), blive, t_min, nee,
    )
    out = torch.empty_like(out_s)
    out[order] = out_s
    out = out[:n]
    return (out[:, 0], out[:, 1], out[:, 2], out[:, 3] > 0.5,
            out[:, 4].contiguous().view(torch.int32), out[:, 5], out[:, 6])
