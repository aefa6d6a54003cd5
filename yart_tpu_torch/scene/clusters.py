"""Triangle clusters for the block-trace and bin-trace traversals.

Port of `yart_tpu/scene/clusters.py` `cut_clusters`, `build_coarse` and
`woop_rows` (:63-162), numpy only:

- `cut_clusters` cuts the binary SAH tree (scene/bvh.py) into maximal
  subtrees of at most C triangles. The SAH build partitions the triangle
  order in place, so every cluster is a contiguous (first, count) range of
  the leaf-ordered triangles.
- `build_coarse` builds a small SAH tree over the cluster boxes, permutes
  the clusters into its leaf order (so a coarse leaf names a contiguous
  cluster range) and collapses it to the 8-wide `wide_pack` that
  bin-trace's collect phase walks (render/bintrace.py).
- `woop_rows` packs per-triangle plane and barycentric constants per
  cluster, the [n_clus, 8, 3C] operand of the fused trace (kernel B3) and
  of the pair kernel (B4).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from yart_tpu_torch.scene.bvh import HostBVH, build_bvh_boxes, collapse_bvh8


class ClusterCut(NamedTuple):
    first: np.ndarray  # [n_clus] i32 first triangle (in BVH leaf order)
    count: np.ndarray  # [n_clus] i32 triangle count (<= max_cluster)
    lo: np.ndarray  # [n_clus, 3] f32 cluster AABB
    hi: np.ndarray  # [n_clus, 3] f32


def _subtree_spans(hb: HostBVH):
    """(first, span) per node. Children are created after their parent
    (scene/bvh.py), so a reverse sweep sees children before parents."""
    n = hb.left.shape[0]
    first = np.zeros(n, np.int64)
    span = np.zeros(n, np.int64)
    leaf = hb.count > 0
    first[leaf] = hb.left[leaf]
    span[leaf] = hb.count[leaf]
    for i in range(n - 1, -1, -1):
        if not leaf[i]:
            l = hb.left[i]
            first[i] = first[l]
            span[i] = span[l] + span[l + 1]
    return first, span


def cut_clusters(hb: HostBVH, max_cluster: int) -> ClusterCut:
    """Depth-first from the root, one cluster per maximal subtree of at most
    `max_cluster` triangles (near-first order keeps ids spatially coherent)."""
    first, span = _subtree_spans(hb)
    out_first, out_count, out_lo, out_hi = [], [], [], []
    stack = [0]
    while stack:
        i = stack.pop()
        if span[i] <= max_cluster or hb.count[i] > 0:
            out_first.append(first[i])
            out_count.append(span[i])
            out_lo.append(hb.node_min[i])
            out_hi.append(hb.node_max[i])
        else:
            l = int(hb.left[i])
            stack.append(l + 1)
            stack.append(l)
    return ClusterCut(
        np.asarray(out_first, np.int32),
        np.asarray(out_count, np.int32),
        np.stack(out_lo).astype(np.float32),
        np.stack(out_hi).astype(np.float32),
    )


class CoarseTree(NamedTuple):
    wide_pack: np.ndarray  # [G, 56] f32: 8 x (min3, max3) + 8 child refs as int32 bits
    depth: int  # wide-tree depth (collect's stack holds depth + 2 entries)
    max_leaf: int  # most clusters in one coarse leaf
    cut: ClusterCut  # the clusters, permuted into coarse leaf order


def build_coarse(cut: ClusterCut, max_leaf: int = 2, n_bins: int = 20) -> CoarseTree:
    """The coarse BVH8 over the cluster boxes; its leaves reference
    contiguous cluster ranges (leaf payload (first cluster, count))."""
    hb = build_bvh_boxes(cut.lo, cut.hi, max_leaf=max_leaf, n_bins=n_bins)
    perm = hb.tri_order
    cut = ClusterCut(cut.first[perm], cut.count[perm], cut.lo[perm], cut.hi[perm])
    hb8 = collapse_bvh8(hb)
    bits = lambda a: np.ascontiguousarray(a, np.int32).view(np.float32)
    wide_pack = np.concatenate(
        [hb8.boxes.reshape(-1, 48), bits(hb8.child).reshape(-1, 8)], axis=1
    ).astype(np.float32)
    return CoarseTree(wide_pack, hb8.depth, int(hb.count.max()), cut)


def woop_rows(v0, v1, v2, cut: ClusterCut, c: int) -> np.ndarray:
    """Per-triangle plane + barycentric constants, packed per cluster.

    For a triangle (p0, e1 = p1 - p0, e2 = p2 - p0):
        n  = e1 x e2,                                cn = n . p0
        eu = (|e2|^2 e1 - (e1.e2) e2) / gram,        cu = eu . p0
        ev = (|e1|^2 e2 - (e1.e2) e1) / gram,        cv = ev . p0
    so that for a ray (o, d): t = (cn - n.o) / n.d, u = eu.o + t (eu.d) - cu,
    v likewise, and back = n.d > 0.

    Returns [n_clus, 8, 3C] f32: rows 0-2 hold the x/y/z components of
    [n | eu | ev] over the column blocks [0:C | C:2C | 2C:3C]; row 3 holds
    (cn | cu | cv); row 4 lane 0 the cluster's first-triangle id (int32
    bits); rows 5-7 are zero. Padding columns (count < C) are all zero, so
    n.d == 0 rejects them like degenerate triangles.
    """
    n_clus = cut.first.shape[0]
    e1 = (v1 - v0).astype(np.float64)
    e2 = (v2 - v0).astype(np.float64)
    n = np.cross(e1, e2)
    a = np.einsum("ij,ij->i", e1, e1)
    b = np.einsum("ij,ij->i", e1, e2)
    cc = np.einsum("ij,ij->i", e2, e2)
    gram = a * cc - b * b
    ok = gram > 1e-30
    inv = np.where(ok, 1.0 / np.where(ok, gram, 1.0), 0.0)
    eu = (cc[:, None] * e1 - b[:, None] * e2) * inv[:, None]
    ev = (a[:, None] * e2 - b[:, None] * e1) * inv[:, None]
    n = np.where(ok[:, None], n, 0.0)
    cn = np.einsum("ij,ij->i", n, v0.astype(np.float64))
    cu = np.einsum("ij,ij->i", eu, v0.astype(np.float64))
    cv = np.einsum("ij,ij->i", ev, v0.astype(np.float64))

    pack = np.zeros((n_clus, 8, 3 * c), np.float32)
    for ci in range(n_clus):
        f, cnt = int(cut.first[ci]), int(cut.count[ci])
        sl = slice(f, f + cnt)
        pack[ci, 0:3, 0:cnt] = n[sl].T
        pack[ci, 0:3, c : c + cnt] = eu[sl].T
        pack[ci, 0:3, 2 * c : 2 * c + cnt] = ev[sl].T
        pack[ci, 3, 0:cnt] = cn[sl]
        pack[ci, 3, c : c + cnt] = cu[sl]
        pack[ci, 3, 2 * c : 2 * c + cnt] = cv[sl]
        pack[ci, 4, 0] = np.int32(f).view(np.float32)
    return pack
