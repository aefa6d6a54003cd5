"""Host-side binned-SAH BVH build over world-space triangles.

Port of `yart_tpu/scene/bvh.py` `build_bvh`, `build_bvh_boxes` and
`_sah_split` (the reference's binned SAH, src/core/bvh.hpp:41-348), and
`collapse_bvh8` / `encode_leaf8` (:237-331): numpy only, and the same
arithmetic, so the tree, the triangle permutation and everything cut from
it (scene/clusters.py) equal the JAX package's numpy builder exactly. The
JAX builder prefers its native C++ build when that library is present; the
port has none and always runs this one.

The builder uses the triangle tree for the leaf-order triangle permutation
and the cluster cut, and packs it and its 8-wide collapse for the stack
traversals (render/stacktrace.py); the collapse also serves the coarse
tree over the clusters, which bin-trace walks (render/bintrace.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class HostBVH(NamedTuple):
    node_min: np.ndarray  # [N, 3] f32
    node_max: np.ndarray  # [N, 3] f32
    left: np.ndarray  # [N] i32 (inner: left child; leaf: first tri)
    count: np.ndarray  # [N] i32 (0 = inner)
    tri_order: np.ndarray  # [T] i32 permutation: tri_order[new] = old
    depth: int  # max tree depth


def build_bvh(v0, v1, v2, max_leaf: int = 4, n_bins: int = 20) -> HostBVH:
    """Build from triangle vertex positions [T, 3] each."""
    tri_lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tri_hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    cent = ((v0 + v1 + v2) / 3.0).astype(np.float32)
    return build_bvh_boxes(tri_lo, tri_hi, cent, max_leaf, n_bins)


def build_bvh_boxes(tri_lo, tri_hi, cent=None, max_leaf: int = 4, n_bins: int = 20) -> HostBVH:
    """Build over arbitrary primitive AABBs [T, 3] (triangles, and the
    clusters of scene/clusters.py)."""
    t = tri_lo.shape[0]
    if t == 0:
        raise ValueError("empty scene")
    if cent is None:
        cent = ((tri_lo + tri_hi) * 0.5).astype(np.float32)

    order = np.arange(t, dtype=np.int32)
    cap = max(1, 2 * t - 1)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    left = np.zeros(cap, np.int32)
    count = np.zeros(cap, np.int32)
    n_nodes = 1
    stack = [(0, 0, t, 1)]  # (node, first, span, depth)
    max_depth = 1

    while stack:
        node, first, span, depth = stack.pop()
        max_depth = max(max_depth, depth)
        # A copy: the partition below writes back into the same range.
        idx = order[first : first + span].copy()
        lo = tri_lo[idx]
        hi = tri_hi[idx]
        node_min[node] = lo.min(axis=0)
        node_max[node] = hi.max(axis=0)

        if span <= max_leaf:
            left[node] = first
            count[node] = span
            continue
        split = _sah_split(cent[idx], lo, hi, n_bins, span)
        if split is None:
            # Degenerate (all centroids equal): median split (bvh.hpp:159-161).
            axis = int(np.argmax(node_max[node] - node_min[node]))
            key = np.argsort(cent[idx][:, axis], kind="stable")
            order[first : first + span] = idx[key]
            mid = span // 2
        else:
            axis, thresh = split
            mask = cent[idx][:, axis] < thresh
            mid = int(mask.sum())
            if mid == 0 or mid == span:
                key = np.argsort(cent[idx][:, axis], kind="stable")
                order[first : first + span] = idx[key]
                mid = span // 2
            else:
                order[first : first + mid] = idx[mask]
                order[first + mid : first + span] = idx[~mask]

        l_child = n_nodes
        n_nodes += 2
        left[node] = l_child
        count[node] = 0
        stack.append((l_child + 1, first + mid, span - mid, depth + 1))
        stack.append((l_child, first, mid, depth + 1))

    return HostBVH(node_min[:n_nodes], node_max[:n_nodes], left[:n_nodes], count[:n_nodes],
                   order, max_depth)


def _sah_split(cent, lo, hi, n_bins, span):
    """Binned SAH over all 3 axes (bvh.hpp:273-347). Returns (axis, thresh)
    or None when unsplittable or a leaf is cheaper than any split."""
    c_lo = cent.min(axis=0)
    c_hi = cent.max(axis=0)
    ext = c_hi - c_lo
    best = (np.inf, -1, 0.0)

    def area(a_lo, a_hi):
        d = np.maximum(a_hi - a_lo, 0.0)
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

    for axis in range(3):
        if ext[axis] <= 0.0:
            continue
        scale = n_bins / ext[axis]
        b = np.minimum(n_bins - 1, ((cent[:, axis] - c_lo[axis]) * scale).astype(np.int32))
        cnt = np.bincount(b, minlength=n_bins)
        blo = np.full((n_bins, 3), np.inf, np.float32)
        bhi = np.full((n_bins, 3), -np.inf, np.float32)
        np.minimum.at(blo, b, lo)
        np.maximum.at(bhi, b, hi)
        llo = np.minimum.accumulate(blo, axis=0)
        lhi = np.maximum.accumulate(bhi, axis=0)
        rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
        rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
        lcnt = np.cumsum(cnt)
        rcnt = span - lcnt
        # Split after bin i: left = bins [0..i], right = bins [i+1..].
        cost = area(llo[:-1], lhi[:-1]) * lcnt[:-1] + area(rlo[1:], rhi[1:]) * rcnt[:-1]
        cost = np.where((lcnt[:-1] == 0) | (rcnt[:-1] == 0), np.inf, cost)
        i = int(np.argmin(cost))
        if cost[i] < best[0]:
            best = (cost[i], axis, c_lo[axis] + (i + 1) / scale)

    if best[1] < 0:
        return None
    # Leaf-vs-split test (bvh.hpp:320-329).
    d = hi.max(axis=0) - lo.min(axis=0)
    parent_area = d[0] * d[1] + d[1] * d[2] + d[2] * d[0]
    if parent_area > 0.0 and best[0] / parent_area >= span:
        return None
    return best[1], best[2]


class HostBVH8(NamedTuple):
    """8-wide BVH collapsed from the binary SAH tree.

    boxes: [M, 8, 6] child AABBs (min3, max3); empty slots +inf/-inf
    child: [M, 8] int32 encoded refs: >= 0 inner node index, -1 empty,
           <= -2 leaf with v = -(child + 2), first = v >> 4, count = v & 15
    depth: wide-tree depth
    """

    boxes: np.ndarray
    child: np.ndarray
    depth: int


def encode_leaf8(first: int, count: int) -> int:
    assert count <= 15
    return -(((first << 4) | count) + 2)


def _wide_slots(hb: HostBVH, b: int, width: int, area) -> list:
    """The children of wide node `b`: starting from [b], greedily replace
    the inner slot of largest area by its two children until `width` slots
    or only leaves remain."""
    slots = [b]
    while len(slots) < width:
        inner = [i for i, s in enumerate(slots) if hb.count[s] == 0]
        if not inner:
            break
        best = max(inner, key=lambda i: area(slots[i]))
        s = slots.pop(best)
        slots.extend([int(hb.left[s]), int(hb.left[s]) + 1])
    return slots


def collapse_bvh8(hb: HostBVH, width: int = 8) -> HostBVH8:
    """Collapse the binary tree to `width` children per node (groups are
    numbered in the order of a depth-first walk with an explicit stack, as
    in the JAX package)."""

    def area(i):
        d = np.maximum(hb.node_max[i] - hb.node_min[i], 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    if hb.count[0] > 0:  # the binary root is itself a leaf
        boxes = np.zeros((1, width, 6), np.float32)
        boxes[:, :, 0:3] = np.inf
        boxes[:, :, 3:6] = -np.inf
        boxes[0, 0, 0:3] = hb.node_min[0]
        boxes[0, 0, 3:6] = hb.node_max[0]
        child = np.full((1, width), -1, np.int64)
        child[0, 0] = encode_leaf8(int(hb.left[0]), int(hb.count[0]))
        return HostBVH8(boxes, child.astype(np.int32), 1)

    group_of = {}
    order = []
    slots_of = []  # each group's slots, found once
    stack = [0]
    while stack:
        b = stack.pop()
        if b in group_of:
            continue
        group_of[b] = len(order)
        order.append(b)
        slots_of.append(_wide_slots(hb, b, width, area))
        stack.extend(s for s in slots_of[-1] if hb.count[s] == 0)

    m = len(order)
    boxes = np.zeros((m, width, 6), np.float32)
    boxes[:, :, 0:3] = np.inf
    boxes[:, :, 3:6] = -np.inf
    child = np.full((m, width), -1, np.int64)
    for gi, slots in enumerate(slots_of):
        for k, s in enumerate(slots):
            boxes[gi, k, 0:3] = hb.node_min[s]
            boxes[gi, k, 3:6] = hb.node_max[s]
            if hb.count[s] > 0:
                child[gi, k] = encode_leaf8(int(hb.left[s]), int(hb.count[s]))
            else:
                child[gi, k] = group_of[s]

    # Depth by levels from the root (group ids are not topologically sorted).
    depth = 1
    level = {0}
    seen = {0}
    while level:
        nxt = set()
        for g in level:
            for c in child[g]:
                if c >= 0 and c not in seen:
                    seen.add(int(c))
                    nxt.add(int(c))
        if nxt:
            depth += 1
        level = nxt
    return HostBVH8(boxes, child.astype(np.int32), depth)
