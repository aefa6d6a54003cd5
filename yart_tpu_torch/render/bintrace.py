"""Bin-trace: two-phase intersection for ungated scenes past the block
trace's cluster cap.

Port of `yart_tpu/render/bintrace.py` (`collect_clusters` :81-223,
`pairs_phase` :230-311, `intersect_bintrace` :329-394):

  phase 1  `collect_clusters` walks the coarse BVH8 over the triangle
           clusters (`scene.coarse_pack`, scene/clusters.py) and collects
           per ray the ids of up to K clusters whose boxes it enters.
  phase 2  `pairs_phase` sorts the (ray, cluster) pairs by cluster, one
           row a pair, cuts each cluster's rows into tiles of up to 256,
           tests every tile against its cluster's triangles (kernel B4,
           kernels/clusterpairs.py) and keeps each ray's closest hit.

Rounds and the continuation window (the JAX module's docstring has the
argument): round r collects only clusters with (entry, id) >=lex the ray's
window; clusters that did not fit leave bound = the lexmin of the dropped
ones. A ray is done when its hit t <= bound.e or nothing was dropped;
otherwise the next round's window is the bound, and slot 0 is reserved for
the cluster with id == bound.id, so the window advances every round.

Phase 1 is XLA in the JAX package, not Pallas, and stays plain PyTorch
here, on every device: a host loop of lockstep iterations in which an
inactive lane changes nothing. It tests `any(active)` on the host every
CHECK_EVERY iterations only, and then moves the still-active lanes into a
smaller working set when fewer than half remain; lanes are independent, so
neither changes a result as long as the iterations stay within the JAX
loop's cap, `max_iters = G * 9 + 64`. Phase 2's layout is plain PyTorch
too; it lays out only the live pairs, one row each (the JAX code pads each
cluster to blocks of 1024 rows and the blocks to a static upper bound,
which changes no pair's result).

`COUNTS` records rounds per call and collect iterations per round (host
counters; the iteration count rounds up to CHECK_EVERY).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from yart_tpu_torch.kernels import clusterpairs as _cp
from yart_tpu_torch.render.blocktrace import cluster_counts
from yart_tpu_torch.render.hit import Hit

# Python values, never module-level tensors (they would fix a device at
# import).
F32_MAX = _cp.F32_MAX
_BIG = F32_MAX  # no dropped candidate (np.float32(3e38) in the JAX module)
_NOID = 1 << 30
CHECK_EVERY = 8  # collect iterations between host checks of any(active)
MAX_ROUNDS = 64  # the JAX function's default `max_rounds`

# Batcher odd-even mergesort network for 8 elements (19 compare-exchanges).
_SORT8 = [
    (0, 1), (2, 3), (4, 5), (6, 7),
    (0, 2), (1, 3), (4, 6), (5, 7),
    (1, 2), (5, 6),
    (0, 4), (1, 5), (2, 6), (3, 7),
    (2, 4), (3, 5),
    (1, 2), (3, 4), (5, 6),
]
# The network's six stages, each a set of disjoint pairs (i, j), as views
# (the i columns, the j columns) of an [m, 8] tensor, so a stage is one
# vectorised compare-exchange.
_SORT8_STAGES = [
    lambda a: (a[:, 0::2], a[:, 1::2]),  # (0,1) (2,3) (4,5) (6,7)
    lambda a: (a.view(-1, 2, 4)[:, :, 0:2], a.view(-1, 2, 4)[:, :, 2:4]),  # (0,2) (1,3) (4,6) (5,7)
    lambda a: (a.view(-1, 2, 4)[:, :, 1], a.view(-1, 2, 4)[:, :, 2]),  # (1,2) (5,6)
    lambda a: (a[:, 0:4], a[:, 4:8]),  # (0,4) (1,5) (2,6) (3,7)
    lambda a: (a[:, 2:4], a[:, 4:6]),  # (2,4) (3,5)
    lambda a: (a[:, 1:7:2], a[:, 2:8:2]),  # (1,2) (3,4) (5,6)
]


@dataclasses.dataclass
class BintraceCounts:
    """Bin-trace calls, their rounds, and collect iterations per round."""

    calls: int = 0
    rounds: int = 0
    iters: list = dataclasses.field(default_factory=list)

    def reset(self) -> None:
        self.calls = 0
        self.rounds = 0
        self.iters = []


COUNTS = BintraceCounts()
# Profiler ranges around the two phases (read by profile_render).
RANGES = ("bintrace.collect", "bintrace.pairs")


def collect_clusters(scene, meta, o, d, t_cur, t_min, w_e, w_id, active, k):
    """Phase 1: one collection pass. Returns (slots [N, K] int32, n_col,
    bound_e, bound_id). A candidate is a cluster whose box the ray enters
    before t_cur, with (entry, id) >=lex (w_e, w_id).

    Per lane the state is (group, cursor), the cursor indexing the group's
    children sorted by entry distance, and a stack of packed (group << 3 |
    cursor) words, one per level. Each iteration fetches the group's row,
    tests and sorts its 8 children (the Batcher network, whose order of
    tied entries the slots follow) and visits sorted child #cursor: a leaf
    adds its clusters, an inner child is descended into (pushing the next
    cursor), and an exhausted group pops."""
    n = o.shape[0]
    dev = o.device
    width = 8
    stack_depth = meta.coarse_depth + 2
    max_iters = int(scene.coarse_pack.shape[0]) * (width + 1) + 64
    coarse = scene.coarse_pack
    enc_all = coarse[:, 48:56].contiguous().view(torch.int32)  # [G, 8]
    boxes_all = coarse[:, :48].reshape(-1, width, 6)

    tiny = torch.where(d < 0, -1e-20, 1e-20)
    idir = 1.0 / torch.where(d.abs() < 1e-20, tiny, d)
    odir = -o * idir
    has_window = w_id >= 0

    # Results for every lane; the working set (lanes `ws`) carries the rest.
    slots_out = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    n_col_out = has_window.to(torch.int32)
    bound_e_out = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    bound_id_out = torch.full((n,), _NOID, dtype=torch.int32, device=dev)
    ws = torch.nonzero(active & (t_cur > t_min))[:, 0]
    m = ws.numel()
    st = {
        "idir": idir[ws], "odir": odir[ws], "t_cur": t_cur[ws], "w_e": w_e[ws], "w_id": w_id[ws],
        "group": torch.zeros(m, dtype=torch.int32, device=dev),
        "cursor": torch.zeros(m, dtype=torch.int32, device=dev),
        "sp": torch.zeros(m, dtype=torch.int32, device=dev),
        "stack": torch.zeros((m, stack_depth), dtype=torch.int32, device=dev),
        "slots": slots_out[ws], "n_col": n_col_out[ws], "bound_e": bound_e_out[ws],
        "bound_id": bound_id_out[ws], "active": torch.ones(m, dtype=torch.bool, device=dev),
    }

    def write_back():
        slots_out[ws] = st["slots"]
        n_col_out[ws] = st["n_col"]
        bound_e_out[ws] = st["bound_e"]
        bound_id_out[ws] = st["bound_id"]

    it = 0
    while it < max_iters:
        if it % CHECK_EVERY == 0:
            n_act = int(st["active"].sum())
            if n_act == 0:
                break
            if n_act * 2 <= ws.numel():  # shrink the working set to the active lanes
                write_back()
                keep = torch.nonzero(st["active"])[:, 0]
                ws = ws[keep]
                st = {name: a[keep] for name, a in st.items()}
        _collect_step(st, boxes_all, enc_all, meta.coarse_max_leaf, k, stack_depth, t_min)
        it += 1
    write_back()
    COUNTS.iters.append(it)
    return slots_out, n_col_out, bound_e_out, bound_id_out


def sort8(dist, enc):
    """Sort the rows of dist [m, 8] in place with Batcher's network, moving
    enc [m, 8] along: `_SORT8`'s compare-exchanges (swap where dist[i] >
    dist[j]), whose order of ties the collected slots follow, one stage at a
    time."""
    for view in _SORT8_STAGES:
        di, dj = view(dist)
        ei, ej = view(enc)
        swap = di > dj
        new = (torch.where(swap, dj, di), torch.where(swap, di, dj),
               torch.where(swap, ej, ei), torch.where(swap, ei, ej))
        for dst, src in zip((di, dj, ei, ej), new):
            dst.copy_(src)


def _collect_step(st, boxes_all, enc_all, max_leaf, k, stack_depth, t_min):
    """One lockstep iteration of the JAX loop's `body` on the working set
    (updates `st` in place)."""
    active, cursor, group = st["active"], st["cursor"], st["group"]
    w_e, w_id = st["w_e"], st["w_id"]
    g = group.clamp(min=0).long()
    boxes = boxes_all[g]  # [m, 8, 6]
    enc8 = enc_all[g]  # [m, 8]
    idir, odir = st["idir"][:, None, :], st["odir"][:, None, :]
    lo = boxes[..., 0:3] * idir + odir
    hi = boxes[..., 3:6] * idir + odir
    tlo = torch.minimum(lo, hi)
    thi = torch.maximum(lo, hi)
    c0 = torch.clamp(tlo.amax(dim=-1), min=t_min)  # [m, 8]
    c1r = thi.amin(dim=-1)
    c1 = torch.minimum(c1r, st["t_cur"][:, None])
    # Window prune: a child that exits before w_e holds only clusters whose
    # entry is < w_e, all ineligible this round.
    chit = (c1 >= c0) & (c1r >= w_e[:, None]) & (enc8 != -1)
    dist8 = torch.where(chit, c0, F32_MAX)
    n_hit = chit.sum(dim=-1, dtype=torch.int32)
    sort8(dist8, enc8)

    cur = cursor.clamp(max=7).long()[:, None]  # a cursor of 8 only pops
    child = enc8.gather(1, cur)[:, 0]
    entry = dist8.gather(1, cur)[:, 0]
    has_child = active & (cursor < n_hit)
    is_leaf = has_child & (child <= -2)
    is_inner = has_child & (child >= 0)

    # Leaf child: up to max_leaf cluster candidates.
    vdec = -(child + 2)
    first = torch.where(is_leaf, vdec >> 4, 0)
    count = torch.where(is_leaf, vdec & 15, 0)
    slots, n_col, bound_e, bound_id = st["slots"], st["n_col"], st["bound_e"], st["bound_id"]
    for j in range(max_leaf):
        cid = first + j
        elig = is_leaf & (j < count) & ((entry > w_e) | ((entry == w_e) & (cid >= w_id)))
        is_win = elig & (cid == w_id)
        can = elig & (is_win | (n_col < k))
        slot = torch.where(is_win, 0, n_col.clamp(max=k - 1)).long()[:, None]
        # Masked write without a host sync: rewrite the old value where not `can`.
        slots.scatter_(1, slot, torch.where(can[:, None], cid[:, None], slots.gather(1, slot)))
        n_col = n_col + (can & ~is_win).to(torch.int32)
        dropped = elig & ~can
        better = dropped & ((entry < bound_e) | ((entry == bound_e) & (cid < bound_id)))
        bound_e = torch.where(better, entry, bound_e)
        bound_id = torch.where(better, cid, bound_id)

    # Advance: an inner child pushes (group, cursor + 1) and is descended
    # into; a leaf child advances the cursor; an exhausted group pops.
    stack, sp = st["stack"], st["sp"]
    push = is_inner & (cursor + 1 < n_hit)
    packed = (group << 3) | (cursor + 1).clamp(max=7)
    top = sp.clamp(max=stack_depth - 1).long()[:, None]
    stack.scatter_(1, top, torch.where(push[:, None], packed[:, None], stack.gather(1, top)))
    sp = sp + push.to(torch.int32)
    need_pop = active & ~has_child
    can_pop = sp > 0
    pop = need_pop & can_pop
    sp_post = torch.where(pop, sp - 1, sp)
    popped = stack.gather(1, sp_post.clamp(0, stack_depth - 1).long()[:, None])[:, 0]
    st["group"] = torch.where(is_inner, child, torch.where(pop, popped >> 3, group))
    st["cursor"] = torch.where(
        is_inner, 0, torch.where(pop, popped & 7, torch.where(is_leaf, cursor + 1, cursor)))
    st["sp"] = sp_post
    st["active"] = active & ~(need_pop & ~can_pop)
    st["n_col"], st["bound_e"], st["bound_id"] = n_col, bound_e, bound_id


class PairLayout(NamedTuple):
    """Phase 2's layout of one round's live pairs (B4's inputs): one row a
    live pair, sorted by cluster and stably by (ray, slot) within one, cut
    into tiles of at most TILE rows that share a cluster. No row is
    padding."""

    x: torch.Tensor  # [L, 8] pair rows: o3, d3, tmax, 0
    tiles: torch.Tensor  # [n_tiles, 4] int32: cluster, its first triangle, first row, row count
    pair: torch.Tensor  # [L] each row's flat (ray, slot) index


def tile_table(cid_sorted, clus_first, tile: int):
    """[n_tiles, 4] int32 (cluster, first triangle, first row, count) for
    pair rows sorted by cluster id `cid_sorted` [L]: each cluster's run of
    rows in tiles of `tile`, its last tile partial, covering the rows in
    order."""
    dev = cid_sorted.device
    if cid_sorted.numel() == 0:
        return torch.zeros((0, 4), dtype=torch.int32, device=dev)
    cids, cnt = torch.unique_consecutive(cid_sorted, return_counts=True)
    start = torch.cumsum(cnt, 0) - cnt
    per = (cnt + tile - 1) // tile
    n_tiles = int(per.sum())
    run = torch.repeat_interleave(torch.arange(cids.numel(), device=dev), per, output_size=n_tiles)
    j = torch.arange(n_tiles, device=dev) - (torch.cumsum(per, 0) - per)[run]
    cid = cids[run].long()
    return torch.stack([cid, clus_first[cid].long(), start[run] + j * tile,
                        torch.clamp(cnt[run] - j * tile, max=tile)], dim=1).to(torch.int32)


def pair_layout(scene, meta, slots, n_col, o, d, t_cur) -> PairLayout:
    """Sort the live (ray, slot) pairs by cluster (stably, so a cluster's
    pairs keep ascending (ray, slot) order), one row each, and cut each
    cluster's rows into tiles of TILE (`tile_table`). The JAX code pads
    every cluster to blocks of 1024 rows and their count to a static upper
    bound instead; that changes no pair's result."""
    n, k = slots.shape
    dev = slots.device
    pair_cid = slots.reshape(-1)
    slot_j = torch.arange(k, dtype=torch.int32, device=dev).repeat(n)
    live = (slot_j < n_col.repeat_interleave(k)) & (pair_cid >= 0)
    pair = torch.nonzero(live)[:, 0]  # ascending (ray, slot)
    cid_s, order = torch.sort(pair_cid[pair], stable=True)
    pair = pair[order]
    ray = pair // k
    x = torch.cat([o[ray], d[ray], t_cur[ray, None], torch.zeros_like(t_cur[ray, None])], dim=1)
    return PairLayout(x, tile_table(cid_s, scene.clus_first, _cp.TILE), pair)


def pairs_phase(scene, meta, slots, n_col, o, d, t_cur, t_min, clus_count):
    """Phase 2: lay the live pairs out (`pair_layout`), test them (B4, each
    against its cluster's clus_count triangles), and reduce per ray.
    Returns (t, u, v, back, tri, got) per ray, with t == t_cur and tri ==
    -1 where this round found nothing closer."""
    n, k = slots.shape
    dev = slots.device
    lay = pair_layout(scene, meta, slots, n_col, o, d, t_cur)
    if lay.pair.numel() == 0:
        none = torch.zeros(n, dtype=torch.bool, device=dev)
        return (t_cur, torch.zeros_like(t_cur), torch.zeros_like(t_cur), none,
                torch.full((n,), -1, dtype=torch.int32, device=dev), none)
    t_p, u_p, v_p, back_p, tri_p = _cp.cluster_pairs(scene.clus_pack, clus_count, lay.tiles, lay.x,
                                                      meta.cluster_size, t_min)

    def back_to_slots(a, fill):
        out = torch.full((n * k,), fill, dtype=a.dtype, device=dev)
        out[lay.pair] = a
        return out.view(n, k)

    rt = back_to_slots(t_p, F32_MAX)
    best = torch.argmin(rt, dim=1, keepdim=True)  # the first minimum, as jnp.argmin
    take = lambda a: a.gather(1, best)[:, 0]
    bt = take(rt)
    got = bt < t_cur
    return (
        torch.where(got, bt, t_cur),
        take(back_to_slots(u_p, 0.0)),
        take(back_to_slots(v_p, 0.0)),
        take(back_to_slots(back_p, False)),
        torch.where(got, take(back_to_slots(tri_p, -1)), -1),
        got,
    )


def intersect_bintrace(scene, meta, o, d, t_max, t_min: float = 1e-3, nee: bool = False,
                       k: int = 0):
    """Closest hit (or, with `nee`, any hit) of every ray through bin-trace
    rounds; ungated scenes only. Returns a render.hit.Hit whose
    attenuation is ones."""
    n = o.shape[0]
    dev = o.device
    if k <= 0:
        k = meta.bintrace_k
    t = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n,)).clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    back = torch.zeros(n, dtype=torch.bool, device=dev)
    any_hit = torch.zeros(n, dtype=torch.bool, device=dev)
    w_e = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    w_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    done = t <= t_min
    clus_count = cluster_counts(scene, meta)
    rnd = 0
    COUNTS.calls += 1
    while rnd < MAX_ROUNDS and bool((~done).any()):
        with torch.profiler.record_function(RANGES[0]):
            slots, n_col, bound_e, bound_id = collect_clusters(scene, meta, o, d, t, t_min, w_e, w_id, ~done, k)
        with torch.profiler.record_function(RANGES[1]):
            t2, u2, v2, b2, tri2, got = pairs_phase(scene, meta, slots, n_col, o, d, t, t_min, clus_count)
        upd = got & ~done
        t = torch.where(upd, t2, t)
        tri = torch.where(upd, tri2, tri)
        u = torch.where(upd, u2, u)
        v = torch.where(upd, v2, v)
        back = torch.where(upd, b2, back)
        any_hit = any_hit | upd
        done = done | (bound_e >= _BIG) | (t <= bound_e)
        if nee:
            done = done | any_hit
        w_e, w_id = bound_e, bound_id
        rnd += 1
    COUNTS.rounds += rnd
    return Hit(t, tri, u, v, back, torch.ones((n, 3), dtype=torch.float32, device=dev), any_hit)
