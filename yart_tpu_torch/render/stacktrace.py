"""Stack traversals: gated scenes past the block trace's cluster cap.

Port of `yart_tpu/render/intersect.py` `_closest_in_leaf` (:82-223),
`_slab_test` (:226), `intersect_bvh` (:392-550, the binary tree; the JAX
tests' oracle), `intersect_bvh8` (:617-783) and `intersect_bvh_sorted`
(:786-868). Each lane walks the triangle BVH (`scene.node_pack`, or its
8-wide collapse `scene.wide_pack`) near-first with a stack of its own:
pop a node, skip it if its entry lies beyond the lane's hit, test a leaf's
`max_leaf` triangles at once (Moller-Trumbore, then the per-hit gates of
`blocktrace.hit_gates`: the stochastic alpha test, and for shadow rays the
transparent surfaces, whose factors multiply into the attenuation), or
test an inner node's children and descend into the nearest, pushing the
others far first. Shadow rays (`nee`) stop at their first confirmed hit.

The JAX loops are XLA, not Pallas, and stay plain PyTorch here on every
device, run as bin-trace's collect loop is (render/bintrace.py): a host
loop of lockstep iterations in which an inactive lane changes nothing. It
reads `any(active)` every CHECK_EVERY iterations only, and then moves the
lanes still active into a smaller working set once half have finished,
writing each leaving lane's results back. Lanes are independent, so
neither changes a result as long as the iterations stay within the JAX
loop's cap (`max_iters`: node count + 64 for the binary tree, 2 x groups
+ 64 for the 8-wide one). The host reads only those counts.

Where the port departs from the JAX code, no lane's result changes, but
one:
- the children of an 8-wide node are ordered by a stable sort of their
  entry distances (`jnp.argsort` is stable: missed children tie at
  F32_MAX, boxes around the origin at t_min), and the child refs move with
  an integer gather. The JAX loop moves them through a float32 one-hot
  product, which rounds a leaf ref -(((first << 4) | count) + 2) once its
  magnitude passes 2^24, i.e. for leaves at triangle 2^20 and beyond; there
  the port reads the leaf the tree holds, and below it the two agree bit
  for bit (ROADMAP.md C);
- a push past the last of the 8-wide stack's `7 * wide_depth + 2` slots
  lands in one spare column that no pop reads (the JAX loop drops it);
- `intersect_bvh_sorted` runs the coherence-sorted lanes as one shrinking
  working set, where the JAX function maps `intersect_bvh8` over chunks of
  `chunk` lanes, padded: lane-exact either way, and no pad lanes.

`COUNTS` records calls, iterations per call and the working set at each
host check (host counters); each loop runs inside the profiler range
`RANGE` (read by profile_render).
"""

from __future__ import annotations

import dataclasses

import torch

from yart_tpu_torch.kernels import brute as _brute
from yart_tpu_torch.render import blocktrace
from yart_tpu_torch.render.hit import Hit, coherence_key

F32_MAX = 3.0e38
CHECK_EVERY = 8  # lockstep iterations between host checks of any(active)
_RESULTS = ("t", "tri", "u", "v", "back", "any_hit", "atten")
RANGE = "stacktrace.walk"


@dataclasses.dataclass
class StackCounts:
    """Traversal calls, their iterations, and the working set (lanes) at
    each host check of each call."""

    calls: int = 0
    iters: list = dataclasses.field(default_factory=list)
    sets: list = dataclasses.field(default_factory=list)

    def reset(self) -> None:
        self.calls = 0
        self.iters = []
        self.sets = []


COUNTS = StackCounts()


def slab_test(o_lo, o_hi, t_min: float, t_cur):
    """`_slab_test`: the boxes' per-axis entry and exit candidates [..., 3]
    -> (hit, entry), entry clamped below by t_min, exit above by t_cur."""
    t0 = torch.clamp(torch.minimum(o_lo, o_hi).amax(dim=-1), min=t_min)
    t1 = torch.minimum(torch.maximum(o_lo, o_hi).amin(dim=-1), t_cur)
    return t1 >= t0, t0


def closest_in_leaf(scene, meta, o, d, t_min: float, t_cur, first, n_valid, nee: bool, seed, atten):
    """`_closest_in_leaf`: per lane the `max_leaf` triangles from `first`,
    the first `n_valid` of them real. Returns (any valid, t, u, v, back,
    tri, atten) of the closest valid hit, the lowest offset among ties;
    t = t_cur where none is valid. The Moller-Trumbore arithmetic and the
    gates are the gated brute's (render/intersect.py), so both give a
    triangle the same bits and the same (lane seed, triangle) alpha draw."""
    offs = torch.arange(meta.max_leaf, dtype=torch.int32, device=o.device)
    ids = torch.clamp(first[:, None] + offs, 0, meta.n_tris - 1)
    rows = scene.tri_pack[ids.long()]  # [m, L, 12]
    p0 = rows[..., 0:3]
    e1 = rows[..., 3:6] - p0
    e2 = rows[..., 6:9] - p0
    det, u, v, t = _brute.mt_test(*(o[:, k : k + 1] for k in range(3)), *(d[:, k : k + 1] for k in range(3)),
                                  *(a[..., k] for a in (p0, e1, e2) for k in range(3)))
    valid = ((det.abs() >= _brute.EPS_DET) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > t_min) & (t < t_cur[:, None]) & (offs < n_valid[:, None]))
    if meta.any_alpha or (nee and meta.any_transparent):
        alpha_ok, transparent, factor = blocktrace.hit_gates(scene, meta, u, v, ids, d[:, None, :], nee,
                                                             seed[:, None])
        valid = valid & alpha_ok
        if nee and meta.any_transparent:
            factor = torch.where((valid & transparent)[..., None], factor, 1.0)
            for k in range(meta.max_leaf):  # in offset order, whatever the lane count
                atten = atten * factor[:, k]
            valid = valid & ~transparent
    j = torch.argmin(torch.where(valid, t, F32_MAX), dim=1, keepdim=True)
    take = lambda a: a.gather(1, j)[:, 0]
    got = valid.any(dim=1)
    return got, torch.where(got, take(t), t_cur), take(u), take(v), take(det) < 0.0, take(ids), atten


def sort_children(dist8, enc8):
    """A group's children near first: a stable sort of the entry distances
    dist8 [m, 8] (misses at F32_MAX), the child refs enc8 [m, 8] int32
    moved along by an integer gather. Returns (sorted dist8, sorted enc8)."""
    s_dist, order = torch.sort(dist8, dim=1, stable=True)
    return s_dist, enc8.gather(1, order)


def _lanes(o, d, t_max, alpha_seed):
    """The per-lane inputs and the initial results: t = t_max, no hit."""
    n, dev = o.shape[0], o.device
    t0 = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n,)).clone()
    seed = torch.zeros(n, dtype=torch.int64, device=dev) if alpha_seed is None else alpha_seed
    tiny = torch.where(d < 0, -1e-20, 1e-20)
    idir = 1.0 / torch.where(d.abs() < 1e-20, tiny, d)
    return dict(o=o, d=d, idir=idir, odir=-o * idir, seed=torch.broadcast_to(seed, (n,)), t=t0,
                tri=torch.full((n,), -1, dtype=torch.int32, device=dev),
                u=torch.zeros(n, dtype=torch.float32, device=dev),
                v=torch.zeros(n, dtype=torch.float32, device=dev),
                back=torch.zeros(n, dtype=torch.bool, device=dev),
                any_hit=torch.zeros(n, dtype=torch.bool, device=dev),
                atten=torch.ones((n, 3), dtype=torch.float32, device=dev))


def _walk(lanes: dict, step, max_iters: int, columns: int):
    """The host loop over `step(state)`, which advances every lane of the
    working set one iteration in place. `lanes` holds [n, ...] tensors, its
    `active` flags among them; the working set gets two [m, columns]
    stacks, node refs (int32) and their entry distances. Returns the
    results as a render.hit.Hit."""
    out = {k: lanes[k] for k in _RESULTS}
    ws = torch.nonzero(lanes["active"])[:, 0]
    st = {k: a[ws] for k, a in lanes.items()}
    m = ws.numel()
    st["snode"] = torch.zeros((m, columns), dtype=torch.int32, device=ws.device)
    st["sdist"] = torch.zeros((m, columns), dtype=torch.float32, device=ws.device)
    sets = []

    def write_back():
        for k in _RESULTS:
            out[k][ws] = st[k]

    it = 0
    with torch.profiler.record_function(RANGE):
        while it < max_iters:
            if it % CHECK_EVERY == 0:
                n_act = int(st["active"].sum())
                if n_act == 0:
                    break
                if n_act * 2 <= ws.numel():  # shrink the working set to the active lanes
                    write_back()
                    keep = torch.nonzero(st["active"])[:, 0]
                    ws = ws[keep]
                    st = {k: a[keep] for k, a in st.items()}
                sets.append(ws.numel())
            step(st)
            it += 1
        write_back()
    COUNTS.calls += 1
    COUNTS.iters.append(it)
    COUNTS.sets.append(sets)
    return Hit(out["t"], out["tri"], out["u"], out["v"], out["back"], out["atten"], out["any_hit"])


def _leaf_step(scene, meta, st, first, count, do_leaf, t_min, nee):
    """The leaf test of one iteration on the lanes `do_leaf`: updates their
    hits in `st`; returns the flags of a closer confirmed hit."""
    got, t2, u2, v2, b2, id2, st["atten"] = closest_in_leaf(
        scene, meta, st["o"], st["d"], t_min, st["t"], first, torch.where(do_leaf, count, 0), nee,
        st["seed"], st["atten"])
    upd = do_leaf & got
    for k, new in (("t", t2), ("tri", id2), ("u", u2), ("v", v2), ("back", b2)):
        st[k] = torch.where(upd, new, st[k])
    st["any_hit"] = st["any_hit"] | upd
    return upd


def intersect_bvh(scene, meta, o, d, t_max, t_min: float = 1e-3, nee: bool = False, alpha_seed=None,
                  max_iters: int = 0):
    """Ordered traversal of the binary BVH (`intersect_bvh`): a lane pops a
    node, tests a leaf or both children of an inner node, descends into the
    nearer child hit and pushes the farther one when both are. A push onto
    a full stack overwrites its last slot, as in the JAX loop."""
    n_nodes = scene.node_pack.shape[0]
    depth = meta.bvh_depth + 2
    if max_iters <= 0:
        max_iters = n_nodes + 64
    node_box = scene.node_pack[:, 0:6]
    node_int = scene.node_pack[:, 6:8].contiguous().view(torch.int32)  # left, count
    lanes = _lanes(o, d, t_max, alpha_seed)
    root = node_box[0]
    hit, entry = slab_test(root[0:3] * lanes["idir"] + lanes["odir"], root[3:6] * lanes["idir"] + lanes["odir"],
                           t_min, lanes["t"])
    lanes.update(node=torch.zeros(o.shape[0], dtype=torch.int32, device=o.device), dist=entry,
                 sp=torch.zeros(o.shape[0], dtype=torch.int32, device=o.device), active=hit)

    def box(child, st):
        b = node_box[torch.clamp(child, max=n_nodes - 1).long()]
        return slab_test(b[:, 0:3] * st["idir"] + st["odir"], b[:, 3:6] * st["idir"] + st["odir"], t_min,
                         st["t"])

    def step(st):
        node, active, sp = st["node"], st["active"], st["sp"]
        lc = node_int[node.long()]
        left, count = lc[:, 0], lc[:, 1]
        is_leaf = count > 0
        near_ok = st["dist"] < st["t"]
        do_leaf = active & is_leaf & near_ok
        do_inner = active & ~is_leaf & near_ok
        upd = _leaf_step(scene, meta, st, left, count, do_leaf, t_min, nee)

        l_child = torch.where(is_leaf, 0, left)
        r_child = l_child + 1
        lh, ld = box(l_child, st)
        rh, rd = box(r_child, st)
        lh = lh & do_inner
        rh = rh & do_inner
        both = lh & rh
        swap = both & (ld > rd)
        near_node = torch.where(swap, r_child, torch.where(lh, l_child, r_child))
        near_d = torch.where(swap, rd, torch.where(lh, ld, rd))
        descend = lh | rh
        top = torch.clamp(sp, 0, depth - 1).long()[:, None]
        for name, far in (("snode", torch.where(swap, l_child, r_child)), ("sdist", torch.where(swap, ld, rd))):
            s = st[name]
            s.scatter_(1, top, torch.where(both[:, None], far[:, None], s.gather(1, top)))
        sp = sp + both.to(torch.int32)

        need_pop = do_leaf | (active & ~near_ok) | (do_inner & ~descend)
        can_pop = sp > 0
        sp = torch.where(need_pop & can_pop, sp - 1, sp)
        pidx = torch.clamp(sp, 0, depth - 1).long()[:, None]
        go = do_inner & descend
        st["node"] = torch.where(go, near_node, torch.where(need_pop, st["snode"].gather(1, pidx)[:, 0], node))
        st["dist"] = torch.where(go, near_d, torch.where(need_pop, st["sdist"].gather(1, pidx)[:, 0], st["dist"]))
        st["sp"] = sp
        active = active & ~(need_pop & ~can_pop)
        st["active"] = active & ~upd if nee else active

    return _walk(lanes, step, max_iters, depth)


def intersect_bvh8(scene, meta, o, d, t_max, t_min: float = 1e-3, nee: bool = False, alpha_seed=None,
                   max_iters: int = 0):
    """The 8-wide traversal (`intersect_bvh8`): one row of `wide_pack`
    tests a group's 8 child boxes; the lane descends into the nearest child
    hit and pushes the others far first, so they pop near first. A child
    ref is >= 0 a group, -1 empty, <= -2 a leaf with v = -(ref + 2),
    first = v >> 4, count = v & 15."""
    width = 8
    depth = (width - 1) * meta.wide_depth + 2
    if max_iters <= 0:
        max_iters = 2 * scene.wide_pack.shape[0] + 64
    wide_box = scene.wide_pack[:, :48].reshape(-1, width, 6)
    wide_enc = scene.wide_pack[:, 48:56].contiguous().view(torch.int32)
    n, dev = o.shape[0], o.device
    lanes = _lanes(o, d, t_max, alpha_seed)
    lanes.update(cur=torch.zeros(n, dtype=torch.int32, device=dev),
                 cur_dist=torch.full((n,), t_min, dtype=torch.float32, device=dev),
                 sp=torch.zeros(n, dtype=torch.int32, device=dev), active=lanes["t"] > t_min)
    slots = torch.arange(width - 1, dtype=torch.int32, device=dev)

    def step(st):
        cur, active, sp = st["cur"], st["active"], st["sp"]
        is_leaf = cur <= -2
        near_ok = st["cur_dist"] < st["t"]
        do_leaf = active & is_leaf & near_ok
        do_inner = active & ~is_leaf & near_ok
        vdec = -(cur + 2)
        upd = _leaf_step(scene, meta, st, torch.where(is_leaf, vdec >> 4, 0), vdec & 15, do_leaf, t_min, nee)

        g = torch.clamp(cur, min=0).long()
        boxes = wide_box[g]  # [m, 8, 6]
        idir, odir = st["idir"][:, None, :], st["odir"][:, None, :]
        lo = boxes[..., 0:3] * idir + odir
        hi = boxes[..., 3:6] * idir + odir
        c0 = torch.clamp(torch.minimum(lo, hi).amax(dim=-1), min=t_min)
        c1 = torch.minimum(torch.maximum(lo, hi).amin(dim=-1), st["t"][:, None])
        enc8 = wide_enc[g]
        chit = (c1 >= c0) & (enc8 != -1) & do_inner[:, None]
        s_dist, s_enc = sort_children(torch.where(chit, c0, F32_MAX), enc8)
        n_hit = chit.sum(dim=1, dtype=torch.int32)
        descend = do_inner & (n_hit > 0)

        # Push sorted children n_hit - 1 down to 1 into slots sp, sp + 1, ...
        n_push = torch.clamp(n_hit - 1, min=0)
        slot = sp[:, None] + slots
        write = (slots < n_push[:, None]) & descend[:, None] & (slot < depth)
        slot = torch.where(write, slot, depth).long()  # the spare column
        src = torch.clamp(n_hit[:, None] - 1 - slots, 0, width - 1).long()
        st["snode"].scatter_(1, slot, s_enc.gather(1, src))
        st["sdist"].scatter_(1, slot, s_dist.gather(1, src))
        sp = sp + torch.where(descend, n_push, 0)

        need_pop = do_leaf | (active & ~near_ok) | (do_inner & ~descend)
        can_pop = sp > 0
        sp = torch.where(need_pop & can_pop, sp - 1, sp)
        pidx = torch.clamp(sp, 0, depth - 1).long()[:, None]
        st["cur"] = torch.where(descend, s_enc[:, 0],
                                torch.where(need_pop, st["snode"].gather(1, pidx)[:, 0], cur))
        st["cur_dist"] = torch.where(descend, s_dist[:, 0],
                                     torch.where(need_pop, st["sdist"].gather(1, pidx)[:, 0], st["cur_dist"]))
        st["sp"] = sp
        active = active & ~(need_pop & ~can_pop)
        st["active"] = active & ~upd if nee else active

    return _walk(lanes, step, max_iters, depth + 1)


def intersect_bvh_sorted(scene, meta, o, d, t_max, t_min: float = 1e-3, nee: bool = False, alpha_seed=None,
                         chunk: int = 65536):
    """`intersect_bvh_sorted`: below 2 x `chunk` lanes `intersect_bvh8` in
    lane order; otherwise the lanes sorted (stably) by `coherence_key`
    (direction octant, origin Morton cell), so that neighbouring lanes walk
    similar nodes and their gathers stay local, traversed as one working
    set and written back to lane order. Lane-exact to `intersect_bvh8`."""
    n, dev = o.shape[0], o.device
    if n < 2 * chunk:
        return intersect_bvh8(scene, meta, o, d, t_max, t_min, nee, alpha_seed)
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n,))
    order = torch.sort(coherence_key(scene, o, d), stable=True).indices
    seed = None if alpha_seed is None else torch.broadcast_to(alpha_seed, (n,))[order]
    h = intersect_bvh8(scene, meta, o[order], d[order], t_max[order], t_min, nee, seed)
    return Hit(*(torch.empty_like(a).index_copy_(0, order, a) for a in h))
