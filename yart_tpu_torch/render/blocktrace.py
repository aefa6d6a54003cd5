"""Block-trace: presorted block traversal for big scenes.

Port of `yart_tpu/render/blocktrace.py`: `intersect_blocktrace` (:217-419)
with its fused path and its round-based path (`fused=False`),
`_pad_sorted` (:128-176), `_fused_order` (:179-214), `_hit_gates` and
`intersect_blocktrace_gated` (:422-658), for plain and instanced scenes
(the round-based path for plain scenes only). An instanced scene's
traversal clusters are its (instance, prototype cluster) pairs (`_n_clus`,
:96-100): B2 sweeps their world boxes in `clus_box` unchanged, and B3 runs
in its instanced mode, mapping each ray into the prototype's object space
per tested cluster.

One cast (`intersect_blocktrace`):
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
With `order_info` (from `fused_order`) steps 2-3 are skipped: the cast
reuses an earlier presort's order, `blive` flags and slot columns.

The gated re-cast loop (`intersect_blocktrace_gated`) serves scenes whose
hits must pass per-hit gates: the stochastic alpha test and, for shadow
rays, transparent surfaces. Each cast finds the closest hit past a
per-lane floor; lanes whose hit is rejected (alpha) or passed through
(transparent; its attenuation multiplies in) raise their floor to that
hit and cast again, at most 32 times, with one host sync per cast.

Why one presort serves every cast. The presort and the two-key sort run
once per call (and once more after tail compaction). Every later cast
reuses the order and B2's 4 slot columns, and takes per block
`blive = blive0 & any(t_max > 0)`. That is exact: B3 visits a ray's slot
clusters first and then every other cluster in ascending id, testing each
cluster once, with the order-free tie rule (closest t, then the lowest
triangle index). Slots that went stale as the floor rose therefore change
only the visit order, never a result; a slot cluster that lies wholly
below the floor fails B3's entry test (exit > floor). A block whose rays
entered no cluster at the first cast enters none later either: floors only
rise and retired lanes carry t_max = -1, and both only shrink a ray's
entry set.

When the scene has alpha, every cast runs B3 in its `amask` mode: a
candidate whose alpha-mask cell is certainly transparent is culled inside
the kernel. The gate would reject such a hit for every draw (the accept
test is strict, u_a < alpha, and alpha is 0), so the cull leaves the
result unchanged and only saves casts.

Tail compaction: once the active count fits `cap = ceil(n // 6 / 128) *
128` lanes, the survivors move (stable sort, active first) into a
`cap`-lane set with its own presort, finish there, and scatter back.

The round-based path (`fused=False`, the JAX package's original
pipeline; only tests reach it there too). The rays are sorted by
`coherence_key` (octant, origin Morton cell) with the lanes at t_max <= 0
last, and padded to whole 128-ray blocks with copies of the last lane at
t_max = -1. Every round, for the blocks still active:
1. B7a (kernels/blocktrace.py `select_clusters`) keys every cluster box by
   its least entry over the block's rays and picks the K lexicographically
   smallest keys at or above the block's window key;
2. B7b (`test_clusters`) tests the block's rays against those K clusters
   in order (each cluster's real triangles, `cluster_counts`), each ray
   from its best hit so far, and improved rays take the new hit;
3. the least key left over (`bound_key`) becomes the block's next window.
   A block is done when nothing was left over, or when every ray's best t
   is at or below that key's entry (the entry bits with the id cleared,
   a lower bound on every untested cluster's entry); with `nee` a ray that
   has a hit is done too.
One host sync per round (the active count), at most `max_rounds` rounds;
blocks still active then keep the hits found so far, as in the JAX
package. `LEGACY` counts calls and rounds. B7b breaks bit-equal t by the
earlier slot and the lower column, B3 by the lower triangle index, so the
two paths may name different triangles at one t; t and the mask agree.

CUDA tensors run the kernels, CPU tensors their plain twins.
"""

from __future__ import annotations

import dataclasses

import torch

from yart_tpu_torch.kernels import blocktrace as _bk
from yart_tpu_torch.kernels import fusedtrace as _ft
from yart_tpu_torch.kernels import presort as _ps
from yart_tpu_torch.ops.qmc import alpha_draw
from yart_tpu_torch.ops.vecmath import mat3_rows
from yart_tpu_torch.render.hit import Hit, coherence_key
from yart_tpu_torch.render.texture import sample_stack

BLOCK = _ft.BLOCK
MAX_CLUSTERS = _ps.MAX_CLUSTERS
CAP_DIV = 6  # tail-compaction buffer = n // CAP_DIV lanes (TRACE_CAPDIV)
MAX_CASTS = 32


@dataclasses.dataclass
class GatedCounts:
    """Gated calls and the casts they took (host counters, no sync)."""

    calls: int = 0
    casts: int = 0

    def reset(self) -> None:
        self.calls = 0
        self.casts = 0


GATED = GatedCounts()


@dataclasses.dataclass
class LegacyCounts:
    """Round-based (fused=False) calls and the rounds they took (host
    counters, no sync)."""

    calls: int = 0
    rounds: int = 0

    def reset(self) -> None:
        self.calls = 0
        self.rounds = 0


LEGACY = LegacyCounts()


def n_clus(meta) -> int:
    """Traversal clusters: the instance clusters of an instanced scene."""
    return meta.n_inst_clusters if meta.n_instances else meta.n_clusters


def inst_tables(scene, meta):
    """B3's instanced tables (clus_src, clus_inst, clus_fid, inst_flat), or
    None for a scene without instances."""
    if not meta.n_instances:
        return None
    return scene.clus_src, scene.clus_inst, scene.clus_fid, scene.inst_flat


def cluster_counts(scene, meta) -> torch.Tensor:
    """Triangles per traversal cluster [n_clus] int32. The clusters are
    contiguous ranges of the leaf-ordered triangles, so each ends where the
    next higher first triangle (or the last triangle) begins. The instance
    clusters of an instanced scene are ranges of the virtual triangles,
    which run instance after instance, each in its prototype's leaf order:
    the same rule over their first virtual triangles `clus_fid`."""
    if meta.n_instances:
        first, n_tris = scene.clus_fid[: meta.n_inst_clusters].long(), meta.n_tris
    else:
        first, n_tris = scene.clus_first.long(), scene.tri_pack.shape[0]
    start, idx = torch.sort(first)
    end = torch.cat([start[1:], torch.full((1,), n_tris, dtype=torch.long, device=first.device)])
    counts = torch.empty_like(first)
    counts[idx] = end - start
    return counts.to(torch.int32)


def lane_vectors(n: int, t_max, floor, dev):
    """t_max and floor (None: zeros) broadcast to [n] float32 lanes."""
    t_max_v = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n,))
    floor_v = (torch.zeros(n, dtype=torch.float32, device=dev) if floor is None
               else torch.broadcast_to(torch.as_tensor(floor, dtype=torch.float32, device=dev), (n,)))
    return t_max_v, floor_v


def ray_matrix(o, d, t_max, floor=None) -> torch.Tensor:
    """The [Np, 8] ray matrix (o, d, t_max, floor) of o, d [N, 3], padded
    to whole 128-ray blocks with rows at t_max = -1."""
    n = o.shape[0]
    dev = o.device
    t_max_v, floor_v = lane_vectors(n, t_max, floor, dev)
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


def fused_order(scene, meta, o, d, t_max, floor, t_min: float):
    """One presort (B2) and two-key sort: (order, blive0, slots) over the
    block-padded lanes, where `slots` are B2's 4 slot columns in sorted
    order. Every cast of a gated call reuses them (see the module
    docstring)."""
    rays = ray_matrix(o, d, t_max, floor)
    pk = _ps.presort_keys(rays, scene.clus_box, n_clus(meta), t_min)
    order, blive = schedule(pk)
    return order, blive, pk[order, 1 : 1 + _ps.N_SLOTS].contiguous()


def intersect_blocktrace(scene, meta, o, d, t_max, t_min: float = 1e-3, nee: bool = False,
                         floor=None, order_info=None, amask: bool = False, fused: bool = True,
                         k: int = 24, max_rounds: int = 64, trace=None):
    """Closest hit (or, with `nee`, any hit) of rays o, d [N, 3] with t_max
    [N] (or a scalar). `floor` [N] optionally restricts hits to t > floor.
    `fused=True` runs B2 + B3; `order_info` reuses an earlier `fused_order`
    and `amask` runs B3's alpha-mask cull. `fused=False` runs the
    round-based path (B7a + B7b, `k` slots per block and round, at most
    `max_rounds` rounds; `trace`, a list, receives the active block count
    of every round). Returns the raw per-ray columns (t, u, v, back, tri,
    clusters tested, triangles tested) in lane order; on the round-based
    path the last two are the live slots the ray's blocks tested and C
    times that (every slot tests all C columns)."""
    if not fused:
        if meta.n_instances:
            raise ValueError("fused=False: the round-based select/test pipeline has no instanced support")
        if amask:
            raise ValueError("fused=False with amask=True: the alpha-mask cull is only wired into the fused "
                             "kernel and would silently not cull")
        if order_info is not None:
            raise ValueError("fused=False with order_info: a presorted order serves the fused path only")
        return _intersect_rounds(scene, meta, o, d, t_max, t_min, nee, floor, k, max_rounds, trace)
    n = o.shape[0]
    rays = ray_matrix(o, d, t_max, floor)
    if order_info is None:
        pk = _ps.presort_keys(rays, scene.clus_box, n_clus(meta), t_min)
        order, blive = schedule(pk)
        slots = pk[order, 1 : 1 + _ps.N_SLOTS].contiguous()
        rays_s = rays[order]
    else:
        order, blive0, slots = order_info
        rays_s = rays[order]
        blive = ((rays_s[:, 6] > 0.0).view(-1, BLOCK).any(dim=1) & (blive0 != 0)).to(torch.int32)
    out_s = _ft.fused_trace(
        rays_s, slots, scene.clus_box, scene.clus_pack, cluster_counts(scene, meta), blive, t_min,
        nee, amask, inst_tables(scene, meta),
    )
    out = torch.empty_like(out_s)
    out[order] = out_s
    out = out[:n]
    return (out[:, 0], out[:, 1], out[:, 2], out[:, 3] > 0.5,
            out[:, 4].contiguous().view(torch.int32), out[:, 5], out[:, 6])


def pad_sorted(scene, o, d, t_max, floor):
    """The round-based path's ray order (`_pad_sorted` without `meta`): a
    stable sort by `coherence_key` with the lanes at t_max <= 0 last, padded
    to whole blocks with copies of lane n-1 at t_max = -1. Returns the
    sorted (o, d, t_max, floor) and `inv`, which gathers sorted results back
    to lane order."""
    n = o.shape[0]
    key = coherence_key(scene, o, d) | ((t_max <= 0.0).long() << 25)
    order = torch.argsort(key, stable=True)
    inv = torch.argsort(order)
    pad = (-n) % BLOCK
    if pad:
        order = torch.cat([order, torch.full((pad,), n - 1, dtype=order.dtype, device=order.device)])
    t_s = t_max[order]
    if pad:
        t_s[n:] = -1.0
    return o[order], d[order], t_s, floor[order], inv


def round_slots(scene, ids, n_live, act):
    """B7b's per-slot (live, first, ids) [n_blocks * K] from B7a's outputs
    ids [n_blocks, K] and n_live and the active flags `act`. Dead slots
    repeat the block's last live id (or cluster 0), as the TPU kernel's
    DMA wants; B7b skips them."""
    slot = torch.arange(ids.shape[1], device=ids.device)[None, :]
    dma = ids.gather(1, torch.minimum(slot, (n_live.long() - 1).clamp_min(0)[:, None])).clamp_min(0).reshape(-1)
    live = ((slot < n_live[:, None]) & (act[:, None] != 0)).reshape(-1).to(torch.int32)
    return live, scene.clus_first[dma.long()], dma


def blocks_done(t, tri, bound_key, nee: bool):
    """Per block, after a round: True when nothing was left over
    (bound_key = KEY_DEAD) or every ray's best t [Np] is at or below the
    left-over key's entry (with `nee`, or the ray has a hit, tri [Np] >= 0)."""
    n_blocks = bound_key.shape[0]
    no_drop = bound_key == _ps.KEY_DEAD
    bound_e = torch.where(no_drop, 3.0e38, (bound_key & ~_ps.ID_MASK).view(torch.float32))
    ray_done = t.view(n_blocks, BLOCK) <= bound_e[:, None]
    if nee:
        ray_done = ray_done | (tri >= 0).view(n_blocks, BLOCK)
    return no_drop | ray_done.all(dim=1)


def _intersect_rounds(scene, meta, o, d, t_max, t_min, nee, floor, k, max_rounds, trace):
    """The round-based path of `intersect_blocktrace` (see the module
    docstring); JAX :351-419."""
    dev = o.device
    c = meta.cluster_size
    o_s, d_s, t_s, floor_s, inv = pad_sorted(scene, o, d, *lane_vectors(o.shape[0], t_max, floor, dev))
    n_blocks = o_s.shape[0] // BLOCK
    res = torch.zeros((o_s.shape[0], 8), dtype=torch.float32, device=dev)
    res[:, 0] = t_s
    res.view(torch.int32)[:, 4] = -1
    w_key = torch.full((n_blocks,), -(1 << 31), dtype=torch.int32, device=dev)
    act = torch.ones(n_blocks, dtype=torch.bool, device=dev)
    tested = torch.zeros(n_blocks, dtype=torch.float32, device=dev)
    counts = cluster_counts(scene, meta)
    LEGACY.calls += 1
    for _ in range(max_rounds):
        n_act = int(act.sum())
        if n_act == 0:
            break
        if trace is not None:
            trace.append(n_act)
        LEGACY.rounds += 1
        rays = torch.cat([o_s, d_s, res[:, 0:1], floor_s[:, None]], dim=1)
        ids, w_key, n_live = _bk.select_clusters(rays, scene.clus_box, w_key, act.to(torch.int32), k, t_min)
        live, first, dma = round_slots(scene, ids, n_live, act)
        out = _bk.test_clusters(rays, scene.clus_pack, live, first, dma, c, k, t_min, counts)
        res = torch.where((out[:, 4].view(torch.int32) >= 0)[:, None], out, res)
        tested += live.view(n_blocks, k).sum(dim=1)
        act = act & ~blocks_done(res[:, 0], res[:, 4].view(torch.int32), w_key, nee)
    res = res[inv]
    n_ct = tested.repeat_interleave(BLOCK)[inv]
    return (res[:, 0], res[:, 1], res[:, 2], res[:, 3] > 0.5, res[:, 4].contiguous().view(torch.int32),
            n_ct, n_ct * c)


class _Captured(Exception):
    """Carries one round's B7a inputs out of `_intersect_rounds`."""


def round_inputs(scene, meta, o, d, t_max, k: int = 24, windowed: bool = False, t_min: float = 1e-3):
    """B7a's inputs (rays, w_key, act) and the round's number as one
    `intersect_blocktrace(fused=False)` call hands them over: at round 1,
    or with `windowed` at the first round that has both converged and
    active blocks. Taken from the round loop itself (it wraps
    `select_clusters` and stops the call there), so a check of B7a or B7b
    sees exactly what the path feeds them. Raises ValueError when every
    block converges in the same round."""
    real = _bk.select_clusters
    rounds = []

    def capture(rays, box, w_key, act, k_, t_min_):
        rounds.append(1)
        if not windowed or not bool(act.all()):
            raise _Captured(rays, w_key, act, len(rounds))
        return real(rays, box, w_key, act, k_, t_min_)

    _bk.select_clusters = capture
    try:
        _intersect_rounds(scene, meta, o, d, t_max, t_min, False, None, k, 1 << 16, None)
    except _Captured as cap:
        return cap.args
    finally:
        _bk.select_clusters = real
    raise ValueError("every block converged in the same round: no windowed round")


def hit_gates(scene, meta, u, v, tri, d, nee: bool, alpha_seed):
    """Per-hit gates (`_hit_gates`, blocktrace.py:422-498) of hits of any
    leading shape: u, v and tri broadcast together, d [..., 3] and
    alpha_seed broadcast with them. Returns (alpha_ok, transparent, factor
    [..., 3]). The alpha test accepts when alpha >= 1 or u_a < alpha,
    strictly, with u_a the (lane seed, tri) hash draw; shadow rays pass
    through thin transmissive surfaces, which attenuate by |n.d| x base
    colour (x tex^2 where textured). The gated brute
    (render/intersect.py) calls it on [rays, triangles] candidates. An
    instanced scene finds material and shade row through `tri_aux`, and
    rotates the object-space normal by the instance's normal matrix
    before the cosine."""
    shape = torch.broadcast_shapes(u.shape, v.shape, tri.shape)
    dev = tri.device
    tri_c = torch.clamp(tri, 0, meta.n_tris - 1).long()
    m = scene.materials
    if meta.n_instances:
        aux = scene.tri_aux[tri_c].long()
        mats = aux[..., 3]
        srow = scene.shade_pack[aux[..., 0]]
    else:
        mats = scene.tri_mat[tri_c].long()
        srow = scene.shade_pack[tri_c]
    w_b, uu, vv = (1.0 - u - v)[..., None], u[..., None], v[..., None]
    uv = w_b * srow[..., 9:11] + uu * srow[..., 11:13] + vv * srow[..., 13:15]

    def texel(idx):  # the rgba texel of every hit
        flat = sample_stack(scene.tex_rgba, torch.broadcast_to(idx, shape).reshape(-1), uv.reshape(-1, 2))
        return flat.reshape(shape + (4,))

    alpha_ok = torch.ones(shape, dtype=torch.bool, device=dev)
    if meta.any_alpha:
        tb = m.tex_base[mats]
        has_a = m.has_alpha[mats] & (tb >= 0)
        alpha = torch.where(has_a, texel(tb)[..., 3], 1.0)
        alpha_ok = (alpha >= 1.0) | (alpha_draw(alpha_seed, tri) < alpha)

    transparent = torch.zeros(shape, dtype=torch.bool, device=dev)
    factor = torch.ones(shape + (3,), dtype=torch.float32, device=dev)
    if nee and meta.any_transparent:
        transparent = torch.broadcast_to(m.thin[mats] & (m.transmission[mats] > 0.0), shape)
        n_interp = w_b * srow[..., 0:3] + uu * srow[..., 3:6] + vv * srow[..., 6:9]
        if meta.n_instances:
            n_interp = mat3_rows(scene.inst_rows[aux[..., 1]][..., 24:33], n_interp)
            n_interp = n_interp / torch.linalg.vector_norm(n_interp, dim=-1, keepdim=True).clamp_min(1e-20)
        base = m.base_color[mats, :3]
        if meta.any_textures:
            tb2 = m.tex_base[mats]
            b_tex = texel(tb2)[..., :3]
            base = torch.where((tb2 >= 0)[..., None], base * b_tex * b_tex, base)
        cosd = (n_interp * d).sum(dim=-1, keepdim=True).abs()
        factor = cosd * base
    return alpha_ok, transparent, factor


def _run_casts(scene, meta, o, d, t_max, seed, state, order_info, t_min, nee, amask, stop_at,
               trace, fused):
    """The re-cast loop over one lane set. `state` is (best: dict of hit
    fields, act, floor, cast). Stops when no lane is active, at MAX_CASTS,
    or (with `stop_at`) once the active count fits `stop_at` lanes. One
    host sync per cast: the active count."""
    best, act, floor, cast = state
    while cast < MAX_CASTS:
        n_act = int(act.sum())
        if n_act == 0 or (stop_at is not None and n_act <= stop_at):
            break
        if trace is not None:
            trace.append(n_act)
        tm = torch.where(act, t_max, -1.0)
        t, u, v, back, tri, _, _ = intersect_blocktrace(
            scene, meta, o, d, tm, t_min, nee=False, floor=floor, order_info=order_info, amask=amask,
            fused=fused)
        hit = (tri >= 0) & act
        alpha_ok, transparent, factor = hit_gates(scene, meta, u, v, tri, d, nee, seed)
        passthru = hit & (transparent | ~alpha_ok)
        accept = hit & ~transparent & alpha_ok
        best["attenuation"] = torch.where((hit & transparent)[:, None], best["attenuation"] * factor,
                                          best["attenuation"])
        for k, val in (("t", t), ("tri", tri), ("u", u), ("v", v), ("back_side", back)):
            best[k] = torch.where(accept, val, best[k])
        best["mask"] = best["mask"] | accept
        act = act & passthru
        floor = torch.where(passthru, t, floor)
        cast += 1
        GATED.casts += 1
    return best, act, floor, cast


def intersect_blocktrace_gated(scene, meta, o, d, t_max, t_min: float = 1e-3, nee: bool = False,
                               alpha_seed=None, trace=None, fused: bool = True):
    """Block trace with per-hit gates through the re-cast loop (see the
    module docstring). `alpha_seed` [N] holds u32 keys in int64 (zeros
    when None). `trace`, a list, receives the active count of every cast.
    With `fused=False` every cast takes the round-based path, without the
    alpha-mask cull, a shared presort or tail compaction (JAX :564-620).
    Returns a render/hit.py `Hit`."""
    n = o.shape[0]
    dev = o.device
    t_max_v, _ = lane_vectors(n, t_max, None, dev)
    seed = (torch.zeros(n, dtype=torch.int64, device=dev) if alpha_seed is None
            else torch.broadcast_to(alpha_seed, (n,)))
    amask = bool(meta.any_alpha) and fused
    GATED.calls += 1

    best = dict(
        t=t_max_v.clone(), tri=torch.full((n,), -1, dtype=torch.int32, device=dev),
        u=torch.zeros(n, dtype=torch.float32, device=dev),
        v=torch.zeros(n, dtype=torch.float32, device=dev),
        back_side=torch.zeros(n, dtype=torch.bool, device=dev),
        attenuation=torch.ones((n, 3), dtype=torch.float32, device=dev),
        mask=torch.zeros(n, dtype=torch.bool, device=dev),
    )
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    order_info = fused_order(scene, meta, o, d, t_max_v, zeros, t_min) if fused else None
    cap = -(-(n // CAP_DIV) // BLOCK) * BLOCK
    compact = fused and BLOCK <= cap < n
    state = (best, torch.ones(n, dtype=torch.bool, device=dev), zeros, 0)
    best, act, floor, cast = _run_casts(scene, meta, o, d, t_max_v, seed, state, order_info, t_min,
                                        nee, amask, cap if compact else None, trace, fused)
    if compact and cast < MAX_CASTS and bool(act.any()):
        # Tail compaction: the survivors finish in `cap` lanes (stable
        # sort: active lanes first, in lane order), with their own presort.
        idx = torch.argsort((~act).to(torch.uint8), stable=True)[:cap]
        o_c, d_c, tmax_c, act_c, floor_c = o[idx], d[idx], t_max_v[idx], act[idx], floor[idx]
        order_c = fused_order(scene, meta, o_c, d_c, torch.where(act_c, tmax_c, -1.0),
                              torch.where(act_c, floor_c, 0.0), t_min)
        sub = {k: val[idx] for k, val in best.items()}
        sub, _, _, _ = _run_casts(scene, meta, o_c, d_c, tmax_c, seed[idx],
                                  (sub, act_c, floor_c, cast), order_c, t_min, nee, amask, None,
                                  trace, fused)
        for k, val in sub.items():
            best[k] = best[k].index_put((idx,), val)
    return Hit(best["t"], best["tri"], best["u"], best["v"], best["back_side"],
               best["attenuation"], best["mask"])
