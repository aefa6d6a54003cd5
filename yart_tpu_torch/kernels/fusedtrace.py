"""B3: fused block-trace closest hit — Hopper kernel and plain twin.

`fused_trace` is the entry point. For tensors on a CUDA device it launches
the hand-written kernel in `csrc/fused_trace.cu` (which replaces
`yart_tpu/kernels/pallas_fusedtrace.py` `fused_trace_pallas`) and raises
if it cannot; for CPU tensors it runs `fused_trace_plain`, the same
arithmetic in plain PyTorch. There is no fallback from one to the other.

Contract. Each row of `rays` [Np, 8] (o3, d3, t_cur, floor; presorted)
gets the exact closest valid hit over the n_clus = `clus_count.shape[0]`
traversal clusters, with `_t_only`'s plane test
(pallas_fusedtrace.py:118-138) on the pack rows [8, 3C] of `clus_pack`,
dot products formed x + y + z as in `_proj`:

    t = (cn - n.o) / n.d,   u = eu.o + t (eu.d) - cu,   v likewise
    valid: |n.d| >= EPS_DET, 0 <= u <= 1, v >= 0, u + v <= 1,
           t_min < t, floor < t, and (t, tri) beats the carried best
    back = n.d > 0,  tri = the cluster's first triangle + column

With `amask` (the alpha-mask mode, `_amask_valid` at
pallas_cluster.py:38-58) a candidate is valid only if bit
clip(iu * 8 + iv, 0, 63) of its triangle's 8x8 barycentric alpha mask is
set, iu = int(clip(8u, 0, 7)) and iv likewise; the mask words ride in pack
row 5 (lanes [0:C] = bits 0..31, [C:2C] = bits 32..63, int32 bits). A NaN
u or v (t = 0/0 on a padding column) converts to an integer that depends
on the device, which is why the bit index is clamped again in the integer
domain; such lanes already fail the geometric tests, so kernel and twin
agree on every valid candidate.

Instanced mode (`inst` = (clus_src, clus_inst, clus_fid, inst_flat);
pallas_fusedtrace.py:291-315, :651-660): traversal cluster `cid` is one
(instance, prototype cluster) pair with a world box in `clus_box`. Its
triangles are pack row clus_src[cid], tested with the ray mapped into the
prototype's object space by the instance's unnormalised inverse 3x4
r = inst_flat[12 clus_inst[cid] : +12],

    o'_a = ((o0 r[4a] + o1 r[4a+1]) + o2 r[4a+2]) + r[4a+3]
    d'_a = (d0 r[4a] + d1 r[4a+1]) + d2 r[4a+2]

so t stays the world parameter; tri = clus_fid[cid] + column, and `amask`
reads the prototype's own mask words. Without `inst`, cluster `cid` is pack
row `cid` and the first triangle rides in its row 4, lane 0.

Output [Np, 8] f32: t, u, v, back (0/1), tri (int32 bits; -1 = miss), the
clusters tested, the triangles tested, and the alpha-mask tests run (0
without `amask`). A miss keeps t = t_cur. The kernel tests a candidate's
mask only once it has passed the geometric tests and beats the best so far
(`&&` order), so the last column counts exactly those candidates. With
`nee` a ray stops after the first cluster that gives it a hit: only the
hit mask is then the contract (the JAX package's any-hit early-out).

Tie rule. Among hits at bit-equal t the lowest triangle index wins. The
JAX kernel breaks such ties by its per-block visit order; the port's rule
does not depend on any order, like B1's (kernels/brute.py).

Visit order and culling. Per ray: first the (up to) 4 nearest clusters of
its presort slots (B2's row, cols 1-4), nearest first, then every other
cluster in ascending id. A cluster is tested when the ray enters its box
(B2's conservative slab test and margins: exit >= entry, entry < t_max,
exit > floor) and its entry is <= the ray's current best t. Kernel and
twin visit in this same order, so they test the same clusters and agree
bitwise; the kernel is built with --fmad=false. Blocks of 128 rays whose
`blive` flag is 0 enter nothing and are skipped whole.

`COUNTS` records kernel launches (in total and per mode: closest, nee,
amask, instanced and their combinations) and plain-twin calls on CUDA
tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yart_tpu_torch.kernels.build import Counts, load, refuse_grad
from yart_tpu_torch.kernels.presort import ID_MASK, KEY_DEAD, N_SLOTS, sweep_bounds

EPS_DET = 1e-12
BLOCK = 128  # rays per `blive` flag and per kernel thread block

COUNTS = Counts()


def bind(lib):
    """The launcher `fused_trace_launch` of a loaded B3 library, typed."""
    fn = lib.fused_trace_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # rays, slots, n
        ctypes.c_void_p, ctypes.c_int,  # clus_box, cpad
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # pack, count, n_clus, c
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # clus_src, _inst, _fid, inst_flat
        ctypes.c_void_p,  # blive
        ctypes.c_float, ctypes.c_int, ctypes.c_int,  # t_min, nee, amask
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # stream
    ]
    return fn


@functools.cache
def _library():
    """The package kernel's launcher, loaded once a process: `load` hashes
    the sources, ~0.15 ms a call on the card's host."""
    return bind(load("fused_trace")[0])


def _check(rays, slots, clus_box, clus_pack, clus_count, blive, inst=None):
    n = rays.shape[0]
    if rays.dim() != 2 or rays.shape[1] != 8 or n % BLOCK:
        raise ValueError(f"rays must be [Np, 8] with Np a multiple of {BLOCK}, got {tuple(rays.shape)}")
    if slots.shape != (n, N_SLOTS) or slots.dtype != torch.int32:
        raise ValueError(f"slots must be int32 [{n}, {N_SLOTS}], got {slots.dtype} {tuple(slots.shape)}")
    if clus_pack.dim() != 3 or clus_pack.shape[1] != 8 or clus_pack.shape[2] % 3:
        raise ValueError(f"clus_pack must be [n_pack, 8, 3C], got {tuple(clus_pack.shape)}")
    if clus_count.dim() != 1 or clus_count.dtype != torch.int32:
        raise ValueError("clus_count must be int32 [n_clus]")
    n_clus = clus_count.shape[0]
    if inst is None and n_clus != clus_pack.shape[0]:
        raise ValueError(f"clus_count has {n_clus} clusters, clus_pack {clus_pack.shape[0]}")
    if clus_box.dim() != 2 or clus_box.shape[0] != 8 or clus_box.shape[1] < n_clus:
        raise ValueError(f"clus_box must be [8, cpad >= {n_clus}], got {tuple(clus_box.shape)}")
    if blive.shape != (n // BLOCK,) or blive.dtype != torch.int32:
        raise ValueError(f"blive must be int32 [{n // BLOCK}]")
    for name, a in (("rays", rays), ("clus_box", clus_box), ("clus_pack", clus_pack)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
    tables = [("slots", slots), ("clus_box", clus_box), ("clus_pack", clus_pack),
              ("clus_count", clus_count), ("blive", blive)]
    if inst is not None:
        clus_src, clus_inst, clus_fid, inst_flat = inst
        for name, a in (("clus_src", clus_src), ("clus_inst", clus_inst), ("clus_fid", clus_fid)):
            if a.dim() != 1 or a.shape[0] < n_clus or a.dtype != torch.int32:
                raise ValueError(f"{name} must be int32 [>= {n_clus}], got {a.dtype} {tuple(a.shape)}")
        if inst_flat.dim() != 1 or inst_flat.shape[0] % 12 or inst_flat.dtype != torch.float32:
            raise ValueError(f"inst_flat must be float32 [I * 12], got {inst_flat.dtype} {tuple(inst_flat.shape)}")
        tables += [("clus_src", clus_src), ("clus_inst", clus_inst), ("clus_fid", clus_fid),
                   ("inst_flat", inst_flat)]
    for name, a in tables:
        if a.device != rays.device:
            raise ValueError(f"{name} is on {a.device}, rays on {rays.device}")
    return tables


def mode_name(nee: bool, amask: bool, inst: bool = False) -> str:
    return "+".join(m for m, on in (("instanced", inst), ("nee", nee), ("amask", amask)) if on) or "closest"


def amask_valid(u, v, words0, words1):
    """The alpha-mask bit of each candidate: u, v [R, K] float32, the
    triangles' mask words [1, K] int32."""
    iu = torch.clamp(u * 8.0, 0.0, 7.0).to(torch.int32)
    iv = torch.clamp(v * 8.0, 0.0, 7.0).to(torch.int32)
    bit = torch.clamp(iu * 8 + iv, 0, 63)
    sel = bit < 32
    word = torch.where(sel, words0, words1)
    return ((word >> torch.where(sel, bit, bit - 32)) & 1) != 0


def to_object(o, d, r):
    """Rays o, d [k, 3] in a prototype's object space: `r` [12] is the
    instance's unnormalised inverse 3x4, applied in the kernel's order."""
    lin = lambda x, a: x[:, 0:1] * r[4 * a] + x[:, 1:2] * r[4 * a + 1] + x[:, 2:3] * r[4 * a + 2]
    return (torch.cat([lin(o, a) + r[4 * a + 3] for a in range(3)], dim=1),
            torch.cat([lin(d, a) for a in range(3)], dim=1))


def fused_trace_plain(rays, slots, clus_box, clus_pack, clus_count, blive, t_min: float,
                      nee: bool = False, amask: bool = False, inst=None):
    """Plain PyTorch twin of the kernel (see the module docstring). Loops
    over clusters; each pass tests only the rays that visit that cluster
    next, against the cluster's real triangles."""
    _check(rays, slots, clus_box, clus_pack, clus_count, blive, inst)
    if rays.is_cuda:
        COUNTS.plain_cuda += 1
    dev = rays.device
    n = rays.shape[0]
    n_clus = clus_count.shape[0]
    c = clus_pack.shape[2] // 3
    out = torch.zeros((n, 8), dtype=torch.float32, device=dev)
    out[:, 0] = rays[:, 6]
    out[:, 4] = torch.tensor(-1, dtype=torch.int32).view(torch.float32)
    live = torch.nonzero(blive.repeat_interleave(BLOCK) != 0)[:, 0]
    if live.numel() == 0 or n_clus == 0:
        return out
    r = rays[live]
    o, d, t0, floor = r[:, 0:3], r[:, 3:6], r[:, 6], r[:, 7]
    bt = t0.clone()
    bu = torch.zeros_like(bt)
    bv = torch.zeros_like(bt)
    bb = torch.zeros_like(bt)
    bi = torch.full(bt.shape, -1, dtype=torch.int32, device=dev)
    n_ct = torch.zeros(bt.shape, dtype=torch.int32, device=dev)
    n_tt = torch.zeros(bt.shape, dtype=torch.int32, device=dev)
    n_mt = torch.zeros(bt.shape, dtype=torch.int32, device=dev)
    done = torch.zeros(bt.shape, dtype=torch.bool, device=dev)
    s = slots[live]
    scid = torch.where(s == KEY_DEAD, -1, s & ID_MASK)
    count = clus_count.tolist()
    if inst is None:
        src = list(range(n_clus))
        first = clus_pack[:, 4, 0].contiguous().view(torch.int32).tolist()
    else:
        src, which, first = (a[:n_clus].tolist() for a in inst[:3])
        inst_rows = inst[3].view(-1, 12)
    t_min_t = torch.tensor(t_min, dtype=torch.float32, device=dev)

    def visit(cid, idx):
        """Test cluster `cid` for rays `idx` that have not stopped."""
        e, xt = sweep_bounds(o[idx], d[idx], clus_box[:, cid : cid + 1])
        e = torch.maximum(e[:, 0], t_min_t)
        xt = xt[:, 0]
        go = (xt >= e) & (e < t0[idx]) & (xt > floor[idx]) & (e <= bt[idx])
        idx = idx[go]
        if idx.numel() == 0:
            return
        cnt = count[cid]
        tri = clus_pack[src[cid]]
        cols = torch.cat([tri[:, 0:cnt], tri[:, c : c + cnt], tri[:, 2 * c : 2 * c + cnt]], dim=1)
        oi, di = o[idx], d[idx]
        if inst is not None:
            oi, di = to_object(oi, di, inst_rows[which[cid]])
        ro = oi[:, 0:1] * cols[0][None] + oi[:, 1:2] * cols[1][None] + oi[:, 2:3] * cols[2][None]
        rd = di[:, 0:1] * cols[0][None] + di[:, 1:2] * cols[1][None] + di[:, 2:3] * cols[2][None]
        cn, cu, cv = cols[3, :cnt][None], cols[3, cnt : 2 * cnt][None], cols[3, 2 * cnt :][None]
        nd, ud, vd = rd[:, :cnt], rd[:, cnt : 2 * cnt], rd[:, 2 * cnt :]
        t = (cn - ro[:, :cnt]) / nd
        u = ro[:, cnt : 2 * cnt] + t * ud - cu
        v = ro[:, 2 * cnt :] + t * vd - cv
        valid = (
            (nd.abs() >= EPS_DET) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > t_min) & (t > floor[idx][:, None])
        )
        cur_t, cur_i = bt[idx], bi[idx]
        if amask:
            ok = amask_valid(u, v, tri[5:6, 0:cnt].contiguous().view(torch.int32),
                             tri[5:6, c : c + cnt].contiguous().view(torch.int32))
            # The kernel's mask tests: candidates that beat the carried (t, tri)
            # and every accepted column before them (those have lower tri, so
            # only a strictly smaller t beats them).
            tris = torch.arange(cnt, dtype=torch.int32, device=dev)[None] + first[cid]
            beats = (t < cur_t[:, None]) | ((t == cur_t[:, None]) & (cur_i[:, None] >= 0)
                                            & (tris < cur_i[:, None]))
            acc = torch.cummin(torch.where(valid & ok, t, float("inf")), dim=1).values
            before = torch.cat([torch.full_like(acc[:, :1], float("inf")), acc[:, :-1]], dim=1)
            n_mt[idx] += (valid & beats & (t < before)).sum(dim=1, dtype=torch.int32)
            valid = valid & ok
        # The cluster's lexicographic (t, column) minimum, then against the
        # carried (t, tri): the same winner as a column-by-column carry.
        j = torch.argmin(torch.where(valid, t, float("inf")), dim=1, keepdim=True)
        got = valid.gather(1, j)[:, 0]
        tj = t.gather(1, j)[:, 0]
        trij = (j[:, 0] + first[cid]).to(torch.int32)
        better = got & ((tj < cur_t) | ((tj == cur_t) & (cur_i >= 0) & (trij < cur_i)))
        bt[idx] = torch.where(better, tj, cur_t)
        bu[idx] = torch.where(better, u.gather(1, j)[:, 0], bu[idx])
        bv[idx] = torch.where(better, v.gather(1, j)[:, 0], bv[idx])
        bb[idx] = torch.where(better, (nd.gather(1, j)[:, 0] > 0.0).to(torch.float32), bb[idx])
        bi[idx] = torch.where(better, trij, cur_i)
        n_ct[idx] += 1
        n_tt[idx] += cnt
        if nee:
            done[idx] = bi[idx] >= 0

    for k in range(N_SLOTS):
        for cid in torch.unique(scid[:, k]).tolist():
            if cid >= 0:
                visit(cid, torch.nonzero((scid[:, k] == cid) & ~done)[:, 0])
    # Phase B in ascending id. A batched entry test per tile of clusters
    # (the visit's own test without the best-t bound) skips the clusters no
    # ray can enter, whose visits would test nothing.
    tile = max(1, min(n_clus, (1 << 24) // r.shape[0]))
    for c0 in range(0, n_clus, tile):
        e, xt = sweep_bounds(o, d, clus_box[:, c0 : min(n_clus, c0 + tile)])
        e = torch.maximum(e, t_min_t)
        could = (xt >= e) & (e < t0[:, None]) & (xt > floor[:, None])
        for j in torch.nonzero(could.any(dim=0))[:, 0].tolist():
            cid = c0 + j
            visit(cid, torch.nonzero(could[:, j] & ~(scid == cid).any(dim=1) & ~done)[:, 0])

    res = torch.stack([bt, bu, bv, bb, bi.view(torch.float32), n_ct.to(torch.float32),
                       n_tt.to(torch.float32), n_mt.to(torch.float32)], dim=1)
    out[live] = res
    return out


def fused_trace_cuda(rays, slots, clus_box, clus_pack, clus_count, blive, t_min: float,
                     nee: bool = False, amask: bool = False, inst=None):
    """Launch the Hopper kernel on the current stream; raises on any input
    it does not take or if the launch is refused."""
    out = launch(rays, slots, clus_box, clus_pack, clus_count, blive, t_min, nee, amask, inst)
    COUNTS.launches += 1
    mode = mode_name(nee, amask, inst is not None)
    COUNTS.modes[mode] = COUNTS.modes.get(mode, 0) + 1
    return out


def launch(rays, slots, clus_box, clus_pack, clus_count, blive, t_min: float,
           nee: bool = False, amask: bool = False, inst=None, fn=None):
    """One launch of the launcher `fn` (`bind` of a B3 library; None: the
    package's kernel) on the current stream, without counting it; raises as
    `fused_trace_cuda`."""
    tables = _check(rays, slots, clus_box, clus_pack, clus_count, blive, inst)
    if not rays.is_cuda:
        raise ValueError("fused_trace_cuda needs CUDA tensors")
    for name, a in [("rays", rays)] + tables:
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = rays.shape[0]
    if n >= 2 ** 31 // 8:
        raise ValueError(f"{n} rays overflow the kernel's int indexing")
    fn = fn or _library()
    out = torch.empty((n, 8), dtype=torch.float32, device=rays.device)
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream().cuda_stream
        inst_ptrs = [None] * 4 if inst is None else [a.data_ptr() for a in inst]
        err = fn(rays.data_ptr(), slots.data_ptr(), int(n), clus_box.data_ptr(),
                 int(clus_box.shape[1]), clus_pack.data_ptr(), clus_count.data_ptr(),
                 int(clus_count.shape[0]), int(clus_pack.shape[2] // 3), *inst_ptrs,
                 blive.data_ptr(), float(t_min), int(bool(nee)), int(bool(amask)), out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"fused_trace launch failed: cudaError {err}")
    return out


def fused_trace(rays, slots, clus_box, clus_pack, clus_count, blive, t_min: float,
                nee: bool = False, amask: bool = False, inst=None):
    """Closest hit (or, with `nee`, any hit; with `amask`, culled by the
    alpha masks; with `inst`, over instance clusters) of presorted `rays`
    [Np, 8] with their presort `slots` [Np, 4]; see the module docstring.
    CUDA tensors go to the kernel, CPU tensors to the plain twin."""
    refuse_grad("fused_trace", rays, clus_box, clus_pack, inst)
    if rays.is_cuda:
        return fused_trace_cuda(rays, slots, clus_box, clus_pack, clus_count, blive, t_min, nee, amask,
                                inst)
    return fused_trace_plain(rays, slots, clus_box, clus_pack, clus_count, blive, t_min, nee, amask,
                             inst)
