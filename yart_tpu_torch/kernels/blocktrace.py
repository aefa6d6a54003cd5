"""B7a and B7b: the round-based block trace's select and test steps —
Hopper kernels and plain twins.

`select_clusters` and `test_clusters` are the entry points. For tensors on
a CUDA device they launch the hand-written kernels in
`csrc/select_clusters.cu` and `csrc/test_clusters.cu` (which replace
`yart_tpu/kernels/pallas_blocktrace.py` `select_clusters_pallas` and
`test_clusters_pallas`) and raise if they cannot; for CPU tensors they run
`select_clusters_plain` and `test_clusters_plain`, the same arithmetic in
plain PyTorch. There is no fallback from one to the other.

Both work on blocks of BLOCK = 128 consecutive rows of `rays` [Np, 8] f32
(o3, d3, t_cur, floor), Np a multiple of 128.

B7a `select_clusters(rays, clus_box, w_key, act, k, t_min)`. Per active
block (act[b] != 0) and per cluster column j of `clus_box` [8, cpad]
(lo.xyz, hi.xyz, pad; pad boxes at +3e38), the slab entry of every ray of
the block (`_entry_chunk`, pallas_blocktrace.py:61-83):

    ia = 1 / where(|d| < 1e-20, +-1e-20, d),  x0 = lo ia - o ia,  x1 likewise
    ent = max over axes of min(x0, x1), ext = min over axes of max(x0, x1)
    e = max(ent, t_min); hit: ext >= e, e < t_cur, ext > floor
    entry = e on a hit, F32_MAX otherwise

with NaN-propagating min and max. The cluster's key is
(f32_bits(min entry over the block's rays) & ~ID_MASK) | j, or KEY_DEAD
where that minimum is F32_MAX or the key lies below the block's window
w_key[b] (signed int32; the first round passes -2^31). The outputs are the
K smallest keys in ascending order: ids [n_blocks, K] int32 (their cluster
ids, -1 past the last live key), bound_key [n_blocks] (the smallest key
left after the K, KEY_DEAD if none) and n_live [n_blocks] (the live ids).
An inactive block gives ids -1, bound_key KEY_DEAD and n_live 0. The
outputs are integers and the kernel repeats the twin's float operations
one by one (--fmad=false), so the two agree exactly.

B7b `test_clusters(rays, clus_pack, live, first, ids, c, k, t_min,
counts)`. Per block b the slots s = 0..K-1 run in order; `live`,
`first` and `ids` [n_blocks * K] int32 hold each slot's flag, first
triangle and cluster row of `clus_pack` [n_clus, 8, 3C]. Each ray starts at
(t = t_cur, u = v = back = 0, tri = -1). A live slot tests the ray against
the cluster's C columns with the plane + barycentric test of
`_test_kernel` (pallas_blocktrace.py:202-262), dot products formed
(x r0 + y r1) + z r2:

    t = (cn - no) / nd,  u = (uo + t ud) - cu,  v = (vo + t vd) - cv
    valid: |nd| >= EPS_DET, 0 <= u <= 1, v >= 0, u + v <= 1,
           t > t_min, t > floor, t < the ray's current t,
           column < counts[cluster row]

and takes the lowest column of least t (F32_MAX where invalid); the ray's
row becomes (t, u, v, back = nd > 0, tri = first + column) only if that t
is strictly below its current t. u and v are taken as the TPU kernel's
masked sum takes them, which turns a picked -0.0 into +0.0. Output
[Np, 8] f32: t, u, v, back (0/1), tri (int32 bits) and three zero columns.
Ties: within a slot the lowest column wins, across slots the earlier slot
(strict <); the fused path's B3 breaks bit-equal t by the lowest triangle
index instead, so the two traversals may name different triangles there.
`counts` [n_clus] int32 holds each cluster row's triangle count
(render/blocktrace.py `cluster_counts`), and the kernel tests only those
real columns. A scene's columns past the count are zeros (scene/clusters.py
`woop_rows`), which |nd| >= EPS_DET rejects, so on a scene's packs the
result is the same as with every count C.

`COUNTS_SELECT` and `COUNTS_TEST` record kernel launches and plain-twin
calls on CUDA tensors. `prepare_select` and `prepare_test` check a call and
return a `build.Launch` of a bound library's kernel (`bind_select` /
`bind_test`; by default the package's), uncounted, for the card tools;
`select_clusters_cuda(..., stats=)` also takes each block's live rays,
kept boxes and live keys.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yart_tpu_torch.kernels.build import Counts, Launch, load
from yart_tpu_torch.kernels.presort import ID_MASK, KEY_DEAD, MAX_CLUSTERS

BLOCK = 128  # rays per block
MAX_K = 128  # slots per block and round (the TPU kernel's lane width)
EPS_DET = 1e-12
F32_MAX = 3.0e38
PLAIN_BUDGET = 1 << 22  # elements of one [blocks, rays, columns] plain-twin chunk

COUNTS_SELECT = Counts()
COUNTS_TEST = Counts()


def bind_select(lib):
    """`select_clusters_launch` of B7a library `lib`, typed."""
    fn = lib.select_clusters_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int,  # rays, n_blocks
        ctypes.c_void_p, ctypes.c_int,  # clus_box, cpad
        ctypes.c_void_p, ctypes.c_void_p,  # w_key, act
        ctypes.c_int, ctypes.c_float,  # k, t_min
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ids, bound_key, n_live
        ctypes.c_void_p,  # stats (or null)
        ctypes.c_void_p,  # stream
    ]
    return fn


def bind_test(lib):
    """`test_clusters_launch` of B7b library `lib`, typed."""
    fn = lib.test_clusters_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int,  # rays, n_blocks
        ctypes.c_void_p, ctypes.c_int,  # clus_pack, c
        ctypes.c_void_p,  # counts
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # live, first, ids
        ctypes.c_int, ctypes.c_float,  # k, t_min
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # stream
    ]
    return fn


@functools.cache  # loaded and bound once a process: `load` hashes the sources
def _select_fn():
    return bind_select(load("select_clusters")[0])


@functools.cache  # loaded and bound once a process: `load` hashes the sources
def _test_fn():
    return bind_test(load("test_clusters")[0])


def _check_rays(rays):
    if rays.dim() != 2 or rays.shape[1] != 8 or rays.shape[0] % BLOCK:
        raise ValueError(f"rays must be [Np, 8] with Np a multiple of {BLOCK}, got {tuple(rays.shape)}")
    if rays.dtype != torch.float32:
        raise TypeError(f"rays must be float32, got {rays.dtype}")


def _check_ints(n: int, dev, **arrays):
    for name, a in arrays.items():
        if a.shape != (n,) or a.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 [{n}], got {a.dtype} {tuple(a.shape)}")
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, rays on {dev}")


def _check_select(rays, clus_box, w_key, act, k):
    _check_rays(rays)
    if clus_box.dim() != 2 or clus_box.shape[0] != 8 or not 0 < clus_box.shape[1] <= MAX_CLUSTERS:
        raise ValueError(f"clus_box must be [8, cpad] with 0 < cpad <= {MAX_CLUSTERS} (the key's "
                         f"cluster-id bits), got {tuple(clus_box.shape)}")
    if clus_box.dtype != torch.float32:
        raise TypeError(f"clus_box must be float32, got {clus_box.dtype}")
    if clus_box.device != rays.device:
        raise ValueError(f"clus_box is on {clus_box.device}, rays on {rays.device}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside 1..{MAX_K}")
    _check_ints(rays.shape[0] // BLOCK, rays.device, w_key=w_key, act=act)


def _check_test(rays, clus_pack, live, first, ids, c, k, counts):
    _check_rays(rays)
    if clus_pack.dim() != 3 or clus_pack.shape[1] != 8 or clus_pack.shape[2] != 3 * c:
        raise ValueError(f"clus_pack must be [n_clus, 8, 3C] with C={c}, got {tuple(clus_pack.shape)}")
    if clus_pack.dtype != torch.float32:
        raise TypeError(f"clus_pack must be float32, got {clus_pack.dtype}")
    if clus_pack.device != rays.device:
        raise ValueError(f"clus_pack is on {clus_pack.device}, rays on {rays.device}")
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    _check_ints(rays.shape[0] // BLOCK * k, rays.device, live=live, first=first, ids=ids)
    _check_ints(clus_pack.shape[0], rays.device, counts=counts)


def block_entries(r, clus_box, t_min: float):
    """Slab entry of rays r [nb, B, 8] into every box of clus_box [8, cpad]:
    [nb, B, cpad], F32_MAX where the ray cannot hit inside the box."""
    o, d = r[..., 0:3], r[..., 3:6]
    ia = 1.0 / torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
    oia = o * ia
    ent = ext = None
    for a in range(3):
        x0 = clus_box[a] * ia[..., a : a + 1] - oia[..., a : a + 1]
        x1 = clus_box[a + 3] * ia[..., a : a + 1] - oia[..., a : a + 1]
        a0 = torch.minimum(x0, x1)
        a1 = torch.maximum(x0, x1)
        ent = a0 if ent is None else torch.maximum(ent, a0)
        ext = a1 if ext is None else torch.minimum(ext, a1)
    e = torch.maximum(ent, torch.tensor(t_min, dtype=torch.float32, device=r.device))
    hit = (ext >= e) & (e < r[..., 6:7]) & (ext > r[..., 7:8])
    return torch.where(hit, e, F32_MAX)


def select_clusters_plain(rays, clus_box, w_key, act, k: int, t_min: float):
    """Plain PyTorch twin of B7a. Returns (ids, bound_key, n_live). It sweeps
    only the active blocks, in chunks of blocks."""
    _check_select(rays, clus_box, w_key, act, k)
    if rays.is_cuda:
        COUNTS_SELECT.plain_cuda += 1
    dev = rays.device
    n_blocks, cpad = rays.shape[0] // BLOCK, clus_box.shape[1]
    ids = torch.full((n_blocks, k), -1, dtype=torch.int32, device=dev)
    bound_key = torch.full((n_blocks,), KEY_DEAD, dtype=torch.int32, device=dev)
    n_live = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
    blocks = torch.nonzero(act != 0)[:, 0]
    cid = torch.arange(cpad, dtype=torch.int32, device=dev)
    kk = min(k + 1, cpad)  # the K keys and the bound after them
    step = max(1, PLAIN_BUDGET // (BLOCK * cpad))
    for b0 in range(0, blocks.numel(), step):
        b = blocks[b0 : b0 + step]
        emin = block_entries(rays.view(n_blocks, BLOCK, 8)[b], clus_box, t_min).amin(dim=1)
        key = (emin.view(torch.int32) & ~ID_MASK) | cid
        key = torch.where((emin < F32_MAX) & (key >= w_key[b, None]), key, KEY_DEAD)
        top = torch.topk(key, kk, dim=1, largest=False, sorted=True).values
        sel = top[:, :k]
        got = sel != KEY_DEAD
        ids[b, : sel.shape[1]] = torch.where(got, sel & ID_MASK, -1)
        n_live[b] = got.sum(dim=1, dtype=torch.int32)
        if kk > k:
            bound_key[b] = top[:, k]
    return ids, bound_key, n_live


def _plus_zero(a):
    """a with -0.0 turned into +0.0 (the TPU kernel's masked-sum pick)."""
    return torch.where(a == 0.0, 0.0, a)


def test_clusters_plain(rays, clus_pack, live, first, ids, c: int, k: int, t_min: float, counts):
    """Plain PyTorch twin of B7b: [Np, 8] f32. Slot after slot, it tests
    the blocks whose slot is live, in chunks of blocks; a column at or past
    its cluster's count is never valid."""
    _check_test(rays, clus_pack, live, first, ids, c, k, counts)
    if rays.is_cuda:
        COUNTS_TEST.plain_cuda += 1
    dev = rays.device
    n = rays.shape[0]
    n_blocks = n // BLOCK
    out = torch.zeros((n, 8), dtype=torch.float32, device=dev)
    out[:, 0] = rays[:, 6]
    out.view(torch.int32)[:, 4] = -1
    out3 = out.view(n_blocks, BLOCK, 8)
    rays3 = rays.view(n_blocks, BLOCK, 8)
    live2, first2, ids2 = live.view(n_blocks, k), first.view(n_blocks, k), ids.view(n_blocks, k)
    step = max(1, PLAIN_BUDGET // (BLOCK * 3 * c))
    col = torch.arange(c, device=dev)
    for s in range(k):
        blocks = torch.nonzero(live2[:, s] != 0)[:, 0]
        for b0 in range(0, blocks.numel(), step):
            b = blocks[b0 : b0 + step]
            r, old = rays3[b], out3[b]  # [nb, B, 8]
            pack = clus_pack[ids2[b, s].long(), 0:4]  # [nb, 4, 3C]
            r0, r1, r2, r3 = (pack[:, None, i, :] for i in range(4))  # [nb, 1, 3C]
            ox, oy, oz, dx, dy, dz = (r[..., i : i + 1] for i in range(6))  # [nb, B, 1]
            floor, t_best = r[..., 7:8], old[..., 0:1]
            ro = ox * r0 + oy * r1 + oz * r2  # [nb, B, 3C], the kernel's order
            rd = dx * r0 + dy * r1 + dz * r2
            no, uo, vo = ro[..., :c], ro[..., c : 2 * c], ro[..., 2 * c :]
            nd, ud, vd = rd[..., :c], rd[..., c : 2 * c], rd[..., 2 * c :]
            cn, cu, cv = r3[..., :c], r3[..., c : 2 * c], r3[..., 2 * c :]
            t = (cn - no) / nd
            u = uo + t * ud - cu
            v = vo + t * vd - cv
            valid = ((nd.abs() >= EPS_DET) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
                     & (t > t_min) & (t > floor) & (t < t_best) & (col < counts[ids2[b, s].long()][:, None, None]))
            tbig = torch.where(valid, t, F32_MAX)
            pick = torch.argmin(tbig, dim=2, keepdim=True)  # the lowest column of least t
            take = lambda a: a.gather(2, pick)
            bt = take(tbig)
            tri = (first2[b, s][:, None, None] + pick.to(torch.int32)).view(torch.float32)
            new = torch.cat([bt, _plus_zero(take(u)), _plus_zero(take(v)), (take(nd) > 0.0).float(), tri,
                             torch.zeros_like(old[..., 5:8])], dim=2)
            out3[b] = torch.where(bt < t_best, new, old)
    return out


def prepare_select(rays, clus_box, w_key, act, k: int, t_min: float, stats=None, fn=None) -> Launch:
    """Check a B7a call and allocate its outputs; returns the `Launch` that
    runs the launcher `fn` (`bind_select` of a B7a library; None: the
    package's kernel) on the current stream, uncounted, giving (ids,
    bound_key, n_live). `stats`, int32 [n_blocks, 3] or None, receives each
    block's live rays, kept boxes and live keys. Raises on any input the
    kernel does not take."""
    _check_select(rays, clus_box, w_key, act, k)
    if not rays.is_cuda:
        raise ValueError("select_clusters_cuda needs CUDA tensors")
    for name, a in (("rays", rays), ("clus_box", clus_box), ("w_key", w_key), ("act", act)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_blocks = rays.shape[0] // BLOCK
    if stats is not None and (stats.shape != (n_blocks, 3) or stats.dtype != torch.int32
                              or stats.device != rays.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be contiguous int32 [{n_blocks}, 3] on {rays.device}")
    fn = fn or _select_fn()
    dev = rays.device
    ids = torch.empty((n_blocks, k), dtype=torch.int32, device=dev)
    bound_key = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    n_live = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    args = (rays.data_ptr(), int(n_blocks), clus_box.data_ptr(), int(clus_box.shape[1]), w_key.data_ptr(),
            act.data_ptr(), int(k), float(t_min), ids.data_ptr(), bound_key.data_ptr(), n_live.data_ptr(),
            None if stats is None else stats.data_ptr(), stream)
    return Launch("select_clusters", fn, args, (ids, bound_key, n_live), dev, (rays, clus_box, w_key, act, stats))


def prepare_test(rays, clus_pack, live, first, ids, c: int, k: int, t_min: float, counts, fn=None) -> Launch:
    """Check a B7b call and allocate its output; returns the `Launch` that
    runs the launcher `fn` (`bind_test` of a B7b library; None: the
    package's kernel) on the current stream, uncounted. Raises on any input
    the kernel does not take. `ids` must name a row of `clus_pack` on every
    live slot."""
    _check_test(rays, clus_pack, live, first, ids, c, k, counts)
    if not rays.is_cuda:
        raise ValueError("test_clusters_cuda needs CUDA tensors")
    for name, a in (("rays", rays), ("clus_pack", clus_pack), ("live", live), ("first", first), ("ids", ids),
                    ("counts", counts)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rays.data_ptr() % 16:
        raise ValueError("rays must be 16-byte aligned (the kernel loads its rows as float4)")
    if 2 * 12 * (-(-c // 4) * 4) * 4 > 227 * 1024:
        raise ValueError(f"C={c}: two buffers of the cluster rows do not fit in shared memory")
    fn = fn or _test_fn()
    out = torch.empty_like(rays)
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream().cuda_stream
    args = (rays.data_ptr(), int(rays.shape[0] // BLOCK), clus_pack.data_ptr(), int(c),
            counts.data_ptr(), live.data_ptr(), first.data_ptr(), ids.data_ptr(),
            int(k), float(t_min), out.data_ptr(), stream)
    return Launch("test_clusters", fn, args, out, rays.device, (rays, clus_pack, live, first, ids, counts))


def select_clusters_cuda(rays, clus_box, w_key, act, k: int, t_min: float, stats=None):
    """Launch B7a on the current stream (counted); raises on any input it
    does not take or if the launch is refused."""
    out = prepare_select(rays, clus_box, w_key, act, k, t_min, stats)()
    COUNTS_SELECT.launches += 1
    return out


def test_clusters_cuda(rays, clus_pack, live, first, ids, c: int, k: int, t_min: float, counts):
    """Launch B7b on the current stream (counted); raises on any input it
    does not take or if the launch is refused."""
    out = prepare_test(rays, clus_pack, live, first, ids, c, k, t_min, counts)()
    COUNTS_TEST.launches += 1
    return out


def select_clusters(rays, clus_box, w_key, act, k: int, t_min: float):
    """B7a: the K nearest candidate clusters of every active block. CUDA
    tensors go to the kernel, CPU tensors to the plain twin."""
    if rays.is_cuda:
        return select_clusters_cuda(rays, clus_box, w_key, act, k, t_min)
    return select_clusters_plain(rays, clus_box, w_key, act, k, t_min)


def test_clusters(rays, clus_pack, live, first, ids, c: int, k: int, t_min: float, counts):
    """B7b: closest hit of every ray over its block's live slots. CUDA
    tensors go to the kernel, CPU tensors to the plain twin."""
    if rays.is_cuda:
        return test_clusters_cuda(rays, clus_pack, live, first, ids, c, k, t_min, counts)
    return test_clusters_plain(rays, clus_pack, live, first, ids, c, k, t_min, counts)
