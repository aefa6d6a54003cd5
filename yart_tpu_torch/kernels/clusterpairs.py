"""B4: bin-trace's (ray, cluster) pair test — Hopper kernel and plain twin.

`cluster_pairs` is the entry point. For tensors on a CUDA device it
launches the hand-written kernel in `csrc/cluster_pairs.cu` (which replaces
`yart_tpu/kernels/pallas_cluster.py` `cluster_pairs_pallas`) and raises if
it cannot; for CPU tensors it runs `cluster_pairs_plain`, the same
arithmetic in plain PyTorch. There is no fallback from one to the other.

Pairs come in blocks of B_PAIRS = 1024 that share one cluster: block i
tests its pair rows `x[i*1024:(i+1)*1024]` ([P, 8] f32: o3, d3, tmax, pad)
against the C triangle columns of `clus_pack[block_cid[i]]`
(scene/clusters.py `woop_rows`). Per pair the result is the valid column
of least t, the lowest column on a tie: (t, u, v, back, tri =
block_first[i] + column). A miss, and every pair of a block with
block_live[i] == 0, gives t = F32_MAX, u = v = 0, back = False, tri = -1.

Against the JAX package's `cluster_pairs_ref` / `cluster_pairs_pallas`:
t and tri agree everywhere, and u, v and back wherever a pair hits. On a
pair of a live block that misses, the JAX functions return column 0's u,
v and back (their masked pick falls back to column 0); no caller reads
them there (bin-trace takes u, v and back only from a hit), and the port
writes 0 instead, so its outputs hold no NaN. The JAX kernel's masked pick
also turns a picked -0.0 into +0.0; the kernel and the twin do the same, so
u and v are compared bit for bit.

`COUNTS` records kernel launches and plain-twin calls on CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from yart_tpu_torch.kernels.build import Counts, load

B_PAIRS = 1024  # pairs per block, all against one cluster
EPS_DET = 1e-12
F32_MAX = 3.0e38
PLAIN_BUDGET = 1 << 22  # pair rows x columns per plain-twin chunk

COUNTS = Counts()


def _library():
    lib, _ = load("cluster_pairs")
    fn = lib.cluster_pairs_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int,  # clus_pack, c
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # block cid, first, live, n_blocks
        ctypes.c_void_p, ctypes.c_float,  # x, t_min
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # t, u, v
        ctypes.c_void_p, ctypes.c_void_p,  # back, tri
        ctypes.c_void_p,  # stream
    ]
    return fn


def _check(clus_pack, block_cid, block_first, block_live, x, c):
    n_blocks = block_cid.shape[0]
    if clus_pack.dim() != 3 or clus_pack.shape[1] != 8 or clus_pack.shape[2] != 3 * c:
        raise ValueError(f"clus_pack must be [n_clus, 8, 3C] with C={c}, got {tuple(clus_pack.shape)}")
    if x.shape != (n_blocks * B_PAIRS, 8):
        raise ValueError(f"x must be [{n_blocks} * {B_PAIRS}, 8], got {tuple(x.shape)}")
    for name, a in (("block_cid", block_cid), ("block_first", block_first), ("block_live", block_live)):
        if a.shape != (n_blocks,) or a.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 [{n_blocks}], got {a.dtype} {tuple(a.shape)}")
    for name, a in (("clus_pack", clus_pack), ("x", x)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
    for name, a in (("clus_pack", clus_pack), ("block_cid", block_cid), ("block_first", block_first),
                    ("block_live", block_live)):
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")


def _pair_test(tri, x, c: int, t_min: float):
    """`_pair_test` + `_pair_test_from_proj` per pair row: tri [R, 4, 3C]
    each row's cluster pack rows 0-3, x [R, 8]. Returns (t, u, v, nd, col)
    of the closest valid column per row, t = F32_MAX and col = 0 where none
    is valid."""
    r0, r1, r2, r3 = tri.unbind(1)  # [R, 3C]
    ox, oy, oz, dx, dy, dz, tmax = (x[:, i : i + 1] for i in range(7))  # [R, 1]
    ro = ox * r0 + oy * r1 + oz * r2  # [R, 3C], the kernel's order
    rd = dx * r0 + dy * r1 + dz * r2
    no, uo, vo = ro[:, :c], ro[:, c : 2 * c], ro[:, 2 * c :]
    nd, ud, vd = rd[:, :c], rd[:, c : 2 * c], rd[:, 2 * c :]
    cn, cu, cv = r3[:, :c], r3[:, c : 2 * c], r3[:, 2 * c :]
    t = (cn - no) / nd
    u = uo + t * ud - cu
    v = vo + t * vd - cv
    valid = ((nd.abs() >= EPS_DET) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > t_min) & (t < tmax))
    # The first minimum: the lowest column of least t (torch.argmin's rule).
    tbig = torch.where(valid, t, F32_MAX)
    col = torch.argmin(tbig, dim=1, keepdim=True)
    take = lambda a: a.gather(1, col)[:, 0]
    return take(tbig), take(u), take(v), take(nd), col[:, 0]


def cluster_pairs_plain(clus_pack, block_cid, block_first, block_live, x, c: int, t_min: float):
    """Plain PyTorch twin of the kernel. Returns (t, u, v, back, tri), each
    [P]. It tests only the rows of live blocks with tmax > t_min (no other
    row can hit), in chunks, each row against its block's cluster."""
    _check(clus_pack, block_cid, block_first, block_live, x, c)
    if x.is_cuda:
        COUNTS.plain_cuda += 1
    p = x.shape[0]
    dev = x.device
    t = torch.full((p,), F32_MAX, dtype=torch.float32, device=dev)
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    back = torch.zeros(p, dtype=torch.bool, device=dev)
    tri = torch.full((p,), -1, dtype=torch.int32, device=dev)
    rows = torch.nonzero((x[:, 6] > t_min) & (block_live != 0).repeat_interleave(B_PAIRS))[:, 0]
    step = max(1, PLAIN_BUDGET // c)
    for r0 in range(0, rows.numel(), step):
        r = rows[r0 : r0 + step]
        blk = r // B_PAIRS
        bt, bu, bv, bnd, col = _pair_test(clus_pack[block_cid[blk], 0:4], x[r], c, t_min)
        hit = bt < F32_MAX
        t[r] = torch.where(hit, bt, F32_MAX)
        # -0.0 -> +0.0, as the JAX kernel's masked pick leaves it.
        u[r] = torch.where(hit & (bu != 0.0), bu, 0.0)
        v[r] = torch.where(hit & (bv != 0.0), bv, 0.0)
        back[r] = hit & (bnd > 0.0)
        tri[r] = torch.where(hit, block_first[blk] + col.to(torch.int32), -1)
    return t, u, v, back, tri


def cluster_pairs_cuda(clus_pack, block_cid, block_first, block_live, x, c: int, t_min: float):
    """Launch the Hopper kernel on the current stream; raises on any input
    it does not take or if the launch is refused."""
    _check(clus_pack, block_cid, block_first, block_live, x, c)
    if not x.is_cuda:
        raise ValueError("cluster_pairs_cuda needs CUDA tensors")
    for name, a in (("clus_pack", clus_pack), ("block_cid", block_cid), ("block_first", block_first),
                    ("block_live", block_live), ("x", x)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel loads its rows as float4)")
    if 4 * 3 * c * 4 > 227 * 1024:
        raise ValueError(f"C={c}: the cluster rows do not fit in shared memory")
    n_blocks = block_cid.shape[0]
    p = n_blocks * B_PAIRS
    fn = _library()
    dev = x.device
    t = torch.empty(p, dtype=torch.float32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    back = torch.empty(p, dtype=torch.bool, device=dev)
    tri = torch.empty(p, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            clus_pack.data_ptr(), int(c), block_cid.data_ptr(), block_first.data_ptr(),
            block_live.data_ptr(), int(n_blocks), x.data_ptr(), float(t_min), t.data_ptr(),
            u.data_ptr(), v.data_ptr(), back.data_ptr(), tri.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"cluster_pairs launch failed: cudaError {err}")
    COUNTS.launches += 1
    return t, u, v, back, tri


def cluster_pairs(clus_pack, block_cid, block_first, block_live, x, c: int, t_min: float):
    """Closest hit of every pair row of `x` against its block's cluster.
    CUDA tensors go to the kernel, CPU tensors to the plain twin."""
    if x.is_cuda:
        return cluster_pairs_cuda(clus_pack, block_cid, block_first, block_live, x, c, t_min)
    return cluster_pairs_plain(clus_pack, block_cid, block_first, block_live, x, c, t_min)
