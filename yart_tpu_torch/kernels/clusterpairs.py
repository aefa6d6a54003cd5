"""B4: bin-trace's (ray, cluster) pair test — Hopper kernel and plain twin.

`cluster_pairs` is the entry point. For tensors on a CUDA device it
launches the hand-written kernel in `csrc/cluster_pairs.cu` (which replaces
`yart_tpu/kernels/pallas_cluster.py` `cluster_pairs_pallas`) and raises if
it cannot; for CPU tensors it runs `cluster_pairs_plain`, the same
arithmetic in plain PyTorch. There is no fallback from one to the other.

The pairs come laid out compactly: `x` [L, 8] f32 holds one row per live
pair (o3, d3, tmax, 0), the rows of one cluster consecutive, and `tiles`
[n_tiles, 4] int32 cuts them into tiles of at most TILE rows that share
one cluster: (cluster id, its first triangle, first row, row count). The
tiles cover the rows 0..L-1 in order, each row once (`_check_tiles`),
so no row is padding. Each row is tested against the first
`clus_count[cluster]` triangle columns of `clus_pack[cluster]`
(scene/clusters.py `woop_rows`; the cluster's triangles, its other columns
are zero and can never be valid); its result is the valid column of least
t, the lowest column on a tie: (t, u, v, back, tri = first triangle +
column). A miss gives t = F32_MAX, u = v = 0, back = False, tri = -1.

Against the JAX package's `cluster_pairs_ref` / `cluster_pairs_pallas`,
which take the same pairs in blocks of 1024 rows padded with empty rows:
per pair, t and tri agree everywhere, and u, v and back wherever a pair
hits. On a pair that misses, the JAX functions return column 0's u, v and
back (their masked pick falls back to column 0); no caller reads them there
(bin-trace takes u, v and back only from a hit), and the port writes 0
instead, so its outputs hold no NaN. The JAX kernel's masked pick also
turns a picked -0.0 into +0.0; the kernel and the twin do the same, so u
and v are compared bit for bit.

`COUNTS` records kernel launches and plain-twin calls on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yart_tpu_torch.kernels.build import Counts, load

TILE = 256  # most pairs a tile (the kernel's 128 threads x 2), and bin-trace's tile (render/bintrace.py)
EPS_DET = 1e-12
F32_MAX = 3.0e38
PLAIN_BUDGET = 1 << 22  # pair rows x columns per plain-twin chunk

COUNTS = Counts()


def bind(lib):
    """The launcher `cluster_pairs_launch` of a loaded B4 library, its C
    signature declared (also for another build of a B4 source, as
    `python -m yart_tpu_torch.compare_kernels` loads them)."""
    fn = lib.cluster_pairs_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # clus_pack, clus_count, n_clus, c
        ctypes.c_void_p, ctypes.c_int,  # tiles, n_tiles
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float,  # x, n_rows, t_min
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # t, u, v
        ctypes.c_void_p, ctypes.c_void_p,  # back, tri
        ctypes.c_void_p,  # stream
    ]
    return fn


@functools.cache
def _library():
    """The package kernel's launcher, loaded once a process: `load` hashes
    the sources, ~0.15 ms a call on the card's host."""
    return bind(load("cluster_pairs")[0])


def _check(clus_pack, clus_count, tiles, x, c):
    if clus_pack.dim() != 3 or clus_pack.shape[1] != 8 or clus_pack.shape[2] != 3 * c:
        raise ValueError(f"clus_pack must be [n_clus, 8, 3C] with C={c}, got {tuple(clus_pack.shape)}")
    if clus_count.shape != clus_pack.shape[:1] or clus_count.dtype != torch.int32:
        raise ValueError(f"clus_count must be int32 [{clus_pack.shape[0]}], got {clus_count.dtype} "
                         f"{tuple(clus_count.shape)}")
    if x.dim() != 2 or x.shape[1] != 8:
        raise ValueError(f"x must be [L, 8], got {tuple(x.shape)}")
    if tiles.dim() != 2 or tiles.shape[1] != 4 or tiles.dtype != torch.int32:
        raise ValueError(f"tiles must be int32 [n_tiles, 4], got {tiles.dtype} {tuple(tiles.shape)}")
    for name, a in (("clus_pack", clus_pack), ("x", x)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
    for name, a in (("clus_pack", clus_pack), ("clus_count", clus_count), ("tiles", tiles)):
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")


def _check_tiles(clus_pack, tiles, x):
    """The tile table covers x's rows in order, each row once, with valid
    cluster ids (one device sync)."""
    cid, row0, cnt = tiles[:, 0], tiles[:, 2], tiles[:, 3]
    ok = ((cnt >= 1) & (cnt <= TILE) & (row0 == torch.cumsum(cnt, 0) - cnt)
          & (cid >= 0) & (cid < clus_pack.shape[0])).all() & (cnt.sum() == x.shape[0])
    if not bool(ok):
        raise ValueError(f"tiles must cover the {x.shape[0]} pair rows in order, each row once, with "
                         f"1..{TILE} rows a tile and cluster ids below {clus_pack.shape[0]}")


def _pair_test(tri, x, c: int, t_min: float, n_cols):
    """`_pair_test` + `_pair_test_from_proj` per pair row: tri [R, 4, 3C]
    each row's cluster pack rows 0-3, x [R, 8], n_cols [R] the columns to
    test. Returns (t, u, v, nd, col) of the closest valid column per row,
    t = F32_MAX and col = 0 where none is valid."""
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
             & (t > t_min) & (t < tmax)
             & (torch.arange(c, device=x.device)[None, :] < n_cols[:, None]))
    # The first minimum: the lowest column of least t (torch.argmin's rule).
    tbig = torch.where(valid, t, F32_MAX)
    col = torch.argmin(tbig, dim=1, keepdim=True)
    take = lambda a: a.gather(1, col)[:, 0]
    return take(tbig), take(u), take(v), take(nd), col[:, 0]


def cluster_pairs_plain(clus_pack, clus_count, tiles, x, c: int, t_min: float):
    """Plain PyTorch twin of the kernel. Returns (t, u, v, back, tri), each
    [L]. It tests only the rows with tmax > t_min (no other row can hit), in
    chunks, each row against its tile's cluster."""
    _check(clus_pack, clus_count, tiles, x, c)
    _check_tiles(clus_pack, tiles, x)
    if x.is_cuda:
        COUNTS.plain_cuda += 1
    n_rows = x.shape[0]
    dev = x.device
    t = torch.full((n_rows,), F32_MAX, dtype=torch.float32, device=dev)
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    back = torch.zeros(n_rows, dtype=torch.bool, device=dev)
    tri = torch.full((n_rows,), -1, dtype=torch.int32, device=dev)
    tile_of = torch.repeat_interleave(torch.arange(tiles.shape[0], device=dev), tiles[:, 3].long(),
                                      output_size=n_rows)
    rows = torch.nonzero(x[:, 6] > t_min)[:, 0]
    step = max(1, PLAIN_BUDGET // c)
    for r0 in range(0, rows.numel(), step):
        r = rows[r0 : r0 + step]
        tl = tiles[tile_of[r]]
        cid = tl[:, 0].long()
        bt, bu, bv, bnd, col = _pair_test(clus_pack[cid, 0:4], x[r], c, t_min, clus_count[cid])
        hit = bt < F32_MAX
        t[r] = torch.where(hit, bt, F32_MAX)
        # -0.0 -> +0.0, as the JAX kernel's masked pick leaves it.
        u[r] = torch.where(hit & (bu != 0.0), bu, 0.0)
        v[r] = torch.where(hit & (bv != 0.0), bv, 0.0)
        back[r] = hit & (bnd > 0.0)
        tri[r] = torch.where(hit, tl[:, 1] + col.to(torch.int32), -1)
    return t, u, v, back, tri


def launch(clus_pack, clus_count, tiles, x, c: int, t_min: float, fn=None):
    """One launch of the launcher `fn` (`bind` of a B4 library; None: the
    package's kernel) on the current stream, without counting it; raises on
    any input it does not take or if the launch is refused. The caller
    vouches for the tile table (`cluster_pairs_cuda` checks it), so the
    launch waits for nothing on the host; the kernel keeps every access
    within the rows and clusters all the same."""
    _check(clus_pack, clus_count, tiles, x, c)
    if not x.is_cuda:
        raise ValueError("cluster_pairs_cuda needs CUDA tensors")
    for name, a in (("clus_pack", clus_pack), ("clus_count", clus_count), ("tiles", tiles), ("x", x)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16 or tiles.data_ptr() % 16:
        raise ValueError("x and tiles must be 16-byte aligned (the kernel loads their rows as 16 bytes)")
    if 4 * 3 * c * 4 > 227 * 1024:
        raise ValueError(f"C={c}: the cluster rows do not fit in shared memory")
    n_rows = x.shape[0]
    if n_rows >= 2 ** 31 // 8:
        raise ValueError(f"{n_rows} pair rows overflow the kernel's int indexing")
    fn = fn or _library()
    dev = x.device
    t = torch.empty(n_rows, dtype=torch.float32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    back = torch.empty(n_rows, dtype=torch.bool, device=dev)
    tri = torch.empty(n_rows, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(clus_pack.data_ptr(), clus_count.data_ptr(), int(clus_pack.shape[0]), int(c), tiles.data_ptr(),
                 int(tiles.shape[0]), x.data_ptr(), int(n_rows),
                 float(t_min), t.data_ptr(), u.data_ptr(), v.data_ptr(), back.data_ptr(), tri.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"cluster_pairs launch failed: cudaError {err}")
    return t, u, v, back, tri


def cluster_pairs_cuda(clus_pack, clus_count, tiles, x, c: int, t_min: float):
    """Launch the Hopper kernel on the current stream (counted) after
    checking the tile table; raises on any input it does not take or if the
    launch is refused."""
    _check_tiles(clus_pack, tiles, x)
    out = launch(clus_pack, clus_count, tiles, x, c, t_min)
    COUNTS.launches += 1
    return out


def cluster_pairs(clus_pack, clus_count, tiles, x, c: int, t_min: float):
    """Closest hit of every pair row of `x` against its tile's cluster.
    CUDA tensors go to the kernel, CPU tensors to the plain twin."""
    if x.is_cuda:
        return cluster_pairs_cuda(clus_pack, clus_count, tiles, x, c, t_min)
    return cluster_pairs_plain(clus_pack, clus_count, tiles, x, c, t_min)
