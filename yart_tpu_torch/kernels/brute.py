"""B1: brute-force closest-hit intersection — Hopper kernel and plain twin.

`brute_intersect` is the entry point. For tensors on a CUDA device it
launches the hand-written kernel in `csrc/brute_intersect.cu` (which
replaces `yart_tpu/kernels/pallas_intersect.py` `brute_pallas`) and raises
if it cannot; for CPU tensors it runs `brute_plain`, the same arithmetic
in plain PyTorch. There is no fallback from one to the other.

`brute_plain` performs `_mt_test`'s operations in the same order as the
kernel, one elementwise op at a time, and chunks both rays and triangles so
its [rays x triangles] intermediates stay bounded. Together with the
kernel's `--fmad=false` build the two agree bitwise on the card.

`prepare` checks a call and allocates its outputs, and returns the
`build.Launch` that launches it (timers bracket that launch alone).
`COUNTS` records kernel launches and plain-twin calls on CUDA tensors, so a
run can show which path it took.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yart_tpu_torch.kernels.build import Counts, Launch, load, refuse_grad

EPS_DET = 1e-12  # reference epsilon (math_base.hpp)
MAX_TRIS = 4096  # the dispatcher's cap for the brute path (render/intersect.py)
PLAIN_BUDGET = 1 << 22  # rays x triangles per plain-twin chunk

COUNTS = Counts()


def bind(lib):
    """The launcher `brute_intersect_launch` of a loaded B1 library, its C
    signature declared (also for another build of a B1 source, as
    `python -m yart_tpu_torch.compare_kernels` loads them)."""
    fn = lib.brute_intersect_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int,  # tri_pack, n_tris
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # o, d, t_max
        ctypes.c_int, ctypes.c_float,  # n, t_min
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # t, u, v
        ctypes.c_void_p, ctypes.c_void_p,  # back, tri
        ctypes.c_void_p,  # stream
    ]
    return fn


@functools.cache
def _library():
    """The package kernel's launcher, loaded once a process: `load` hashes
    the sources, ~0.15 ms a call on the card's host."""
    return bind(load("brute_intersect")[0])


def _check(tri_pack, o, d, t_max, n_tris):
    n = o.shape[0]
    if tri_pack.dim() != 2 or tri_pack.shape[1] != 12:
        raise ValueError(f"tri_pack must be [T, 12], got {tuple(tri_pack.shape)}")
    if not 0 <= n_tris <= tri_pack.shape[0]:
        raise ValueError(f"n_tris={n_tris} outside tri_pack's {tri_pack.shape[0]} rows")
    if o.shape != (n, 3) or d.shape != (n, 3) or t_max.shape != (n,):
        raise ValueError(
            f"o, d must be [N, 3] and t_max [N]; got {tuple(o.shape)}, "
            f"{tuple(d.shape)}, {tuple(t_max.shape)}"
        )
    for name, a in (("tri_pack", tri_pack), ("o", o), ("d", d), ("t_max", t_max)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != o.device:
            raise ValueError(f"{name} is on {a.device}, o on {o.device}")


def mt_test(ox, oy, oz, dx, dy, dz, p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z):
    """`_mt_test`'s Moller-Trumbore arithmetic, one elementwise op at a time
    in the kernel's order, on broadcastable per-axis operands (rays [L, 1],
    triangle corner p0 and edges e1, e2 [1, T]). Returns (det, u, v, t)."""
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = torch.reciprocal(torch.where(det.abs() < EPS_DET, 1.0, det))
    bx = ox - p0x
    by = oy - p0y
    bz = oz - p0z
    u = (bx * pvx + by * pvy + bz * pvz) * inv_det
    qvx = by * e1z - bz * e1y
    qvy = bz * e1x - bx * e1z
    qvz = bx * e1y - by * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    return det, u, v, tt


def brute_plain(tri_pack, o, d, t_max, n_tris: int, t_min: float):
    """Plain PyTorch twin of the kernel. Returns (t, u, v, back, tri); a miss
    keeps t = t_max, u = v = 0, back = False, tri = -1."""
    _check(tri_pack, o, d, t_max, n_tris)
    if o.is_cuda:
        COUNTS.plain_cuda += 1
    n = o.shape[0]
    bt = t_max.clone()
    bu = torch.zeros_like(t_max)
    bv = torch.zeros_like(t_max)
    bb = torch.zeros(n, dtype=torch.bool, device=o.device)
    bi = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    # Only lanes with t_max > t_min can hit (retired lanes carry -1).
    live = torch.nonzero(t_max > t_min)[:, 0]
    if live.numel() == 0 or n_tris == 0:
        return bt, bu, bv, bb, bi
    out = bt, bu, bv, bb, bi
    o, d = o[live], d[live]
    bt, bu, bv, bb, bi = (a[live] for a in out)
    n = live.numel()

    tri_chunk = min(n_tris, 256)
    lane_chunk = max(1, PLAIN_BUDGET // tri_chunk)
    tri = tri_pack[:n_tris]
    p0 = tri[:, 0:3]
    e1 = tri[:, 3:6] - p0
    e2 = tri[:, 6:9] - p0
    for l0 in range(0, n, lane_chunk):
        l1 = min(n, l0 + lane_chunk)
        ox, oy, oz = (o[l0:l1, k : k + 1] for k in range(3))
        dx, dy, dz = (d[l0:l1, k : k + 1] for k in range(3))
        for t0 in range(0, n_tris, tri_chunk):
            t1 = min(n_tris, t0 + tri_chunk)
            p0x, p0y, p0z = (p0[None, t0:t1, k] for k in range(3))
            e1x, e1y, e1z = (e1[None, t0:t1, k] for k in range(3))
            e2x, e2y, e2z = (e2[None, t0:t1, k] for k in range(3))
            det, u, v, tt = mt_test(ox, oy, oz, dx, dy, dz, p0x, p0y, p0z,
                                    e1x, e1y, e1z, e2x, e2y, e2z)

            cur = bt[l0:l1, None]
            valid = (
                (det.abs() >= EPS_DET)
                & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
                & (tt > t_min) & (tt < cur)
            )
            # First minimum = lowest triangle index among equal t, the
            # kernel's ascending strict-< rule.
            j = torch.argmin(torch.where(valid, tt, float("inf")), dim=1, keepdim=True)
            got = valid.gather(1, j)[:, 0]
            take = lambda a: a.gather(1, j)[:, 0]
            sl = slice(l0, l1)
            bt[sl] = torch.where(got, take(tt), bt[sl])
            bu[sl] = torch.where(got, take(u), bu[sl])
            bv[sl] = torch.where(got, take(v), bv[sl])
            bb[sl] = torch.where(got, take(det) < 0.0, bb[sl])
            bi[sl] = torch.where(got, (j[:, 0] + t0).to(torch.int32), bi[sl])
    for full, part in zip(out, (bt, bu, bv, bb, bi)):
        full[live] = part
    return out


def prepare(tri_pack, o, d, t_max, n_tris: int, t_min: float, fn=None) -> Launch:
    """Check a B1 call and allocate its outputs; returns the `Launch` that
    runs the launcher `fn` (`bind` of a B1 library; None: the package's
    kernel) on the current stream, uncounted. Raises on any input the
    kernel does not take."""
    _check(tri_pack, o, d, t_max, n_tris)
    if not o.is_cuda:
        raise ValueError("brute_cuda needs CUDA tensors")
    for name, a in (("tri_pack", tri_pack), ("o", o), ("d", d), ("t_max", t_max)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = o.shape[0]
    if n >= 2 ** 31 // 3:
        raise ValueError(f"{n} rays overflow the kernel's int indexing")
    fn = fn or _library()
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    back = torch.empty(n, dtype=torch.bool, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
    args = (tri_pack.data_ptr(), int(n_tris), o.data_ptr(), d.data_ptr(), t_max.data_ptr(), int(n),
            float(t_min), t.data_ptr(), u.data_ptr(), v.data_ptr(), back.data_ptr(), tri.data_ptr(), stream)
    return Launch("brute_intersect", fn, args, (t, u, v, back, tri), o.device)


def brute_cuda(tri_pack, o, d, t_max, n_tris: int, t_min: float):
    """Launch the Hopper kernel on the current stream (counted); raises on
    any input it does not take or if the launch is refused."""
    out = prepare(tri_pack, o, d, t_max, n_tris, t_min)()
    COUNTS.launches += 1
    return out


def brute_intersect(tri_pack, o, d, t_max, n_tris: int, t_min: float):
    """Closest hit of every ray against the first `n_tris` rows of
    `tri_pack` [T, 12]; o, d [N, 3], t_max [N] float32. CUDA tensors go to
    the kernel, CPU tensors to the plain twin."""
    refuse_grad("brute_intersect", tri_pack, o, d, t_max)
    if o.is_cuda:
        return brute_cuda(tri_pack, o, d, t_max, n_tris, t_min)
    return brute_plain(tri_pack, o, d, t_max, n_tris, t_min)
