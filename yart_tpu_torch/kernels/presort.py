"""B2: block-trace presort keys — Hopper kernel and plain twin.

`presort_keys` is the entry point. For tensors on a CUDA device it launches
the hand-written kernel in `csrc/presort_keys.cu` (which replaces
`yart_tpu/kernels/pallas_fusedtrace.py` `presort_keys_pallas`) and raises
if it cannot; for CPU tensors it runs `presort_plain`, the same arithmetic
in plain PyTorch. There is no fallback from one to the other.

Per ray (one row of `rays` [N, 8] f32: o3, d3, t_max, floor) it sweeps every
cluster box of `clus_box` [8, cpad] with the conservative slab test of
`_presort_body` (pallas_fusedtrace.py:927-974) and returns one int32 row:

    col 0     primary sort key   nothing | heavy | cid0 | cid1
    col 1-4   packed (entry bits & ~ID_MASK) | cid keys of the 4 nearest
              entered clusters, ascending, KEY_DEAD-padded
    col 5     entered-cluster count
    col 6     secondary sort key nothing | cid2 | cid3
    col 7     0

A ray with t_max <= 0 enters nothing, so its row is the dead row the TPU
kernel writes for a block whose rays are all retired; the per-ray rule
gives the same rows for any block composition. The outputs are integers
and the kernel (built with --fmad=false) repeats the twin's float
operations one by one, so the two agree exactly.

`COUNTS` records kernel launches and plain-twin calls on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yart_tpu_torch.kernels.build import Counts, load, refuse_grad

ID_BITS = 13  # cluster-id bits of a packed key (pallas_blocktrace.py:51)
ID_MASK = (1 << ID_BITS) - 1
KEY_DEAD = (1 << 31) - 1  # int32 max: no cluster
MAX_CLUSTERS = 1 << ID_BITS
N_SLOTS = 4  # nearest entered clusters per ray in the sort key
SKEY_HEAVY = 1 << (2 * ID_BITS)  # more than N_SLOTS clusters entered
SKEY_NOTHING = SKEY_HEAVY << 1  # no cluster entered (or a retired ray)
PLAIN_BUDGET = 1 << 22  # rays x clusters per plain-twin chunk

COUNTS = Counts()


def bind(lib):
    """The launcher `presort_keys_launch` of a loaded B2 library, its C
    signature declared (also for another build of a B2 source, as
    `python -m yart_tpu_torch.compare_kernels` loads them)."""
    fn = lib.presort_keys_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int,  # rays, n
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # clus_box, cpad, n_clus
        ctypes.c_float,  # t_min
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # stream
    ]
    return fn


@functools.cache
def _library():
    """The package kernel's launcher, loaded once a process: `load` hashes
    the sources, ~0.15 ms a call on the card's host."""
    return bind(load("presort_keys")[0])


def _check(rays, clus_box, n_clus):
    if rays.dim() != 2 or rays.shape[1] != 8:
        raise ValueError(f"rays must be [N, 8], got {tuple(rays.shape)}")
    if clus_box.dim() != 2 or clus_box.shape[0] != 8:
        raise ValueError(f"clus_box must be [8, cpad], got {tuple(clus_box.shape)}")
    if not 0 <= n_clus <= min(clus_box.shape[1], MAX_CLUSTERS):
        raise ValueError(f"n_clus={n_clus} outside clus_box's {clus_box.shape[1]} columns "
                         f"or the {MAX_CLUSTERS}-cluster cap")
    for name, a in (("rays", rays), ("clus_box", clus_box)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
    if clus_box.device != rays.device:
        raise ValueError(f"clus_box is on {clus_box.device}, rays on {rays.device}")


def sweep_bounds(o, d, boxes):
    """Conservative (entry, exit) of every box per ray, margins applied:
    o, d [R, 3], boxes [8, K] -> (e, xt) [R, K] (`_sweep_bounds` and the
    margins of `_presort_body`, in the kernels' operation order). Entries
    are >= t_min only after the caller's max with t_min."""
    safe = torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
    ia = 1.0 / safe
    oia = o * ia
    ent = ext = None
    for a in range(3):
        x0 = boxes[a][None, :] * ia[:, a : a + 1] - oia[:, a : a + 1]
        x1 = boxes[a + 3][None, :] * ia[:, a : a + 1] - oia[:, a : a + 1]
        a0 = torch.minimum(x0, x1)
        a1 = torch.maximum(x0, x1)
        ent = a0 if ent is None else torch.maximum(ent, a0)
        ext = a1 if ext is None else torch.minimum(ext, a1)
    return ent - (ent.abs() * 1e-6 + 1e-7), ext + (ext.abs() * 1e-6 + 1e-7)


def presort_plain(rays, clus_box, n_clus: int, t_min: float):
    """Plain PyTorch twin of the kernel: [N, 8] f32 rays -> [N, 8] int32."""
    _check(rays, clus_box, n_clus)
    if rays.is_cuda:
        COUNTS.plain_cuda += 1
    n = rays.shape[0]
    dev = rays.device
    out = torch.zeros((n, 8), dtype=torch.int32, device=dev)
    out[:, 0] = SKEY_NOTHING
    out[:, 1 : 1 + N_SLOTS] = KEY_DEAD
    out[:, 6] = SKEY_NOTHING
    live = torch.nonzero(rays[:, 6] > 0.0)[:, 0]
    if live.numel() == 0 or n_clus == 0:
        return out
    boxes = clus_box[:, :n_clus]
    cid = torch.arange(n_clus, dtype=torch.int32, device=dev)[None, :]
    chunk = max(1, PLAIN_BUDGET // n_clus)
    for c0 in range(0, live.numel(), chunk):
        idx = live[c0 : c0 + chunk]
        r = rays[idx]
        t0, floor = r[:, 6:7], r[:, 7:8]
        e, xt = sweep_bounds(r[:, 0:3], r[:, 3:6], boxes)
        e = torch.maximum(e, torch.tensor(t_min, dtype=torch.float32, device=dev))
        hit = (xt >= e) & (e < t0) & (xt > floor)
        key = torch.where(hit, (e.view(torch.int32) & ~ID_MASK) | cid, KEY_DEAD)
        k = min(N_SLOTS, n_clus)
        slots = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        if k < N_SLOTS:
            slots = torch.cat([slots, torch.full((slots.shape[0], N_SLOTS - k), KEY_DEAD,
                                                 dtype=torch.int32, device=dev)], dim=1)
        count = hit.sum(dim=1, dtype=torch.int32)
        nothing = slots[:, 0] == KEY_DEAD
        cids = slots & ID_MASK
        skey = torch.where(count > N_SLOTS, SKEY_HEAVY, 0) | (cids[:, 0] << ID_BITS) | cids[:, 1]
        skey2 = (cids[:, 2] << ID_BITS) | cids[:, 3]
        row = out[idx]
        row[:, 0] = torch.where(nothing, SKEY_NOTHING, skey)
        row[:, 1 : 1 + N_SLOTS] = slots
        row[:, 5] = count
        row[:, 6] = torch.where(nothing, SKEY_NOTHING, skey2)
        out[idx] = row
    return out


def launch(rays, clus_box, n_clus: int, t_min: float, fn=None):
    """One launch of the launcher `fn` (`bind` of a B2 library; None: the
    package's kernel) on the current stream, without counting it; raises on
    any input it does not take or if the launch is refused."""
    _check(rays, clus_box, n_clus)
    if not rays.is_cuda:
        raise ValueError("presort_cuda needs CUDA tensors")
    for name, a in (("rays", rays), ("clus_box", clus_box)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = rays.shape[0]
    if n >= 2 ** 31 // 8:
        raise ValueError(f"{n} rays overflow the kernel's int indexing")
    fn = fn or _library()
    out = torch.empty((n, 8), dtype=torch.int32, device=rays.device)
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rays.data_ptr(), int(n), clus_box.data_ptr(), int(clus_box.shape[1]),
                 int(n_clus), float(t_min), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"presort_keys launch failed: cudaError {err}")
    return out


def presort_cuda(rays, clus_box, n_clus: int, t_min: float):
    """Launch the Hopper kernel on the current stream (counted); raises on
    any input it does not take or if the launch is refused."""
    out = launch(rays, clus_box, n_clus, t_min)
    COUNTS.launches += 1
    return out


def presort_keys(rays, clus_box, n_clus: int, t_min: float):
    """Presort rows of `rays` [N, 8] against the first `n_clus` boxes of
    `clus_box` [8, cpad]. CUDA tensors go to the kernel, CPU tensors to the
    plain twin."""
    refuse_grad("presort_keys", rays, clus_box)
    if rays.is_cuda:
        return presort_cuda(rays, clus_box, n_clus, t_min)
    return presort_plain(rays, clus_box, n_clus, t_min)
