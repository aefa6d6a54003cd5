"""GGX multi-scatter energy LUT fetches (luts.hpp:33-187).

Port of the device side of `yart_tpu/ops/lut.py` and of
`yart_tpu/ops/gatherless.py` `ref_lerp_weights` / `fetch_*_ref`. The
tables are the JAX package's baked `yart_tpu/data/luts.npz`, read with
numpy by path. Plain indexing replaces the TPU's one-hot / hat-weight
contractions, with the reference's index arithmetic kept exactly:
idx = min(int(x * (n - 1)), n - 2), a NEGATIVE coordinate selects the TOP
bin (the oracle's x86 size_t wrap), and the lerp fraction stays UNCLAMPED,
so backside cosines extrapolate off the table edge instead of clamping.
That quirk is the reference's and is matched, not fixed.

Each fetch is a gather (the bin indices and the table entries around
them, which carry no gradient) and a lerp (differentiable in the
coordinates). Under a differentiable render's `remat="trace_lut"` the
gathers go through the bounce's `Residuals`, so the backward pass's
recomputation of a bounce reads them back instead of fetching again (the
JAX package's `named_residuals` / `checkpoint_name(..., "lut")` sites).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from yart_tpu_torch.ops.vecmath import maximum

NPZ_PATH = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "yart_tpu", "data", "luts.npz")
)


@functools.lru_cache(maxsize=None)
def _load_tables(device: str) -> dict:
    with np.load(NPZ_PATH) as z:
        return {
            k: torch.from_numpy(np.ascontiguousarray(z[k], np.float32)).to(device)
            for k in z.files
        }


def load_tables(device) -> dict:
    """All eight tables as float32 tensors on `device` (loaded once per
    device)."""
    return _load_tables(str(torch.device(device)))


class Residuals:
    """Values of one checkpointed bounce that its recomputation reads back
    instead of computing them again (the port's `checkpoint_name` sites).

    The first run of the bounce records each `fetch`'s result in call
    order; after `start()` the next run replays them in the same order.
    The bounce's code is deterministic in its calls, so the n-th fetch of a
    replay is the n-th of the record. With `record=False` it only runs
    the fetches (plain autograd keeps what it needs itself)."""

    def __init__(self, record: bool = True):
        self.record = record
        self.saved = []
        self.pos = None  # None while recording

    def start(self) -> bool:
        """Begin a run of the bounce; True if it is a replay."""
        if not self.saved and self.pos is None:
            return False
        self.pos = 0
        return True

    def fetch(self, fn):
        if not self.record:
            return fn()
        if self.pos is None:
            out = fn()
            self.saved.append(out)
            return out
        out = self.saved[self.pos]
        self.pos += 1
        return out


# The fetch recorder of the bounce being run, under `remat="trace_lut"`
# only (JAX lut.py `_NAME_RESIDUALS`); None runs every fetch.
_RESIDUALS = None


class named_residuals:
    """Route this module's table gathers (and the texture gathers of
    render/texture.py) through `res` while the block runs."""

    def __init__(self, res):
        self.res = res

    def __enter__(self):
        global _RESIDUALS
        self._prev = _RESIDUALS
        _RESIDUALS = self.res

    def __exit__(self, *exc):
        global _RESIDUALS
        _RESIDUALS = self._prev


def named(fn):
    """fn() under `torch.no_grad()`, through the active recorder: its
    outputs carry no gradient (indices, table entries), so a replay can
    stand in for it, and it saves nothing for a backward pass either way."""
    def run():
        with torch.no_grad():
            return fn()

    return run() if _RESIDUALS is None else _RESIDUALS.fetch(run)


def _ref_index(x, n: int):
    """The int64 bin index of x, by the reference's LUT indexing (see
    module doc)."""
    xo = x * (n - 1.0)
    # NaN coordinates index bin 0 (their frac keeps the NaN); never let a
    # NaN reach the integer cast.
    safe = torch.nan_to_num(xo, nan=0.0)
    idx = torch.where(
        safe < 0.0,
        n - 2,
        torch.clamp(safe, 0.0, n - 2.0).to(torch.int64),
    )
    return idx


def _frac(x, n: int, idx_f):
    return x * (n - 1.0) - idx_f


def _gather_1d(tab, x):
    i = _ref_index(x, tab.shape[0])
    return i.to(x.dtype), tab[i], tab[i + 1]


def fetch_1d_ref(tab, x):
    i, t0, t1 = named(lambda: _gather_1d(tab, x))
    f = _frac(x, tab.shape[0], i)
    return t0 * (1.0 - f) + t1 * f


def _gather_2d(tab, x0, x1):
    n0, n1 = tab.shape
    i0 = _ref_index(x0, n0)
    i1 = _ref_index(x1, n1)
    flat = tab.reshape(-1)
    # the corners (j0, j1) in the order the lerps read them
    corners = tuple(flat[(i0 + j0) * n1 + i1 + j1] for j1 in (0, 1) for j0 in (0, 1))
    return (i0.to(x0.dtype), i1.to(x1.dtype)) + corners


def fetch_2d_ref(tab, x0, x1):
    n0, n1 = tab.shape
    i0, i1, c00, c10, c01, c11 = named(lambda: _gather_2d(tab, x0, x1))
    f0 = _frac(x0, n0, i0)
    f1 = _frac(x1, n1, i1)
    row0 = c00 * (1.0 - f0) + c10 * f0  # lerp along axis 0 at column i1
    row1 = c01 * (1.0 - f0) + c11 * f0
    return row0 * (1.0 - f1) + row1 * f1


def _gather_3d(tab, x0, x1, x2):
    n0, n1, n2 = tab.shape
    i0 = _ref_index(x0, n0)
    i1 = _ref_index(x1, n1)
    i2 = _ref_index(x2, n2)
    flat = tab.reshape(-1)
    s0 = n1 * n2
    corners = tuple(flat[(i0 + j0) * s0 + (i1 + dj) * n2 + i2 + dk]
                    for dj in (0, 1) for dk in (0, 1) for j0 in (0, 1))
    return (i0.to(x0.dtype), i1.to(x1.dtype), i2.to(x2.dtype)) + corners


def fetch_3d_ref(tab, x0, x1, x2):
    n0, n1, n2 = tab.shape
    i0, i1, i2, *c = named(lambda: _gather_3d(tab, x0, x1, x2))
    f0 = _frac(x0, n0, i0)
    f1 = _frac(x1, n1, i1)
    f2 = _frac(x2, n2, i2)
    w1 = (1.0 - f1, f1)
    w2 = (1.0 - f2, f2)
    out = None
    for k, (dj, dk) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        a = c[2 * k] * (1.0 - f0) + c[2 * k + 1] * f0  # lerp along axis 0 at (i1 + dj, i2 + dk)
        term = a * w1[dj] * w2[dk]
        out = term if out is None else out + term
    return out


def ggx_e(tables, cos_theta, r):
    """ggxE (luts.hpp:34-45); axes [r][cos]."""
    return fetch_2d_ref(tables["ggx_E"], r, cos_theta)


def ggx_eavg(tables, r):
    """ggxEavg (luts.hpp:53-58)."""
    return fetch_1d_ref(tables["ggx_Eavg"], r)


def ggx_base_e(tables, f0, r, cos_theta):
    """ggxBaseE (luts.hpp:70-99); axes [f0][r][cos]."""
    return fetch_3d_ref(tables["ggx_base_E"], f0.expand_as(r), r, cos_theta)


def ggx_base_eavg(tables, f0, r):
    """ggxBaseEavg (luts.hpp:107-118); axes [f0][r]."""
    return fetch_2d_ref(tables["ggx_base_Eavg"], f0.expand_as(r), r)


def _glass_f0(ior):
    """Axis parametrization f0 = sqrt((ior-1)/(ior+1)), ior >= 1."""
    return torch.sqrt(((ior - 1.0) / (ior + 1.0)).abs())


def ggx_glass_e(tables, ior, r, cos_theta):
    """ggxGlassE (luts.hpp:127-160), branchless over the ior < 1 table;
    axes [f0][cos][r]."""
    inv = ior < 1.0
    f0 = _glass_f0(torch.where(inv, 1.0 / maximum(ior, 1e-6), ior))
    v_n = fetch_3d_ref(tables["ggx_glass_E"], f0, cos_theta, r)
    v_i = fetch_3d_ref(tables["ggx_glass_inv_E"], f0, cos_theta, r)
    return torch.where(inv, v_i, v_n)
