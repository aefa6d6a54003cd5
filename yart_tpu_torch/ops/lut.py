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
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

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


def _ref_index(x, n: int):
    """(idx, frac) with the reference's LUT indexing (see module doc)."""
    xo = x * (n - 1.0)
    # NaN coordinates index bin 0 (their frac keeps the NaN); never let a
    # NaN reach the integer cast.
    safe = torch.nan_to_num(xo, nan=0.0)
    idx = torch.where(
        safe < 0.0,
        n - 2,
        torch.clamp(safe, 0.0, n - 2.0).to(torch.int64),
    )
    return idx, xo - idx.to(xo.dtype)


def fetch_1d_ref(tab, x):
    i, f = _ref_index(x, tab.shape[0])
    return tab[i] * (1.0 - f) + tab[i + 1] * f


def fetch_2d_ref(tab, x0, x1):
    n0, n1 = tab.shape
    i0, f0 = _ref_index(x0, n0)
    i1, f1 = _ref_index(x1, n1)
    flat = tab.reshape(-1)

    def row(j):  # lerp along axis 0 at column j
        return flat[i0 * n1 + j] * (1.0 - f0) + flat[(i0 + 1) * n1 + j] * f0

    return row(i1) * (1.0 - f1) + row(i1 + 1) * f1


def fetch_3d_ref(tab, x0, x1, x2):
    n0, n1, n2 = tab.shape
    i0, f0 = _ref_index(x0, n0)
    i1, f1 = _ref_index(x1, n1)
    i2, f2 = _ref_index(x2, n2)
    flat = tab.reshape(-1)
    s0 = n1 * n2

    def a(j, k):  # lerp along axis 0 at (j, k)
        off = j * n2 + k
        return flat[i0 * s0 + off] * (1.0 - f0) + flat[(i0 + 1) * s0 + off] * f0

    w1 = (1.0 - f1, f1)
    w2 = (1.0 - f2, f2)
    out = None
    for dj in (0, 1):
        for dk in (0, 1):
            term = a(i1 + dj, i2 + dk) * w1[dj] * w2[dk]
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
    f0 = _glass_f0(torch.where(inv, 1.0 / torch.clamp_min(ior, 1e-6), ior))
    v_n = fetch_3d_ref(tables["ggx_glass_E"], f0, cos_theta, r)
    v_i = fetch_3d_ref(tables["ggx_glass_inv_E"], f0, cos_theta, r)
    return torch.where(inv, v_i, v_n)
