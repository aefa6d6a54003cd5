"""Piecewise-constant distributions: the 2D CDF form and alias tables.

Port of `yart_tpu/ops/distribution.py`: `Dist2D` with `build_dist2d`
(host, numpy), `sample_dist2d` and `pdf_dist2d` (device), the flat form of
the reference's `PiecewiseConstant2D` (src/math/sampling.hpp:118-196,
sampling.cpp:5-60) with the intra-bin offset fixed as the JAX package
fixes it; and `build_alias` (host) with `sample_alias_rows` (device),
through which the environment light samples. No render path uses
`Dist2D`, in either package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

ONE_MINUS_EPS = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


class Dist2D(NamedTuple):
    """Flattened piecewise-constant 2D distribution over [0, 1]^2.

    func [nv, nu] non-negative values; cond_cdf [nv, nu + 1] per-row
    conditional CDFs; cond_int [nv] per-row integrals; marg_cdf [nv + 1]
    the marginal CDF over rows; integral [] the total over [0, 1]^2."""

    func: torch.Tensor
    cond_cdf: torch.Tensor
    cond_int: torch.Tensor
    marg_cdf: torch.Tensor
    integral: torch.Tensor


def _build_cdf(f: np.ndarray):
    """Normalised CDFs along the last axis (float64, rounded to float32 at
    the end), uniform where a row integrates to 0 (sampling.hpp:135-140)."""
    n = f.shape[-1]
    cdf = np.concatenate([np.zeros(f.shape[:-1] + (1,), np.float64), np.cumsum(f, axis=-1) / n], axis=-1)
    integral = cdf[..., -1:].copy()
    uniform = np.broadcast_to(np.linspace(0.0, 1.0, n + 1, dtype=np.float64), cdf.shape)
    with np.errstate(invalid="ignore", divide="ignore"):
        norm = cdf / integral
    cdf = np.where(integral > 0.0, norm, uniform)
    return cdf.astype(np.float32), integral[..., 0].astype(np.float32)


def build_dist2d(func: np.ndarray, *, device) -> Dist2D:
    """Host build from a [nv, nu] table of values (their magnitudes are
    used); the tables land on `device`."""
    f = np.abs(np.asarray(func, np.float64))
    cond_cdf, cond_int = _build_cdf(f)
    marg_cdf, integral = _build_cdf(cond_int[None, :].astype(np.float64))
    return Dist2D(
        func=torch.tensor(f.astype(np.float32), device=device),
        cond_cdf=torch.tensor(cond_cdf, device=device),
        cond_int=torch.tensor(cond_int, device=device),
        marg_cdf=torch.tensor(marg_cdf[0], device=device),
        integral=torch.tensor(integral[0], device=device),
    )


def _sample_1d(cdf, func_over_integral, u):
    """PiecewiseConstant1D::sample (sampling.cpp:5-33, offset fixed): one
    CDF [n + 1] for every u, or a row [B, n + 1] per u [B]. Returns
    (x in [0, 1], pdf, idx)."""
    n = cdf.shape[-1] - 1
    if cdf.dim() == 1:
        idx = torch.clamp(torch.searchsorted(cdf, u, side="left") - 1, 0, n - 1)
        c0, c1 = cdf[idx], cdf[idx + 1]
        pdf = func_over_integral[idx]
    else:
        idx = torch.clamp((cdf < u[..., None]).sum(dim=-1) - 1, 0, n - 1)
        c0 = torch.gather(cdf, -1, idx[..., None])[..., 0]
        c1 = torch.gather(cdf, -1, idx[..., None] + 1)[..., 0]
        pdf = torch.gather(func_over_integral, -1, idx[..., None])[..., 0]
    seg = c1 - c0
    du = torch.where(seg > 0, (u - c0) / torch.clamp_min(seg, 1e-20), 0.0)
    return (idx.to(u.dtype) + du) / n, pdf, idx


def sample_dist2d(d: Dist2D, u):
    """UV in [0, 1]^2 from u [..., 2] and its pdf (sampling.cpp:35-44): the
    row from u.y on the marginal, the column from u.x on the row's
    conditional; the pdf is their product."""
    batch = u.shape[:-1]
    uf = u.reshape(-1, 2)
    marg_f = d.cond_int / torch.clamp_min(d.integral, 1e-20)
    y, pdf_y, iv = _sample_1d(d.marg_cdf, marg_f, uf[:, 1].contiguous())
    cond_f = d.func[iv] / torch.clamp_min(d.cond_int[iv][:, None], 1e-20)
    x, pdf_x, _ = _sample_1d(d.cond_cdf[iv], cond_f, uf[:, 0])
    return torch.stack([x, y], dim=-1).reshape(batch + (2,)), (pdf_x * pdf_y).reshape(batch)


def pdf_dist2d(d: Dist2D, uv):
    """The pdf at uv (sampling.cpp:46-60): the cell's value over the
    total integral."""
    nv, nu = d.func.shape
    iu = torch.clamp((uv[..., 0] * nu).to(torch.int64), 0, nu - 1)
    iv = torch.clamp((uv[..., 1] * nv).to(torch.int64), 0, nv - 1)
    return d.func[iv, iu] / torch.clamp_min(d.integral, 1e-20)


def build_alias(weight: np.ndarray):
    """Walker alias table for a discrete distribution over K cells.
    Returns (prob [K] f32, alias [K] i32, pdf [K] f32), pdf being the
    piecewise-constant density over the unit domain (cell value / mean)."""
    w = np.asarray(weight, np.float64).reshape(-1)
    k = w.shape[0]
    total = w.sum()
    if total <= 0.0:
        w = np.ones(k, np.float64)
        total = float(k)
    p = w * (k / total)  # mean 1
    prob = np.ones(k, np.float64)
    alias = np.arange(k, dtype=np.int64)
    small = [i for i in range(k) if p[i] < 1.0]
    large = [i for i in range(k) if p[i] >= 1.0]
    p = p.copy()
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    for i in small + large:
        prob[i] = 1.0
        alias[i] = i
    pdf = w * (k / total)
    return prob.astype(np.float32), alias.astype(np.int32), pdf.astype(np.float32)


def sample_alias_rows(rows: torch.Tensor, u: torch.Tensor):
    """Draw cells from a packed alias table.

    rows: [K, >=4] f32 with cols (prob, alias as int32 bits, pdf_self,
    pdf_alias); u: [N] uniforms. Returns (cell [N] int64, pdf [N], r [N]),
    r being u's leftover entropy renormalised to [0, 1) given the outcome,
    reusable as one jitter coordinate."""
    k = rows.shape[0]
    x = u * k
    j = torch.clamp(x.to(torch.int32), 0, k - 1)
    r = x - j.to(torch.float32)
    row = rows[j.long()]
    prob = row[..., 0]
    alias = row[..., 1].contiguous().view(torch.int32)
    accept = r < prob
    cell = torch.where(accept, j, alias).long()
    pdf = torch.where(accept, row[..., 2], row[..., 3])
    r2 = torch.where(
        accept,
        r / torch.clamp_min(prob, 1e-12),
        (r - prob) / torch.clamp_min(1.0 - prob, 1e-12),
    )
    return cell, pdf, torch.clamp(r2, 0.0, ONE_MINUS_EPS)
