"""Alias tables for environment importance sampling.

Port of `yart_tpu/ops/distribution.py` `build_alias` (host, numpy) and
`sample_alias_rows` (device). The CDF form (`Dist2D`) is not ported: the
environment light samples through the alias rows only.
"""

from __future__ import annotations

import numpy as np
import torch

ONE_MINUS_EPS = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


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
