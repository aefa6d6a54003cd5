"""Robust per-pixel estimators: mean / MoN / GMoNb / GMoN
(src/core/estimator.hpp); port of `yart_tpu/render/estimator.py`.

A wave [P, k, 3] reduces at once. Sample j goes to bucket j % m
(estimator.hpp:62-65); bucket means are sorted by Rec.709 luma with a
STABLE sort, and the Gini coefficient drives trimming. NaN samples are
discarded everywhere, negative ones too for GMoN. Bucket sums are a
reshape-and-sum (deterministic on every device; no atomics).
"""

from __future__ import annotations

import torch

_LW = (0.2126, 0.7152, 0.0722)


def n_buckets(k: int, m_max: int = 15) -> int:
    """m = min(mMax, max(1, 1 + 2*((n-5)//10))) (estimator.hpp:56)."""
    return int(min(m_max, max(1, 1 + 2 * ((k - 5) // 10))))


def _luma(v):
    return v[..., 0] * _LW[0] + v[..., 1] * _LW[1] + v[..., 2] * _LW[2]


def _bucket_means(samples, m: int, reject_negative: bool):
    p, k, _ = samples.shape
    valid = ~torch.isnan(samples).any(dim=-1)
    if reject_negative:
        valid = valid & (samples >= 0.0).all(dim=-1)
    clean = torch.where(valid[..., None], samples, 0.0)
    pad = (-k) % m  # zero, invalid samples complete the last round
    clean = torch.nn.functional.pad(clean, (0, 0, 0, pad))
    cnt = torch.nn.functional.pad(valid.to(samples.dtype), (0, pad))
    acc = clean.reshape(p, -1, m, 3).sum(dim=1)
    cnt = cnt.reshape(p, -1, m).sum(dim=1)
    return acc / torch.clamp_min(cnt, 1.0)[..., None]


def estimate(samples, kind: str = "gmon", m_max: int = 15):
    """Reduce a wave [P, k, 3] -> [P, 3] pixel values."""
    p, k, _ = samples.shape
    if kind == "mean":
        valid = ~torch.isnan(samples).any(dim=-1, keepdim=True)
        return torch.where(valid, samples, 0.0).sum(dim=1) / k

    m = n_buckets(k, m_max)
    if kind not in ("mon", "gmonb", "gmon"):
        raise ValueError(f"unknown estimator: {kind}")
    means = _bucket_means(samples, m, reject_negative=kind == "gmon")
    if m == 1:
        return means[:, 0]

    order = torch.argsort(_luma(means), dim=-1, stable=True)
    smeans = torch.gather(means, 1, order[..., None].expand(-1, -1, 3))
    if kind == "mon":
        return smeans[:, m // 2]

    # Gini coefficient over the luma-sorted bucket means (estimator.hpp:122-128)
    idx = torch.arange(1, m + 1, dtype=samples.dtype, device=samples.device)
    s = smeans.sum(dim=1)
    ws = (smeans * idx[None, :, None]).sum(dim=1)
    g = 2.0 * _luma(ws) / torch.clamp_min(m * _luma(s), 1e-12) - (m + 1.0) / m
    g = torch.clamp(g, 0.0, 1.0)
    if kind == "gmonb":
        return torch.where((g <= 0.25)[..., None], s / m, smeans[:, m // 2])

    c = (g * (m // 2)).to(torch.int32)
    ar = torch.arange(m, dtype=torch.int32, device=samples.device)[None, :]
    keep = (ar >= c[:, None]) & (ar < (m - c[:, None]))
    trimmed = torch.where(keep[..., None], smeans, 0.0).sum(dim=1)
    return trimmed / torch.clamp_min((m - 2 * c).to(samples.dtype), 1.0)[..., None]
