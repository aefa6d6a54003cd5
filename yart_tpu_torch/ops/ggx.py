"""Trowbridge-Reitz (GGX) microfacet distribution (bsdf.hpp:175-291);
port of `yart_tpu/ops/ggx.py`. Directions are in the local shading frame."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from yart_tpu_torch.ops import warps
from yart_tpu_torch.ops.vecmath import absdot, cross, maximum, normalize, safe_sqrt

PI = math.pi
SMOOTH_ALPHA = 1e-3
# Alphas entering denominators are floored strictly below SMOOTH_ALPHA, as in
# the JAX package (there a reverse-mode guard); rough lanes are unchanged and
# smooth lanes' rough-branch values are masked by every caller.
ALPHA_FLOOR = 1e-4


class Alphas(NamedTuple):
    ax: torch.Tensor
    ay: torch.Tensor
    roughness: torch.Tensor


def make_alphas(roughness, anisotropic=None) -> Alphas:
    """roughness/aniso -> (alpha_x, alpha_y) (bsdf.hpp:177-187)."""
    alpha = roughness * roughness
    if anisotropic is None:
        aniso = torch.zeros_like(alpha)
    else:
        aniso = anisotropic
    aspect = torch.sqrt(1.0 - 0.9 * aniso)
    return Alphas(alpha / aspect, alpha * aspect, roughness)


def smooth(a: Alphas):
    """Delta-lobe cutoff (bsdf.hpp:239-241)."""
    return (a.ax < SMOOTH_ALPHA) & (a.ay < SMOOTH_ALPHA)


def _phi_terms(w):
    cos2t = w[..., 2] * w[..., 2]
    sin2t = maximum(1.0 - cos2t, 0.0)
    safe = torch.where(sin2t > 1e-20, sin2t, 1.0)
    zero = sin2t == 0.0
    cos2p = torch.where(zero, 1.0, w[..., 0] * w[..., 0] / safe)
    sin2p = torch.where(zero, 0.0, w[..., 1] * w[..., 1] / safe)
    return cos2t, sin2t, cos2p, sin2p


def mdf(a: Alphas, w):
    """Microfacet NDF D(w) (bsdf.hpp:193-217); 0 at grazing w."""
    cos2t, sin2t, cos2p, sin2p = _phi_terms(w)
    ok = cos2t > 1e-12
    tan2t = torch.where(ok, sin2t, 0.0) / torch.where(ok, cos2t, 1.0)
    cos4t = torch.where(ok, cos2t * cos2t, 1.0)
    ax = maximum(a.ax, ALPHA_FLOOR)
    ay = maximum(a.ay, ALPHA_FLOOR)
    k = tan2t * (cos2p / (ax * ax) + sin2p / (ay * ay))
    k2 = (1.0 + k) * (1.0 + k)
    d = 1.0 / (PI * ax * ay * cos4t * k2)
    return torch.where(ok, d, 0.0)


def _lambda(a: Alphas, w):
    """Smith Lambda (bsdf.hpp:276-290)."""
    cos2t, sin2t, cos2p, sin2p = _phi_terms(w)
    ok = cos2t > 1e-12
    tan2t = torch.where(ok, sin2t, 0.0) / torch.where(ok, cos2t, 1.0)
    alpha2 = a.ax * a.ax * cos2p + a.ay * a.ay * sin2p
    lam = (torch.sqrt(1.0 + alpha2 * tan2t) - 1.0) * 0.5
    return torch.where(ok, lam, 1e20)


def g1(a: Alphas, w):
    """Masking (bsdf.hpp:219-221)."""
    return 1.0 / (1.0 + _lambda(a, w))


def g(a: Alphas, wo, wi):
    """Masking-shadowing (bsdf.hpp:224-229)."""
    return 1.0 / (1.0 + _lambda(a, wo) + _lambda(a, wi))


def vmdf(a: Alphas, w, wm):
    """Visible-NDF pdf of wm seen from w (bsdf.hpp:232-237)."""
    return g1(a, w) / maximum(w[..., 2].abs(), 1e-20) * mdf(a, wm) * absdot(w, wm)


def sample_visible(a: Alphas, w, u):
    """Heitz VNDF sampling (bsdf.hpp:243-271); wm.z >= 1e-6."""
    ax = maximum(a.ax, ALPHA_FLOOR)
    ay = maximum(a.ay, ALPHA_FLOOR)
    wh = normalize(torch.stack([ax * w[..., 0], ay * w[..., 1], w[..., 2]], dim=-1))
    wh = torch.where(wh[..., 2:3] < 0.0, -wh, wh)

    z = torch.zeros_like(wh)
    z[..., 2] = 1.0
    b_raw = normalize(cross(z, wh))
    x = torch.zeros_like(wh)
    x[..., 0] = 1.0
    b = torch.where(wh[..., 2:3] < 0.9999, b_raw, x)
    t = cross(wh, b)

    p = warps.sample_disk_uniform(u)
    h = safe_sqrt(1.0 - p[..., 0] * p[..., 0])
    mix = 0.5 * wh[..., 2] + 0.5
    py = h + (p[..., 1] - h) * mix
    px = p[..., 0]

    pz = safe_sqrt(1.0 - px * px - py * py)
    nh = px[..., None] * b + py[..., None] * t + pz[..., None] * wh
    return normalize(
        torch.stack([ax * nh[..., 0], ay * nh[..., 1], maximum(nh[..., 2], 1e-6)], dim=-1)
    )
