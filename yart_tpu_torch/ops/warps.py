"""Sampling warps (src/math/sampling.hpp:13-89); port of
`yart_tpu/ops/warps.py` (the subset the forward path uses). u is [..., 2]."""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def pixel_jitter_gaussian(u, std_dev: float = 0.3):
    """Box-Muller Gaussian pixel filter, sigma 0.3 (sampling.hpp:20-28)."""
    ux = torch.clamp_min(u[..., 0], 1e-10)
    a = torch.sqrt(-2.0 * torch.log(ux)) * std_dev
    b = TWO_PI * u[..., 1]
    return torch.stack([a * torch.cos(b), a * torch.sin(b)], dim=-1)


def sample_cosine_hemisphere(u):
    """Cosine-weighted hemisphere about +z (sampling.hpp:30-38)."""
    phi = u[..., 0] * TWO_PI
    sqrt_r2 = torch.sqrt(u[..., 1])
    x = torch.cos(phi) * sqrt_r2
    y = torch.sin(phi) * sqrt_r2
    z = torch.sqrt(torch.clamp_min(1.0 - u[..., 1], 0.0))
    return torch.stack([x, y, z], dim=-1)


def sample_disk_uniform(u):
    """Uniform unit disk (sampling.hpp:40-45)."""
    r = torch.sqrt(u[..., 0])
    theta = TWO_PI * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def sample_tri_uniform(u):
    """Uniform barycentrics via the reflection trick (sampling.hpp:54-64)."""
    ux, uy = u[..., 0], u[..., 1]
    lt = ux < uy
    b0 = torch.where(lt, ux * 0.5, ux - uy * 0.5)
    b1 = torch.where(lt, uy - ux * 0.5, uy * 0.5)
    return torch.stack([b0, b1, 1.0 - b0 - b1], dim=-1)


def sample_poly_uniform(u, sides: int):
    """Uniform point in a regular polygon of outer radius 1, for bladed
    apertures (sampling.hpp:72-89); `sides` >= 3."""
    ux = u[..., 0] * sides
    side = torch.clamp_max(ux.to(torch.int32), sides - 1)
    ux = ux - side.to(u.dtype)

    b = sample_tri_uniform(torch.stack([ux, u[..., 1]], dim=-1))
    theta1 = side.to(u.dtype) / sides * TWO_PI
    theta2 = (side.to(u.dtype) + 1.0) / sides * TWO_PI
    v1 = torch.stack([-torch.sin(theta1), torch.cos(theta1)], dim=-1)
    v2 = torch.stack([-torch.sin(theta2), torch.cos(theta2)], dim=-1)
    return v1 * b[..., 1:2] + v2 * b[..., 2:3]
