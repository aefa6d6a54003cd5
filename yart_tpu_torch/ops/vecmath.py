"""Batched 3-vector math over ``[..., 3]`` float32 tensors.

Port of `yart_tpu/ops/vecmath.py` (the subset the forward path uses):
reflect/refract/fresnel (src/math/math.hpp:15-100), the octahedral map of
the environment light (math.hpp:151-179) and the orthonormal shading
frames (src/math/frame.hpp:21-59). `maximum`, `minimum` and `clip` are
the shading code's clamps: they give the value of torch's clamps and the
gradient of jnp.maximum / minimum / clip, which split it at a tie (a
material often sits on a bound: metallic 0 or 1, a colour of 1.0).
"""

from __future__ import annotations

import torch

EPS = 1e-12


def _grad_flows(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _bound(c, x):
    # A Python bound as a 0-dim CPU tensor: a scalar operand on any device.
    return c if isinstance(c, torch.Tensor) else torch.tensor(c, dtype=x.dtype)


def maximum(x, c):
    """max(x, c) with `jnp.maximum`'s gradient: at a tie x takes half the
    gradient (`torch.clamp_min` gives it all). The value is clamp_min's,
    bit for bit; without a gradient to carry it is clamp_min."""
    return torch.maximum(x, _bound(c, x)) if _grad_flows(x) else torch.clamp_min(x, c)


def minimum(x, c):
    """min(x, c) with `jnp.minimum`'s gradient (see `maximum`)."""
    return torch.minimum(x, _bound(c, x)) if _grad_flows(x) else torch.clamp_max(x, c)


def clip(x, lo, hi):
    """`jnp.clip` = minimum(maximum(x, lo), hi), with its gradient at the
    bounds (half, where torch.clamp passes all of it)."""
    return minimum(maximum(x, lo), hi) if _grad_flows(x) else torch.clamp(x, lo, hi)


def dot(a, b, keepdim: bool = False):
    return (a * b).sum(dim=-1, keepdim=keepdim)


def absdot(a, b, keepdim: bool = False):
    return dot(a, b, keepdim=keepdim).abs()


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def mat3_rows(m9, x):
    """M x for the 3x3 matrices M [..., 9] stored row by row and x [..., 3]:
    three dot products, as `integrator.shading_data`'s `mm` forms them."""
    return torch.stack([dot(m9[..., 3 * i : 3 * i + 3], x) for i in range(3)], dim=-1)


def length2(v, keepdim: bool = False):
    return (v * v).sum(dim=-1, keepdim=keepdim)


def normalize(v):
    """v / |v|, with 0 for zero-length inputs."""
    n2 = length2(v, keepdim=True)
    pos = n2 > 0
    return v * torch.where(pos, torch.rsqrt(torch.where(pos, n2, 1.0)), 0.0)


def safe_sqrt(x):
    """sqrt(max(x, 0))."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def max_component(v):
    return v.amax(dim=-1)


def _sign_nz(x):
    """sign(x) with +1 at x == 0."""
    return torch.where(x < 0.0, -1.0, 1.0)


def octahedral_uv(v):
    """Direction -> octahedral-map UV in [0, 1]^2 (math.hpp:151-166)."""
    s = v.abs().sum(dim=-1, keepdim=True)
    v = v / maximum(s, EPS)
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    lo_u = (1.0 - vz.abs()) * _sign_nz(vx)
    lo_v = (1.0 - vx.abs()) * _sign_nz(vz)
    u = torch.where(vy >= 0.0, vx, lo_u)
    w = torch.where(vy >= 0.0, vz, lo_v)
    return (torch.stack([u, w], dim=-1) + 1.0) * 0.5


def inv_octahedral_uv(uv):
    """Octahedral-map UV -> unit direction (math.hpp:168-179)."""
    x = 2.0 * uv[..., 0] - 1.0
    z = 2.0 * uv[..., 1] - 1.0
    y = 1.0 - (x.abs() + z.abs())
    below = y < 0.0
    x_f = (1.0 - z.abs()) * _sign_nz(x)
    z_f = (1.0 - x.abs()) * _sign_nz(z)
    x = torch.where(below, x_f, x)
    z = torch.where(below, z_f, z)
    return normalize(torch.stack([x, y, z], dim=-1))


def refract(wi, n, ior):
    """Refract wi through the interface with normal n and relative ior
    (src/math/math.hpp:22-42). Returns (wt, tir); wt is undefined under
    total internal reflection. `ior` is lane-shaped [...]."""
    cos_theta = dot(wi, n)
    below = cos_theta < 0.0
    eta = torch.where(below, 1.0 / ior, ior)
    cos_theta = cos_theta.abs()
    n = torch.where(below[..., None], -n, n)

    sin2 = maximum(1.0 - cos_theta * cos_theta, 0.0)
    sin2_t = sin2 / (eta * eta)
    tir = sin2_t >= 1.0

    cos_t = safe_sqrt(1.0 - sin2_t)
    wt = -wi / eta[..., None] + (cos_theta / eta - cos_t)[..., None] * n
    return wt, tir


def fresnel_dielectric(cos_theta, ior):
    """Exact dielectric Fresnel (src/math/math.hpp:44-62); cos < 0 inverts
    the ior; 1 under total internal reflection."""
    cos_theta = clip(cos_theta, -1.0, 1.0)
    below = cos_theta < 0.0
    if isinstance(ior, torch.Tensor):
        ior = torch.where(below, 1.0 / ior, ior)
    else:
        ior = torch.where(below, 1.0 / ior, torch.full_like(cos_theta, ior))
    cos_theta = cos_theta.abs()

    sin2 = 1.0 - cos_theta * cos_theta
    sin2_t = sin2 / (ior * ior)
    tir = sin2_t >= 1.0

    cos_t = safe_sqrt(1.0 - sin2_t)
    r_prl = (ior * cos_theta - cos_t) / (ior * cos_theta + cos_t + EPS)
    r_per = (cos_theta - ior * cos_t) / (cos_theta + ior * cos_t + EPS)
    f = 0.5 * (r_prl * r_prl + r_per * r_per)
    return torch.where(tir, 1.0, f)


def fresnel_schlick(r0, cos_theta):
    """Schlick's approximation (src/math/math.hpp:81-88)."""
    k = 1.0 - cos_theta
    k5 = (k * k) * (k * k) * k
    return r0 + (1.0 - r0) * k5


def _axis(ref, i):
    e = torch.zeros(3, dtype=ref.dtype, device=ref.device)
    e[i] = 1.0
    return e.expand_as(ref)


def frame_from_normal(n):
    """(x, y, z=n) basis from a normal alone (Frame(n), frame.hpp:27-32)."""
    a = torch.where(n[..., 0:1].abs() > 0.5, _axis(n, 1), _axis(n, 0))
    y = normalize(cross(n, a))
    x = cross(n, y)
    return x, y, n


def frame_from_normal_tangent(n, t, handedness=1.0):
    """Basis from normal + tangent with the degenerate-tangent fallback
    (Frame(n, t, handedness), frame.hpp:34-50): |t.n| > 0.9 falls back to
    the normal-only frame, else y = normalize(n x t) * handedness (a scalar
    or a [...] tensor), x = y x n."""
    fx, fy, _ = frame_from_normal(n)
    y = normalize(cross(n, t))
    if isinstance(handedness, torch.Tensor):
        y = y * handedness[..., None]
    else:
        y = y * handedness
    x = cross(y, n)
    degen = (absdot(t, n) > 0.9)[..., None]
    return torch.where(degen, fx, x), torch.where(degen, fy, y), n


def world_to_local(w, fx, fy, fz):
    """Frame::wtl (frame.hpp:52-54)."""
    return torch.stack([dot(w, fx), dot(w, fy), dot(w, fz)], dim=-1)


def local_to_world(v, fx, fy, fz):
    """Frame::ltw (frame.hpp:56-58)."""
    return v[..., 0:1] * fx + v[..., 1:2] * fy + v[..., 2:3] * fz


def shading_tangent(n):
    """The integrator's shading tangent (src/cpu/ray-integrator.cpp:72-77):
    normalize(cross(n, +Y)), +X when n is within 0.999 of +/-Y."""
    tg = normalize(cross(n, _axis(n, 1)))
    degen = (n[..., 1].abs() > 0.999)[..., None]
    return torch.where(degen, _axis(n, 0), tg)
