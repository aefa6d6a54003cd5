"""Component-form shading math of the fused shade bounce (B5's twin).

Port of `yart_tpu/kernels/shade_math.py`. The MIS integrator's
post-intersect tail — sampler-fed VNDF sampling, the sample and eval of
all four lobes, the LUT-fed multiscatter terms, the NEE f/pdf, the MIS
weights, the throughput and volume update and roulette — is written here
in component form: every vector is a tuple (x, y, z) of [N] float32
tensors and `vdot(a, b) = a.x * b.x + a.y * b.y + a.z * b.z` in that order.
The CUDA kernel `csrc/shade.cu` computes one lane at a time with the same
float operations in the same order, so the two agree bit for bit on the
card (built with --fmad=false). Three rules of PyTorch's CUDA ops that the
kernel repeats: `tensor / python_float` multiplies by the float32
reciprocal of the scalar, `python_float / tensor` is `reciprocal(t) * s`,
and clamp / maximum / minimum return a NaN operand (the clamps are
ops/vecmath.py's `maximum` / `minimum` / `clip`: clamp_min / clamp_max /
clamp where no gradient flows, jnp's tie rule where one does). Python-float constants
enter as float32, rounded from the double.

The pipeline is the JAX module's:

    candidates()  -> frames, sampled half-vectors/directions, LUT coords
    run_fetches() -> the LUT fetches, grouped by kind (ops/lut.py)
    finish()      -> lobe energies, one-sample pick, emitted MIS, NEE
                     eval, throughput, roulette, next state

`shade()` runs the three in a row: it is the `shade_kernel="xla"` body of
the integrator and the plain twin of B5. The JAX module's gatherless MXU
dots are not ported: `ops/lut.py` indexes the tables with the reference's
index arithmetic. `inp` is the integrator's dict of per-lane inputs:
vector quantities as [N, 3] tensors, scalars as [N] float32, flags as [N]
bool, and the per-bounce `depth0`, `rr_on` (Python bools) and
`reg_threshold` (Python float).

Dead lanes: a lane that is neither active nor found takes no bounce. The
kernel writes the pass-through state for it, and `finish` zeroes its
`contrib` and `shadow_d` (which only `nee_need`, false there, gates
downstream), so every output of the twin equals the kernel's on every
lane.
"""

from __future__ import annotations

import math

import torch

from yart_tpu_torch.ops import lut
from yart_tpu_torch.ops.vecmath import clip, maximum

PI = math.pi

# Scatter flags (render/bsdf.py, src/core/bsdf.hpp:21-29)
ABSORBED = 0
EMITTED = 1
REFLECTED = 2
TRANSMITTED = 4
DIFFUSE = 8
GLOSSY = 16
SPECULAR = 32

SMOOTH_ALPHA = 1e-3
ALPHA_FLOOR = 1e-4  # = ops/ggx.py ALPHA_FLOOR
EPS = 1e-20

V3_KEYS = ("o", "d", "n", "p", "atten", "last_p", "base", "emission", "volume_color",
           "ls_wi", "ls_Li", "ls_n", "ls_p")
F_KEYS = ("last_pdf", "acc_rough", "hit_t", "u0", "u1", "uc", "uc2", "u_rr", "metallic",
          "roughness", "roughness_base", "transmission", "ior", "anisotropic", "aniso_rotation",
          "clearcoat", "cc_roughness", "cc_roughness_base", "volume_density", "pdf_area", "sel_p",
          "ls_pdf", "ls_select_p")
B_KEYS = ("active", "found", "specular_prev", "light_neg", "hit_back", "thin", "ls_valid",
          "ls_is_env")
OUT_V3 = ("L_emit", "contrib", "shadow_d", "o", "d", "atten", "last_p")
OUT_F = ("shadow_tmax", "last_pdf", "acc_rough")
OUT_B = ("nee_need", "active", "specular")


# ---------------------------------------------------------------------------
# Component-vector helpers: a "v3" is a tuple (x, y, z) of same-shape tensors.
# ---------------------------------------------------------------------------


def split3(a):
    return (a[..., 0], a[..., 1], a[..., 2])


def vsplat(s):
    return (s, s, s)


def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vmul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vneg(a):
    return (-a[0], -a[1], -a[2])


def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def vwhere(c, a, b):
    return (torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1]), torch.where(c, a[2], b[2]))


def vnormalize(a):
    """ops/vecmath.normalize: 0 for zero length; 1 / sqrt, not rsqrt."""
    n2 = vdot(a, a)
    pos = n2 > 0
    inv = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, n2, 1.0)), 0.0)
    return vscale(a, inv)


def safe_sqrt(x):
    """sqrt(max(x, 0))."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def vmirror(a):
    """(-x, -y, z): mirror about the local normal."""
    return (-a[0], -a[1], a[2])


def reflect_about(wo, wm):
    """-wo + 2 (wo.wm) wm."""
    d2 = 2.0 * vdot(wo, wm)
    return vsub(vscale(wm, d2), wo)


def _const3(like, x, y, z):
    return (torch.full_like(like, x), torch.full_like(like, y), torch.full_like(like, z))


# ---------------------------------------------------------------------------
# Frames (ops/vecmath.py frame_from_normal[_tangent], shading_tangent)
# ---------------------------------------------------------------------------


def shading_tangent(n):
    """normalize(cross(n, +Y)); +X near the Y poles (ray-integrator.cpp:72-77)."""
    tg = vnormalize(vcross(n, _const3(n[0], 0.0, 1.0, 0.0)))
    degen = n[1].abs() > 0.999
    return vwhere(degen, _const3(n[0], 1.0, 0.0, 0.0), tg)


def frame_from_normal(n):
    """(x, y, z = n) from the normal alone (frame.hpp:27-32)."""
    big = n[0].abs() > 0.5
    a = vwhere(big, _const3(n[0], 0.0, 1.0, 0.0), _const3(n[0], 1.0, 0.0, 0.0))
    y = vnormalize(vcross(n, a))
    x = vcross(n, y)
    return x, y, n


def frame_from_normal_tangent(n, t):
    """Basis with the degenerate-tangent fallback (frame.hpp:34-50)."""
    fx, fy, _ = frame_from_normal(n)
    y = vnormalize(vcross(n, t))
    x = vcross(y, n)
    degen = vdot(t, n).abs() > 0.9
    return vwhere(degen, fx, x), vwhere(degen, fy, y), n


def world_to_local(v, fx, fy, fz):
    return (vdot(v, fx), vdot(v, fy), vdot(v, fz))


def local_to_world(v, fx, fy, fz):
    return (
        v[0] * fx[0] + v[1] * fy[0] + v[2] * fz[0],
        v[0] * fx[1] + v[1] * fy[1] + v[2] * fz[1],
        v[0] * fx[2] + v[1] * fy[2] + v[2] * fz[2],
    )


def rot_z(v, angle):
    """Rotate xy about +z (anisotropy rotation, parametric.cpp:50-51)."""
    c = torch.cos(angle)
    s = torch.sin(angle)
    return (c * v[0] - s * v[1], s * v[0] + c * v[1], v[2])


# ---------------------------------------------------------------------------
# GGX in component form (ops/ggx.py semantics, bsdf.hpp:175-291)
# ---------------------------------------------------------------------------


def make_alphas(roughness, anisotropic):
    alpha = roughness * roughness
    if anisotropic is None:
        return alpha, alpha
    aspect = torch.sqrt(1.0 - 0.9 * anisotropic)
    return alpha / aspect, alpha * aspect


def ggx_smooth(ax, ay):
    return (ax < SMOOTH_ALPHA) & (ay < SMOOTH_ALPHA)


def _phi_terms(w):
    cos2t = w[2] * w[2]
    sin2t = maximum(1.0 - cos2t, 0.0)
    safe = torch.where(sin2t > 1e-20, sin2t, 1.0)
    z = sin2t == 0.0
    cos2p = torch.where(z, 1.0, w[0] * w[0] / safe)
    sin2p = torch.where(z, 0.0, w[1] * w[1] / safe)
    return cos2t, sin2t, cos2p, sin2p


def ggx_mdf(ax, ay, w):
    cos2t, sin2t, cos2p, sin2p = _phi_terms(w)
    ok = cos2t > 1e-12
    tan2t = torch.where(ok, sin2t, 0.0) / torch.where(ok, cos2t, 1.0)
    cos4t = torch.where(ok, cos2t * cos2t, 1.0)
    ax = maximum(ax, ALPHA_FLOOR)
    ay = maximum(ay, ALPHA_FLOOR)
    k = tan2t * (cos2p / (ax * ax) + sin2p / (ay * ay))
    k2 = (1.0 + k) * (1.0 + k)
    d = 1.0 / (PI * ax * ay * cos4t * k2)
    return torch.where(ok, d, 0.0)


def ggx_lambda(ax, ay, w):
    cos2t, sin2t, cos2p, sin2p = _phi_terms(w)
    ok = cos2t > 1e-12
    tan2t = torch.where(ok, sin2t, 0.0) / torch.where(ok, cos2t, 1.0)
    alpha2 = ax * ax * cos2p + ay * ay * sin2p
    lam = (torch.sqrt(1.0 + alpha2 * tan2t) - 1.0) * 0.5
    return torch.where(ok, lam, 1e20)


def ggx_g1(ax, ay, w):
    return 1.0 / (1.0 + ggx_lambda(ax, ay, w))


def ggx_g(ax, ay, wo, wi):
    return 1.0 / (1.0 + ggx_lambda(ax, ay, wo) + ggx_lambda(ax, ay, wi))


def ggx_vmdf(ax, ay, w, wm):
    return (
        ggx_g1(ax, ay, w)
        / maximum(w[2].abs(), 1e-20)
        * ggx_mdf(ax, ay, wm)
        * vdot(w, wm).abs()
    )


def sample_disk_uniform(u0, u1):
    r = torch.sqrt(u0)
    theta = 2.0 * PI * u1
    return r * torch.cos(theta), r * torch.sin(theta)


def sample_cosine_hemisphere(u0, u1):
    phi = u0 * 2.0 * PI
    sqrt_r2 = torch.sqrt(u1)
    return (torch.cos(phi) * sqrt_r2, torch.sin(phi) * sqrt_r2, safe_sqrt(1.0 - u1))


def sample_visible(ax, ay, w, u0, u1):
    """Heitz VNDF sampling (ops/ggx.py sample_visible, bsdf.hpp:243-271)."""
    ax = maximum(ax, ALPHA_FLOOR)
    ay = maximum(ay, ALPHA_FLOOR)
    wh = vnormalize((ax * w[0], ay * w[1], w[2]))
    wh = vwhere(wh[2] < 0.0, vneg(wh), wh)
    b_raw = vnormalize(vcross(_const3(wh[0], 0.0, 0.0, 1.0), wh))
    b = vwhere(wh[2] < 0.9999, b_raw, _const3(wh[0], 1.0, 0.0, 0.0))
    t = vcross(wh, b)
    px, py0 = sample_disk_uniform(u0, u1)
    h = safe_sqrt(1.0 - px * px)
    mix = 0.5 * wh[2] + 0.5
    py = h + (py0 - h) * mix
    pz = safe_sqrt(1.0 - px * px - py * py)
    nh = vadd(vadd(vscale(b, px), vscale(t, py)), vscale(wh, pz))
    return vnormalize((ax * nh[0], ay * nh[1], maximum(nh[2], 1e-6)))


# ---------------------------------------------------------------------------
# Fresnel (ops/vecmath.py semantics)
# ---------------------------------------------------------------------------


def fresnel_dielectric(cos_theta, ior):
    """`ior` is a tensor or a Python float (the coat's 1.5)."""
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


def fresnel_schlick3(f0, cos_theta):
    """Schlick over an rgb f0 v3 (no clip)."""
    m = 1.0 - cos_theta
    m5 = (m * m) * (m * m) * m
    return tuple(c + (1.0 - c) * m5 for c in f0)


def refract(wi, n, ior):
    """ops/vecmath.refract in component form; returns (wt, tir)."""
    cos_theta = vdot(wi, n)
    below = cos_theta < 0.0
    eta = torch.where(below, 1.0 / ior, ior)
    cos_theta = cos_theta.abs()
    nn = vwhere(below, vneg(n), n)
    sin2 = maximum(1.0 - cos_theta * cos_theta, 0.0)
    sin2_t = sin2 / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    wt = vadd(vscale(vneg(wi), 1.0 / eta), vscale(nn, cos_theta / eta - cos_t))
    return wt, tir


def _outward(wm):
    """render/bsdf.py _outward: normalize + flip up; ok = |wm|^2 > 1e-20."""
    n2 = vdot(wm, wm)
    ok = n2 > 1e-20
    n2m = torch.where(ok, n2, 1.0)
    w = vscale(wm, torch.where(ok, 1.0 / torch.sqrt(n2m), 0.0))
    w = vwhere(w[2] < 0.0, vneg(w), w)
    return w, ok


def _safe_div(a, b, eps=1e-20):
    """a / b with |b| clamped away from 0, keeping b's sign."""
    small = b.abs() < eps
    bb = torch.where(small, torch.where(b < 0, -eps, eps), b)
    return a / bb


def _favg_fit(ior):
    return (ior - 1.0) / (4.08567 + 1.00071 * ior)


FAVG15 = _favg_fit(1.5)  # the clearcoat's Favg fit, a Python float


def roughen(r):
    """Path-regularization roughening (src/core/bsdf.hpp:16-18)."""
    return torch.maximum(r, clip(r * 2.0, 0.1, 0.3))


# ---------------------------------------------------------------------------
# Stage 1: candidates + fetch coordinates
# ---------------------------------------------------------------------------


def candidates(c, gates, force_reg=None):
    """Frames, sampled half-vectors, candidate directions and LUT fetch
    coordinates for one bounce (render/bsdf.py bsdf_sample's direction
    phase, parametric.cpp:179-258, plus the NEE local-frame transform).
    `c` is `components(inp)`; `gates` = (use_metal, use_diel, use_coat,
    use_aniso); `force_reg` the specular-chain regularization gate (the
    "xla" path's `regularize_specular`) or None."""
    use_metal, use_diel, use_coat, use_aniso = gates
    n = c["n"]
    rough = c["roughness"]
    ccr = c["cc_roughness"]
    u0, u1 = c["u0"], c["u1"]

    tg = shading_tangent(n)
    fx, fy, fz = frame_from_normal_tangent(n, tg)
    wo = world_to_local(vneg(c["d"]), fx, fy, fz)

    regularized = c["acc_rough"] > c["reg_threshold"]
    if force_reg is not None:
        regularized = regularized | force_reg
    r_s = torch.where(regularized, roughen(rough), rough)

    wo_r = rot_z(wo, -c["aniso_rotation"]) if use_aniso else wo
    ax, ay = make_alphas(r_s, c["anisotropic"] if use_aniso else None)
    smooth = ggx_smooth(ax, ay)
    wm = sample_visible(ax, ay, wo_r, u0, u1)

    # Candidate directions (shared across lobes: parametric.cpp reflects
    # about the SAME VNDF half-vector for metal/glossy/dielectric).
    wi_g = reflect_about(wo_r, wm)
    wi_d = sample_cosine_hemisphere(u0, u1)
    wi_d = vwhere(wo_r[2] < 0.0, vneg(wi_d), wi_d)

    # NEE direction in the local (and rotated) frame.
    wi_l = world_to_local(c["ls_wi"], fx, fy, fz)
    wi_l_r = rot_z(wi_l, -c["aniso_rotation"]) if use_aniso else wi_l

    out = dict(frame=(fx, fy, fz), wo=wo, wo_r=wo_r, wm=wm, smooth=smooth, ax=ax, ay=ay,
               r_s=r_s, wi_g=wi_g, wi_d=wi_d, wi_l=wi_l, wi_l_r=wi_l_r,
               regularized=regularized)

    ior = c["ior"]
    r0 = (1.0 - ior) / (1.0 + ior)
    f0 = r0 * r0
    out["f0"] = f0
    cos_o = wo_r[2]
    cos_o_abs = cos_o.abs()
    coords = {
        # glossy sample (RAW sign-carrying cosines: the reference's
        # backside LUT extrapolation)
        "eavg_s": ("eavg", r_s),
        "e_o_s_raw": ("e", cos_o, r_s),
        "e_i_g": ("e", wi_g[2], r_s),
        "base_e_o_s": ("base_e", f0, r_s, cos_o),
        "base_e_i_d": ("base_e", f0, r_s, wi_d[2]),
        "base_eavg_s": ("base_eavg", f0, r_s),
        # NEE f/pdf eval (abs cosines, unroughened r)
        "eavg_raw": ("eavg", rough),
        "e_o_abs_raw": ("e", cos_o_abs, rough),
        "e_i_l_abs": ("e", wi_l_r[2].abs(), rough),
        "base_e_o_abs": ("base_e", f0, rough, cos_o_abs),
        "base_e_i_l": ("base_e", f0, rough, wi_l_r[2].abs()),
        "base_eavg_raw": ("base_eavg", f0, rough),
    }
    if use_metal:
        coords["e_o_abs_s"] = ("e", cos_o_abs, r_s)
    if use_diel:
        ior_rel = torch.where(c["thin"] | (wo_r[2] > 0.0), ior, 1.0 / ior)
        coords["glass_e_s"] = ("glass_e", ior_rel, r_s, cos_o_abs)
        out["ior_rel"] = ior_rel
        # NEE eval ior selection (parametric.cpp:354-363)
        is_refl = cos_o * wi_l_r[2] > 0.0
        ior_f = torch.where(is_refl, 1.0, torch.where(cos_o > 0.0, ior, 1.0 / ior))
        coords["glass_e_f"] = ("glass_e", ior_f, rough, cos_o_abs)
    if use_coat:
        cr_s = torch.where(regularized, roughen(ccr), ccr)
        acx, acy = make_alphas(cr_s, None)
        wm_coat = sample_visible(acx, acy, wo, u0, u1)
        out["cr_s"] = cr_s
        out["ac"] = (acx, acy)
        out["wm_coat"] = wm_coat
        coords["eavg_c"] = ("eavg", cr_s)
        coords["e_o_c"] = ("e", clip(vdot(wo, wm_coat).abs(), 0.0, 1.0), cr_s)
    out["coords"] = coords
    return out


_FETCHERS = {
    "eavg": lut.ggx_eavg,
    "e": lut.ggx_e,  # (cos, r)
    "base_e": lut.ggx_base_e,  # (f0, r, cos)
    "base_eavg": lut.ggx_base_eavg,  # (f0, r)
    "glass_e": lut.ggx_glass_e,  # (ior, r, cos)
}


def run_fetches(tables, coords):
    """The LUT fetches, queries of one kind stacked into one call of the
    port's ops/lut.py fetcher (the reference's index arithmetic)."""
    by_kind = {}
    for name, q in coords.items():
        by_kind.setdefault(q[0], []).append((name, q[1:]))
    out = {}
    for kind, items in by_kind.items():
        args = [torch.stack([a[i] for _, a in items], dim=0) for i in range(len(items[0][1]))]
        vals = _FETCHERS[kind](tables, *args)
        for i, (name, _) in enumerate(items):
            out[name] = vals[i]
    return out


# ---------------------------------------------------------------------------
# Lobe samples (component transliteration of render/bsdf.py _sample_*)
# ---------------------------------------------------------------------------


def _mk(flags, f, Le, wi, pdf, roughness):
    return dict(flags=flags, f=f, Le=Le, wi=wi, pdf=pdf, roughness=roughness)


def _flags(cond, a, b):
    return torch.where(cond, a, b).to(torch.int32)


def _sample_metallic_c(c, cand, fet):
    """(parametric.cpp:307-352)"""
    wo, wm = cand["wo_r"], cand["wm"]
    ax, ay = cand["ax"], cand["ay"]
    smooth = cand["smooth"]
    base = c["base"]

    wi_s = vmirror(wo)
    f_s = vscale(fresnel_schlick3(base, wo[2]), 1.0 / maximum(wo[2].abs(), 1e-12))

    wi = cand["wi_g"]
    valid = wo[2] * wi[2] >= 0.0
    pdf = ggx_vmdf(ax, ay, wo, wm) / maximum(4 * vdot(wo, wm).abs(), 1e-12)
    cos_o = wo[2].abs()
    cos_i = wi[2].abs()
    fss = fresnel_schlick3(base, vdot(wo, wm).abs())
    m_scalar = ggx_mdf(ax, ay, wm) * ggx_g(ax, ay, wo, wi) / maximum(4 * cos_o * cos_i, 1e-12)
    mss = vscale(fss, m_scalar)
    ess = maximum(fet["e_o_abs_s"], 1e-4)
    ms_gain = (1.0 - ess) / ess
    f = vmul(mss, vadd(vsplat(torch.ones_like(ess)), vscale(base, ms_gain)))

    zero3 = vsplat(torch.zeros_like(ess))
    flags_r = _flags(valid, REFLECTED | GLOSSY, ABSORBED)
    return _mk(
        flags=_flags(smooth, REFLECTED | SPECULAR, flags_r),
        f=vwhere(smooth, f_s, vwhere(valid, f, zero3)),
        Le=zero3,
        wi=vwhere(smooth, wi_s, wi),
        pdf=torch.where(smooth, 1.0, pdf),
        roughness=torch.where(smooth, 0.0, c["roughness_base"]),
    )


def _sample_dielectric_c(c, cand, fet):
    """(parametric.cpp:462-575)"""
    wo, wm = cand["wo_r"], cand["wm"]
    ax, ay = cand["ax"], cand["ay"]
    smooth = cand["smooth"]
    base = c["base"]
    thin = c["thin"]
    ior = c["ior"]
    uc = c["uc"]
    ior_rel = cand["ior_rel"]
    zero = torch.zeros_like(ior)

    # ---- smooth (delta) case ----
    f_spec = fresnel_dielectric(wo[2].abs(), ior_rel)
    refl_s = uc < f_spec
    wi_s_refl = vmirror(wo)
    wi_s_refr, tir_s = refract(wo, _const3(ior, 0.0, 0.0, 1.0), ior)
    wi_s_refr = vwhere(thin, vneg(wo), wi_s_refr)
    tir_s = tir_s & ~thin
    wi_s = vwhere(refl_s, wi_s_refl, wi_s_refr)
    t_spec = 1.0 - f_spec
    f_s = vwhere(
        refl_s,
        vsplat(f_spec / maximum(wi_s_refl[2].abs(), 1e-12)),
        vscale(base, t_spec / maximum(wi_s_refr[2].abs(), 1e-12)),
    )
    pdf_s = torch.where(refl_s, f_spec, t_spec)
    flags_s = _flags(refl_s, REFLECTED | SPECULAR,
                     _flags(tir_s, ABSORBED, TRANSMITTED | SPECULAR))

    # ---- rough case ----
    fss = fresnel_dielectric(vdot(wo, wm).abs(), ior_rel)
    cos_o = wo[2].abs()
    e_o = maximum(fet["glass_e_s"], 1e-4)
    refl = uc < fss
    dot_wo_wm = vdot(wo, wm)
    vm = ggx_vmdf(ax, ay, wo, wm) / maximum(4 * dot_wo_wm.abs(), 1e-12)

    # reflection branch
    wi_r = cand["wi_g"]
    ok_r = wo[2] * wi_r[2] >= 0.0
    cos_i_r = wi_r[2].abs()
    mss_r = ggx_mdf(ax, ay, wm) * ggx_g(ax, ay, wo, wi_r) / maximum(4 * cos_o * cos_i_r, 1e-12)
    f_r = vsplat(fss * mss_r / e_o)
    pdf_r = vm * fss

    # thin transmission branch: reflect(wo, wm) * (1, 1, -1)
    wi_thin = (wi_r[0], wi_r[1], -wi_r[2])
    cos_i_t = wi_thin[2].abs()
    tss_thin = ggx_mdf(ax, ay, wm) * ggx_g(ax, ay, wo, wi_thin) / maximum(
        4 * cos_o * cos_i_t, 1e-12)
    f_thin = vscale(base, (1.0 - fss) * tss_thin / e_o)
    pdf_thin = vm * (1.0 - fss)

    # full refraction branch
    wi_t, tir = refract(wo, wm, ior)
    bad_t = tir | (wo[2] * wi_t[2] > 0.0) | (wi_t[2] == 0.0)
    dot_wi_wm = vdot(wi_t, wm)
    temp = dot_wi_wm * ior_rel + dot_wo_wm
    dwm_dwi = dot_wi_wm.abs() / maximum(temp * temp, 1e-12)
    pdf_t = ggx_vmdf(ax, ay, wo, wm) * dwm_dwi * (1.0 - fss)
    tss = ggx_mdf(ax, ay, wm) * ggx_g(ax, ay, wo, wi_t) * _safe_div(
        dot_wi_wm * dot_wo_wm, wi_t[2] * wo[2] * temp * temp).abs()
    f_t = vscale(base, (1.0 - fss) * tss / e_o)

    use_thin = ~refl & thin
    wi_rough = vwhere(refl, wi_r, vwhere(use_thin, wi_thin, wi_t))
    f_rough = vwhere(refl, f_r, vwhere(use_thin, f_thin, f_t))
    pdf_rough = torch.where(refl, pdf_r, torch.where(use_thin, pdf_thin, pdf_t))
    flags_rough = _flags(
        refl,
        _flags(ok_r, REFLECTED | GLOSSY, ABSORBED),
        _flags(use_thin, TRANSMITTED | GLOSSY, _flags(bad_t, ABSORBED, TRANSMITTED | GLOSSY)),
    )
    return _mk(
        flags=_flags(smooth, flags_s, flags_rough),
        f=vwhere(smooth, f_s, f_rough),
        Le=vsplat(zero),
        wi=vwhere(smooth, wi_s, wi_rough),
        pdf=torch.where(smooth, pdf_s, pdf_rough),
        roughness=torch.where(smooth, 0.0, cand["r_s"]),
    )


def _sample_glossy_c(c, cand, fet):
    """(parametric.cpp:648-730)"""
    wo, wm = cand["wo_r"], cand["wm"]
    ax, ay = cand["ax"], cand["ay"]
    smooth = cand["smooth"]
    base = c["base"]
    ior = c["ior"]
    emission = c["emission"]

    cos_o = wo[2]
    favg = _favg_fit(ior)
    eavg = fet["eavg_s"]
    fms = favg * favg * eavg / maximum(1.0 - favg * (1.0 - eavg), 1e-6)
    e_o = fet["e_o_s_raw"]  # RAW sign-carrying cosine (backside extrapolation)
    kappa = 1.0 - (favg * e_o + fms * (1.0 - e_o))
    sel_diffuse = c["uc"] < kappa

    # ---- diffuse branch ----
    wi_d = cand["wi_d"]
    e_wo = fet["base_e_o_s"]
    e_wi = fet["base_e_i_d"]
    eavg_b = fet["base_eavg_s"]
    c_diffuse = (1.0 - e_wo) * (1.0 - e_wi) / maximum(PI * (1.0 - eavg_b), 1e-6)
    f_d = vscale(base, c_diffuse)
    pdf_d = wi_d[2].abs() * c_diffuse
    emissive = vdot(emission, emission) > 0.0
    flags_d = _flags(emissive, REFLECTED | DIFFUSE | EMITTED, REFLECTED | DIFFUSE)

    # ---- smooth specular ----
    f_spec = fresnel_dielectric(cos_o, ior)
    wi_s = vmirror(wo)
    f_sv = vsplat(f_spec / maximum(wi_s[2].abs(), 1e-12))

    # ---- rough reflection ----
    wi_g = cand["wi_g"]
    cos_i_g = wi_g[2]
    ok_g = cos_o * cos_i_g >= 0.0
    fss = fresnel_dielectric(vdot(wo, wm), ior)
    mss = ggx_mdf(ax, ay, wm) * ggx_g(ax, ay, wo, wi_g) / maximum(
        (4 * cos_o * cos_i_g).abs(), 1e-12)
    e_i = fet["e_i_g"]
    mms = (1.0 - e_o) * (1.0 - e_i) / maximum(PI * (1.0 - eavg), 1e-6)
    f_g = vsplat(fss * mss + fms * mms)
    pdf_g = ggx_vmdf(ax, ay, wo, wm) / maximum(4 * vdot(wo, wm).abs(), 1e-12) * fss
    flags_g = _flags(ok_g, REFLECTED | GLOSSY, ABSORBED)

    zero3 = vsplat(torch.zeros_like(cos_o))
    spec_flags = _flags(smooth, REFLECTED | SPECULAR, flags_g)
    spec_f = vwhere(smooth, f_sv, vwhere(ok_g, f_g, zero3))
    spec_wi = vwhere(smooth, wi_s, wi_g)
    spec_pdf = torch.where(smooth, f_spec, pdf_g)
    spec_rough = torch.where(smooth, 0.0, cand["r_s"])
    return _mk(
        flags=_flags(sel_diffuse, flags_d, spec_flags),
        f=vwhere(sel_diffuse, f_d, spec_f),
        Le=vwhere(sel_diffuse, emission, zero3),
        wi=vwhere(sel_diffuse, wi_d, spec_wi),
        pdf=torch.where(sel_diffuse, pdf_d, spec_pdf),
        roughness=torch.where(sel_diffuse, 1.0, spec_rough),
    )


def _sample_clearcoat_c(c, cand, fet):
    """(parametric.cpp:795-832)"""
    wo = cand["wo"]
    wm = cand["wm_coat"]
    acx, acy = cand["ac"]
    smooth = ggx_smooth(acx, acy)
    cos_o = wo[2]

    # smooth: the reference uses the MATERIAL ior here (parametric.cpp:804)
    f_spec = fresnel_dielectric(cos_o, c["ior"])
    wi_s = vmirror(wo)
    f_sv = vsplat(f_spec / maximum(wi_s[2].abs(), 1e-12))

    wi = reflect_about(wo, wm)
    ok = cos_o * wi[2] >= 0.0
    fss = fresnel_dielectric(vdot(wo, wm), 1.5)
    mss = ggx_mdf(acx, acy, wm) * ggx_g(acx, acy, wo, wi) / maximum(
        (4 * cos_o * wi[2]).abs(), 1e-12)
    pdf = fss * ggx_vmdf(acx, acy, wo, wm) / maximum(4 * vdot(wo, wm).abs(), 1e-12)
    f = vsplat(fss * mss)
    zero3 = vsplat(torch.zeros_like(cos_o))
    flags = _flags(ok, REFLECTED | GLOSSY, ABSORBED)
    return _mk(
        flags=_flags(smooth, REFLECTED | SPECULAR, flags),
        f=vwhere(smooth, f_sv, vwhere(ok, f, zero3)),
        Le=zero3,
        wi=vwhere(smooth, wi_s, wi),
        pdf=torch.where(smooth, f_spec, pdf),
        roughness=torch.where(smooth, 0.0, c["cc_roughness_base"]),
    )


# ---------------------------------------------------------------------------
# NEE f / pdf evaluation (render/bsdf.py _f_* / _pdf_* at the UNROUGHENED
# material roughness)
# ---------------------------------------------------------------------------


def _f_metallic_c(c, fet, ax, ay, wo, wi):
    """(parametric.cpp:260-286)"""
    cos_o = wo[2].abs()
    cos_i = wi[2].abs()
    wm, ok = _outward(vadd(wo, wi))
    ok = ok & (cos_o > 0) & (cos_i > 0) & ~ggx_smooth(ax, ay)
    fss = fresnel_schlick3(c["base"], vdot(wo, wm).abs())
    m_scalar = ggx_mdf(ax, ay, wm) * ggx_g(ax, ay, wo, wi) / maximum(4 * cos_o * cos_i, 1e-12)
    mss = vscale(fss, m_scalar)
    ess = maximum(fet["e_o_abs_raw"], 1e-4)
    mms = vscale(vmul(mss, c["base"]), (1.0 - ess) / ess)
    return vwhere(ok, vadd(mss, mms), vsplat(torch.zeros_like(cos_o)))


def _pdf_metallic_c(ax, ay, wo, wi):
    """(parametric.cpp:288-305)"""
    wm, ok = _outward(vadd(wo, wi))
    ok = ok & ~ggx_smooth(ax, ay)
    pdf = ggx_vmdf(ax, ay, wo, wm) / maximum(4 * vdot(wo, wm).abs(), 1e-12)
    return torch.where(ok, pdf, 0.0)


def _f_dielectric_c(c, fet, ax, ay, wo, wi):
    """(parametric.cpp:354-414)"""
    thin = c["thin"]
    cos_o = wo[2]
    cos_i = wi[2]
    is_refl = cos_o * cos_i > 0.0
    ior = torch.where(is_refl, 1.0, torch.where(cos_o > 0.0, c["ior"], 1.0 / c["ior"]))

    wm, ok = _outward(vadd(vscale(wi, ior), wo))
    ok = ok & (cos_i != 0) & (cos_o != 0) & ~ggx_smooth(ax, ay)
    ok = ok & (vdot(wm, wi) * cos_i >= 0.0) & (vdot(wm, wo) * cos_o >= 0.0)

    fss = fresnel_dielectric(vdot(wo, wm).abs(), ior)
    t = 1.0 - fss
    e_o = maximum(fet["glass_e_f"], 1e-4)
    d_g = ggx_mdf(ax, ay, wm) * ggx_g(ax, ay, wo, wi)
    f_refl = fss * d_g / maximum((4 * cos_o * cos_i).abs(), 1e-12)

    # SIGNED cos_o denominator: the reference's thin-transmission quirk
    # (parametric.cpp:399-402).
    wip = (wi[0], wi[1], -wi[2])
    wm_thin, ok_thin = _outward(vadd(wip, wo))
    cos_ip = wip[2].abs()
    tss_thin = ggx_mdf(ax, ay, wm_thin) * ggx_g(ax, ay, wo, wip) * _safe_div(
        torch.ones_like(cos_o), 4 * cos_o * cos_ip, eps=1e-12)

    temp = vdot(wi, wm) * ior + vdot(wo, wm)
    dwm_dwi = vdot(wi, wm).abs() * vdot(wo, wm).abs() / maximum(temp * temp, 1e-12)
    tss = d_g * dwm_dwi / maximum((cos_i * cos_o).abs(), 1e-12)

    trans_ss = torch.where(thin, torch.where(ok_thin, tss_thin, 0.0), tss)
    f_trans = vscale(c["base"], t * trans_ss)
    out = vwhere(is_refl, vsplat(f_refl / e_o), vscale(f_trans, 1.0 / e_o))
    return vwhere(ok, out, vsplat(torch.zeros_like(cos_o)))


def _pdf_dielectric_c(c, ax, ay, wo, wi):
    """(parametric.cpp:416-460)"""
    thin = c["thin"]
    cos_o = wo[2]
    cos_i = wi[2]
    is_refl = cos_o * cos_i > 0.0
    ior = torch.where(is_refl, 1.0, torch.where(cos_o > 0.0, c["ior"], 1.0 / c["ior"]))

    wm, ok = _outward(vadd(vscale(wi, ior), wo))
    ok = ok & (cos_i != 0) & (cos_o != 0) & ~ggx_smooth(ax, ay)
    ok = ok & (vdot(wm, wi) * cos_i >= 0.0) & (vdot(wm, wo) * cos_o >= 0.0)

    # NOTE: signed dot and the MATERIAL ior (parametric.cpp:438-440).
    f = fresnel_dielectric(vdot(wo, wm), c["ior"])
    t = 1.0 - f
    pdf_refl = ggx_vmdf(ax, ay, wo, wm) / maximum(4 * vdot(wo, wm).abs(), 1e-12) * f

    wip = (wi[0], wi[1], -wi[2])
    wm_thin, _ = _outward(vadd(wip, wo))
    pdf_thin = (ggx_vmdf(ax, ay, wo, wm_thin)
                / maximum(4 * vdot(wo, wm_thin).abs(), 1e-12) * t)

    temp2 = vdot(wi, wm) + vdot(wo, wm) / ior
    dwm_dwi2 = vdot(wo, wm).abs() / maximum(temp2 * temp2, 1e-12)
    pdf_refr = ggx_vmdf(ax, ay, wo, wm) * dwm_dwi2 * t

    pdf = torch.where(is_refl, pdf_refl, torch.where(thin, pdf_thin, pdf_refr))
    return torch.where(ok, pdf, 0.0)


def _f_glossy_c(c, fet, ax, ay, wo, wi):
    """(parametric.cpp:577-617)"""
    cos_o = wo[2].abs()
    cos_i = wi[2].abs()
    wm, ok = _outward(vadd(wo, wi))
    ok = ok & (cos_o > 0) & (cos_i > 0)
    rough_ok = ok & ~ggx_smooth(ax, ay)

    ior = c["ior"]
    fss = fresnel_dielectric(vdot(wo, wm), ior)
    mss = ggx_mdf(ax, ay, wm) * ggx_g(ax, ay, wo, wi) / maximum(4 * cos_o * cos_i, 1e-12)
    favg = _favg_fit(ior)
    eavg = fet["eavg_raw"]
    e_o = fet["e_o_abs_raw"]
    e_i = fet["e_i_l_abs"]
    mms = (1.0 - e_o) * (1.0 - e_i) / maximum(PI * (1.0 - eavg), 1e-6)
    fms = favg * favg * eavg / maximum(1.0 - favg * (1.0 - eavg), 1e-6)

    c_diffuse = (1.0 - fet["base_e_o_abs"]) * (1.0 - fet["base_e_i_l"]) / maximum(
        PI * (1.0 - fet["base_eavg_raw"]), 1e-6)
    diffuse = vscale(c["base"], c_diffuse)
    spec = torch.where(rough_ok, fss * mss + mms * fms, 0.0)
    out = vadd(vsplat(spec), diffuse)
    return vwhere(ok, out, vsplat(torch.zeros_like(cos_o)))


def _pdf_glossy_c(c, fet, ax, ay, wo, wi):
    """(parametric.cpp:619-645)"""
    cos_i = wi[2].abs()
    wm, ok = _outward(vadd(wo, wi))
    ior = c["ior"]
    fss = fresnel_dielectric(vdot(wo, wm), ior)
    favg = _favg_fit(ior)
    eavg = fet["eavg_raw"]
    fms = favg * favg * eavg / maximum(1.0 - favg * (1.0 - eavg), 1e-6)
    e_o = fet["e_o_abs_raw"]
    kappa = 1.0 - (favg * e_o + fms * (1.0 - e_o))
    spec_pdf = (fss + fms) * ggx_vmdf(ax, ay, wo, wm) / maximum(4 * vdot(wo, wm).abs(), 1e-12)
    spec_pdf = torch.where(ok & ~ggx_smooth(ax, ay), spec_pdf, 0.0)
    return spec_pdf + cos_i * kappa


def _f_clearcoat_c(acx, acy, wo, wi):
    """(parametric.cpp:732-766); returns (f_scalar, Fc)."""
    cos_o = wo[2].abs()
    cos_i = wi[2].abs()
    wm, ok = _outward(vadd(wo, wi))
    ok = ok & (cos_o > 0) & (cos_i > 0) & ~ggx_smooth(acx, acy)
    fss = fresnel_dielectric(vdot(wo, wm), 1.5)
    mss = ggx_mdf(acx, acy, wm) * ggx_g(acx, acy, wo, wi) / maximum(4 * cos_o * cos_i, 1e-12)
    fc = torch.maximum(fresnel_dielectric(cos_o, 1.5), fresnel_dielectric(cos_i, 1.5))
    return torch.where(ok, fss * mss, 0.0), fc


def _pdf_clearcoat_c(acx, acy, wo, wi):
    """(parametric.cpp:768-793); returns (pdf, Fc)."""
    wm, ok = _outward(vadd(wo, wi))
    ok = ok & ~ggx_smooth(acx, acy)
    fss = fresnel_dielectric(vdot(wo, wm), 1.5)
    pdf = fss * ggx_vmdf(acx, acy, wo, wm) / maximum(4 * vdot(wo, wm).abs(), 1e-12)
    fc = torch.maximum(fresnel_dielectric(wo[2].abs(), 1.5), fresnel_dielectric(wi[2].abs(), 1.5))
    return torch.where(ok, pdf, 0.0), fc


def bsdf_f_c(c, cand, fet, gates):
    """Full layered f at (wo_r, wi_l_r): render/bsdf.py bsdf_f."""
    use_metal, use_diel, use_coat, use_aniso = gates
    ax, ay = make_alphas(c["roughness"], c["anisotropic"] if use_aniso else None)
    wo, wi = cand["wo_r"], cand["wi_l_r"]
    metallic = c["metallic"]
    trans = c["transmission"]
    c_diel = (1.0 - metallic) * trans
    c_glossy = (1.0 - metallic) * (1.0 - trans)

    val = vscale(_f_glossy_c(c, fet, ax, ay, wo, wi), c_glossy)
    if use_metal:
        val = vadd(val, vscale(_f_metallic_c(c, fet, ax, ay, wo, wi), metallic))
    if use_diel:
        val = vadd(val, vscale(_f_dielectric_c(c, fet, ax, ay, wo, wi), c_diel))
    if use_coat:
        # bsdf_f feeds every lobe, the coat included, the rotated pair.
        accx, accy = make_alphas(c["cc_roughness"], None)
        f_coat, fc = _f_clearcoat_c(accx, accy, wo, wi)
        cc = c["clearcoat"]
        val = vadd(vscale(val, 1.0 - cc * fc), vsplat(cc * f_coat))
    return val


def bsdf_pdf_c(c, cand, fet, gates):
    """Full layered pdf: render/bsdf.py bsdf_pdf, on UNROTATED directions
    (the reference's pdfImpl skips the anisotropy rotation)."""
    use_metal, use_diel, use_coat, use_aniso = gates
    ax, ay = make_alphas(c["roughness"], c["anisotropic"] if use_aniso else None)
    wo, wi = cand["wo"], cand["wi_l"]
    metallic = c["metallic"]
    trans = c["transmission"]
    p_diel = (1.0 - metallic) * trans
    p_glossy = (1.0 - metallic) * (1.0 - trans)

    pdf = p_glossy * _pdf_glossy_c(c, fet, ax, ay, wo, wi)
    if use_metal:
        pdf = pdf + metallic * _pdf_metallic_c(ax, ay, wo, wi)
    if use_diel:
        pdf = pdf + p_diel * _pdf_dielectric_c(c, ax, ay, wo, wi)
    if use_coat:
        accx, accy = make_alphas(c["cc_roughness"], None)
        pdf_coat, fc = _pdf_clearcoat_c(accx, accy, wo, wi)
        cc = c["clearcoat"]
        pdf = (1.0 - cc * fc) * pdf + cc * pdf_coat
    return pdf


def lobe_pick(c, fet, gates):
    """bsdf_sample_c's one-sample lobe pick (parametric.cpp:179-258):
    (sel_coat, sel_metal, sel_diel) [N] bool; glossy where none holds.
    Under the coat gate it reads the coat's fetches `eavg_c` and `e_o_c`."""
    use_metal, use_diel, use_coat, _ = gates
    uc2 = c["uc2"]
    if use_coat:
        eavg_c = fet["eavg_c"]
        fms_c = FAVG15 * FAVG15 * eavg_c / maximum(1.0 - FAVG15 * (1.0 - eavg_c), 1e-6)
        e_o_c = fet["e_o_c"]
        kappa_c = 1.0 - (FAVG15 * e_o_c + fms_c * (1.0 - e_o_c))
        p_coat = c["clearcoat"] * (1.0 - kappa_c)
    else:
        p_coat = torch.zeros_like(c["metallic"])
    p_metal = (1.0 - p_coat) * c["metallic"]
    p_diel = (1.0 - p_coat) * (c["metallic"] + (1.0 - c["metallic"]) * c["transmission"])

    false = torch.zeros_like(uc2, dtype=torch.bool)
    sel_coat = (uc2 < p_coat) if use_coat else false
    sel_metal = (~sel_coat & (uc2 < p_metal)) if use_metal else false
    sel_diel = (~sel_coat & ~sel_metal & (uc2 < p_diel)) if use_diel else false
    return sel_coat, sel_metal, sel_diel


def bsdf_sample_c(c, cand, fet, gates):
    """One-sample layered BSDF sample (render/bsdf.py bsdf_sample,
    parametric.cpp:179-258), wi in the LOCAL (unrotated) frame."""
    use_metal, use_diel, use_coat, use_aniso = gates
    zero = torch.zeros_like(c["metallic"])
    sel_coat, sel_metal, sel_diel = lobe_pick(c, fet, gates)
    sel_glossy = ~sel_coat & ~sel_metal & ~sel_diel

    s = _sample_glossy_c(c, cand, fet)
    glossy_le = s["Le"]
    for use, sel, fn in ((use_diel, sel_diel, _sample_dielectric_c),
                         (use_metal, sel_metal, _sample_metallic_c),
                         (use_coat, sel_coat, _sample_clearcoat_c)):
        if not use:
            continue
        smp = fn(c, cand, fet)
        s = dict(
            flags=torch.where(sel, smp["flags"], s["flags"]),
            f=vwhere(sel, smp["f"], s["f"]),
            Le=s["Le"],
            wi=vwhere(sel, smp["wi"], s["wi"]),
            pdf=torch.where(sel, smp["pdf"], s["pdf"]),
            roughness=torch.where(sel, smp["roughness"], s["roughness"]),
        )
    s["Le"] = vwhere(sel_glossy, glossy_le, vsplat(zero))
    # un-rotate the base lobes' wi (parametric.cpp:254-255); the coat's is unrotated
    if use_aniso:
        s["wi"] = vwhere(sel_coat, s["wi"], rot_z(s["wi"], c["aniso_rotation"]))
    return s


# ---------------------------------------------------------------------------
# Stage 3: finish — everything between the two traversals of a bounce
# (render/integrator.py li body, mis-integrator.cpp:27-133)
# ---------------------------------------------------------------------------


def finish(c, cand, fet, gates, mis=True, any_lights=True, detach=False):
    """Sample pick + emitted MIS + NEE eval + throughput + roulette + state.
    Returns the dict of per-lane outputs (vectors as v3 tuples) that the
    integrator consumes after the shadow traversal.

    `detach=True` (differentiable mode) makes the same detached-sampling
    cut as the classic bounce (JAX shade_math.py:1101-1135): the sampled
    direction, its pdf and roughness become constants once the sample is
    built, f and Le keep their parameter dependence, and the roulette
    probability q is a constant, so its 1/(1-q) reweight is one too."""
    frame = cand["frame"]
    n, p, d, atten = c["n"], c["p"], c["d"], c["atten"]
    found = c["found"]
    zero = torch.zeros_like(c["last_pdf"])
    zero3 = vsplat(zero)

    smp = bsdf_sample_c(c, cand, fet, gates)
    if detach:
        smp = dict(smp, wi=tuple(w.detach() for w in smp["wi"]), pdf=smp["pdf"].detach(),
                   roughness=smp["roughness"].detach())
    flags = smp["flags"]
    wi_world = local_to_world(smp["wi"], *frame)

    # ---- emitted radiance + MIS vs the light sampler ----
    emitted = ((flags & EMITTED) != 0) & found
    if mis:
        dp = vsub(c["last_p"], p)
        dist2 = vdot(dp, dp)
        if any_lights:
            pdf_light = (c["pdf_area"] * dist2 * c["sel_p"]
                         / maximum(vdot(vneg(d), n).abs(), 1e-9))
        else:
            pdf_light = zero
        if c["depth0"]:
            w_b = torch.ones_like(zero)
        else:
            w_b = torch.where(c["specular_prev"] | c["light_neg"], 1.0,
                              c["last_pdf"] / maximum(c["last_pdf"] + pdf_light, 1e-20))
    else:
        w_b = torch.ones_like(zero)
    L_emit = vwhere(emitted, vscale(vmul(atten, smp["Le"]), w_b), zero3)

    scattered = ((flags & (REFLECTED | TRANSMITTED)) != 0) & found

    # ---- NEE: f/pdf at the sampled light direction + pending contrib ----
    if mis and any_lights:
        live = c["active"] | found
        do_nee = scattered & ((flags & (EMITTED | SPECULAR)) == 0)
        f_l = bsdf_f_c(c, cand, fet, gates)
        pdf_b = bsdf_pdf_c(c, cand, fet, gates)
        nee_need = do_nee & c["ls_valid"] & (vdot(f_l, f_l) > 0.0)
        to_l = vsub(c["ls_p"], p)
        dist2_l = vdot(to_l, to_l)
        dist_l = torch.sqrt(maximum(dist2_l, 1e-20))
        shadow_d = vwhere(live, vscale(to_l, 1.0 / dist_l), zero3)
        shadow_tmax = torch.where(nee_need, dist_l - 1e-3, -1.0)
        pdf_l = (c["ls_select_p"] * c["ls_pdf"]
                 / maximum(vdot(c["ls_n"], c["ls_wi"]).abs(), 1e-9))
        pdf_l = torch.where(c["ls_is_env"], pdf_l, pdf_l * dist2_l)
        w_nee = vdot(c["ls_wi"], n).abs() / maximum(pdf_b + pdf_l, 1e-20)
        contrib = vwhere(live, vmul(atten, vscale(vmul(c["ls_Li"], f_l), w_nee)), zero3)
    else:
        nee_need = torch.zeros_like(found)
        shadow_d = zero3
        shadow_tmax = torch.full_like(zero, -1.0)
        contrib = zero3

    # ---- throughput update (mis-integrator.cpp:83-96) ----
    fcos = vscale(smp["f"], vdot(wi_world, n).abs())
    atten_new = vmul(atten, vscale(fcos, 1.0 / maximum(smp["pdf"], 1e-20)))
    vc = c["volume_color"]
    dens = c["volume_density"]
    t = c["hit_t"]
    vol = tuple(torch.exp((vc[k] - 1.0) * t * dens) for k in range(3))
    vol = vwhere(c["thin"], vsplat(torch.ones_like(zero)), vol)
    atten_new = vwhere(c["hit_back"] & scattered, vmul(atten_new, vol), atten_new)

    active = c["active"] & scattered
    specular = (flags & SPECULAR) != 0
    acc_rough = c["acc_rough"] + torch.where(scattered, smp["roughness"], 0.0)

    # ---- russian roulette (mis-integrator.cpp:98-102) ----
    if mis:
        q = maximum(
            1.0 - torch.maximum(atten_new[0], torch.maximum(atten_new[1], atten_new[2])), 0.0)
        if detach:
            q = q.detach()
        rr_on = active if c["rr_on"] else torch.zeros_like(active)
        killed = rr_on & (c["u_rr"] < q)
        active = active & ~killed
        scale = torch.where(rr_on & ~killed, 1.0 / maximum(1.0 - q, 1e-9), 1.0)
        atten_new = vscale(atten_new, scale)

    return dict(
        L_emit=L_emit,
        contrib=contrib,
        nee_need=nee_need,
        shadow_d=shadow_d,
        shadow_tmax=shadow_tmax,
        o=vwhere(active, p, c["o"]),
        d=vwhere(active, wi_world, d),
        atten=vwhere(active, atten_new, atten),
        active=active,
        specular=(active & specular) | (~active & c["specular_prev"]),
        acc_rough=acc_rough,
        last_pdf=torch.where(active, smp["pdf"], c["last_pdf"]),
        last_p=vwhere(active, p, c["last_p"]),
    )


def components(inp):
    """`inp` with its [N, 3] tensors split into v3 tuples."""
    return {k: split3(v) if k in V3_KEYS else v for k, v in inp.items()}


def shade(inp, gates, mis, any_lights, tables, force_reg=None, detach=False):
    """candidates -> run_fetches -> finish: the `shade_kernel="xla"` bounce
    tail and B5's plain twin (`detach` for differentiable mode, not B5's).
    Returns finish's outputs with the vectors stacked into [N, 3] tensors."""
    c = components(inp)
    cand = candidates(c, gates, force_reg)
    fet = run_fetches(tables, cand["coords"])
    out = finish(c, cand, fet, gates, mis=mis, any_lights=any_lights, detach=detach)
    return {k: torch.stack(v, dim=-1) if k in OUT_V3 else v for k, v in out.items()}
