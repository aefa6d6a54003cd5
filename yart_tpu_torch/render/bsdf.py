"""Parametric layered uber-BSDF, batched and branchless.

Port of `yart_tpu/render/bsdf.py` (src/bsdf/parametric.cpp): every lane
carries resolved material parameters and all lobes are evaluated with
masked arithmetic; sampling selects one lobe by uc2 against the
{clearcoat, metallic, dielectric} thresholds (parametric.cpp:212-255).
The three reproduced reference quirks are kept: the backside LUT
extrapolation (ops/lut.py), the signed-cos thin transmission in
`_f_dielectric`, and the unrotated `bsdf_pdf`. Directions are in the local
shading frame (z = shading normal). `resolve_material` modulates the
material rows by the scene's textures at the hit uv.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from yart_tpu_torch.ops import ggx, lut, warps
from yart_tpu_torch.ops.vecmath import (absdot, clip, dot, fresnel_dielectric, fresnel_schlick, maximum,
                                        refract)
from yart_tpu_torch.render.texture import sample_stack
from yart_tpu_torch.scene.types import CompiledScene, SceneMeta

PI = math.pi

# Scatter flags (src/core/bsdf.hpp:21-29)
ABSORBED = 0
EMITTED = 1
REFLECTED = 2
TRANSMITTED = 4
DIFFUSE = 8
GLOSSY = 16
SPECULAR = 32


class LaneMaterial(NamedTuple):
    """Per-lane resolved material parameters."""

    base: torch.Tensor  # [N, 3]
    metallic: torch.Tensor  # [N]
    roughness: torch.Tensor  # [N]
    roughness_base: torch.Tensor  # [N]
    transmission: torch.Tensor  # [N]
    ior: torch.Tensor  # [N]
    anisotropic: torch.Tensor  # [N]
    aniso_rotation: torch.Tensor  # [N] radians
    clearcoat: torch.Tensor  # [N]
    cc_roughness: torch.Tensor  # [N]
    cc_roughness_base: torch.Tensor  # [N]
    emission: torch.Tensor  # [N, 3]
    thin: torch.Tensor  # [N] bool
    volume_color: torch.Tensor  # [N, 3]
    volume_density: torch.Tensor  # [N]


class BSDFSample(NamedTuple):
    """SoA BSDFSample (src/core/bsdf.hpp:20-41)."""

    flags: torch.Tensor  # [N] int32 bitmask
    f: torch.Tensor  # [N, 3]
    Le: torch.Tensor  # [N, 3]
    wi: torch.Tensor  # [N, 3]
    pdf: torch.Tensor  # [N]
    roughness: torch.Tensor  # [N]


def has_flag(flags, bit):
    return (flags & bit) != 0


def _flags(cond, a: int, b):
    """int32 flags: a where cond else b (b an int or a flag tensor)."""
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(cond, b, dtype=torch.int32)
    return torch.where(cond, torch.full_like(b, a), b)


def roughen(r):
    """Path-regularization roughening (src/core/bsdf.hpp:16-18)."""
    return torch.maximum(r, clip(r * 2.0, 0.1, 0.3))


def resolve_material(scene: CompiledScene, meta: SceneMeta, mat_idx, uv=None) -> LaneMaterial:
    """Material row fetch and texture modulation (parametric.cpp:88-110;
    yart_tpu/render/bsdf.py:133-157). Textured scenes need the hit `uv`
    [N, 2]: base colour x tex^2 (gamma-2 decode), roughness and metallic x
    the 2ch map's channels 0 and 1, transmission and clearcoat (and its
    roughness) x mono maps, emission x tex^2."""
    if meta.any_textures and uv is None:
        raise ValueError("textured materials need the hit uv")
    m = scene.materials
    idx = mat_idx.long()
    base = m.base_color[idx, :3]
    metallic = m.metallic[idx]
    rough = m.roughness[idx]
    trans = m.transmission[idx]
    cc = m.clearcoat[idx]
    ccr = m.cc_roughness[idx]
    emission = m.emission[idx]
    if meta.any_textures:
        tb = m.tex_base[idx]
        bt = sample_stack(scene.tex_rgba, tb, uv)[..., :3]
        base = torch.where((tb >= 0)[..., None], base * (bt * bt), base)
        tmr = m.tex_mr[idx]
        mr = sample_stack(scene.tex_2ch, tmr, uv)
        rough = torch.where(tmr >= 0, rough * mr[..., 0], rough)
        metallic = torch.where(tmr >= 0, metallic * mr[..., 1], metallic)
        tt = m.tex_transmission[idx]
        trans = torch.where(tt >= 0, trans * sample_stack(scene.tex_mono, tt, uv)[..., 0], trans)
        tc = m.tex_clearcoat[idx]
        cct = sample_stack(scene.tex_mono, tc, uv)[..., 0]
        cc = torch.where(tc >= 0, cc * cct, cc)
        ccr = torch.where(tc >= 0, ccr * cct, ccr)
        te = m.tex_emission[idx]
        em = sample_stack(scene.tex_rgb, te, uv)
        emission = torch.where((te >= 0)[..., None], emission * (em * em), emission)
    return LaneMaterial(
        base=base,
        metallic=metallic,
        roughness=rough,
        roughness_base=m.roughness[idx],
        transmission=trans,
        ior=m.ior[idx],
        anisotropic=m.anisotropic[idx],
        aniso_rotation=m.aniso_rotation[idx],
        clearcoat=cc,
        cc_roughness=ccr,
        cc_roughness_base=m.cc_roughness[idx],
        emission=emission,
        thin=m.thin[idx],
        volume_color=m.volume_color[idx],
        volume_density=m.volume_density[idx],
    )


def volume_attenuation(mat: LaneMaterial, d):
    """Beer-Lambert attenuation on backside hits (parametric.cpp:834-838)."""
    att = torch.exp((mat.volume_color - 1.0) * d[..., None] * mat.volume_density[..., None])
    return torch.where(mat.thin[..., None], 1.0, att)


def _rot_z(v, angle):
    """Rotate the xy components about +z (parametric.cpp:50-51)."""
    c = torch.cos(angle)
    s = torch.sin(angle)
    return torch.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1], v[..., 2]], dim=-1)


def _favg_fit(ior):
    """Average Fresnel fit (KC2017; parametric.cpp:7-9)."""
    return (ior - 1.0) / (4.08567 + 1.00071 * ior)


def _outward(wm):
    """Normalize a half-vector and flip it to the upper hemisphere."""
    n2 = (wm * wm).sum(dim=-1, keepdim=True)
    ok = n2[..., 0] > 1e-20
    n2m = torch.where(n2 > 1e-20, n2, 1.0)
    wm = wm * torch.where(n2 > 1e-20, 1.0 / torch.sqrt(n2m), 0.0)
    wm = torch.where(wm[..., 2:3] < 0.0, -wm, wm)
    return wm, ok


def _safe_div(a, b, eps=1e-20):
    """a / b with |b| clamped away from 0, keeping its sign."""
    small = b.abs() < eps
    return a / torch.where(small, torch.where(b < 0, -eps, eps), b)


def _mirror(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


def _reflect(wo, wm):
    return -wo + 2.0 * dot(wo, wm, keepdim=True) * wm


# ---------------------------------------------------------------------------
# Lobe evaluation (f / pdf)
# ---------------------------------------------------------------------------


def _f_metallic(tables, mat, a, wo, wi):
    """(parametric.cpp:260-286)"""
    cos_o = wo[..., 2].abs()
    cos_i = wi[..., 2].abs()
    wm, ok = _outward(wo + wi)
    ok = ok & (cos_o > 0) & (cos_i > 0) & ~ggx.smooth(a)
    fss = fresnel_schlick(mat.base, absdot(wo, wm)[..., None])
    mss = fss * (ggx.mdf(a, wm) * ggx.g(a, wo, wi) / maximum(4 * cos_o * cos_i, 1e-12))[..., None]
    ess = maximum(lut.ggx_e(tables, cos_o, a.roughness), 1e-4)
    mms = mss * mat.base * ((1.0 - ess) / ess)[..., None]
    return torch.where(ok[..., None], mss + mms, 0.0)


def _pdf_metallic(tables, mat, a, wo, wi):
    """(parametric.cpp:288-305)"""
    wm, ok = _outward(wo + wi)
    ok = ok & ~ggx.smooth(a)
    pdf = ggx.vmdf(a, wo, wm) / maximum(4 * absdot(wo, wm), 1e-12)
    return torch.where(ok, pdf, 0.0)


def _f_dielectric(tables, mat, a, wo, wi):
    """(parametric.cpp:354-414)"""
    cos_o = wo[..., 2]
    cos_i = wi[..., 2]
    is_refl = cos_o * cos_i > 0.0
    ior = torch.where(is_refl, 1.0, torch.where(cos_o > 0.0, mat.ior, 1.0 / mat.ior))

    wm, ok = _outward(ior[..., None] * wi + wo)
    ok = ok & (cos_i != 0) & (cos_o != 0) & ~ggx.smooth(a)
    ok = ok & (dot(wm, wi) * cos_i >= 0.0) & (dot(wm, wo) * cos_o >= 0.0)

    fss = fresnel_dielectric(absdot(wo, wm), ior)
    t = 1.0 - fss
    e_o = maximum(lut.ggx_glass_e(tables, ior, a.roughness, cos_o.abs()), 1e-4)
    d_g = ggx.mdf(a, wm) * ggx.g(a, wo, wi)

    f_refl = fss * d_g / maximum((4 * cos_o * cos_i).abs(), 1e-12)

    # Thin transmission: flip wi and evaluate as reflection. The reference
    # divides by the SIGNED cos_o (parametric.cpp:399-402), so backside
    # evaluations give negative f; reproduced (parity-load-bearing).
    wip = torch.stack([wi[..., 0], wi[..., 1], -wi[..., 2]], dim=-1)
    wm_thin, ok_thin = _outward(wip + wo)
    cos_ip = wip[..., 2].abs()
    tss_thin = ggx.mdf(a, wm_thin) * ggx.g(a, wo, wip) * _safe_div(
        torch.ones_like(cos_o), 4 * cos_o * cos_ip, eps=1e-12
    )

    temp = dot(wi, wm) * ior + dot(wo, wm)
    dwm_dwi = absdot(wi, wm) * absdot(wo, wm) / maximum(temp * temp, 1e-12)
    tss = d_g * dwm_dwi / maximum((cos_i * cos_o).abs(), 1e-12)

    trans_ss = torch.where(mat.thin, torch.where(ok_thin, tss_thin, 0.0), tss)
    f_trans = (t * trans_ss)[..., None] * mat.base
    out = torch.where(is_refl[..., None], (f_refl / e_o)[..., None], f_trans / e_o[..., None])
    return torch.where(ok[..., None], out, 0.0)


def _pdf_dielectric(tables, mat, a, wo, wi):
    """(parametric.cpp:416-460)"""
    cos_o = wo[..., 2]
    cos_i = wi[..., 2]
    is_refl = cos_o * cos_i > 0.0
    ior = torch.where(is_refl, 1.0, torch.where(cos_o > 0.0, mat.ior, 1.0 / mat.ior))

    wm, ok = _outward(ior[..., None] * wi + wo)
    ok = ok & (cos_i != 0) & (cos_o != 0) & ~ggx.smooth(a)
    ok = ok & (dot(wm, wi) * cos_i >= 0.0) & (dot(wm, wo) * cos_o >= 0.0)

    # The reference uses the signed dot and the material ior here
    # (parametric.cpp:438-440).
    f = fresnel_dielectric(dot(wo, wm), mat.ior)
    t = 1.0 - f
    pdf_refl = ggx.vmdf(a, wo, wm) / maximum(4 * absdot(wo, wm), 1e-12) * f

    wip = torch.stack([wi[..., 0], wi[..., 1], -wi[..., 2]], dim=-1)
    wm_thin, _ = _outward(wip + wo)
    pdf_thin = ggx.vmdf(a, wo, wm_thin) / maximum(4 * absdot(wo, wm_thin), 1e-12) * t

    temp2 = dot(wi, wm) + dot(wo, wm) / ior
    dwm_dwi2 = absdot(wo, wm) / maximum(temp2 * temp2, 1e-12)
    pdf_refr = ggx.vmdf(a, wo, wm) * dwm_dwi2 * t

    pdf = torch.where(is_refl, pdf_refl, torch.where(mat.thin, pdf_thin, pdf_refr))
    return torch.where(ok, pdf, 0.0)


def _glossy_diffuse_factor(tables, mat, a, cos_o, cos_i):
    """Kulla-Conty energy-conserving diffuse weight (parametric.cpp:606-613)."""
    r0 = (1.0 - mat.ior) / (1.0 + mat.ior)
    f0 = r0 * r0
    e_wo = lut.ggx_base_e(tables, f0, a.roughness, cos_o)
    e_wi = lut.ggx_base_e(tables, f0, a.roughness, cos_i)
    eavg = lut.ggx_base_eavg(tables, f0, a.roughness)
    return (1.0 - e_wo) * (1.0 - e_wi) / maximum(PI * (1.0 - eavg), 1e-6)


def _f_glossy(tables, mat, a, wo, wi):
    """(parametric.cpp:577-617)"""
    cos_o = wo[..., 2].abs()
    cos_i = wi[..., 2].abs()
    wm, ok = _outward(wo + wi)
    ok = ok & (cos_o > 0) & (cos_i > 0)
    rough_ok = ok & ~ggx.smooth(a)

    fss = fresnel_dielectric(dot(wo, wm), mat.ior)
    mss = ggx.mdf(a, wm) * ggx.g(a, wo, wi) / maximum(4 * cos_o * cos_i, 1e-12)

    favg = _favg_fit(mat.ior)
    eavg = lut.ggx_eavg(tables, a.roughness)
    e_o = lut.ggx_e(tables, cos_o, a.roughness)
    e_i = lut.ggx_e(tables, cos_i, a.roughness)
    mms = (1.0 - e_o) * (1.0 - e_i) / maximum(PI * (1.0 - eavg), 1e-6)
    fms = favg * favg * eavg / maximum(1.0 - favg * (1.0 - eavg), 1e-6)

    c_diffuse = _glossy_diffuse_factor(tables, mat, a, cos_o, cos_i)
    diffuse = mat.base * c_diffuse[..., None]
    spec = torch.where(rough_ok, fss * mss + mms * fms, 0.0)
    return torch.where(ok[..., None], spec[..., None] + diffuse, 0.0)


def _pdf_glossy(tables, mat, a, wo, wi):
    """(parametric.cpp:619-645)"""
    cos_o = wo[..., 2].abs()
    cos_i = wi[..., 2].abs()
    wm, ok = _outward(wo + wi)

    fss = fresnel_dielectric(dot(wo, wm), mat.ior)
    favg = _favg_fit(mat.ior)
    eavg = lut.ggx_eavg(tables, a.roughness)
    fms = favg * favg * eavg / maximum(1.0 - favg * (1.0 - eavg), 1e-6)
    e_o = lut.ggx_e(tables, cos_o, a.roughness)
    kappa = 1.0 - (favg * e_o + fms * (1.0 - e_o))

    spec_pdf = (fss + fms) * ggx.vmdf(a, wo, wm) / maximum(4 * absdot(wo, wm), 1e-12)
    spec_pdf = torch.where(ok & ~ggx.smooth(a), spec_pdf, 0.0)
    return spec_pdf + cos_i * kappa


def _f_clearcoat(tables, mat, a_coat, wo, wi):
    """(parametric.cpp:732-766); returns (f_scalar, Fc)."""
    cos_o = wo[..., 2].abs()
    cos_i = wi[..., 2].abs()
    wm, ok = _outward(wo + wi)
    ok = ok & (cos_o > 0) & (cos_i > 0) & ~ggx.smooth(a_coat)
    fss = fresnel_dielectric(dot(wo, wm), 1.5)
    mss = ggx.mdf(a_coat, wm) * ggx.g(a_coat, wo, wi) / maximum(4 * cos_o * cos_i, 1e-12)
    fc = torch.maximum(fresnel_dielectric(cos_o, 1.5), fresnel_dielectric(cos_i, 1.5))
    return torch.where(ok, fss * mss, 0.0), fc


def _pdf_clearcoat(tables, mat, a_coat, wo, wi):
    """(parametric.cpp:768-793); returns (pdf, Fc)."""
    wm, ok = _outward(wo + wi)
    ok = ok & ~ggx.smooth(a_coat)
    fss = fresnel_dielectric(dot(wo, wm), 1.5)
    pdf = fss * ggx.vmdf(a_coat, wo, wm) / maximum(4 * absdot(wo, wm), 1e-12)
    fc = torch.maximum(
        fresnel_dielectric(wo[..., 2].abs(), 1.5), fresnel_dielectric(wi[..., 2].abs(), 1.5)
    )
    return torch.where(ok, pdf, 0.0), fc


# ---------------------------------------------------------------------------
# Public f / pdf / sample
# ---------------------------------------------------------------------------


def _lobe_flags(meta):
    """Static lobe-usage gates: scenes without a lobe skip it."""
    if meta is None:
        return True, True, True, True
    return meta.any_metallic, meta.any_transmissive, meta.any_clearcoat, meta.any_anisotropy


def bsdf_f(tables, mat: LaneMaterial, wo, wi, meta=None):
    """Full layered f (parametric.cpp:84-132). Local-frame wo/wi [N, 3]."""
    use_metal, use_diel, use_coat, use_aniso = _lobe_flags(meta)
    a = ggx.make_alphas(mat.roughness, mat.anisotropic if use_aniso else None)
    wo_r = _rot_z(wo, -mat.aniso_rotation) if use_aniso else wo
    wi_r = _rot_z(wi, -mat.aniso_rotation) if use_aniso else wi

    c_metal = mat.metallic
    c_diel = (1.0 - mat.metallic) * mat.transmission
    c_glossy = (1.0 - mat.metallic) * (1.0 - mat.transmission)

    val = c_glossy[..., None] * _f_glossy(tables, mat, a, wo_r, wi_r)
    if use_metal:
        val = val + c_metal[..., None] * _f_metallic(tables, mat, a, wo_r, wi_r)
    if use_diel:
        val = val + c_diel[..., None] * _f_dielectric(tables, mat, a, wo_r, wi_r)
    if use_coat:
        f_coat, fc = _f_clearcoat(tables, mat, ggx.make_alphas(mat.cc_roughness), wo_r, wi_r)
        c = mat.clearcoat
        val = (1.0 - c * fc)[..., None] * val + (c * f_coat)[..., None]
    return val


def bsdf_pdf(tables, mat: LaneMaterial, wo, wi, meta=None):
    """Full layered pdf (parametric.cpp:135-177). Like the reference's
    pdfImpl it does NOT apply the anisotropy rotation (reproduced quirk)."""
    use_metal, use_diel, use_coat, use_aniso = _lobe_flags(meta)
    a = ggx.make_alphas(mat.roughness, mat.anisotropic if use_aniso else None)

    p_metal = mat.metallic
    p_diel = (1.0 - mat.metallic) * mat.transmission
    p_glossy = (1.0 - mat.metallic) * (1.0 - mat.transmission)

    pdf = p_glossy * _pdf_glossy(tables, mat, a, wo, wi)
    if use_metal:
        pdf = pdf + p_metal * _pdf_metallic(tables, mat, a, wo, wi)
    if use_diel:
        pdf = pdf + p_diel * _pdf_dielectric(tables, mat, a, wo, wi)
    if use_coat:
        pdf_coat, fc = _pdf_clearcoat(tables, mat, ggx.make_alphas(mat.cc_roughness), wo, wi)
        c = mat.clearcoat
        pdf = (1.0 - c * fc) * pdf + c * pdf_coat
    return pdf


def bsdf_sample(tables, mat: LaneMaterial, wo, u, uc, uc2, regularized, meta=None):
    """Full layered sample (parametric.cpp:179-258). `regularized` [N] bool
    applies roughen() per lane. Invalid samples get flags == ABSORBED."""
    use_metal, use_diel, use_coat, use_aniso = _lobe_flags(meta)
    r = torch.where(regularized, roughen(mat.roughness), mat.roughness)
    false = torch.zeros_like(regularized)

    if use_coat:
        cr = torch.where(regularized, roughen(mat.cc_roughness), mat.cc_roughness)
        a_coat = ggx.make_alphas(cr)
        wm_coat = ggx.sample_visible(a_coat, wo, u)
        favg15 = _favg_fit(1.5)
        eavg_c = lut.ggx_eavg(tables, cr)
        fms_c = favg15 * favg15 * eavg_c / maximum(1.0 - favg15 * (1.0 - eavg_c), 1e-6)
        e_o_c = lut.ggx_e(tables, clip(absdot(wo, wm_coat), 0, 1), cr)
        kappa_c = 1.0 - (favg15 * e_o_c + fms_c * (1.0 - e_o_c))
        p_coat = mat.clearcoat * (1.0 - kappa_c)
    else:
        p_coat = torch.zeros_like(mat.metallic)

    p_metal = (1.0 - p_coat) * mat.metallic
    p_diel = (1.0 - p_coat) * (mat.metallic + (1.0 - mat.metallic) * mat.transmission)

    sel_coat = (uc2 < p_coat) if use_coat else false
    sel_metal = (~sel_coat & (uc2 < p_metal)) if use_metal else false
    sel_diel = (~sel_coat & ~sel_metal & (uc2 < p_diel)) if use_diel else false
    sel_glossy = ~sel_coat & ~sel_metal & ~sel_diel

    a = ggx.make_alphas(r, mat.anisotropic if use_aniso else None)
    wo_r = _rot_z(wo, -mat.aniso_rotation) if use_aniso else wo
    wm = ggx.sample_visible(a, wo_r, u)
    smooth = ggx.smooth(a)

    picks = [(None, _sample_glossy(tables, mat, a, smooth, wo_r, wm, u, uc))]
    if use_diel:
        picks.append((sel_diel, _sample_dielectric(tables, mat, a, smooth, wo_r, wm, uc)))
    if use_metal:
        picks.append((sel_metal, _sample_metallic(tables, mat, a, smooth, wo_r, wm)))
    if use_coat:
        picks.append((sel_coat, _sample_clearcoat(tables, mat, a_coat, wo, wm_coat, cr)))

    def pick(field):
        out = getattr(picks[0][1], field)
        for sel, smp in picks[1:]:
            fv = getattr(smp, field)
            out = torch.where(sel[..., None] if fv.dim() > sel.dim() else sel, fv, out)
        return out

    wi = pick("wi")
    if use_aniso:  # un-rotate base-lobe wi; clearcoat is unrotated
        wi = torch.where(sel_coat[..., None], wi, _rot_z(wi, mat.aniso_rotation))
    return BSDFSample(
        flags=pick("flags"),
        f=pick("f"),
        Le=torch.where(sel_glossy[..., None], picks[0][1].Le, 0.0),
        wi=wi,
        pdf=pick("pdf"),
        roughness=pick("roughness"),
    )


def _sample_metallic(tables, mat, a, smooth, wo, wm):
    """(parametric.cpp:307-352)"""
    wi_s = _mirror(wo)
    f_s = fresnel_schlick(mat.base, wo[..., 2:3]) / maximum(wo[..., 2:3].abs(), 1e-12)

    wi = _reflect(wo, wm)
    valid = wo[..., 2] * wi[..., 2] >= 0.0
    pdf = ggx.vmdf(a, wo, wm) / maximum(4 * absdot(wo, wm), 1e-12)
    cos_o = wo[..., 2].abs()
    cos_i = wi[..., 2].abs()
    fss = fresnel_schlick(mat.base, absdot(wo, wm)[..., None])
    mss = fss * (ggx.mdf(a, wm) * ggx.g(a, wo, wi) / maximum(4 * cos_o * cos_i, 1e-12))[..., None]
    ess = maximum(lut.ggx_e(tables, cos_o, a.roughness), 1e-4)
    f = mss * (1.0 + mat.base * ((1.0 - ess) / ess)[..., None])

    flags_r = _flags(valid, REFLECTED | GLOSSY, ABSORBED)
    return BSDFSample(
        flags=_flags(smooth, REFLECTED | SPECULAR, flags_r),
        f=torch.where(smooth[..., None], f_s, torch.where(valid[..., None], f, 0.0)),
        Le=torch.zeros_like(f),
        wi=torch.where(smooth[..., None], wi_s, wi),
        pdf=torch.where(smooth, 1.0, pdf),
        roughness=torch.where(smooth, 0.0, mat.roughness_base),
    )


def _sample_dielectric(tables, mat, a, smooth, wo, wm, uc):
    """(parametric.cpp:462-575)"""
    ior_rel = torch.where(mat.thin | (wo[..., 2] > 0.0), mat.ior, 1.0 / mat.ior)

    # ---- smooth (delta) case ----
    f_spec = fresnel_dielectric(wo[..., 2].abs(), ior_rel)
    refl_s = uc < f_spec
    wi_s_refl = _mirror(wo)
    z_axis = torch.zeros_like(wo)
    z_axis[..., 2] = 1.0
    wi_s_refr, tir_s = refract(wo, z_axis, mat.ior)
    wi_s_refr = torch.where(mat.thin[..., None], -wo, wi_s_refr)
    tir_s = tir_s & ~mat.thin
    wi_s = torch.where(refl_s[..., None], wi_s_refl, wi_s_refr)
    t_spec = 1.0 - f_spec
    f_s = torch.where(
        refl_s[..., None],
        (f_spec / maximum(wi_s_refl[..., 2].abs(), 1e-12))[..., None],
        (t_spec / maximum(wi_s_refr[..., 2].abs(), 1e-12))[..., None] * mat.base,
    )
    pdf_s = torch.where(refl_s, f_spec, t_spec)
    flags_s = _flags(refl_s, REFLECTED | SPECULAR, _flags(tir_s, ABSORBED, TRANSMITTED | SPECULAR))

    # ---- rough case ----
    fss = fresnel_dielectric(absdot(wo, wm), ior_rel)
    cos_o = wo[..., 2].abs()
    e_o = maximum(lut.ggx_glass_e(tables, ior_rel, a.roughness, cos_o), 1e-4)
    refl = uc < fss
    vis = ggx.vmdf(a, wo, wm) / maximum(4 * absdot(wo, wm), 1e-12)

    wi_r = _reflect(wo, wm)
    ok_r = wo[..., 2] * wi_r[..., 2] >= 0.0
    cos_i_r = wi_r[..., 2].abs()
    mss_r = ggx.mdf(a, wm) * ggx.g(a, wo, wi_r) / maximum(4 * cos_o * cos_i_r, 1e-12)
    f_r = (fss * mss_r / e_o)[..., None]
    pdf_r = vis * fss

    # thin transmission: reflect(wo, wm) * (1, 1, -1)
    wi_thin = torch.stack([wi_r[..., 0], wi_r[..., 1], -wi_r[..., 2]], dim=-1)
    cos_i_t = wi_thin[..., 2].abs()
    tss_thin = ggx.mdf(a, wm) * ggx.g(a, wo, wi_thin) / maximum(4 * cos_o * cos_i_t, 1e-12)
    f_thin = ((1.0 - fss) * tss_thin / e_o)[..., None] * mat.base
    pdf_thin = vis * (1.0 - fss)

    # full refraction
    wi_t, tir = refract(wo, wm, mat.ior)
    bad_t = tir | (wo[..., 2] * wi_t[..., 2] > 0.0) | (wi_t[..., 2] == 0.0)
    temp = dot(wi_t, wm) * ior_rel + dot(wo, wm)
    dwm_dwi = absdot(wi_t, wm) / maximum(temp * temp, 1e-12)
    pdf_t = ggx.vmdf(a, wo, wm) * dwm_dwi * (1.0 - fss)
    tss = ggx.mdf(a, wm) * ggx.g(a, wo, wi_t) * _safe_div(
        dot(wi_t, wm) * dot(wo, wm), wi_t[..., 2] * wo[..., 2] * temp * temp
    ).abs()
    f_t = ((1.0 - fss) * tss / e_o)[..., None] * mat.base

    use_thin = ~refl & mat.thin
    wi_rough = torch.where(refl[..., None], wi_r, torch.where(use_thin[..., None], wi_thin, wi_t))
    f_rough = torch.where(refl[..., None], f_r, torch.where(use_thin[..., None], f_thin, f_t))
    pdf_rough = torch.where(refl, pdf_r, torch.where(use_thin, pdf_thin, pdf_t))
    flags_rough = torch.where(
        refl,
        _flags(ok_r, REFLECTED | GLOSSY, ABSORBED),
        _flags(use_thin | ~bad_t, TRANSMITTED | GLOSSY, ABSORBED),
    )
    return BSDFSample(
        flags=torch.where(smooth, flags_s, flags_rough),
        f=torch.where(smooth[..., None], f_s, f_rough),
        Le=torch.zeros_like(f_rough),
        wi=torch.where(smooth[..., None], wi_s, wi_rough),
        pdf=torch.where(smooth, pdf_s, pdf_rough),
        roughness=torch.where(smooth, 0.0, a.roughness),
    )


def _sample_glossy(tables, mat, a, smooth, wo, wm, u, uc):
    """(parametric.cpp:648-730)"""
    cos_o = wo[..., 2]
    favg = _favg_fit(mat.ior)
    eavg = lut.ggx_eavg(tables, a.roughness)
    fms = favg * favg * eavg / maximum(1.0 - favg * (1.0 - eavg), 1e-6)
    # RAW sign-carrying cosine, like parametric.cpp:658-662: backside
    # evaluations extrapolate off the LUT edge.
    e_o = lut.ggx_e(tables, cos_o, a.roughness)
    kappa = 1.0 - (favg * e_o + fms * (1.0 - e_o))
    sel_diffuse = uc < kappa

    # ---- diffuse ----
    wi_d = warps.sample_cosine_hemisphere(u)
    wi_d = torch.where((cos_o < 0)[..., None], -wi_d, wi_d)
    cos_i_d = wi_d[..., 2]
    c_diffuse = _glossy_diffuse_factor(tables, mat, a, cos_o, cos_i_d)
    f_d = mat.base * c_diffuse[..., None]
    pdf_d = cos_i_d.abs() * c_diffuse
    emissive = (mat.emission * mat.emission).sum(dim=-1) > 0.0
    flags_d = _flags(emissive, REFLECTED | DIFFUSE | EMITTED, REFLECTED | DIFFUSE)

    # ---- smooth specular ----
    f_spec = fresnel_dielectric(cos_o, mat.ior)
    wi_s = _mirror(wo)
    f_s = (f_spec / maximum(wi_s[..., 2].abs(), 1e-12))[..., None]

    # ---- rough reflection ----
    wi_g = _reflect(wo, wm)
    cos_i_g = wi_g[..., 2]
    ok_g = cos_o * cos_i_g >= 0.0
    fss = fresnel_dielectric(dot(wo, wm), mat.ior)
    mss = ggx.mdf(a, wm) * ggx.g(a, wo, wi_g) / maximum((4 * cos_o * cos_i_g).abs(), 1e-12)
    e_i = lut.ggx_e(tables, cos_i_g, a.roughness)
    mms = (1.0 - e_o) * (1.0 - e_i) / maximum(PI * (1.0 - eavg), 1e-6)
    f_g = (fss * mss + fms * mms)[..., None]
    pdf_g = ggx.vmdf(a, wo, wm) / maximum(4 * absdot(wo, wm), 1e-12) * fss
    flags_g = _flags(ok_g, REFLECTED | GLOSSY, ABSORBED)

    # combine: diffuse < smooth specular < rough glossy
    spec_flags = _flags(smooth, REFLECTED | SPECULAR, flags_g)
    spec_f = torch.where(smooth[..., None], f_s, torch.where(ok_g[..., None], f_g, 0.0))
    spec_wi = torch.where(smooth[..., None], wi_s, wi_g)
    spec_pdf = torch.where(smooth, f_spec, pdf_g)
    spec_rough = torch.where(smooth, 0.0, a.roughness)
    return BSDFSample(
        flags=torch.where(sel_diffuse, flags_d, spec_flags),
        f=torch.where(sel_diffuse[..., None], f_d, spec_f),
        Le=torch.where(sel_diffuse[..., None], mat.emission, 0.0),
        wi=torch.where(sel_diffuse[..., None], wi_d, spec_wi),
        pdf=torch.where(sel_diffuse, pdf_d, spec_pdf),
        roughness=torch.where(sel_diffuse, 1.0, spec_rough),
    )


def _sample_clearcoat(tables, mat, a_coat, wo, wm_coat, cr):
    """(parametric.cpp:795-832)"""
    smooth = ggx.smooth(a_coat)
    cos_o = wo[..., 2]
    # The reference uses the material ior for the smooth coat, not 1.5
    # (parametric.cpp:804).
    f_spec = fresnel_dielectric(cos_o, mat.ior)
    wi_s = _mirror(wo)
    f_s = (f_spec / maximum(wi_s[..., 2].abs(), 1e-12))[..., None]

    wi = _reflect(wo, wm_coat)
    ok = cos_o * wi[..., 2] >= 0.0
    fss = fresnel_dielectric(dot(wo, wm_coat), 1.5)
    mss = ggx.mdf(a_coat, wm_coat) * ggx.g(a_coat, wo, wi) / maximum(
        (4 * cos_o * wi[..., 2]).abs(), 1e-12
    )
    pdf = fss * ggx.vmdf(a_coat, wo, wm_coat) / maximum(4 * absdot(wo, wm_coat), 1e-12)
    f = (fss * mss)[..., None]
    return BSDFSample(
        flags=_flags(smooth, REFLECTED | SPECULAR, _flags(ok, REFLECTED | GLOSSY, ABSORBED)),
        f=torch.where(smooth[..., None], f_s, torch.where(ok[..., None], f, 0.0)).expand_as(wo),
        Le=torch.zeros_like(wo),
        wi=torch.where(smooth[..., None], wi_s, wi),
        pdf=torch.where(smooth, f_spec, pdf),
        roughness=torch.where(smooth, 0.0, mat.cc_roughness_base),
    )
