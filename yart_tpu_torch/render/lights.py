"""Light sampling: power-weighted selection, area and environment lights.

Port of `yart_tpu/render/lights.py`:
- PowerLightSampler (light-sampler.cpp:32-93): the infinite light gets the
  reserved probability pInf = nInf / (nInf + 1); area lights are chosen by
  a search of the power CDF. UniformLightSampler (:11-21) puts the env
  light at the last index.
- AreaLight::sample (light.cpp:44-73): a uniform barycentric point on an
  emissive triangle, pdf = 1 / area.
- ImageInfiniteLight (light.cpp:137-242): an octahedral map, importance
  sampled through an alias table over its bilinear base cells
  (ops/distribution.py); pdf(wi) = pdf_uv / 4pi; the sampled point is
  pushed to twice the scene radius. With portal bounds the radiance and
  the sampling weights outside the rect are zero. A uniform env
  (`SceneMeta.env_sampleable` False) shines on misses only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from yart_tpu_torch.ops import warps
from yart_tpu_torch.ops.distribution import ONE_MINUS_EPS, sample_alias_rows
from yart_tpu_torch.ops.vecmath import inv_octahedral_uv, mat3_rows, maximum, normalize, octahedral_uv
from yart_tpu_torch.scene.types import CompiledScene, SceneMeta

FOUR_PI = 4.0 * math.pi


class LightSample(NamedTuple):
    """SoA LightSample (src/core/light.hpp:10) + selection probability."""

    Li: torch.Tensor  # [N, 3]
    wi: torch.Tensor  # [N, 3]
    p: torch.Tensor  # [N, 3] point on the light
    n: torch.Tensor  # [N, 3] light normal
    pdf: torch.Tensor  # [N] area-measure pdf (solid angle for the env)
    select_p: torch.Tensor  # [N]
    is_env: torch.Tensor  # [N] bool
    valid: torch.Tensor  # [N] bool


def env_rows_from_image(env_image: torch.Tensor, pdf_cells: torch.Tensor) -> torch.Tensor:
    """The [K, 16] env row table: per bilinear base cell its 2x2 texel quad
    (radiance) and its sampling density. Plain tensor ops, so an env image
    that requires grad passes its gradient to the radiance fetches
    (render/diff.py `env_grads` rebuilds the rows from it)."""
    h, w = env_image.shape[:2]
    wc, hc = max(w - 1, 1), max(h - 1, 1)
    dev = env_image.device
    x1 = torch.clamp_max(torch.arange(wc, device=dev) + 1, w - 1)
    y1 = torch.clamp_max(torch.arange(hc, device=dev) + 1, h - 1)
    s00 = env_image[:hc, :wc]
    s10 = env_image[:hc, x1]
    s01 = env_image[y1, :wc]
    s11 = env_image[y1][:, x1]
    quad = torch.cat([s00, s10, s01, s11], dim=-1).reshape(hc * wc, 12)
    return torch.cat(
        [quad, pdf_cells.reshape(-1, 1).to(dev), torch.zeros((hc * wc, 3), dtype=env_image.dtype, device=dev)],
        dim=1
    )


def _in_bounds(scene: CompiledScene, uv):
    b = scene.env_bounds
    return (uv[..., 0] >= b[0]) & (uv[..., 0] < b[2]) & (uv[..., 1] >= b[1]) & (uv[..., 1] < b[3])


def _env_fetch(scene: CompiledScene, meta: SceneMeta, uv):
    """One row gather -> (bilinear radiance, uv-square sampling pdf)."""
    wc, hc = meta.env_wc, meta.env_hc
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    # The bilinear base cell is the sampling cell (grid (W-1) x (H-1)).
    fx = u * wc
    fy = v * hc
    x = torch.clamp(fx.to(torch.int32), 0, wc - 1)
    y = torch.clamp(fy.to(torch.int32), 0, hc - 1)
    fu = (fx - x)[..., None]
    fv = (fy - y)[..., None]
    row = scene.env_rows[(y * wc + x).long()]
    le = (row[..., 0:3] * (1 - fu) + row[..., 3:6] * fu) * (1 - fv) + (
        row[..., 6:9] * (1 - fu) + row[..., 9:12] * fu
    ) * fv
    return le, row[..., 12]


def env_le_pdf(scene: CompiledScene, d, meta: SceneMeta):
    """(radiance, solid-angle sampling pdf) of the env along world
    directions d [N, 3] (light.cpp:196-214), from one row fetch."""
    uv = octahedral_uv(mat3_rows(scene.env_rotation.reshape(9), d))
    le, pdf_uv = _env_fetch(scene, meta, uv)
    if meta.env_portal:
        le = torch.where(_in_bounds(scene, uv)[..., None], le, 0.0)
    if not meta.env_sampleable:
        return le, torch.zeros(d.shape[:-1], dtype=torch.float32, device=d.device)
    return le, pdf_uv / FOUR_PI


def env_pdf(scene: CompiledScene, d, meta: SceneMeta):
    """Solid-angle pdf of env importance sampling; 0 for a uniform env
    (light.cpp:105-110), and 0 outside portal bounds by construction."""
    return env_le_pdf(scene, d, meta)[1]


def p_infinite(meta: SceneMeta) -> float:
    """Reserved infinite-light probability (light-sampler.cpp:57-59)."""
    n_inf = 1 if meta.has_env else 0
    if meta.n_lights == 0:
        return 1.0
    return n_inf / (n_inf + 1.0)


def select_p_area(scene: CompiledScene, meta: SceneMeta, light_idx, kind: str = "power"):
    """Selection probability of area light `light_idx` for MIS
    (light-sampler.cpp:80-93 / 23-29)."""
    if kind == "uniform":
        n_total = meta.n_lights + (1 if meta.has_env else 0)
        return torch.full(light_idx.shape, 1.0 / max(n_total, 1),
                          dtype=torch.float32, device=light_idx.device)
    total = maximum(scene.light_cdf[-1], 1e-20)
    return scene.light_power[light_idx] / total * (1.0 - p_infinite(meta))


def sample_light(scene: CompiledScene, meta: SceneMeta, p, uc, u, kind: str = "power") -> LightSample:
    """Power/Uniform LightSampler::sample + Light::sample, batched.
    p: [N, 3] shading points; uc: [N] selector; u: [N, 2]."""
    n = p.shape[0]
    dev = p.device
    false = torch.zeros(n, dtype=torch.bool, device=dev)
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    zero3 = torch.zeros_like(p)
    n_total = meta.n_lights + (1 if meta.has_env else 0)
    if kind == "uniform":
        pick = torch.clamp((uc * n_total - 0.01).to(torch.int32), 0, max(n_total - 1, 0))
        pick_env = pick == meta.n_lights if meta.has_env else false
        p_inf = 0.0
        uniform_sel = torch.full((n,), 1.0 / max(n_total, 1), dtype=torch.float32, device=dev)
    else:
        p_inf = p_infinite(meta)
        pick_env = uc < p_inf if meta.has_env else false

    # ---- area branch (power CDF, light-sampler.cpp:69-78) ----
    if meta.n_lights > 0:
        if kind == "uniform":
            li = torch.clamp(pick, 0, meta.n_lights - 1)
        else:
            u_area = (uc - p_inf) / max(1.0 - p_inf, 1e-9) if p_inf < 1.0 else torch.zeros_like(uc)
            target = u_area * scene.light_cdf[-1]
            li = torch.clamp(
                (scene.light_cdf[None, 1:] <= target[:, None]).sum(dim=-1), 0, meta.n_lights - 1
            )
        li = li.long()
        b = warps.sample_tri_uniform(u)
        b0, b1, b2 = b[:, 0:1], b[:, 1:2], b[:, 2:3]
        verts = scene.light_verts[li]  # [N, 3, 3]
        norms = scene.light_norms[li]
        pos = b0 * verts[:, 0] + b1 * verts[:, 1] + b2 * verts[:, 2]
        nrm = b0 * norms[:, 0] + b1 * norms[:, 1] + b2 * norms[:, 2]
        wi_area = normalize(pos - p)
        pdf_area = 1.0 / maximum(scene.light_area[li], 1e-20)
        li_rgb = scene.light_emission[li]
        if kind == "uniform":
            sel_area = uniform_sel
        else:
            total = maximum(scene.light_cdf[-1], 1e-20)
            sel_area = scene.light_power[li] / total * (1.0 - p_inf)
    else:
        pos = nrm = wi_area = li_rgb = zero3
        pdf_area = sel_area = zero

    # ---- env branch (light.cpp:219-238) ----
    if meta.has_env:
        # The alias draw picks the cell and leaves one jitter coordinate;
        # the second row fetch returns radiance and pdf together.
        cell, pdf_uv, r = sample_alias_rows(scene.env_alias, u[:, 0])
        wc, hc = meta.env_wc, meta.env_hc
        iu = (cell % wc).to(torch.float32)
        iv = (cell // wc).to(torch.float32)
        jit2 = torch.clamp_max(u[:, 1], ONE_MINUS_EPS)
        uv = torch.stack([(iu + r) / wc, (iv + jit2) / hc], dim=-1)
        wi_env = mat3_rows(scene.env_rotation.T.reshape(9), inv_octahedral_uv(uv))
        li_env, _ = _env_fetch(scene, meta, uv)
        pdf_env = pdf_uv / FOUR_PI
        pos_env = wi_env * 2.0 * scene.scene_radius
        sel_env = uniform_sel if kind == "uniform" else torch.full((n,), p_inf, dtype=torch.float32, device=dev)
        # A uniform env occupies the pInf slot but cannot be sampled
        # (light.cpp:112-133): those draws give no NEE contribution.
        env_ok = (pdf_uv > 0.0) & meta.env_sampleable
    else:
        wi_env = li_env = pos_env = zero3
        pdf_env = sel_env = zero
        env_ok = false

    pe = pick_env[..., None]
    valid = torch.where(pick_env, env_ok, ~false if meta.n_lights else false)
    return LightSample(
        Li=torch.where(pe, li_env, li_rgb),
        wi=torch.where(pe, wi_env, wi_area),
        p=torch.where(pe, pos_env, pos),
        n=torch.where(pe, -wi_env, nrm),
        pdf=torch.where(pick_env, pdf_env, pdf_area),
        select_p=torch.where(pick_env, sel_env, sel_area),
        is_env=pick_env,
        valid=valid,
    )
