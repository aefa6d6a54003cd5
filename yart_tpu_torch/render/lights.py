"""Area-light sampling (light-sampler.cpp:32-93, light.cpp:44-73); port of
the area branch of `yart_tpu/render/lights.py`. Environment lights are
the next slice (ROADMAP.md A.3) and are refused."""

from __future__ import annotations

from typing import NamedTuple

import torch

from yart_tpu_torch.ops import warps
from yart_tpu_torch.ops.vecmath import normalize
from yart_tpu_torch.scene.types import CompiledScene, SceneMeta


class LightSample(NamedTuple):
    """SoA LightSample (src/core/light.hpp:10) + selection probability."""

    Li: torch.Tensor  # [N, 3]
    wi: torch.Tensor  # [N, 3]
    p: torch.Tensor  # [N, 3] point on the light
    n: torch.Tensor  # [N, 3] light normal
    pdf: torch.Tensor  # [N] area-measure pdf
    select_p: torch.Tensor  # [N]
    is_env: torch.Tensor  # [N] bool
    valid: torch.Tensor  # [N] bool


def _refuse_env(meta: SceneMeta) -> None:
    if meta.has_env:
        raise NotImplementedError(
            "environment lights are not ported yet (ROADMAP.md A.3, the "
            "env-lighting + textures slice)"
        )


def p_infinite(meta: SceneMeta) -> float:
    """Reserved infinite-light probability (light-sampler.cpp:57-59)."""
    n_inf = 1 if meta.has_env else 0
    if meta.n_lights == 0:
        return 1.0
    return n_inf / (n_inf + 1.0)


def select_p_area(scene: CompiledScene, meta: SceneMeta, light_idx, kind: str = "power"):
    """Selection probability of area light `light_idx` for MIS
    (light-sampler.cpp:80-93 / 23-29)."""
    _refuse_env(meta)
    if kind == "uniform":
        return torch.full(light_idx.shape, 1.0 / max(meta.n_lights, 1),
                          dtype=torch.float32, device=light_idx.device)
    total = torch.clamp_min(scene.light_cdf[-1], 1e-20)
    return scene.light_power[light_idx] / total * (1.0 - p_infinite(meta))


def sample_light(scene: CompiledScene, meta: SceneMeta, p, uc, u, kind: str = "power") -> LightSample:
    """Power/Uniform LightSampler::sample + AreaLight::sample, batched.
    p: [N, 3] shading points; uc: [N] selector; u: [N, 2]."""
    _refuse_env(meta)
    n = p.shape[0]
    false = torch.zeros(n, dtype=torch.bool, device=p.device)
    if meta.n_lights == 0:
        zero3 = torch.zeros_like(p)
        zero = torch.zeros(n, dtype=torch.float32, device=p.device)
        return LightSample(zero3, zero3, zero3, zero3, zero, zero, false, false)

    if kind == "uniform":
        li = torch.clamp((uc * meta.n_lights - 0.01).to(torch.int32), 0, meta.n_lights - 1)
    else:
        # findFirst over the power CDF (light-sampler.cpp:69-78); with no
        # env light p_inf is 0, so u_area == uc.
        target = uc * scene.light_cdf[-1]
        li = torch.clamp(
            (scene.light_cdf[None, 1:] <= target[:, None]).sum(dim=-1), 0, meta.n_lights - 1
        )
    b = warps.sample_tri_uniform(u)
    b0, b1, b2 = b[:, 0:1], b[:, 1:2], b[:, 2:3]
    verts = scene.light_verts[li]  # [N, 3, 3]
    norms = scene.light_norms[li]
    pos = b0 * verts[:, 0] + b1 * verts[:, 1] + b2 * verts[:, 2]
    nrm = b0 * norms[:, 0] + b1 * norms[:, 1] + b2 * norms[:, 2]
    return LightSample(
        Li=scene.light_emission[li],
        wi=normalize(pos - p),
        p=pos,
        n=nrm,
        pdf=1.0 / torch.clamp_min(scene.light_area[li], 1e-20),
        select_p=select_p_area(scene, meta, li, kind),
        is_env=false,
        valid=~false,
    )
