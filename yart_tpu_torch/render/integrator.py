"""Wavefront path-tracing integrators (MIS+NEE and naive).

Port of `yart_tpu/render/integrator.py` (src/cpu/mis-integrator.cpp,
naive-integrator.cpp) for plain and instanced scenes, textured or not, lit
by area lights and an environment light. The JAX
package's `lax.while_loop` over the wavefront becomes a host loop over
depth with one `any(active)` sync per bounce; every lane advances one
bounce per iteration and dead lanes are masked.

Sampler dimensions are assigned statically per bounce (dims 0-1 film,
2-3 lens, then per bounce k at base 4 + 8k: BSDF u (2), uc, uc2, NEE light
select, NEE u (2), roulette), so every lane keeps an aligned counter-based
stream and results do not depend on which lanes run together. Scenes with
per-hit gates (alpha, transparent shadows) key their alpha tests with a
per-bounce seed from the sampler's lane seed, which travels with the lane
state through compaction too.

`li(differentiable=True)` is the detached-sampling estimator of the JAX
package (integrator.py:407-888): traversals run under `torch.no_grad()` on
detached rays and their hits are constants; the sampled direction, its
pdf and roughness and the roulette probability are detached; f, Le, the
env and texture lookups and (with `cfg.diff_geometry`) the re-solved hit
parameters keep their gradients. `cfg.remat` sets what the backward pass
keeps: "all" is plain autograd; "trace" and "trace_lut" checkpoint each
bounce (`torch.utils.checkpoint`, non-reentrant) and its recomputation
replays the bounce's recorded traversal outputs (and, for "trace_lut", its
LUT and texture gathers) instead of running them again, so no traversal
kernel runs in a backward pass.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from yart_tpu_torch.config import RenderConfig
from yart_tpu_torch.kernels import shade as SK
from yart_tpu_torch.kernels import shade_math as SM
from yart_tpu_torch.ops import lut
from yart_tpu_torch.ops.qmc import M32
from yart_tpu_torch.ops.vecmath import (
    absdot,
    cross,
    frame_from_normal_tangent,
    local_to_world,
    mat3_rows,
    max_component,
    maximum,
    minimum,
    normalize,
    shading_tangent,
    world_to_local,
)
from yart_tpu_torch.render import bsdf as B
from yart_tpu_torch.render import lights
from yart_tpu_torch.render.camera import CameraParams, generate_rays
from yart_tpu_torch.render.intersect import intersect
from yart_tpu_torch.render.texture import sample_stack
from yart_tpu_torch.scene.types import CompiledScene, SceneMeta

INF = 1e30
RAY_EPS = 1e-3  # tMin (mis-integrator.cpp:26)
SHADE_KERNELS = ("off", "xla", "pallas")
# The JAX package's refusal (yart_tpu/render/integrator.py:239-245).
PALLAS_REG_SPECULAR = (
    "regularize_specular is wired into the XLA shade paths only; the Pallas "
    "shade kernel's packed-row layout does not carry the force_reg lane input"
)
# The JAX package's refusal of differentiable "pallas" (integrator.py:437-443).
PALLAS_NO_VJP = (
    "shade_kernel='pallas': the Pallas shade kernel has no VJP; use shade_kernel='xla' (same math, "
    "detached-sampling gradients, kernels/shade_math.py finish(detach=True)) or 'off' for "
    "differentiable rendering"
)
REMATS = ("trace", "trace_lut", "all")


class Shading(NamedTuple):
    """Per-lane surface data after a hit (ray-integrator.cpp:56-82)."""

    p: torch.Tensor  # [N, 3]
    n: torch.Tensor  # [N, 3] shading normal
    tg: torch.Tensor  # [N, 3] integrator tangent
    uv: torch.Tensor  # [N, 2] interpolated texture coordinates
    mat: torch.Tensor  # [N] int32
    light: torch.Tensor  # [N] int32, -1 = not emissive
    back: torch.Tensor  # [N] bool


def shading_data(scene: CompiledScene, meta: SceneMeta, hit, o, d) -> Shading:
    """Interpolated shading normal, uv, material and light id of each hit,
    normal-mapped through the interpolated tangent frame where the
    material has a normal map (bsdf.cpp:44-58). An instanced scene maps
    the virtual triangle through ONE `tri_aux` row (shade row, instance,
    light, material) and rotates the object-space normal by the instance's
    normal matrix and the tangent by its forward linear part, keeping the
    tangent's handedness (JAX integrator.py:64-125). Miss lanes are pinned
    to the ray origin."""
    tri = torch.clamp(hit.tri, 0, meta.n_tris - 1).long()
    if meta.n_instances:
        aux = scene.tri_aux[tri].long()
        row = scene.shade_pack[aux[..., 0]]
        irow = scene.inst_rows[aux[..., 1]]  # [N, 40]
    else:
        row = scene.shade_pack[tri]  # one packed row per lane
    w = (1.0 - hit.u - hit.v)[..., None]
    u = hit.u[..., None]
    v = hit.v[..., None]
    n = normalize(w * row[..., 0:3] + u * row[..., 3:6] + v * row[..., 6:9])
    uv = w * row[..., 9:11] + u * row[..., 11:13] + v * row[..., 13:15]
    if meta.n_instances:
        mat = aux[..., 3].to(torch.int32)
        light = aux[..., 2].to(torch.int32)
        n = normalize(mat3_rows(irow[..., 24:33], n))
    else:
        mat = scene.tri_mat[tri]
        light = scene.tri_light[tri]
    if meta.any_textures:
        t4 = w * row[..., 15:19] + u * row[..., 19:23] + v * row[..., 23:27]
        if meta.n_instances:
            # The forward 3x4's rows sit at columns 12:24; its linear part
            # skips the translations at 15, 19 and 23.
            fwd9 = torch.cat([irow[..., 12:15], irow[..., 16:19], irow[..., 20:23]], dim=-1)
            t4 = torch.cat([normalize(mat3_rows(fwd9, t4[..., :3])), t4[..., 3:4]], dim=-1)
        tn_idx = scene.materials.tex_normal[mat.long()]
        tex_n = sample_stack(scene.tex_rgb, tn_idx, uv) * 2.0 - 1.0
        fx, fy, fz = frame_from_normal_tangent(n, t4[..., :3], t4[..., 3])
        mapped = normalize(local_to_world(tex_n, fx, fy, fz))
        n = torch.where((tn_idx >= 0)[..., None], mapped, n)
    return Shading(
        p=o + d * torch.where(hit.mask, hit.t, 0.0)[..., None],
        n=n,
        tg=shading_tangent(n),
        uv=uv,
        mat=mat,
        light=light,
        back=hit.back_side,
    )


@dataclasses.dataclass
class _State:
    o: torch.Tensor
    d: torch.Tensor
    L: torch.Tensor
    atten: torch.Tensor
    active: torch.Tensor
    specular: torch.Tensor
    acc_rough: torch.Tensor
    last_pdf: torch.Tensor
    last_p: torch.Tensor
    spec_depth: torch.Tensor  # near-specular scatters so far (roughness < 0.3)
    depth: int = 0

    _LANE_FIELDS = (
        "o", "d", "L", "atten", "active", "specular", "acc_rough",
        "last_pdf", "last_p", "spec_depth",
    )

    def take(self, idx) -> "_State":
        return _State(**{f: getattr(self, f)[idx] for f in self._LANE_FIELDS}, depth=self.depth)


@dataclasses.dataclass
class BounceCount:
    """Bounces run (`_bounce` calls, one per depth per compaction stage),
    so a run can hold the fused path's launches to one per bounce."""

    bounces: int = 0

    def reset(self) -> None:
        self.bounces = 0


BOUNCES = BounceCount()


class _Counters:
    """Ray count and per-depth active-lane counts, accumulated as device
    tensors so the loop syncs only on its exit test."""

    def __init__(self, max_depth: int, device):
        self.rays = torch.zeros((), dtype=torch.float64, device=device)
        self.live = torch.zeros(max_depth, dtype=torch.float64, device=device)


def _check_supported(meta: SceneMeta, cfg: RenderConfig, differentiable: bool) -> None:
    if differentiable and cfg.shade_kernel == "pallas":
        raise NotImplementedError(PALLAS_NO_VJP)
    if differentiable and cfg.remat not in REMATS:
        raise ValueError(f"remat={cfg.remat!r}: expected one of {REMATS}")
    if cfg.shade_kernel not in SHADE_KERNELS:
        raise ValueError(f"shade_kernel={cfg.shade_kernel!r}: expected one of {SHADE_KERNELS}")
    if cfg.shade_kernel == "pallas" and cfg.regularize_specular is not None:
        raise NotImplementedError(PALLAS_REG_SPECULAR)


def _traverse(trace, fn, *rays):
    """fn(*rays) -> Hit. Without a recorder (the plain forward) it is just
    the call. A differentiable bounce passes its recorder: the traversal
    runs on detached rays under `torch.no_grad()` (its hits are constants,
    and the kernels refuse inputs that require grad) with the LUT recorder
    off, and a recomputation reads the recorded hits back."""
    if trace is None:
        return fn(*rays)

    def run():
        with torch.no_grad(), lut.named_residuals(None):
            return fn(*(r.detach() for r in rays))

    return trace.fetch(run)


def _refit_hit(scene: CompiledScene, meta: SceneMeta, hit, o, d):
    """The differentiable (t, u, v) of the triangle the traversal found
    (JAX integrator.py:316-382): Moller-Trumbore re-solved against
    `scene.positions[tri_v[tri]]`, so t, u and v (and with them the hit
    point, the NEE geometry and the interpolated attributes) carry
    gradients to the vertex positions; which triangle was hit stays
    detached. An instanced scene maps the virtual triangle through
    `tri_aux` to its prototype's object-space vertices (`proto_tri`,
    `proto_pos`) and the instance's forward 3x4, so the gradient reaches
    the shared prototype, summed over its instances. A lane keeps the
    traversal's values where it missed, |det| < 1e-12 or t <= 0."""
    tri = torch.clamp(hit.tri, 0, meta.n_tris - 1).long()
    if meta.n_instances:
        aux = scene.tri_aux[tri].long()
        idx = scene.proto_tri[aux[:, 0]].long()
        f = scene.inst_rows[aux[:, 1]][:, 12:24]  # forward 3x4, row by row

        def to_world(vo):
            return torch.stack([(f[:, 4 * r : 4 * r + 3] * vo).sum(dim=-1) + f[:, 4 * r + 3]
                                for r in range(3)], dim=-1)

        v0, v1, v2 = (to_world(scene.proto_pos[idx[:, k]]) for k in range(3))
    else:
        idx = scene.tri_v[tri].long()
        v0, v1, v2 = (scene.positions[idx[:, k]] for k in range(3))
    e1 = v1 - v0
    e2 = v2 - v0
    pv = cross(d, e2)
    det = (e1 * pv).sum(dim=-1)
    small = det.abs() < 1e-12
    inv = 1.0 / torch.where(small, torch.where(det < 0, -1e-12, 1e-12), det)
    tv = o - v0
    u = (tv * pv).sum(dim=-1) * inv
    qv = cross(tv, e1)
    v = (d * qv).sum(dim=-1) * inv
    t = (e2 * qv).sum(dim=-1) * inv
    ok = hit.mask & ~small & (t > 0.0)
    return hit._replace(t=torch.where(ok, t, hit.t), u=torch.where(ok, u, hit.u),
                        v=torch.where(ok, v, hit.v))


def _bounce(scene, meta, sampler, lane_state, cfg, tables, st: _State, cnt, mis: bool,
            trace=None) -> _State:
    """One bounce of every lane in `st` (the body of li's loop). A
    differentiable bounce passes `trace`, the recorder of its traversals;
    `cnt` is None when such a bounce is recomputed (it counted its rays the
    first time)."""
    differentiable = trace is not None
    n = st.active.shape[0]
    depth = st.depth
    dim0 = 4 + depth * 8
    if cnt is not None:
        BOUNCES.bounces += 1
        n_act = st.active.sum().to(torch.float64)
        cnt.rays += n_act
        cnt.live[depth] += n_act

    # Fresh alpha-test stream per bounce (integrator.py:481); only gated
    # scenes draw from it.
    bounce_seed = None
    if meta.any_alpha or meta.any_transparent:
        bounce_seed = sampler.lane_seed(lane_state) ^ ((depth * 0x85EBCA6B) & M32)

    # Retired lanes trace with t_max = -1: instant misses.
    tmax_lane = torch.where(st.active, INF, -1.0)
    hit = _traverse(trace, lambda o, d, tm: intersect(scene, meta, o, d, tm, t_min=RAY_EPS,
                                                      alpha_seed=bounce_seed),
                    st.o, st.d, tmax_lane)
    if differentiable and cfg.diff_geometry:
        hit = _refit_hit(scene, meta, hit, st.o, st.d)
    found = hit.mask & st.active

    # ---- miss: environment + background (mis-integrator.cpp:27-43) ----
    miss = st.active & ~hit.mask
    L = st.L
    if meta.has_env:
        le, pdf_env = lights.env_le_pdf(scene, st.d, meta)
        env_l = st.atten * le
        if mis and depth > 0:
            w_bsdf = torch.where(
                st.specular, 1.0, st.last_pdf / maximum(st.last_pdf + pdf_env, 1e-20)
            )
            env_l = env_l * w_bsdf[..., None]
        L = L + torch.where(miss[..., None], env_l, 0.0)
    L = L + torch.where(miss[..., None], st.atten * scene.background, 0.0)

    # ---- surface shading ----
    sh = shading_data(scene, meta, hit, st.o, st.d)
    mat = B.resolve_material(scene, meta, sh.mat, sh.uv)
    if cfg.shade_kernel != "off":
        return _shade_kernel_body(scene, meta, sampler, lane_state, cfg, tables, st, cnt, hit, sh,
                                  mat, found, L, dim0, bounce_seed, mis, trace)
    u = sampler.get2d(lane_state, dim0)
    uc = sampler.get1d(lane_state, dim0 + 2)
    uc2 = sampler.get1d(lane_state, dim0 + 3)

    regularized = st.acc_rough > cfg.regularize_threshold
    if cfg.regularize_specular is not None:
        regularized = regularized | (st.spec_depth >= cfg.regularize_specular)
    fx, fy, fz = frame_from_normal_tangent(sh.n, sh.tg)
    wo_local = world_to_local(-st.d, fx, fy, fz)
    smp = B.bsdf_sample(tables, mat, wo_local, u, uc, uc2, regularized, meta=meta)
    if differentiable:
        # Detached sampling: direction, pdf and lobe choice are constants;
        # f and Le keep their parameter dependence.
        smp = smp._replace(wi=smp.wi.detach(), pdf=smp.pdf.detach(),
                           roughness=smp.roughness.detach())
    wi_world = local_to_world(smp.wi, fx, fy, fz)

    # ---- emitted radiance (mis-integrator.cpp:60-74) ----
    emitted = B.has_flag(smp.flags, B.EMITTED) & found
    if mis:
        dist2 = ((st.last_p - sh.p) ** 2).sum(dim=-1)
        if meta.n_lights:
            lidx = torch.clamp(sh.light, 0, meta.n_lights - 1).long()
            pdf_area = 1.0 / maximum(scene.light_area[lidx], 1e-20)
            sel_p = lights.select_p_area(scene, meta, lidx, kind=cfg.light_sampler)
        else:
            pdf_area = torch.zeros(n, dtype=torch.float32, device=L.device)
            sel_p = pdf_area
        pdf_light = pdf_area * dist2 * sel_p / maximum(absdot(-st.d, sh.n), 1e-9)
        first = depth == 0
        w_b = torch.where(
            st.specular | (sh.light < 0) | first,
            1.0,
            st.last_pdf / maximum(st.last_pdf + pdf_light, 1e-20),
        )
        L = L + torch.where(emitted[..., None], st.atten * smp.Le * w_b[..., None], 0.0)
    else:
        L = L + torch.where(emitted[..., None], st.atten * smp.Le, 0.0)

    scattered = B.has_flag(smp.flags, B.REFLECTED | B.TRANSMITTED) & found

    # ---- NEE direct lighting (mis-integrator.cpp:76-80, 111-133) ----
    if mis and (meta.n_lights > 0 or meta.has_env):
        do_nee = scattered & ~B.has_flag(smp.flags, B.EMITTED | B.SPECULAR)
        uc_l = sampler.get1d(lane_state, dim0 + 4)
        u_l = sampler.get2d(lane_state, dim0 + 5)
        ls = lights.sample_light(scene, meta, sh.p, uc_l, u_l, kind=cfg.light_sampler)

        wi_l_local = world_to_local(ls.wi, fx, fy, fz)
        f_l = B.bsdf_f(tables, mat, wo_local, wi_l_local, meta=meta)
        pdf_b = B.bsdf_pdf(tables, mat, wo_local, wi_l_local, meta=meta)
        to_l = ls.p - sh.p
        dist2_l = (to_l * to_l).sum(dim=-1)
        dist_l = torch.sqrt(maximum(dist2_l, 1e-20))
        nee_need = do_nee & ls.valid & ((f_l * f_l).sum(dim=-1) > 0.0)
        shadow_d = to_l / dist_l[..., None]
        shadow_tmax = torch.where(nee_need, dist_l - 1e-3, -1.0)
        occ = _traverse(trace, lambda o, d, tm: intersect(
            scene, meta, o, d, tm, t_min=RAY_EPS, nee=True,
            alpha_seed=None if bounce_seed is None else bounce_seed ^ 0x6A09E667),
            sh.p, shadow_d, shadow_tmax)
        if cnt is not None:
            cnt.rays += nee_need.sum().to(torch.float64)

        pdf_light = ls.select_p * ls.pdf / maximum(absdot(ls.n, ls.wi), 1e-9)
        pdf_light = torch.where(ls.is_env, pdf_light, pdf_light * dist2_l)
        contrib = (ls.Li * f_l * occ.attenuation
                   * (absdot(ls.wi, sh.n) / maximum(pdf_b + pdf_light, 1e-20))[..., None])
        ok = nee_need & ~occ.mask
        L = L + torch.where(ok[..., None], st.atten * contrib, 0.0)

    # ---- throughput update (mis-integrator.cpp:83-96) ----
    fcos = smp.f * absdot(wi_world, sh.n)[..., None]
    atten = st.atten * fcos / maximum(smp.pdf, 1e-20)[..., None]
    vol = B.volume_attenuation(mat, hit.t)
    atten = torch.where((sh.back & scattered)[..., None], atten * vol, atten)

    active = st.active & scattered
    specular = B.has_flag(smp.flags, B.SPECULAR)
    acc_rough = st.acc_rough + torch.where(scattered, smp.roughness, 0.0)
    depth_new = depth + 1

    # ---- russian roulette (mis-integrator.cpp:98-102) ----
    if mis and depth_new >= cfg.rr_start_depth:
        u_rr = sampler.get1d(lane_state, dim0 + 7)
        q = maximum(1.0 - max_component(atten), 0.0)
        if differentiable:
            # Detached-sampling roulette: with q a constant, E[d(f/(1-q)) 1{survive}]
            # = f' exactly (JAX integrator.py:666-684).
            q = q.detach()
        active = active & ~(u_rr < q)
        scale = torch.where(active, 1.0 / maximum(1.0 - q, 1e-9), 1.0)
        atten = atten * scale[..., None]

    atten = torch.where(active[..., None], atten, st.atten)
    a3 = active[..., None]
    return _State(
        o=torch.where(a3, sh.p, st.o),
        d=torch.where(a3, wi_world, st.d),
        L=L,
        atten=atten,
        active=active,
        specular=torch.where(active, specular, st.specular),
        acc_rough=acc_rough,
        last_pdf=torch.where(active, smp.pdf, st.last_pdf),
        last_p=torch.where(a3, sh.p, st.last_p),
        spec_depth=torch.where(
            active, st.spec_depth + (smp.roughness < 0.3).to(torch.int32), st.spec_depth
        ),
        depth=depth_new,
    )


def _shade_kernel_body(scene, meta, sampler, lane_state, cfg, tables, st: _State, cnt,
                       hit, sh: Shading, mat, found, L, dim0: int, bounce_seed, mis: bool,
                       trace=None) -> _State:
    """The fused-shade bounce tail (JAX integrator.py:141-313): the whole
    post-intersect bounce goes through kernels/shade_math.py, assembled in
    plain PyTorch (`shade_kernel="xla"`) or as B6 (the sampler draws) and
    B5 (the shade tail) (`"pallas"`; their twins on CPU tensors). It
    differs from `_bounce`'s classic tail as the JAX shade body does: B6
    draws u_rr on every bounce, roulette scales by 1/max(1-q, 1e-9) only
    for the lanes it spares, and `spec_depth` grows from the acc_rough
    delta."""
    n = st.active.shape[0]
    dev = L.device
    gates = (meta.any_metallic, meta.any_transmissive, meta.any_clearcoat, meta.any_anisotropy)
    any_lights = bool(meta.n_lights > 0 or meta.has_env)
    zero = torch.zeros(n, dtype=torch.float32, device=dev)

    draws = None
    if cfg.shade_kernel == "pallas":
        setup = SK.sampler_draw_setup(sampler, lane_state, dim0)
        if setup is not None:
            draws = SK.draws(setup, n)
    if draws is None:
        u = sampler.get2d(lane_state, dim0)
        draws = dict(u0=u[:, 0], u1=u[:, 1],
                     uc=sampler.get1d(lane_state, dim0 + 2), uc2=sampler.get1d(lane_state, dim0 + 3),
                     u_rr=sampler.get1d(lane_state, dim0 + 7) if mis else zero)

    # Emitted-MIS light terms of the hit light (the "uniform" sampler's
    # 1 / n_total, or its power share).
    if mis and meta.n_lights:
        lidx = torch.clamp(sh.light, 0, meta.n_lights - 1).long()
        pdf_area = 1.0 / maximum(scene.light_area[lidx], 1e-20)
        sel_p = lights.select_p_area(scene, meta, lidx, kind=cfg.light_sampler)
    else:
        pdf_area = sel_p = zero

    inp = dict(
        o=st.o, d=st.d, n=sh.n, p=sh.p, atten=st.atten, active=st.active, found=found,
        specular_prev=st.specular, acc_rough=st.acc_rough, last_pdf=st.last_pdf, last_p=st.last_p,
        depth0=st.depth == 0, rr_on=st.depth + 1 >= cfg.rr_start_depth, light_neg=sh.light < 0,
        hit_back=sh.back, hit_t=hit.t, reg_threshold=float(cfg.regularize_threshold),
        pdf_area=pdf_area, sel_p=sel_p, **{k: draws[k] for k in ("u0", "u1", "uc", "uc2", "u_rr")},
        **mat._asdict(),
    )
    if mis and any_lights:
        if "uc_l" in draws:
            uc_l, u_l = draws["uc_l"], torch.stack([draws["ul0"], draws["ul1"]], dim=-1)
        else:
            uc_l, u_l = sampler.get1d(lane_state, dim0 + 4), sampler.get2d(lane_state, dim0 + 5)
        ls = lights.sample_light(scene, meta, sh.p, uc_l, u_l, kind=cfg.light_sampler)
        inp.update(ls_wi=ls.wi, ls_Li=ls.Li, ls_pdf=ls.pdf, ls_select_p=ls.select_p, ls_n=ls.n,
                   ls_p=ls.p, ls_valid=ls.valid, ls_is_env=ls.is_env)
    else:
        # candidates() still takes the NEE direction into the local frame.
        inp["ls_wi"] = torch.zeros_like(sh.p)

    if cfg.shade_kernel == "pallas":
        # B5 takes contiguous tensors (a traversal's t can be a column view).
        inp = {k: v.contiguous() if isinstance(v, torch.Tensor) else v for k, v in inp.items()}
        out = SK.shade(inp, gates, mis, any_lights, tables)
    else:
        force_reg = None
        if cfg.regularize_specular is not None:
            force_reg = st.spec_depth >= cfg.regularize_specular
        out = SM.shade(inp, gates, mis, any_lights, tables, force_reg=force_reg, detach=trace is not None)

    L = L + out["L_emit"]
    if mis and any_lights:
        occ = _traverse(trace, lambda o, d, tm: intersect(
            scene, meta, o, d, tm, t_min=RAY_EPS, nee=True,
            alpha_seed=None if bounce_seed is None else bounce_seed ^ 0x6A09E667),
            sh.p, out["shadow_d"], out["shadow_tmax"])
        if cnt is not None:
            cnt.rays += out["nee_need"].sum().to(torch.float64)
        ok = out["nee_need"] & ~occ.mask
        L = L + torch.where(ok[..., None], out["contrib"] * occ.attenuation, 0.0)

    return _State(
        o=out["o"], d=out["d"], L=L, atten=out["atten"], active=out["active"],
        specular=out["specular"], acc_rough=out["acc_rough"], last_pdf=out["last_pdf"],
        last_p=out["last_p"],
        # Lanes that go on took this bounce's scatter; its sampled roughness
        # is the acc_rough delta.
        spec_depth=st.spec_depth + (out["active"] & ((out["acc_rough"] - st.acc_rough) < 0.3)).to(torch.int32),
        depth=st.depth + 1,
    )


def _diff_step(scene, meta, sampler, cfg, tables, cnt, mis: bool):
    """-> step(st, lanes): one differentiable bounce under `cfg.remat`.

    "all" runs the bounce under plain autograd. "trace" / "trace_lut" run
    it inside a non-reentrant `checkpoint`, which keeps the bounce's input
    state and drops its intermediates; the backward pass recomputes them by
    running the bounce again, and that run reads its traversal outputs
    (and, for "trace_lut", its LUT and texture gathers) from the records
    of the first, so it launches no traversal kernel and counts nothing.
    (The kernels are bound through ctypes, not as `torch.library` ops, so
    selective checkpointing cannot mark them; the replay stands in for the
    JAX package's `checkpoint_name` policies.)"""
    def step(st: _State, lanes) -> _State:
        if cfg.remat == "all":
            return _bounce(scene, meta, sampler, lanes, cfg, tables, st, cnt, mis,
                           trace=lut.Residuals(record=False))
        trace = lut.Residuals()
        luts = lut.Residuals() if cfg.remat == "trace_lut" else None
        depth = st.depth

        def body(*tensors):
            replay = trace.start()
            if luts is not None:
                luts.start()
            with lut.named_residuals(luts):
                out = _bounce(scene, meta, sampler, lanes, cfg, tables, _State(*tensors, depth=depth),
                              None if replay else cnt, mis, trace=trace)
            return tuple(getattr(out, f) for f in _State._LANE_FIELDS)

        outs = checkpoint(body, *(getattr(st, f) for f in _State._LANE_FIELDS),
                          use_reentrant=False, preserve_rng_state=False)
        return _State(*outs, depth=depth + 1)

    return step


def li(scene: CompiledScene, meta: SceneMeta, sampler, lane_state, o, d, cfg: RenderConfig,
       mis: bool = True, return_live: bool = False, differentiable: bool = False):
    """Trace radiance for a wavefront of camera rays.

    Returns (L [N, 3], ray count []) — plus the [max_depth] per-depth
    active-lane counts when `return_live` (the compaction autotune probe).
    `lane_state` comes from `sampler.init_lanes`. `cfg.shade_kernel`
    picks the bounce tail: "off" (the classic body), "xla" or "pallas"
    (the fused shade body). `differentiable=True` makes L reverse-
    differentiable w.r.t. the scene's tensors by detached sampling (module
    doc); "pallas" has no backward and is refused there, as in the JAX
    package.
    """
    _check_supported(meta, cfg, differentiable)
    n = o.shape[0]
    dev = o.device
    tables = lut.load_tables(dev)
    cnt = _Counters(cfg.max_depth, dev)
    st = _State(
        o=o,
        d=d,
        L=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        atten=torch.ones((n, 3), dtype=torch.float32, device=dev),
        active=torch.ones(n, dtype=torch.bool, device=dev),
        specular=torch.zeros(n, dtype=torch.bool, device=dev),
        acc_rough=torch.zeros(n, dtype=torch.float32, device=dev),
        last_pdf=torch.zeros(n, dtype=torch.float32, device=dev),
        last_p=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        spec_depth=torch.zeros(n, dtype=torch.int32, device=dev),
    )
    if differentiable:
        step = _diff_step(scene, meta, sampler, cfg, tables, cnt, mis)
    else:
        def step(st, lanes):
            return _bounce(scene, meta, sampler, lanes, cfg, tables, st, cnt, mis)

    def run(st, lanes, stop):
        # The JAX scan of a differentiable render always runs max_depth
        # bounces; one with no active lane adds nothing to L or to its
        # gradient, so both flavours stop there.
        while st.depth < stop and bool(st.active.any()):
            st = step(st, lanes)
        return st

    split = cfg.compact_depth
    if split == "auto":
        # Env-lit scenes retire most lanes within two bounces; closed scenes
        # keep too many survivors for the cap (integrator.py:834-839). The
        # differentiable flavour also needs roulette live (:792-802): without
        # it an env scene keeps ~60% of its lanes at depth 2.
        rr_live = cfg.rr_start_depth < cfg.max_depth
        split = 2 if meta.has_env and (rr_live or not differentiable) else None
    cap = 0
    if split and split < cfg.max_depth:
        cap = max(128, (n // max(cfg.compact_factor, 2)) // 128 * 128)
    if not cap or cap >= n:
        st = run(st, lane_state, cfg.max_depth)
    else:
        # Staged wavefront compaction (integrator.py:848-885): after `split`
        # bounces the survivors move into `cap` lanes (stable sort: active
        # lanes first, in lane order) with their sampler state, so every
        # draw and hence the image is unchanged; active lanes beyond the cap
        # drain afterwards at full width from depth `split`. In
        # differentiable mode the gather and the merge carry gradients
        # (:787-831); the indices are constants.
        st = run(st, lane_state, split)
        idx = torch.argsort((~st.active).to(torch.uint8), stable=True)[:cap]
        st_c = run(st.take(idx), lane_state[idx], cfg.max_depth)
        in_idx = torch.zeros(n, dtype=torch.bool, device=dev)
        in_idx[idx] = True
        st.L = st.L.index_put((idx,), st_c.L)
        st.active = st.active & ~in_idx
        st = run(st, lane_state, cfg.max_depth)
    if return_live:
        return st.L, cnt.rays, cnt.live
    return st.L, cnt.rays


def render_wave(scene: CompiledScene, meta: SceneMeta, cam: CameraParams, sampler,
                cfg: RenderConfig, px, py, sample_idx, return_live: bool = False,
                differentiable: bool = False):
    """Camera raygen + Li for a batch of (pixel, sample) lanes. px, py: [N]
    int pixel coords; sample_idx: [N] global sample indices. Returns
    (radiance [N, 3] scaled by exposure, ray count) (+ live counts);
    `differentiable` as in `li`."""
    lane_state = sampler.init_lanes(px, py, sample_idx)
    u_film = sampler.get2d(lane_state, 0)
    u_lens = sampler.get2d(lane_state, 2)
    o, d = generate_rays(cam, px, py, u_film, u_lens)
    out = li(scene, meta, sampler, lane_state, o, d, cfg,
             mis=cfg.integrator == "mis", return_live=return_live, differentiable=differentiable)
    L = out[0]
    if cfg.clamp is not None:
        L = minimum(L, float(cfg.clamp))
    return (L * cam.exposure_scale,) + tuple(out[1:])
