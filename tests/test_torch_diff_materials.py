"""The port's differentiable path on the cornell box against the JAX
package: `render/diff.py` `material_grads` for base_color, emission,
roughness and metallic through `li(differentiable=True)`, central finite
differences and staged compaction with its overflow drain; and on
cornell-mat (a metal sphere at metallic 1, glass at transmission 1) the
three `remat` policies, "xla" against "off", the forward against the plain
render, and the clamps' tie rule.

One JAX `value_and_grad` (its `material_grads` on the plain box, jitted
with XLA:CPU's backend optimisation off, ~30 s cold) serves the module.
Tolerances: the loss within rtol 1e-5; each gradient within rtol 1e-3
plus an atol of 1e-4 of its field's largest entry (XLA:CPU's FMA
contraction moves the last bits of the forward floats). The port against
itself: forward bitwise, the remat policies bitwise (one intra-op
thread), "xla" against "off" and compaction on against off at
tests/test_diff.py's bar (rtol 2e-4, atol 1e-7), finite differences at its
rtol 0.08."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yart_tpu.config import CameraConfig as JCam
from yart_tpu.config import RenderConfig as JCfg
from yart_tpu.ops.qmc import make_sampler as j_make_sampler
from yart_tpu.render.camera import build_camera as j_build_camera
from yart_tpu.render.diff import material_grads as j_material_grads
from yart_tpu.scene.procedural import cornell_box as j_cornell
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.ops import vecmath
from yart_tpu_torch.ops.qmc import make_sampler
from yart_tpu_torch.render import diff as TD
from yart_tpu_torch.render import integrator as TI
from yart_tpu_torch.render.camera import build_camera
from yart_tpu_torch.render.integrator import render_wave
from yart_tpu_torch.scene.convert import from_numpy
from yart_tpu_torch.scene.procedural import cornell_box

SIZE = (8, 8)
SPP = 2
CAM = dict(image_size=SIZE, focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
CFG = dict(samples=SPP, max_depth=3, rr_start_depth=99)
FIELDS = ("base_color", "emission", "roughness", "metallic")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The port runs on one intra-op thread here (bitwise policy checks;
    see tests/test_torch_bsdf.py's docstring)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lanes(size, spp):
    yy, xx = np.meshgrid(np.arange(size[1]), np.arange(size[0]), indexing="ij")
    px = np.repeat(xx.reshape(-1), spp).astype(np.int32)
    py = np.repeat(yy.reshape(-1), spp).astype(np.int32)
    return px, py, np.tile(np.arange(spp), size[0] * size[1]).astype(np.uint32)


@pytest.fixture(scope="module")
def scenes():
    """(JAX cornell box, its meta, the port's copy, its meta, the port's
    cornell-mat, its meta)."""
    js, jm = j_cornell().compile()
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    return (js, jm, ts, tm) + cornell_box(extra_materials=True).compile("cpu")


def jax_fast(fn, *args):
    """fn(*args) under jax.jit with XLA:CPU's backend optimisation off,
    which compiles the differentiable scan in about two thirds of the time
    (the values differ from the optimised build's in float noise)."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)(*args)


@pytest.fixture(scope="module")
def jax_ref(scenes):
    js, jm = scenes[:2]
    cfg = JCfg(**CFG)
    cam, sampler = j_build_camera(JCam(**CAM)), j_make_sampler(cfg.sampler, SPP, SIZE, 0)
    val, g = jax_fast(lambda s, px, py, sidx: j_material_grads(s, jm, cam, sampler, cfg, px, py, sidx,
                                                               loss_fn=jnp.mean, fields=list(FIELDS)),
                      js, *(jnp.asarray(a) for a in _lanes(SIZE, SPP)))
    return float(val), {k: np.asarray(g[k]) for k in FIELDS}


def _setup(scenes, size=SIZE, spp=SPP, mat=False, **cfg):
    ts, tm = scenes[4:6] if mat else scenes[2:4]
    cfg = RenderConfig(**dict(CFG, samples=spp, **cfg))
    px, py, sidx = (torch.from_numpy(a.astype(np.int64)) for a in _lanes(size, spp))
    cam = build_camera(CameraConfig(**dict(CAM, image_size=size)), "cpu")
    return ts, tm, cam, make_sampler(cfg.sampler, spp, size, 0, device="cpu"), cfg, px, py, sidx


def _grads(scenes, fields=FIELDS, **kw):
    ts, tm, cam, sampler, cfg, px, py, sidx = _setup(scenes, **kw)
    val, g = TD.material_grads(ts, tm, cam, sampler, cfg, px, py, sidx, loss_fn=torch.mean, fields=list(fields))
    return float(val), {k: g[k].numpy() for k in fields}


@pytest.fixture(scope="module")
def box_grads(scenes):
    return _grads(scenes)


@pytest.fixture(scope="module")
def mat_grads(scenes):
    """cornell-mat's gradients under each remat policy."""
    return {remat: _grads(scenes, mat=True, remat=remat) for remat in ("trace_lut", "trace", "all")}


def _close(got, ref, rtol=1e-3, frac_atol=1e-4):
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=frac_atol * np.abs(ref).max())


@pytest.mark.parametrize("shade_kernel", ["off", "xla"])
def test_diff_forward_equals_plain_render(scenes, shade_kernel):
    """The differentiable forward, with the material table requiring grad,
    renders the plain render's radiance bit for bit and counts its rays and
    bounces; the backward pass's recomputation of each bounce counts
    neither again."""
    ts, tm, cam, sampler, cfg, px, py, sidx = _setup(scenes, mat=True, shade_kernel=shade_kernel)
    TI.BOUNCES.reset()
    plain, rays = render_wave(ts, tm, cam, sampler, cfg, px, py, sidx)
    bounces = TI.BOUNCES.bounces
    mats = ts.materials._replace(base_color=ts.materials.base_color.clone().requires_grad_(True))
    TI.BOUNCES.reset()
    diff, rays_d = render_wave(dataclasses.replace(ts, materials=mats), tm, cam, sampler, cfg, px, py, sidx,
                               differentiable=True)
    assert diff.requires_grad and TI.BOUNCES.bounces == bounces == cfg.max_depth
    assert torch.equal(diff.detach(), plain) and float(rays_d) == float(rays)
    diff.mean().backward()
    assert TI.BOUNCES.bounces == bounces and float(rays_d) == float(rays)


@pytest.mark.parametrize("field", FIELDS)
def test_material_grads_match_jax(box_grads, jax_ref, field):
    val, g = box_grads
    j_val, j_g = jax_ref
    np.testing.assert_allclose(val, j_val, rtol=1e-5)
    assert g[field].shape == j_g[field].shape and np.isfinite(g[field]).all()
    assert np.abs(g[field]).sum() > 0
    _close(g[field], j_g[field])


@pytest.mark.parametrize("remat", ["trace", "all"])
def test_remat_policies_bitwise(mat_grads, remat):
    """On cornell-mat, "trace" (hits replayed in the recomputation) and
    "all" (plain autograd) give "trace_lut"'s (hits and LUT gathers
    replayed) loss and gradients bit for bit."""
    val, g = mat_grads[remat]
    ref_val, ref = mat_grads["trace_lut"]
    assert val == ref_val
    for k in FIELDS:
        assert np.isfinite(g[k]).all() and np.abs(g[k]).sum() > 0, k
        np.testing.assert_array_equal(g[k], ref[k], err_msg=k)


def test_xla_grads_match_off(scenes, mat_grads):
    """shade_kernel="xla" (shade_math.finish(detach=True)) against the
    classic body on cornell-mat, the JAX test's bar (tests/test_diff.py
    `test_shade_xla_grads_match_classic_and_fd`)."""
    _, ref = mat_grads["trace_lut"]
    _, g = _grads(scenes, mat=True, shade_kernel="xla")
    for k in FIELDS:
        np.testing.assert_allclose(g[k], ref[k], rtol=2e-4, atol=1e-7, err_msg=k)


def test_clamp_helpers_take_jax_tie_rule():
    """At a bound, jnp.clip / maximum / minimum give half the gradient and
    torch.clamp all of it; the shading code's clamps (ops/vecmath.py) take
    JAX's rule where a gradient flows and are torch's clamps elsewhere."""
    x = torch.tensor([0.0, 1.0, 0.5, -1.0], requires_grad=True)
    xj = jnp.asarray([0.0, 1.0, 0.5, -1.0])
    for f, jf in ((lambda v: vecmath.clip(v, 0.0, 1.0), lambda v: jnp.clip(v, 0.0, 1.0)),
                  (lambda v: vecmath.maximum(v, 0.0), lambda v: jnp.maximum(v, 0.0)),
                  (lambda v: vecmath.minimum(v, 1.0), lambda v: jnp.minimum(v, 1.0))):
        (g,) = torch.autograd.grad(f(x).sum(), x)
        np.testing.assert_array_equal(g.numpy(), np.asarray(jax.grad(lambda v: jf(v).sum())(xj)))
        with torch.no_grad():
            assert torch.equal(f(x), torch.from_numpy(np.array(jf(xj))))
    np.testing.assert_array_equal(torch.autograd.grad(vecmath.clip(x, 0.0, 1.0).sum(), x)[0].numpy(),
                                  [0.5, 0.5, 1.0, 0.0])


def test_roughen_tie_matches_jax():
    """A clamp tie on the render path, against JAX: cornell-mat's glass has
    roughness 0.05, so a regularized lane's roughen(r) = max(r, clip(2r,
    0.1, 0.3)) sits on the clip's lower bound. The gradient of the sampled
    f w.r.t. the material table through `bsdf_sample(regularized=True)`
    matches jax.grad (rtol 1e-4); torch.clamp's rule doubles the roughness
    entry (the ~1.5% gap a cornell-mat render's roughness gradient showed
    before the clamps took JAX's rule)."""
    from yart_tpu.ops import lut as JL
    from yart_tpu.render import bsdf as JB
    from yart_tpu_torch.ops import lut as TL
    from yart_tpu_torch.render import bsdf as TB

    js, jm = j_cornell(extra_materials=True).compile()
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    glass = int(np.flatnonzero(np.asarray(js.materials.transmission) == 1.0)[0])
    assert js.materials.roughness[glass] == np.float32(0.05)
    n = 64
    rng = np.random.default_rng(5)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wo[:, 2] = np.abs(wo[:, 2]) + 0.2
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    u, uc, uc2 = rng.uniform(size=(n, 2)), rng.uniform(size=n), rng.uniform(size=n)
    u, uc, uc2 = (a.astype(np.float32) for a in (u, uc, uc2))
    idx = np.full(n, glass, np.int32)
    keys = ("roughness", "metallic", "transmission")

    def t_loss(*vals):
        s = dataclasses.replace(ts, materials=ts.materials._replace(**dict(zip(keys, vals))))
        mat = TB.resolve_material(s, tm, torch.from_numpy(idx))
        smp = TB.bsdf_sample(TL.load_tables("cpu"), mat, *(torch.from_numpy(a) for a in (wo, u, uc, uc2)),
                             torch.ones(n, dtype=torch.bool), meta=tm)
        return smp.f.sum(), smp.flags

    def j_loss(vals):
        s = js._replace(materials=js.materials._replace(**dict(zip(keys, vals))))
        mat = JB.resolve_material(s, jm, jnp.asarray(idx), jnp.zeros((n, 2), jnp.float32))
        smp = JB.bsdf_sample(JL.load_tables(), mat, *(jnp.asarray(a) for a in (wo, u, uc, uc2)),
                             jnp.ones(n, bool), meta=jm)
        return jnp.sum(smp.f), smp.flags

    leaves = [getattr(ts.materials, k).clone().requires_grad_(True) for k in keys]
    loss, flags = t_loss(*leaves)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    j_grads, j_flags = jax_fast(jax.grad(j_loss, has_aux=True), [getattr(js.materials, k) for k in keys])
    np.testing.assert_array_equal(flags.numpy(), np.asarray(j_flags))
    assert abs(float(j_grads[0][glass])) > 1e-3
    for k, g, jg in zip(keys, grads, j_grads):
        np.testing.assert_allclose(g[glass].item(), float(jg[glass]), rtol=1e-4, atol=1e-6, err_msg=k)


def test_compaction_and_overflow_drain_match_uncompacted(scenes):
    """The closed box, 16x16 at 2 spp (512 lanes), compaction after bounce 1
    into 128 lanes: 384 live lanes overflow into the full-width drain. The
    radiance is the uncompacted one bit for bit, the gradients agree."""
    out = {}
    for cd in (None, 1):
        ts, tm, cam, sampler, cfg, px, py, sidx = _setup(scenes, size=(16, 16), compact_depth=cd, compact_factor=4)
        bc = ts.materials.base_color.clone().requires_grad_(True)
        s = dataclasses.replace(ts, materials=ts.materials._replace(base_color=bc))
        rad, rays = render_wave(s, tm, cam, sampler, cfg, px, py, sidx, differentiable=True)
        (g,) = torch.autograd.grad(rad.mean(), bc)
        out[cd] = rad.detach(), float(rays), g.numpy()
    assert torch.equal(out[None][0], out[1][0]) and out[None][1] == out[1][1]
    assert np.abs(out[None][2]).sum() > 0
    np.testing.assert_allclose(out[1][2], out[None][2], rtol=2e-4, atol=1e-7)


def _loss_at(scenes, field, row, col, delta, scale=False):
    ts, tm, cam, sampler, cfg, px, py, sidx = _setup(scenes)
    v = getattr(ts.materials, field).clone()
    if scale:
        v[row] = v[row] * (1.0 + delta)
    else:
        v[row, col] += delta
    s = dataclasses.replace(ts, materials=ts.materials._replace(**{field: v}))
    with torch.no_grad():
        return float(render_wave(s, tm, cam, sampler, cfg, px, py, sidx)[0].mean())


def test_grads_match_finite_differences(scenes, box_grads):
    """Central differences at tests/test_diff.py's steps and bar: the
    white wall's red albedo (h 0.02) and the light's emission scale (h
    0.05, the directional derivative along emission[3])."""
    _, g = box_grads
    fd = (_loss_at(scenes, "base_color", 0, 0, 0.02) - _loss_at(scenes, "base_color", 0, 0, -0.02)) / 0.04
    assert g["base_color"][0, 0] > 0
    np.testing.assert_allclose(g["base_color"][0, 0], fd, rtol=0.08)
    em = scenes[2].materials.emission[3].numpy()
    ad = float((g["emission"][3] * em).sum())
    fd = (_loss_at(scenes, "emission", 3, None, 0.05, True) - _loss_at(scenes, "emission", 3, None, -0.05, True)) / 0.1
    assert ad > 0
    np.testing.assert_allclose(ad, fd, rtol=0.08)
