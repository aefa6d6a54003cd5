"""yart_tpu_torch.kernels.shade_math and kernels/shade.py (B5's and B6's
plain twins) against yart_tpu.kernels.shade_math and the Pallas kernels
`shade_pallas` / `draws_pallas` in interpret mode, on seeded lanes with
every lobe gate on.

Tolerances: the sampler draws (B6's twin) are bit-exact. Integer and
boolean outputs (sampled flags, nee_need, active, specular) are exact.
Floats agree to float noise on almost every lane; the exceptions are the
ill-conditioned lanes of tests/test_torch_bsdf.py (sharp GGX lobes, TIR
edges, VNDF disk edges), where XLA:CPU's FMA contraction and its
transcendentals differ in the last ulp from torch's and the lobe math
amplifies it. So floats must agree within rtol 1e-3 / atol 1e-5 on at
least 99.5% of lanes. The JAX component math runs eagerly (op by op, so
without cross-op FMA contraction); `shade_pallas` runs jitted in
interpret mode. The port's twin zeroes `contrib` and `shadow_d` on dead
lanes (neither active nor found), where the JAX math leaves values no
caller reads, so those two compare on live lanes only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yart_tpu.kernels import shade_math as JSM
from yart_tpu.kernels.pallas_shade import draws_pallas as j_draws_pallas
from yart_tpu.kernels.pallas_shade import sampler_draw_setup as j_draw_setup
from yart_tpu.kernels.pallas_shade import shade_pallas as j_shade_pallas
from yart_tpu.ops import lut as JL
from yart_tpu.ops import qmc as JQ
from yart_tpu_torch.kernels import shade as TK
from yart_tpu_torch.kernels import shade_math as TSM
from yart_tpu_torch.ops import lut as TL
from yart_tpu_torch.ops import qmc as TQ

GATES = (True, True, True, True)
N = 2048  # two of shade_pallas's 1024-lane blocks


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """This module's tests run the port on one intra-op thread, set when
    they start (every test module sets its own at import, so under xdist
    the last import would win). See tests/test_torch_bsdf.py's docstring."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def make_lanes(n, seed, dead_first_block=False):
    """Numpy inputs of one bounce: the material ranges of
    tests/test_shade_kernel.py:30-64 (smooth, thin and anisotropic lanes
    among them), random light samples and state."""
    rng = np.random.default_rng(seed)
    uni = lambda lo=0.0, hi=1.0, shape=(n,): rng.uniform(lo, hi, size=shape).astype(np.float32)
    rough = uni()
    rough[: n // 8] = uni(0.0, 0.03, (n // 8,))
    active = rng.uniform(size=n) < 0.9
    if dead_first_block:
        active[:1024] = False
    a = dict(
        o=uni(-1, 1, (n, 3)), d=_unit(rng, n), n=_unit(rng, n), p=uni(-1, 1, (n, 3)),
        atten=uni(0.05, 1, (n, 3)), last_p=uni(-1, 1, (n, 3)), base=uni(0.05, 1, (n, 3)),
        emission=np.where(rng.uniform(size=(n, 1)) < 0.3, uni(0.5, 5, (n, 3)), 0).astype(np.float32),
        volume_color=uni(0, 1, (n, 3)), ls_wi=_unit(rng, n), ls_Li=uni(0, 4, (n, 3)),
        ls_n=_unit(rng, n), ls_p=uni(-2, 2, (n, 3)),
        last_pdf=uni(0, 3), acc_rough=uni(0, 1), hit_t=uni(0, 3), u0=uni(), u1=uni(), uc=uni(),
        uc2=uni(), u_rr=uni(), metallic=uni(), roughness=rough, roughness_base=rough,
        transmission=uni(), ior=uni(1.05, 2.2), anisotropic=uni(), aniso_rotation=uni(-3, 3),
        clearcoat=uni(), cc_roughness=uni(), cc_roughness_base=uni(), volume_density=uni(0, 2),
        pdf_area=uni(0, 2), sel_p=uni(0, 1), ls_pdf=uni(0, 2), ls_select_p=uni(0, 1),
        active=active, found=active & (rng.uniform(size=n) < 0.9),
        specular_prev=rng.uniform(size=n) < 0.2, light_neg=rng.uniform(size=n) < 0.7,
        hit_back=rng.uniform(size=n) < 0.3, thin=rng.uniform(size=n) < 0.3,
        ls_valid=rng.uniform(size=n) < 0.9, ls_is_env=rng.uniform(size=n) < 0.3,
        force_reg=rng.uniform(size=n) < 0.3,
    )
    return a


def port_inp(a, depth0=False, rr_on=True):
    inp = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items() if k != "force_reg"}
    inp.update(depth0=depth0, rr_on=rr_on, reg_threshold=0.5)
    return inp


def jax_inp(a, depth0=False, rr_on=True, force_reg=False):
    n = a["active"].shape[0]
    inp = {}
    for k, v in a.items():
        if k == "force_reg":
            continue
        v = jnp.asarray(v)
        inp[k] = (v[:, 0], v[:, 1], v[:, 2]) if v.ndim == 2 else v
    inp.update(depth0=jnp.full((n,), depth0), rr_on=jnp.full((n,), rr_on), reg_threshold=0.5)
    if force_reg:
        inp["force_reg"] = jnp.asarray(a["force_reg"])
    return inp


def _np(v):
    if isinstance(v, tuple):
        return np.stack([np.asarray(c) for c in v], axis=-1)
    return np.asarray(v)


def _mostly_close(j, t, name, frac=0.995, rtol=1e-3, atol=1e-5):
    ok = np.isclose(t, j, rtol=rtol, atol=atol, equal_nan=True)
    ok = ok.reshape(ok.shape[0], -1).all(axis=1)
    assert ok.mean() >= frac, (name, ok.mean(), np.flatnonzero(~ok)[:10])


def _compare_outputs(jout, tout, live):
    for k in TSM.OUT_V3 + TSM.OUT_F + TSM.OUT_B:
        j, t = _np(jout[k]), tout[k].numpy()
        if k in ("contrib", "shadow_d"):
            j, t = j[live], t[live]
        if t.dtype == bool:
            np.testing.assert_array_equal(t, j != 0, err_msg=k)
        else:
            _mostly_close(j, t, k)


@pytest.fixture(scope="module")
def lanes():
    return make_lanes(N, 7)


@pytest.mark.parametrize("case", ["mis", "no_mis", "no_lights", "force_reg", "depth0"])
def test_component_math_matches_jax(lanes, case):
    """candidates -> run_fetches -> finish, the port against the JAX module."""
    mis = case != "no_mis"
    any_lights = case != "no_lights"
    force = case == "force_reg"
    depth0 = case == "depth0"
    jt, tt = JL.load_tables(), TL.load_tables("cpu")
    ji = jax_inp(lanes, depth0=depth0, force_reg=force)
    jc = JSM.candidates(ji, GATES)
    jf = JSM.run_fetches(jt, jc["coords"])
    jo = JSM.finish(ji, jc, jf, GATES, mis=mis, any_lights=any_lights)
    jsmp = JSM.bsdf_sample_c(ji, jc, jf, GATES)

    c = TSM.components(port_inp(lanes, depth0=depth0))
    tc = TSM.candidates(c, GATES, torch.from_numpy(lanes["force_reg"]) if force else None)
    tf = TSM.run_fetches(tt, tc["coords"])
    to = TSM.finish(c, tc, tf, GATES, mis=mis, any_lights=any_lights)
    tsmp = TSM.bsdf_sample_c(c, tc, tf, GATES)

    assert sorted(jf) == sorted(tf)
    for k in jf:
        _mostly_close(_np(jf[k]), tf[k].numpy(), k)
    np.testing.assert_array_equal(tsmp["flags"].numpy(), np.asarray(jsmp["flags"]))
    live = lanes["active"] | lanes["found"]
    _compare_outputs(jo, {k: torch.stack(v, -1) if isinstance(v, tuple) else v for k, v in to.items()}, live)


def test_finish_refuses_detach(lanes):
    """finish(detach=True), the differentiable mode's cut (the name is from
    when the port refused it): its outputs are finish()'s, and the gradient
    of its radiance and throughput w.r.t. the lanes' material against the
    JAX module's `jax.grad` through finish(detach=True), on the same lanes.
    The gradient of each lane is its own, so lanes compare one by one with
    the float bar of this module (rtol 1e-3, atol 1e-5, 99.5% of lanes)."""
    diff_keys = ("base", "metallic", "roughness", "emission")

    def port(detach, vals):
        inp = dict(port_inp(lanes), **dict(zip(diff_keys, vals)))
        c = TSM.components(inp)
        cand = TSM.candidates(c, GATES)
        out = TSM.finish(c, cand, TSM.run_fetches(TL.load_tables("cpu"), cand["coords"]), GATES,
                         detach=detach)
        return out, sum(torch.stack(out[k], -1).sum() for k in ("L_emit", "contrib", "atten"))

    leaves = [torch.from_numpy(lanes[k]).requires_grad_(True) for k in diff_keys]
    out, loss = port(True, leaves)
    ref, _ = port(False, [x.detach() for x in leaves])
    for k in ref:
        a, b = out[k], ref[k]
        a, b = (torch.stack(a, -1), torch.stack(b, -1)) if isinstance(a, tuple) else (a, b)
        assert torch.equal(a.detach(), b), k
    grads = torch.autograd.grad(loss, leaves)

    def jloss(vals):
        inp = dict(jax_inp(lanes), **dict(zip(diff_keys, vals)))
        cand = JSM.candidates(inp, GATES)
        o = JSM.finish(inp, cand, JSM.run_fetches(JL.load_tables(), cand["coords"]), GATES, detach=True)
        return sum(jnp.sum(jnp.stack(o[k], -1)) for k in ("L_emit", "contrib", "atten"))

    jvals = [(lambda v: (v[:, 0], v[:, 1], v[:, 2]) if v.ndim == 2 else v)(jnp.asarray(lanes[k]))
             for k in diff_keys]
    # Jitted with XLA:CPU's backend optimisation off: op by op, the JAX
    # side's gradient took ~20 s (each op compiled alone).
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    jgrads = jax.jit(jax.grad(jloss)).lower(jvals).compile(compiler_options=opts)(jvals)
    live = lanes["active"] | lanes["found"]
    for k, g, jg in zip(diff_keys, grads, jgrads):
        assert torch.isfinite(g).all() and g.abs().sum() > 0, k
        _mostly_close(_np(jg)[live], g.numpy()[live], k)


@pytest.mark.parametrize("sampler", ["zsobol_even", "zsobol_odd", "hash"])
def test_draws_twin_equals_draws_pallas(sampler):
    """B6's twin against draws_pallas (interpret mode), bit-exact, at N =
    300 (not a block multiple): ZSobol at 16 spp (even log2spp) and 8 spp
    (odd: the pow2_samples branch), and hash. A 32x32 film keeps the
    interpret-mode compile short (7 base-4 digits)."""
    rng = np.random.default_rng(5)
    n, res = 300, (32, 32)
    px, py = rng.integers(0, 32, n), rng.integers(0, 32, n)
    sidx = rng.integers(0, 8, n)
    spp = 8 if sampler == "zsobol_odd" else 16
    if sampler == "hash":
        js, ts = JQ.HashSampler(spp, res), TQ.HashSampler(spp, res, device="cpu")
    else:
        js, ts = JQ.ZSobolSampler(spp, res), TQ.ZSobolSampler(spp, res, device="cpu")
    jst = js.init_lanes(jnp.asarray(px, jnp.uint32), jnp.asarray(py, jnp.uint32), jnp.asarray(sidx, jnp.uint32))
    tst = ts.init_lanes(torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(sidx))
    for dim0 in (4, 28):
        jout = j_draws_pallas(j_draw_setup(js, jst, jnp.uint32(dim0)), n, interpret=True)
        setup = TK.sampler_draw_setup(ts, tst, dim0)
        assert setup is not None and setup.kind == sampler.split("_")[0]
        tout = TK.draws(setup, n)
        for k in TK.DRAW_OUT:
            np.testing.assert_array_equal(tout[k].numpy().view(np.int32),
                                          np.asarray(jout[k]).view(np.int32), err_msg=f"{k} dim0 {dim0}")


def test_shade_twin_matches_shade_pallas():
    """B5's twin against shade_pallas (interpret mode) on two 1024-lane
    blocks, the first dead (the TPU kernel's pass-through), the second
    live."""
    a = make_lanes(N, 11, dead_first_block=True)
    jo = j_shade_pallas(jax_inp(a), GATES, mis=True, any_lights=True, interpret=True)
    to = TK.shade(port_inp(a), GATES, True, True, TL.load_tables("cpu"))
    live = a["active"] | a["found"]
    _compare_outputs(jo, to, live)
    dead = ~live
    for k in ("contrib", "shadow_d", "L_emit"):
        np.testing.assert_array_equal(_np(jo[k])[:1024], 0.0, err_msg=k)
        np.testing.assert_array_equal(to[k].numpy()[dead], 0.0, err_msg=k)
    for k in ("o", "d", "atten", "last_p"):
        np.testing.assert_array_equal(to[k].numpy()[dead], a[k][dead], err_msg=k)
    assert TK.COUNTS_SHADE.launches == 0
