"""yart_tpu_torch.ops (vecmath, warps, ggx, lut, tonemap, color) against
yart_tpu.ops on the same seeded numpy inputs.

Tolerances: elementwise float32 math agrees to a few ulp; the gaps come from
XLA's and torch's different sin/cos/log/exp/rsqrt implementations and FMA
contraction inside XLA's contractions (LUT fetches), so rtol 1e-5 /
atol 1e-6 unless a test says otherwise. Integer / boolean results are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yart_tpu.ops import color as JC
from yart_tpu.ops import ggx as JG
from yart_tpu.ops import lut as JL
from yart_tpu.ops import tonemap as JT
from yart_tpu.ops import vecmath as JV
from yart_tpu.ops import warps as JW
from yart_tpu_torch.ops import color as TC
from yart_tpu_torch.ops import ggx as TG
from yart_tpu_torch.ops import lut as TL
from yart_tpu_torch.ops import tonemap as TT
from yart_tpu_torch.ops import vecmath as TV
from yart_tpu_torch.ops import warps as TW

N = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """This module's tests run the port on one intra-op thread, set when
    they start (every test module sets its own at import, so under xdist
    the last import would win). With two, PyTorch's CPU unary math splits
    an op at its 2048-element grain and the worker thread's results can
    move (tests/test_torch_bsdf.py); test_vecmath's refract was seen off
    by up to 2e-4 on the lanes such a worker computes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _unit(rng, n=N):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    return w / np.linalg.norm(w, axis=-1, keepdims=True)


def _close(j, t, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


T = torch.from_numpy


def test_vecmath():
    rng = np.random.default_rng(0)
    a, b = _unit(rng), _unit(rng)
    v = (a * rng.uniform(0, 3, (N, 1))).astype(np.float32)
    v[:8] = 0.0  # zero-length inputs normalize to 0
    ior = rng.uniform(1.05, 2.5, N).astype(np.float32)
    cos = rng.uniform(-1, 1, N).astype(np.float32)
    _close(JV.cross(a, b), TV.cross(T(a), T(b)))
    _close(JV.normalize(v), TV.normalize(T(v)))
    for jo, to in zip(JV.refract(a, b, ior), TV.refract(T(a), T(b), T(ior))):
        if to.dtype == torch.bool:
            np.testing.assert_array_equal(np.asarray(jo), to.numpy())
        else:
            _close(jo, to, atol=1e-5)
    _close(JV.fresnel_dielectric(cos, ior), TV.fresnel_dielectric(T(cos), T(ior)))
    _close(JV.fresnel_dielectric(cos, 1.5), TV.fresnel_dielectric(T(cos), 1.5))
    _close(JV.fresnel_schlick(a, cos[:, None]), TV.fresnel_schlick(T(a), T(cos)[:, None]))
    t = _unit(rng)
    t[:16] = a[:16]  # degenerate tangents take the normal-only frame
    for jf, tf in zip(JV.frame_from_normal_tangent(a, t), TV.frame_from_normal_tangent(T(a), T(t))):
        _close(jf, tf)
    a[:4] = [[0, 1, 0], [0, -1, 0], [0, 0.9995, 0.0316], [1, 0, 0]]
    _close(JV.shading_tangent(a), TV.shading_tangent(T(a)))
    fx, fy, fz = JV.frame_from_normal(a)
    _close(JV.world_to_local(b, fx, fy, fz), TV.world_to_local(T(b), *TV.frame_from_normal(T(a))))
    _close(JV.local_to_world(b, fx, fy, fz), TV.local_to_world(T(b), *TV.frame_from_normal(T(a))))


def test_warps():
    rng = np.random.default_rng(1)
    u = rng.random((N, 2), dtype=np.float32)
    u[:4] = [[0, 0], [0, 0.999], [1 - 2 ** -24, 0.5], [0.5, 0]]
    _close(JW.pixel_jitter_gaussian(u, 0.3), TW.pixel_jitter_gaussian(T(u), 0.3))
    _close(JW.sample_cosine_hemisphere(u), TW.sample_cosine_hemisphere(T(u)))
    _close(JW.sample_disk_uniform(u), TW.sample_disk_uniform(T(u)))
    _close(JW.sample_tri_uniform(u), TW.sample_tri_uniform(T(u)))
    for sides in (3, 6):
        _close(JW.sample_poly_uniform(u, sides), TW.sample_poly_uniform(T(u), sides))


def test_ggx():
    rng = np.random.default_rng(2)
    wo, wm = _unit(rng), _unit(rng)
    wm[:, 2] = np.abs(wm[:, 2])
    wo[:4] = [[0, 0, 1], [1, 0, 0], [0, 0, -1], [0.6, 0.8, 0]]  # poles and grazing
    r = rng.uniform(0.0, 1.0, N).astype(np.float32)
    r[:64] = 0.0  # smooth lanes
    aniso = rng.uniform(0, 1, N).astype(np.float32)
    u = rng.random((N, 2), dtype=np.float32)
    ja, ta = JG.make_alphas(r, aniso), TG.make_alphas(T(r), T(aniso))
    for jx, tx in zip(ja, ta):
        _close(jx, tx)
    np.testing.assert_array_equal(np.asarray(JG.smooth(ja)), TG.smooth(ta).numpy())
    # D, G and the visible-NDF pdf are steep functions of their inputs (the
    # NDF peaks like 1/alpha^2): a few ulp of alpha or cos^2 move them by
    # ~1e-4 relative at small roughness.
    _close(JG.mdf(ja, wm), TG.mdf(ta, T(wm)), rtol=1e-4)
    _close(JG.g1(ja, wo), TG.g1(ta, T(wo)), rtol=1e-4)
    _close(JG.g(ja, wo, wm), TG.g(ta, T(wo), T(wm)), rtol=1e-4)
    _close(JG.vmdf(ja, wo, wm), TG.vmdf(ta, T(wo), T(wm)), rtol=1e-4)
    # VNDF sampling stays well conditioned except where the sampled disk
    # point lands on the edge (sqrt of ~0), hence atol 1e-4 on directions.
    _close(JG.sample_visible(ja, wo, u), TG.sample_visible(ta, T(wo), T(u)), rtol=1e-4, atol=1e-4)


def test_lut_fetches_match_reference_indexing():
    """Includes negative and >1 coordinates: the reference's backside
    extrapolation (top-bin select, unclamped lerp) must be reproduced."""
    rng = np.random.default_rng(3)
    jt, tt = JL.load_tables(), TL.load_tables("cpu")
    for k in jt:
        np.testing.assert_array_equal(jt[k], tt[k].numpy())
    cos = rng.uniform(-1.0, 1.2, N).astype(np.float32)
    cos[:4] = [-1.0, -1e-7, 0.0, 1.0]
    r = rng.uniform(0, 1, N).astype(np.float32)
    f0 = rng.uniform(0, 1, N).astype(np.float32)
    ior = rng.uniform(0.4, 2.5, N).astype(np.float32)
    # LUT values are O(1); atol covers XLA's FMA in the weight contractions.
    tol = dict(rtol=1e-5, atol=2e-6)
    _close(JL.ggx_e(jt, cos, r), TL.ggx_e(tt, T(cos), T(r)), **tol)
    _close(JL.ggx_eavg(jt, cos), TL.ggx_eavg(tt, T(cos)), **tol)
    _close(JL.ggx_base_e(jt, f0, r, cos), TL.ggx_base_e(tt, T(f0), T(r), T(cos)), **tol)
    _close(JL.ggx_base_eavg(jt, f0, cos), TL.ggx_base_eavg(tt, T(f0), T(cos)), **tol)
    _close(JL.ggx_glass_e(jt, ior, r, cos), TL.ggx_glass_e(tt, T(ior), T(r), T(cos)), **tol)
    # The extrapolation is real: backside values leave the table's range.
    e = TL.ggx_e(tt, T(cos), T(r)).numpy()
    assert (e[cos < 0] > 1.0).any() or (e[cos < 0] < 0.0).any()
    # NaN coordinates give NaN, never an out-of-range index.
    nan = torch.full((4,), float("nan"))
    assert torch.isnan(TL.ggx_e(tt, nan, nan)).all()


@pytest.mark.parametrize("look", ["none", "golden", "punchy"])
def test_agx_tonemap(look):
    rng = np.random.default_rng(4)
    hdr = (rng.lognormal(-1.0, 2.0, (N, 3)) * (rng.random((N, 1)) > 0.01)).astype(np.float32)
    _close(JT.tonemap(jnp.asarray(hdr), "agx", look), TT.tonemap(T(hdr), "agx", look), rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(TT.tonemap(T(hdr), "none").numpy(), hdr)


def test_color():
    v = np.linspace(-0.1, 1.2, 1001).astype(np.float32)
    _close(JC.srgb_decode(v), TC.srgb_decode(T(v)))
    _close(JC.srgb_encode(v), TC.srgb_encode(T(v)))
    _close(JC.gamma22_encode(v), TC.gamma22_encode(T(v)))
    _close(JC.gamma2_decode(v), TC.gamma2_decode(T(v)))
