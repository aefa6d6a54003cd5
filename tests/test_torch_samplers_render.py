"""`Dist2D` (yart_tpu/ops/distribution.py) and renders with the samplers
ported from yart_tpu/ops/qmc.py, against the JAX package.

`Dist2D`'s tables are bit-equal and its samples within 1e-6, with
tests/test_distribution.py's statistical checks on the port. A 16x16
env-lit render with the stratified sampler and staged compaction against
the JAX Renderer at the port's image bar (>= 95% of pixels within rtol
1e-4 / atol 1e-5, channel means within 0.5%), and the fused shade path's
draw setup: B6 draws only ZSobol + FastOwen and hash, so for the other
samplers `sampler_draw_setup` is None and "pallas" draws through the
sampler, equal to "xla" bitwise and to "off" at
tests/test_shade_kernel.py:209-222's bar."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yart_tpu.config import CameraConfig as JCam
from yart_tpu.config import RenderConfig as JCfg
from yart_tpu.ops import distribution as JD
from yart_tpu.render.renderer import Renderer as JRenderer
from yart_tpu.scene.procedural import cornell_box as j_cornell
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.kernels import shade as TK
from yart_tpu_torch.ops import distribution as TD
from yart_tpu_torch.ops import qmc as T
from yart_tpu_torch.render.renderer import Renderer
from yart_tpu_torch.scene.convert import from_numpy

KINDS = ["stratified", "zsobol:null", "zsobol:binary", "zsobol:owen"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The port on one intra-op thread in this module (tests/test_torch_bsdf.py's docstring)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------- Dist2D


@pytest.mark.parametrize("shape,seed", [((16, 32), 1), ((3, 5), 2), ((1, 7), 3), ((8, 1), 4)])
def test_dist2d_against_jax(shape, seed):
    rng = np.random.default_rng(seed)
    f = rng.random(shape) ** 2
    f[0] = 0.0  # a row that integrates to 0 takes the uniform CDF
    if shape[0] > 2:
        f[2, : shape[1] // 2] = 0.0
    jd, td = JD.build_dist2d(f), TD.build_dist2d(f, device="cpu")
    for name in TD.Dist2D._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jd, name)), getattr(td, name).numpy(), err_msg=name)
    u = rng.random((4096, 2), np.float32)
    u[:4] = [[0.0, 0.0], [0.99999994, 0.99999994], [0.5, 0.0], [0.0, 0.5]]
    juv, jpdf = JD.sample_dist2d(jd, jnp.asarray(u))
    tuv, tpdf = TD.sample_dist2d(td, torch.from_numpy(u))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TD.pdf_dist2d(td, tuv).numpy(), np.asarray(JD.pdf_dist2d(jd, juv)), rtol=1e-6)


def test_dist2d_statistics():
    """tests/test_distribution.py's checks, on the port."""
    f = np.asarray([[1.0, 3.0], [2.0, 2.0]])
    d = TD.build_dist2d(f, device="cpu")
    np.testing.assert_allclose(float(d.integral), f.mean(), rtol=1e-6)
    np.testing.assert_allclose(d.cond_cdf[:, -1].numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(d.marg_cdf[-1]), 1.0, rtol=1e-6)

    rng = np.random.default_rng(0)
    uv, _ = TD.sample_dist2d(TD.build_dist2d(np.zeros((4, 4)), device="cpu"),
                             torch.from_numpy(rng.random((256, 2), np.float32)))
    assert ((uv >= 0) & (uv <= 1)).all()

    rng = np.random.default_rng(1)
    d = TD.build_dist2d(rng.random((16, 32)) ** 2 + 0.01, device="cpu")
    uv, pdf = TD.sample_dist2d(d, torch.from_numpy(rng.random((4096, 2), np.float32)))
    np.testing.assert_allclose(pdf.numpy(), TD.pdf_dist2d(d, uv).numpy(), rtol=2e-3, atol=1e-4)

    rng = np.random.default_rng(2)
    f = rng.random((8, 8)) + 0.1
    d = TD.build_dist2d(f, device="cpu")
    uv, pdf = TD.sample_dist2d(d, torch.from_numpy(rng.random((1 << 15, 2), np.float32)))
    g = TD.pdf_dist2d(d, uv).numpy() * float(d.integral)
    np.testing.assert_allclose((g / np.maximum(pdf.numpy(), 1e-9)).mean(), f.mean(), rtol=2e-2)

    rng = np.random.default_rng(3)
    d = TD.build_dist2d(np.asarray([[1.0, 0.0], [0.0, 3.0]]), device="cpu")
    uv = TD.sample_dist2d(d, torch.from_numpy(rng.random((1 << 15, 2), np.float32)))[0].numpy()
    np.testing.assert_allclose(((uv[:, 0] < 0.5) & (uv[:, 1] < 0.5)).mean(), 0.25, atol=2e-2)
    np.testing.assert_allclose(((uv[:, 0] >= 0.5) & (uv[:, 1] >= 0.5)).mean(), 0.75, atol=2e-2)
    assert ((uv[:, 0] >= 0.5) & (uv[:, 1] < 0.5)).mean() < 1e-3


# ---------------------------------------------------------------- renders

CAM = dict(image_size=(16, 16), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
CFG = dict(samples=4, max_depth=4, estimator="mean", tonemap="none", first_wave_samples=4, max_wave_samples=4)


@pytest.fixture(scope="module")
def cornell_env():
    """cornell-mat under a uniform env (env-lit: compaction at depth 2),
    compiled by the JAX package: (jax scene, jax meta, port scene, port meta)."""
    b = j_cornell(extra_materials=True)
    b.set_env_uniform((0.4, 0.45, 0.5))
    js, jm = b.compile()
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    return js, jm, ts, tm


def _render(scene, meta, **cfg):
    res = Renderer(scene, meta, CameraConfig(**CAM), RenderConfig(**dict(CFG, **cfg)), device="cpu").render()
    return res.hdr, res.total_rays


def test_stratified_render_matches_jax_renderer(cornell_env):
    js, jm, ts, tm = cornell_env
    cfg = dict(sampler="stratified", compact_depth=2, compact_factor=2)
    img, _ = _render(ts, tm, **cfg)
    ref = np.asarray(JRenderer(js, jm, JCam(**CAM), JCfg(**CFG, **cfg)).render().hdr)
    assert img.shape == ref.shape and np.isfinite(img).all() and img.mean() > 0.01
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)), rtol=5e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_draw_setup_none_and_pallas_draws_through_the_sampler(cornell_env, kind):
    _, _, ts, tm = cornell_env
    s = T.make_sampler(kind, 4, (16, 16), device="cpu")
    st = s.init_lanes(torch.arange(8), torch.arange(8), torch.zeros(8, dtype=torch.int64))
    assert TK.sampler_draw_setup(s, st, 4) is None
    for drawable in ("zsobol", "zsobol:fastowen", "hash"):
        s = T.make_sampler(drawable, 4, (16, 16), device="cpu")
        assert TK.sampler_draw_setup(s, s.init_lanes(torch.arange(8), torch.arange(8), torch.zeros(
            8, dtype=torch.int64)), 4) is not None
    TK.COUNTS_DRAWS.reset()
    off, r_off = _render(ts, tm, sampler=kind)
    xla, r_xla = _render(ts, tm, sampler=kind, shade_kernel="xla")
    pal, r_pal = _render(ts, tm, sampler=kind, shade_kernel="pallas")
    assert TK.COUNTS_DRAWS.launches == 0 and TK.COUNTS_DRAWS.plain_cuda == 0
    np.testing.assert_array_equal(pal.view(np.int32), xla.view(np.int32))
    assert r_pal == r_xla
    rel = np.abs(off - pal) / np.maximum(np.abs(off), 1.0)
    assert (rel < 1e-3).mean() > 0.99, f"flip fraction {(rel >= 1e-3).mean()}"
    assert np.median(rel) < 1e-5
    assert abs(off.mean() - pal.mean()) < 0.02 * max(off.mean(), 1e-6)
    assert abs(r_off - r_pal) <= max(8.0, 0.005 * r_off)
