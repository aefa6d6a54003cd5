"""The fused shade bounce (`shade_kernel="xla"` and `"pallas"`) in whole
renders: the port's "xla" render of cornell-mat against the JAX
Renderer's "xla" render, the port's "pallas" (B6 and B5's twins on the
CPU) bitwise against its "xla", "xla" against the classic body ("off"),
the textured box under "pallas", and the refusals.

Tolerances: against the JAX Renderer the port's image bar (>= 95% of
pixels within rtol 1e-4 / atol 1e-5, channel means within 0.5%). Against
"off" the bar of tests/test_shade_kernel.py:209-222: the fused body
orders its floats differently from the classic body (and applies the JAX
shade body's roulette), so a few lanes near a lobe, roulette or NEE
threshold take another valid sample: >= 99% of pixels within 1e-3
relative, the median relative difference under 1e-5, the mean within 2%,
the ray counts within max(8, 0.5%)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from yart_tpu.config import CameraConfig as JCam
from yart_tpu.config import RenderConfig as JCfg
from yart_tpu.render.renderer import Renderer as JRenderer
from yart_tpu.scene.procedural import cornell_box as j_cornell
from yart_tpu_torch import cli
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.kernels import shade as TK
from yart_tpu_torch.render import integrator as TI
from yart_tpu_torch.render.renderer import Renderer
from yart_tpu_torch.scene.convert import from_numpy
from yart_tpu_torch.scene.procedural import textured_box_scene

CAM = dict(image_size=(12, 12), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
CFG = dict(samples=4, max_depth=4, estimator="mean", tonemap="none", first_wave_samples=4, max_wave_samples=4)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """This module's tests run the port on one intra-op thread, set when
    they start (every test module sets its own at import, so under xdist
    the last import would win). See tests/test_torch_bsdf.py's docstring."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cornell_mat():
    js, jm = j_cornell(extra_materials=True).compile()
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    return js, jm, ts, tm


def _render(scene, meta, cam=CAM, **cfg):
    res = Renderer(scene, meta, CameraConfig(**cam), RenderConfig(**dict(CFG, **cfg)), device="cpu").render()
    return res.hdr, res.total_rays


def _assert_images_equivalent(a, b, rays_a, rays_b):
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
    assert (rel < 1e-3).mean() > 0.99, f"flip fraction {(rel >= 1e-3).mean()}"
    assert np.median(rel) < 1e-5
    assert abs(a.mean() - b.mean()) < 0.02 * max(a.mean(), 1e-6)
    assert abs(rays_a - rays_b) <= max(8.0, 0.005 * rays_a)


def test_xla_render_matches_jax_renderer(cornell_mat):
    js, jm, ts, tm = cornell_mat
    img, _ = _render(ts, tm, shade_kernel="xla")
    ref = np.asarray(JRenderer(js, jm, JCam(**CAM), JCfg(**CFG, shade_kernel="xla")).render().hdr)
    assert img.shape == ref.shape and np.isfinite(img).all() and img.mean() > 0.01
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)), rtol=5e-3)


@pytest.mark.parametrize("integrator", ["mis", "naive"])
def test_pallas_equals_xla_and_xla_matches_off(cornell_mat, integrator):
    """"pallas" runs B6's and B5's twins on CPU tensors: the same images as
    "xla" bit for bit; "xla" against the classic body at the JAX bar."""
    _, _, ts, tm = cornell_mat
    TK.COUNTS_SHADE.reset()
    off, r_off = _render(ts, tm, integrator=integrator)
    xla, r_xla = _render(ts, tm, integrator=integrator, shade_kernel="xla")
    pal, r_pal = _render(ts, tm, integrator=integrator, shade_kernel="pallas")
    assert TK.COUNTS_SHADE.launches == 0 and TK.COUNTS_SHADE.plain_cuda == 0
    np.testing.assert_array_equal(pal.view(np.int32), xla.view(np.int32))
    assert r_pal == r_xla
    _assert_images_equivalent(off, xla, r_off, r_xla)


def test_textured_box_pallas_matches_off():
    """Atlas-resolved materials and normal maps enter the fused body as
    inputs (tests/test_shade_kernel.py:415)."""
    scene, meta = textured_box_scene().compile("cpu")
    cam = dict(image_size=(10, 10), focal_length=26.0, position=(0.0, 1.2, 4.0), forward=(0, -0.15, -1))
    a, ra = _render(scene, meta, cam)
    b, rb = _render(scene, meta, cam, shade_kernel="pallas")
    _assert_images_equivalent(a, b, ra, rb)


def test_pallas_inputs_fit_b5_on_every_traversal(monkeypatch):
    """The inputs the "pallas" body hands B5 are the contiguous [N, 3] /
    [N] tensors the CUDA kernel takes (kernels/shade.py check_inputs), on
    a block-trace scene (spheres: the traversal's t is a column view) and
    a gated brute scene (the textured box)."""
    seen = []
    orig = TK.shade

    def checked(inp, gates, mis, any_lights, tables):
        TK.check_inputs(inp, mis, any_lights)
        seen.append(inp["active"].shape[0])
        return orig(inp, gates, mis, any_lights, tables)

    monkeypatch.setattr(TK, "shade", checked)
    from yart_tpu_torch.scene.procedural import material_test_spheres

    for scene, meta, cam in (
            (*material_test_spheres().compile("cpu"),
             dict(image_size=(6, 6), position=(0, 2.2, 5.5), forward=(0, -1.8, -6.1))),
            (*textured_box_scene().compile("cpu"),
             dict(image_size=(6, 6), focal_length=26.0, position=(0.0, 1.2, 4.0), forward=(0, -0.15, -1)))):
        n = len(seen)
        img, _ = _render(scene, meta, cam, shade_kernel="pallas", max_depth=3)
        assert len(seen) > n and np.isfinite(img).all()


def test_refusals(cornell_mat):
    _, _, ts, tm = cornell_mat
    with pytest.raises(NotImplementedError, match="force_reg"):
        _render(ts, tm, shade_kernel="pallas", regularize_specular=2)
    with pytest.raises(ValueError, match="shade_kernel"):
        _render(ts, tm, shade_kernel="mosaic")
    # Differentiable mode: "pallas" has no backward and is refused with the
    # JAX package's message; "xla" runs (kernels/shade_math.py finish(detach=True))
    # and renders the forward's image.
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    with pytest.raises(NotImplementedError, match="no VJP"):
        TI.li(ts, tm, None, None, o, d, RenderConfig(shade_kernel="pallas"), differentiable=True)
    from yart_tpu_torch.ops.qmc import make_sampler

    sampler = make_sampler("zsobol", 1, (2, 2), 0, device="cpu")
    lanes = sampler.init_lanes(torch.tensor([0, 1, 0, 1]), torch.tensor([0, 0, 1, 1]), torch.zeros(4, dtype=torch.int64))
    o = torch.tensor([[0.0, 1.0, 3.4]]).repeat(4, 1)
    cfg = RenderConfig(shade_kernel="xla", max_depth=3)
    plain, rays = TI.li(ts, tm, sampler, lanes, o, d, cfg)
    diff, rays_d = TI.li(ts, tm, sampler, lanes, o, d, cfg, differentiable=True)
    assert torch.equal(plain, diff) and float(rays) == float(rays_d) and float(plain.sum()) > 0
    # "xla" carries the specular-chain regularization.
    img, _ = _render(ts, tm, shade_kernel="xla", regularize_specular=2)
    assert np.isfinite(img).all()


def test_cli_shade_kernel(capsys):
    args = cli.parse_args(["cornell-mat", "--shade-kernel", "pallas", "--device", "cpu"])
    assert cli.render_configs(args)[1].shade_kernel == "pallas"
    with pytest.raises(SystemExit) as e:
        cli.parse_args(["cornell-mat", "--shade-kernel", "pallas", "--regularize-specular", "2"])
    assert e.value.code == 2
    assert TI.PALLAS_REG_SPECULAR in capsys.readouterr().err
