"""Inverse rendering with the port (`yart_tpu_torch/tools/inverse_render.py`
`optimize_materials`, torch.optim.Adam at optax.adam's defaults) on
tests/test_inverse.py's problem: the cornell box's red wall perturbed to
(0.3, 0.3, 0.6) must optimize back to the target image's true colour,
16x16 at 2 spp, depth 3, 60 steps at lr 0.05, only the perturbed row free.
The bars are the JAX test's: a loss drop of more than 95%, the colour
within 0.05, the frozen rows untouched. The first step's loss and
gradient against the JAX package's (one JAX `value_and_grad` of the same
mean-squared loss, jitted with XLA:CPU's backend optimisation off): the
loss within rtol 1e-5, the gradient within rtol 1e-3 plus 1e-4 of its
largest entry."""

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
from yart_tpu.render.integrator import render_wave as j_render_wave
from yart_tpu.scene.procedural import cornell_box as j_cornell
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.ops.qmc import make_sampler
from yart_tpu_torch.render import diff as TD
from yart_tpu_torch.render.camera import build_camera
from yart_tpu_torch.render.integrator import render_wave
from yart_tpu_torch.scene.convert import from_numpy
from yart_tpu_torch.tools import inverse_render

SIZE = (16, 16)
SPP = 2
CAM = dict(image_size=SIZE, focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
CFG = dict(samples=SPP, max_depth=3, rr_start_depth=99)
BAD = (0.3, 0.3, 0.6)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
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
def setup():
    """(JAX scene, meta, port scene, meta, port camera, sampler, cfg, lanes,
    target, true and perturbed colour tables)."""
    js, jm = j_cornell().compile()
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    cfg = RenderConfig(**CFG)
    lanes = tuple(torch.from_numpy(a.astype(np.int64)) for a in _lanes(SIZE, SPP))
    cam = build_camera(CameraConfig(**CAM), "cpu")
    sampler = make_sampler(cfg.sampler, SPP, SIZE, 0, device="cpu")
    with torch.no_grad():
        target, _ = render_wave(ts, tm, cam, sampler, cfg, *lanes)
    bc_true = ts.materials.base_color.numpy()
    bc_bad = bc_true.copy()
    bc_bad[1, :3] = BAD
    return js, jm, ts, tm, cam, sampler, cfg, lanes, target, bc_true, bc_bad


def jax_fast(fn, *args):
    """fn(*args) under jax.jit with XLA:CPU's backend optimisation off,
    which compiles the differentiable scan in about two thirds of the time
    (the values differ from the optimised build's in float noise)."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)(*args)


@pytest.fixture(scope="module")
def jax_first_step(setup):
    js, jm, target, bc_bad = setup[0], setup[1], setup[8], setup[10]
    cfg = JCfg(**CFG)
    cam, sampler = j_build_camera(JCam(**CAM)), j_make_sampler(cfg.sampler, SPP, SIZE, 0)

    def loss(bc, s, tgt, px, py, sidx):
        s = s._replace(materials=s.materials._replace(base_color=bc))
        img, _ = j_render_wave(s, jm, cam, sampler, cfg, px, py, sidx, differentiable=True)
        return jnp.mean((img - tgt) ** 2)

    val, g = jax_fast(jax.value_and_grad(loss), jnp.asarray(bc_bad), js, jnp.asarray(target.numpy()),
                      *(jnp.asarray(a) for a in _lanes(SIZE, SPP)))
    return float(val), np.asarray(g)


@pytest.fixture(scope="module")
def result(setup):
    _, _, ts, tm, cam, sampler, cfg, lanes, target, _, bc_bad = setup
    bad = dataclasses.replace(ts, materials=ts.materials._replace(base_color=torch.from_numpy(bc_bad)))
    mask = np.zeros(bc_bad.shape[0], bool)
    mask[1] = True
    return inverse_render.optimize_materials(bad, tm, cam, sampler, cfg, *lanes, target, steps=60, lr=0.05,
                                             mask=mask)


def test_recover_wall_albedo(setup, result):
    bc_true, bc_bad = setup[9], setup[10]
    assert len(result.losses) == 60 and np.isfinite(result.losses).all()
    assert result.losses[-1] < result.losses[0] * 0.05  # >95% loss reduction
    got = result.base_color.numpy()
    np.testing.assert_allclose(got[1, :3], bc_true[1, :3], atol=0.05)
    np.testing.assert_array_equal(np.delete(got, 1, axis=0), np.delete(bc_bad, 1, axis=0))
    assert result.image.shape == (SIZE[0] * SIZE[1] * SPP, 3) and not result.image.requires_grad


def test_first_step_matches_jax(setup, result, jax_first_step):
    """The loop's first loss, and the gradient of that loss through
    `material_grads`, against the JAX package's."""
    _, _, ts, tm, cam, sampler, cfg, lanes, target, _, bc_bad = setup
    j_val, j_g = jax_first_step
    np.testing.assert_allclose(result.losses[0], j_val, rtol=1e-5)
    bad = dataclasses.replace(ts, materials=ts.materials._replace(base_color=torch.from_numpy(bc_bad)))
    val, g = TD.material_grads(bad, tm, cam, sampler, cfg, *lanes, fields=["base_color"],
                               loss_fn=lambda img: ((img - target) ** 2).mean())
    assert float(val) == result.losses[0]
    g = g["base_color"].numpy()
    assert np.abs(g[1]).sum() > 0
    np.testing.assert_allclose(g, j_g, rtol=1e-3, atol=1e-4 * np.abs(j_g).max())


def test_autotune_picks_compaction_from_live_counts(setup, monkeypatch):
    """With compact_depth "auto" one forward probe's per-depth live counts
    go through `renderer.choose_compaction` and the steps run with its pick
    (here the box keeps its lanes, so none)."""
    from yart_tpu_torch.render import renderer

    _, _, ts, tm, cam, sampler, cfg, lanes, target, _, _ = setup
    seen = []
    choose = renderer.choose_compaction
    monkeypatch.setattr(renderer, "choose_compaction", lambda live, n, d: seen.append((list(live), n, d))
                        or choose(live, n, d))
    res = inverse_render.optimize_materials(ts, tm, cam, sampler, dataclasses.replace(cfg, compact_depth="auto"),
                                            *lanes, target, steps=1)
    assert len(seen) == 1 and seen[0][1] == lanes[0].shape[0] and seen[0][2] == cfg.max_depth
    assert seen[0][0][0] == lanes[0].shape[0] and res.losses[0] < 1e-12
