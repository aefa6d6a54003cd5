"""The port's differentiable path on an env-lit scene against the JAX
package: `render/diff.py` `env_grads` (the env rows rebuilt from the
image, the alias table fixed) and the material table's base_color,
metallic and roughness, with roulette on (the detached kill probability q
and its 1/(1-q) reweight). Then the port on its own: staged compaction in its
differentiable flavour ("auto" splits at 2 only with roulette live), the
remat policies, and central finite differences of the env.

The scene is a floor and a low-poly glossy sphere under an 8x8 sky
gradient: 258 triangles, so B1's path. One JAX `value_and_grad`
(jitted with XLA:CPU's backend optimisation off, ~40 s cold) serves the
module. Tolerances: the loss within rtol 1e-5, each gradient within rtol
1e-3 plus 1e-4 of its largest entry; compaction against none at
tests/test_diff.py's bar (rtol 2e-4, atol 1e-7; radiance bitwise); the
policies bitwise; finite differences at rtol 0.08."""

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
from yart_tpu.render.lights import env_rows_from_image as j_env_rows
from yart_tpu.scene.builder import SceneBuilder as JBuilder
from yart_tpu.scene.procedural import uv_sphere
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.ops.qmc import make_sampler
from yart_tpu_torch.render import diff as TD
from yart_tpu_torch.render import integrator as TI
from yart_tpu_torch.render.camera import build_camera
from yart_tpu_torch.render.lights import env_rows_from_image
from yart_tpu_torch.scene.convert import from_numpy

SIZE = (8, 8)
SPP = 2
CAM = dict(image_size=SIZE, focal_length=26.0, position=(0.0, 1.6, 5.0), forward=(0, -0.2, -1))
CFG = dict(samples=SPP, max_depth=4, rr_start_depth=2, compact_depth=None)
LEAVES = ("env_image", "base_color", "metallic", "roughness")


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


def env_scene():
    b = JBuilder()
    floor = b.add_material(base_color=(0.5, 0.5, 0.5, 1.0), roughness=0.9)
    fv = np.asarray([[-12, 0, -12], [12, 0, -12], [12, 0, 12], [-12, 0, 12]], np.float32)
    b.add_mesh(fv, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32), floor)
    v, nrm, idx = uv_sphere((0.0, 0.5, 0.0), 0.5, 8, 16)
    b.add_mesh(v, idx, b.add_material(base_color=(0.2, 0.3, 0.8, 1.0), roughness=0.5), normals=nrm)
    yy, xx = np.meshgrid(np.linspace(0, 1, 8), np.linspace(0, 1, 8), indexing="ij")
    b.set_env(np.stack([0.4 + 0.8 * yy, 0.5 + 0.3 * xx, 0.9 - 0.5 * yy * xx], -1).astype(np.float32))
    return b.compile()


@pytest.fixture(scope="module")
def scenes():
    js, jm = env_scene()
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    return js, jm, ts, tm


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

    def loss(s, px, py, sidx, env_image, bc, metallic, roughness):
        s = s._replace(env_image=env_image, env_rows=j_env_rows(env_image, s.env_pdf_cells),
                       materials=s.materials._replace(base_color=bc, metallic=metallic, roughness=roughness))
        return jnp.mean(j_render_wave(s, jm, cam, sampler, cfg, px, py, sidx, differentiable=True)[0])

    m = js.materials
    val, g = jax_fast(jax.value_and_grad(loss, argnums=(4, 5, 6, 7)), js,
                      *(jnp.asarray(a) for a in _lanes(SIZE, SPP)), js.env_image, m.base_color, m.metallic,
                      m.roughness)
    return float(val), dict(zip(LEAVES, (np.asarray(x) for x in g)))


def _setup(ts, size=SIZE, **cfg):
    cfg = RenderConfig(**dict(CFG, **cfg))
    px, py, sidx = (torch.from_numpy(a.astype(np.int64)) for a in _lanes(size, cfg.samples))
    return (build_camera(CameraConfig(**dict(CAM, image_size=size)), "cpu"),
            make_sampler(cfg.sampler, cfg.samples, size, 0, device="cpu"), cfg, px, py, sidx)


def _all_grads(ts, tm, size=SIZE, **cfg):
    """(radiance, rays, loss, {leaf: gradient}) of mean radiance w.r.t. the
    env image and three material fields, in one backward pass."""
    cam, sampler, cfg, px, py, sidx = _setup(ts, size, **cfg)
    m = ts.materials
    xs = [x.clone().requires_grad_(True) for x in (ts.env_image, m.base_color, m.metallic, m.roughness)]
    s = dataclasses.replace(ts, env_image=xs[0], env_rows=env_rows_from_image(xs[0], ts.env_rows[:, 12]),
                            materials=m._replace(base_color=xs[1], metallic=xs[2], roughness=xs[3]))
    rad, rays = TI.render_wave(s, tm, cam, sampler, cfg, px, py, sidx, differentiable=True)
    loss = rad.mean()
    grads = torch.autograd.grad(loss, xs)
    return rad.detach(), float(rays), float(loss.detach()), {k: g.numpy() for k, g in zip(LEAVES, grads)}


@pytest.fixture(scope="module")
def port(scenes):
    return {remat: _all_grads(*scenes[2:], remat=remat) for remat in ("trace_lut", "all")}


@pytest.mark.parametrize("leaf", LEAVES)
def test_grads_match_jax(jax_ref, port, leaf):
    _, _, val, g = port["trace_lut"]
    j_val, j_g = jax_ref
    np.testing.assert_allclose(val, j_val, rtol=1e-5)
    assert g[leaf].shape == j_g[leaf].shape and np.isfinite(g[leaf]).all() and np.abs(g[leaf]).sum() > 0
    np.testing.assert_allclose(g[leaf], j_g[leaf], rtol=1e-3, atol=1e-4 * np.abs(j_g[leaf]).max())


def test_env_grads_api(scenes, port):
    """`env_grads` (only the image differentiated) gives the joint pass's
    env gradient and loss."""
    ts, tm = scenes[2:]
    cam, sampler, cfg, px, py, sidx = _setup(ts)
    val, g = TD.env_grads(ts, tm, cam, sampler, cfg, px, py, sidx, loss_fn=torch.mean)
    _, _, ref_val, ref = port["trace_lut"]
    assert g.shape == ts.env_image.shape and float(val) == ref_val
    np.testing.assert_allclose(g.numpy(), ref["env_image"], rtol=1e-5, atol=1e-9)


def test_remat_all_bitwise(port):
    a, b = port["trace_lut"], port["all"]
    assert torch.equal(a[0], b[0]) and a[1:3] == b[1:3]
    for k in LEAVES:
        np.testing.assert_array_equal(a[3][k], b[3][k], err_msg=k)


def test_diff_compaction_auto_rule_and_equality(scenes, monkeypatch):
    """16x16 at 2 spp (512 lanes): "auto" in differentiable mode splits at
    2 into 128 lanes with roulette live and not without it (an RR-off env
    scene keeps too many lanes); with the split the radiance and the ray
    count are the uncompacted ones bit for bit and the gradients agree."""
    takes = []
    take = TI._State.take
    monkeypatch.setattr(TI._State, "take", lambda st, idx: takes.append(len(idx)) or take(st, idx))
    ts, tm = scenes[2:]
    size = (16, 16)
    auto = _all_grads(ts, tm, size, compact_depth="auto", compact_factor=4)
    assert takes == [128]
    none = _all_grads(ts, tm, size)
    assert takes == [128]
    _all_grads(ts, tm, size, compact_depth="auto", rr_start_depth=99)
    assert takes == [128]
    assert torch.equal(auto[0], none[0]) and auto[1] == none[1]
    for k in LEAVES:
        np.testing.assert_allclose(auto[3][k], none[3][k], rtol=2e-4, atol=1e-7, err_msg=k)


def test_env_grad_matches_fd(scenes, port):
    """A uniform brightness shift of the env image (h 0.02): the AD sum
    against central differences (the alias table and every sampling
    decision unchanged by the shift)."""
    ts, tm = scenes[2:]
    cam, sampler, cfg, px, py, sidx = _setup(ts)

    def loss(delta):
        img = ts.env_image + delta
        s = dataclasses.replace(ts, env_image=img, env_rows=env_rows_from_image(img, ts.env_rows[:, 12]))
        with torch.no_grad():
            return float(TI.render_wave(s, tm, cam, sampler, cfg, px, py, sidx)[0].mean())

    g_ad = float(port["trace_lut"][3]["env_image"].sum())
    g_fd = (loss(0.02) - loss(-0.02)) / 0.04
    assert g_ad > 0
    np.testing.assert_allclose(g_ad, g_fd, rtol=0.08)
