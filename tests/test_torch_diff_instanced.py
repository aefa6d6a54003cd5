"""Vertex gradients of an instanced scene (`render/diff.py`
`geometry_grads` on `proto_pos`): `integrator._refit_hit` maps each hit
through `tri_aux` to its prototype's object-space vertices and the
instance's forward 3x4, so the gradient reaches the shared prototype,
summed over its instances. tests/test_diff.py's scene: two instances of
one receiver quad side by side, lit by a lamp instance; B3's instanced
mode (its twin here) finds the hits. Against the JAX package, the sum
rule and central differences of rebuilt scenes.

One JAX `value_and_grad` (its `geometry_grads`, jitted with XLA:CPU's
backend optimisation off) serves the module. Tolerances: the loss within
rtol 1e-5, the gradient within rtol 1e-3 plus 1e-4 of its largest entry;
the AD of a shift against the gradient's sum within rtol 1e-4 (as the JAX
test); finite differences at rtol 0.08."""

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
from yart_tpu.render.diff import geometry_grads as j_geometry_grads
from yart_tpu.scene.builder import SceneBuilder as JBuilder
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.kernels import brute, fusedtrace
from yart_tpu_torch.ops.qmc import make_sampler
from yart_tpu_torch.render import diff as TD
from yart_tpu_torch.render.camera import build_camera
from yart_tpu_torch.render.integrator import render_wave
from yart_tpu_torch.scene.builder import SceneBuilder
from yart_tpu_torch.scene.convert import from_numpy

SIZE = (8, 8)
SPP = 4
CAM = dict(image_size=SIZE, focal_length=35.0, position=(0, 0, 2.0), forward=(0, 0, -1))
CFG = dict(samples=SPP, max_depth=3, rr_start_depth=99)


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


def instanced_scene(builder, dz: float = 0.0):
    """Two instances of a 50 x 50 receiver prototype at z = dz and one
    lamp instance at z = 3 (tests/test_diff.py `test_geometry_grads_instanced`)."""
    b = builder()
    white = b.add_material(base_color=(0.7, 0.7, 0.7, 1.0), roughness=1.0)
    light = b.add_material(base_color=(0.0, 0.0, 0.0, 1.0), roughness=1.0, emission=(1.0, 1.0, 1.0),
                           emission_strength=20.0)
    s = 25.0
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    p_recv = b.add_prototype(np.asarray([[-s, -s, dz], [s, -s, dz], [s, s, dz], [-s, s, dz]], np.float32),
                             idx, white)
    for x in (-s, s):
        t = np.eye(4)
        t[0, 3] = x
        b.add_instance(p_recv, t)
    lamp = np.asarray([[-0.5, -0.5, 3], [-0.5, 0.5, 3], [0.5, 0.5, 3], [0.5, -0.5, 3]], np.float32)
    b.add_instance(b.add_prototype(lamp, idx, light))
    return b


@pytest.fixture(scope="module")
def scenes():
    js, jm = instanced_scene(JBuilder).compile()
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    assert tm.n_instances == 3
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
    val, g = jax_fast(lambda s, px, py, sidx: j_geometry_grads(s, jm, cam, sampler, cfg, px, py, sidx,
                                                               loss_fn=jnp.mean),
                      js, *(jnp.asarray(a) for a in _lanes(SIZE, SPP)))
    return float(val), np.asarray(g)


def _setup(**cfg):
    cfg = RenderConfig(**dict(CFG, **cfg))
    px, py, sidx = (torch.from_numpy(a.astype(np.int64)) for a in _lanes(SIZE, SPP))
    return (build_camera(CameraConfig(**CAM), "cpu"), make_sampler(cfg.sampler, SPP, SIZE, 0, device="cpu"),
            cfg, px, py, sidx)


@pytest.fixture(scope="module")
def port(scenes):
    ts, tm = scenes[2:]
    val, g = TD.geometry_grads(ts, tm, *_setup(), loss_fn=torch.mean)
    return float(val), g.numpy()


def test_instanced_geometry_grads_match_jax(scenes, jax_ref, port):
    val, g = port
    j_val, j_g = jax_ref
    np.testing.assert_allclose(val, j_val, rtol=1e-5)
    assert g.shape == tuple(scenes[2].proto_pos.shape) and np.isfinite(g).all()
    assert np.all(g[0:4, 2] > 0)  # the receiver prototype's vertices, toward the lamp
    np.testing.assert_allclose(g, j_g, rtol=1e-3, atol=1e-4 * np.abs(j_g).max())


def test_casts_take_b3_instanced_mode(scenes, monkeypatch):
    """Every cast of the differentiable render goes to B3 in its instanced
    mode (closest and nee), with detached rays and no B1 call."""
    calls = []
    ft, br = fusedtrace.fused_trace, brute.brute_intersect

    def spy(rays, slots, box, pack, count, blive, t_min, nee=False, amask=False, inst=None):
        calls.append((nee, inst is not None, rays.requires_grad))
        return ft(rays, slots, box, pack, count, blive, t_min, nee, amask, inst)

    monkeypatch.setattr(fusedtrace, "fused_trace", spy)
    monkeypatch.setattr(brute, "brute_intersect", lambda *a, **k: calls.append("b1") or br(*a, **k))
    ts, tm = scenes[2:]
    TD.geometry_grads(ts, tm, *_setup(), loss_fn=torch.mean)
    assert calls and "b1" not in calls
    assert {c[1] for c in calls} == {True} and {c[2] for c in calls} == {False}
    assert {c[0] for c in calls} == {False, True}


def test_shift_ad_equals_gradient_sum(scenes, port):
    """AD of a z shift of the receiver prototype equals the sum of its
    per-vertex gradients (both instances accumulate into it)."""
    ts, tm = scenes[2:]
    cam, sampler, cfg, px, py, sidx = _setup(diff_geometry=True)
    dz = torch.zeros((), requires_grad=True)
    pp = ts.proto_pos.clone()
    pp = torch.cat([pp[0:4] + torch.stack([torch.zeros(()), torch.zeros(()), dz]), pp[4:]])
    rad, _ = render_wave(dataclasses.replace(ts, proto_pos=pp), tm, cam, sampler, cfg, px, py, sidx,
                         differentiable=True)
    (g_dz,) = torch.autograd.grad(rad.mean(), dz)
    np.testing.assert_allclose(float(g_dz), float(port[1][0:4, 2].sum()), rtol=1e-4)


def test_instanced_geometry_grad_matches_fd(scenes, port):
    """Central differences of renders of the scene rebuilt with the
    receiver prototype moved (traversal and refit move together)."""
    cam, sampler, cfg, px, py, sidx = _setup(diff_geometry=True)

    def loss(dz):
        s, m = instanced_scene(SceneBuilder, dz).compile("cpu")
        with torch.no_grad():
            return float(render_wave(s, m, cam, sampler, cfg, px, py, sidx, differentiable=True)[0].mean())

    g_ad = float(port[1][0:4, 2].sum())
    np.testing.assert_allclose(g_ad, (loss(0.02) - loss(-0.02)) / 0.04, rtol=0.08)
