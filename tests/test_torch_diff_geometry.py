"""Vertex-position gradients of the port (`render/diff.py`
`geometry_grads`, `cfg.diff_geometry`: `integrator._refit_hit` re-solves
each hit against `scene.positions`) against the JAX package on
tests/test_diff.py's plane-and-lamp scene, and the pieces they rest on:
the builder's `positions` / `tri_v`, bit-equal to the JAX builder's, and
the traversal wrappers (B1, B2, B3), which refuse inputs that require
grad.

One JAX `value_and_grad` (its `geometry_grads`) serves the module.
Tolerances: the loss within rtol 1e-5, the gradient within rtol 1e-3 plus
1e-4 of its largest entry (the in-plane entries are float noise, ~1e-11,
in both packages); the finite-difference check at tests/test_diff.py's
step and bar (h 0.02, rtol 0.08); the refit's forward within
tests/test_diff.py's atol 2e-3 of the traversal's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_native_lib import numpy_twins
from yart_tpu.config import CameraConfig as JCam
from yart_tpu.config import RenderConfig as JCfg
from yart_tpu.ops.qmc import make_sampler as j_make_sampler
from yart_tpu.render.camera import build_camera as j_build_camera
from yart_tpu.render.diff import geometry_grads as j_geometry_grads
from yart_tpu.scene.builder import SceneBuilder as JBuilder
from yart_tpu.scene.procedural import cornell_box as j_cornell
from yart_tpu.scene.procedural import textured_box_scene as j_textured
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.kernels import brute, fusedtrace, presort
from yart_tpu_torch.ops.qmc import make_sampler
from yart_tpu_torch.render import blocktrace
from yart_tpu_torch.render import diff as TD
from yart_tpu_torch.render.camera import build_camera
from yart_tpu_torch.render.integrator import render_wave
from yart_tpu_torch.scene.builder import SceneBuilder
from yart_tpu_torch.scene.convert import from_numpy
from yart_tpu_torch.scene.procedural import cornell_box, textured_box_scene

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


def plane_light_scene(builder, dz: float = 0.0):
    """tests/test_diff.py `_plane_light_scene`: a 100 x 100 diffuse receiver
    at z = dz lit by a small area light at z = 3, behind the camera; every
    camera ray hits the receiver's interior and no shadow ray is occluded."""
    b = builder()
    white = b.add_material(base_color=(0.7, 0.7, 0.7, 1.0), roughness=1.0)
    light = b.add_material(base_color=(0.0, 0.0, 0.0, 1.0), roughness=1.0, emission=(1.0, 1.0, 1.0),
                           emission_strength=20.0)
    s = 50.0
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    b.add_mesh(np.asarray([[-s, -s, dz], [s, -s, dz], [s, s, dz], [-s, s, dz]], np.float32), idx, white)
    b.add_mesh(np.asarray([[-0.5, -0.5, 3], [-0.5, 0.5, 3], [0.5, 0.5, 3], [0.5, -0.5, 3]], np.float32),
               idx, light)
    return b


@pytest.fixture(scope="module")
def scenes():
    js, jm = plane_light_scene(JBuilder).compile()
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
    js, jm, _, _ = scenes
    cfg = JCfg(**CFG)
    cam, sampler = j_build_camera(JCam(**CAM)), j_make_sampler(cfg.sampler, SPP, SIZE, 0)
    val, g = jax_fast(lambda s, px, py, sidx: j_geometry_grads(s, jm, cam, sampler, cfg, px, py, sidx,
                                                               loss_fn=jnp.mean),
                      js, *(jnp.asarray(a) for a in _lanes(SIZE, SPP)))
    return float(val), np.asarray(g)


def _setup(ts, cam=CAM, size=SIZE, spp=SPP, **cfg):
    cfg = RenderConfig(**dict(CFG, samples=spp, **cfg))
    px, py, sidx = (torch.from_numpy(a.astype(np.int64)) for a in _lanes(size, spp))
    return (build_camera(CameraConfig(**dict(cam, image_size=size)), "cpu"),
            make_sampler(cfg.sampler, spp, size, 0, device="cpu"), cfg, px, py, sidx)


@pytest.fixture(scope="module")
def port_grads(scenes):
    _, _, ts, tm = scenes
    cam, sampler, cfg, px, py, sidx = _setup(ts)
    val, g = TD.geometry_grads(ts, tm, cam, sampler, cfg, px, py, sidx, loss_fn=torch.mean)
    return float(val), g.numpy()


def test_geometry_grads_match_jax(jax_ref, port_grads, scenes):
    val, g = port_grads
    j_val, j_g = jax_ref
    np.testing.assert_allclose(val, j_val, rtol=1e-5)
    assert g.shape == tuple(scenes[2].positions.shape) and np.isfinite(g).all()
    assert np.all(g[0:4, 2] > 0)  # the receiver closer to the lamp: brighter
    np.testing.assert_allclose(g, j_g, rtol=1e-3, atol=1e-4 * np.abs(j_g).max())


def test_geometry_grad_matches_fd(scenes, port_grads):
    """d(mean)/d(receiver z): the AD sum over the receiver's vertices
    against central differences of renders of the scene rebuilt with the
    receiver moved (traversal and refit move together; moving
    `positions` alone would put refit points below the detached traversal
    plane, which then shadows them)."""
    _, _, ts, tm = scenes
    cam, sampler, cfg, px, py, sidx = _setup(ts, diff_geometry=True)

    def loss(dz):
        s, m = plane_light_scene(SceneBuilder, dz).compile("cpu")
        with torch.no_grad():
            rad, _ = render_wave(s, m, cam, sampler, cfg, px, py, sidx, differentiable=True)
        return float(rad.mean())

    g_ad = float(port_grads[1][0:4, 2].sum())
    g_fd = (loss(0.02) - loss(-0.02)) / 0.04
    assert g_ad > 0
    np.testing.assert_allclose(g_ad, g_fd, rtol=0.08)


def test_diff_geometry_forward_close_to_plain():
    """On cornell-mat (metal, glass) the refit re-derives t, u, v from the
    raw vertices: the radiance stays within tests/test_diff.py's atol of
    the traversal's, and the vertex gradients through glass and metal are
    finite (tests/test_diff.py `test_geometry_grads_glass_scene_finite`)."""
    ts, tm = cornell_box(extra_materials=True).compile("cpu")
    cam = dict(focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
    cam, sampler, cfg, px, py, sidx = _setup(ts, cam=cam, spp=2, max_depth=4)
    plain, _ = render_wave(ts, tm, cam, sampler, cfg, px, py, sidx)
    refit, _ = render_wave(ts, tm, cam, sampler, dataclasses.replace(cfg, diff_geometry=True), px, py, sidx,
                           differentiable=True)
    np.testing.assert_allclose(refit.numpy(), plain.numpy(), atol=2e-3)
    val, g = TD.geometry_grads(ts, tm, cam, sampler, cfg, px, py, sidx, loss_fn=torch.mean)
    assert np.isfinite(float(val)) and torch.isfinite(g).all() and g.abs().sum() > 0


@pytest.mark.parametrize("name", ["plane", "cornell-mat", "textured"])
def test_builder_positions_and_tri_v_equal_jax(name, monkeypatch):
    """The builder's vertex table and leaf-ordered triangle ids, bit-equal
    to the JAX builder's, both on their numpy BVH build (what `_refit_hit`
    gathers; the native builds' trees differ from it,
    tests/test_torch_clusters.py)."""
    numpy_twins(monkeypatch, collapse=False)
    jb, tb = {"plane": (plane_light_scene(JBuilder), plane_light_scene(SceneBuilder)),
              "cornell-mat": (j_cornell(extra_materials=True), cornell_box(extra_materials=True)),
              "textured": (j_textured(), textured_box_scene())}[name]
    js, _ = jb.compile()
    ts, _ = tb.compile("cpu")
    for f in ("positions", "tri_v"):
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    # tri_pack's vertex columns are positions[tri_v] in the same order.
    v = ts.positions[ts.tri_v.long()].reshape(-1, 9)
    assert torch.equal(v, ts.tri_pack[:, :9])


def test_traversal_wrappers_refuse_grad():
    """B1, B2 and B3 read raw pointers and have no backward: each wrapper
    raises when grad mode is on and an input requires grad (as a Pallas
    call without a VJP fails under jax.grad), and runs under no_grad."""
    ts, tm = cornell_box().compile("cpu")
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)) + torch.tensor([0.0, 1.0, 3.0])
    d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32)), dim=-1)
    t_max = torch.full((300,), 1e30)
    dg = d.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        brute.brute_intersect(ts.tri_pack, o, dg, t_max, tm.n_tris, 1e-3)
    with pytest.raises(RuntimeError, match="requires grad"):
        brute.brute_intersect(ts.tri_pack.clone().requires_grad_(True), o, d, t_max, tm.n_tris, 1e-3)
    with pytest.raises(RuntimeError, match="requires grad"):
        blocktrace.intersect_blocktrace(ts, tm, o, dg, t_max)  # B2 on rays built from dg
    rays = blocktrace.ray_matrix(o, d, t_max, None)
    pk = presort.presort_keys(rays, ts.clus_box, blocktrace.n_clus(tm), 1e-3)
    order, blive = blocktrace.schedule(pk)
    args = (rays[order], pk[order, 1:5].contiguous(), ts.clus_box, ts.clus_pack,
            blocktrace.cluster_counts(ts, tm), blive, 1e-3)
    with pytest.raises(RuntimeError, match="requires grad"):
        fusedtrace.fused_trace(args[0].clone().requires_grad_(True), *args[1:])
    with torch.no_grad():
        hit = brute.brute_intersect(ts.tri_pack, o, dg, t_max, tm.n_tris, 1e-3)
        out = fusedtrace.fused_trace(args[0].clone().requires_grad_(True), *args[1:])
    ref = brute.brute_intersect(ts.tri_pack, o, d, t_max, tm.n_tris, 1e-3)
    assert all(torch.equal(a, b) for a, b in zip(hit, ref))
    assert torch.equal(out.view(torch.int32), fusedtrace.fused_trace(*args).view(torch.int32))
