"""Texture-content gradients of the port (`render/diff.py`
`texture_grads`: the quad rows rebuilt from the atlas inside the loss)
against the JAX package on the textured box (checker albedo, roughness
map, normal map, an alpha-cutout panel, a thin-glass panel): the alpha
gates read the same rgba atlas that receives the gradient, and the
traversal's alpha decisions stay detached. Through the default traversal
(the gated brute) and through the gated block trace (B2 + B3 `amask`, the
re-cast loop; their twins here), as tests/test_diff.py's
`test_texture_grad_through_gated_alpha_traversal` forces it in the JAX
package. Also the remat policies (texture gathers replayed under
"trace_lut"), the other atlas kinds and central finite differences.

One JAX `value_and_grad` (its `texture_grads`, jitted with XLA:CPU's
backend optimisation off) serves the module. Tolerances: the loss within
rtol 1e-5, the gradient within rtol 1e-3 plus 1e-4 of its largest entry;
the policies bitwise; finite differences at tests/test_diff.py's rtol
0.08 (h 0.02 on the colour channels only, so no alpha decision moves)."""

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
from yart_tpu.render.diff import texture_grads as j_texture_grads
from yart_tpu.scene.procedural import textured_box_scene as j_textured
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.ops.qmc import make_sampler
from yart_tpu_torch.render import blocktrace
from yart_tpu_torch.render import diff as TD
from yart_tpu_torch.render import integrator as TI
from yart_tpu_torch.render.camera import build_camera
from yart_tpu_torch.render.texture import qrows_from_data
from yart_tpu_torch.scene.convert import from_numpy

SIZE = (8, 8)
SPP = 2
CAM = dict(image_size=SIZE, focal_length=26.0, position=(0.0, 1.2, 4.0), forward=(0, -0.15, -1))
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


@pytest.fixture(scope="module")
def scenes():
    js, jm = j_textured().compile()
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    assert tm.any_alpha and tm.any_transparent
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
    val, g = jax_fast(lambda s, px, py, sidx: j_texture_grads(s, jm, cam, sampler, cfg, px, py, sidx,
                                                              loss_fn=jnp.mean, kind="rgba"),
                      js, *(jnp.asarray(a) for a in _lanes(SIZE, SPP)))
    return float(val), np.asarray(g)


def _setup(**cfg):
    cfg = RenderConfig(**dict(CFG, **cfg))
    px, py, sidx = (torch.from_numpy(a.astype(np.int64)) for a in _lanes(SIZE, SPP))
    return (build_camera(CameraConfig(**CAM), "cpu"), make_sampler(cfg.sampler, SPP, SIZE, 0, device="cpu"),
            cfg, px, py, sidx)


def _grads(scenes, kind="rgba", **cfg):
    ts, tm = scenes[2:]
    val, g = TD.texture_grads(ts, tm, *_setup(**cfg), loss_fn=torch.mean, kind=kind)
    return float(val), g.numpy()


def _gated_blocktrace(scene, meta, o, d, t_max, t_min=1e-3, nee=False, alpha_seed=None):
    return blocktrace.intersect_blocktrace_gated(scene, meta, o, d, t_max, t_min, nee, alpha_seed)


@pytest.fixture(scope="module")
def port(scenes):
    out = {remat: _grads(scenes, remat=remat) for remat in ("trace_lut", "trace", "all")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TI, "intersect", _gated_blocktrace)
        out["blocktrace"] = _grads(scenes)
    return out


@pytest.mark.parametrize("path", ["trace_lut", "blocktrace"])
def test_texture_grads_match_jax(scenes, jax_ref, port, path):
    val, g = port[path]
    j_val, j_g = jax_ref
    np.testing.assert_allclose(val, j_val, rtol=1e-5)
    assert g.shape == tuple(scenes[2].tex_rgba.data.shape) and np.isfinite(g).all()
    assert g[..., :3].sum() > 0  # brighter albedo, brighter image
    np.testing.assert_allclose(g, j_g, rtol=1e-3, atol=1e-4 * np.abs(j_g).max())


@pytest.mark.parametrize("remat", ["trace", "all"])
def test_remat_policies_bitwise(port, remat):
    """"trace_lut" replays the bounce's texture and LUT gathers in its
    recomputation, "trace" runs them again, "all" keeps everything."""
    assert port[remat][0] == port["trace_lut"][0]
    np.testing.assert_array_equal(port[remat][1], port["trace_lut"][1])


@pytest.mark.parametrize("kind", ["2ch", "rgb"])
def test_other_atlas_kinds(scenes, kind):
    """The roughness map and the normal map take gradients too."""
    val, g = _grads(scenes, kind=kind)
    assert g.shape == tuple(getattr(scenes[2], TD.TEXTURE_FIELDS[kind]).data.shape)
    assert np.isfinite(g).all() and np.abs(g).sum() > 0


def test_texture_grad_matches_fd(scenes, port):
    ts, tm = scenes[2:]
    cam, sampler, cfg, px, py, sidx = _setup()

    def loss(delta):
        data = ts.tex_rgba.data.clone()
        data[..., :3] += delta
        s = dataclasses.replace(ts, tex_rgba=ts.tex_rgba._replace(data=data, qrows=qrows_from_data(data)))
        with torch.no_grad():
            return float(TI.render_wave(s, tm, cam, sampler, cfg, px, py, sidx)[0].mean())

    g_ad = float(port["trace_lut"][1][..., :3].sum())
    g_fd = (loss(0.02) - loss(-0.02)) / 0.04
    assert g_ad > 0
    np.testing.assert_allclose(g_ad, g_fd, rtol=0.08)
