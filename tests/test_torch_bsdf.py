"""yart_tpu_torch.render.bsdf against yart_tpu.render.bsdf, lane by lane,
for cornell-mat's six materials and for random parametric materials with
every lobe on (metallic, dielectric thin/solid, clearcoat, anisotropy).

Tolerances: sampled flags and roughness are exact. Floats agree to ~1e-6
relative on almost every lane; the exceptions are ill-conditioned lanes —
sharp GGX lobes (alpha ~ 0.0025) whose NDF turns an ulp of direction into
1e-4..1e-1 of f and pdf, refraction next to total internal reflection,
and VNDF samples at the disk edge — where XLA's and torch's sin/cos/rsqrt
last-ulp differences are amplified. So sampled f/pdf/wi must agree within
rtol 1e-3 on at least 99.5% of lanes, and f/pdf evaluation within
rtol 1e-3 / atol 1e-6 on every lane.

The port's side runs on one intra-op thread. With two, PyTorch's CPU
unary math (sqrt and the other vectorized float functions) splits an
8192-lane op at its 2048-element grain, and lanes >= 4096 are computed
on the intra-op worker thread. In 6 of 111 runs of test_bsdf_sample
(solo and under `-n 6 --dist loadfile`, with the machine loaded) that
worker's results differed: every JAX output and every torch input was
bit-equal to the passing runs', the torch outputs' lanes < 4096 too,
but lanes >= 4096 took one fixed other value from the first sqrt on
(sqrt of an all-1.0 tensor was not 1.0 there), and 98.7% of lanes were
close, all misses >= 4096. On one thread: 0 failures in 50 runs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yart_tpu.ops import lut as JL
from yart_tpu.render import bsdf as JB
from yart_tpu.scene.builder import SceneBuilder
from yart_tpu.scene.procedural import cornell_box
from yart_tpu_torch.ops import lut as TL
from yart_tpu_torch.render import bsdf as TB
from yart_tpu_torch.scene.convert import from_numpy

N = 8192
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """This module's tests run the port on one intra-op thread, set when
    they start (every test module sets its own at import, so under xdist
    the last import would win). See the module docstring."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _random_materials_scene(rng, n_mat=24):
    b = SceneBuilder()
    for _ in range(n_mat):
        b.add_material(
            base_color=tuple(rng.uniform(0, 1, 3)) + (1.0,),
            metallic=float(rng.choice([0.0, 1.0, rng.uniform()])),
            roughness=float(rng.choice([0.0, 0.02, rng.uniform(0.05, 1.0)])),
            transmission=float(rng.choice([0.0, 1.0, rng.uniform()])),
            ior=float(rng.uniform(1.1, 2.0)),
            anisotropic=float(rng.choice([0.0, rng.uniform(-0.5, 0.9)])),
            aniso_rotation=float(rng.uniform(0, 3)),
            clearcoat=float(rng.choice([0.0, rng.uniform()])),
            cc_roughness=float(rng.uniform(0.0, 0.6)),
            emission=tuple(rng.choice([0.0, 1.0]) * rng.uniform(0, 2, 3)),
            thin=bool(rng.integers(0, 2)),
            volume_color=tuple(rng.uniform(0.2, 1, 3)),
            volume_density=float(rng.uniform(0, 2)),
        )
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    b.add_mesh(verts, np.asarray([[0, 1, 2]]), 0)
    return b.compile()  # the JAX builder


@pytest.fixture(scope="module", params=["cornell_mat", "random_materials"])
def case(request):
    rng = np.random.default_rng(11)
    if request.param == "cornell_mat":
        js, jm = cornell_box(extra_materials=True).compile()
    else:
        js, jm = _random_materials_scene(rng)
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")

    def unit():
        w = rng.normal(size=(N, 3)).astype(np.float32)
        return w / np.linalg.norm(w, axis=-1, keepdims=True)

    inp = dict(
        mi=rng.integers(0, jm.n_materials, N).astype(np.int32),
        wo=unit(), wi=unit(),
        u=rng.random((N, 2), dtype=np.float32),
        uc=rng.random(N, dtype=np.float32),
        uc2=rng.random(N, dtype=np.float32),
        reg=rng.random(N) < 0.3,
    )
    jmat = JB.resolve_material(js, jm, jnp.asarray(inp["mi"]), jnp.zeros((N, 2), jnp.float32))
    tmat = TB.resolve_material(ts, tm, T(inp["mi"]))
    return js, jm, ts, tm, jmat, tmat, inp


def test_resolve_material_exact(case):
    _, _, _, _, jmat, tmat, _ = case
    for f in JB.LaneMaterial._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jmat, f)), getattr(tmat, f).numpy(), err_msg=f)


def _mostly_close(j, t, frac=0.995, rtol=1e-3, atol=1e-5):
    j, t = np.asarray(j), np.asarray(t)
    ok = np.isclose(t, j, rtol=rtol, atol=atol)
    ok = ok.reshape(ok.shape[0], -1).all(axis=1)
    assert ok.mean() >= frac, (ok.mean(), np.flatnonzero(~ok)[:10])


def test_bsdf_sample(case):
    _, jm, _, tm, jmat, tmat, x = case
    jt, tt = JL.load_tables(), TL.load_tables("cpu")
    js = jax.jit(lambda m, *a: JB.bsdf_sample(jt, m, *a, meta=jm))(
        jmat, x["wo"], x["u"], x["uc"], x["uc2"], x["reg"]
    )
    ts = TB.bsdf_sample(tt, tmat, T(x["wo"]), T(x["u"]), T(x["uc"]), T(x["uc2"]), T(x["reg"]), meta=tm)
    np.testing.assert_array_equal(np.asarray(js.flags), ts.flags.numpy())
    np.testing.assert_array_equal(np.asarray(js.roughness), ts.roughness.numpy())
    np.testing.assert_allclose(ts.Le.numpy(), np.asarray(js.Le), rtol=1e-6)
    for f in ("f", "wi", "pdf"):
        _mostly_close(getattr(js, f), getattr(ts, f).numpy())


def test_bsdf_f_and_pdf(case):
    _, jm, _, tm, jmat, tmat, x = case
    jt, tt = JL.load_tables(), TL.load_tables("cpu")
    jf, jp = jax.jit(lambda m, wo, wi: (JB.bsdf_f(jt, m, wo, wi, meta=jm), JB.bsdf_pdf(jt, m, wo, wi, meta=jm)))(
        jmat, x["wo"], x["wi"]
    )
    tf = TB.bsdf_f(tt, tmat, T(x["wo"]), T(x["wi"]), meta=tm)
    tp = TB.bsdf_pdf(tt, tmat, T(x["wo"]), T(x["wi"]), meta=tm)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-3, atol=1e-6)


def test_volume_attenuation(case):
    _, _, _, _, jmat, tmat, _ = case
    d = np.random.default_rng(2).uniform(0, 3, N).astype(np.float32)
    np.testing.assert_allclose(
        TB.volume_attenuation(tmat, T(d)).numpy(), np.asarray(JB.volume_attenuation(jmat, d)), rtol=1e-5
    )


def test_textured_materials_refused():
    """Textured materials are resolved at the hit uv
    (tests/test_torch_textures.py); without a uv they are refused."""
    _, tm = from_numpy(
        jax.tree_util.tree_map(np.asarray, cornell_box().compile()[0]),
        dict(n_tris=12, n_materials=4, n_lights=2, any_textures=True),
        device="cpu",
    )
    with pytest.raises(ValueError, match="uv"):
        TB.resolve_material(None, tm, torch.zeros(1, dtype=torch.int32))
