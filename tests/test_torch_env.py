"""The port's environment light against the JAX package's, lane by lane.

- `build_alias` (numpy on both sides) and `sample_alias_rows` are exact.
- `env_le_pdf`, `env_pdf` and `sample_light` (power and uniform light
  selection) agree at rtol 1e-5 on JAX-built scenes carried over with
  `from_numpy`: the `furnace` scene (uniform 8x8 map, no area light), a
  seeded non-uniform 16x16 map under a rotation with an area light, the
  same map cropped by portal bounds, and a uniform (non-sampleable) env.
  The octahedral map's abs/sign arithmetic and the alias draw are exact;
  the tolerance covers the normalisations, which XLA and torch round in
  another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_bintrace import _random_mesh
from yart_tpu.ops import distribution as JD
from yart_tpu.render import lights as JL
from yart_tpu.scene import procedural as JP
from yart_tpu.scene.builder import SceneBuilder
from yart_tpu_torch.ops import distribution as TD
from yart_tpu_torch.render import lights as TL
from yart_tpu_torch.scene.convert import from_numpy

torch.set_num_threads(2)
T = torch.from_numpy


def test_build_alias_exact():
    rng = np.random.default_rng(0)
    for w in (rng.lognormal(0, 1.5, 300), np.where(rng.random(64) < 0.3, 0.0, rng.random(64)),
              np.zeros(5), np.ones(1)):
        for a, b in zip(TD.build_alias(w), JD.build_alias(w)):
            np.testing.assert_array_equal(a, b)


def test_sample_alias_rows_exact():
    rng = np.random.default_rng(1)
    prob, alias, pdf = JD.build_alias(rng.lognormal(0, 1.0, 225))
    rows = np.stack([prob, alias.view(np.float32), pdf, pdf[alias]], axis=1).astype(np.float32)
    u = rng.random(8192, dtype=np.float32)
    u[:4] = (0.0, 0.5, TD.ONE_MINUS_EPS, 1.0 - 2.0 ** -20)
    for a, b in zip(TD.sample_alias_rows(T(rows), T(u)), JD.sample_alias_rows(jnp.asarray(rows), jnp.asarray(u))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _scene(kind):
    if kind == "furnace":
        b = JP.furnace(env_value=0.5)
    else:
        rng = np.random.default_rng(3)
        pos, tri = _random_mesh(rng, 40)
        b = SceneBuilder()
        b.add_mesh(pos, tri, b.add_material(roughness=0.5))
        light = b.add_material(emission=(4.0, 3.0, 2.0), emission_strength=1.0)
        b.add_mesh(np.asarray([[-1, 5, -1], [1, 5, -1], [0, 5, 1]], np.float32), [[0, 1, 2]], light)
        img = rng.lognormal(0.0, 1.0, (16, 16, 3)).astype(np.float32)
        a = 0.6
        rot = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        if kind == "rotated":
            b.set_env(img, 1.5, rotation=rot)
        elif kind == "portal":
            b.set_env(img, 1.5, rotation=rot, bounds=(0.1, 0.2, 0.8, 0.9))
        else:
            b.set_env_uniform((0.3, 0.5, 0.7))
    js, jm = b.compile()
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    return js, jm, ts, tm


@pytest.fixture(scope="module", params=["furnace", "rotated", "portal", "uniform"])
def env_case(request):
    return (request.param,) + _scene(request.param)


def _close(a, b, msg):
    a, b = a.numpy(), np.asarray(b)
    if a.dtype == bool:
        np.testing.assert_array_equal(a, b, err_msg=msg)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=msg)


def test_env_le_pdf(env_case):
    kind, js, jm, ts, tm = env_case
    assert tm.has_env and tm.env_portal == (kind == "portal") and tm.env_sampleable == (kind != "uniform")
    rng = np.random.default_rng(2)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:6] = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)  # the map's poles and seams
    le, pdf = TL.env_le_pdf(ts, T(d), tm)
    jle, jpdf = JL.env_le_pdf(js, jnp.asarray(d), jm)
    _close(le, jle, "le")
    _close(pdf, jpdf, "pdf")
    _close(TL.env_pdf(ts, T(d), tm), JL.env_pdf(js, jnp.asarray(d), jm), "env_pdf")
    assert (le.numpy() > 0).any()
    if kind == "portal":
        assert (le.numpy() == 0).all(axis=1).any() and (pdf.numpy() == 0).any()


@pytest.mark.parametrize("light_sampler", ["power", "uniform"])
def test_sample_light(env_case, light_sampler):
    kind, js, jm, ts, tm = env_case
    rng = np.random.default_rng(4)
    n = 4096
    p = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    uc = rng.random(n, dtype=np.float32)
    u = rng.random((n, 2), dtype=np.float32)
    tl = TL.sample_light(ts, tm, T(p), T(uc), T(u), kind=light_sampler)
    jl = JL.sample_light(js, jm, jnp.asarray(p), jnp.asarray(uc), jnp.asarray(u), kind=light_sampler)
    for f in jl._fields:
        _close(getattr(tl, f), getattr(jl, f), f)
    is_env = tl.is_env.numpy()
    assert is_env.any()
    assert tl.valid.numpy()[is_env].all() == (kind != "uniform")
    assert TL.p_infinite(tm) == JL.p_infinite(jm)
