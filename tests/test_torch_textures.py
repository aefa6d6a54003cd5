"""The port's textures, textured scene tables, textured shading and alpha
seeds against the JAX package, on the CPU.

- `sample_stack` for every channel class (rgba, rgb, 2ch, mono) over
  shelf-packed atlases: uv below 0, above 1 and exactly on texel and period
  boundaries, lanes with idx = -1, and an empty stack; within 1e-6 (the
  bilinear weights are rounded in another order where XLA fuses them).
- `SceneBuilder.compile` of `textured_box_scene()` and of
  `atrium(ivy=True, tex_res=64)` against the JAX builder, both on their
  numpy BVH paths, bit for bit: the atlases, rect tables and quad rows of all four stacks, the
  triangle and shading rows (uvs, tangents), and `clus_pack` with the
  alpha-mask words of row 5. The atrium's sky HDRI is the one exception:
  the JAX package normalises its directions with XLA's rsqrt, which is not
  correctly rounded on the CPU, the port with torch's correctly rounded
  one, so the sky image, its env rows and its cell pdfs agree to rtol
  1e-5 (the alias pairing itself may differ).
- `resolve_material` and the normal-mapped `shading_data` at seeded hits
  on both scenes within rtol 1e-5.
- `lane_seed` of both samplers and the alpha hash draw, bit-exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_native_lib import numpy_twins
from yart_tpu.ops import qmc as JQ
from yart_tpu.render import bsdf as JB
from yart_tpu.render import integrator as JI
from yart_tpu.render.intersect import Hit as JHit
from yart_tpu.render.texture import sample_stack as j_sample
from yart_tpu.scene import builder as JBld
from yart_tpu.scene import procedural as JP
from yart_tpu.scene import showcase as JS
from yart_tpu_torch.ops import qmc as TQ
from yart_tpu_torch.render import bsdf as TB
from yart_tpu_torch.render import integrator as TI
from yart_tpu_torch.render.intersect import Hit as THit
from yart_tpu_torch.render.texture import sample_stack as t_sample
from yart_tpu_torch.scene import builder as TBld
from yart_tpu_torch.scene import procedural as TP
from yart_tpu_torch.scene import showcase as TS
from yart_tpu_torch.scene.types import CompiledScene, TextureStack

torch.set_num_threads(2)
T = torch.from_numpy
SKY_FIELDS = ("env_image", "env_alias", "env_rows")


def _textures(rng, c):
    sizes = [(16, 16), (8, 32), (33, 5), (2, 2), (64, 48)]
    return [rng.random((h, w, c), dtype=np.float32) for h, w in sizes]


def _uvs(rng, n):
    uv = rng.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    edges = np.asarray([0.0, 1.0, -1.0, 2.0, 0.5, 0.25, 1.0 - 2.0 ** -24, -0.0, 1.0 / 15.0], np.float32)
    k = edges.size
    uv[:k, 0] = edges
    uv[k : 2 * k, 1] = edges
    uv[2 * k : 3 * k] = edges[:, None]
    return uv


@pytest.mark.parametrize("c", [4, 3, 2, 1])
def test_sample_stack_equals_jax(c):
    rng = np.random.default_rng(c)
    texs = _textures(rng, c)
    ts, js = TBld._stack_from_list(texs, c), JBld._stack_from_list(texs, c)
    for g in TextureStack._fields:
        np.testing.assert_array_equal(getattr(ts, g).numpy(), np.asarray(getattr(js, g)), err_msg=g)
    n = 4096
    uv = _uvs(rng, n)
    idx = rng.integers(-1, len(texs), n).astype(np.int32)
    got = t_sample(ts, T(idx), T(uv)).numpy()
    want = np.asarray(j_sample(js, jnp.asarray(idx), jnp.asarray(uv)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[idx < 0] == 0).all() and (got[idx >= 0] != 0).any()
    empty = TBld._stack_from_list([], c)
    assert (t_sample(empty, T(idx), T(uv)).numpy() == 0).all()


def _bits_equal(a, b, msg):
    a, b = np.atleast_1d(a), np.atleast_1d(np.asarray(b))
    assert a.shape == b.shape, msg
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=msg)


@pytest.fixture(scope="module", params=["textured_box", "atrium_ivy"])
def scenes(request):
    """(JAX scene as numpy leaves, JAX meta, port scene, port meta), both
    built by their own builders, both on their numpy BVH paths."""
    if request.param == "textured_box":
        jb, tb = JP.textured_box_scene(), TP.textured_box_scene()
    else:
        jb, tb = JS.atrium(ivy=True, tex_res=64), TS.atrium(ivy=True, tex_res=64)
    with pytest.MonkeyPatch.context() as mp:
        numpy_twins(mp)
        js, jm = jb.compile()
        ts, tm = tb.compile(device="cpu")
    return request.param, jax.tree_util.tree_map(np.asarray, js), jm, ts, tm


def test_builder_tables_equal_jax(scenes):
    name, js, jm, ts, tm = scenes
    for f in ("n_tris", "n_materials", "n_lights", "n_clusters", "n_clus_pad", "has_env",
              "any_alpha", "any_transparent", "any_textures", "any_metallic", "any_transmissive",
              "any_clearcoat", "any_anisotropy"):
        assert getattr(tm, f) == getattr(jm, f), f
    for f in dataclasses.fields(CompiledScene):
        a, b = getattr(ts, f.name), getattr(js, f.name)
        if f.name == "materials":
            for g in a._fields:
                _bits_equal(getattr(a, g).numpy(), getattr(b, g), g)
        elif isinstance(a, TextureStack):
            for g in TextureStack._fields:
                _bits_equal(getattr(a, g).numpy(), getattr(b, g), f"{f.name}.{g}")
        elif name == "atrium_ivy" and f.name in SKY_FIELDS:
            # The alias table's (prob, alias) pairing follows the order of
            # its inputs, so only each cell's own pdf (column 2) compares.
            x, y = a.numpy(), np.asarray(b)
            if f.name == "env_alias":
                x, y = x[:, 2], y[:, 2]
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-7, err_msg=f.name)
        else:
            _bits_equal(a.numpy(), b, f.name)
    # Row 5 carries real masks: all ones off the alpha triangles, zero
    # padding, and on the ivy's leaves zero bits over their empty texels
    # (the textured box's 8-texel alpha stripes are narrower than a
    # conservative cell, so its masks stay full).
    c = tm.cluster_size
    words = ts.clus_pack[:, 5, : 2 * c].contiguous().view(torch.int32).numpy()
    first = ts.clus_first.numpy()
    alpha_tri = ts.materials.has_alpha.numpy()[ts.tri_mat.numpy()]
    counts = np.diff(np.append(np.sort(first), tm.n_tris))[np.argsort(np.argsort(first))]
    ones = zeros_seen = 0
    for ci in range(tm.n_clusters):
        f, k = first[ci], counts[ci]
        w = words[ci]
        a = alpha_tri[f : f + k]
        assert (w[:k][~a] == -1).all() and (w[c : c + k][~a] == -1).all()
        assert (w[k:c] == 0).all() and (w[c + k :] == 0).all()
        ones += int((~a).sum())
        zeros_seen += int(((w[:k][a] != -1) | (w[c : c + k][a] != -1)).sum())
    assert ones > 0 and (zeros_seen > 0) == (name == "atrium_ivy")


def _hits(rng, n_tris, n):
    tri = rng.integers(0, n_tris, n).astype(np.int32)
    u = rng.random(n, dtype=np.float32)
    v = (rng.random(n, dtype=np.float32) * (1.0 - u)).astype(np.float32)
    return tri, u, v


def test_resolve_material_and_shading_equal_jax(scenes):
    name, js, jm, ts, tm = scenes
    rng = np.random.default_rng(11)
    n = 4096
    tri, u, v = _hits(rng, tm.n_tris, n)
    tri[:8] = -1  # misses
    t = rng.uniform(0.1, 5.0, n).astype(np.float32)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mask = tri >= 0
    back = rng.random(n) < 0.3
    th = THit(T(t), T(tri), T(u), T(v), T(back), torch.ones((n, 3)), T(mask))
    jh = JHit(jnp.asarray(t), jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v), jnp.asarray(back),
              jnp.ones((n, 3)), jnp.asarray(mask))
    jscene = jax.tree_util.tree_map(jnp.asarray, js)
    sh = TI.shading_data(ts, tm, th, T(o), T(d))
    jsh = JI.shading_data(jscene, jm, jh, jnp.asarray(o), jnp.asarray(d))
    for f in ("p", "n", "tg", "uv"):
        np.testing.assert_allclose(getattr(sh, f).numpy(), np.asarray(getattr(jsh, f)), rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    for f in ("mat", "light", "back"):
        np.testing.assert_array_equal(getattr(sh, f).numpy(), np.asarray(getattr(jsh, f)), err_msg=f)
    # Normal maps moved the normals of the mapped materials.
    mapped = ts.materials.tex_normal.numpy()[sh.mat.numpy()] >= 0
    assert mapped.any()
    tm_ = TB.resolve_material(ts, tm, sh.mat, sh.uv)
    jm_ = JB.resolve_material(jscene, jm, jsh.mat, jsh.uv)
    for f in tm_._fields:
        a, b = getattr(tm_, f).numpy(), np.asarray(getattr(jm_, f))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=f)
    # Textures modulate the base colour of the textured materials.
    textured = ts.materials.tex_base.numpy()[sh.mat.numpy()] >= 0
    assert textured.any()
    untex = TB.resolve_material(ts, dataclasses.replace(tm, any_textures=False), sh.mat)
    assert (untex.base.numpy()[textured] != tm_.base.numpy()[textured]).any()


@pytest.mark.parametrize("kind", ["zsobol", "hash"])
def test_lane_seed_bit_exact(kind):
    rng = np.random.default_rng(3)
    n = 8192
    px = rng.integers(0, 2048, n).astype(np.int32)
    py = rng.integers(0, 2048, n).astype(np.int32)
    s = rng.integers(0, 4096, n).astype(np.int32)
    ts_ = TQ.make_sampler(kind, 4096, (2048, 2048), seed=7, device="cpu")
    js_ = JQ.make_sampler(kind, 4096, (2048, 2048), seed=7)
    got = ts_.lane_seed(ts_.init_lanes(T(px), T(py), T(s))).numpy()
    want = np.asarray(js_.lane_seed(js_.init_lanes(jnp.asarray(px), jnp.asarray(py), jnp.asarray(s))))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert len(np.unique(got)) > 0.99 * n


def test_alpha_draw_bit_exact():
    rng = np.random.default_rng(4)
    n = 1 << 16
    seed = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    tri = rng.integers(-1, 1 << 20, n).astype(np.int32)
    for depth in (0, 1, 29):
        bounce = seed ^ np.uint32((depth * 0x85EBCA6B) & 0xFFFFFFFF)
        for s in (bounce, bounce ^ np.uint32(0x6A09E667)):
            want = np.asarray(JQ.u32_to_unit_float(JQ.mix32(
                jnp.asarray(s) ^ jnp.asarray(tri).astype(jnp.uint32) * jnp.uint32(0x9E3779B9))))
            got = TQ.alpha_draw(T(s.astype(np.int64)), T(tri)).numpy()
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
