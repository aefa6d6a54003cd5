"""The port's block-trace scene tables against the JAX package's.

Both sides are numpy, so everything is compared exactly:
- `build_bvh` (tree, leaf-order permutation), `cut_clusters`, the coarse
  cluster permutation and `woop_rows` on a seeded quad soup at C = 64;
- `SceneBuilder.compile` against the JAX builder, both on their numpy
  BVH build and BVH8 collapse (each builder prefers its native C++ build,
  whose tree differs from the numpy one; tests/test_torch_native.py holds
  the two native builds to each other): the permuted
  triangle rows, the cluster tables with their +3e38 pad boxes and the
  coarse BVH8 of bin-trace, the env
  tables and the scene bounds, bit for bit, on the `spheres` scene and on
  image, rotated + portal-cropped and uniform envs."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_bintrace import _random_mesh
from torch_native_lib import numpy_twins
from yart_tpu.scene import bvh as JB
from yart_tpu.scene import clusters as JCl
from yart_tpu.scene import procedural as JP
from yart_tpu.scene.builder import SceneBuilder as JBuilder
from yart_tpu_torch.scene import bvh as TB
from yart_tpu_torch.scene import clusters as TCl
from yart_tpu_torch.scene import procedural as TP
from yart_tpu_torch.scene.builder import SceneBuilder as TBuilder
from yart_tpu_torch.scene.types import CompiledScene, TextureStack

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def soup():
    pos, tri = _random_mesh(np.random.default_rng(5), 700)
    return pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def test_bvh_equals_jax(soup):
    jb, tb = JB.build_bvh(*soup), TB.build_bvh(*soup)
    for f in TB.HostBVH._fields:
        _eq(getattr(tb, f), getattr(jb, f), f)
    assert sorted(tb.tri_order.tolist()) == list(range(soup[0].shape[0]))


@pytest.mark.parametrize("c", [64, 128])
def test_clusters_equal_jax(soup, c):
    hb = TB.build_bvh(*soup)
    jcut, tcut = JCl.cut_clusters(hb, c), TCl.cut_clusters(hb, c)
    for f in TCl.ClusterCut._fields:
        _eq(getattr(tcut, f), getattr(jcut, f), f)
    assert tcut.first.shape[0] > 8 and tcut.count.max() <= c
    jco, tco = JCl.build_coarse(jcut).cut, TCl.build_coarse(tcut).cut
    for f in TCl.ClusterCut._fields:
        _eq(getattr(tco, f), getattr(jco, f), f)
    w = tuple(v[hb.tri_order] for v in soup)
    _eq(TCl.woop_rows(*w, tco, c).view(np.int32), JCl.woop_rows(*w, jco, c).view(np.int32))


def _jax_numpy_compile(builder, monkeypatch, **kw):
    """The JAX builder on its numpy BVH path (native build and BVH8 collapse
    switched off), and the port's builder on its numpy twins from here on."""
    numpy_twins(monkeypatch)
    js, jm = builder.compile(**kw)
    return jax.tree_util.tree_map(np.asarray, js), jm


def _check_tables(ts, tm, js, jm):
    for f in dataclasses.fields(CompiledScene):
        if f.name == "materials":
            continue
        a, b = getattr(ts, f.name), getattr(js, f.name)
        pairs = ([(f"{f.name}.{g}", getattr(a, g), getattr(b, g)) for g in TextureStack._fields]
                 if isinstance(a, TextureStack) else [(f.name, a, b)])
        for name, x, y in pairs:
            x, y = np.atleast_1d(x.numpy()), np.atleast_1d(np.asarray(y))
            assert x.shape == y.shape, name
            _eq(x.view(np.uint8), y.view(np.uint8), name)
    for f in ("n_tris", "n_lights", "has_env", "env_sampleable", "env_portal", "env_wc",
              "env_hc", "n_clusters", "cluster_size", "n_clus_pad", "coarse_depth",
              "coarse_max_leaf", "bintrace_k", "max_leaf", "bvh_depth", "wide_depth"):
        assert getattr(tm, f) == getattr(jm, f), f


def test_spheres_builder_equals_jax(monkeypatch):
    js, jm = _jax_numpy_compile(JP.material_test_spheres(), monkeypatch)
    ts, tm = TP.material_test_spheres().compile(device="cpu")
    assert tm.n_tris == 14402 and tm.n_clusters > 100 and tm.has_env
    _check_tables(ts, tm, js, jm)
    # Pad boxes sit far away at +3e38 (never entered), the rest are real.
    assert (ts.clus_box[:6, tm.n_clusters:] == 3.0e38).all()
    assert (ts.clus_box[0:3, : tm.n_clusters] <= ts.clus_box[3:6, : tm.n_clusters]).all()


def _env_builders(kind):
    rng = np.random.default_rng(3)
    pos, tri = _random_mesh(rng, 40)
    img = rng.lognormal(0.0, 1.0, (16, 16, 3)).astype(np.float32)
    a = 0.6
    rot = np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
    out = []
    for cls in (JBuilder, TBuilder):
        b = cls()
        b.add_mesh(pos, tri, b.add_material(roughness=0.5))
        if kind == "rotated_portal":
            b.set_env(img, 1.5, rotation=rot, bounds=(0.1, 0.2, 0.8, 0.9))
        elif kind == "uniform":
            b.set_env_uniform((0.3, 0.5, 0.7))
        else:
            b.set_env(img, 0.7)
        out.append(b)
    return out


@pytest.mark.parametrize("kind", ["image", "rotated_portal", "uniform"])
def test_env_builder_equals_jax(monkeypatch, kind):
    jb, tb = _env_builders(kind)
    js, jm = _jax_numpy_compile(jb, monkeypatch, cluster_size=64)
    ts, tm = tb.compile(device="cpu", cluster_size=64)
    _check_tables(ts, tm, js, jm)
    assert tm.env_portal == (kind == "rotated_portal")
    assert tm.env_sampleable == (kind != "uniform")
