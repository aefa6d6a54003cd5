"""The port's native host builder (`yart_tpu_torch/native.py`, C++ in
`yart_tpu_torch/csrc/host/`) against the JAX package's, on the CPU.

The JAX package's own native sources are compiled here with the port's
flags (`tests/torch_native_lib.py`), so both sides run the same C++ under
the same floating-point contraction, and everything is compared bit for
bit:
- `build_bvh` at the JAX wrapper's defaults (max_leaf 4, 20 bins) on
  seeded soups of 1, 2, 3,000 and 20,000 triangles, coplanar triangles
  and triangles with duplicate centroids;
- `collapse_bvh8`: the C++ collapse, the port's numpy twin and the JAX
  package's C++ collapse;
- a whole `SceneBuilder.compile` of cornell-mat and of a small textured,
  instanced scene (tests/test_torch_instancing.py's `spheres`): every
  table of the scene and of each prototype;
- the default build path: g++ missing or failing raises, naming the
  command; nothing falls back to numpy;
- chip_smoke.py's check of a native tree.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

import chip_smoke
import yart_tpu.native as JN
import yart_tpu_torch.native as TN
from test_torch_instancing import _spheres
from torch_native_lib import jax_native_at, jax_native_library
from yart_tpu.scene import procedural as JP
from yart_tpu.scene.builder import SceneBuilder as JSB
from yart_tpu_torch.kernels import build
from yart_tpu_torch.scene import bvh as TB
from yart_tpu_torch.scene import procedural as TP
from yart_tpu_torch.scene.builder import SceneBuilder as TSB
from yart_tpu_torch.scene.types import LOOKS, CompiledScene, InstancedScene, TextureStack


@pytest.fixture(scope="session")
def jax_lib(tmp_path_factory):
    return jax_native_library(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture
def jax_native(jax_lib, monkeypatch):
    """yart_tpu.native on its own sources built with the port's flags."""
    jax_native_at(monkeypatch, jax_lib)
    assert JN.get_library() is not None


def _soup(n, seed=0):
    rng = np.random.default_rng(seed)
    v = (rng.uniform(-2, 2, (n, 1, 3)) + rng.uniform(-0.3, 0.3, (n, 3, 3))).astype(np.float32)
    return v[:, 0], v[:, 1], v[:, 2]


def _coplanar(n=900, seed=1):
    v0, v1, v2 = _soup(n, seed)
    for v in (v0, v1, v2):
        v[:, 2] = 0.5  # every centroid at one z: that axis has no extent
    return v0, v1, v2


def _duplicate_centroids(n=600, seed=2):
    """Triangles in 7 groups, each group sharing one centroid exactly
    (mirrored pairs around it): SAH bins cannot separate a group."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (7, 3)).astype(np.float32)[np.arange(n) % 7]
    e = rng.uniform(-0.2, 0.2, (n, 2, 3)).astype(np.float32)
    return c + e[:, 0], c - e[:, 0] + e[:, 1], c - e[:, 1]


SOUPS = {"1": lambda: _soup(1), "2": lambda: _soup(2), "3000": lambda: _soup(3000, 3),
         "20000": lambda: _soup(20000, 4), "coplanar": _coplanar, "duplicate_centroids": _duplicate_centroids}


def _bits_equal(a, b, msg):
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, (msg, a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=msg)


def _trees_equal(t, j, fields, msg=""):
    for f in fields:
        x, y = getattr(t, f), getattr(j, f)
        if isinstance(x, int):
            assert x == y, f"{msg}{f}"
        else:
            _bits_equal(x, y, f"{msg}{f}")


@pytest.mark.parametrize("case", list(SOUPS))
def test_build_bvh_equals_jax(case, jax_native):
    v = SOUPS[case]()
    t = TN.build_bvh(*v)
    _trees_equal(t, JN.build_bvh_native(*v), TB.HostBVH._fields)
    n = v[0].shape[0]
    assert sorted(t.tri_order.tolist()) == list(range(n))
    assert t.node_min.shape == (t.left.shape[0], 3) and t.left.dtype == t.tri_order.dtype == np.int32
    if n >= 3000:  # a real tree, shaped as the numpy twin's
        tw = TB.build_bvh(*v)
        assert t.depth > 5 and all(getattr(t, f).dtype == getattr(tw, f).dtype for f in TB.HostBVH._fields[:-1])


@pytest.mark.parametrize("case", list(SOUPS))
def test_collapse_bvh8_equals_twin_and_jax(case, jax_native):
    hb = TN.build_bvh(*SOUPS[case]())
    t = TN.collapse_bvh8(hb)
    _trees_equal(t, TB.collapse_bvh8(hb), TB.HostBVH8._fields, "twin ")
    _trees_equal(t, JN.collapse_bvh8_native(hb), TB.HostBVH8._fields, "jax ")
    # The twin's collapse of the numpy tree likewise.
    hn = TB.build_bvh(*SOUPS[case]())
    _trees_equal(TN.collapse_bvh8(hn), TB.collapse_bvh8(hn), TB.HostBVH8._fields, "numpy tree ")


def _scenes_equal(ts, js, msg=""):
    """Every table of the port's scene bit-equal to the JAX scene's (numpy
    leaves), the prototypes' scenes too."""
    for f in dataclasses.fields(type(ts)):
        a, b = getattr(ts, f.name), getattr(js, f.name)
        if f.name == "protos":
            if a is not None or b is not None:
                assert len(a) == len(b), f"{msg}protos"
                for p, (pa, pb) in enumerate(zip(a, b)):
                    _scenes_equal(pa, pb, f"{msg}proto {p} ")
        elif f.name == "materials" or isinstance(a, TextureStack):
            for g in a._fields:
                _bits_equal(getattr(a, g).numpy(), getattr(b, g), f"{msg}{f.name}.{g}")
        else:
            _bits_equal(a.numpy(), b, f"{msg}{f.name}")


META = ("n_tris", "n_lights", "n_clusters", "cluster_size", "n_clus_pad", "coarse_depth", "coarse_max_leaf",
        "max_leaf", "bvh_depth", "wide_depth", "n_instances", "inst_proto", "n_inst_clusters")


@pytest.mark.parametrize("name", ["cornell_mat", "spheres_instanced"])
def test_compile_tables_equal_jax(name, jax_native):
    if name == "cornell_mat":
        jb, tb = JP.cornell_box(extra_materials=True), TP.cornell_box(extra_materials=True)
    else:
        jb, tb = _spheres(JSB), _spheres(TSB)
    js, jm = jb.compile()
    ts, tm = tb.compile(device="cpu")
    assert isinstance(ts, InstancedScene) == (name != "cornell_mat")
    _scenes_equal(ts, jax.tree_util.tree_map(np.asarray, js))
    for f in META:
        assert getattr(tm, f) == getattr(jm, f), f
    for pm, pj in zip(tm.proto_metas, jm.proto_metas):
        for f in ("n_tris", "n_clusters", "bvh_depth", "wide_depth"):
            assert getattr(pm, f) == getattr(pj, f), f
    assert tb.timings["bvh_s"] >= 0 and tb.timings["collapse_s"] >= 0
    if name != "cornell_mat":  # the prototypes share the scene's looks
        assert all(getattr(p, k) is getattr(ts, k) for p in ts.protos for k in LOOKS)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The port's host library unbuilt: a new build directory, nothing loaded."""
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(TN, "_lib", None)


def test_missing_gxx_raises(fresh_build, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ there
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        TN.build_bvh(*_soup(10))
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):  # no quiet numpy fallback
        TP.cornell_box().compile(device="cpu")


def test_failing_gxx_raises_with_its_command(fresh_build, monkeypatch):
    monkeypatch.setattr(build, "GXX_FLAGS", build.GXX_FLAGS + ("-fno-such-option-anywhere",))
    with pytest.raises(RuntimeError) as e:
        TP.cornell_box().compile(device="cpu")
    msg = str(e.value)
    assert "g++ failed building yartnative" in msg and "-ffp-contract=off" in msg
    assert "-fno-such-option-anywhere" in msg.split("\n", 2)[2]  # g++'s own error, after the command
    assert not os.listdir(os.path.dirname(build.library_path("yartnative", build.HOST_LIBRARIES["yartnative"])))


def test_malformed_inputs_raise():
    v0, v1, v2 = _soup(10)
    with pytest.raises(ValueError, match=r"\[T, 3\] alike"):
        TN.build_bvh(v0, v1[:9], v2)
    with pytest.raises(ValueError, match="refused 0 triangles"):
        TN.build_bvh(v0[:0], v1[:0], v2[:0])
    hb = TN.build_bvh(v0, v1, v2)
    bad = hb._replace(left=np.where(hb.count == 0, hb.left + 1000, hb.left).astype(np.int32))
    with pytest.raises(ValueError, match="a child outside its nodes"):
        TN.collapse_bvh8(bad)


def test_library_built_once_with_the_flags():
    path = build.library_path("yartnative", build.HOST_LIBRARIES["yartnative"])
    TN.build_bvh(*_soup(5))
    assert os.path.exists(path) and path.startswith(build.BUILD_ROOT)
    assert "-ffp-contract=off" in build.GXX_FLAGS and not any("march" in f for f in build.GXX_FLAGS)
    assert build.load("yartnative") == (TN.library(), False)


def test_chip_smoke_tree_check():
    b = TP.cornell_box(extra_materials=True)
    scene, _ = b.compile(device="cpu")
    rec = chip_smoke.native_tree_check("cornell-mat", b, scene)
    assert rec["n_tris"] == scene.tri_v.shape[0] and rec["leaves"] > 1
    bad = dataclasses.replace(scene, node_pack=scene.node_pack.clone())
    bad.node_pack[1, 0] -= 1.0  # a child box leaves its parent's
    with pytest.raises(AssertionError):
        chip_smoke.native_tree_check("cornell-mat", b, bad)
    assert isinstance(scene, CompiledScene)
