"""The port's stack traversals (render/stacktrace.py) against the JAX
package, on the CPU.

- Builder tables: `node_pack`, `wide_pack`, `max_leaf`, `bvh_depth`
  and `wide_depth` of a gated ivy of 4,202 triangles bit-equal to the JAX
  builder's, both builders on their numpy BVH build and BVH8 collapse.
- `intersect_bvh`, `intersect_bvh8` and `intersect_bvh_sorted` against
  their JAX counterparts on tests/test_blocktrace.py's textured box (alpha
  cutout, thin glass) with alpha seeds: closest hits, and shadow rays at a
  finite t_max; tests/test_torch_gated.py's bars (masks equal, t within
  2e-5, triangle ids equal on >= 99.5% of hit lanes, unoccluded
  attenuation within rtol 1e-4 / atol 1e-5).
- Lane-exactness of the port's own variants: `intersect_bvh_sorted` with a
  small chunk and a ragged lane count against `intersect_bvh8`, and every
  traversal with a host check every iteration (`CHECK_EVERY` = 1), bitwise.
- The stack-overflow rules and the iteration cap: `wide_depth` /
  `bvh_depth` = 1 and a small `max_iters` on both sides.
- The alpha stream: the stack traversal and the port's gated brute draw the
  same per-(lane, triangle) hash (tests/test_alpha_stream.py's quad).
- The child sort carries a leaf ref at triangle 2^20 exactly, where a
  float32 round trip (the JAX loop's one-hot product) does not.
- base_color gradients through the stack traversal (the ivy past the
  cap) against the gated block trace route's, its calls on detached rays
  with gradients off.
(The render through the stack traversals against the JAX Renderer is in
tests/test_torch_stackrender.py.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_native_lib import numpy_twins
from yart_tpu.render import intersect as JI
from yart_tpu.scene.builder import SceneBuilder as JSB
from yart_tpu.scene.procedural import textured_box_scene as j_textured_box
from yart_tpu.scene.showcase import leaf_texture
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.ops.qmc import make_sampler
from yart_tpu_torch.render import blocktrace as TBT
from yart_tpu_torch.render import diff as TD
from yart_tpu_torch.render import intersect as TI
from yart_tpu_torch.render import stacktrace as TS
from yart_tpu_torch.render.camera import build_camera
from yart_tpu_torch.scene.builder import SceneBuilder as TSB
from yart_tpu_torch.scene.bvh import encode_leaf8
from yart_tpu_torch.scene.convert import from_numpy

T = torch.from_numpy
FIELDS = ("mask", "t", "u", "v", "back_side", "tri", "attenuation")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ivy(cls, q=2100):
    """`q` alpha-tested leaf quads (the atrium's leaf texture, thin) over an
    opaque floor: 2q + 2 triangles."""
    rng = np.random.default_rng(21)
    b = cls()
    t = b.add_texture("rgba", leaf_texture())
    m_ivy = b.add_material(roughness=0.9, tex_base=t, has_alpha=True, thin=True)
    m_floor = b.add_material(base_color=(0.5, 0.5, 0.5, 1.0), roughness=0.8)
    c = np.stack([rng.uniform(-2, 2, q), rng.uniform(0.3, 2.0, q), rng.uniform(-2, 2, q)], 1)
    a = rng.uniform(0, np.pi, q)
    s = rng.uniform(0.1, 0.25, q)[:, None]
    du = np.stack([np.cos(a), np.zeros(q), np.sin(a)], 1) * s
    dv = np.stack([np.zeros(q), np.ones(q), np.zeros(q)], 1) * s
    p = np.stack([c - du - dv, c + du - dv, c + du + dv, c - du + dv], 1).reshape(-1, 3)
    idx = (np.asarray([[0, 1, 2], [0, 2, 3]])[None] + 4 * np.arange(q)[:, None, None]).reshape(-1, 3)
    uv = np.tile(np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32), (q, 1))
    b.add_mesh(p, idx, m_ivy, uvs=uv)
    b.add_mesh(np.asarray([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float32),
               [[0, 2, 1], [0, 3, 2]], m_floor)
    b.set_env_uniform((0.6, 0.7, 0.8))
    return b


@pytest.fixture(scope="module")
def ivy():
    with pytest.MonkeyPatch.context() as mp:
        numpy_twins(mp)
        js, jm = _ivy(JSB).compile(cluster_size=64)
        ts, tm = _ivy(TSB).compile(device="cpu", cluster_size=64)
    return jax.tree_util.tree_map(np.asarray, js), js, jm, ts, tm


@pytest.fixture(scope="module")
def box():
    """tests/test_blocktrace.py `_gated_fixture`: the JAX-built textured box
    (alpha cutout and thin glass) carried across, and 512 seeded rays toward
    its panels."""
    with pytest.MonkeyPatch.context() as mp:
        numpy_twins(mp)
        js, jm = j_textured_box().compile()
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    rng = np.random.default_rng(9)
    n = 512
    o = np.asarray([0.0, 1.2, 3.0], np.float32) + rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] -= 1.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    seed = rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
    return js, jm, ts, tm, o, d, seed


def _fields(h):
    return {f: np.asarray(getattr(h, f)) for f in FIELDS}


def _check(got, want, nee):
    """tests/test_torch_gated.py's bars."""
    np.testing.assert_array_equal(got["mask"], want["mask"])
    m = got["mask"]
    np.testing.assert_allclose(got["t"][m], want["t"][m], rtol=2e-5, atol=2e-5)
    assert ((got["tri"] == want["tri"]) & m).sum() >= 0.995 * m.sum()
    if nee:
        un = ~m
        np.testing.assert_allclose(got["attenuation"][un], want["attenuation"][un], rtol=1e-4, atol=1e-5)


def _bits_equal(a, b, msg):
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, (msg, a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=msg)


def check_stack_tables(ts, tm, js, jm, name=""):
    """The stack traversals' tables and statics bit-equal to the JAX scene's."""
    for f in ("node_pack", "wide_pack"):
        _bits_equal(getattr(ts, f).numpy(), getattr(js, f), f"{name}{f}")
    for f in ("max_leaf", "bvh_depth", "wide_depth"):
        assert getattr(tm, f) == getattr(jm, f), f"{name}{f}"


def test_stack_tables_equal_jax(ivy):
    npj, _, jm, ts, tm = ivy
    assert tm.n_tris == 4202 and tm.any_alpha
    check_stack_tables(ts, tm, npj, jm)
    assert (tm.max_leaf, tm.wide_depth) == (4, 5) and tm.bvh_depth > tm.wide_depth


# (traversal, nee): one JAX compile each.
CASES = [("bvh8", False), ("bvh8", True), ("bvh", False), ("bvh", True), ("sorted", False)]


def _traverse(kind, side, sc, mt, o, d, t_max, nee, seed, **kw):
    if side == "jax":
        fn = {"bvh8": JI.intersect_bvh8, "bvh": JI.intersect_bvh, "sorted": JI.intersect_bvh_sorted}[kind]
        return _fields(fn(sc, mt, jnp.asarray(o), jnp.asarray(d), t_max, nee=nee, alpha_seed=jnp.asarray(seed),
                          **kw))
    fn = {"bvh8": TS.intersect_bvh8, "bvh": TS.intersect_bvh, "sorted": TS.intersect_bvh_sorted}[kind]
    return _fields(fn(sc, mt, T(o), T(d), t_max, nee=nee, alpha_seed=T(seed.astype(np.int64)), **kw))


@pytest.mark.parametrize("kind,nee", CASES)
def test_traversal_equals_jax(box, kind, nee):
    js, jm, ts, tm, o, d, seed = box
    assert tm.any_alpha and tm.any_transparent
    t_max = 6.0 if nee else 100.0
    kw = dict(chunk=128) if kind == "sorted" else {}  # 512 lanes: four sorted chunks in JAX
    TS.COUNTS.reset()
    got = _traverse(kind, "torch", ts, tm, o, d, t_max, nee, seed, **kw)
    want = _traverse(kind, "jax", js, jm, o, d, t_max, nee, seed, **kw)
    assert TS.COUNTS.calls == 1 and TS.COUNTS.iters[0] > 0
    _check(got, want, nee)
    m = got["mask"]
    assert 0.05 < m.mean() < 0.95
    if nee:
        assert (got["attenuation"][~m] < 1.0).any()  # some pass the thin glass


def test_sorted_is_lane_exact_to_bvh8(box):
    _, _, ts, tm, o, d, seed = box
    n = 1000  # ragged: not a multiple of the chunk
    o2, d2 = np.concatenate([o, o[: n - o.shape[0]]]), np.concatenate([d, -d[: n - o.shape[0]]])
    s2 = np.concatenate([seed, seed[: n - o.shape[0]] ^ 0x5555])
    a = _traverse("sorted", "torch", ts, tm, o2, d2, 100.0, False, s2, chunk=96)
    b = _traverse("bvh8", "torch", ts, tm, o2, d2, 100.0, False, s2)
    for f in FIELDS:
        _bits_equal(a[f], b[f], f)


@pytest.mark.parametrize("kind", ["bvh8", "bvh"])
def test_working_set_changes_nothing(box, kind, monkeypatch):
    _, _, ts, tm, o, d, seed = box
    a = _traverse(kind, "torch", ts, tm, o, d, 6.0, True, seed)
    TS.COUNTS.reset()
    monkeypatch.setattr(TS, "CHECK_EVERY", 1)
    b = _traverse(kind, "torch", ts, tm, o, d, 6.0, True, seed)
    assert len(TS.COUNTS.sets[0]) == TS.COUNTS.iters[0]  # a host check every iteration
    assert TS.COUNTS.sets[0][-1] < TS.COUNTS.sets[0][0]  # and the working set shrank
    for f in FIELDS:
        _bits_equal(a[f], b[f], f)


@pytest.mark.parametrize("kind", ["bvh8", "bvh"])
def test_stack_overflow_and_cap_match_jax(ivy, kind):
    """One-level stacks (pushes dropped past the last slot for the 8-wide
    tree, the last slot overwritten for the binary one) and a cap of 12
    iterations, on the ivy: the lanes cut short agree with the JAX loop's."""
    _, js, jm, ts, tm = ivy
    rng = np.random.default_rng(4)
    n = 1024
    o = (np.asarray([0.0, 1.4, 4.5]) + rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    d = np.stack([rng.uniform(-2, 2, n), rng.uniform(0.3, 2.0, n), rng.uniform(-2, 2, n)], 1) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    seed = rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
    depth = "wide_depth" if kind == "bvh8" else "bvh_depth"
    jm1, tm1 = dataclasses.replace(jm, **{depth: 1}), dataclasses.replace(tm, **{depth: 1})
    full = _traverse(kind, "torch", ts, tm, o, d, 100.0, False, seed)
    for iters in (0, 12):
        got = _traverse(kind, "torch", ts, tm1, o, d, 100.0, False, seed, max_iters=iters)
        want = _traverse(kind, "jax", js, jm1, o, d, 100.0, False, seed, max_iters=iters)
        _check(got, want, False)
        assert (got["mask"] != full["mask"]).any()  # the override bites
        assert 0.05 < got["mask"].mean()


def test_alpha_stream_matches_gated_brute():
    """tests/test_alpha_stream.py's constant-alpha quad: the stack traversal
    and the gated brute accept the same lanes (the same per-(lane, tri)
    hash draw), at a rate of alpha."""
    alpha, n = 0.37, 1 << 13
    a = np.full((8, 8, 4), 1.0, np.float32)
    a[..., 3] = alpha
    b = TSB()
    m = b.add_material(roughness=1.0, tex_base=b.add_texture("rgba", a), has_alpha=True)
    b.add_mesh(np.asarray([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32), [[0, 1, 2], [0, 2, 3]], m,
               uvs=np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
    ts, tm = b.compile(device="cpu")
    rng = np.random.default_rng(17)
    o = np.concatenate([rng.uniform(-0.9, 0.9, (n, 2)), np.full((n, 1), -3.0)], 1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    seed = T(rng.integers(0, 2 ** 32, size=n, dtype=np.uint32).astype(np.int64))
    hs = TS.intersect_bvh8(ts, tm, T(o), T(d), 100.0, alpha_seed=seed)
    hb = TI.intersect_brute(ts, tm, T(o), T(d), 100.0, alpha_seed=seed)
    for f in FIELDS:
        _bits_equal(getattr(hs, f).numpy(), getattr(hb, f).numpy(), f)
    assert abs(hs.mask.float().mean().item() - alpha) < 5.0 * np.sqrt(alpha * (1 - alpha) / n)


def test_child_sort_carries_leaf_refs_past_2_20():
    ref = encode_leaf8(1 << 20, 3)
    assert int(np.int32(np.float32(ref))) != ref  # the float32 one-hot product rounds it
    enc = torch.tensor([[5, -1, ref, 7, -1, -1, encode_leaf8(12, 2), -1]], dtype=torch.int32)
    dist = torch.tensor([[2.0, 3e38, 0.5, 0.5, 3e38, 3e38, 1.0, 3e38]])
    s_dist, s_enc = TS.sort_children(dist, enc)
    assert s_enc.tolist() == [[ref, 7, encode_leaf8(12, 2), 5, -1, -1, -1, -1]]  # ties keep slot order
    assert s_dist.tolist()[0][:4] == [0.5, 0.5, 1.0, 2.0]
    v = -(s_enc[0, 0].item() + 2)
    assert (v >> 4, v & 15) == (1 << 20, 3)


def material_grads_both_routes(ts, tm, past, mod, name, cam):
    """base_color gradients (8x8, 2 spp, depth 2) through the route of the
    meta `past` and through the block trace's (`tm`), with the calls of
    `mod.name` recorded: (gradient, the block trace's, [(grad enabled,
    o and d require grad) per call])."""
    seen = []
    real = getattr(mod, name)
    setattr(mod, name, lambda s, m, o, d, *a, **k: seen.append(
        (torch.is_grad_enabled(), o.requires_grad, d.requires_grad)) or real(s, m, o, d, *a, **k))
    try:
        size, spp = (8, 8), 2
        cfg = RenderConfig(samples=spp, max_depth=2, estimator="mean")
        yy, xx = np.meshgrid(np.arange(size[1]), np.arange(size[0]), indexing="ij")
        px, py = (torch.from_numpy(np.repeat(a.reshape(-1), spp).astype(np.int64)) for a in (xx, yy))
        sidx = torch.from_numpy(np.tile(np.arange(spp), size[0] * size[1]).astype(np.int64))
        camera = build_camera(CameraConfig(image_size=size, **cam), "cpu")
        sampler = make_sampler(cfg.sampler, spp, size, 0, device="cpu")
        g, ref = (TD.material_grads(ts, m, camera, sampler, cfg, px, py, sidx, loss_fn=torch.mean,
                                    fields=["base_color"])[1]["base_color"] for m in (past, tm))
    finally:
        setattr(mod, name, real)
    return g, ref, seen


def test_material_grads_through_the_stack_traversal(ivy):
    """The differentiable path through the stack traversal (the ivy past
    the cluster cap): its calls see detached rays with gradients off, and
    the base_color gradient equals the gated block trace route's within
    1e-4 of its largest entry."""
    _, _, _, ts, tm = ivy
    g, ref, seen = material_grads_both_routes(
        ts, tm, dataclasses.replace(tm, n_clusters=TBT.MAX_CLUSTERS + 1), TS, "intersect_bvh8",
        dict(position=(0.0, 1.4, 4.5), forward=(0.0, -0.25, -1.0), focal_length=26.0))
    assert seen and all(s == (False, False, False) for s in seen)
    assert torch.isfinite(g).all() and ref.abs().max() > 0
    assert (g - ref).abs().max() <= 1e-4 * ref.abs().max()
