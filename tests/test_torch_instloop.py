"""The port's per-instance loop (render/intersect.py `intersect_instanced`)
against the JAX package, on the CPU.

Scenes: tests/test_torch_instancing.py's `spheres` (ungated: B1's twin per
prototype; an emissive and a textured, normal-mapped instance) and
`leaves` (`showcase.instanced_leaves()`: alpha-tested leaf quads and a thin
glass pane, so the prototypes take the gated brute), each built by both
builders (both on their numpy BVH build and BVH8 collapse).

- Every prototype's scene and meta (`protos`, `proto_metas`) bit-equal to
  the JAX builder's, the stack traversals' tables included, and sharing
  the instanced scene's material table and atlases by reference; carried
  across by `from_numpy` likewise.
- The loop against the JAX `_intersect_instanced`, closest hits and shadow
  rays, with alpha seeds, at tests/test_instancing.py's bar (masks equal;
  closest hits: t within 2e-5, triangle ids equal on >= 99.9% of hit
  lanes; shadow rays: the unoccluded attenuation within rtol 1e-4 / atol
  1e-5).
- The loop against the port's own instanced block trace (B3's instanced
  twin; the gated re-cast loop for `leaves`), at the same bar.
- base_color gradients through the loop (`spheres` past the cap) against
  the instanced block trace route's, its calls on detached rays with
  gradients off.
(The render through the loop against the JAX Renderer is in
tests/test_torch_stackrender.py.)
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_instancing import _build, _rays
from test_torch_stacktrace import FIELDS, check_stack_tables, material_grads_both_routes
from yart_tpu.render.intersect import _intersect_instanced as j_loop
from yart_tpu_torch.render import blocktrace as TBT
from yart_tpu_torch.render import intersect as TIn
from yart_tpu_torch.scene.convert import from_numpy
from yart_tpu_torch.scene.types import LOOKS, CompiledScene, MaterialTable, TextureStack

T = torch.from_numpy
META = ("n_tris", "n_materials", "n_lights", "has_env", "any_alpha", "any_transparent", "any_textures",
        "n_clusters", "cluster_size", "n_clus_pad", "coarse_depth", "coarse_max_leaf", "max_leaf", "bvh_depth",
        "wide_depth")


@pytest.fixture(scope="module", params=["spheres", "leaves"])
def scene(request):
    return (request.param, *_build(request.param))


def _bits_equal(a, b, msg):
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, (msg, a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=msg)


def _tables_equal(ps, pj, msg):
    for f in dataclasses.fields(CompiledScene):
        a, b = getattr(ps, f.name), getattr(pj, f.name)
        if f.name not in LOOKS:  # the looks are shared: checked below
            _bits_equal(a.numpy(), b, f"{msg}{f.name}")


def test_proto_tables_equal_jax(scene):
    name, npj, _, jm, ts, tm = scene
    assert len(ts.protos) == len(npj.protos) == len(tm.proto_metas) == max(tm.inst_proto) + 1
    cs, cm = from_numpy(npj, dataclasses.asdict(jm), device="cpu")
    assert cm == tm  # the proto metas carried across
    for p, (ps, pm) in enumerate(zip(ts.protos, tm.proto_metas)):
        _tables_equal(ps, npj.protos[p], f"proto {p} ")
        _tables_equal(cs.protos[p], npj.protos[p], f"carried proto {p} ")
        check_stack_tables(ps, pm, npj.protos[p], jm.proto_metas[p], f"proto {p} ")
        for f in META:
            assert getattr(pm, f) == getattr(jm.proto_metas[p], f), (p, f)
        for s in (ts, cs):  # one material table and one set of atlases
            for k in LOOKS:
                assert getattr(s.protos[p], k) is getattr(s, k), (p, k)
        for g in MaterialTable._fields:
            _bits_equal(getattr(ps.materials, g).numpy(), getattr(npj.protos[p].materials, g), g)
        for g in TextureStack._fields:
            _bits_equal(getattr(ps.tex_rgba, g).numpy(), getattr(npj.protos[p].tex_rgba, g), f"tex_rgba.{g}")
    moved = ts.to("cpu")
    assert all(getattr(p, k) is getattr(moved, k) for p in moved.protos for k in LOOKS)


def _check(got, want, nee):
    """Closest hits: masks, t, triangle ids; shadow rays: their contract,
    the masks and the unoccluded attenuation (the loop's shadow t stays
    t_max, as in the JAX loop)."""
    np.testing.assert_array_equal(got["mask"], want["mask"])
    m = got["mask"]
    if nee:
        np.testing.assert_allclose(got["attenuation"][~m], want["attenuation"][~m], rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(got["t"][m], want["t"][m], rtol=2e-5, atol=2e-5)
        assert ((got["tri"] == want["tri"]) & m).sum() >= 0.999 * m.sum()
    assert 0.05 < m.mean() < 0.95


def _case(rng, n=384):
    o, d = _rays(rng, n)
    return o, d, rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)


@pytest.mark.parametrize("nee", [False, True])
def test_loop_equals_jax(scene, nee):
    name, _, js, jm, ts, tm = scene
    o, d, seed = _case(np.random.default_rng(7))
    t_max = 4.0 if nee else 100.0
    got = TIn.intersect_instanced(ts, tm, T(o), T(d), t_max, nee=nee, alpha_seed=T(seed.astype(np.int64)))
    want = j_loop(js, jm, jnp.asarray(o), jnp.asarray(d), t_max, nee=nee, alpha_seed=jnp.asarray(seed))
    _check({f: getattr(got, f).numpy() for f in FIELDS}, {f: np.asarray(getattr(want, f)) for f in FIELDS}, nee)
    if nee and name == "leaves":
        assert (got.attenuation[~got.mask] < 1.0).any()  # through the glass pane


@pytest.mark.parametrize("nee", [False, True])
def test_loop_equals_instanced_blocktrace(scene, nee):
    name, _, _, _, ts, tm = scene
    o, d, seed = _case(np.random.default_rng(11), 1000)
    t_max = torch.full((o.shape[0],), 4.0 if nee else 100.0)
    args = (T(o), T(d), t_max)
    kw = dict(nee=nee, alpha_seed=T(seed.astype(np.int64)))
    past = dataclasses.replace(tm, n_inst_clusters=TBT.MAX_CLUSTERS + 1)
    got = TIn.intersect(ts, past, *args, **kw)  # the loop
    want = TIn.intersect(ts, tm, *args, **kw)  # the block trace
    _check({f: getattr(got, f).numpy() for f in FIELDS}, {f: getattr(want, f).numpy() for f in FIELDS}, nee)


def test_material_grads_through_the_loop():
    """The differentiable path through the per-instance loop (`spheres`
    past the cap): its calls see detached rays with gradients off, and the
    base_color gradient equals the instanced block trace route's within
    1e-4 of its largest entry."""
    _, _, _, ts, tm = _build("spheres")
    g, ref, seen = material_grads_both_routes(
        ts, tm, dataclasses.replace(tm, n_inst_clusters=TBT.MAX_CLUSTERS + 1), TIn, "intersect_instanced",
        dict(position=(0, 0.6, 4.0), forward=(0, -0.05, -1), focal_length=26.0))
    assert seen and all(s == (False, False, False) for s in seen)
    assert torch.isfinite(g).all() and ref.abs().max() > 0
    assert (g - ref).abs().max() <= 1e-4 * ref.abs().max()
