"""B1's plain twin (yart_tpu_torch.kernels.brute) against the JAX package's
`intersect_brute` and against `brute_pallas` run in interpret mode, plus
the dispatcher's routes and the CPU/CUDA routing of the wrapper.

Tolerances (as tests/test_pallas.py holds the Pallas kernel): hit masks
are exact; the hit triangle agrees on >= 99.9% of hit lanes (two
triangles at numerically equal t may resolve either way under another
operation order); t agrees to rtol 1e-5, and u, v to atol 5e-5 (see
_assert_hits_match)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_intersect import make_scene, random_rays
from yart_tpu.render.intersect import intersect_brute, intersect_brute_pallas
from yart_tpu_torch.kernels import brute
from yart_tpu_torch.render import intersect as TI
from yart_tpu_torch.render import stacktrace
from yart_tpu_torch.scene.convert import from_numpy
from yart_tpu_torch.scene.types import SceneMeta

torch.set_num_threads(2)


def _case(n_tris, n_rays, seed, n_retired=0):
    js, jm = make_scene(n_tris)
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    o, d = random_rays(np.random.default_rng(seed), n_rays)
    t_max = np.full(n_rays, 1e30, np.float32)
    t_max[:n_retired] = -1.0  # retired lanes (integrator.py:486)
    return js, jm, ts, tm, np.array(o), np.array(d), t_max


def _assert_hits_match(jh, th):
    np.testing.assert_array_equal(np.asarray(jh.mask), th.mask.numpy())
    m = np.asarray(jh.mask)
    np.testing.assert_allclose(th.t.numpy()[m], np.asarray(jh.t)[m], rtol=1e-5, atol=1e-5)
    same = np.asarray(jh.tri)[m] == th.tri.numpy()[m]
    assert m.sum() == 0 or same.mean() > 0.999, same.mean()
    # Barycentrics come out of a cancelling dot product: XLA:CPU contracts
    # its a*b+c into FMAs where the port rounds every product. Both land a
    # few 1e-6 from a float64 evaluation; grazing rays (|det| small) move
    # u, v by up to a few 1e-5 absolute on single lanes.
    for f in ("u", "v"):
        np.testing.assert_allclose(
            getattr(th, f).numpy()[m][same], np.asarray(getattr(jh, f))[m][same], rtol=1e-5, atol=5e-5
        )
    np.testing.assert_array_equal(np.asarray(jh.back_side)[m][same], th.back_side.numpy()[m][same])
    # Misses keep t = t_max, tri = -1.
    np.testing.assert_array_equal(th.tri.numpy()[~m], -1)


@pytest.mark.parametrize("n_tris,n_rays,n_retired", [(300, 2048, 0), (64, 1000, 100), (5, 257, 0)])
def test_plain_matches_jax_intersect_brute(n_tris, n_rays, n_retired):
    js, jm, ts, tm, o, d, t_max = _case(n_tris, n_rays, 11, n_retired)
    jh = jax.jit(lambda o, d, tm_: intersect_brute(js, jm, o, d, tm_))(o, d, t_max)
    th = TI.intersect(ts, tm, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max))
    _assert_hits_match(jh, th)
    assert not th.mask[:n_retired].any()
    # Scene-level plain entry point == the dispatcher on CPU.
    tp = TI.intersect_brute(ts, tm, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max))
    for a, b in zip(th, tp):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_rays", [2048, 1000])
def test_plain_matches_brute_pallas_interpret(n_rays):
    js, jm, ts, tm, o, d, t_max = _case(300, n_rays, 5, n_retired=64)
    jh = intersect_brute_pallas(js, jm, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), interpret=True)
    th = TI.intersect(ts, tm, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max))
    _assert_hits_match(jh, th)


def test_plain_chunking_is_invisible(monkeypatch):
    """Lane and triangle chunking do not change a single bit."""
    _, _, ts, tm, o, d, t_max = _case(600, 700, 3, n_retired=10)
    args = (ts.tri_pack, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max), tm.n_tris, 1e-3)
    whole = brute.brute_plain(*args)
    monkeypatch.setattr(brute, "PLAIN_BUDGET", 256 * 37)
    chunked = brute.brute_plain(*args)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_lowest_index_wins_ties():
    """Two identical triangles: the lower index wins (B1's strict-< rule)."""
    tri = np.zeros((3, 12), np.float32)
    tri[0, :9] = [5, 5, 5, 6, 5, 5, 5, 6, 5]  # off to the side
    tri[1, :9] = [-1, -1, 0, 1, -1, 0, 0, 1, 0]
    tri[2] = tri[1]
    o = torch.tensor([[0.0, 0.0, 2.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    t, u, v, back, idx = brute.brute_intersect(torch.from_numpy(tri), o, d, torch.tensor([1e30]), 3, 1e-3)
    assert idx.tolist() == [1] and t.tolist() == [2.0]


def test_wrapper_routes_cpu_to_plain_and_validates():
    _, _, ts, tm, o, d, t_max = _case(64, 100, 1)
    brute.COUNTS.reset()
    args = (ts.tri_pack, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max), tm.n_tris, 1e-3)
    brute.brute_intersect(*args)
    assert brute.COUNTS.launches == 0 and brute.COUNTS.plain_cuda == 0
    with pytest.raises(ValueError, match="CUDA"):
        brute.brute_cuda(*args)
    with pytest.raises(TypeError, match="float32"):
        brute.brute_intersect(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match=r"\[T, 12\]"):
        brute.brute_intersect(args[0][:, :9], *args[1:])
    with pytest.raises(ValueError, match="t_max"):
        brute.brute_intersect(args[0], args[1], args[2], args[3][:-1], *args[4:])
    with pytest.raises(ValueError, match="n_tris"):
        brute.brute_intersect(*args[:4], 10 ** 6, 1e-3)


def _spy_routes(monkeypatch):
    """Replace the per-instance loop and the stack traversals by spies that
    record the route taken and return a marker."""
    routes = []
    for mod, name in ((TI, "intersect_instanced"), (stacktrace, "intersect_bvh8"),
                      (stacktrace, "intersect_bvh_sorted")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: routes.append(_n) or _n)
    return routes


@pytest.mark.parametrize(
    "fields,nee",
    [
        (dict(n_instances=2, n_inst_clusters=(1 << 13) + 1), False),  # instanced, past the cap
        (dict(n_tris=5000, n_clusters=(1 << 13) + 1, any_alpha=True), False),  # gated, past the cap
        (dict(n_tris=5000, n_clusters=(1 << 13) + 1, any_transparent=True), True),
        (dict(n_instances=2), False),
    ],
)
def test_dispatcher_refuses_unported_scenes(fields, nee, monkeypatch):
    """The scenes the port refused before the stack traversals and the
    per-instance loop: instanced ones past the cap (or with no instance
    clusters) take the loop, gated ones past the cap `intersect_bvh8` at
    fewer than 131,072 rays."""
    _, _, ts, _, o, d, t_max = _case(8, 16, 2)
    meta = SceneMeta(**{**dict(n_tris=8, n_materials=1, n_lights=0), **fields})
    routes = _spy_routes(monkeypatch)
    TI.intersect(ts, meta, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max), nee=nee)
    assert routes == ["intersect_instanced" if meta.n_instances else "intersect_bvh8"]


def test_dispatcher_sorts_many_gated_rays(monkeypatch):
    """A gated scene past the cap takes `intersect_bvh_sorted` from 131,072
    rays on, `intersect_bvh8` below."""
    _, _, ts, _, _, _, _ = _case(8, 16, 2)
    meta = SceneMeta(n_tris=5000, n_materials=1, n_lights=0, n_clusters=(1 << 13) + 1, any_alpha=True)
    routes = _spy_routes(monkeypatch)
    for n in (TI.SORTED_MIN_RAYS - 1, TI.SORTED_MIN_RAYS):
        TI.intersect(ts, meta, torch.zeros((n, 3)), torch.ones((n, 3)), 1e30)
    assert TI.SORTED_MIN_RAYS == 131072 and routes == ["intersect_bvh8", "intersect_bvh_sorted"]


@pytest.mark.parametrize("nee", [False, True])
def test_dispatcher_size_threshold(nee, monkeypatch):
    """A scene without instances of at most 4096 triangles takes the brute
    (B1; with transparency gates on shadow rays the gated brute), one
    triangle more the block trace (few clusters), as in the JAX dispatcher
    (:981-984); both find the same hits (shadow rays: the same occlusion)."""
    routes = []
    for mod, name in ((TI, "_gated_brute"), (brute, "brute_intersect"), (TI, "_blocktrace")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k: routes.append(_n) or _r(*a, **k))
    brute_route = "_gated_brute" if nee else "brute_intersect"
    _, _, ts, tm, o, d, t_max = _case(brute.MAX_TRIS + 1, 128, 4)
    meta = dataclasses.replace(tm, any_transparent=nee)  # no transparent material: every hit blocks
    args = (ts, meta, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(np.minimum(t_max, 3.0)))
    traced = TI.intersect(*args, nee=nee)
    # The same scene with its last triangle dropped from the count.
    small = TI.intersect(ts, dataclasses.replace(meta, n_tris=brute.MAX_TRIS), *args[2:], nee=nee)
    assert routes == ["_blocktrace", brute_route], routes
    last = traced.tri == brute.MAX_TRIS
    assert torch.equal(small.mask[~last], traced.mask[~last]) and small.mask.any()
    if not nee:
        m = small.mask & ~last
        assert torch.equal(small.tri[m], traced.tri[m])
        torch.testing.assert_close(small.t[m], traced.t[m], rtol=2e-5, atol=2e-5)


def test_nee_with_opaque_transparency_flag_off_is_closest_hit():
    """Shadow rays of ungated scenes take the same closest-hit path."""
    _, _, ts, tm, o, d, t_max = _case(64, 256, 4)
    args = (ts, tm, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max))
    for a, b in zip(TI.intersect(*args), TI.intersect(*args, nee=True)):
        assert torch.equal(a, b)
