"""The port's round-based block trace (`intersect_blocktrace(fused=False)`:
B7a `select_clusters` and B7b `test_clusters`, plain twins on the CPU)
against the JAX package's `fused=False` path and its Pallas kernels in
interpret mode, the brute-force oracle and the port's fused path, on the
scene of tests/test_blocktrace.py (a seeded soup of 1400 triangles in
clusters of 64, built by the JAX builder and carried over with
`from_numpy`) and, for the gated loop, its textured box.

Tolerances:
- `coherence_key` is an integer: bitwise equal to `_coherence_key`.
- B7a's outputs are integers: ids, bound_key and n_live equal on >= 99.9%
  of blocks (B2's bar in tests/test_torch_blocktrace.py: XLA:CPU may
  contract the slab test's multiply-subtract into an FMA, which can move an
  entry by an ulp across a quantisation step of the packed key).
- B7b on the same slots: masks equal, tri equal on >= 99.9% of hits, t
  within 2e-5 (the same FMA contraction in the plane test).
- The whole path against the JAX `fused=False` path and the brute oracle:
  tests/test_blocktrace.py's `_check_match` bar (masks equal, t within
  2e-5, tri on >= 99.9% of hits, u/v within 1e-3 and back_side equal where
  tri agrees); with `nee` the masks equal.
- Against the port's fused path on the CPU: masks equal and t bitwise equal
  on every lane (the same plane test, the same float order); tri may differ
  only where both paths' triangles lie at the same t.
- The gated loop with `fused=False` against the JAX call: tests/
  test_blocktrace.py:195-226's bars (alpha: masks equal, t within 2e-5, tri
  on >= 99.5% of hits; `nee`: masks equal, the unblocked rays' attenuation
  within rtol 1e-4 / atol 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_bintrace import _compile, _random_mesh, _rays
from test_torch_blocktrace import _check
from yart_tpu.kernels import pallas_blocktrace as PB
from yart_tpu.render import blocktrace as JBT
from yart_tpu.render.intersect import _coherence_key
from yart_tpu.render.intersect import intersect_brute as j_brute
from yart_tpu.scene.procedural import textured_box_scene as j_textured_box
from yart_tpu_torch.kernels import blocktrace as BK
from yart_tpu_torch.kernels import presort
from yart_tpu_torch.render import blocktrace as TBT
from yart_tpu_torch.render.hit import coherence_key
from yart_tpu_torch.scene.convert import from_numpy

T = torch.from_numpy
T_MIN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """This module's tests run the port on one intra-op thread, set when
    they start (every test module sets its own at import, so under xdist
    the last import would win)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _carry(js, jm):
    return from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(5)
    pos, tri = _random_mesh(rng, 700)
    js, jm = _compile(pos, tri, cluster_size=64)
    ts, tm = _carry(js, jm)
    o, d = _rays(rng, 2048)
    assert tm.n_clusters > 24  # more clusters than slots: a block may need a second round
    return js, jm, ts, tm, np.array(o), np.array(d)


def _port(ts, tm, o, d, t_max, **kw):
    o, d = np.ascontiguousarray(o), np.ascontiguousarray(d)
    t, u, v, back, tri, n_ct, n_tt = TBT.intersect_blocktrace(ts, tm, T(o), T(d), t_max, fused=False, **kw)
    return dict(mask=(tri >= 0).numpy(), t=t.numpy(), u=u.numpy(), v=v.numpy(),
                back_side=back.numpy(), tri=tri.numpy(), n_ct=n_ct.numpy(), n_tt=n_tt.numpy())


def _jax(js, jm, o, d, t_max, **kw):
    h = JBT.intersect_blocktrace(js, jm, jnp.asarray(o), jnp.asarray(d), t_max, fused=False, interpret=True,
                                 **kw)
    return {f: np.asarray(getattr(h, f)) for f in ("mask", "t", "u", "v", "back_side", "tri")}


def _brute(js, jm, o, d, t_max, nee=False):
    h = j_brute(js, jm, jnp.asarray(o), jnp.asarray(d), t_max, nee=nee)
    return {f: np.asarray(getattr(h, f)) for f in ("mask", "t", "u", "v", "back_side", "tri")}


def test_coherence_key_equals_jax(case):
    js, _, ts, _, o, d = case
    o, d = o.copy(), d.copy()
    d[:7, 1] = 0.0  # on an octant boundary
    d[7:9, 2] = -0.0
    o[9] = 1e3  # outside the scene box: clamped cells
    o[10] = -1e3
    want = np.asarray(_coherence_key(js, jnp.asarray(o), jnp.asarray(d))).astype(np.int64)
    got = coherence_key(ts, T(o), T(d)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 100


def test_round_inputs_are_the_paths(case):
    """round_inputs takes B7a's inputs from the round loop itself: round 1
    is the coherence-sorted ray matrix with the window at -2^31 and every
    block active; the windowed round follows earlier rounds and has both
    kinds of blocks; the wrapper is gone afterwards."""
    _, _, ts, tm, o, d = case
    real = BK.select_clusters
    rays, w_key, act, rnd = TBT.round_inputs(ts, tm, T(o), T(d), 100.0, 24, False, T_MIN)
    o_s, d_s, t_s, f_s, _ = TBT.pad_sorted(ts, T(o), T(d), torch.full((o.shape[0],), 100.0),
                                            torch.zeros(o.shape[0]))
    want = torch.cat([o_s, d_s, t_s[:, None], f_s[:, None]], dim=1)
    assert rnd == 1 and torch.equal(rays, want)
    assert (w_key == -(1 << 31)).all() and (act == 1).all()
    rays2, w_key2, act2, rnd2 = TBT.round_inputs(ts, tm, T(o), T(d), 100.0, 24, True, T_MIN)
    assert rnd2 >= 2 and act2.any() and not act2.all()
    assert (rays2[:, 6] <= rays[:, 6]).all() and (rays2[:, 6] < rays[:, 6]).any()  # earlier hits shorten t
    assert (w_key2 > -(1 << 31)).any()
    assert BK.select_clusters is real


def _select_pallas(rays, js, w_key, act, k):
    ids, bound_key, n_live = PB.select_clusters_pallas(
        jnp.asarray(rays.numpy()), js.clus_box, jnp.asarray(w_key.numpy()), jnp.asarray(act.numpy()),
        BK.BLOCK, k, T_MIN, interpret=True)
    return np.asarray(ids), np.asarray(bound_key), np.asarray(n_live)


@pytest.mark.parametrize("k", [24, 2])
@pytest.mark.parametrize("windowed", [False, True], ids=["round1", "windowed"])
def test_select_twin_equals_pallas(case, k, windowed):
    js, _, ts, tm, o, d = case
    rays, w_key, act, _ = TBT.round_inputs(ts, tm, T(o), T(d), 100.0, k, windowed, T_MIN)
    got = [a.numpy() for a in BK.select_clusters(rays, ts.clus_box, w_key, act, k, T_MIN)]
    want = _select_pallas(rays, js, w_key, act, k)
    same = (got[0] == want[0]).all(axis=1) & (got[1] == want[1]) & (got[2] == want[2])
    assert same.mean() >= 0.999, same.mean()
    ids, bound_key, n_live = got
    dead = act.numpy() == 0
    assert (ids[dead] == -1).all() and (bound_key[dead] == presort.KEY_DEAD).all() and (n_live[dead] == 0).all()
    live = ~dead
    assert (n_live[live] > 0).all() and (n_live[live] <= k).all()
    if k == 2:
        assert (bound_key[live] != presort.KEY_DEAD).any()  # the window overflowed: more rounds follow


def test_select_twin_equals_pallas_negative_tmin_signed_zero():
    """B7a at t_min < 0 (tests/test_torch_cuda.py's `tmin_neg_signed_zero`
    case, also held kernel against twin there): entries of -0 (box faces
    at -0 ahead of origins at +0) give the least key, bits 0x80000000, and
    entries just below 0 the keys after it; the twin keeps the JAX
    kernel's ids, bounds and live counts on every block."""
    from test_torch_cuda import b7a_edge_case

    rays, box, w_key, act, k, t_min = b7a_edge_case("tmin_neg_signed_zero", "cpu")
    assert t_min < 0
    entries = BK.block_entries(rays.view(-1, BK.BLOCK, 8), box, t_min).amin(dim=1)
    assert ((entries == 0) & torch.signbit(entries)).sum() >= 64
    got = [a.numpy() for a in BK.select_clusters(rays, box, w_key, act, k, t_min)]
    want = [np.asarray(a) for a in PB.select_clusters_pallas(
        jnp.asarray(rays.numpy()), jnp.asarray(box.numpy()), jnp.asarray(w_key.numpy()), jnp.asarray(act.numpy()),
        BK.BLOCK, k, t_min, interpret=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0][:3] < 32).all()  # the boxes with faces at -0 come first
    assert ((got[1][:2] & ~BK.ID_MASK) == np.int32(-(1 << 31))).all()  # blocks 0-1: the bound is a -0 key too


@pytest.mark.parametrize("windowed", [False, True], ids=["round1", "windowed"])
def test_test_twin_equals_pallas(case, windowed):
    js, _, ts, tm, o, d = case
    k = 24
    rays, w_key, act, _ = TBT.round_inputs(ts, tm, T(o), T(d), 100.0, k, windowed, T_MIN)
    ids, _, n_live = BK.select_clusters(rays, ts.clus_box, w_key, act, k, T_MIN)
    live, first, dma = TBT.round_slots(ts, ids, n_live, act)
    every = torch.full((ts.clus_pack.shape[0],), tm.cluster_size, dtype=torch.int32)
    got = BK.test_clusters(rays, ts.clus_pack, live, first, dma, tm.cluster_size, k, T_MIN, every).numpy()
    want = np.asarray(PB.test_clusters_pallas(
        jnp.asarray(rays.numpy()), js.clus_pack, jnp.asarray(live.numpy()), jnp.asarray(first.numpy()),
        jnp.asarray(dma.numpy()), tm.cluster_size, k, T_MIN, interpret=True))
    tri_g, tri_w = got[:, 4].view(np.int32), want[:, 4].view(np.int32)
    m = tri_g >= 0
    np.testing.assert_array_equal(m, tri_w >= 0)
    assert m.sum() >= 20  # a later round finds fewer, nearer hits
    assert ((tri_g == tri_w) & m).sum() >= 0.999 * m.sum()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=2e-5, atol=2e-5)
    same = (tri_g == tri_w) & m
    np.testing.assert_array_equal(got[same, 3], want[same, 3])
    np.testing.assert_array_equal(got[:, 5:], 0.0)
    np.testing.assert_array_equal(got[~m, 0], rays.numpy()[~m, 6])  # a miss keeps t_cur


@pytest.mark.parametrize("windowed", [False, True], ids=["round1", "windowed"])
def test_test_twin_counts(case, windowed):
    """B7b's twin with the clusters' counts, as the path calls it: bitwise
    equal to the twin with every count C (a cluster's columns past its
    count are zeros) and to the same bar against `test_clusters_pallas` as without;
    on a pack whose pad columns hold the next cluster's triangles, the
    counts still keep every slot to its own cluster's triangles."""
    js, _, ts, tm, o, d = case
    k, c = 24, tm.cluster_size
    rays, w_key, act, _ = TBT.round_inputs(ts, tm, T(o), T(d), 100.0, k, windowed, T_MIN)
    ids, _, n_live = BK.select_clusters(rays, ts.clus_box, w_key, act, k, T_MIN)
    slots = TBT.round_slots(ts, ids, n_live, act)
    counts = TBT.cluster_counts(ts, tm)
    assert (counts < c).any() and (counts >= 1).all()  # some clusters have pad columns
    every = torch.full_like(counts, c)
    got = BK.test_clusters(rays, ts.clus_pack, *slots, c, k, T_MIN, counts)
    bits = lambda a: a.view(torch.int32)
    assert torch.equal(bits(got), bits(BK.test_clusters(rays, ts.clus_pack, *slots, c, k, T_MIN, every)))
    want = np.asarray(PB.test_clusters_pallas(
        jnp.asarray(rays.numpy()), js.clus_pack, *(jnp.asarray(a.numpy()) for a in slots), c, k, T_MIN,
        interpret=True))
    tri_g, tri_w = got.numpy()[:, 4].view(np.int32), want[:, 4].view(np.int32)
    np.testing.assert_array_equal(tri_g >= 0, tri_w >= 0)
    assert ((tri_g == tri_w) & (tri_g >= 0)).sum() >= 0.999 * (tri_g >= 0).sum()
    np.testing.assert_allclose(got.numpy()[:, 0], want[:, 0], rtol=2e-5, atol=2e-5)
    poisoned = ts.clus_pack.clone()
    n_clus = poisoned.shape[0]
    for i in range(n_clus):
        n = int(counts[i])
        for p in range(3):  # the n, eu, ev column blocks of rows 0-3
            poisoned[i, 0:4, p * c + n : (p + 1) * c] = ts.clus_pack[(i + 1) % n_clus, 0:4, p * c : p * c + c - n]
    assert torch.equal(bits(BK.test_clusters(rays, poisoned, *slots, c, k, T_MIN, counts)), bits(got))
    if not windowed:  # at round 1 (t_cur = 100) some ray meets a poisoned column with every count C
        assert not torch.equal(bits(BK.test_clusters(rays, poisoned, *slots, c, k, T_MIN, every)), bits(got))


@pytest.mark.parametrize("n", [2048, 1000])  # 1000: not a multiple of the 128-ray block
def test_closest_hit_vs_jax_brute_and_fused(case, n):
    js, jm, ts, tm, o, d = case
    o, d = o[:n].copy(), d[:n].copy()
    trace = []
    TBT.LEGACY.reset()
    got = _port(ts, tm, o, d, 100.0, trace=trace)
    assert TBT.LEGACY.calls == 1 and TBT.LEGACY.rounds == len(trace) >= 2
    assert trace[0] == -(-n // BK.BLOCK)  # every block active in round 1
    _check(got, _jax(js, jm, o, d, 100.0), 2e-5, 1e-3)
    _check(got, _brute(js, jm, o, d, 100.0), 2e-5, 1e-3)
    assert 0.1 < got["mask"].mean() < 0.9
    # The diagnostics: live slots tested by the ray's block, C triangles each.
    assert (got["n_ct"] >= 1).all() and (got["n_tt"] == tm.cluster_size * got["n_ct"]).all()
    # The port's fused path: the same t on every lane.
    t, _, _, _, tri, _, _ = TBT.intersect_blocktrace(ts, tm, T(o), T(d), 100.0)
    np.testing.assert_array_equal(got["mask"], (tri >= 0).numpy())
    np.testing.assert_array_equal(got["t"].view(np.int32), t.numpy().view(np.int32))


def test_nee_any_hit(case):
    js, jm, ts, tm, o, d = case
    got = _port(ts, tm, o, d, 8.0, nee=True)
    np.testing.assert_array_equal(got["mask"], _jax(js, jm, o, d, 8.0, nee=True)["mask"])
    np.testing.assert_array_equal(got["mask"], _brute(js, jm, o, d, 8.0, nee=True)["mask"])


def test_floor(case):
    """A second cast with floor = the first hit's t, each side from its own
    first t (an ulp of difference would otherwise let one side hit its
    first triangle again)."""
    js, jm, ts, tm, o, d = case
    first = _port(ts, tm, o, d, 100.0)
    got = _port(ts, tm, o, d, 100.0, floor=T(first["t"]))
    j_first = JBT.intersect_blocktrace(js, jm, jnp.asarray(o), jnp.asarray(d), 100.0, fused=False,
                                       interpret=True)
    _check(got, _jax(js, jm, o, d, 100.0, floor=j_first.t), 2e-5, 1e-3)
    m2 = got["mask"]
    assert m2.any() and (got["t"][m2] > first["t"][m2]).all()
    assert not (m2 & ~first["mask"]).any()


def test_window_overflow_small_k(case):
    """k = 2 forces many continuation rounds: still the JAX path's and the
    oracle's hits, and the fused path's t on every lane."""
    js, jm, ts, tm, o, d = case
    trace = []
    got = _port(ts, tm, o, d, 100.0, k=2, max_rounds=512, trace=trace)
    assert 8 <= len(trace) < 512
    _check(got, _jax(js, jm, o, d, 100.0, k=2, max_rounds=512), 2e-5, 1e-3)
    _check(got, _brute(js, jm, o, d, 100.0), 2e-5, 1e-3)
    t, _, _, _, tri, _, _ = TBT.intersect_blocktrace(ts, tm, T(o), T(d), 100.0)
    np.testing.assert_array_equal(got["mask"], (tri >= 0).numpy())
    np.testing.assert_array_equal(got["t"].view(np.int32), t.numpy().view(np.int32))


@pytest.fixture(scope="module")
def textured_box():
    """tests/test_blocktrace.py `_gated_fixture`: the JAX-built textured
    box and 512 seeded rays toward its panels."""
    js, jm = j_textured_box().compile()
    rng = np.random.default_rng(9)
    n = 512
    o = np.asarray([0.0, 1.2, 3.0], np.float32) + rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] -= 1.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    seed = rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
    return js, jm, *_carry(js, jm), o, d, seed


@pytest.mark.parametrize("nee,t_max", [(False, 100.0), (True, 6.0)])
def test_gated_legacy_equals_jax(textured_box, nee, t_max):
    js, jm, ts, tm, o, d, seed = textured_box
    fields = ("mask", "t", "tri", "attenuation")
    TBT.LEGACY.reset()
    h = TBT.intersect_blocktrace_gated(ts, tm, T(o), T(d), t_max, nee=nee, alpha_seed=T(seed.astype(np.int64)),
                                       fused=False)
    assert TBT.LEGACY.calls >= 1
    got = {f: getattr(h, f).numpy() for f in fields}
    hj = JBT.intersect_blocktrace_gated(js, jm, jnp.asarray(o), jnp.asarray(d), t_max, nee=nee,
                                        alpha_seed=jnp.asarray(seed), fused=False, interpret=True)
    want = {f: np.asarray(getattr(hj, f)) for f in fields}
    np.testing.assert_array_equal(got["mask"], want["mask"])
    m = got["mask"]
    assert 0.05 < m.mean() < 0.95
    if nee:
        un = ~m  # the attenuation contract: unblocked shadow rays only
        np.testing.assert_allclose(got["attenuation"][un], want["attenuation"][un], rtol=1e-4, atol=1e-5)
        assert (got["attenuation"][un] < 1.0).any()  # some pass the thin glass
    else:
        np.testing.assert_allclose(got["t"][m], want["t"][m], rtol=2e-5, atol=2e-5)
        assert ((got["tri"] == want["tri"]) & m).sum() >= 0.995 * m.sum()


def test_refusals(case):
    _, _, ts, tm, o, d = case
    o, d = T(o[:256].copy()), T(d[:256].copy())
    with pytest.raises(ValueError, match="no instanced support"):
        TBT.intersect_blocktrace(ts, dataclasses.replace(tm, n_instances=2), o, d, 100.0, fused=False)
    with pytest.raises(ValueError, match="amask=True"):
        TBT.intersect_blocktrace(ts, tm, o, d, 100.0, fused=False, amask=True)
    info = TBT.fused_order(ts, tm, o, d, torch.full((256,), 100.0), torch.zeros(256), T_MIN)
    with pytest.raises(ValueError, match="order_info"):
        TBT.intersect_blocktrace(ts, tm, o, d, 100.0, fused=False, order_info=info)
