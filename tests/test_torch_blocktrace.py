"""The port's block trace (B2 presort + B3 fused trace, plain twins on the
CPU) against the JAX package's Pallas kernels in interpret mode and the
brute-force oracle, on the scene of tests/test_blocktrace.py (a seeded
soup of 1400 triangles in clusters of 64, built by the JAX builder and
carried over with `from_numpy`).

Tolerances:
- B2 rows are integers: >= 99.9% of rows match exactly, the rest by an
  ulp of an entry (XLA:CPU's FMA contraction), with the same cluster ids.
- Against the JAX fused kernel (the same plane test): masks equal, t
  within rtol/atol 2e-5 (XLA:CPU contracts to FMA), tri equal on >= 99.9% of hits (the JAX kernel
  breaks bit-equal t across clusters by its visit order, the port by the
  lowest triangle index).
- Against the Moller-Trumbore brute oracle, tests/test_blocktrace.py's
  bar: masks equal, t within 2e-5, tri on >= 99.9% of hits, u/v within
  1e-3 and back_side equal where tri agrees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_bintrace import _compile, _random_mesh, _rays
from test_torch_cuda import tie_rays, tie_soup
from yart_tpu.kernels.pallas_fusedtrace import presort_keys_pallas
from yart_tpu.render import blocktrace as JBT
from yart_tpu.render.intersect import intersect_brute as j_brute
from yart_tpu_torch.kernels import fusedtrace, presort
from yart_tpu_torch.render import blocktrace as TBT
from yart_tpu_torch.render import intersect as TI
from yart_tpu_torch.scene.convert import from_numpy

torch.set_num_threads(2)
T = torch.from_numpy


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(5)
    pos, tri = _random_mesh(rng, 700)
    js, jm = _compile(pos, tri, cluster_size=64)
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    o, d = _rays(rng, 2048)
    assert tm.n_clusters > 8
    return js, jm, ts, tm, np.array(o), np.array(d)


def _port(ts, tm, o, d, t_max, **kw):
    o, d = np.ascontiguousarray(o), np.ascontiguousarray(d)
    t, u, v, back, tri, n_ct, n_tt = TBT.intersect_blocktrace(ts, tm, T(o), T(d), t_max, **kw)
    return dict(mask=(tri >= 0).numpy(), t=t.numpy(), u=u.numpy(), v=v.numpy(),
                back_side=back.numpy(), tri=tri.numpy(), n_ct=n_ct.numpy(), n_tt=n_tt.numpy())


def _as_np(h):
    return {f: np.asarray(getattr(h, f)) for f in ("mask", "t", "u", "v", "back_side", "tri")}


def _check(port, ref, t_tol, uv_tol):
    m = port["mask"]
    np.testing.assert_array_equal(m, ref["mask"])
    np.testing.assert_allclose(port["t"][m], ref["t"][m], rtol=t_tol, atol=t_tol)
    same = (port["tri"] == ref["tri"]) & m
    assert same.sum() >= 0.999 * m.sum()
    for f in ("u", "v"):
        np.testing.assert_allclose(port[f][same], ref[f][same], rtol=uv_tol, atol=uv_tol, err_msg=f)
    np.testing.assert_array_equal(port["back_side"][same], ref["back_side"][same])


def test_presort_equals_pallas(case):
    js, jm, ts, tm, o, d = case
    n = o.shape[0]
    t_max = np.full((n + 128, 1), 100.0, np.float32)
    t_max[n:] = -1.0  # a block of retired lanes
    floor = np.zeros_like(t_max)
    floor[n // 2 : n] = 2.0
    rays = np.concatenate([np.concatenate([o, o[:128]]), np.concatenate([d, d[:128]]), t_max, floor], axis=1)
    want = np.asarray(presort_keys_pallas(jnp.asarray(rays), js.clus_box, jm.n_clusters, 1e-3, interpret=True))
    got = presort.presort_keys(T(rays), ts.clus_box, tm.n_clusters, 1e-3).numpy()
    # XLA:CPU may contract the slab test's multiply-subtract into an FMA, so
    # an entry can differ by an ulp: the packed key's entry bits then move
    # by one step. Rows agree exactly on >= 99.9% of lanes, cluster ids on
    # every slot of those that differ only so.
    rows_eq = (got == want).all(axis=1)
    assert rows_eq.mean() >= 0.999, rows_eq.mean()
    off = ~rows_eq
    np.testing.assert_array_equal(got[off][:, 1:5] & presort.ID_MASK, want[off][:, 1:5] & presort.ID_MASK)
    assert (np.abs(got[off][:, 1:5].astype(np.int64) - want[off][:, 1:5]) <= 1 << presort.ID_BITS).all()
    assert (got[n:, 0] == presort.SKEY_NOTHING).all() and (got[n:, 1:5] == presort.KEY_DEAD).all()
    assert (got[:n, 5] > 1).mean() > 0.2  # rays enter several clusters


@pytest.mark.parametrize("n", [2048, 1000])  # 1000: not a multiple of the 128-ray block
def test_closest_hit_vs_pallas_and_brute(case, n):
    js, jm, ts, tm, o, d = case
    o, d = o[:n].copy(), d[:n].copy()
    port = _port(ts, tm, o, d, 100.0)
    jax_bt = _as_np(JBT.intersect_blocktrace(js, jm, jnp.asarray(o), jnp.asarray(d), 100.0, interpret=True))
    _check(port, jax_bt, 2e-5, 1e-5)
    _check(port, _as_np(j_brute(js, jm, jnp.asarray(o), jnp.asarray(d), 100.0)), 2e-5, 1e-3)
    assert 0.1 < port["mask"].mean() < 0.9
    # The diagnostics: every hit tested its cluster's triangles.
    assert (port["n_ct"][port["mask"]] >= 1).all() and (port["n_tt"] <= 64 * port["n_ct"]).all()


def test_nee_any_hit(case):
    js, jm, ts, tm, o, d = case
    port = _port(ts, tm, o, d, 8.0, nee=True)
    jax_bt = JBT.intersect_blocktrace(js, jm, jnp.asarray(o), jnp.asarray(d), 8.0, nee=True, interpret=True)
    np.testing.assert_array_equal(port["mask"], np.asarray(jax_bt.mask))
    ref = j_brute(js, jm, jnp.asarray(o), jnp.asarray(d), 8.0, nee=True)
    np.testing.assert_array_equal(port["mask"], np.asarray(ref.mask))


def test_floor(case):
    """A second cast with floor = the first hit's t finds the same hits as
    the JAX pipeline, all strictly behind the first. Each side takes its
    own first t as the floor: an ulp of difference would otherwise let one
    side hit its first triangle again."""
    js, jm, ts, tm, o, d = case
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    first = _port(ts, tm, o, d, 100.0)
    port = _port(ts, tm, o, d, 100.0, floor=torch.from_numpy(first["t"]))
    j_first = JBT.intersect_blocktrace(js, jm, jo, jd, 100.0, interpret=True)
    jax_bt = JBT.intersect_blocktrace(js, jm, jo, jd, 100.0, floor=j_first.t, interpret=True)
    _check(port, _as_np(jax_bt), 2e-5, 1e-5)
    m2 = port["mask"]
    assert m2.any() and (port["t"][m2] > first["t"][m2]).all()
    assert not (m2 & ~first["mask"]).any()


def test_per_ray_result_is_order_free(case):
    """Reversing the lanes reverses the result bit for bit: the sort is
    scheduling only, and the tie rule does not depend on visit order."""
    _, _, ts, tm, o, d = case
    a = _port(ts, tm, o, d, 100.0)
    b = _port(ts, tm, o[::-1], d[::-1], 100.0)
    for f in ("t", "u", "v", "tri", "back_side"):
        np.testing.assert_array_equal(a[f], b[f][::-1], err_msg=f)


def test_dispatcher_routes_big_scenes_to_blocktrace(case, monkeypatch):
    """Over 4096 triangles the dispatcher takes the block trace, with
    shadow rays as any-hit queries; below, B1."""
    _, _, ts, tm, o, d = case
    want = _port(ts, tm, o, d, 8.0, nee=True)["mask"]
    calls = []
    real = TBT.intersect_blocktrace
    monkeypatch.setattr(TBT, "intersect_blocktrace",
                        lambda *a, **k: calls.append(k.get("nee", a[6] if len(a) > 6 else False)) or real(*a, **k))
    big = dataclasses.replace(tm, n_tris=5000)  # same tables, over B1's cap
    t_max = torch.full((o.shape[0],), 8.0)
    h = TI.intersect(ts, big, T(o), T(d), t_max, nee=True)
    assert calls == [True]
    np.testing.assert_array_equal(h.mask.numpy(), want)
    TI.intersect(ts, tm, T(o), T(d), t_max)
    assert calls == [True]  # 1400 triangles: B1
    assert presort.COUNTS.plain_cuda == fusedtrace.COUNTS.plain_cuda == 0


def test_tie_fixture_has_bit_equal_ties():
    """The card tests' tie fixture (tests/test_torch_cuda.py `tie_soup`,
    clusters of 64), built by the JAX builder and carried over: on rays
    through its stack the plane test gives bit-equal t in different lanes,
    different 32-column rounds and two clusters, so the card's tie cases
    are not vacuous. The port's twin names the lowest copy and agrees with
    the brute-force oracle (tests/test_blocktrace.py's bar)."""
    pos, tri = tie_soup()
    js, jm = _compile(pos, tri, cluster_size=64)
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    o, d = tie_rays(1024)
    port = _port(ts, tm, o, d, 100.0)
    _check(port, _as_np(j_brute(js, jm, jnp.asarray(o), jnp.asarray(d), 100.0)), 2e-5, 1e-3)
    # Every column's plane-test t (the twin's arithmetic), cluster by cluster.
    pack, counts = ts.clus_pack, TBT.cluster_counts(ts, tm).tolist()
    c = pack.shape[2] // 3
    ot, dt = T(o), T(d)
    ts_, ids, cols = [], [], []
    for k, cnt in enumerate(counts):
        rows = torch.cat([pack[k, :, 0:cnt], pack[k, :, c : c + cnt], pack[k, :, 2 * c : 2 * c + cnt]], dim=1)
        ro = ot[:, 0:1] * rows[0][None] + ot[:, 1:2] * rows[1][None] + ot[:, 2:3] * rows[2][None]
        rd = dt[:, 0:1] * rows[0][None] + dt[:, 1:2] * rows[1][None] + dt[:, 2:3] * rows[2][None]
        t = (rows[3, :cnt][None] - ro[:, :cnt]) / rd[:, :cnt]
        u = ro[:, cnt : 2 * cnt] + t * rd[:, cnt : 2 * cnt] - rows[3, cnt : 2 * cnt][None]
        v = ro[:, 2 * cnt :] + t * rd[:, 2 * cnt :] - rows[3, 2 * cnt :][None]
        ok = (rd[:, :cnt].abs() >= 1e-12) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-3)
        ts_.append(torch.where(ok, t, float("inf")))
        first = int(pack[k, 4, 0].view(torch.int32))
        ids.append(torch.arange(first, first + cnt))
        cols.append(torch.stack([torch.full((cnt,), k), torch.arange(cnt)], dim=1))
    t_all, ids, cols = torch.cat(ts_, dim=1), torch.cat(ids), torch.cat(cols)
    tmin = t_all.min(dim=1, keepdim=True).values
    tied = (t_all == tmin) & torch.isfinite(tmin)
    many = tied.sum(dim=1) >= 2
    assert many.sum() >= 250  # the rays through the stack (the others meet the soup or nothing)
    for r in torch.nonzero(many)[:, 0][:50].tolist():
        kc = cols[tied[r]]
        assert kc[:, 0].unique().numel() == 2  # two clusters
        assert (kc[:, 1] % 32).unique().numel() >= 2 and (kc[:, 1] // 32).unique().numel() == 2  # lanes, rounds
        assert port["tri"][r] == int(ids[tied[r]].min()) and port["t"][r] == float(tmin[r, 0])
