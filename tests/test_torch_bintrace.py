"""The port's bin-trace against the JAX package's, on the CPU.

JAX builds its scenes on its numpy BVH path, and each JAX scene reaches
the port through `from_numpy`.

Checks and tolerances:
- `collapse_bvh8` and `build_coarse` (wide_pack, depth, max_leaf, the
  permuted cut) bit-equal to the JAX functions, on a quad soup and on trees
  whose root is a leaf;
- the collect loop's vectorised stages of Batcher's network permute as the
  JAX module's list of 19 compare-exchanges does, ties included;
- B4's twin `cluster_pairs_plain` on the port's tile layout against
  `cluster_pairs_ref` on the same pairs in the JAX blocks (padded with
  empty rows, a dead block), per pair, bitwise on t and tri (and u, v and
  back on hits), with short clusters, clusters of 1, TILE and TILE + 1
  pairs and pairs that cannot hit; against
  `cluster_pairs_pallas(interpret=True)` at
  the JAX package's own bar between those two (tests/test_bintrace.py:
  84-124): tri on >= 99.9% of pairs, t within rtol/atol 1e-5, u and v
  within 1e-5 where tri agrees, back equal there (interpret mode contracts the
  projections o0*n0 + o1*n1 + o2*n2 to FMAs under XLA:CPU; the twin, like
  the CUDA kernel built with --fmad=false, does not);
- `collect_clusters` over three chained rounds (each side fed its own
  bounds), k = 12 and k = 2: slots, n_col and bound_id equal, bound_e
  within rtol/atol 1e-5 (XLA:CPU contracts the slab test box*idir + odir
  to an FMA, so entry distances differ by rounding; every differing lane
  is counted);
- `intersect_bintrace` at k = 12, at k = 2 (forced overflow rounds), on
  the tied-entry grid of tests/test_bintrace.py:170-206 and with nee:
  mask, tri and back equal, t, u and v within rtol/atol 1e-5;
- dispatch: a quad soup past 8192 clusters (C = 4; `from_numpy` carries
  its coarse tables bit for bit) goes through the real `intersect` to
  bin-trace (the brute twin's closest hits agree); with alpha gates it
  takes the stack traversal instead, with the same hits;
- a 24x24, 2 spp, depth 2 env-lit render (one wave) of that soup against
  the JAX Renderer (which takes bin-trace on the CPU for any ungated scene
  past 4096 triangles) at the port's image bar: >= 95% of pixels within
  rtol 1e-4 / atol 1e-5, channel means within 0.5%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yart_tpu.native
from test_bintrace import _random_mesh
from yart_tpu.config import CameraConfig as JCam
from yart_tpu.config import RenderConfig as JCfg
from yart_tpu.kernels.pallas_cluster import B_PAIRS, cluster_pairs_pallas, cluster_pairs_ref
from yart_tpu.render import bintrace as JBT
from yart_tpu.render.renderer import Renderer as JRenderer
from yart_tpu.scene import bvh as JB
from yart_tpu.scene import clusters as JCl
from yart_tpu.scene.builder import SceneBuilder as JSB
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.kernels import clusterpairs
from yart_tpu_torch.render import bintrace as TBT
from yart_tpu_torch.render import blocktrace
from yart_tpu_torch.render import intersect as TIn
from yart_tpu_torch.render import stacktrace as TST
from yart_tpu_torch.render.renderer import Renderer
from yart_tpu_torch.scene import bvh as TB
from yart_tpu_torch.scene import clusters as TCl
from yart_tpu_torch.scene.convert import from_numpy

torch.set_num_threads(2)
T = lambda a: torch.from_numpy(np.array(a))


def _eq(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, msg
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=msg)


def _builder(cls, pos, tri, env=False):
    b = cls()
    b.add_mesh(pos, tri, b.add_material(roughness=0.5))
    if env:
        b.set_env_uniform((0.6, 0.6, 0.6))
    return b


def _jax_compile(builder, **kw):
    """The JAX builder on its numpy BVH path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(yart_tpu.native, "build_bvh_native", lambda *a, **k: None)
        return builder.compile(**kw)


def _both(pos, tri, cluster_size=128):
    """(JAX scene, JAX meta, the port's scene and meta from it)."""
    js, jm = _jax_compile(_builder(JSB, pos, tri), cluster_size=cluster_size)
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    return js, jm, ts, tm


def _rays(rng, n, spread=6.0):
    o = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _tied_grid():
    """tests/test_bintrace.py:170-206: 40 stacked layers of 4x4 axis-aligned
    quads and 256 rays along ~+z, every layer box at a tied entry."""
    rng = np.random.default_rng(4)
    quads, tris, nv = [], [], 0
    for zi in range(40):
        for gx in range(4):
            for gy in range(4):
                x0, y0, z = gx - 2.0, gy - 2.0, 0.1 * zi
                quads.append([(x0, y0, z), (x0 + 1, y0, z), (x0 + 1, y0 + 1, z), (x0, y0 + 1, z)])
                tris.append([(nv, nv + 1, nv + 2), (nv, nv + 2, nv + 3)])
                nv += 4
    pos = np.asarray(quads, np.float32).reshape(-1, 3)
    tri = np.asarray(tris, np.int32).reshape(-1, 3)
    n = 256
    o = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), np.full(n, -1.0)], axis=1).astype(np.float32)
    d = np.tile(np.asarray([[0.005, 0.005, 1.0]], np.float32), (n, 1))
    return pos, tri, o, d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def soup():
    rng = np.random.default_rng(2)
    pos, tri = _random_mesh(rng, 1500)  # 3,000 triangles, 34 clusters of <= 128
    return _both(pos, tri)


@pytest.fixture(scope="module")
def big():
    """12,400 quads in a slab 32 wide and 3.2 deep, at C = 4: 24,800
    triangles in 8,252 clusters, past the block trace's 8192, under a
    uniform env."""
    pos, tri = _random_mesh(np.random.default_rng(7), 12400, spread=16.0)
    pos[:, 2] *= 0.1
    js, jm = _jax_compile(_builder(JSB, pos, tri, env=True), cluster_size=4)
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    return js, jm, ts, tm


@pytest.mark.parametrize("case", ["soup", "root_leaf"])
def test_coarse_tables_equal_jax(case):
    rng = np.random.default_rng(5)
    pos, tri = _random_mesh(rng, 700 if case == "soup" else 1)
    v = [pos[tri[:, i]] for i in range(3)]
    hb = JB.build_bvh(*v)  # the root of a 2-triangle tree is a leaf
    j8, t8 = JB.collapse_bvh8(hb), TB.collapse_bvh8(hb)
    _eq(t8.boxes, j8.boxes, "boxes")
    _eq(t8.child, j8.child, "child")
    assert t8.depth == j8.depth
    assert (t8.depth == 1) == (case == "root_leaf")
    # The coarse tree over clusters (C = 64): its root is a leaf when the
    # cut has at most coarse max_leaf = 2 clusters.
    cut = JCl.cut_clusters(hb, 64)
    assert (cut.first.shape[0] <= 2) == (case == "root_leaf")
    jc, tc = JCl.build_coarse(cut), TCl.build_coarse(cut)
    _eq(tc.wide_pack, jc.wide_pack, "wide_pack")
    assert (tc.depth, tc.max_leaf) == (jc.depth, jc.max_leaf)
    for f in TCl.ClusterCut._fields:
        _eq(getattr(tc.cut, f), getattr(jc.cut, f), f)


def test_sort8_stages_equal_the_network():
    """The collect loop runs Batcher's 19 compare-exchanges (`_SORT8`, the
    JAX module's list) as six vectorised stages; on keys with many ties the
    stages must permute exactly as the list does."""
    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.integers(0, 3, (4096, 8)).astype(np.float32))
    e = torch.arange(8, dtype=torch.int32).repeat(4096, 1)
    dc, ec = list(d.unbind(1)), list(e.unbind(1))
    for i, j in TBT._SORT8:
        sw = dc[i] > dc[j]
        dc[i], dc[j] = torch.where(sw, dc[j], dc[i]), torch.where(sw, dc[i], dc[j])
        ec[i], ec[j] = torch.where(sw, ec[j], ec[i]), torch.where(sw, ec[i], ec[j])
    TBT.sort8(d, e)
    assert torch.equal(torch.stack(dc, 1), d) and torch.equal(torch.stack(ec, 1), e)


def test_pair_twin_equals_jax(soup):
    """The same seeded pairs laid out both ways: compactly, one row a pair
    in the port's tiles (clusters of 1, TILE, TILE + 1 and 3 TILE + 5
    pairs), and in the JAX kernels' blocks of B_PAIRS rows padded with
    empty rows, with a dead block; compared per pair."""
    js, jm, ts, tm = soup
    rng = np.random.default_rng(1)
    tile = clusterpairs.TILE
    sizes = [1, tile, tile + 1, 3 * tile + 5, 129]
    cids = rng.choice(jm.n_clusters, size=len(sizes), replace=False).astype(np.int32)
    counts = np.diff(np.append(np.sort(np.asarray(js.clus_first)), jm.n_tris))
    assert counts.min() < jm.cluster_size  # short clusters: zero padding columns
    n_pairs = sum(sizes)
    o, d = _rays(rng, n_pairs)
    tmax = np.full((n_pairs, 1), 100.0, np.float32)
    tmax[::7] = 0.0  # live pairs that cannot hit (tmax <= t_min)
    x = np.concatenate([o, d, tmax, np.zeros((n_pairs, 1), np.float32)], axis=1)
    pair_cid = np.repeat(cids, sizes)
    tiles = TBT.tile_table(T(pair_cid), ts.clus_first, tile)
    assert tiles[:, 3].max() == tile and int(tiles[:, 3].sum()) == n_pairs
    args = (jm.cluster_size, 1e-3)
    counts = blocktrace.cluster_counts(ts, tm)
    assert counts.min() < jm.cluster_size  # B4 tests each cluster's triangles, not its zero columns
    got = [a.numpy() for a in clusterpairs.cluster_pairs(T(ts.clus_pack), counts, tiles, T(x), *args)]
    hit = got[4] >= 0
    assert 0.01 < hit.mean() < 0.5
    assert (got[0][~hit] == np.float32(3e38)).all()
    assert (got[1][~hit] == 0).all() and (got[2][~hit] == 0).all() and not got[3][~hit].any()

    # The JAX layout: a block of B_PAIRS rows per cluster, the rest empty
    # rows (tmax 0), and one dead block.
    n_blocks = len(sizes) + 1
    xp = np.zeros((n_blocks * B_PAIRS, 8), np.float32)
    pos = np.concatenate([b * B_PAIRS + np.arange(n) for b, n in enumerate(sizes)])
    xp[pos] = x
    xp[len(sizes) * B_PAIRS :] = np.concatenate([*_rays(rng, B_PAIRS), x[:B_PAIRS, 6:]], axis=1)
    cid = np.append(cids, cids[0]).astype(np.int32)
    live = np.append(np.ones(len(sizes), np.int32), 0).astype(np.int32)
    first = np.asarray(js.clus_first)[cid]
    jargs = (js.clus_pack, jnp.asarray(cid), jnp.asarray(first), jnp.asarray(live), jnp.asarray(xp))
    ref = [np.asarray(a)[pos] for a in cluster_pairs_ref(*jargs, *args)]
    _eq(got[4], ref[4], "tri")
    _eq(got[0], ref[0], "t")
    for i, name in ((1, "u"), (2, "v"), (3, "back")):  # JAX leaves column 0's values on a miss
        _eq(got[i][hit], ref[i][hit], name)

    pal = [np.asarray(a) for a in cluster_pairs_pallas(*jargs, *args, interpret=True)]
    assert (pal[4][len(sizes) * B_PAIRS :] == -1).all()  # the dead block
    pal = [a[pos] for a in pal]
    same = got[4] == pal[4]
    assert same.mean() >= 0.999
    np.testing.assert_allclose(got[0], pal[0], rtol=1e-5, atol=1e-5)
    both = same & hit
    for i in (1, 2):
        np.testing.assert_allclose(got[i][both], pal[i][both], rtol=1e-5, atol=1e-5)
    _eq(got[3][both], pal[3][both], "back")


@pytest.mark.parametrize("k", [12, 2])
def test_collect_equals_jax(soup, k):
    js, jm, ts, tm = soup
    o, d = _rays(np.random.default_rng(3), 1024)
    n = o.shape[0]
    t_cur = np.full(n, 100.0, np.float32)
    t_cur[:64] = -1.0  # retired lanes
    jw = (jnp.full(n, -1.0, jnp.float32), jnp.full(n, -1, jnp.int32))
    tw = (torch.full((n,), -1.0), torch.full((n,), -1, dtype=torch.int32))
    active = np.ones(n, bool)
    active[64:96] = False
    for rnd in range(3):
        jr = [np.asarray(a) for a in JBT.collect_clusters(js, jm, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_cur),
                                                          1e-3, *jw, jnp.asarray(active), k)]
        tr = TBT.collect_clusters(ts, tm, T(o), T(d), T(t_cur), 1e-3, *tw, T(active), k)
        for name, a, b in zip(("slots", "n_col", "bound_id"), (jr[0], jr[1], jr[3]), (tr[0], tr[1], tr[3])):
            _eq(b.numpy(), a, f"round {rnd} {name}")
        np.testing.assert_allclose(tr[2].numpy(), jr[2], rtol=1e-5, atol=1e-5)
        jw, tw = (jnp.asarray(jr[2]), jnp.asarray(jr[3])), (tr[2], tr[3])
    assert (jr[1] > 0).any() and (tr[0][:96] == -1).all()


@pytest.mark.parametrize("case", ["random_k12", "overflow_k2", "tied_k2", "nee_k4"])
def test_intersect_bintrace_equals_jax(soup, case):
    if case == "tied_k2":
        pos, tri, o, d = _tied_grid()
        js, jm, ts, tm = _both(pos, tri)
    else:
        js, jm, ts, tm = soup
        o, d = _rays(np.random.default_rng(6), 2048 if case == "random_k12" else 256)
    k = {"random_k12": 12, "overflow_k2": 2, "tied_k2": 2, "nee_k4": 4}[case]
    nee = case == "nee_k4"
    t_max = 50.0 if nee else 100.0
    TBT.COUNTS.reset()
    th = TBT.intersect_bintrace(ts, tm, T(o), T(d), t_max, k=k, nee=nee)
    jh = JBT.intersect_bintrace(js, jm, jnp.asarray(o), jnp.asarray(d), t_max, k=k, nee=nee)
    assert TBT.COUNTS.calls == 1 and TBT.COUNTS.rounds >= (2 if case == "overflow_k2" else 1)
    m = np.asarray(jh.mask)
    assert m.mean() > 0.05 and (case == "tied_k2" or m.mean() < 0.98)
    for f in ("mask", "tri", "back_side"):
        _eq(getattr(th, f).numpy(), np.asarray(getattr(jh, f)), f)
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(th, f).numpy(), np.asarray(getattr(jh, f)), rtol=1e-5, atol=1e-5,
                                   err_msg=f)
    _eq(th.attenuation.numpy(), np.ones((o.shape[0], 3), np.float32), "attenuation")


def test_dispatch_routes_past_the_cap_to_bintrace(big):
    js, jm, ts, tm = big
    assert tm.n_clusters > blocktrace.MAX_CLUSTERS and tm.n_tris > 4096
    _eq(ts.coarse_pack.numpy(), np.asarray(js.coarse_pack), "coarse_pack")
    assert (tm.coarse_depth, tm.coarse_max_leaf, tm.bintrace_k) == \
        (jm.coarse_depth, jm.coarse_max_leaf, jm.bintrace_k)
    o, d = _rays(np.random.default_rng(8), 256, spread=16.0)
    t_max = torch.full((256,), 100.0)
    TBT.COUNTS.reset()
    h = TIn.intersect(ts, tm, T(o), T(d), t_max)
    assert TBT.COUNTS.calls == 1 and h.mask.any()
    ref = TIn.intersect_brute(ts, tm, T(o), T(d), t_max)
    _eq(h.mask.numpy(), ref.mask.numpy(), "mask")
    np.testing.assert_allclose(h.t.numpy(), ref.t.numpy(), rtol=2e-4, atol=2e-4)  # plane vs Moller-Trumbore
    assert (h.tri == ref.tri).float().mean() >= 0.995
    # The same scene gated (alpha on, no material with an alpha texture, so
    # every hit passes) takes the stack traversal, with the same hits.
    gated = dataclasses.replace(tm, any_alpha=True)
    TST.COUNTS.reset()
    hg = TIn.intersect(ts, gated, T(o), T(d), t_max)
    assert TST.COUNTS.calls == 1 and TBT.COUNTS.calls == 1
    _eq(hg.mask.numpy(), ref.mask.numpy(), "mask")
    np.testing.assert_allclose(hg.t.numpy(), ref.t.numpy(), rtol=2e-5, atol=2e-5)
    assert (hg.tri == ref.tri).float().mean() >= 0.995


def test_render_matches_jax_renderer(big):
    js, jm, ts, tm = big
    kw = dict(image_size=(24, 24), focal_length=30.0, position=(0.0, 0.0, 35.0), forward=(0.0, 0.0, -1.0))
    cfg = dict(samples=2, max_depth=2, estimator="mean", first_wave_samples=2, max_wave_samples=2)
    TBT.COUNTS.reset()
    img = Renderer(ts, tm, CameraConfig(**kw), RenderConfig(**cfg), device="cpu").render().hdr
    assert TBT.COUNTS.calls > 0
    ref = np.asarray(JRenderer(js, jm, JCam(**kw), JCfg(**cfg)).render().hdr)
    assert img.shape == ref.shape and np.isfinite(img).all() and img.mean() > 0.01
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)), rtol=5e-3)
