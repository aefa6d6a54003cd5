"""The port's gated intersection paths against the JAX package, on the CPU.

- The gated brute (`intersect_brute` with gates, plain PyTorch) against
  the JAX `intersect_brute` on tests/test_blocktrace.py's textured-box rays,
  for alpha-tested primary rays and NEE-transparent shadow rays, at that
  file's bar: masks equal, t within 2e-5, tri equal on >= 99.5% of hits,
  unoccluded shadow attenuation within rtol 1e-4 / atol 1e-5.
- B3's `amask` mode (plain twin) against `fused_trace_pallas(amask=True)`
  in interpret mode, through each side's `intersect_blocktrace`, and the
  gated re-cast loop `intersect_blocktrace_gated` against the JAX one, on a
  small ivy fixture (300 leaf quads under `leaf_texture()` over a floor, 14
  clusters of 64, 2048 rays), with tests/test_torch_blocktrace.py's
  tolerances; the per-cast active counts of the loop equal the JAX loop's
  cast by cast. The alpha-mask cull changes single casts (culled hits lie
  on alpha-zero texels) but leaves the gated result bit-identical.
- Images: golden_v1 `textured` (48x48, 16 spp, depth 5, mean estimator;
  every texture channel class, the alpha cutout and thin-glass shadows)
  from the JAX-built scene through `from_numpy` at the `cornell_mat` bar
  (>= 95% of pixels within rtol 1e-4 / atol 1e-5, channel means within
  0.5%), and from the port-built scene with channel means within 2%.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_blocktrace import _check
from yart_tpu.render import blocktrace as JBT
from yart_tpu.render.intersect import intersect_brute as j_brute
from yart_tpu.scene.builder import SceneBuilder
from yart_tpu.scene.procedural import textured_box_scene as j_textured_box
from yart_tpu.scene.showcase import leaf_texture
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.kernels import brute, fusedtrace, presort
from yart_tpu_torch.render import blocktrace as TBT
from yart_tpu_torch.render import intersect as TI
from yart_tpu_torch.render.renderer import Renderer
from yart_tpu_torch.render.texture import sample_stack
from yart_tpu_torch.scene.convert import from_numpy
from yart_tpu_torch.scene.procedural import textured_box_scene as t_textured_box

torch.set_num_threads(2)
T = torch.from_numpy
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "golden_v1.npz")
TEXTURED_CAM = CameraConfig(image_size=(48, 48), focal_length=26.0, position=(0, 1.6, 3.2),
                            forward=(0, -0.9, -3.0))
TEXTURED_CFG = RenderConfig(samples=16, max_depth=5, tonemap="none", estimator="mean",
                            first_wave_samples=16, max_wave_samples=16)


def _carry(js, jm):
    return from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")


def _fields(h):
    return {f: np.asarray(getattr(h, f)) for f in ("mask", "t", "u", "v", "back_side", "tri", "attenuation")}


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
def test_gated_brute_equals_jax(textured_box, nee, t_max):
    js, jm, ts, tm, o, d, seed = textured_box
    assert tm.any_alpha and tm.any_transparent
    n = o.shape[0]
    got = _fields(TI.intersect_brute(ts, tm, T(o), T(d), torch.full((n,), t_max), nee=nee,
                                     alpha_seed=T(seed.astype(np.int64))))
    want = _fields(j_brute(js, jm, jnp.asarray(o), jnp.asarray(d), t_max, nee=nee,
                           alpha_seed=jnp.asarray(seed)))
    np.testing.assert_array_equal(got["mask"], want["mask"])
    m = got["mask"]
    np.testing.assert_allclose(got["t"][m], want["t"][m], rtol=2e-5, atol=2e-5)
    assert ((got["tri"] == want["tri"]) & m).sum() >= 0.995 * m.sum()
    if nee:
        un = ~m  # the attenuation contract: unblocked shadow rays only
        np.testing.assert_allclose(got["attenuation"][un], want["attenuation"][un], rtol=1e-4, atol=1e-5)
        assert (got["attenuation"][un] < 1.0).any()  # some pass the thin glass
    assert 0.05 < m.mean() < 0.95


def _ivy(q=300):
    """A small ivy: `q` alpha-tested leaf quads (the atrium's leaf texture,
    thin, no transmission) over an opaque floor, clusters of 64."""
    rng = np.random.default_rng(21)
    b = SceneBuilder()
    t = b.add_texture("rgba", leaf_texture())
    m_ivy = b.add_material(roughness=0.9, tex_base=t, has_alpha=True, thin=True)
    m_floor = b.add_material(base_color=(0.5, 0.5, 0.5, 1.0), roughness=0.8)
    c = np.stack([rng.uniform(-2, 2, q), rng.uniform(0.3, 2.0, q), rng.uniform(-2, 2, q)], 1)
    a = rng.uniform(0, np.pi, q)
    s = rng.uniform(0.25, 0.5, q)[:, None]
    du = np.stack([np.cos(a), np.zeros(q), np.sin(a)], 1) * s
    dv = np.stack([np.zeros(q), np.ones(q), np.zeros(q)], 1) * s
    p = np.stack([c - du - dv, c + du - dv, c + du + dv, c - du + dv], 1).reshape(-1, 3)
    idx = (np.asarray([[0, 1, 2], [0, 2, 3]])[None] + 4 * np.arange(q)[:, None, None]).reshape(-1, 3)
    uv = np.tile(np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32), (q, 1))
    b.add_mesh(p, idx, m_ivy, uvs=uv)
    b.add_mesh(np.asarray([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float32),
               [[0, 2, 1], [0, 3, 2]], m_floor)
    return b.compile(cluster_size=64)


@pytest.fixture(scope="module")
def ivy():
    js, jm = _ivy()
    ts, tm = _carry(js, jm)
    assert tm.any_alpha and not tm.any_transparent and tm.n_clusters > 8
    rng = np.random.default_rng(9)
    n = 2048
    o = np.asarray([0.0, 1.2, 5.0], np.float32) + rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    target = np.stack([rng.uniform(-2, 2, n), rng.uniform(0, 2, n), rng.uniform(-2, 2, n)], 1)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    seed = rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
    return js, jm, ts, tm, o, d, seed


def _port_cast(ts, tm, o, d, t_max, **kw):
    t, u, v, back, tri, _, _ = TBT.intersect_blocktrace(ts, tm, T(o), T(d), t_max, **kw)
    return dict(mask=(tri >= 0).numpy(), t=t.numpy(), u=u.numpy(), v=v.numpy(), back_side=back.numpy(),
                tri=tri.numpy())


def test_amask_twin_equals_pallas_and_culls_only_alpha_zero(ivy):
    js, jm, ts, tm, o, d, _ = ivy
    got = _port_cast(ts, tm, o, d, 100.0, amask=True)
    want = _fields(JBT.intersect_blocktrace(js, jm, jnp.asarray(o), jnp.asarray(d), 100.0, amask=True,
                                            interpret=True))
    _check(got, want, 2e-5, 1e-5)
    # Against the unculled cast: some first hits move behind; each culled
    # hit lies where the leaf's bilinear alpha is exactly 0.
    raw = _port_cast(ts, tm, o, d, 100.0)
    moved = raw["mask"] & (raw["tri"] != got["tri"])
    assert moved.sum() > 0.05 * raw["mask"].sum()
    assert (got["t"][moved & got["mask"]] > raw["t"][moved & got["mask"]]).all()
    tri = T(raw["tri"][moved]).long()
    u, v = T(raw["u"][moved]), T(raw["v"][moved])
    row = ts.shade_pack[tri]
    uv = (1.0 - u - v)[:, None] * row[:, 9:11] + u[:, None] * row[:, 11:13] + v[:, None] * row[:, 13:15]
    alpha = sample_stack(ts.tex_rgba, ts.materials.tex_base[ts.tri_mat[tri].long()], uv)[:, 3]
    assert (alpha == 0).all()


def _jax_ladder(js, jm, o, d, seed, nee, max_casts=32):
    """The JAX loop's active count per cast, replayed cast by cast at full
    width with its own pieces (`_fused_order`, `intersect_blocktrace` with
    `order_info` and `amask`, `_hit_gates`)."""
    n = o.shape[0]
    o, d, seed = jnp.asarray(o), jnp.asarray(d), jnp.asarray(seed)
    t_max = jnp.full((n,), 100.0 if not nee else 6.0, jnp.float32)
    info = JBT._fused_order(js, jm, o, d, t_max, jnp.zeros((n,)), 128, 1e-3, True)
    act = np.ones(n, bool)
    floor = jnp.zeros((n,), jnp.float32)
    ladder = []
    while act.any() and len(ladder) < max_casts:
        ladder.append(int(act.sum()))
        h = JBT.intersect_blocktrace(js, jm, o, d, jnp.where(act, t_max, -1.0), floor=floor,
                                     order_info=info, amask=True, interpret=True)
        hit = np.asarray(h.mask) & act
        ok, transparent, _ = JBT._hit_gates(js, jm, h, d, nee, seed)
        passthru = hit & (np.asarray(transparent) | ~np.asarray(ok))
        act = act & passthru
        floor = jnp.where(passthru, h.t, floor)
    return ladder


@pytest.mark.parametrize("nee", [False, True])
def test_gated_loop_equals_jax(ivy, nee):
    js, jm, ts, tm, o, d, seed = ivy
    t_max = 6.0 if nee else 100.0
    trace = []
    calls, casts = TBT.GATED.calls, TBT.GATED.casts
    got = _fields(TBT.intersect_blocktrace_gated(ts, tm, T(o), T(d), t_max, nee=nee,
                                                 alpha_seed=T(seed.astype(np.int64)), trace=trace))
    assert TBT.GATED.calls == calls + 1 and TBT.GATED.casts == casts + len(trace)
    want = _fields(JBT.intersect_blocktrace_gated(js, jm, jnp.asarray(o), jnp.asarray(d), t_max, nee=nee,
                                                  alpha_seed=jnp.asarray(seed), interpret=True))
    _check(got, want, 2e-5, 1e-5)
    # The pass-through ladder, cast by cast; it runs past the compaction
    # cap (n // 6 -> 384 lanes), so the compacted tail ran too.
    assert trace == _jax_ladder(js, jm, o, d, seed, nee)
    assert trace[0] == o.shape[0] and trace[1] > 384 and len(trace) >= 4
    if not nee:
        assert got["mask"].mean() > 0.9  # the floor stops what the leaves pass


def test_amask_leaves_gated_result_unchanged(ivy, monkeypatch):
    _, _, ts, tm, o, d, seed = ivy
    args = (ts, tm, T(o), T(d), 100.0)
    kw = dict(alpha_seed=T(seed.astype(np.int64)))
    with_cull, without = [], []
    a = TBT.intersect_blocktrace_gated(*args, trace=with_cull, **kw)
    real = fusedtrace.fused_trace
    monkeypatch.setattr(fusedtrace, "fused_trace", lambda *x, **k: real(*x[:8], amask=False))
    b = TBT.intersect_blocktrace_gated(*args, trace=without, **kw)
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f
    assert sum(with_cull) < sum(without)


def _kernel_walk(ray, slot_ids, box, pack, counts, t_min):
    """One ray through B3 in `amask` mode as csrc/fused_trace.cu runs it:
    its slots, then every other cluster in ascending id; in each entered
    cluster the columns in order, testing the alpha mask only for a
    candidate that passes the geometry and beats the best so far. The
    per-candidate arithmetic is the twin's; the carry is sequential."""
    o, d, t0, floor = ray[None, 0:3], ray[None, 3:6], float(ray[6]), float(ray[7])
    n_clus, c = pack.shape[0], pack.shape[2] // 3
    bt, bu, bv, bb, bi = t0, 0.0, 0.0, 0.0, -1
    n_c = n_t = n_m = 0
    slot_ids = [s for s in slot_ids if 0 <= s < n_clus]
    for cid in slot_ids + [k for k in range(n_clus) if k not in slot_ids]:
        e, xt = presort.sweep_bounds(o, d, box[:, cid : cid + 1])
        e, xt = float(torch.maximum(e, torch.tensor(t_min))), float(xt)
        if not (xt >= e and e < t0 and xt > floor and e <= bt):
            continue
        cnt, p = int(counts[cid]), pack[cid]
        first = int(p[4, 0:1].view(torch.int32))
        n_o, u_o, v_o = (o[:, 0:1] * p[0, k * c : k * c + cnt] + o[:, 1:2] * p[1, k * c : k * c + cnt]
                         + o[:, 2:3] * p[2, k * c : k * c + cnt] for k in range(3))
        n_d, u_d, v_d = (d[:, 0:1] * p[0, k * c : k * c + cnt] + d[:, 1:2] * p[1, k * c : k * c + cnt]
                         + d[:, 2:3] * p[2, k * c : k * c + cnt] for k in range(3))
        t = ((p[3, 0:cnt] - n_o) / n_d)[0]
        u = (u_o + t * u_d - p[3, c : c + cnt])[0]
        v = (v_o + t * v_d - p[3, 2 * c : 2 * c + cnt])[0]
        n_d = n_d[0]
        geom = ((n_d.abs() >= fusedtrace.EPS_DET) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
                & (t > t_min) & (t > floor))
        ok = fusedtrace.amask_valid(u[None], v[None], p[5:6, 0:cnt].contiguous().view(torch.int32),
                                    p[5:6, c : c + cnt].contiguous().view(torch.int32))[0]
        n_c, n_t = n_c + 1, n_t + cnt
        for j in torch.nonzero(geom)[:, 0].tolist():
            tj, tri = float(t[j]), first + j
            if tj < bt or (tj == bt and bi >= 0 and tri < bi):
                n_m += 1
                if ok[j]:
                    bt, bu, bv, bb, bi = tj, float(u[j]), float(v[j]), float(n_d[j] > 0), tri
    return [bt, bu, bv, bb, bi, n_c, n_t, n_m]


def test_amask_twin_equals_kernel_walk_and_counts_mask_tests(ivy):
    """The twin's vectorised carry gives the kernel's sequential results,
    and its last column counts exactly the mask tests the kernel runs (the
    bound of B3's `amask` mode is taken from that column)."""
    _, _, ts, tm, o, d, _ = ivy
    t_max = torch.full((o.shape[0],), 100.0)
    order, blive, slots = TBT.fused_order(ts, tm, T(o), T(d), t_max, torch.zeros(o.shape[0]), 1e-3)
    rays = TBT.ray_matrix(T(o), T(d), t_max)[order][:128].contiguous()
    assert int(blive[0]) == 1
    counts = TBT.cluster_counts(ts, tm)
    args = (rays, slots[:128].contiguous(), ts.clus_box, ts.clus_pack, counts, blive[:1], 1e-3)
    out = fusedtrace.fused_trace_plain(*args, amask=True)
    ids = torch.where(slots[:128] == presort.KEY_DEAD, -1, slots[:128] & presort.ID_MASK)
    for i in range(128):
        want = _kernel_walk(rays[i], ids[i].tolist(), ts.clus_box, ts.clus_pack, counts, 1e-3)
        row = out[i].tolist()
        row[4] = int(out[i, 4:5].view(torch.int32))
        assert row == want, i
    n_mask = out[:, 7]
    assert (n_mask > (out[:, 4].view(torch.int32) >= 0)).any()  # some rays test masks they reject
    assert (n_mask <= out[:, 6]).all()
    assert (fusedtrace.fused_trace_plain(*args)[:, 7] == 0).all()


def test_gated_result_is_order_free(ivy):
    _, _, ts, tm, o, d, seed = ivy
    s = T(seed.astype(np.int64))
    a = TBT.intersect_blocktrace_gated(ts, tm, T(o), T(d), 100.0, alpha_seed=s)
    b = TBT.intersect_blocktrace_gated(ts, tm, T(o[::-1].copy()), T(d[::-1].copy()), 100.0,
                                       alpha_seed=s.flip(0))
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f).flip(0)), f


def test_dispatcher_routes_gated_scenes(textured_box, ivy, monkeypatch):
    """Small gated scenes take the gated brute and never B1; big ones the
    gated block trace; shadow rays of alpha-free, transparent-free scenes
    stay ungated."""
    _, _, ts, tm, o, d, seed = textured_box
    calls = []
    real_b1 = brute.brute_intersect
    monkeypatch.setattr(brute, "brute_intersect", lambda *a, **k: calls.append("B1") or real_b1(*a, **k))
    real_gated = TBT.intersect_blocktrace_gated
    monkeypatch.setattr(TBT, "intersect_blocktrace_gated",
                        lambda *a, **k: calls.append("gated") or real_gated(*a, **k))
    n = o.shape[0]
    h = TI.intersect(ts, tm, T(o), T(d), torch.full((n,), 100.0), alpha_seed=T(seed.astype(np.int64)))
    assert calls == [] and h.mask.any()
    _, _, ts2, tm2, o2, d2, seed2 = ivy
    big = dataclasses.replace(tm2, n_tris=5000)  # the same tables, over B1's cap
    h2 = TI.intersect(ts2, big, T(o2), T(d2), torch.full((o2.shape[0],), 100.0),
                      alpha_seed=T(seed2.astype(np.int64)))
    assert calls == ["gated"] and h2.mask.float().mean() > 0.9
    plain = dataclasses.replace(tm, any_alpha=False, any_transparent=False)
    TI.intersect(ts, plain, T(o), T(d), torch.full((n,), 6.0), nee=True)
    assert calls == ["gated", "B1"]


def test_textured_golden_from_jax_scene():
    ts, tm = _carry(*j_textured_box().compile())
    img = Renderer(ts, tm, TEXTURED_CAM, TEXTURED_CFG, device="cpu").render().hdr
    with np.load(GOLDEN) as z:
        golden = z["textured"]
    assert img.shape == golden.shape and np.isfinite(img).all()
    close = np.isclose(img, golden, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), golden.mean(axis=(0, 1)), rtol=5e-3)


def test_textured_golden_from_port_scene():
    ts, tm = t_textured_box().compile(device="cpu")
    img = Renderer(ts, tm, TEXTURED_CAM, TEXTURED_CFG, device="cpu").render().hdr
    with np.load(GOLDEN) as z:
        golden = z["textured"]
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), golden.mean(axis=(0, 1)), rtol=0.02)
