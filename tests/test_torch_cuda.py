"""B1-B7b on the card: each Hopper kernel against its plain PyTorch twin
(B3 in its closest-hit, any-hit and alpha-mask modes, and in its instanced
mode in each of them, and at the edges of its block-cooperative design:
bit-equal t ties across lanes, rounds and clusters, one live ray a block,
short clusters, several tiles with `nee`, mask-test counts, several
instances a block, NaN and dead rays; B1 at the edges of its resident
triangle set (T = 0 to 4096), ties, NaN and zero directions, det at
+-1e-12 and unaligned rays; B4 with dead blocks and empty rows; B5 with
every lobe gate on, dead blocks and mis off, at the edges of its
lobe-grouped tiles (one lobe, interleaved lobes, dead tiles, ragged lane
counts, inputs with a storage offset) and in each flag instance, within one
wave of blocks and beyond it; B6 for ZSobol at even and odd
log2spp and hash; B7a and B7b at round 1 and a windowed round, k = 1, 2,
24 and 128, a ragged lane count, B7b with the clusters' counts and
without, and at the edges of their Hopper designs: B7a's culled blocks,
pad lanes, NaN and zero directions, signed-zero entries at t_min = 0,
entries of -0 and just below 0 kept by t_min < 0, entered pad boxes,
cpad 128 and 8192, window edges, blocks with no key and with more keys
than slots; B7b's clusters of 1 and C triangles,
degenerate triangles, ties within and across slots, t_cur = inf, live
flags that are no prefix, repeated ids, one block and 2,048 blocks, C =
30), the
gated re-cast loop's (fused and
round-based), bin-trace's, the round-based block trace's and the
per-instance loop's kernel paths against their twin paths, the stack
traversal against the gated brute, torch.argmin's first-minimum rule on the card,
renders that go through them, and the differentiable path (cornell-mat
forward + backward under each remat policy: B1 in every forward bounce and
never in a backward pass, kernel path against twin path); "pallas" renders
with the samplers B6 does not draw (stratified, ZSobol's null, binary and
exact Owen scramblers: B6 never launches, kernel path == twin path), a
render over 2 gloo ranks on the one card bitwise to one process, and two
NCCL ranks on one card refused by name.

These tests need a CUDA GPU (sm_90a for the kernel build) and skip
without one. They import no JAX, so they also run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernels are built with --fmad=false and repeat their twins' float
operations in order, so kernel and twin must agree bitwise."""

import dataclasses

import numpy as np
import pytest
import torch

from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.kernels import blocktrace as legacy
from yart_tpu_torch.kernels import brute, clusterpairs, fusedtrace, presort, shade
from yart_tpu_torch.ops import lut, qmc
from yart_tpu_torch.render import bintrace, blocktrace, integrator
from yart_tpu_torch.render.camera import build_camera
from yart_tpu_torch.render.renderer import Renderer
from yart_tpu_torch.scene.builder import SceneBuilder
from yart_tpu_torch.scene.procedural import cornell_box, material_test_spheres

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _soup(rng, n_tris, n_rays, dev, n_retired=0):
    c = rng.uniform(-2, 2, (n_tris, 1, 3))
    tri = np.zeros((n_tris, 12), np.float32)
    tri[:, :9] = (c + rng.normal(0, 0.3, (n_tris, 3, 3))).reshape(n_tris, 9)
    o = rng.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    d = rng.uniform(-1.5, 1.5, (n_rays, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(n_rays, 1e30, np.float32)
    t_max[:n_retired] = -1.0
    return [torch.from_numpy(a).to(dev) for a in (tri, o, d, t_max)]


@pytest.mark.parametrize("n_tris", [1, 36, 300, 4096])
@pytest.mark.parametrize("n_rays", [1, 255, 257, 1000, 65536])
def test_kernel_bitwise_equals_plain(dev, n_tris, n_rays):
    tri, o, d, t_max = _soup(np.random.default_rng(n_tris * 7 + n_rays), n_tris, n_rays, dev, n_rays // 10)
    before = brute.COUNTS.launches
    k = brute.brute_intersect(tri, o, d, t_max, n_tris, 1e-3)
    assert brute.COUNTS.launches == before + 1
    p = brute.brute_plain(tri, o, d, t_max, n_tris, 1e-3)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    assert not (k[4][: n_rays // 10] >= 0).any()  # retired lanes miss


def test_kernel_rejects_bad_inputs(dev):
    tri, o, d, t_max = _soup(np.random.default_rng(0), 8, 64, dev)
    with pytest.raises(ValueError, match="contiguous"):
        brute.brute_cuda(tri, o.t().contiguous().t(), d, t_max, 8, 1e-3)
    with pytest.raises(TypeError, match="float32"):
        brute.brute_cuda(tri, o.half(), d, t_max, 8, 1e-3)
    with pytest.raises(ValueError, match="is on"):
        brute.brute_cuda(tri.cpu(), o, d, t_max, 8, 1e-3)


def _b1_equal(tri, o, d, t_max, n_tris):
    """B1 against its twin, bitwise on every output; returns the kernel's."""
    k = brute.brute_intersect(tri, o, d, t_max, n_tris, 1e-3)
    p = brute.brute_plain(tri, o, d, t_max, n_tris, 1e-3)
    torch.cuda.synchronize()
    for name, a, b in zip(("t", "u", "v", "back", "tri"), k, p):
        assert _bits_equal(a, b), name
    return k


@pytest.mark.parametrize("n_tris", [0, 1, 255, 256, 257, 4096, 6000])
def test_brute_triangle_set_sizes_equal_plain(dev, n_tris):
    """The triangle set at its edges (none, one, around 256, the 1024 that
    stay resident, 4096 and 6000 streamed in chunks) at 2^16 + 77 rays, not
    a multiple of a tile (256 threads x 1, 2 or 4 rays), and at fewer rays
    than a tile an SM (blocks of 64); every tenth ray retired."""
    n = (1 << 16) + 77
    tri, o, d, t_max = _soup(np.random.default_rng(n_tris + 5), max(n_tris, 1), n, dev)
    t_max[::10] = -1.0
    for m in (n, 5000, 300):
        k = _b1_equal(tri, o[:m], d[:m], t_max[:m], n_tris)
        assert not (k[4][::10] >= 0).any()
        if n_tris == 0 or n_tris >= 255:  # one triangle may be missed by every ray
            assert bool((k[4] >= 0).any()) == (n_tris > 0)


def test_brute_ties_nan_and_zero_directions_equal_plain(dev):
    """Triangles 0-99 repeated at 100-199 (equal t: the lowest index
    wins), then NaN and zero directions among the rays."""
    n = (1 << 16) + 77
    tri, o, d, t_max = _soup(np.random.default_rng(21), 300, n, dev)
    tri = torch.cat([tri[:100], tri[:100], tri[100:]]).contiguous()
    k = _b1_equal(tri, o, d, t_max, tri.shape[0])
    assert ((k[4] >= 0) & (k[4] < 100)).any() and not ((k[4] >= 100) & (k[4] < 200)).any()
    d = d.clone()
    d[::7] = float("nan")
    d[3::7] = 0.0
    d[5::7, 1] = float("nan")
    k = _b1_equal(tri, o, d, t_max, tri.shape[0])
    assert not (k[4][::7] >= 0).any() and not (k[4][3::7] >= 0).any()


def test_brute_det_threshold_equal_plain(dev):
    """det = e1 . (d x e2) at exactly +-1e-12 (a hit: |det| >= eps) and at
    the float just inside (a miss), each triangle hit head-on at t = 1."""
    ex = np.float32(1e-12)
    inner = np.nextafter(ex, np.float32(0))
    tri = np.zeros((4, 12), np.float32)  # p0 = (0, 2j, 0), p1 = p0 + (e1x, 0, 1), p2 = p0 + (0, 1, 0)
    tri[:, 1] = [0.0, 2.0, 4.0, 6.0]
    tri[:, 3] = [ex, -ex, inner, -inner]
    tri[:, 4] = tri[:, 1]
    tri[:, 5] = 1.0
    tri[:, 7] = tri[:, 1] + 1.0
    o = np.zeros((256, 3), np.float32)
    o[:, 1] = np.repeat(tri[:, 1], 64) + np.tile(np.linspace(0.05, 0.95, 64, dtype=np.float32), 4)
    o[:, 2] = -1.0
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (256, 1))
    k = _b1_equal(*(torch.from_numpy(a).to(dev) for a in (tri, o, d)), torch.full((256,), 1e30, device=dev), 4)
    assert torch.equal(k[4].cpu(), torch.tensor([0] * 64 + [1] * 64 + [-1] * 128, dtype=torch.int32))


def test_brute_unaligned_rays_equal_plain(dev):
    """o and d as views with a storage offset of 1 and 3 rows (12 and 36
    bytes: not 16-byte aligned, so the kernel's 4-byte ray loads)."""
    n = 20000
    tri, o, d, t_max = _soup(np.random.default_rng(8), 36, n + 3, dev, 100)
    for off in (1, 3):
        assert o[off:].data_ptr() % 16 != 0
        _b1_equal(tri, o[off:], d[off:], t_max[off:], 36)


def test_render_on_card_goes_through_kernel(dev):
    scene, meta = cornell_box(extra_materials=True).compile(dev)
    cam = CameraConfig(image_size=(16, 16), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
    cfg = RenderConfig(samples=4, max_depth=6, tonemap="none", first_wave_samples=4)
    brute.COUNTS.reset()
    img = Renderer(scene, meta, cam, cfg, device=dev).render().hdr
    assert brute.COUNTS.launches > 0 and brute.COUNTS.plain_cuda == 0
    assert np.isfinite(img).all() and img.mean() > 0.01


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.fixture(scope="module")
def quad_soup():
    """A port-built soup of 3000 random quads (6000 triangles) in clusters
    of 64, and rays through and around it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(5)
    q = 3000
    c = rng.uniform(-4, 4, (q, 1, 3))
    corners = c + rng.normal(0, 0.3, (q, 4, 3))
    b = SceneBuilder()
    m = b.add_material()
    idx = np.asarray([[0, 1, 2], [0, 2, 3]])
    b.add_mesh(corners.reshape(-1, 3), (idx[None] + 4 * np.arange(q)[:, None, None]).reshape(-1, 3), m)
    return b.compile(device="cuda", cluster_size=64)


def _trace_rays(n, seed, dev):
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform(-6, 6, (n, 3)).astype(np.float32)).to(dev)
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    return o, d / d.norm(dim=1, keepdim=True)


@pytest.mark.parametrize("n_rays", [128, 1000, 65536])
def test_presort_kernel_equals_plain(quad_soup, n_rays):
    scene, meta = quad_soup
    o, d = _trace_rays(n_rays, n_rays, scene.clus_box.device)
    t_max = torch.full((n_rays, 1), 20.0, device=o.device)
    t_max[: n_rays // 8] = -1.0
    rays = torch.cat([o, d, t_max, torch.zeros_like(t_max)], dim=1).contiguous()
    before = presort.COUNTS.launches
    k = presort.presort_keys(rays, scene.clus_box, meta.n_clusters, 1e-3)
    assert presort.COUNTS.launches == before + 1
    p = presort.presort_plain(rays, scene.clus_box, meta.n_clusters, 1e-3)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert (k[: n_rays // 8, 0] == presort.SKEY_NOTHING).all()


def _boxes(rng, n_clus, dev, degenerate=False):
    """clus_box [8, cpad] of n_clus seeded boxes in [-4, 4]^3 (cpad the
    next multiple of 128, the pad columns NaN, which B2 must not read)."""
    cpad = -(-n_clus // 128) * 128
    lo = rng.uniform(-4, 4, (3, n_clus))
    hi = lo if degenerate else lo + rng.uniform(0.05, 0.6, (3, n_clus))
    box = np.full((8, cpad), np.nan, np.float32)
    box[0:3, :n_clus], box[3:6, :n_clus] = lo, hi
    return torch.from_numpy(box).to(dev)


def _b2_kernel_equals_plain(rays, box, n_clus):
    before = presort.COUNTS.launches
    k = presort.presort_keys(rays.contiguous(), box, n_clus, 1e-3)
    assert presort.COUNTS.launches == before + 1
    p = presort.presort_plain(rays.contiguous(), box, n_clus, 1e-3)
    torch.cuda.synchronize()
    assert torch.equal(k, p), f"B2 kernel and twin differ on {int((k != p).any(dim=1).sum())} rows"
    return k


def _b2_rays(rng, n, kind, dev):
    """[n, 8] rays in lane order: "camera" (one origin, directions sweeping
    a small frustum row by row, as a render's camera rays) or "random"
    (origins near each other in lane order, directions uniform, as a later
    bounce's)."""
    if kind == "camera":
        side = int(np.ceil(np.sqrt(n)))
        u, v = np.meshgrid(np.linspace(-0.4, 0.4, side), np.linspace(-0.4, 0.4, side))
        d = np.stack([u.ravel(), v.ravel(), -np.ones(side * side)], 1)[:n]
        o = np.tile([[0.3, 0.2, 7.0]], (n, 1))
    else:
        o = np.cumsum(rng.normal(0, 0.02, (n, 3)), axis=0) % 8.0 - 4.0
        d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.full((n, 1), 30.0)
    return torch.from_numpy(np.concatenate([o, d, t, np.zeros((n, 1))], 1).astype(np.float32)).to(dev)


@pytest.mark.parametrize("n_clus", [1, 127, 128, 129, 8192])
def test_presort_cluster_counts_equal_plain(dev, n_clus):
    """Box counts around B2's tile of 128 and the 8192-cluster cap, with
    camera and random-direction rays."""
    rng = np.random.default_rng(n_clus)
    box = _boxes(rng, n_clus, dev)
    for kind in ("camera", "random"):
        k = _b2_kernel_equals_plain(_b2_rays(rng, 16384, kind, dev), box, n_clus)
        assert (k[:, 5] > 0).any()


@pytest.mark.parametrize("case", ["ragged_1", "ragged_129", "ragged_1000", "one_live_lane", "dead_blocks",
                                  "zero_directions", "tiny_directions", "nan_directions", "on_faces",
                                  "degenerate_boxes", "camera", "random"])
def test_presort_edges_equal_plain(dev, case):
    """B2 at the edges of its block cull: ragged N; blocks with one live
    lane and with none; direction components of +-0, +-1e-21 (the 1e-20
    safe path) and NaN; origins on box faces (slab values +-0, boxes at
    -0.0); degenerate boxes (lo = hi); coherent camera and random rays."""
    rng = np.random.default_rng(len(case))
    n_clus = 700
    box = _boxes(rng, n_clus, dev, degenerate=case == "degenerate_boxes")
    n = {"ragged_1": 1, "ragged_129": 129, "ragged_1000": 1000}.get(case, 8192)
    rays = _b2_rays(rng, n, "camera" if case in ("camera", "one_live_lane", "dead_blocks") else "random", dev)
    lane = torch.arange(n, device=dev)
    if case == "one_live_lane":
        rays[lane % 128 != 37, 6] = -1.0
    elif case == "dead_blocks":
        rays[(lane // 128) % 3 == 1, 6] = -1.0
        rays[lane % 5 == 0, 6] = 0.0
    elif case in ("zero_directions", "tiny_directions", "nan_directions"):
        val = {"zero_directions": 0.0, "tiny_directions": 1e-21, "nan_directions": float("nan")}[case]
        for a in range(3):
            rays[a::4, 3 + a] = val
            rays[a + 1::8, 3 + a] = -val
    elif case == "on_faces":
        j = torch.from_numpy(rng.integers(0, n_clus, n)).to(dev)
        for a in range(3):
            rays[:, a] = torch.where(lane % 3 == a, box[a, j], box[a + 3, j])
        box[0:3, : n_clus // 4] = -0.0  # boxes at -0.0 against origins at +0.0 (slab values -0)
        rays[::7, 0:3] = 0.0
        rays[1::7, 3:6] = torch.tensor([0.0, -0.0, 1.0], device=dev)
    k = _b2_kernel_equals_plain(rays, box, n_clus)
    if case == "one_live_lane":
        assert (k[lane % 128 != 37, 5] == 0).all() and (k[lane % 128 == 37, 5] > 0).any()
    if case == "dead_blocks":
        assert (k[(lane // 128) % 3 == 1, 0] == presort.SKEY_NOTHING).all()


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("n_rays", [1000, 65536])
def test_fused_trace_kernel_equals_plain(quad_soup, n_rays, nee):
    scene, meta = quad_soup
    o, d = _trace_rays(n_rays, 7 * n_rays, scene.clus_box.device)
    t_max = torch.full((n_rays,), 8.0 if nee else 100.0, device=o.device)
    t_max[: n_rays // 8] = -1.0
    floor = torch.zeros(n_rays, device=o.device)
    floor[n_rays // 2 :] = 1.5
    before = fusedtrace.COUNTS.launches
    k = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, nee=nee, floor=floor)
    assert fusedtrace.COUNTS.launches == before + 1
    saved = fusedtrace.fused_trace, presort.presort_keys
    fusedtrace.fused_trace, presort.presort_keys = fusedtrace.fused_trace_plain, presort.presort_plain
    try:
        p = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, nee=nee, floor=floor)
    finally:
        fusedtrace.fused_trace, presort.presort_keys = saved
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert _bits_equal(a, b)
    hit = k[4] >= 0
    assert 0.05 < hit.float().mean() < 0.95
    assert not hit[: n_rays // 8].any()
    assert (k[0][hit & (floor > 0)] > 1.5).all()
    if not nee:
        # Moller-Trumbore (B1) and the plane test may flip a lane that grazes
        # an edge; B1 has no floor.
        ref = brute.brute_intersect(scene.tri_pack, o, d, t_max, meta.n_tris, 1e-3)
        low = floor == 0
        assert (hit[low] == (ref[4][low] >= 0)).float().mean() >= 0.999


def test_spheres_render_on_card_goes_through_blocktrace():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    scene, meta = material_test_spheres().compile()
    cam = CameraConfig(image_size=(16, 16), focal_length=35.0, position=(0, 2.2, 5.5),
                       forward=(0, -1.8, -6.1))
    cfg = RenderConfig(samples=4, max_depth=6, tonemap="none", first_wave_samples=4)
    for c in (brute.COUNTS, presort.COUNTS, fusedtrace.COUNTS):
        c.reset()
    img = Renderer(scene, meta, cam, cfg).render().hdr
    assert presort.COUNTS.launches > 0 and fusedtrace.COUNTS.launches > 0
    assert brute.COUNTS.launches == 0
    assert presort.COUNTS.plain_cuda == fusedtrace.COUNTS.plain_cuda == 0
    assert np.isfinite(img).all() and img.mean() > 0.05


@pytest.fixture(scope="module")
def ivy_soup():
    """A port-built ivy: 300 alpha-tested leaf quads (the atrium's leaf
    texture) over a floor in clusters of 64, and rays through it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    from yart_tpu_torch.scene.showcase import leaf_texture

    rng = np.random.default_rng(21)
    q = 300
    b = SceneBuilder()
    m_ivy = b.add_material(roughness=0.9, tex_base=b.add_texture("rgba", leaf_texture()), has_alpha=True)
    m_floor = b.add_material(roughness=0.8)
    c = np.stack([rng.uniform(-2, 2, q), rng.uniform(0.3, 2.0, q), rng.uniform(-2, 2, q)], 1)
    a = rng.uniform(0, np.pi, q)
    s = rng.uniform(0.25, 0.5, q)[:, None]
    du = np.stack([np.cos(a), np.zeros(q), np.sin(a)], 1) * s
    dv = np.stack([np.zeros(q), np.ones(q), np.zeros(q)], 1) * s
    p = np.stack([c - du - dv, c + du - dv, c + du + dv, c - du + dv], 1).reshape(-1, 3)
    idx = (np.asarray([[0, 1, 2], [0, 2, 3]])[None] + 4 * np.arange(q)[:, None, None]).reshape(-1, 3)
    b.add_mesh(p, idx, m_ivy, uvs=np.tile(np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]]), (q, 1)))
    b.add_mesh(np.asarray([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]]), [[0, 2, 1], [0, 3, 2]], m_floor)
    scene, meta = b.compile(device="cuda", cluster_size=64)
    n = 65536
    o = torch.from_numpy(np.asarray([0.0, 1.2, 5.0], np.float32) + rng.normal(size=(n, 3)).astype(np.float32) * 0.1)
    target = np.stack([rng.uniform(-2, 2, n), rng.uniform(0, 2, n), rng.uniform(-2, 2, n)], 1)
    d = torch.from_numpy(target.astype(np.float32)) - o
    seed = torch.from_numpy(rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.int64))
    return scene, meta, o.cuda(), (d / d.norm(dim=1, keepdim=True)).cuda(), seed.cuda()


@pytest.mark.parametrize("n_rays", [1000, 65536])
def test_fused_trace_amask_kernel_equals_plain(ivy_soup, n_rays):
    scene, meta, o, d, _ = ivy_soup
    o, d = o[:n_rays].contiguous(), d[:n_rays].contiguous()
    t_max = torch.full((n_rays,), 100.0, device=o.device)
    t_max[: n_rays // 8] = -1.0
    floor = torch.zeros(n_rays, device=o.device)
    floor[n_rays // 2 :] = 2.0
    before = fusedtrace.COUNTS.modes.get("amask", 0)
    k = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, floor=floor, amask=True)
    assert fusedtrace.COUNTS.modes["amask"] == before + 1
    saved = fusedtrace.fused_trace, presort.presort_keys
    fusedtrace.fused_trace, presort.presort_keys = fusedtrace.fused_trace_plain, presort.presort_plain
    try:
        p = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, floor=floor, amask=True)
    finally:
        fusedtrace.fused_trace, presort.presort_keys = saved
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert _bits_equal(a, b)
    raw = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, floor=floor)
    hit = k[4] >= 0
    assert (raw[4] != k[4]).any() and not hit[: n_rays // 8].any()
    assert (k[0][hit & (floor > 0)] > 2.0).all()


@pytest.mark.parametrize("nee", [False, True])
def test_gated_loop_kernel_path_equals_plain_path(ivy_soup, nee):
    scene, meta, o, d, seed = ivy_soup
    t_max = 6.0 if nee else 100.0
    trace_k, trace_p = [], []
    k = blocktrace.intersect_blocktrace_gated(scene, meta, o, d, t_max, nee=nee, alpha_seed=seed, trace=trace_k)
    saved = fusedtrace.fused_trace, presort.presort_keys
    fusedtrace.fused_trace, presort.presort_keys = fusedtrace.fused_trace_plain, presort.presort_plain
    try:
        p = blocktrace.intersect_blocktrace_gated(scene, meta, o, d, t_max, nee=nee, alpha_seed=seed,
                                                  trace=trace_p)
    finally:
        fusedtrace.fused_trace, presort.presort_keys = saved
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert _bits_equal(a, b)
    assert trace_k == trace_p and len(trace_k) >= 3


def test_textured_render_on_card():
    """The textured box (alpha cutout, thin glass) through the gated brute,
    which has no kernel: no twin runs, the image is finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    from yart_tpu_torch.scene.procedural import textured_box_scene

    scene, meta = textured_box_scene().compile()
    cam = CameraConfig(image_size=(16, 16), focal_length=26.0, position=(0, 1.6, 3.2), forward=(0, -0.9, -3.0))
    cfg = RenderConfig(samples=4, max_depth=5, tonemap="none", first_wave_samples=4)
    for c in (brute.COUNTS, presort.COUNTS, fusedtrace.COUNTS):
        c.reset()
    img = Renderer(scene, meta, cam, cfg).render().hdr
    assert brute.COUNTS.plain_cuda == presort.COUNTS.plain_cuda == fusedtrace.COUNTS.plain_cuda == 0
    assert np.isfinite(img).all() and img.mean() > 0.01


@pytest.fixture(scope="module")
def inst_leaves():
    """The port's instanced gated fixture (`showcase.instanced_leaves`):
    leaf quads instanced under rotated, non-uniformly scaled transforms,
    a glass pane instance, a baked floor; and rays through it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    from yart_tpu_torch.scene.showcase import instanced_leaves

    scene, meta = instanced_leaves().compile(device="cuda")
    rng = np.random.default_rng(12)
    n = 65536
    o = torch.from_numpy(np.asarray([0.0, 1.2, 4.5], np.float32) + rng.normal(size=(n, 3)).astype(np.float32) * 0.2)
    target = np.stack([rng.uniform(-2, 2, n), rng.uniform(0, 2, n), rng.uniform(-2, 2, n)], 1)
    d = torch.from_numpy(target.astype(np.float32)) - o
    seed = torch.from_numpy(rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.int64))
    return scene, meta, o.cuda(), (d / d.norm(dim=1, keepdim=True)).cuda(), seed.cuda()


@pytest.mark.parametrize("mode", ["instanced", "instanced+nee", "instanced+amask"])
@pytest.mark.parametrize("n_rays", [1000, 65536])
def test_fused_trace_instanced_kernel_equals_plain(inst_leaves, mode, n_rays):
    scene, meta, o, d, _ = inst_leaves
    assert meta.n_instances > 1 and meta.n_inst_clusters > 1
    nee, amask = "nee" in mode, "amask" in mode
    o, d = o[:n_rays].contiguous(), d[:n_rays].contiguous()
    t_max = torch.full((n_rays,), 4.0 if nee else 100.0, device=o.device)
    t_max[: n_rays // 8] = -1.0
    floor = torch.zeros(n_rays, device=o.device)
    floor[n_rays // 2 :] = 1.0
    before = fusedtrace.COUNTS.modes.get(mode, 0)
    k = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, nee=nee, floor=floor, amask=amask)
    assert fusedtrace.COUNTS.modes[mode] == before + 1
    saved = fusedtrace.fused_trace, presort.presort_keys
    fusedtrace.fused_trace, presort.presort_keys = fusedtrace.fused_trace_plain, presort.presort_plain
    try:
        p = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, nee=nee, floor=floor, amask=amask)
    finally:
        fusedtrace.fused_trace, presort.presort_keys = saved
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert _bits_equal(a, b)
    hit = k[4] >= 0
    assert hit.any() and not hit[: n_rays // 8].any() and (k[0][hit & (floor > 0)] > 1.0).all()
    if not nee:  # closest hits land on several instances of the one leaf prototype
        assert scene.tri_aux[k[4][hit].long(), 1].unique().numel() > 2


@pytest.mark.parametrize("nee", [False, True])
def test_gated_instanced_loop_kernel_path_equals_plain_path(inst_leaves, nee):
    scene, meta, o, d, seed = inst_leaves
    t_max = 6.0 if nee else 100.0
    trace_k, trace_p = [], []
    before = fusedtrace.COUNTS.modes.get("instanced+amask", 0)
    k = blocktrace.intersect_blocktrace_gated(scene, meta, o, d, t_max, nee=nee, alpha_seed=seed, trace=trace_k)
    assert fusedtrace.COUNTS.modes["instanced+amask"] == before + len(trace_k)
    saved = fusedtrace.fused_trace, presort.presort_keys
    fusedtrace.fused_trace, presort.presort_keys = fusedtrace.fused_trace_plain, presort.presort_plain
    try:
        p = blocktrace.intersect_blocktrace_gated(scene, meta, o, d, t_max, nee=nee, alpha_seed=seed,
                                                  trace=trace_p)
    finally:
        fusedtrace.fused_trace, presort.presort_keys = saved
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert _bits_equal(a, b)
    assert trace_k == trace_p and len(trace_k) >= 2


@pytest.mark.parametrize("nee", [False, True])
def test_stack_traversal_equals_gated_brute(ivy_soup, nee):
    """The 8-wide stack traversal (plain PyTorch, no kernel) against the
    gated brute on 4,096 lanes of the gated ivy, on the card: masks exact;
    closest hits: t, u and v bitwise where the triangle agrees (the same
    Moller-Trumbore arithmetic), another triangle only where two tie in t;
    and the coherence-sorted variant lane-exact to it."""
    from yart_tpu_torch.render import stacktrace
    from yart_tpu_torch.render.intersect import intersect_brute

    scene, meta, o, d, seed = ivy_soup
    o, d, seed = o[:4096].contiguous(), d[:4096].contiguous(), seed[:4096].contiguous()
    t_max = torch.full((4096,), 6.0 if nee else 100.0, device=o.device)
    s = stacktrace.intersect_bvh8(scene, meta, o, d, t_max, nee=nee, alpha_seed=seed)
    b = intersect_brute(scene, meta, o, d, t_max, nee=nee, alpha_seed=seed)
    torch.cuda.synchronize()
    assert torch.equal(s.mask, b.mask) and s.mask.any() and not s.mask.all()  # hits and misses
    if not nee:
        same = s.mask & (s.tri == b.tri)
        assert same.sum() >= 0.995 * s.mask.sum()
        for f in ("t", "u", "v"):
            assert _bits_equal(getattr(s, f)[same], getattr(b, f)[same]), f
        assert _bits_equal(s.t[s.mask], b.t[b.mask])  # a differing triangle ties in t
    srt = stacktrace.intersect_bvh_sorted(scene, meta, o, d, t_max, nee=nee, alpha_seed=seed, chunk=1000)
    for a, c in zip(srt, s):
        assert _bits_equal(a, c)


@pytest.mark.parametrize("nee", [False, True])
def test_instanced_loop_kernel_path_equals_plain_path(nee):
    """The per-instance loop over the dense instanced atrium (95 instances
    of 41 prototypes, 12,055 instance clusters): B1 for the small
    prototypes and B2 + B3 for the big ones, kernel path against twin path
    bitwise on every Hit field."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    from yart_tpu_torch.render.intersect import intersect
    from yart_tpu_torch.scene.showcase import atrium

    scene, meta = atrium(density=3, instanced=True).compile(device="cuda")
    assert meta.n_inst_clusters > blocktrace.MAX_CLUSTERS
    rng = np.random.default_rng(5)
    n = 8192
    o = torch.from_numpy(np.asarray([-10.0, 1.8, 0.0], np.float32) + rng.normal(size=(n, 3)).astype(np.float32))
    target = np.stack([rng.uniform(-8, 8, n), rng.uniform(0, 6, n), rng.uniform(-6, 6, n)], 1)
    d = torch.from_numpy(target.astype(np.float32)) - o
    o, d = o.cuda(), (d / d.norm(dim=1, keepdim=True)).cuda()
    t_max = torch.full((n,), 6.0 if nee else 1e30, device="cuda")
    before = (brute.COUNTS.launches, presort.COUNTS.launches, fusedtrace.COUNTS.launches)
    k = intersect(scene, meta, o, d, t_max, nee=nee)
    after = (brute.COUNTS.launches, presort.COUNTS.launches, fusedtrace.COUNTS.launches)
    assert all(a > b for a, b in zip(after, before))
    saved = brute.brute_intersect, fusedtrace.fused_trace, presort.presort_keys
    brute.brute_intersect, fusedtrace.fused_trace, presort.presort_keys = (
        brute.brute_plain, fusedtrace.fused_trace_plain, presort.presort_plain)
    try:
        p = intersect(scene, meta, o, d, t_max, nee=nee)
    finally:
        brute.brute_intersect, fusedtrace.fused_trace, presort.presort_keys = saved
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert _bits_equal(a, b)
    assert 0.05 < k.mask.float().mean()


def tie_soup(seed: int = 3, n_soup: int = 500, n_dup: int = 100):
    """(pos [V, 3] float32, tri [T, 3]): `n_soup` small random triangles in
    a box below the plane z = 0 and `n_dup` copies of one large triangle in
    that plane. In
    clusters of 64 the copies fill two clusters of 50 columns, so a ray
    through the stack meets bit-equal t in different lanes, different
    32-column rounds and two clusters (tests/test_torch_blocktrace.py
    checks that on the CPU)."""
    rng = np.random.default_rng(seed)
    soup = rng.uniform((-4, -4, -4), (4, 4, -1), (n_soup, 1, 3)) + rng.normal(0, 0.3, (n_soup, 3, 3))
    pos = np.concatenate([soup.reshape(-1, 3), np.tile(TIE_TRIANGLE, (n_dup, 1))]).astype(np.float32)
    return pos, np.arange(pos.shape[0]).reshape(-1, 3)


TIE_TRIANGLE = np.asarray([[-3.0, -3.0, 0.0], [3.0, -3.0, 0.0], [0.0, 3.0, 0.0]], np.float32)


def tie_rays(n: int, seed: int = 4):
    """Rays o, d [n, 3] float32 from z = 8 down to the plane of tie_soup's
    stack, most through the stack and some past its edges."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-4, 4, (n, 2)), np.full((n, 1), 8.0)], 1)
    d = np.concatenate([rng.uniform(-3.5, 3.5, (n, 2)), np.zeros((n, 1))], 1) - o
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def tie_scene():
    """tie_soup built by the port in clusters of 64, and its stack's
    triangle ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    pos, tri = tie_soup()
    b = SceneBuilder()
    b.add_mesh(pos, tri, b.add_material())
    scene, meta = b.compile(device="cuda", cluster_size=64)
    big = torch.from_numpy(TIE_TRIANGLE.reshape(1, 9)).cuda()
    stack = torch.nonzero((scene.tri_pack[:, :9] == big).all(dim=1))[:, 0].to(torch.int32)
    assert stack.numel() == 100
    return scene, meta, stack


@pytest.fixture(scope="module")
def quad_soup_c16():
    """quad_soup's 6000 triangles in clusters of 16: 375 clusters, three
    tiles of B3's ascending walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(5)
    q = 3000
    corners = rng.uniform(-4, 4, (q, 1, 3)) + rng.normal(0, 0.3, (q, 4, 3))
    b = SceneBuilder()
    idx = np.asarray([[0, 1, 2], [0, 2, 3]])
    b.add_mesh(corners.reshape(-1, 3), (idx[None] + 4 * np.arange(q)[:, None, None]).reshape(-1, 3),
               b.add_material())
    scene, meta = b.compile(device="cuda", cluster_size=16)
    assert meta.n_clusters > 256
    return scene, meta


def _live_lanes(n: int, lanes: str, t_max: float, dev):
    """t_max [n]: every lane live ("all"), one lane of each 128-lane block
    ("one"), or a seeded tenth of them ("mixed"); the others dead (-1)."""
    t = torch.full((n,), t_max, device=dev)
    if lanes == "all":
        return t
    if lanes == "one":
        keep = (torch.arange(n, device=dev) % blocktrace.BLOCK) == 37
    else:
        keep = torch.from_numpy(np.random.default_rng(n).random(n) < 0.1).to(dev)
    return torch.where(keep, t, -1.0)


def _b3_kernel_equals_plain(scene, meta, o, d, t_max, floor=None, nee=False, amask=False, sort=True,
                            counts=None):
    """B3 on the block trace's inputs for o, d, t_max: B2's slots, and the
    two-key sort with its `blive` flags or, with sort=False, the lanes in
    their own order with every block that has a live lane flagged. The
    kernel against its twin, bitwise on all 8 columns; returns
    (B3 arguments, kernel output)."""
    rays = blocktrace.ray_matrix(o, d, t_max, floor)
    pk = presort.presort_keys(rays, scene.clus_box, blocktrace.n_clus(meta), 1e-3)
    if sort:
        order, blive = blocktrace.schedule(pk)
    else:
        order = torch.arange(rays.shape[0], device=rays.device)
        blive = (rays[:, 6] > 0).view(-1, blocktrace.BLOCK).any(dim=1).to(torch.int32)
    args = (rays[order].contiguous(), pk[order, 1 : 1 + presort.N_SLOTS].contiguous(), scene.clus_box,
            scene.clus_pack, blocktrace.cluster_counts(scene, meta) if counts is None else counts, blive,
            1e-3, nee, amask, blocktrace.inst_tables(scene, meta))
    before = fusedtrace.COUNTS.launches
    k = fusedtrace.fused_trace(*args)
    assert fusedtrace.COUNTS.launches == before + 1
    p = fusedtrace.fused_trace_plain(*args)
    torch.cuda.synchronize()
    diff = [i for i in range(8) if not _bits_equal(k[:, i].contiguous(), p[:, i].contiguous())]
    assert not diff, f"B3 kernel and twin differ in columns {diff}"
    return args, k


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("lanes", ["all", "one", "mixed"])
def test_fused_trace_ties_equal_plain(tie_scene, lanes, sort):
    """Bit-equal t in different lanes, 32-column rounds and clusters, with
    many rays entering a cluster, a single one (a live block with one live
    ray) and a mix: the lowest copy of the stack wins every tie."""
    scene, meta, stack = tie_scene
    dev = scene.clus_pack.device
    n = 16384
    o, d = (torch.from_numpy(a).to(dev) for a in tie_rays(n))
    t_max = _live_lanes(n, lanes, 100.0, dev)
    _, k = _b3_kernel_equals_plain(scene, meta, o, d, t_max, sort=sort)
    tri = k[:, 4].contiguous().view(torch.int32)
    on_stack = torch.isin(tri, stack)
    assert int(on_stack.sum()) >= 0.25 * int((t_max > 0).sum())  # a third of the rays end on the stack
    assert (tri[on_stack] == stack.min()).all()


@pytest.mark.parametrize("cnt", [1, 33])
def test_fused_trace_short_clusters_equal_plain(tie_scene, cnt):
    """Clusters cut to their first `cnt` columns (B3 takes the counts as
    given): one column, and one past a warp's 32."""
    scene, meta, _ = tie_scene
    dev = scene.clus_pack.device
    n = 16384
    o, d = (torch.from_numpy(a).to(dev) for a in tie_rays(n, seed=cnt))
    counts = torch.clamp(blocktrace.cluster_counts(scene, meta), max=cnt)
    for lanes in ("all", "one"):
        _, k = _b3_kernel_equals_plain(scene, meta, o, d, _live_lanes(n, lanes, 100.0, dev), counts=counts)
        assert (k[:, 4].contiguous().view(torch.int32) >= 0).any()
        assert (k[:, 6] <= cnt * k[:, 5]).all()


@pytest.mark.parametrize("lanes", ["all", "one", "mixed"])
@pytest.mark.parametrize("nee", [False, True])
def test_fused_trace_tiles_and_nee_equal_plain(quad_soup_c16, nee, lanes):
    """375 clusters (three tiles of the ascending walk), closest hit and
    shadow rays (nee) with a finite t_max: rays stop at the first cluster
    that gives them a hit, inside a tile, and a block whose live rays have
    all stopped leaves the walk."""
    scene, meta = quad_soup_c16
    n = 65536
    o, d = _trace_rays(n, 11, scene.clus_box.device)
    floor = torch.zeros(n, device=o.device)
    floor[n // 2 :] = 0.5
    _, k = _b3_kernel_equals_plain(scene, meta, o, d, _live_lanes(n, lanes, 6.0 if nee else 100.0, o.device),
                                   floor=floor, nee=nee, sort=lanes == "all")
    hit = k[:, 4].contiguous().view(torch.int32) >= 0
    assert hit.any() and (~hit & (k[:, 5] > 1)).any()
    if nee:  # some rays stopped before the walk's last entered cluster
        assert (hit & (k[:, 5] > 1)).any()


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("lanes", ["all", "one", "mixed"])
def test_fused_trace_amask_counts_equal_plain(ivy_soup, lanes, sort):
    """`amask` mask-test counts (column 7) when a cluster's accepted
    candidates lie in different lanes and rounds (the warp prefix-min), for
    many, single and mixed entering rays."""
    scene, meta, o, d, _ = ivy_soup
    n = o.shape[0]
    _, k = _b3_kernel_equals_plain(scene, meta, o, d, _live_lanes(n, lanes, 100.0, o.device), amask=True,
                                   sort=sort)
    assert (k[:, 7] >= 2).any() and (k[:, 7] <= k[:, 6]).all()


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("mode", ["instanced", "instanced+nee", "instanced+amask"])
def test_fused_trace_instances_in_one_block_equal_plain(inst_leaves, mode, sort):
    """Rays of one block in different instances (in their own order, a
    block's rays are scattered over the scene): each entering ray is mapped
    by its cluster's instance."""
    scene, meta, o, d, _ = inst_leaves
    n = o.shape[0]
    nee = "nee" in mode
    _, k = _b3_kernel_equals_plain(scene, meta, o, d, torch.full((n,), 4.0 if nee else 100.0, device=o.device),
                                   nee=nee, amask="amask" in mode, sort=sort)
    tri = k[:, 4].contiguous().view(torch.int32)
    hit = tri >= 0
    inst = scene.tri_aux[tri.clamp(min=0).long(), 1]
    lo = torch.where(hit, inst, 1 << 30).view(-1, blocktrace.BLOCK).min(dim=1).values
    hi = torch.where(hit, inst, -1).view(-1, blocktrace.BLOCK).max(dim=1).values
    assert (hi > lo).any()


def test_fused_trace_nan_and_dead_rays_equal_plain(tie_scene):
    """Inside live blocks: rays with a NaN direction component, a NaN
    floor, t_max = -1, a direction along an axis (1/d = 1e20) and one with
    an infinite component (1/d = 0). The kernel's bundle leaves out only
    rays that enter nothing; those write the miss row."""
    scene, meta, _ = tie_scene
    dev = scene.clus_pack.device
    n = 4096
    o, d = tie_rays(n, seed=9)
    d[5::64, 1] = np.nan
    d[7::64] = (0.0, 0.0, -1.0)
    d[9::128, 0] = np.inf
    t_max = np.full(n, 100.0, np.float32)
    t_max[11::3] = -1.0
    floor = np.zeros(n, np.float32)
    floor[13::64] = np.nan
    o, d, t_max, floor = (torch.from_numpy(a).to(dev) for a in (o, d, t_max, floor))
    _, k = _b3_kernel_equals_plain(scene, meta, o, d, t_max, floor=floor, sort=False)
    dead = torch.zeros(n, dtype=torch.bool, device=dev)
    for start, step in ((5, 64), (11, 3), (13, 64)):
        dead[start::step] = True
    miss = k[:n][dead]
    assert (miss[:, 4].contiguous().view(torch.int32) == -1).all() and (miss[:, 5:] == 0).all()
    assert _bits_equal(miss[:, 0].contiguous(), t_max[dead])
    assert (k[7:n:64, 4].contiguous().view(torch.int32) >= 0).any()


def test_argmin_takes_the_first_minimum_on_cuda(dev):
    # bin-trace's per-ray reduction and B4's twin rely on it (jnp.argmin's rule).
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, 3, (4096, 37)).astype(np.float32)).to(dev)
    got = torch.argmin(a, dim=1).cpu().numpy()
    np.testing.assert_array_equal(got, np.argmin(a.cpu().numpy(), axis=1))  # numpy: the first one
    assert int(torch.argmin(torch.full((1000,), 3e38, device=dev))) == 0


def _pairs(rng, sizes, n_clusters, dev, tmax=100.0):
    """B4's compact layout for seeded pairs: clusters of the given sizes
    (random cluster ids in ascending order, distinct where there are enough
    clusters; a repeated id joins its runs), one random ray a pair.
    Returns (each row's cluster id [L] int32, the rows x [L, 8])."""
    cids = np.sort(rng.choice(n_clusters, size=len(sizes), replace=len(sizes) > n_clusters))
    n = int(sum(sizes))
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    x = np.concatenate([o, d, np.full((n, 1), tmax, np.float32), np.zeros((n, 1), np.float32)], axis=1)
    cid = torch.from_numpy(np.repeat(cids, sizes).astype(np.int32)).to(dev)
    return cid, torch.from_numpy(x).to(dev)


def _b4_kernel_equals_plain(scene, meta, cid, x, tile=clusterpairs.TILE, counts=None):
    """B4 on pair rows x sorted by cluster `cid`, in tiles of `tile`, each
    against its cluster's triangles (or the first `counts` columns): the
    kernel against its twin, bitwise on t, u, v, back and tri; returns the
    kernel's outputs."""
    tiles = bintrace.tile_table(cid, scene.clus_first, tile)
    counts = blocktrace.cluster_counts(scene, meta) if counts is None else counts
    args = (scene.clus_pack, counts, tiles, x.contiguous(), meta.cluster_size, 1e-3)
    before = clusterpairs.COUNTS.launches
    k = clusterpairs.cluster_pairs(*args)
    assert clusterpairs.COUNTS.launches == before + 1
    p = clusterpairs.cluster_pairs_plain(*args)
    torch.cuda.synchronize()
    diff = [f for f, a, b in zip(("t", "u", "v", "back", "tri"), k, p) if not _bits_equal(a, b)]
    assert not diff, f"B4 kernel and twin differ in {diff}"
    assert all(a.shape[0] == x.shape[0] for a in k)
    hit = k[4] >= 0
    assert (k[0][~hit] == 3e38).all() and not k[3][~hit].any() and (k[1][~hit] == 0).all()
    return k


@pytest.mark.parametrize("n_blocks", [1, 7, 300])
def test_cluster_pairs_kernel_equals_plain(quad_soup, n_blocks):
    """n_blocks clusters of seeded random sizes (1 to 700 pairs), every
    fifth pair with tmax 0 (it cannot hit)."""
    scene, meta = quad_soup
    dev = scene.clus_pack.device
    rng = np.random.default_rng(n_blocks)
    cid, x = _pairs(rng, rng.integers(1, 700, n_blocks), meta.n_clusters, dev)
    x[::5, 6] = 0.0
    k = _b4_kernel_equals_plain(scene, meta, cid, x)
    assert (k[4] >= 0).any() and not (k[4][::5] >= 0).any()


@pytest.mark.parametrize("size", [1, clusterpairs.TILE - 1, clusterpairs.TILE, clusterpairs.TILE + 1,
                                  3 * clusterpairs.TILE + 5])
def test_cluster_pairs_tile_edges_equal_plain(quad_soup, size):
    """Clusters of 1, T - 1, T, T + 1 and 3T + 5 pairs: full, partial and
    one-pair tiles and warps, in tiles of T and of 128."""
    scene, meta = quad_soup
    dev = scene.clus_pack.device
    cid, x = _pairs(np.random.default_rng(size), [size] * 3, meta.n_clusters, dev)
    for tile in (clusterpairs.TILE, 128):
        _b4_kernel_equals_plain(scene, meta, cid, x, tile)


@pytest.mark.parametrize("cnt", [1, 33])
def test_cluster_pairs_short_clusters_equal_plain(tie_scene, cnt):
    """Clusters cut to their first `cnt` columns (B4 takes the counts as
    given): one column, and one past a warp's 32."""
    scene, meta, _ = tie_scene
    dev = scene.clus_pack.device
    counts = torch.clamp(blocktrace.cluster_counts(scene, meta), max=cnt)
    n = 4096
    o, d = (torch.from_numpy(a).to(dev) for a in tie_rays(n, seed=cnt))
    cid = torch.arange(meta.n_clusters, dtype=torch.int32, device=dev).repeat_interleave(n // 8)
    ray = torch.arange(cid.numel(), device=dev) % n
    x = torch.cat([o[ray], d[ray], torch.full((ray.numel(), 1), 100.0, device=dev),
                   torch.zeros((ray.numel(), 1), device=dev)], dim=1)
    k = _b4_kernel_equals_plain(scene, meta, cid, x, counts=counts)
    hit = k[4] >= 0
    assert hit.any() and ((k[4][hit] - scene.clus_first[cid[hit].long()]) < cnt).all()


def test_cluster_pairs_edge_rays_equal_plain(quad_soup):
    """Pairs with tmax <= t_min (0, t_min itself, -1), NaN direction and
    origin components, and directions along the axes."""
    scene, meta = quad_soup
    dev = scene.clus_pack.device
    cid, x = _pairs(np.random.default_rng(21), [300, 257, 64, 1], meta.n_clusters, dev)
    x[0::11, 6] = 0.0
    x[1::11, 6] = 1e-3
    x[2::11, 6] = -1.0
    x[3::13, 4] = float("nan")
    x[4::17, 0] = float("nan")
    for a, step in ((3, 7), (4, 9), (5, 10)):
        axis = torch.zeros(3, device=dev)
        axis[a - 3] = -1.0 if a == 4 else 1.0
        x[a::step, 3:6] = axis
    k = _b4_kernel_equals_plain(scene, meta, cid, x)
    for start in (0, 1, 2):
        assert not (k[4][start::11] >= 0).any()
    assert (k[4] >= 0).any()


def test_cluster_pairs_ties_equal_plain(tie_scene):
    """Rays through tie_soup's stack against its two clusters of copies:
    bit-equal t in many columns, the lowest column wins."""
    scene, meta, stack = tie_scene
    dev = scene.clus_pack.device
    n = 2048
    o, d = (torch.from_numpy(a).to(dev) for a in tie_rays(n, seed=5))
    cids = torch.unique(torch.searchsorted(scene.clus_first.contiguous(), stack, right=True) - 1).to(torch.int32)
    assert cids.numel() == 2
    cid = cids.repeat_interleave(n)
    ray = torch.arange(n, device=dev).repeat(2)
    x = torch.cat([o[ray], d[ray], torch.full((2 * n, 1), 100.0, device=dev), torch.zeros((2 * n, 1), device=dev)], 1)
    k = _b4_kernel_equals_plain(scene, meta, cid, x)
    on_stack = torch.isin(k[4], stack)  # a ray that misses the stack may hit a soup triangle of the cluster
    assert on_stack.float().mean() > 0.1
    owner = torch.searchsorted(scene.clus_first.contiguous(), stack, right=True) - 1
    lowest = torch.stack([stack[owner == c].min() for c in cids])  # each cluster's first copy
    assert (k[4][on_stack] == lowest[(cid == cids[1]).long()][on_stack]).all()


def test_cluster_pairs_one_live_pair(quad_soup):
    """A round with a single live pair: one tile of one row."""
    scene, meta = quad_soup
    cid, x = _pairs(np.random.default_rng(2), [1], meta.n_clusters, scene.clus_pack.device)
    _b4_kernel_equals_plain(scene, meta, cid, x)


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("n_rays", [1000, 65536])
def test_bintrace_kernel_path_equals_plain_path(quad_soup, n_rays, nee):
    scene, meta = quad_soup  # bin-trace serves any ungated scene; this one fits the block trace too
    o, d = _trace_rays(n_rays, 11 * n_rays, scene.clus_pack.device)
    t_max = torch.full((n_rays,), 8.0 if nee else 100.0, device=o.device)
    t_max[: n_rays // 8] = -1.0
    bintrace.COUNTS.reset()
    before = clusterpairs.COUNTS.launches
    k = bintrace.intersect_bintrace(scene, meta, o, d, t_max, nee=nee, k=4)
    rounds_k, iters_k = bintrace.COUNTS.rounds, list(bintrace.COUNTS.iters)
    assert rounds_k >= 2 and 1 <= clusterpairs.COUNTS.launches - before <= rounds_k  # k = 4: extra rounds
    saved = clusterpairs.cluster_pairs
    clusterpairs.cluster_pairs = clusterpairs.cluster_pairs_plain
    bintrace.COUNTS.reset()
    try:
        p = bintrace.intersect_bintrace(scene, meta, o, d, t_max, nee=nee, k=4)
    finally:
        clusterpairs.cluster_pairs = saved
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert _bits_equal(a, b)
    assert (bintrace.COUNTS.rounds, bintrace.COUNTS.iters) == (rounds_k, iters_k)
    assert k.mask.any() and not k.mask[: n_rays // 8].any()
    if not nee:  # the block trace's plane test, another traversal: the same closest hits
        ref = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max)
        assert (k.tri == ref[4]).float().mean() >= 0.999


@pytest.mark.parametrize("kind", ["zsobol_16spp", "zsobol_8spp", "hash"])
@pytest.mark.parametrize("n", [1000, 65536])
def test_draws_kernel_equals_plain(dev, kind, n):
    """B6 against the sampler's own draws, bitwise on all 8 outputs (8 spp:
    odd log2spp, the pow2_samples branch; 1000: not a block multiple)."""
    rng = np.random.default_rng(n)
    px, py, s = (torch.from_numpy(rng.integers(0, hi, n)).to(dev) for hi in (512, 512, 8))
    spp = 8 if kind == "zsobol_8spp" else 16
    sampler = (qmc.HashSampler if kind == "hash" else qmc.ZSobolSampler)(spp, (512, 512), device=dev)
    state = sampler.init_lanes(px, py, s)
    for dim0 in (4, 28):
        setup = shade.sampler_draw_setup(sampler, state, dim0)
        before = shade.COUNTS_DRAWS.launches
        k = shade.draws(setup, n)
        assert shade.COUNTS_DRAWS.launches == before + 1
        p = shade.draws_plain(setup, n)
        torch.cuda.synchronize()
        for key in shade.DRAW_OUT:
            assert _bits_equal(k[key], p[key]), (key, dim0)


def _shade_lanes(n, seed, dev, dead_blocks=False):
    """B5's inputs for n random lanes with every lobe in play."""
    rng = np.random.default_rng(seed)
    uni = lambda lo=0.0, hi=1.0, shape=(n,): rng.uniform(lo, hi, shape).astype(np.float32)

    def unit():
        v = rng.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)

    rough = uni()
    rough[: n // 8] = uni(0.0, 0.03, (n // 8,))
    active = rng.uniform(size=n) < 0.9
    if dead_blocks:
        active &= (np.arange(n) // 4096) % 2 == 1
    a = dict(o=uni(-1, 1, (n, 3)), d=unit(), n=unit(), p=uni(-1, 1, (n, 3)), atten=uni(0.05, 1, (n, 3)),
             last_p=uni(-1, 1, (n, 3)), base=uni(0.05, 1, (n, 3)),
             emission=np.where(rng.uniform(size=(n, 1)) < 0.3, uni(0.5, 5, (n, 3)), 0).astype(np.float32),
             volume_color=uni(0, 1, (n, 3)), ls_wi=unit(), ls_Li=uni(0, 4, (n, 3)), ls_n=unit(),
             ls_p=uni(-2, 2, (n, 3)), roughness=rough, roughness_base=rough, ior=uni(1.05, 2.2),
             aniso_rotation=uni(-3, 3), volume_density=uni(0, 2), active=active,
             found=active & (rng.uniform(size=n) < 0.9))
    for k in ("last_pdf", "acc_rough", "hit_t", "u0", "u1", "uc", "uc2", "u_rr", "metallic", "transmission",
              "anisotropic", "clearcoat", "cc_roughness", "cc_roughness_base", "pdf_area", "sel_p", "ls_pdf",
              "ls_select_p"):
        a[k] = uni()
    for k, q in (("specular_prev", 0.2), ("light_neg", 0.7), ("hit_back", 0.3), ("thin", 0.3),
                 ("ls_valid", 0.9), ("ls_is_env", 0.3)):
        a[k] = rng.uniform(size=n) < q
    inp = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in a.items()}
    inp.update(depth0=False, rr_on=True, reg_threshold=0.5)
    return inp


@pytest.mark.parametrize("case", ["all_gates", "dead_blocks", "mis_off", "no_lights", "gates_off"])
def test_shade_kernel_equals_plain(dev, case):
    """B5 against shade_math.shade, bitwise on every output and lane (the
    kernel writes a dead lane's pass-through state, the twin zeroes its
    contrib and shadow_d)."""
    inp = _shade_lanes(65536 + 77, 5, dev, dead_blocks=case == "dead_blocks")
    gates = (False, False, False, False) if case == "gates_off" else (True, True, True, True)
    mis, any_lights = case != "mis_off", case != "no_lights"
    tables = lut.load_tables(dev)
    before = shade.COUNTS_SHADE.launches
    k = shade.shade(inp, gates, mis, any_lights, tables)
    assert shade.COUNTS_SHADE.launches == before + 1
    p = shade.shade_plain(inp, gates, mis, any_lights, tables)
    torch.cuda.synchronize()
    for key in k:
        assert _bits_equal(k[key], p[key].contiguous()), key
    assert k["active"].any() and (k["nee_need"].any() or not (mis and any_lights))


def _b5_equal(inp, gates, mis=True, any_lights=True):
    tables = lut.load_tables(inp["active"].device)
    k = shade.shade(inp, gates, mis, any_lights, tables)
    p = shade.shade_plain(inp, gates, mis, any_lights, tables)
    torch.cuda.synchronize()
    for key in k:
        assert _bits_equal(k[key], p[key].contiguous()), key
    return k, shade.mixed_warps(shade.lobe_keys(inp, gates, tables))


def _lobe_lanes(n, seed, dev, lobes):
    """Random lanes whose materials force lane i's pick to lobes[i % len]."""
    inp = _shade_lanes(n, seed, dev)
    kind = torch.arange(n, device=dev) % len(lobes)
    one, zero = torch.ones(n, device=dev), torch.zeros(n, device=dev)
    pick = {name: kind == i for i, name in enumerate(lobes)}
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    inp["clearcoat"] = torch.where(pick.get("coat", none), one, zero)
    inp["uc2"] = torch.where(pick.get("coat", none), zero, inp["uc2"])
    inp["metallic"] = torch.where(pick.get("metal", none), one, zero)
    inp["transmission"] = torch.where(pick.get("dielectric", none), one, zero)
    inp["active"] = torch.ones(n, dtype=torch.bool, device=dev)
    inp["found"] = inp["active"].clone()
    return inp


@pytest.mark.parametrize("case", ["one_lobe", "interleaved", "dead_tiles", "n_1", "n_127", "n_129", "n_2^20+77",
                                  "offset_1", "offset_3"])
def test_shade_tile_edges_equal_plain(dev, case):
    """B5's lobe-grouped tiles at their edges, bitwise: every lane of a
    tile on one lobe; the four lobes interleaved lane by lane (the grouping
    leaves no mixed warp); every other 128-lane tile dead; lane counts
    around a tile; every input a view with a storage offset (not 16-byte
    aligned; the kernel reads each input at any address)."""
    gates = (True, True, True, True)
    if case == "one_lobe":
        inp = _lobe_lanes(1 << 16, 1, dev, ("metal",))
    elif case == "interleaved":
        inp = _lobe_lanes(1 << 16, 2, dev, ("coat", "metal", "dielectric", "glossy"))
    elif case == "dead_tiles":
        inp = _shade_lanes(1 << 16, 3, dev)
        dead = (torch.arange(1 << 16, device=dev) // shade.SHADE_TILE) % 2 == 0
        inp["active"] &= ~dead
        inp["found"] &= ~dead
    elif case.startswith("n_"):
        inp = _shade_lanes({"n_1": 1, "n_127": 127, "n_129": 129, "n_2^20+77": (1 << 20) + 77}[case], 4, dev)
    else:
        off = int(case[-1])
        whole = _shade_lanes(1000 + off, 5, dev)
        inp = {k: v[off:] if isinstance(v, torch.Tensor) else v for k, v in whole.items()}
        assert inp["o"].data_ptr() % 16 and inp["active"].data_ptr() % 16
    before = shade.COUNTS_SHADE.launches
    k, mix = _b5_equal(inp, gates)
    assert shade.COUNTS_SHADE.launches == before + 1
    if case == "one_lobe":
        assert mix["lanes"]["metal"] == 1 << 16 and mix["mixed_before"] == mix["mixed_after"] == 0
    if case == "interleaved":
        assert mix["mixed_before"] == mix["warps"] and mix["mixed_after"] == 0
        assert all(mix["lanes"][x] == 1 << 14 for x in ("coat", "metal", "dielectric", "glossy"))
    if case == "dead_tiles":
        assert not k["active"][dead].any() and k["active"].any()


@pytest.mark.parametrize("gates", [(True, True, False, False), (True, False, False, False),
                                   (True, True, True, False), (False, True, True, True),
                                   (False, False, True, False)], ids=["MD", "M", "MDC", "DCA", "C"])
@pytest.mark.parametrize("mis", [True, False])
@pytest.mark.parametrize("n", [5000, (1 << 18) + 77])
def test_shade_instances_equal_plain(dev, gates, mis, n):
    """The flag combinations the kernel has its own instance for (the
    render paths' with NEE, the all-gates one without) and others that run
    the generic instance; at 40 tiles, and at 2,049, more than one wave of
    resident blocks (132 SMs x 8), where a block shades several tiles."""
    _b5_equal(_shade_lanes(n, 9, dev), gates, mis=mis)


def test_fused_render_on_card_goes_through_b5_b6(dev):
    """cornell-mat with shade_kernel="pallas": B6 and B5 once per bounce, no
    twin on CUDA, the image equal bitwise to "xla"'s."""
    scene, meta = cornell_box(extra_materials=True).compile()
    cam = CameraConfig(image_size=(16, 16), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
    imgs = {}
    for mode in ("xla", "pallas"):
        cfg = RenderConfig(samples=4, max_depth=6, tonemap="none", first_wave_samples=4, shade_kernel=mode)
        for c in (shade.COUNTS_SHADE, shade.COUNTS_DRAWS, integrator.BOUNCES):
            c.reset()
        imgs[mode] = Renderer(scene, meta, cam, cfg).render().hdr
        launches = (shade.COUNTS_SHADE.launches, shade.COUNTS_DRAWS.launches)
        assert launches == ((0, 0) if mode == "xla" else (integrator.BOUNCES.bounces,) * 2), (mode, launches)
        assert shade.COUNTS_SHADE.plain_cuda == shade.COUNTS_DRAWS.plain_cuda == 0
    assert np.array_equal(imgs["xla"].view(np.int32), imgs["pallas"].view(np.int32))


@pytest.mark.parametrize("windowed", [False, True], ids=["round1", "windowed"])
@pytest.mark.parametrize("k", [1, 2, 24, 128])
@pytest.mark.parametrize("n_rays", [1000, 65536])
def test_select_and_test_clusters_kernels_equal_plain(quad_soup, n_rays, k, windowed):
    """B7a and B7b at a round of the path; B7b with the scene's cluster
    counts (as the path calls it) and with every count C."""
    scene, meta = quad_soup
    o, d = _trace_rays(n_rays, 13 * n_rays, scene.clus_box.device)
    rays, w_key, act, _ = blocktrace.round_inputs(scene, meta, o, d, 100.0, k, windowed)
    counts = blocktrace.cluster_counts(scene, meta)
    every = torch.full_like(counts, meta.cluster_size)
    before = legacy.COUNTS_SELECT.launches, legacy.COUNTS_TEST.launches
    sel = legacy.select_clusters(rays, scene.clus_box, w_key, act, k, 1e-3)
    sel_p = legacy.select_clusters_plain(rays, scene.clus_box, w_key, act, k, 1e-3)
    slots = blocktrace.round_slots(scene, sel[0], sel[2], act)
    out = legacy.test_clusters(rays, scene.clus_pack, *slots, meta.cluster_size, k, 1e-3, counts)
    out_p = legacy.test_clusters_plain(rays, scene.clus_pack, *slots, meta.cluster_size, k, 1e-3, counts)
    out_all = legacy.test_clusters(rays, scene.clus_pack, *slots, meta.cluster_size, k, 1e-3, every)
    out_all_p = legacy.test_clusters_plain(rays, scene.clus_pack, *slots, meta.cluster_size, k, 1e-3, every)
    torch.cuda.synchronize()
    assert (legacy.COUNTS_SELECT.launches, legacy.COUNTS_TEST.launches) == (before[0] + 1, before[1] + 2)
    for a, b in zip(sel, sel_p):
        assert torch.equal(a, b)
    assert _bits_equal(out, out_p) and _bits_equal(out_all, out_all_p) and _bits_equal(out, out_all)
    assert (out[:, 4].view(torch.int32) >= 0).any()
    assert (sel[2][act == 0] == 0).all()
    if k == 1:
        assert (sel[1][act != 0] != legacy.KEY_DEAD).any()  # more keys than slots: a bound


B7A_EDGES = ("all_culled", "pad_lanes", "nan_zero_dirs", "tmin0_signed_zero", "far_tcur_pad_boxes", "cpad128",
             "cpad8192", "window_edge", "live0_and_overflow", "tmin_neg_signed_zero")
# Real boxes of a case (1,566 of 2,048 otherwise, the bench scene's), and its columns.
B7A_REAL = {"cpad128": 100, "cpad8192": 8000, "tmin_neg_signed_zero": 100}
B7A_CPAD = {"cpad128": 128, "cpad8192": 8192, "tmin_neg_signed_zero": 128}


def _b7a_boxes(rng, n_real: int, cpad: int):
    """clus_box [8, cpad]: n_real random boxes in [-6, 7.5]^3, pad boxes at +3e38."""
    box = np.full((8, cpad), 3.0e38, np.float32)
    box[6:8] = 0.0
    lo = rng.uniform(-6, 6, (n_real, 3))
    box[0:3, :n_real] = lo.T
    box[3:6, :n_real] = (lo + rng.uniform(0.05, 1.5, (n_real, 3))).T
    return box


def b7a_edge_case(case: str, dev):
    """(rays, clus_box, w_key, act, k, t_min) of a B7a edge case: 8 blocks of
    rays in random directions from [-8, 8]^3 at t_cur = 100 (block 3
    inactive), made on the host from a seed and changed as the case says."""
    rng = np.random.default_rng(B7A_EDGES.index(case) + 40)
    n_blocks, k, t_min = 8, 24, 1e-3
    n_real = B7A_REAL.get(case, 1566)
    box = _b7a_boxes(rng, n_real, B7A_CPAD.get(case, 2048))
    n = n_blocks * 128
    d = rng.normal(size=(n, 3))
    rays = np.zeros((n, 8), np.float32)
    rays[:, 0:3] = rng.uniform(-8, 8, (n, 3))
    rays[:, 3:6] = d / np.linalg.norm(d, axis=1, keepdims=True)
    rays[:, 6] = 100.0
    w_key = np.full(n_blocks, -(1 << 31), np.int32)
    act = np.ones(n_blocks, np.int32)
    act[3] = 0
    if case == "all_culled":  # every ray past the boxes in x, heading away
        rays[:, 0] = rng.uniform(8, 12, n)
        rays[:, 3] = np.abs(rays[:, 3]) + 0.05
    elif case == "pad_lanes":  # block 0 retired (t_cur -1, 0, t_min), block 1 in part
        rays[:128, 6] = np.resize(np.float32([-1.0, 0.0, 1e-3]), 128)
        rays[128:192, 6] = -1.0
    elif case == "nan_zero_dirs":
        rays[0:40, 3] = np.nan
        rays[40:80, 3:6] = 0.0
        rays[80:120, 4] = 0.0
        rays[120:160, 5] = -0.0
        rays[160:170, 0] = np.nan
        rays[170:180, 7] = np.nan
        rays[180:200, 3:5] = 1e-30
        rays[200:210, 1] = np.inf
        rays[256:384, 3:5] = 0.0  # block 2: rays along z only
        rays[256:384, 5] = np.sign(rays[256:384, 5]) + (rays[256:384, 5] == 0)
    elif case == "tmin0_signed_zero":  # entries of +-0: origins on box faces, signed zero coordinates
        t_min = 0.0
        box[0:3, :64] = 0.0
        box[3:6, :64] = rng.uniform(0.5, 2.0, (3, 64))
        box[3:6, 64:128] = -0.0
        box[0:3, 64:128] = -rng.uniform(0.5, 2.0, (3, 64))
        rays[:256, 0:3] = 0.0
        rays[:128, 0:3] *= -1.0
        rays[256:512, 0:3] = box[0:3, rng.integers(0, 128, 256)].T
        rays[512:640, 0:3] = box[3:6, rng.integers(0, 128, 128)].T
    elif case == "tmin_neg_signed_zero":  # t_min < 0 keeps entries of -0 and just below 0 as keys
        t_min = -1e-3
        box[0, :32] = -0.0  # x faces at -0: from an origin at +0 along +x the slab enters at -0 - 0 = -0
        box[3, :32] = rng.uniform(0.5, 2.0, 32)
        box[1:3, :32] = -rng.uniform(0.5, 2.0, (2, 32))
        box[4:6, :32] = rng.uniform(0.5, 2.0, (2, 32))
        rays[:256, 0:3] = 0.0  # blocks 0-1: every entry into those boxes is -0
        rays[:256, 3] = np.abs(rays[:256, 3]) + 0.05
        rays[256:384, 0:3] = 0.0  # block 2: origins just inside the x faces, entries in (-1e-3, 0)
        rays[256:384, 0] = rng.uniform(1e-6, 4e-5, 128)
        rays[256:384, 3] = np.abs(rays[256:384, 3]) + 0.05
    elif case == "far_tcur_pad_boxes":  # d = (2, 2, 2) from (c, c, c): every pad box entered at ~1.5e38
        rays[:256, 0:3] = rng.uniform(-1, 1, (256, 1)) + np.float32([20.0] * 128 + [0.0] * 128)[:, None]
        rays[:256, 3:6] = 2.0
        rays[:256, 6] = np.resize(np.float32([np.inf, 3.3e38]), 256)
        rays[256:512, 6] = 2.9e38
    elif case == "live0_and_overflow":  # blocks 0-1 miss every box; the others have more keys than slots
        k = 4
        rays[:256, 0] = 20.0
        rays[:256, 3] = np.abs(rays[:256, 3]) + 0.05
    t = lambda a: torch.from_numpy(a).to(dev)
    rays, box, w_key, act = t(rays), t(box), t(w_key), t(act)
    if case == "window_edge":  # windows at a live key (kept) and one past it (dropped)
        _, bound, _ = legacy.select_clusters_plain(rays, box, w_key, act, 3, t_min)
        w_key = torch.where(act != 0, bound + (torch.arange(n_blocks, device=dev) % 2).to(torch.int32), w_key)
    return rays, box, w_key, act, k, t_min


@pytest.mark.parametrize("case", B7A_EDGES)
def test_select_clusters_edges_equal_plain(dev, case):
    """B7a at the edges of its design (the cull, the live rays, the pad
    boxes, the two arithmetic paths, the selection), bitwise against its
    twin; with the per-block records of live rays, kept boxes and keys."""
    rays, box, w_key, act, k, t_min = b7a_edge_case(case, dev)
    n_blocks = act.shape[0]
    stats = torch.zeros((n_blocks, 3), dtype=torch.int32, device=dev)
    got = legacy.select_clusters_cuda(rays, box, w_key, act, k, t_min, stats=stats)
    want = legacy.select_clusters_plain(rays, box, w_key, act, k, t_min)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ids, bound_key, n_live = got
    live_rays, kept, keys = stats.unbind(1)
    assert (stats[act == 0] == 0).all() and (n_live == torch.clamp(keys, max=k)).all()
    assert ((bound_key != legacy.KEY_DEAD) == (keys > k)).all()
    if case == "all_culled":
        assert (kept == 0).all() and (n_live == 0).all()
    elif case == "pad_lanes":
        assert live_rays[0] == 0 and n_live[0] == 0 and live_rays[1] == 64
    elif case == "far_tcur_pad_boxes":
        assert (ids[0] >= B7A_REAL.get(case, 1566)).all()  # block 0 sees the pad boxes alone
    elif case == "live0_and_overflow":
        assert (n_live[:2] == 0).all() and (bound_key[4:] != legacy.KEY_DEAD).all()
    elif case == "window_edge":
        assert (n_live[act != 0] > 0).all()
    elif case == "tmin_neg_signed_zero":  # -0 (bits 0x80000000) is the least key; entries below 0 come next
        assert (ids[:3] < 32).all() and (bound_key[:3] < 0).all()
    if case in ("pad_lanes", "live0_and_overflow"):  # a retired or missing block keeps no box
        assert (kept[act != 0] < box.shape[1]).any() and (n_live > 0).any()


B7B_EDGES = ("clusters_1_and_C", "degenerate", "ties", "tcur_inf", "live_not_prefix", "repeated_ids",
             "one_block", "many_blocks", "c_30", "pad_columns_filled")


def b7b_edge_case(case: str, dev):
    """(rays, clus_pack, live, first, ids, c, k, t_min, counts) of a B7b edge
    case: 12 clusters of random triangles (C = 64) packed by
    `scene.clusters.woop_rows`, 4 blocks of rays toward them, k = 6 slots,
    made on the host from a seed and changed as the case says (c_30: C = 30,
    not a whole number of 16-byte words; pad_columns_filled: clusters of at
    most C / 2 triangles whose columns past the count hold the next
    cluster's triangles, so only the count keeps them out)."""
    from yart_tpu_torch.scene.clusters import ClusterCut, woop_rows

    rng = np.random.default_rng(B7B_EDGES.index(case) + 60)
    c, k, n_clus = 30 if case == "c_30" else 64, 6, 12
    n_blocks = {"one_block": 1, "many_blocks": 2048}.get(case, 4)
    counts = rng.integers(1, c + 1, n_clus).astype(np.int32)
    if case == "pad_columns_filled":
        counts = np.maximum(counts // 2, 1)
    if case == "clusters_1_and_C":
        counts[:] = np.resize(np.int32([1, c]), n_clus)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    n_tri = int(counts.sum())
    v0 = rng.uniform(-1.5, 1.5, (n_tri, 3))
    v1 = v0 + rng.normal(0, 0.5, (n_tri, 3))
    v2 = v0 + rng.normal(0, 0.5, (n_tri, 3))
    if case == "degenerate":  # every third triangle collinear or a point
        v1[::3] = v0[::3] + 0.3
        v2[::3] = v0[::3] + 0.6
        v1[1::6] = v2[1::6] = v0[1::6]
    if case == "ties":  # cluster 1 repeats cluster 0; columns 1 and 3 repeat column 0 within it
        counts[1] = counts[0] = max(counts[0], 4)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
        n_tri = int(counts.sum())
        v0, v1, v2 = (np.resize(a, (n_tri, 3)) for a in (v0, v1, v2))
        for a in (v0, v1, v2):
            a[[1, 3]] = a[0]
            a[first[1] : first[1] + counts[1]] = a[: counts[0]]
    cut = ClusterCut(first, counts, np.zeros((n_clus, 3), np.float32), np.zeros((n_clus, 3), np.float32))
    pack = woop_rows(v0.astype(np.float32), v1.astype(np.float32), v2.astype(np.float32), cut, c)
    if case == "pad_columns_filled":
        real = pack.copy()
        for i, n in enumerate(counts):
            for p in range(3):  # the n, eu, ev column blocks of rows 0-3
                pack[i, 0:4, p * c + n : (p + 1) * c] = real[(i + 1) % n_clus, 0:4, p * c : (p + 1) * c - n]
    n = n_blocks * 128
    o = rng.uniform(-3, 3, (n, 3))
    d = rng.uniform(-1, 1, (n, 3)) - o
    rays = np.zeros((n, 8), np.float32)
    rays[:, 0:3] = o
    rays[:, 3:6] = d / np.linalg.norm(d, axis=1, keepdims=True)
    rays[:, 6] = 100.0
    rays[::5, 7] = 1.0  # floors
    ids = rng.integers(0, n_clus, (n_blocks, k)).astype(np.int32)
    live = np.ones((n_blocks, k), np.int32)
    if case == "live_not_prefix":
        live = (rng.random((n_blocks, k)) < 0.5).astype(np.int32)
        live[0] = [0, 1, 0, 0, 1, 0]
    if case == "repeated_ids":
        ids[:, 2] = ids[:, 0]
        ids[:, 5] = ids[:, 0]
    if case == "ties":
        ids[:, 0], ids[:, 1] = 0, 1
    if case == "tcur_inf":  # t_cur = inf; cluster 11 holds one column at t = 3.1e38 for d = (0, 0, 1)
        rays[:, 6] = np.inf
        rays[:64, 0:3] = np.c_[rng.uniform(-1, 1, (64, 2)), np.zeros(64)]
        rays[:64, 3:6] = [0.0, 0.0, 1.0]
        rays[:64, 7] = 0.0
        counts[11] = 1
        pack[11] = 0.0
        pack[11, 2, 0] = 2e-12  # n.z
        pack[11, 3, 0] = 6.2e26  # cn
        pack[11, 3, c] = pack[11, 3, 2 * c] = -0.25  # cu, cv
        ids[0, :3] = 11
    if n_blocks > 1:
        live[1, :] = 0  # a block with no live slot
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    flat = lambda a: t(a.reshape(-1))
    return (t(rays), t(pack), flat(live), flat(first[ids]), flat(ids), c, k, 1e-3, t(counts))


@pytest.mark.parametrize("case", B7B_EDGES)
def test_test_clusters_edges_equal_plain(dev, case):
    """B7b at the edges of its design (real columns only, slot walk,
    staging), bitwise against its twin with the clusters' counts and with
    every count C; the two agree on packs with zero columns past each count
    and differ where those columns hold triangles."""
    rays, pack, live, first, ids, c, k, t_min, counts = b7b_edge_case(case, dev)
    outs = []
    for cnt in (counts, torch.full_like(counts, c)):
        got = legacy.test_clusters_cuda(rays, pack, live, first, ids, c, k, t_min, cnt)
        want = legacy.test_clusters_plain(rays, pack, live, first, ids, c, k, t_min, cnt)
        torch.cuda.synchronize()
        assert _bits_equal(got, want)
        outs.append(got)
    assert _bits_equal(outs[0], outs[1]) == (case != "pad_columns_filled")
    tri = outs[0][:, 4].view(torch.int32)
    assert (tri[128:256] == -1).all()  # block 1: no live slot
    assert (tri >= 0).any()
    if case == "tcur_inf":  # a block's every ray takes a pick (3e38 where nothing is valid)
        assert (outs[0][:128, 0] <= 3e38).all() and (outs[0][:64, 0] == 3e38).any()


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("n_rays", [1000, 65536])
def test_legacy_trace_kernel_path_equals_plain_path(quad_soup, n_rays, nee):
    scene, meta = quad_soup
    o, d = _trace_rays(n_rays, 17 * n_rays, scene.clus_box.device)
    t_max = torch.full((n_rays,), 8.0 if nee else 100.0, device=o.device)
    t_max[: n_rays // 8] = -1.0
    floor = torch.zeros(n_rays, device=o.device)
    floor[n_rays // 2 :] = 1.5
    legacy.COUNTS_SELECT.reset()
    legacy.COUNTS_TEST.reset()
    trace_k, trace_p = [], []
    k = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, nee=nee, floor=floor, fused=False, k=4,
                                        max_rounds=512, trace=trace_k)
    assert legacy.COUNTS_SELECT.launches == legacy.COUNTS_TEST.launches == len(trace_k) >= 2
    assert legacy.COUNTS_SELECT.plain_cuda == legacy.COUNTS_TEST.plain_cuda == 0
    saved = legacy.select_clusters, legacy.test_clusters
    legacy.select_clusters, legacy.test_clusters = legacy.select_clusters_plain, legacy.test_clusters_plain
    try:
        p = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, nee=nee, floor=floor, fused=False, k=4,
                                            max_rounds=512, trace=trace_p)
    finally:
        legacy.select_clusters, legacy.test_clusters = saved
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert _bits_equal(a, b)
    assert trace_k == trace_p
    hit = k[4] >= 0
    assert 0.05 < hit.float().mean() < 0.95 and not hit[: n_rays // 8].any()
    assert (k[0][hit & (floor > 0)] > 1.5).all()
    fused = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, nee=nee, floor=floor)
    assert torch.equal(hit, fused[4] >= 0)
    if not nee:
        assert _bits_equal(k[0], fused[0])


@pytest.mark.parametrize("nee", [False, True])
def test_gated_legacy_loop_kernel_path_equals_plain_path(ivy_soup, nee):
    scene, meta, o, d, seed = ivy_soup
    t_max = 6.0 if nee else 100.0
    legacy.COUNTS_SELECT.reset()
    trace_k, trace_p = [], []
    k = blocktrace.intersect_blocktrace_gated(scene, meta, o, d, t_max, nee=nee, alpha_seed=seed, trace=trace_k,
                                              fused=False)
    assert legacy.COUNTS_SELECT.launches > 0 and legacy.COUNTS_SELECT.plain_cuda == 0
    saved = legacy.select_clusters, legacy.test_clusters
    legacy.select_clusters, legacy.test_clusters = legacy.select_clusters_plain, legacy.test_clusters_plain
    try:
        p = blocktrace.intersect_blocktrace_gated(scene, meta, o, d, t_max, nee=nee, alpha_seed=seed,
                                                  trace=trace_p, fused=False)
    finally:
        legacy.select_clusters, legacy.test_clusters = saved
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert _bits_equal(a, b)
    assert trace_k == trace_p and len(trace_k) >= 3
    fused = blocktrace.intersect_blocktrace_gated(scene, meta, o, d, t_max, nee=nee, alpha_seed=seed)
    assert torch.equal(k.mask, fused.mask)


LAUNCHERS = [  # (module, launcher function, library): every kernel wrapper's binding
    (brute, "_library", "brute_intersect"),
    (presort, "_library", "presort_keys"),
    (fusedtrace, "_library", "fused_trace"),
    (clusterpairs, "_library", "cluster_pairs"),
    (shade, "_draws_fn", "draws"),
    (shade, "_shade_fn", "shade"),
    (legacy, "_select_fn", "select_clusters"),
    (legacy, "_test_fn", "test_clusters"),
]


@pytest.mark.parametrize("mod, fn, lib", LAUNCHERS, ids=[f"{m.__name__.split('.')[-1]}.{f}" for m, f, _ in LAUNCHERS])
def test_launcher_loads_its_library_once(quad_soup, monkeypatch, mod, fn, lib):
    """Each wrapper's launcher calls build.load once across two launches of
    its kernel (load hashes the sources on every call)."""
    scene, meta = quad_soup
    dev = scene.clus_pack.device
    calls = []
    real = mod.load
    monkeypatch.setattr(mod, "load", lambda name: (calls.append(name), real(name))[1])
    getattr(mod, fn).cache_clear()
    o, d = _trace_rays(1000, 3, dev)
    t_max = torch.full((1000,), 100.0, device=dev)
    rays = blocktrace.ray_matrix(o, d, t_max)
    if lib == "brute_intersect":
        run = lambda: brute.brute_intersect(scene.tri_pack, o, d, t_max, 36, 1e-3)
    elif lib == "presort_keys":
        run = lambda: presort.presort_keys(rays, scene.clus_box, meta.n_clusters, 1e-3)
    elif lib == "fused_trace":
        run = lambda: blocktrace.intersect_blocktrace(scene, meta, o, d, t_max)
    elif lib == "cluster_pairs":
        run = lambda: bintrace.intersect_bintrace(scene, meta, o, d, t_max, k=4)
    elif lib == "draws":
        sampler = qmc.ZSobolSampler(16, (64, 64), device=dev)
        state = sampler.init_lanes(*(torch.arange(1000, device=dev) % 64 for _ in range(2)),
                                   torch.zeros(1000, dtype=torch.int64, device=dev))
        run = lambda: shade.draws(shade.sampler_draw_setup(sampler, state, 4), 1000)
    elif lib == "shade":
        inp, tables = _shade_lanes(1000, 1, dev), lut.load_tables(dev)
        run = lambda: shade.shade(inp, (True,) * 4, True, True, tables)
    else:
        rin, w_key, act, _ = blocktrace.round_inputs(scene, meta, o, d, 100.0, 4, False)
        sel = legacy.select_clusters(rin, scene.clus_box, w_key, act, 4, 1e-3)
        slots = blocktrace.round_slots(scene, sel[0], sel[2], act)
        counts = blocktrace.cluster_counts(scene, meta)
        run = (lambda: legacy.select_clusters(rin, scene.clus_box, w_key, act, 4, 1e-3)) if lib == "select_clusters" \
            else (lambda: legacy.test_clusters(rin, scene.clus_pack, *slots, meta.cluster_size, 4, 1e-3, counts))
        calls.clear()
        getattr(mod, fn).cache_clear()
    run()
    run()
    torch.cuda.synchronize()
    assert calls.count(lib) == 1, calls


def _cornell_fwdbwd(dev, remat, plain=False):
    """One differentiable render of cornell-mat at 2^16 lanes (128x128, 4
    spp, depth 6, roulette off) and its backward w.r.t. base_color:
    (radiance, gradient, B1 launches forward, B1 launches backward, B1
    twin calls on CUDA). `plain` routes B1's calls to its twin."""
    scene, meta = cornell_box(extra_materials=True).compile(dev)
    cfg = RenderConfig(samples=4, max_depth=6, rr_start_depth=99, compact_depth=None, remat=remat)
    sampler = qmc.make_sampler("zsobol", 4, (128, 128), 0, device=dev)
    yy, xx = torch.meshgrid(torch.arange(128, device=dev), torch.arange(128, device=dev), indexing="ij")
    px, py = xx.reshape(-1).repeat_interleave(4), yy.reshape(-1).repeat_interleave(4)
    sidx = torch.arange(4, device=dev).repeat(128 * 128)
    cam = build_camera(CameraConfig(image_size=(128, 128), focal_length=28.0, position=(0, 1.0, 3.4),
                                    forward=(0, 0, -1)), dev)
    bc = scene.materials.base_color.clone().requires_grad_(True)
    s = dataclasses.replace(scene, materials=scene.materials._replace(base_color=bc))
    real = brute.brute_intersect
    if plain:
        brute.brute_intersect = brute.brute_plain
    try:
        brute.COUNTS.reset()
        rad, _ = integrator.render_wave(s, meta, cam, sampler, cfg, px, py, sidx, differentiable=True)
        fwd = brute.COUNTS.launches
        (g,) = torch.autograd.grad(rad.mean(), bc)
        torch.cuda.synchronize()
        bwd = brute.COUNTS.launches - fwd
    finally:
        brute.brute_intersect = real
    return rad.detach(), g, fwd, bwd, brute.COUNTS.plain_cuda


def test_cornell_fwdbwd_kernel_path_equals_twin_path(dev):
    """The differentiable path on the card: B1 launches in every forward
    bounce (camera and shadow rays) and never in the backward pass, under
    each remat policy; the kernel path's radiance equals the twin path's
    bitwise and its gradient agrees to 1e-5 of its largest entry (the
    backward of the material gather accumulates with atomics, so the last
    bits of a sum may differ between runs); the policies agree likewise."""
    out = {remat: _cornell_fwdbwd(dev, remat) for remat in ("trace_lut", "trace", "all")}
    rad_t, g_t, fwd_t, bwd_t, plain_cuda = _cornell_fwdbwd(dev, "trace_lut", plain=True)
    assert fwd_t == bwd_t == 0 and plain_cuda > 0
    ref_rad, ref_g = out["trace_lut"][:2]
    scale = float(ref_g.abs().max())
    assert torch.isfinite(ref_g).all() and scale > 0
    assert torch.equal(ref_rad.view(torch.int32), rad_t.view(torch.int32))
    assert float((ref_g - g_t).abs().max()) <= 1e-5 * scale
    for remat, (rad, g, fwd, bwd, plain) in out.items():
        assert fwd >= 6 and bwd == 0 and plain == 0, (remat, fwd, bwd, plain)
        assert torch.equal(rad.view(torch.int32), ref_rad.view(torch.int32)), remat
        assert float((g - ref_g).abs().max()) <= 1e-5 * scale, remat


@pytest.mark.parametrize("name", ["cornell_mat", "spheres"])
def test_glb_render_kernel_path_equals_twin_path(dev, name, tmp_path):
    """A scene written by the port's GLB exporter (and its environment by
    export_env_hdr), loaded back as the CLI loads it: a small render
    through the kernels (B1 for cornell-mat, B2 + B3 for spheres) equals
    the render through their plain twins bitwise."""
    from yart_tpu_torch.io.glb_export import export_env_hdr, export_glb
    from yart_tpu_torch.io.image import load_hdr
    from yart_tpu_torch.scene.gltf import load

    src = cornell_box(extra_materials=True) if name == "cornell_mat" else material_test_spheres()
    glb, sky = str(tmp_path / "s.glb"), str(tmp_path / "s.hdr")
    export_glb(src, glb)
    b = load(glb)
    if export_env_hdr(src, sky):
        b.set_env(load_hdr(sky), src._env_scale)
    scene, meta = b.compile(dev)
    pos, fwd = ((0, 1.0, 3.4), (0, 0, -1)) if name == "cornell_mat" else ((0, 2.2, 5.5), (0, -1.8, -6.1))
    cam = CameraConfig(image_size=(32, 32), focal_length=35.0, position=pos, forward=fwd)
    cfg = RenderConfig(samples=2, max_depth=4, tonemap="none", estimator="mean", first_wave_samples=2,
                       max_wave_samples=2)
    for c in (brute.COUNTS, presort.COUNTS, fusedtrace.COUNTS):
        c.reset()
    img_k = Renderer(scene, meta, cam, cfg, device=dev).render().hdr
    launched = (brute.COUNTS.launches, presort.COUNTS.launches, fusedtrace.COUNTS.launches)
    assert (launched[0] > 0) == (name == "cornell_mat") and (launched[2] > 0) == (name == "spheres")
    saved = brute.brute_intersect, presort.presort_keys, fusedtrace.fused_trace
    brute.brute_intersect, presort.presort_keys, fusedtrace.fused_trace = (
        brute.brute_plain, presort.presort_plain, fusedtrace.fused_trace_plain)
    try:
        img_p = Renderer(scene, meta, cam, cfg, device=dev).render().hdr
    finally:
        brute.brute_intersect, presort.presort_keys, fusedtrace.fused_trace = saved
    assert np.isfinite(img_k).all() and img_k.mean() > 0.01
    np.testing.assert_array_equal(img_k.view(np.int32), img_p.view(np.int32))


# ---------------------------------------------------------------- samplers and ranks


@pytest.mark.parametrize("kind", ["stratified", "zsobol:null", "zsobol:binary", "zsobol:owen"])
def test_new_samplers_pallas_kernel_path_equals_twin_path(dev, kind, monkeypatch):
    """cornell-mat, "pallas", with a sampler B6 does not draw: B6 launches
    0 times, B1 and B5 once a bounce, and the image equals the twin path's
    (B1's and B5's plain twins on the same CUDA tensors) bitwise."""
    scene, meta = cornell_box(extra_materials=True).compile(dev)
    cam = CameraConfig(image_size=(32, 32), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
    cfg = RenderConfig(samples=2, max_depth=4, tonemap="none", estimator="mean", first_wave_samples=2,
                       max_wave_samples=2, shade_kernel="pallas", sampler=kind)
    for c in (brute.COUNTS, shade.COUNTS_SHADE, shade.COUNTS_DRAWS, integrator.BOUNCES):
        c.reset()
    img_k = Renderer(scene, meta, cam, cfg, device=dev).render()
    bounces = integrator.BOUNCES.bounces
    assert shade.COUNTS_DRAWS.launches == 0 and bounces > 0
    assert shade.COUNTS_SHADE.launches == bounces and brute.COUNTS.launches >= bounces  # + the NEE casts
    monkeypatch.setattr(brute, "brute_intersect", brute.brute_plain)
    monkeypatch.setattr(shade, "shade", shade.shade_plain)
    img_p = Renderer(scene, meta, cam, cfg, device=dev).render()
    assert shade.COUNTS_SHADE.launches == bounces and shade.COUNTS_SHADE.plain_cuda > 0
    assert np.isfinite(img_k.hdr).all() and img_k.hdr.mean() > 0
    assert np.array_equal(img_k.hdr.view(np.int32), img_p.hdr.view(np.int32)) and img_k.total_rays == img_p.total_rays


def test_two_gloo_ranks_on_one_card_equal_one_process(dev, tmp_path):
    import torch_dist_worker as W

    from yart_tpu_torch.parallel import distributed

    cfg = dict(samples=4, max_depth=4, first_wave_samples=2, max_wave_samples=4, tonemap="none",
               shade_kernel="pallas")
    _, one = W.render(cfg, devices=None, device=dev)
    out = str(tmp_path / "r.npz")
    distributed.spawn(W.render_rank, 2, (out, cfg, None, None, "cuda"), device="cuda", backend="gloo")
    with np.load(out) as z:
        assert np.array_equal(one.hdr.view(np.int32), z["hdr"].view(np.int32))
        assert one.total_rays == float(z["rays"])


def test_two_nccl_ranks_on_one_card_are_refused(dev):
    from yart_tpu_torch.parallel import distributed

    if torch.cuda.device_count() != 1:
        pytest.skip("needs a host with exactly one card")
    msg = r"2 NCCL ranks on a host with 1 CUDA device.*backend='gloo'"
    with pytest.raises(RuntimeError, match=msg):
        distributed.spawn(print, 2, device="cuda", backend="nccl")
    with pytest.raises(RuntimeError, match=msg):  # a rank refuses before it joins
        distributed.init_distributed(f"tcp://127.0.0.1:{distributed.free_port()}", 2, 0, backend="nccl")
    assert not distributed.is_initialized()
