"""The port's instancing against the JAX package, on the CPU.

Scenes, each built by both builders from the same numpy inputs (both on
their numpy BVH paths):
- `spheres`: tests/test_instancing.py's scene (a diffuse sphere prototype
  under a translation and under a rotation with non-uniform scale, an
  emissive instance, a baked floor under a uniform env) plus a textured,
  normal-mapped quad prototype instanced rotated and non-uniformly scaled;
- `leaves`: `showcase.instanced_leaves()`, an alpha-tested leaf-quad
  prototype under 40 seeded rotated, non-uniformly scaled transforms and a
  thin glass pane instance (NEE transparency through the instance's normal
  matrix), over a baked floor;
- `atrium(tex_res=64, instanced=True)`.

Checks and tolerances:
- every table and meta field of all three scenes bit-equal to the JAX
  builder's (the sky HDRI of the atrium to rtol 1e-5: XLA:CPU's rsqrt is
  not correctly rounded, see tests/test_torch_textures.py), and the JAX
  scene carried across by `from_numpy` bit for bit;
- a mirrored instance raises ValueError;
- B3's instanced twin against `fused_trace_pallas` in interpret mode,
  through each side's `intersect_blocktrace`, closest hit, `nee` and
  `amask`, at tests/test_instancing.py's bar for the instanced kernel:
  masks equal, t within rtol/atol 2e-5, tri equal on >= 99.9% of hits (the
  ray transform o*r + ... may contract to FMAs under XLA:CPU), u/v within
  1e-5 where tri agrees;
- `shading_data` lane by lane (p, n, tg, uv within rtol 1e-5 / atol 1e-6;
  material, light and back exact);
- the gated instanced loop against `intersect_blocktrace_gated(...,
  interpret=True)`: masks, tri and back exact (the integer decisions), t,
  u, v and the transparent-shadow attenuation within 2e-5;
- a 24x24, 16 spp render of `spheres` against the JAX Renderer (which runs
  the per-instance loop `_intersect_instanced` on the CPU) at the port's
  image bar: >= 95% of pixels within rtol 1e-4 / atol 1e-5, channel means
  within 0.5%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_native_lib import numpy_twins
from test_torch_blocktrace import _check
from yart_tpu.config import CameraConfig as JCam
from yart_tpu.config import RenderConfig as JCfg
from yart_tpu.render import blocktrace as JBT
from yart_tpu.render import integrator as JI
from yart_tpu.render.intersect import Hit as JHit
from yart_tpu.render.renderer import Renderer as JRenderer
from yart_tpu.scene import showcase as JS
from yart_tpu.scene.builder import SceneBuilder as JSB
from yart_tpu.scene.procedural import _quad, uv_sphere
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.kernels import fusedtrace
from yart_tpu_torch.render import blocktrace as TBT
from yart_tpu_torch.render import integrator as TI
from yart_tpu_torch.render import intersect as TIn
from yart_tpu_torch.render.intersect import Hit as THit
from yart_tpu_torch.render.renderer import Renderer
from yart_tpu_torch.scene import showcase as TS
from yart_tpu_torch.scene.builder import SceneBuilder as TSB
from yart_tpu_torch.scene.convert import from_numpy
from yart_tpu_torch.scene.types import InstancedScene, TextureStack

torch.set_num_threads(2)
T = torch.from_numpy
SKY_FIELDS = ("env_image", "env_alias", "env_rows")
META_FIELDS = ("n_tris", "n_materials", "n_lights", "n_clusters", "n_clus_pad", "cluster_size", "has_env",
               "env_sampleable", "any_alpha", "any_transparent", "any_textures", "any_metallic",
               "n_instances", "inst_proto", "n_inst_clusters")


def _rot(axis, a):
    c, s = np.cos(a), np.sin(a)
    i, j = [k for k in range(3) if k != axis]
    m = np.eye(3)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def _affine(lin, t):
    m = np.eye(4)
    m[:3, :3] = lin
    m[:3, 3] = t
    return m


def _spheres(sb):
    """tests/test_instancing.py:32-60 (instanced) plus a textured,
    normal-mapped quad prototype under a rotation with non-uniform scale."""
    rng = np.random.default_rng(3)
    b = sb()
    t_base = b.add_texture("rgba", rng.uniform(0.2, 1.0, (16, 16, 4)).astype(np.float32))
    nrm = np.concatenate([rng.uniform(0.3, 0.7, (16, 16, 2)), np.ones((16, 16, 1))], axis=-1)
    t_nrm = b.add_texture("rgb", nrm.astype(np.float32))
    m_diff = b.add_material(base_color=(0.7, 0.4, 0.3, 1.0), roughness=0.7)
    m_emit = b.add_material(base_color=(0, 0, 0, 1), emission=(6, 5, 4))
    m_floor = b.add_material(roughness=0.9)
    m_tex = b.add_material(roughness=0.4, tex_base=t_base, tex_normal=t_nrm)
    pos, nrm_v, tri = uv_sphere((0.0, 0.0, 0.0), 0.6, n_theta=10, n_phi=16)
    pid = b.add_prototype(pos, tri, m_diff, normals=nrm_v)
    pe = b.add_prototype(pos, tri, m_emit, normals=nrm_v)
    b.add_instance(pid, _affine(np.eye(3), (-0.9, 0.7, 0.0)))
    b.add_instance(pid, _affine(_rot(1, 0.7) @ np.diag([0.6, 1.3, 0.8]), (1.0, 0.9, -0.4)))
    b.add_instance(pe, _affine(np.eye(3) * 0.3, (0.0, 1.6, 0.0)))
    qp = np.asarray([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0], [-0.5, 0.5, 0]], np.float32)
    uv = np.asarray([[0, 0], [2, 0], [2, 2], [0, 2]], np.float32)
    pq = b.add_prototype(qp, [[0, 1, 2], [0, 2, 3]], m_tex, uvs=uv)
    b.add_instance(pq, _affine(_rot(0, -0.3) @ _rot(1, 0.4) @ np.diag([1.6, 0.9, 1.2]), (0.2, 0.4, -1.2)))
    fp, ft = _quad((-3, -0.61, -3), (3, -0.61, -3), (3, -0.61, 3), (-3, -0.61, 3))
    b.add_mesh(fp, ft, m_floor)
    b.set_env_uniform((0.4, 0.4, 0.45))
    return b


BUILDERS = {"spheres": _spheres, "leaves": lambda sb: TS.instanced_leaves(builder=sb),
            "atrium_inst": lambda sb: (JS if sb is JSB else TS).atrium(tex_res=64, instanced=True)}


def _build(name):
    """(JAX scene as numpy leaves, JAX scene, JAX meta, port scene, port meta)."""
    with pytest.MonkeyPatch.context() as mp:
        numpy_twins(mp)
        js, jm = BUILDERS[name](JSB).compile()
        ts, tm = BUILDERS[name](TSB).compile(device="cpu")
    return jax.tree_util.tree_map(np.asarray, js), js, jm, ts, tm


@pytest.fixture(scope="module")
def spheres():
    return _build("spheres")


@pytest.fixture(scope="module")
def leaves():
    return _build("leaves")


def _bits_equal(a, b, msg):
    a, b = np.atleast_1d(a), np.atleast_1d(np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, (msg, a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=msg)


@pytest.mark.parametrize("name", ["spheres", "leaves", "atrium_inst"])
def test_builder_tables_equal_jax(name, request):
    npj, _, jm, ts, tm = request.getfixturevalue(name) if name != "atrium_inst" else _build(name)
    for f in META_FIELDS:
        assert getattr(tm, f) == getattr(jm, f), f
    assert tm.n_instances > 0 and 0 < tm.n_inst_clusters <= TBT.MAX_CLUSTERS
    # from_numpy carries the JAX scene across bit for bit, int rows included.
    cs, cm = from_numpy(npj, dataclasses.asdict(jm), device="cpu")
    assert isinstance(ts, InstancedScene) and isinstance(cs, InstancedScene) and cm == tm
    for f in dataclasses.fields(InstancedScene):
        if f.name == "protos":  # tests/test_torch_instloop.py compares the prototype scenes
            continue
        a, b, c = getattr(ts, f.name), getattr(npj, f.name), getattr(cs, f.name)
        if f.name == "materials" or isinstance(a, TextureStack):
            for g in a._fields:
                _bits_equal(getattr(a, g).numpy(), getattr(b, g), f"{f.name}.{g}")
                _bits_equal(getattr(c, g).numpy(), getattr(b, g), f"carried {f.name}.{g}")
            continue
        _bits_equal(c.numpy(), b, f"carried {f.name}")
        if name == "atrium_inst" and f.name in SKY_FIELDS:
            x, y = a.numpy(), np.asarray(b)
            if f.name == "env_alias":  # only each cell's own pdf compares
                x, y = x[:, 2], y[:, 2]
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-7, err_msg=f.name)
        else:
            _bits_equal(a.numpy(), b, f.name)
    # Each instance cluster's triangle count is its prototype cluster's.
    counts = TBT.cluster_counts(ts, tm).numpy()
    src = ts.clus_src[: tm.n_inst_clusters].numpy()
    per_src = {}
    for s, k in zip(src, counts):
        assert per_src.setdefault(int(s), int(k)) == k
    assert counts.sum() == tm.n_tris and (counts > 0).all() and (counts <= tm.cluster_size).all()
    if name == "atrium_inst":
        assert (tm.n_instances, len(set(tm.inst_proto))) == (95, 41) and tm.any_textures


def test_mirrored_instance_rejected():
    b = TSB()
    m = b.add_material()
    pos, nrm, tri = uv_sphere((0, 0, 0), 1.0, n_theta=6, n_phi=8)
    pid = b.add_prototype(pos, tri, m, normals=nrm)
    with pytest.raises(ValueError, match="orientation-preserving"):
        b.add_instance(pid, np.diag([-1.0, 1.0, 1.0, 1.0]))
    b.add_instance(pid, np.diag([2.0, 0.5, 1.0, 1.0]))


def _rays(rng, n, lo=-2.5, hi=2.5):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _port_cast(ts, tm, o, d, t_max, **kw):
    t, u, v, back, tri, _, _ = TBT.intersect_blocktrace(ts, tm, T(o), T(d), t_max, **kw)
    return dict(mask=(tri >= 0).numpy(), t=t.numpy(), u=u.numpy(), v=v.numpy(), back_side=back.numpy(),
                tri=tri.numpy())


def _fields(h):
    return {f: np.asarray(getattr(h, f)) for f in ("mask", "t", "u", "v", "back_side", "tri", "attenuation")}


@pytest.mark.parametrize("nee,t_max", [(False, 100.0), (True, 4.0)])
def test_instanced_twin_equals_pallas(spheres, nee, t_max):
    _, js, jm, ts, tm = spheres
    o, d = _rays(np.random.default_rng(7), 256)
    got = _port_cast(ts, tm, o, d, t_max, nee=nee)
    want = _fields(JBT.intersect_blocktrace(js, jm, jnp.asarray(o), jnp.asarray(d), t_max, nee=nee,
                                            interpret=True))
    if nee:  # any hit: only the mask is the contract
        np.testing.assert_array_equal(got["mask"], want["mask"])
    else:
        _check(got, want, 2e-5, 1e-5)
    assert 0.2 < got["mask"].mean() < 0.95
    # Both sphere instances, the textured quad and the floor take hits.
    inst = ts.tri_aux[T(got["tri"][got["mask"]]).long(), 1].numpy()
    assert {0, 1, 3, 4} <= set(inst.tolist()) or nee


def test_amask_twin_equals_pallas(leaves):
    _, js, jm, ts, tm = leaves
    rng = np.random.default_rng(9)
    o = np.asarray([0.0, 1.2, 5.0], np.float32) + rng.normal(size=(256, 3)).astype(np.float32) * 0.1
    target = np.stack([rng.uniform(-2, 2, 256), rng.uniform(0, 2, 256), rng.uniform(-2, 2, 256)], 1)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = _port_cast(ts, tm, o, d, 100.0, amask=True)
    want = _fields(JBT.intersect_blocktrace(js, jm, jnp.asarray(o), jnp.asarray(d), 100.0, amask=True,
                                            interpret=True))
    _check(got, want, 2e-5, 1e-5)
    raw = _port_cast(ts, tm, o, d, 100.0)
    assert (raw["mask"] & (raw["tri"] != got["tri"])).sum() > 0.02 * raw["mask"].sum()  # the cull culls


def test_shading_data_equals_jax(spheres):
    _, js, jm, ts, tm = spheres
    rng = np.random.default_rng(11)
    n = 1024
    tri = rng.integers(0, tm.n_tris, n).astype(np.int32)
    tri[:8] = -1
    u = rng.random(n, dtype=np.float32)
    v = (rng.random(n, dtype=np.float32) * (1.0 - u)).astype(np.float32)
    t = rng.uniform(0.1, 5.0, n).astype(np.float32)
    o, d = _rays(rng, n)
    back = rng.random(n) < 0.3
    mask = tri >= 0
    th = THit(T(t), T(tri), T(u), T(v), T(back), torch.ones((n, 3)), T(mask))
    jh = JHit(*(jnp.asarray(a) for a in (t, tri, u, v, back)), jnp.ones((n, 3)), jnp.asarray(mask))
    sh = TI.shading_data(ts, tm, th, T(o), T(d))
    jsh = jax.jit(JI.shading_data, static_argnums=1)(js, jm, jh, jnp.asarray(o), jnp.asarray(d))
    for f in ("p", "n", "tg", "uv"):
        np.testing.assert_allclose(sh_f := getattr(sh, f).numpy(), np.asarray(getattr(jsh, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
        assert np.isfinite(sh_f).all()
    for f in ("mat", "light", "back"):
        np.testing.assert_array_equal(getattr(sh, f).numpy(), np.asarray(getattr(jsh, f)), err_msg=f)
    # The instance matrices rotated normals, the normal map moved them, and
    # the emissive instance's triangles carry their world-space lights.
    lights = sh.light.numpy()
    assert (lights >= 0).any() and lights.max() == tm.n_lights - 1
    mapped = ts.materials.tex_normal.numpy()[sh.mat.numpy()] >= 0
    assert mapped.any()


@pytest.mark.parametrize("nee", [False, True])
def test_gated_loop_equals_jax(leaves, nee):
    _, js, jm, ts, tm = leaves
    assert tm.any_alpha and tm.any_transparent
    rng = np.random.default_rng(12)
    n = 256
    o = np.asarray([0.0, 1.2, 4.5], np.float32) + rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    target = np.stack([rng.uniform(-2, 2, n), rng.uniform(0, 2, n), rng.uniform(-2, 2, n)], 1)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    seed = rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
    t_max = 6.0 if nee else 100.0
    trace = []
    got = _fields(TBT.intersect_blocktrace_gated(ts, tm, T(o), T(d), t_max, nee=nee,
                                                 alpha_seed=T(seed.astype(np.int64)), trace=trace))
    want = _fields(JBT.intersect_blocktrace_gated(js, jm, jnp.asarray(o), jnp.asarray(d), t_max, nee=nee,
                                                  alpha_seed=jnp.asarray(seed), interpret=True))
    for f in ("mask", "tri", "back_side"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    m = got["mask"]
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(got[f][m], want[f][m], rtol=2e-5, atol=2e-5, err_msg=f)
    np.testing.assert_allclose(got["attenuation"], want["attenuation"], rtol=2e-5, atol=2e-5)
    assert len(trace) >= 2 and trace[1] > 0  # lanes passed through leaves (and the pane)
    if nee:
        assert (got["attenuation"][~m] < 1.0).any()  # shadows through the rotated pane


def test_dispatcher_routes_instanced_scenes(spheres, monkeypatch):
    _, _, _, ts, tm = spheres
    modes = []
    real = fusedtrace.fused_trace  # called as (rays, ..., t_min, nee, amask, inst)
    monkeypatch.setattr(fusedtrace, "fused_trace", lambda *a: modes.append(
        fusedtrace.mode_name(a[7], a[8], a[9] is not None)) or real(*a))
    o, d = _rays(np.random.default_rng(2), 256)
    n = o.shape[0]
    assert tm.n_tris < 4096  # small, yet no B1: the block trace in its instanced mode
    h = TIn.intersect(ts, tm, T(o), T(d), torch.full((n,), 100.0))
    TIn.intersect(ts, tm, T(o), T(d), torch.full((n,), 4.0), nee=True)
    assert modes == ["instanced", "instanced+nee"] and h.mask.any()
    # Past the cap: the per-instance loop (B1's twin per prototype here),
    # with the block trace's hits.
    big = dataclasses.replace(tm, n_inst_clusters=TBT.MAX_CLUSTERS + 1)
    hl = TIn.intersect(ts, big, T(o), T(d), torch.full((n,), 100.0))
    assert modes == ["instanced", "instanced+nee"]  # no B3 call
    assert torch.equal(hl.mask, h.mask) and (hl.tri == h.tri).float().mean() >= 0.999
    torch.testing.assert_close(hl.t[h.mask], h.t[h.mask], rtol=2e-5, atol=2e-5)


def test_render_matches_jax_renderer(spheres):
    _, js, jm, ts, tm = spheres
    kw = dict(image_size=(24, 24), focal_length=26.0, position=(0, 0.6, 4.0), forward=(0, -0.05, -1))
    cfg = dict(samples=16, max_depth=4, estimator="mean", first_wave_samples=16, max_wave_samples=16)
    img = Renderer(ts, tm, CameraConfig(**kw), RenderConfig(**cfg), device="cpu").render().hdr
    ref = np.asarray(JRenderer(js, jm, JCam(**kw), JCfg(**cfg)).render().hdr)
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)), rtol=5e-3)
