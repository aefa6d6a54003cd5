"""The port's render slice: camera, light sampling and estimators against
the JAX package, the whole slice against the stored goldens, and the
renderer's and CLI's behaviour (compaction, checkpoints, refusals).

No test here compiles the JAX integrator: tests/goldens/golden_v1.npz
stands in for it (the JAX package reproduces those images exactly on CPU,
tests/test_golden.py)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yart_tpu import config as JC
from yart_tpu.render import camera as JCam
from yart_tpu.render import estimator as JE
from yart_tpu.render import lights as JLi
from yart_tpu.render import renderer as JR
from yart_tpu.scene.procedural import cornell_box as j_cornell
from yart_tpu_torch import cli
from yart_tpu_torch import config as TC
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.io.image import load_hdr
from yart_tpu_torch.render import camera as TCam
from yart_tpu_torch.render import estimator as TE
from yart_tpu_torch.render import lights as TLi
from yart_tpu_torch.render import renderer as TR
from yart_tpu_torch.scene.convert import from_numpy
from yart_tpu_torch.scene.builder import SceneBuilder as TSB
from yart_tpu_torch.scene.procedural import cornell_box as t_cornell
from yart_tpu_torch.scene.procedural import uv_sphere

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "golden_v1.npz")
T = torch.from_numpy


@pytest.fixture(scope="module")
def cornell_mat():
    """cornell-mat as compiled by the JAX package: (jax scene, jax meta,
    port scene, port meta)."""
    js, jm = j_cornell(extra_materials=True).compile()
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    return js, jm, ts, tm


def _golden_cfg(size):
    cam = CameraConfig(image_size=(size, size), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
    cfg = RenderConfig(samples=16, max_depth=6, tonemap="none", estimator="gmon",
                       first_wave_samples=16, max_wave_samples=16)
    return cam, cfg


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("name", ["CameraConfig", "RenderConfig"])
def test_config_mirrors_jax(name):
    """The port's config fields carry the JAX package's names and defaults
    (the camera's all of them), so one configuration reads the same in both."""
    jf = {f.name: f.default for f in dataclasses.fields(getattr(JC, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(TC, name))}
    assert {k: jf.get(k, "<missing>") for k in tf} == tf
    if name == "CameraConfig":
        assert tf == jf


# ---------------------------------------------------------------- camera


@pytest.mark.parametrize(
    "cfg",
    [
        CameraConfig(image_size=(40, 24), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1)),
        CameraConfig(image_size=(32, 32), focal_length=40.0, f_number=2.8, position=(0, 2.2, 5.5),
                     forward=(0, -1.8, -6.1), aperture_sides=6, exposure=1.5),
        CameraConfig(image_size=(16, 48), f_number=4.0, position=(1, 2, 3), forward=(-1, -1, -2)),
    ],
)
def test_camera_matches_jax(cfg):
    jc, tc = JCam.build_camera(cfg), TCam.build_camera(cfg, "cpu")
    for f in ("position", "top_left_pixel", "pixel_delta_u", "pixel_delta_v", "frame_x", "frame_y"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)), getattr(tc, f).numpy(), err_msg=f)
    assert float(jc.aperture_radius) == tc.aperture_radius
    assert float(jc.exposure_scale) == tc.exposure_scale
    rng = np.random.default_rng(0)
    w, h = cfg.image_size
    n = 2048
    px = rng.integers(0, w, n).astype(np.int32)
    py = rng.integers(0, h, n).astype(np.int32)
    uf, ul = rng.random((n, 2), dtype=np.float32), rng.random((n, 2), dtype=np.float32)
    jo, jd = JCam.generate_rays(jc, jnp.asarray(px), jnp.asarray(py), uf, ul)
    to, td = TCam.generate_rays(tc, T(px), T(py), T(uf), T(ul))
    # sin/cos/log of the jitter and lens warps differ by an ulp between
    # XLA and torch.
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- lights


@pytest.mark.parametrize("kind", ["power", "uniform"])
def test_sample_light_matches_jax(cornell_mat, kind):
    js, jm, ts, tm = cornell_mat
    rng = np.random.default_rng(1)
    n = 4096
    p = rng.uniform([-1, 0, -1], [1, 2, 1], (n, 3)).astype(np.float32)
    uc = rng.random(n, dtype=np.float32)
    u = rng.random((n, 2), dtype=np.float32)
    jl = JLi.sample_light(js, jm, jnp.asarray(p), jnp.asarray(uc), jnp.asarray(u), kind=kind)
    tl = TLi.sample_light(ts, tm, T(p), T(uc), T(u), kind=kind)
    for f in jl._fields:
        a, b = np.asarray(getattr(jl, f)), getattr(tl, f).numpy()
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=f)
    idx = T(np.arange(tm.n_lights))
    np.testing.assert_allclose(
        TLi.select_p_area(ts, tm, idx, kind).numpy(),
        np.asarray(JLi.select_p_area(js, jm, jnp.arange(jm.n_lights), kind)), rtol=1e-6,
    )
    assert TLi.p_infinite(tm) == JLi.p_infinite(jm)


# ---------------------------------------------------------------- estimator


@pytest.mark.parametrize("kind", ["mean", "mon", "gmonb", "gmon"])
@pytest.mark.parametrize("k", [4, 16, 64])
def test_estimator_matches_jax(kind, k):
    rng = np.random.default_rng(k)
    s = rng.lognormal(-1, 1.5, (512, k, 3)).astype(np.float32)
    s[rng.random((512, k)) < 0.02] = np.nan
    s[rng.random((512, k)) < 0.02] = -0.5
    s[:8] = rng.lognormal(-1, 0.1, (8, k, 3))  # low-Gini pixels (gmonb mean branch)
    # Bucket sums are taken in another order than XLA's einsum.
    np.testing.assert_allclose(
        TE.estimate(T(s), kind).numpy(), np.asarray(JE.estimate(jnp.asarray(s), kind)), rtol=1e-5, atol=1e-6
    )


def test_estimator_rejects_unknown_kind():
    with pytest.raises(ValueError):
        TE.estimate(torch.ones(2, 16, 3), "median")


# ---------------------------------------------------------------- renderer pieces


def test_wave_plan_and_compaction_choice_match_jax():
    for args in [(64, 64, 128), (64, 8, 128), (1000, 8, 128), (5, 16, 16)]:
        assert TR.wave_plan(*args) == JR.wave_plan(*args)
    rng = np.random.default_rng(2)
    for _ in range(50):
        n = 4096
        live = np.sort(rng.integers(0, n, 30))[::-1].astype(np.float64)
        live[rng.integers(5, 30):] = 0
        assert TR.choose_compaction(live, n, 30) == JR.choose_compaction(live, n, 30)


# ---------------------------------------------------------------- whole slice


def _image_matches_golden(img, golden):
    """The slice holds the golden with the same rtol/atol as
    tests/test_golden.py on >= 95% of pixels; the rest differ because a
    path through the rough glass/metal lobes diverges: last-ulp
    differences between XLA's and torch's transcendental functions are
    amplified by the sharp GGX lobes (alpha 0.0025) until a lobe choice or
    a roulette test flips. The image as a whole must still agree: mean
    absolute difference <= 1% of the mean, channel means within 0.5%."""
    close = np.isclose(img, golden, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.95, close.mean()
    assert np.abs(img - golden).mean() <= 0.01 * golden.mean()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), golden.mean(axis=(0, 1)), rtol=5e-3)


@pytest.mark.parametrize("key,size", [("cornell_mat", 16), ("cornell_mat_64", 64)])
def test_slice_matches_golden(cornell_mat, key, size):
    _, _, ts, tm = cornell_mat
    cam, cfg = _golden_cfg(size)
    res = TR.Renderer(ts, tm, cam, cfg, device="cpu").render()
    with np.load(GOLDEN) as z:
        golden = z[key]
    assert res.hdr.shape == golden.shape and np.isfinite(res.hdr).all()
    assert res.samples_taken == 16 and res.total_rays > size * size * 16
    _image_matches_golden(res.hdr, golden)


def test_port_built_scene_matches_golden_statistically():
    """The port's own builder (its numpy BVH order, no JAX) renders the same
    image statistics as the JAX-built golden."""
    ts, tm = t_cornell(extra_materials=True).compile(device="cpu")
    cam, cfg = _golden_cfg(16)
    img = TR.Renderer(ts, tm, cam, cfg, device="cpu").render().hdr
    with np.load(GOLDEN) as z:
        golden = z["cornell_mat"]
    np.testing.assert_allclose(img.mean(axis=(0, 1)), golden.mean(axis=(0, 1)), rtol=0.02)


@pytest.mark.parametrize("compact", [(2, 4), (2, 8), (1, 2)])
def test_compaction_is_bit_identical(cornell_mat, compact):
    """Staged compaction, including its overflow drain (factor 8 caps the
    compacted stage below the survivor count), changes no bit."""
    _, _, ts, tm = cornell_mat
    cam, cfg = _golden_cfg(16)
    off = TR.Renderer(ts, tm, cam, dataclasses.replace(cfg, compact_depth=None), device="cpu").render().hdr
    on = TR.Renderer(ts, tm, cam, dataclasses.replace(
        cfg, compact_depth=compact[0], compact_factor=compact[1]), device="cpu").render().hdr
    np.testing.assert_array_equal(off.view(np.int32), on.view(np.int32))


def test_naive_integrator_hash_sampler_and_waves(cornell_mat):
    """Other integrator/sampler/estimator paths run and stay physical; the
    on_wave callback sees the progressive plan and the autotune's choice."""
    _, _, ts, tm = cornell_mat
    cam = CameraConfig(image_size=(8, 8), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
    waves = []
    cfg = RenderConfig(samples=6, max_depth=4, integrator="naive", sampler="hash", estimator="mean",
                       first_wave_samples=2, max_wave_samples=4, tonemap="agx", agx_look="punchy",
                       clamp=10.0, regularize_specular=1)
    res = TR.Renderer(ts, tm, cam, cfg, device="cpu").render(on_wave=lambda wd, prev: waves.append((wd, prev)))
    assert [wd.wave_samples for wd, _ in waves] == [2, 4]
    assert waves[0][1].shape == (8, 8, 3)
    assert np.isfinite(res.hdr).all() and res.hdr.max() <= 10.0 and res.hdr.mean() > 0
    assert (res.display >= 0).all() and (res.display <= 1).all()


def test_checkpoint_resume_equals_full_render(cornell_mat, tmp_path):
    _, _, ts, tm = cornell_mat
    cam = CameraConfig(image_size=(8, 8), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
    cfg = RenderConfig(samples=12, max_depth=4, first_wave_samples=4, max_wave_samples=8, tonemap="none")
    full = TR.Renderer(ts, tm, cam, cfg, device="cpu").render().hdr
    ck = str(tmp_path / "ck.npz")
    part = TR.Renderer(ts, tm, cam, cfg, device="cpu").render(checkpoint=ck, max_waves=1)
    assert part.samples_taken == 4 and os.path.exists(ck)
    resumed = TR.Renderer(ts, tm, cam, cfg, device="cpu").render(checkpoint=ck)
    assert resumed.samples_taken == 12
    np.testing.assert_array_equal(resumed.hdr, full)


def test_renderer_refusals(cornell_mat):
    _, _, ts, tm = cornell_mat
    cam, cfg = _golden_cfg(4)
    # devices=2 renders over 2 ranks of a torch.distributed group, one
    # process each: one process alone cannot (tests/test_torch_distributed.py).
    with pytest.raises(ValueError, match="one rank of a group of 1.*--devices 2"):
        TR.Renderer(ts, tm, cam, cfg, devices=2, device="cpu")
    for d in (None, 1, "all"):
        assert TR.Renderer(ts, tm, cam, cfg, devices=d, device="cpu").n_devices == 1
    # A plain render ignores diff_geometry (it only acts in differentiable
    # mode), as the JAX Renderer does: the image is the one without it.
    cam8 = dataclasses.replace(cam, image_size=(8, 8))
    cfg4 = dataclasses.replace(cfg, samples=4, first_wave_samples=4, max_wave_samples=4, max_depth=3)
    np.testing.assert_array_equal(
        TR.Renderer(ts, tm, cam8, dataclasses.replace(cfg4, diff_geometry=True), device="cpu").render().hdr,
        TR.Renderer(ts, tm, cam8, cfg4, device="cpu").render().hdr)
    # The stratified sampler renders (its draws: tests/test_torch_samplers.py).
    strat = TR.Renderer(ts, tm, cam8, dataclasses.replace(cfg4, sampler="stratified"), device="cpu").render()
    assert strat.samples_taken == 4 and np.isfinite(strat.hdr).all() and strat.hdr.mean() > 0
    # Instanced scenes past the block trace's cap, refused until the
    # per-instance loop was ported, render through it: the image equals the
    # block trace's within float noise, with the alpha gates on too (no
    # material has alpha, so every hit passes them; the block trace would
    # cull with alpha-mask rows this scene never baked).
    b = TSB()
    pos, nrm, tri = uv_sphere((0.0, 1.0, 0.0), 0.4, n_theta=6, n_phi=8)
    pid = b.add_prototype(pos, tri, b.add_material(base_color=(0.7, 0.5, 0.3, 1.0)), normals=nrm)
    for x in (-0.6, 0.6):
        b.add_instance(pid, np.asarray([[1, 0, 0, x], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64))
    b.set_env_uniform((0.5, 0.5, 0.5))
    si, mi = b.compile(device="cpu")
    ref = TR.Renderer(si, mi, cam8, cfg4, device="cpu").render().hdr
    for fields in (dict(), dict(any_alpha=True)):
        past = dataclasses.replace(mi, n_inst_clusters=1 << 14, **fields)
        img = TR.Renderer(si, past, cam8, cfg4, device="cpu").render().hdr
        assert np.isfinite(img).all() and img.mean() > 0.01
        np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-5)
    # An env-lit scene renders: the env light is ported.
    env = TR.Renderer(ts, dataclasses.replace(tm, has_env=True), cam, cfg, device="cpu").render()
    assert env.samples_taken == cfg.samples and np.isfinite(env.hdr).all()


def test_cuda_device_without_gpu_fails_clearly(cornell_mat):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error path cannot be shown")
    _, _, ts, tm = cornell_mat
    cam, cfg = _golden_cfg(4)
    with pytest.raises(RuntimeError, match="cuda"):
        TR.Renderer(ts, tm, cam, cfg, device="cuda")
    with pytest.raises(SystemExit, match="CUDA"):
        cli.main(["cornell-mat", "--device", "cuda", "--size", "4x4", "--spp", "1"])


# ---------------------------------------------------------------- CLI


@pytest.mark.parametrize(
    "argv,dest,value",
    [
        (["cornell", "--devices", "2"], "devices", 2),
        (["cornell", "--distributed"], "distributed", True),
        (["cornell", "--serve", "8000"], "serve", 8000),
        (["cornell", "--serve-host", "0.0.0.0"], "serve_host", "0.0.0.0"),
        (["cornell", "--sampler", "stratified"], "sampler", "stratified"),
        (["cornell", "--sampler", "zsobol:owen"], "sampler", "zsobol:owen"),
        (["cornell", "--profile", "/tmp/x"], "profile", "/tmp/x"),
        (["cornell", "--preview", "p.png"], "preview", "p.png"),
        (["cornell", "--devices", "all"], "devices", "all"),
        (["cornell", "--debug-nan"], "debug_nan", True),
    ],
)
def test_cli_parses_every_jax_flag(argv, dest, value):
    """Every flag of the JAX CLI parses (none is refused any more)."""
    assert getattr(cli.parse_args(argv), dest) == value


@pytest.mark.parametrize("argv", [["cornell", "--sampler", "zsobol:fast"], ["cornell", "--devices", "0"],
                                  ["cornell", "--devices", "two"], ["nosuchscene"]])
def test_cli_rejects_bad_values(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli.parse_args(argv)
    err = capsys.readouterr().err
    assert e.value.code == 2 and ("invalid" in err or "no such file" in err)


def _ckpt(path):
    with np.load(path) as z:
        return z["hdr"], int(z["samples_taken"]), int(z["seed"])


def test_cli_config_defaults_and_explicit_flags_win(tmp_path):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"spp": 3, "size": "8x4", "seed": 5, "device": "cpu", "max-depth": 2,
                               "--first-wave": 3, "quiet": True}))
    ck = str(tmp_path / "ck.npz")
    assert cli.main(["cornell", "--config", str(cfg), "--seed", "2", "-o", str(tmp_path / "o.png"),
                     "--checkpoint", ck]) == 0
    hdr, spp, seed = _ckpt(ck)
    assert hdr.shape == (32, 3) and spp == 3 and seed == 2  # the file's spp and size; the flag's seed
    args = cli.parse_args(["cornell", "--config", str(cfg), "--spp", "7"])
    assert (args.spp, args.size, args.seed, args.device, args.max_depth) == (7, "8x4", 5, "cpu", 2)


def test_cli_config_unknown_key_exits_2(tmp_path, capsys):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"spp": 2, "bogus-flag": 1}))
    with pytest.raises(SystemExit) as e:
        cli.parse_args(["cornell", "--config", str(cfg)])
    assert e.value.code == 2 and "unknown config key: bogus-flag" in capsys.readouterr().err


def test_cli_preview_serve_profile_and_debug_nan(tmp_path, monkeypatch, capsys):
    """--preview writes the PNG every wave, --serve serves the frame and
    status over loopback while the render runs, --profile writes the
    profiler's chrome trace, --debug-nan passes a clean render."""
    import urllib.request

    from yart_tpu_torch.io import preview
    from yart_tpu_torch.io.png import decode_png

    seen = []
    update = preview.PreviewServer.update

    def probe(self, img, wave_data=None, done=False):
        update(self, img, wave_data, done)
        get = [urllib.request.urlopen(f"http://127.0.0.1:{self.port}{p}", timeout=5).read()
               for p in ("/status", "/frame.png")]
        seen.append((json.loads(get[0]), get[1]))

    monkeypatch.setattr(preview.PreviewServer, "update", probe)
    prev, prof = tmp_path / "p.png", tmp_path / "prof"
    assert cli.main(["cornell-mat", "--device", "cpu", "--size", "8x6", "--spp", "4", "--first-wave", "2",
                     "--max-depth", "3", "-o", str(tmp_path / "o.png"), "--preview", str(prev), "--serve", "0",
                     "--profile", str(prof), "--debug-nan"]) == 0
    out = capsys.readouterr().out
    assert "live view: http://127.0.0.1:" in out and "profile: " in out
    assert [s["samples_taken"] for s, _ in seen] == [2, 4, 4] and seen[-1][0]["done"]
    assert decode_png(seen[-1][1]).shape == (6, 8, 4)
    assert decode_png(prev.read_bytes()).shape == (6, 8, 4)
    trace = json.loads((prof / "trace.json").read_text())
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])


def test_cli_debug_nan_raises_naming_wave_and_chunk(monkeypatch):
    from yart_tpu_torch.render import renderer

    monkeypatch.setattr(renderer, "estimate", lambda samples, *a: torch.full(
        (samples.shape[0], 3), float("nan"), dtype=samples.dtype))
    argv = ["cornell", "--device", "cpu", "--size", "4x4", "--spp", "1", "--max-depth", "2", "--quiet", "-o",
            os.devnull + ".png"]
    with pytest.raises(FloatingPointError, match=r"NaN in wave 0 \(1 spp\) chunk 0 of 1"):
        cli.main(argv + ["--debug-nan"])


def test_cli_devices_beyond_the_cards_exits_with_the_count(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="this host has 1 CUDA device"):
        cli.main(["cornell", "--devices", "2", "--size", "4x4", "--spp", "1"])


@pytest.mark.parametrize("sampler", ["stratified", "zsobol:null", "zsobol:binary", "zsobol:owen"])
def test_cli_renders_every_sampler(tmp_path, sampler):
    ck = str(tmp_path / "ck.npz")
    assert cli.main(["cornell-mat", "--device", "cpu", "--size", "6x4", "--spp", "2", "--max-depth", "3",
                     "--sampler", sampler, "--quiet", "-o", str(tmp_path / "o.png"), "--checkpoint", ck]) == 0
    hdr, spp, _ = _ckpt(ck)
    assert spp == 2 and np.isfinite(hdr).all() and hdr.mean() > 0


def test_cli_renders_on_cpu(tmp_path, capsys):
    out = tmp_path / "o.png"
    assert cli.main(["cornell-mat", "--device", "cpu", "-o", str(out), "--size", "6x4",
                     "--spp", "2", "--max-depth", "3", "--first-wave", "2"]) == 0
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 50
    ppm = tmp_path / "o.ppm"
    cli.main(["cornell", "--device", "cpu", "-o", str(ppm), "--size", "4x4", "--spp", "1", "--quiet"])
    assert ppm.read_bytes().startswith(b"P6\n4 4\n255\n")
    assert "Mrays/s on cpu" in capsys.readouterr().out


def test_cli_renders_a_glb_file(tmp_path, capsys):
    """A scene file (the port-exported cornell-mat GLB) renders through the
    CLI, from the JAX CLI's default camera for a path."""
    from yart_tpu_torch.io.glb_export import export_glb

    glb = str(tmp_path / "box.glb")
    export_glb(t_cornell(extra_materials=True), glb)
    args = cli.parse_args([glb, "--camera-pos", "0,1,3.4"])
    cam, _ = cli.render_configs(args)
    assert cam.position == (0.0, 1.0, 3.4) and cam.forward == (0.0, 0.0, -3.4) and cam.exposure == 0.0
    cam, _ = cli.render_configs(cli.parse_args([glb]))
    assert (cam.position, cam.forward) == ((0, 1, 4), (0, 0, -4))
    out = tmp_path / "g.png"
    assert cli.main([glb, "--device", "cpu", "-o", str(out), "--size", "6x4", "--spp", "2", "--max-depth", "3",
                     "--camera-pos", "0,1,3.4"]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    printed = capsys.readouterr().out
    assert f"scene: {glb} (36 tris" in printed and "env=False" in printed


@pytest.mark.parametrize("scene", ["spheres", "glb"])
def test_cli_env_hdr_lights_any_scene(tmp_path, scene, capsys):
    """--env-hdr / --env-scale set the environment from a Radiance file on
    a procedural scene and on a scene file; the image is brighter at a
    larger scale."""
    from yart_tpu_torch.io.glb_export import export_glb
    from yart_tpu_torch.io.image import save_hdr

    sky = str(tmp_path / "sky.hdr")
    save_hdr(sky, np.random.default_rng(3).lognormal(0, 0.5, (8, 8, 3)).astype(np.float32))
    if scene == "glb":
        scene = str(tmp_path / "box.glb")
        export_glb(t_cornell(), scene)
    args = cli.parse_args([scene, "--env-hdr", sky, "--env-scale", "2.5"])
    ts, tm = cli.build_scene(args, "cpu")
    assert tm.has_env and tuple(ts.env_image.shape) == (8, 8, 3)
    np.testing.assert_array_equal(ts.env_image.numpy(), load_hdr(sky) * np.float32(2.5))
    means = []
    for k in ("1", "3"):
        out = tmp_path / f"e{k}.ppm"
        assert cli.main([scene, "--env-hdr", sky, "--env-scale", k, "--device", "cpu", "-o", str(out),
                         "--size", "4x4", "--spp", "1", "--max-depth", "2", "--tonemap", "none",
                         "--camera-pos", "0,1,6"]) == 0
        means.append(np.frombuffer(out.read_bytes()[-48:], np.uint8).mean())
    assert "env=True" in capsys.readouterr().out and means[1] > means[0]


@pytest.mark.parametrize("argv", [["missing.glb"], ["cornell", "--env-hdr", "missing_sky.hdr"]],
                         ids=["scene", "env_hdr"])
def test_cli_missing_file_names_itself(argv, tmp_path, capsys):
    argv = [str(tmp_path / a) if a.startswith("missing") else a for a in argv]
    with pytest.raises(SystemExit) as e:
        cli.parse_args(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert str(tmp_path / ("missing.glb" if len(argv) == 1 else "missing_sky.hdr")) in err and "no such file" in err


def test_cli_env_scale_without_env_hdr_is_accepted():
    """As in the JAX CLI, --env-scale alone is accepted and changes nothing
    (it scales only an --env-hdr image)."""
    args = cli.parse_args(["furnace", "--env-scale", "2"])
    assert args.env_scale == 2.0 and args.env_hdr is None
    a, am = cli.build_scene(args, "cpu")
    b, bm = cli.build_scene(cli.parse_args(["furnace"]), "cpu")
    assert am == bm and torch.equal(a.env_image, b.env_image)
