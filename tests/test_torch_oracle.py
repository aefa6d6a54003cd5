"""The port against the reference renderer's own outputs
(tests/goldens/oracle_images.npz, tools/oracle), as tests/test_parity.py
holds the JAX package to them.

- BSDF probes: `bsdf_f` / `bsdf_pdf` on the reference's deterministic
  direction grids (`probe_aniso`, `probe_mixed`, `probe_thin`), f within
  5% relative and pdf within 1% (the bars of tests/test_parity.py:
  217-263); `bsdf_sample` on the `_smp` probes, flags on over 97% of lanes,
  wi within rtol 1e-3 / atol 2e-3, and at most 2% of lanes over 6% off in
  f or pdf with none over 60% (tests/test_parity.py:266-330). These probes
  found the reference quirks the port reproduces (the signed-cos thin
  transmission, the unrotated `pdfImpl`).
- `probe_draws`: ZSobol + FastOwen, get1d dims 0-15 and get2d dims 0-14,
  bitwise to the reference's sequential sampler.
- Images (16x16, depth 30, the port's own scene builders through
  `render_wave`, the default seed 0), with tests/test_parity.py's scenes,
  cameras and `_assert_image_parity`: here the cornell box without boxes
  (MIS and naive), cornell-mat, and the furnace sphere as rough glass,
  clearcoat, rough metal and rotated anisotropic metal (MIS); thin glass
  in tests/test_torch_oracle_thin.py and naive rough glass in
  tests/test_torch_oracle_naive.py (each file under a minute).
- Sample counts. The MIS images render at SPP_MIS = 64, the lowest of 32,
  64 and 128 at which every MIS image passed at each of seeds 0-4 (at 32
  cornell MIS, cornell-mat and clearcoat missed at some seeds). No count
  from 32 to 128 passes the naive images: their sample variance is 0 on
  pixels whose paths all take one route, where the re-baked LUTs move the
  value past the 2e-3 floor, and the JAX package's render fails the same
  bound with the same pixels (equal to the port's within 2.6e-6 for naive
  glass at 64 spp). They render at test_parity's own SPP_NAIVE = 512:
  naive glass passed at each of seeds 0-4, the naive cornell box at seeds
  0, 1, 3 and 4 (at seed 2 1.2% of its channels fell outside, against the
  1% allowed).
- The bound as applied. `_assert_image_parity` scales the oracle's noise
  from its own SPP constant (512): at 64 spp it allows 5 (s + s / 4) +
  2e-3 per channel, s the port's standard error at 64 spp; at 512 spp
  5 (s + s / 4) + 2e-3 as in test_parity. At most 1% of channels may fall
  outside (2.5% for cornell-mat), and image means must agree within
  max(5 mean(s) / 16 + 1e-3, 5e-3), for the furnace materials also 1.5%
  of the mean.
"""

import os

import numpy as np
import pytest
import torch

from test_parity import _assert_image_parity
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.ops import lut
from yart_tpu_torch.ops.qmc import ZSobolSampler, make_sampler
from yart_tpu_torch.render import bsdf as B
from yart_tpu_torch.render.camera import build_camera
from yart_tpu_torch.render.integrator import render_wave
from yart_tpu_torch.scene.procedural import cornell_box, furnace

torch.set_num_threads(2)
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "oracle_images.npz")
RES = 16
SPP_MIS = 64
SPP_NAIVE = 512
CORNELL_CAM = CameraConfig(image_size=(RES, RES), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
FURNACE_CAM = CameraConfig(image_size=(RES, RES), focal_length=30.0, position=(0, 0, 3.5), forward=(0, 0, -3.5))


@pytest.fixture(scope="module")
def oracle():
    with np.load(GOLDENS) as z:
        return {k: z[k] for k in z.files}


def render_port(builder, cam_cfg, mis: bool, seed: int = 0):
    """(mean image, per-pixel standard error) of a RES x RES render through
    the port's render_wave at SPP_MIS or SPP_NAIVE, one lane per (pixel,
    sample)."""
    spp = SPP_MIS if mis else SPP_NAIVE
    scene, meta = builder.compile(device="cpu")
    cfg = RenderConfig(samples=spp, max_depth=30, integrator="mis" if mis else "naive", seed=seed)
    cam = build_camera(cam_cfg, "cpu")
    sampler = make_sampler(cfg.sampler, spp, (RES, RES), cfg.seed, device="cpu")
    yy, xx = torch.meshgrid(torch.arange(RES), torch.arange(RES), indexing="ij")
    px = xx.reshape(-1).repeat_interleave(spp)
    py = yy.reshape(-1).repeat_interleave(spp)
    sidx = torch.arange(spp).repeat(RES * RES)
    with torch.no_grad():
        rad, _ = render_wave(scene, meta, cam, sampler, cfg, px, py, sidx)
    r = rad.numpy().astype(np.float64).reshape(RES, RES, spp, 3)
    mean = r.mean(axis=2)
    std = np.sqrt(np.maximum((r ** 2).mean(axis=2) - mean ** 2, 0.0) / spp)
    return mean, std


# key: (integrator is MIS, the furnace material) as tests/test_parity.py:154-194 builds them.
FURNACE_MATERIALS = {
    "glass_mis": (True, dict(roughness=0.2, transmission=1.0, ior=1.5)),
    "glass_naive": (False, dict(roughness=0.2, transmission=1.0, ior=1.5)),
    "thinglass_mis": (True, dict(roughness=0.2, transmission=1.0, ior=1.5, thin=True)),
    "clearcoat_mis": (True, dict(roughness=0.6, clearcoat=1.0, cc_roughness=0.1)),
    "metal_mis": (True, dict(roughness=0.3, metallic=1.0)),
    "aniso_mis": (True, dict(roughness=0.35, metallic=1.0, anisotropic=0.8, aniso_rotation=0.7)),
}


def furnace_material_parity(oracle, key):
    mis, material = FURNACE_MATERIALS[key]
    ours, std = render_port(furnace(env_value=0.5, **material), FURNACE_CAM, mis)
    _assert_image_parity(ours, std, oracle[key], int(oracle["spp"]), key, mean_rel=0.015)


@pytest.mark.parametrize("integrator", ["mis", "naive"])
def test_cornell_image_parity(oracle, integrator):
    ours, std = render_port(cornell_box(boxes=False), CORNELL_CAM, integrator == "mis")
    _assert_image_parity(ours, std, oracle[f"cornell_{integrator}"], int(oracle["spp"]), f"cornell {integrator}")


def test_cornell_mat_image_parity(oracle):
    ours, std = render_port(cornell_box(extra_materials=True), CORNELL_CAM, True)
    assert np.isfinite(ours).all()
    _assert_image_parity(ours, std, oracle["cornellmat_mis"], int(oracle["spp"]), "cornell-mat mis", frac=0.025)


@pytest.mark.parametrize("key", ["glass_mis", "clearcoat_mis", "metal_mis", "aniso_mis"])
def test_furnace_material_image_parity(oracle, key):
    furnace_material_parity(oracle, key)


def _probe_material(oracle, name, n):
    r, m, t, cc, ccr, thin, ior, aniso, arot = (float(x) for x in oracle[name + "_args"])
    ones = torch.ones(n)
    return B.LaneMaterial(
        base=torch.tensor([[0.8, 0.6, 0.4]]).repeat(n, 1), metallic=ones * m, roughness=ones * r,
        roughness_base=ones * r, transmission=ones * t, ior=ones * ior, anisotropic=ones * aniso,
        aniso_rotation=ones * arot, clearcoat=ones * cc, cc_roughness=ones * ccr, cc_roughness_base=ones * ccr,
        emission=torch.zeros(n, 3), thin=torch.full((n,), bool(thin)), volume_color=torch.ones(n, 3),
        volume_density=torch.zeros(n),
    )


def _f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("name", ["probe_aniso", "probe_mixed", "probe_thin"])
def test_bsdf_probe_parity(oracle, name):
    rows = np.asarray(oracle[name], np.float64)
    mat = _probe_material(oracle, name, rows.shape[0])
    tables = lut.load_tables("cpu")
    wo, wi = _f32(rows[:, 0:3]), _f32(rows[:, 3:6])
    f = B.bsdf_f(tables, mat, wo, wi).numpy().astype(np.float64)
    pdf = B.bsdf_pdf(tables, mat, wo, wi).numpy().astype(np.float64)
    relf = np.abs(f - rows[:, 6:9]) / np.maximum(np.abs(rows[:, 6:9]), 1e-3)
    relp = np.abs(pdf - rows[:, 9]) / np.maximum(np.abs(rows[:, 9]), 1e-3)
    assert relf.max() < 0.05, f"{name}: f max rel {relf.max():.4f}"
    assert relp.max() < 0.01, f"{name}: pdf max rel {relp.max():.5f}"


@pytest.mark.parametrize("name", ["probe_aniso", "probe_mixed", "probe_thin"])
def test_bsdf_sample_probe_parity(oracle, name):
    rows = np.asarray(oracle[name + "_smp"], np.float64)
    n = rows.shape[0]
    mat = _probe_material(oracle, name, n)
    smp = B.bsdf_sample(lut.load_tables("cpu"), mat, _f32(rows[:, 0:3]), _f32(rows[:, 3:5]), _f32(rows[:, 5]),
                        _f32(rows[:, 6]), torch.zeros(n, dtype=torch.bool))
    flags_ref = rows[:, 7].astype(np.int32)
    match = smp.flags.numpy() == flags_ref
    assert match.mean() > 0.97, f"{name}: flags mismatch on {(~match).sum()}/{n} lanes"
    match = match & (flags_ref != 0)  # absorbed lanes carry a direction nobody reads
    np.testing.assert_allclose(smp.wi.numpy().astype(np.float64)[match], rows[match, 8:11], rtol=1e-3, atol=2e-3,
                               err_msg=f"{name} wi")
    f, pdf = smp.f.numpy().astype(np.float64)[match], smp.pdf.numpy().astype(np.float64)[match]
    relf = np.abs(f - rows[match, 11:14]) / np.maximum(np.abs(rows[match, 11:14]), 1e-3)
    relp = np.abs(pdf - rows[match, 14]) / np.maximum(np.abs(rows[match, 14]), 1e-3)
    for rel, what in ((relf.max(axis=1), "f"), (relp, "pdf")):
        assert (rel > 0.06).mean() < 0.02, f"{name}: {int((rel > 0.06).sum())} lanes over 6% {what} delta"
        assert rel.max() < 0.6, f"{name}: sample {what} max rel {rel.max():.4f}"


def test_sampler_stream_bit_parity(oracle):
    rows = np.asarray(oracle["probe_draws"], np.float64)
    px, py, s = (torch.from_numpy(rows[:, k].astype(np.int64)) for k in range(3))
    zs = ZSobolSampler(8, (512, 512), seed=0, device="cpu")
    st = zs.init_lanes(px, py, s)
    for d in range(16):
        np.testing.assert_array_equal(zs.get1d(st, d).numpy(), rows[:, 3 + d].astype(np.float32),
                                      err_msg=f"get1d dim {d}")
    for k in range(8):
        np.testing.assert_array_equal(zs.get2d(st, 2 * k).numpy(), rows[:, 19 + 2 * k : 21 + 2 * k].astype(np.float32),
                                      err_msg=f"get2d dim {2 * k}")
