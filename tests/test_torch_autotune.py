"""The port's Renderer against the JAX package's on the compaction
autotune, and its chunking and config rules, on the CPU.

- `windowed_interior` (procedural.py): the builder's tables bit-equal to
  the JAX builder's (both on the native build, the JAX one compiled with
  the port's flags, tests/torch_native_lib.py); the autotune run as
  tests/test_render.py:376 runs it (16x16, 4 spp in two waves, depth 8):
  wave 0 on the env guess (2, 4), wave 1 on the measured choice, which
  must be the JAX Renderer's; per-depth live counts of wave 0 within 1%
  of the lanes of JAX's (XLA's and torch's float orders may retire a lane
  at another depth); the image equal to a compaction-off render bitwise;
  with ragged chunks the same live counts, choice and image.
- `RenderConfig(chunk_inflight=..., background=...)` constructs and
  renders, bitwise equal to a render without them (the port ignores both).
- A ragged last chunk: cornell at 10x10, 2 spp, depth 4 with
  `chunk_pixels=64` (chunks of 64 and 36 pixels) against one chunk of
  100: the same ray count and bitwise the same image (the port renders
  only the real pixels; the JAX Renderer also counts its padded lanes).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_native_lib import jax_native_at, jax_native_library
from yart_tpu.config import CameraConfig as JCam
from yart_tpu.config import RenderConfig as JCfg
from yart_tpu.render.renderer import Renderer as JRenderer
from yart_tpu.scene import procedural as JP
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.render.renderer import Renderer
from yart_tpu_torch.scene import procedural as TP


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def windowed(tmp_path_factory):
    """(JAX scene, JAX meta, port scene, port meta) of windowed_interior()."""
    lib = jax_native_library(tmp_path_factory.mktemp("jax_native"))
    with pytest.MonkeyPatch.context() as mp:
        jax_native_at(mp, lib)
        js, jm = JP.windowed_interior().compile()
    ts, tm = TP.windowed_interior().compile(device="cpu")
    return js, jm, ts, tm


def test_windowed_interior_tables_equal_jax(windowed):
    js, jm, ts, tm = windowed
    assert tm.has_env and tm.n_tris == jm.n_tris == 18
    for f in ("positions", "tri_v", "tri_pack", "shade_pack", "clus_pack", "clus_box", "node_pack", "wide_pack",
              "env_image", "env_alias", "scene_center", "scene_radius"):
        a, b = np.atleast_1d(getattr(ts, f).numpy()), np.atleast_1d(np.asarray(getattr(js, f)))
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), f


CAM = dict(image_size=(16, 16), focal_length=28.0, position=(0, 1.0, 0.8), forward=(0, 0, -1))
CFG = dict(samples=4, max_depth=8, tonemap="none", estimator="mean", first_wave_samples=2, max_wave_samples=2)


def test_autotune_windowed_interior_matches_jax(windowed):
    js, jm, ts, tm = windowed
    jw, tw = [], []
    JRenderer(js, jm, JCam(**CAM), JCfg(**CFG)).render(on_wave=lambda wd, _: jw.append(wd))
    cfg = RenderConfig(**CFG)
    img = Renderer(ts, tm, CameraConfig(**CAM), cfg, device="cpu").render(
        on_wave=lambda wd, _: tw.append(wd)).hdr
    assert len(tw) == len(jw) == 2
    # Wave 0 on the env guess; the measured live fraction at depth 2 rules
    # it out, and wave 1 takes the JAX Renderer's choice.
    assert tw[0].compact == jw[0].compact == (2, 4)
    n0 = 16 * 16 * 2
    np.testing.assert_allclose(tw[0].live, np.asarray(jw[0].live), atol=0.01 * n0)
    assert tw[0].live[2] > 0.8 * n0 / 4
    assert tw[1].compact == jw[1].compact and tw[1].compact != (2, 4)
    img_off = Renderer(ts, tm, CameraConfig(**CAM), dataclasses.replace(cfg, compact_depth=None),
                       device="cpu").render().hdr
    np.testing.assert_array_equal(img, img_off)
    # Ragged chunks (100 + 100 + 56 pixels): the port's live counts, and so
    # its choice, stay those of the whole image. (The JAX Renderer counts
    # its padded lanes too, and there picks (3, 2) instead of (4, 3).)
    rw = []
    img_r = Renderer(ts, tm, CameraConfig(**CAM), cfg, device="cpu").render(
        on_wave=lambda wd, _: rw.append(wd), chunk_pixels=100).hdr
    assert [w.compact for w in rw] == [w.compact for w in tw]
    np.testing.assert_array_equal(rw[0].live, tw[0].live)
    np.testing.assert_array_equal(img_r, img)


CORNELL_CAM = CameraConfig(image_size=(10, 10), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
CORNELL_CFG = RenderConfig(samples=2, max_depth=4, tonemap="none", estimator="mean", first_wave_samples=2,
                           max_wave_samples=2)


@pytest.fixture(scope="module")
def cornell():
    return TP.cornell_box().compile(device="cpu")


def _render(cornell, cfg=CORNELL_CFG, **kw):
    chunks = []
    r = Renderer(*cornell, CORNELL_CAM, cfg, device="cpu").render(on_chunk=lambda cd, _: chunks.append(cd), **kw)
    return r, chunks


def test_ignored_config_fields_render(cornell):
    ref, _ = _render(cornell)
    for fields in (dict(chunk_inflight=2, background=(0, 0, 0)), dict(chunk_inflight=1, background=(1.0, 0.5, 0.0))):
        r, _ = _render(cornell, RenderConfig(**{**dataclasses.asdict(CORNELL_CFG), **fields}))
        assert r.total_rays == ref.total_rays
        np.testing.assert_array_equal(r.hdr, ref.hdr)
    assert np.isfinite(ref.hdr).all() and ref.hdr.mean() > 0


def test_ragged_last_chunk_counts_real_lanes(cornell):
    one, c1 = _render(cornell, chunk_pixels=100)
    ragged, c2 = _render(cornell, chunk_pixels=64)
    assert [c.lanes_done for c in c1] == [100] and [c.lanes_done for c in c2] == [64, 100]
    assert ragged.total_rays == one.total_rays and one.total_rays >= 10 * 10 * 2
    assert c2[-1].rays == ragged.total_rays
    np.testing.assert_array_equal(ragged.hdr, one.hdr)
