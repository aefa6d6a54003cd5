"""The live view (yart_tpu_torch/io/preview.py, port of yart_tpu/io/preview.py)
and the renderer's within-wave progress (`on_chunk`, `ChunkData`).

The server is driven over a loopback socket as tests/test_preview.py
drives the JAX one, its frames decoded by the port's own PNG decoder
(io/png.py: the card's machine has no PIL). The port's `on_chunk`
sequence matches the JAX Renderer's field for field (the ray counts within
max(8, 0.5%), the partial images `merged_hdr()` at the port's image bar:
>= 95% of pixels within rtol 1e-4 / atol 1e-5)."""

from __future__ import annotations

import dataclasses
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from yart_tpu.config import CameraConfig as JCam
from yart_tpu.config import RenderConfig as JCfg
from yart_tpu.render.renderer import Renderer as JRenderer
from yart_tpu.scene.procedural import cornell_box as j_cornell
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.io.png import decode_png
from yart_tpu_torch.io.preview import PreviewServer
from yart_tpu_torch.render.renderer import ChunkData, Renderer, WaveData
from yart_tpu_torch.scene.convert import from_numpy

CAM = dict(image_size=(16, 16), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
CFG = dict(samples=4, max_depth=3, estimator="mean", tonemap="none", first_wave_samples=2, max_wave_samples=4)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The port on one intra-op thread in this module (tests/test_torch_bsdf.py's docstring)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.read(), r.headers.get("Content-Type")


def test_preview_server_serves_frames_and_status():
    srv = PreviewServer(port=0)
    try:
        body, ctype = _get(srv.port, "/")
        assert ctype == "text/html" and b"yart-tpu live view" in body
        img = np.zeros((8, 6, 3), np.float32)
        img[..., 0] = 0.5
        srv.update(img, WaveData(wave=0, wave_samples=4, samples_taken=4, total_samples=16, rays=1e6, time=2.0))
        png1, ctype = _get(srv.port, "/frame.png")
        assert ctype == "image/png" and png1[:8] == b"\x89PNG\r\n\x1a\n"
        st, ctype = _get(srv.port, "/status")
        st = json.loads(st)
        assert ctype == "application/json"
        assert st["samples_taken"] == 4 and st["total_samples"] == 16 and st["frame"] == 1 and not st["done"]
        assert abs(st["mrays"] - 0.5) < 1e-6

        img[..., 1] = 1.0
        img[2, 3] = (0.25, 0.0, 1.0)
        srv.update(img, WaveData(wave=1, wave_samples=4, samples_taken=8, total_samples=16, rays=2e6, time=3.0),
                   done=True)
        png2, _ = _get(srv.port, "/frame.png?2")
        st2 = json.loads(_get(srv.port, "/status")[0])
        assert st2["frame"] == 2 and st2["done"] and st2["samples_taken"] == 8 and png2 != png1
        # The served PNG decodes back to the pushed image (8-bit, as written).
        rgba = decode_png(png2)
        assert rgba.shape == (8, 6, 4) and (rgba[..., 3] == 255).all()
        np.testing.assert_array_equal(rgba[..., :3], np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8))
        # A frame pushed without a WaveData (a partial one) keeps the status.
        srv.update(img * 0.5)
        st3 = json.loads(_get(srv.port, "/status")[0])
        assert st3["frame"] == 3 and st3["samples_taken"] == 8
    finally:
        srv.close()


def test_on_chunk_sequence_matches_jax_renderer():
    js, jm = j_cornell(extra_materials=True).compile()
    ts, tm = from_numpy(jax.tree_util.tree_map(np.asarray, js), dataclasses.asdict(jm), device="cpu")
    seen = {"jax": [], "port": []}

    def recorder(key):
        def on_chunk(cd, merged_hdr):
            seen[key].append((cd, np.asarray(merged_hdr())))
        return on_chunk

    chunk = 64  # 4 chunks a wave, none padded
    JRenderer(js, jm, JCam(**CAM), JCfg(**CFG)).render(on_chunk=recorder("jax"), chunk_pixels=chunk)
    res = Renderer(ts, tm, CameraConfig(**CAM), RenderConfig(**CFG), device="cpu").render(
        on_chunk=recorder("port"), chunk_pixels=chunk)
    assert len(seen["port"]) == len(seen["jax"]) == 8  # waves of 2 and 2 spp
    t_last = 0.0
    for (cj, ij), (ct, it) in zip(seen["jax"], seen["port"]):
        assert isinstance(ct, ChunkData)
        for f in ("wave", "wave_samples", "chunk", "n_chunks", "lanes_done", "lanes_total"):
            assert getattr(ct, f) == getattr(cj, f), f
        assert abs(ct.rays - cj.rays) <= max(8.0, 0.005 * cj.rays)
        assert ct.time >= t_last
        t_last = ct.time
        assert it.shape == ij.shape == (16, 16, 3)
        close = np.isclose(it, ij, rtol=1e-4, atol=1e-5).all(axis=-1)
        assert close.mean() >= 0.95, close.mean()
        # Pixels the first wave has not reached yet are still black.
        if ct.wave == 0:
            assert (it.reshape(-1, 3)[ct.lanes_done:] == 0).all()
    np.testing.assert_array_equal(seen["port"][-1][1], res.hdr)
    assert seen["port"][-1][0].rays == res.total_rays
