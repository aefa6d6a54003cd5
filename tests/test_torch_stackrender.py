"""Renders through the port's stack traversals and per-instance loop
against the JAX Renderer, on the CPU (24x24, 2 spp, depth 2, the mean
estimator), at the port's image bar: >= 95% of pixels within rtol 1e-4 /
atol 1e-5, channel means within 0.5%.

- The gated ivy of tests/test_torch_stacktrace.py (4,202 triangles,
  alpha-tested), its cluster count replaced past the block trace's cap:
  every cast takes `intersect_bvh8` (fewer than 131,072 rays) in the port,
  and in the JAX package, which sends gated scenes of more than 4096
  triangles there on the CPU.
- tests/test_torch_instancing.py's `spheres`, its instance-cluster count
  replaced past the cap: every cast takes the per-instance loop in the
  port, as in the JAX package on the CPU.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_instancing import _build
from test_torch_stacktrace import _ivy
from torch_native_lib import numpy_twins
from yart_tpu.config import CameraConfig as JCam
from yart_tpu.config import RenderConfig as JCfg
from yart_tpu.render.renderer import Renderer as JRenderer
from yart_tpu.scene.builder import SceneBuilder as JSB
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.render import blocktrace as TBT
from yart_tpu_torch.render import intersect as TIn
from yart_tpu_torch.render import stacktrace as TS
from yart_tpu_torch.render.renderer import Renderer
from yart_tpu_torch.scene.builder import SceneBuilder as TSB

CFG = dict(samples=2, max_depth=2, estimator="mean", first_wave_samples=2, max_wave_samples=2)


def _compare(ts, tm, js, jm, cam):
    img = Renderer(ts, tm, CameraConfig(**cam), RenderConfig(**CFG), device="cpu").render().hdr
    ref = np.asarray(JRenderer(js, jm, JCam(**cam), JCfg(**CFG)).render().hdr)
    assert img.shape == ref.shape and np.isfinite(img).all() and img.mean() > 0.01
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)), rtol=5e-3)


def test_gated_render_through_the_stack_traversal_matches_jax():
    with pytest.MonkeyPatch.context() as mp:
        numpy_twins(mp)
        js, jm = _ivy(JSB).compile(cluster_size=64)
        ts, tm = _ivy(TSB).compile(device="cpu", cluster_size=64)
    assert tm.n_tris > 4096 and tm.any_alpha
    TS.COUNTS.reset()
    _compare(ts, dataclasses.replace(tm, n_clusters=TBT.MAX_CLUSTERS + 1), js, jm,
             dict(image_size=(24, 24), focal_length=26.0, position=(0.0, 1.4, 4.5), forward=(0.0, -0.25, -1.0)))
    assert TS.COUNTS.calls >= 2  # camera and shadow rays


def test_instanced_render_through_the_loop_matches_jax(monkeypatch):
    _, js, jm, ts, tm = _build("spheres")
    calls = []
    real = TIn.intersect_instanced
    monkeypatch.setattr(TIn, "intersect_instanced", lambda *a, **k: calls.append(1) or real(*a, **k))
    _compare(ts, dataclasses.replace(tm, n_inst_clusters=TBT.MAX_CLUSTERS + 1), js, jm,
             dict(image_size=(24, 24), focal_length=26.0, position=(0, 0.6, 4.0), forward=(0, -0.05, -1)))
    assert len(calls) >= 2  # camera and shadow rays
