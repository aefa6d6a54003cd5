"""B1 on the card: the Hopper kernel against its plain PyTorch twin.

These tests need a CUDA GPU (sm_90a for the kernel build) and skip
without one. They import no JAX, so they also run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel is built with --fmad=false and follows `_mt_test`'s operation
order, so kernel and twin must agree bitwise."""

import numpy as np
import pytest
import torch

from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.kernels import brute
from yart_tpu_torch.render.renderer import Renderer
from yart_tpu_torch.scene.procedural import cornell_box

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


def test_render_on_card_goes_through_kernel(dev):
    scene, meta = cornell_box(extra_materials=True).compile(dev)
    cam = CameraConfig(image_size=(16, 16), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
    cfg = RenderConfig(samples=4, max_depth=6, tonemap="none", first_wave_samples=4)
    brute.COUNTS.reset()
    img = Renderer(scene, meta, cam, cfg, device=dev).render().hdr
    assert brute.COUNTS.launches > 0 and brute.COUNTS.plain_cuda == 0
    assert np.isfinite(img).all() and img.mean() > 0.01
