"""Ranks of the multi-process tests: tests/test_torch_distributed.py (CPU
ranks) and tests/test_torch_cuda.py (ranks on the card).

Each `*_rank` function runs in a process started by
`yart_tpu_torch.parallel.distributed.spawn` (gloo), after
`init_distributed` joined the group, as fn(rank, *args); rank 0 saves
what the test compares. Only the port is imported here: no JAX.
"""

import numpy as np
import torch

from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.render.renderer import Renderer
from yart_tpu_torch.scene.procedural import cornell_box

CAM = dict(image_size=(24, 16), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
DIFF_CAM = dict(image_size=(16, 16), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
DIFF_SPP = 2


def cornell_env(device="cpu"):
    """cornell-mat under a uniform env: env-lit, so compaction runs."""
    b = cornell_box(extra_materials=True)
    b.set_env_uniform((0.4, 0.45, 0.5))
    return b.compile(device=device)


def render(cfg: dict, checkpoint=None, max_waves=None, devices="all", device="cpu"):
    """The port's render of cornell_env() at CAM with RenderConfig(**cfg)."""
    torch.set_num_threads(1)
    scene, meta = cornell_env(device)
    r = Renderer(scene, meta, CameraConfig(**CAM), RenderConfig(**cfg), device=device, devices=devices)
    return r, r.render(checkpoint=checkpoint, max_waves=max_waves)


def render_rank(rank, out, cfg, checkpoint, max_waves, device="cpu"):
    r, res = render(cfg, checkpoint, max_waves, device=device)
    assert r.sharded and r.n_devices == torch.distributed.get_world_size()
    if rank == 0:
        np.savez(out, hdr=res.hdr, rays=res.total_rays, samples=res.samples_taken)


def diff_lanes():
    """(px, py, sample index) of every lane of DIFF_CAM at DIFF_SPP."""
    w, h = DIFF_CAM["image_size"]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = torch.from_numpy(np.repeat(xx.reshape(-1), DIFF_SPP))
    py = torch.from_numpy(np.repeat(yy.reshape(-1), DIFF_SPP))
    s = torch.from_numpy(np.tile(np.arange(DIFF_SPP), w * h))
    return px, py, s


def base_color_loss_grad(lanes=None):
    """(mean radiance of the lanes over every lane's count, its gradient
    w.r.t. the materials' base_color) of cornell-mat at DIFF_CAM: the
    problem of tests/multihost_worker.py (depth 3, roulette off)."""
    from yart_tpu_torch.ops.qmc import make_sampler
    from yart_tpu_torch.render.camera import build_camera
    from yart_tpu_torch.render.diff import material_grads

    torch.set_num_threads(1)
    scene, meta = cornell_box().compile(device="cpu")
    cfg = RenderConfig(samples=DIFF_SPP, max_depth=3, rr_start_depth=99)
    px, py, s = diff_lanes()
    n = px.shape[0]
    sl = slice(0, n) if lanes is None else lanes
    sampler = make_sampler(cfg.sampler, cfg.samples, DIFF_CAM["image_size"], cfg.seed, device="cpu")
    loss, grads = material_grads(scene, meta, build_camera(CameraConfig(**DIFF_CAM), "cpu"), sampler, cfg,
                                 px[sl], py[sl], s[sl], lambda rad: rad.sum() / (n * 3), fields=["base_color"])
    return loss, grads["base_color"]


def grad_rank(rank, out):
    """This rank's share of the lanes (an even split), the loss and the
    gradient summed over the ranks as XLA's psum sums them."""
    from yart_tpu_torch.parallel import distributed, sharding

    n = diff_lanes()[0].shape[0]
    loss, grad = base_color_loss_grad(distributed.local_lane_slice(n))
    loss = sharding.sum_ranks(loss)
    sharding.all_reduce_grads([grad])
    if rank == 0:
        np.savez(out, loss=loss.numpy(), grad=grad.numpy())
