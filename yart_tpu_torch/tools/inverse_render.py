"""Inverse rendering: recover scene parameters from a target image.

Port of `yart_tpu/tools/inverse_render.py`, the product-level loop on the
differentiable renderer (render/diff.py): render a target with known
parameters, then descend from a perturbed scene back to it, with
`torch.optim.Adam` at optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8).

Library use:

    from yart_tpu_torch.tools.inverse_render import optimize_materials
    result = optimize_materials(scene, meta, cam, sampler, cfg, px, py,
                                sidx, target, steps=100)

Demo (the cornell red wall, perturbed and recovered):

    python -m yart_tpu_torch.tools.inverse_render [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import NamedTuple

import numpy as np
import torch


class InverseResult(NamedTuple):
    base_color: torch.Tensor  # recovered [M, 4] material table
    losses: list  # per-step scalar losses
    image: torch.Tensor  # final rendered image [N, 3]


def optimize_materials(scene, meta, cam, sampler, cfg, px, py, sidx, target, steps: int = 60,
                       lr: float = 0.05, mask=None, autotune_compaction: bool = True) -> InverseResult:
    """Adam-optimize the material base-colour table to match `target` ([N,
    3] radiance lanes) under a mean-squared loss. `mask` ([M] bool) freezes
    the rows where it is False; after each step the colour channels are
    clipped to [0, 1]. The sampler is a pure function of (pixel, sample,
    dim), so the loss has no noise but the fixed sample set's.

    With `autotune_compaction` and `cfg.compact_depth == "auto"`, one
    forward probe measures the per-depth live lanes and
    `renderer.choose_compaction` picks the staged compaction (split,
    factor) that every step then runs with."""
    from yart_tpu_torch.render.integrator import render_wave
    from yart_tpu_torch.render.renderer import choose_compaction

    if autotune_compaction and cfg.compact_depth == "auto":
        with torch.no_grad():
            _, _, live = render_wave(scene, meta, cam, sampler, cfg, px, py, sidx, return_live=True)
        choice = choose_compaction(live.cpu().numpy(), px.shape[0], cfg.max_depth)
        cfg = dataclasses.replace(cfg, compact_depth=choice[0] if choice else None,
                                  compact_factor=choice[1] if choice else cfg.compact_factor)

    bc0 = scene.materials.base_color
    target = torch.as_tensor(target, dtype=torch.float32, device=bc0.device)
    keep = (torch.ones(bc0.shape[0], dtype=torch.bool) if mask is None
            else torch.as_tensor(np.asarray(mask, bool))).to(bc0.device)
    bc = bc0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([bc], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    img = None
    for _ in range(steps):
        s = dataclasses.replace(scene, materials=scene.materials._replace(base_color=bc))
        img, _ = render_wave(s, meta, cam, sampler, cfg, px, py, sidx, differentiable=True)
        loss = ((img - target) ** 2).mean()
        opt.zero_grad(set_to_none=False)
        loss.backward()
        with torch.no_grad():
            bc.grad.mul_(keep[:, None])
        opt.step()
        with torch.no_grad():
            bc[:, :3] = torch.clamp(bc[:, :3], 0.0, 1.0)
        losses.append(float(loss.detach()))
    return InverseResult(bc.detach(), losses, img.detach())


def _demo(device: str = "cuda", steps: int = 80) -> InverseResult:
    from yart_tpu_torch.config import CameraConfig, RenderConfig
    from yart_tpu_torch.ops.qmc import make_sampler
    from yart_tpu_torch.render.camera import build_camera
    from yart_tpu_torch.render.integrator import render_wave
    from yart_tpu_torch.scene.procedural import cornell_box

    scene, meta = cornell_box().compile(device)
    size = (32, 32)
    spp = 4
    cam = build_camera(CameraConfig(image_size=size, focal_length=28.0, position=(0, 1.0, 3.4),
                                    forward=(0, 0, -1)), scene.tri_pack.device)
    cfg = RenderConfig(samples=spp, max_depth=3, rr_start_depth=99)
    dev = scene.tri_pack.device
    sampler = make_sampler(cfg.sampler, cfg.samples, size, cfg.seed, device=dev)
    yy, xx = np.meshgrid(np.arange(size[1]), np.arange(size[0]), indexing="ij")
    px = torch.from_numpy(np.repeat(xx.reshape(-1), spp)).to(dev)
    py = torch.from_numpy(np.repeat(yy.reshape(-1), spp)).to(dev)
    sidx = torch.from_numpy(np.tile(np.arange(spp), size[0] * size[1])).to(dev)
    with torch.no_grad():
        target, _ = render_wave(scene, meta, cam, sampler, cfg, px, py, sidx)

    # Perturb the red wall and recover it.
    bc_true = scene.materials.base_color.cpu().numpy()
    bc_bad = bc_true.copy()
    bc_bad[1, :3] = (0.3, 0.3, 0.6)
    scene_bad = dataclasses.replace(
        scene, materials=scene.materials._replace(base_color=torch.from_numpy(bc_bad).to(dev)))
    res = optimize_materials(scene_bad, meta, cam, sampler, cfg, px, py, sidx, target, steps=steps, lr=0.05)
    got = res.base_color.cpu().numpy()[1, :3]
    print(f"loss {res.losses[0]:.3e} -> {res.losses[-1]:.3e}")
    print(f"wall color true {bc_true[1, :3]} recovered {got}")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Recover the cornell box's red wall colour by inverse rendering.")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=80)
    args = ap.parse_args(argv)
    _demo(args.device, args.steps)


if __name__ == "__main__":
    main()
