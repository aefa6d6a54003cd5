"""yart_tpu_torch: the PyTorch + CUDA port of yart_tpu.

The JAX package `yart_tpu` is the reference; this package mirrors its
layout (`ops/`, `render/`, `scene/`, `kernels/`, plus `csrc/` for the CUDA
sources) and is held against it by `tests/test_torch_*.py`.

Ported so far: the forward MIS/naive render path for ungated scenes of at
most 4096 triangles without textures or environment light (the Cornell
boxes), with the brute-force intersection as a hand-written Hopper kernel
(`kernels/brute.py`, `csrc/brute_intersect.cu`). Everything else raises
`NotImplementedError` naming its ROADMAP.md item.

This package imports torch and nothing of jax or of `yart_tpu`; its
configuration dataclasses (`config.py`) mirror `yart_tpu/config.py`.
"""

from yart_tpu_torch.config import CameraConfig, RenderConfig

__all__ = ["CameraConfig", "RenderConfig"]
