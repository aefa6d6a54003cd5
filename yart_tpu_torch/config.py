"""Configuration dataclasses of the port.

The port keeps its own copies so that it depends on nothing of the JAX
package. Every field has the name and default of its counterpart in
`yart_tpu/config.py` (tests/test_torch_render.py holds them equal), so a
configuration written for one package reads the same in the other. The
knobs the port reads are here, and two it accepts and ignores
(`RenderConfig.background`, `chunk_inflight`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Thin-lens physical camera (src/core/camera.hpp:10-165)."""

    image_size: Tuple[int, int] = (512, 512)  # (width, height) pixels
    focal_length: float = 35.0  # mm
    f_number: float = 0.0  # 0 disables depth of field
    sensor_size: Tuple[float, float] = (36.0, 24.0)  # mm, 35mm full frame
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    forward: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    exposure: float = 0.0  # EV stops, applied as 2**exposure to samples
    aperture_sides: int = 0  # 0 = circular aperture, >=3 = bladed


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render/integrator/scheduler knobs (see yart_tpu/config.py for the
    reference line behind each default)."""

    samples: int = 64
    max_depth: int = 30
    integrator: str = "mis"  # "mis" | "naive"
    sampler: str = "zsobol"  # "zsobol" | "hash"
    estimator: str = "gmon"  # "gmon" | "gmonb" | "mon" | "mean"
    light_sampler: str = "power"  # "power" | "uniform"
    estimator_buckets: int = 15
    regularize_threshold: float = 0.5
    # Lanes with >= k prior near-specular scatters sample roughened lobes;
    # None = reference-parity behaviour.
    regularize_specular: Optional[int] = None
    # Accepted and ignored, as in the JAX package, whose renderer does not
    # read it either: the background is the scene's (SceneBuilder.set_background).
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    first_wave_samples: int = 64
    max_wave_samples: int = 128
    tonemap: str = "agx"  # "agx" | "none"
    agx_look: str = "none"  # "none" | "golden" | "punchy"
    rr_start_depth: int = 2
    clamp: Optional[float] = None  # per-sample radiance clamp, None = off
    # Staged wavefront compaction: after `compact_depth` bounces the
    # survivors move into n / compact_factor lanes. "auto" = 2 for env-lit
    # scenes, off for closed ones, then retuned from the first wave.
    compact_depth: object = "auto"  # "auto" | int | None
    compact_factor: int = 4
    lane_chunk: Optional[int] = None  # pixels per chunk; None = ~2^20 lanes
    # Accepted and ignored. In the JAX package it bounds the pixel chunks
    # in flight; the port's chunk loop queues every chunk on the device
    # stream without a bound (a lone process syncs the host only for
    # `on_chunk` or `debug_nan`, render/renderer.py), so it has no such
    # count.
    chunk_inflight: int = 2
    seed: int = 0
    # The bounce tail: "off" = the classic body; "xla" = the component-form
    # shade math (kernels/shade_math.py) in plain PyTorch; "pallas" = B6
    # (sampler draws) + B5 (fused shade) as CUDA kernels on a CUDA device,
    # their plain twins on the CPU. The names are the JAX package's.
    shade_kernel: str = "off"
    # Differentiable mode only: re-solve each hit's (t, u, v) from the
    # vertex positions so gradients reach `scene.positions` (or an
    # instanced scene's `proto_pos`); a plain render ignores it.
    diff_geometry: bool = False
    # What the backward pass of a differentiable render keeps from its
    # forward: "trace" checkpoints each bounce and keeps the traversal
    # outputs (the backward recomputes the shading, never a traversal);
    # "trace_lut" keeps the LUT and texture fetches too; "all" is plain
    # autograd over every bounce (no recomputation, the most memory).
    remat: str = "trace_lut"
