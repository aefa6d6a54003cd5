"""yart_tpu_torch: the PyTorch + CUDA port of yart_tpu.

The JAX package `yart_tpu` is the reference; this package mirrors its
layout (`ops/`, `render/`, `scene/`, `kernels/`, plus `csrc/` for the CUDA
sources) and is held against it by `tests/test_torch_*.py`.

Ported so far: the forward MIS/naive render path for ungated,
non-instanced, untextured scenes lit by area lights and an environment
light (`cornell`, `cornell-mat`, `furnace`, `spheres`), with a numpy scene
builder (SAH BVH, triangle clusters, env alias tables) and three
hand-written Hopper kernels: the brute-force intersection B1
(`kernels/brute.py`, `csrc/brute_intersect.cu`) for scenes of at most 4096
triangles, and above that the block trace (`render/blocktrace.py`) with
its presort B2 (`kernels/presort.py`, `csrc/presort_keys.cu`) and fused
closest-hit trace B3 (`kernels/fusedtrace.py`, `csrc/fused_trace.cu`).
Later slices added textures, alpha gates, instancing, bin-trace, the fused
shade tail and the round-based block trace (all eight TPU kernels have a
Hopper counterpart in `csrc/`), the differentiable path
(`render/diff.py`, `tools/inverse_render.py`), and the stack traversals
(`render/stacktrace.py`) and per-instance loop for gated and instanced
scenes past the block trace's cap, so intersection refuses no scene
(README.md), and scene files: glTF / GLB loading (`scene/gltf.py`, with
its own PNG decoder `io/png.py`), GLB export (`io/glb_export.py`),
Radiance HDR environments (`io/image.py`) and `tools/convert_hdri.py`.
Then the application layer: multi-rank rendering over torch.distributed
(`parallel/`: one process a card on NCCL, or CPU ranks on gloo;
`Renderer(devices=...)`, the CLI's `--devices` and `--distributed`), the
live view (`io/preview.py`), within-wave progress (`on_chunk`), NaN checks,
profiler traces and JSON flag files, the stratified sampler and ZSobol's
null, binary and exact Owen scramblers (`ops/qmc.py`) and `Dist2D`
(`ops/distribution.py`). Entry points run on the card unless given
`device="cpu"`. Nothing the JAX package runs is refused, apart from the
divergences ROADMAP.md C records: glTF textures that are not PNG, and
`shade_kernel="pallas"` with `regularize_specular` or in differentiable
mode, which the JAX package refuses too.

This package imports torch and nothing of jax or of `yart_tpu`; its
configuration dataclasses (`config.py`) mirror `yart_tpu/config.py`.
"""

from yart_tpu_torch.config import CameraConfig, RenderConfig

__all__ = ["CameraConfig", "RenderConfig"]
