"""Batched texture sampling over shelf-packed atlases.

Port of `yart_tpu/render/texture.py` (src/core/texture.hpp:126-161,
texture.cpp:21-35): repeat wrap by frac(uv), scale by (size - 1), the base
texel clamped to size - 2, bilinear over the 2x2 neighbourhood, fetched as
ONE quad-row gather. The JAX package fetches each lane's rect with a
one-hot matmul; here it is plain indexing, with the same values. sRGB
colour stays gamma-2 encoded: callers decode colour channels by squaring.
"""

from __future__ import annotations

import torch

from yart_tpu_torch.ops import lut
from yart_tpu_torch.scene.types import TextureStack


def qrows_from_data(data: torch.Tensor) -> torch.Tensor:
    """[H, W, C] atlas -> [H*W, 4C] per-texel 2x2 quad rows (s00 s10 s01
    s11), edges clamped."""
    h, w = data.shape[:2]
    x1 = torch.clamp_max(torch.arange(w, device=data.device) + 1, w - 1)
    y1 = torch.clamp_max(torch.arange(h, device=data.device) + 1, h - 1)
    quad = torch.cat([data, data[:, x1], data[y1], data[y1][:, x1]], dim=-1)
    return quad.reshape(h * w, -1)


def _gather(stack: TextureStack, idx: torch.Tensor, uv: torch.Tensor):
    """The parts of a fetch that carry no gradient: the rect's (w - 1, h -
    1), the base texel (x, y) and the flat row of each lane's quad, and the
    quad rows themselves unless they are being differentiated."""
    safe = torch.clamp(idx.long(), 0, stack.table.shape[0] - 1)
    rect = stack.table[safe].to(torch.float32)  # [N, 4]
    w, h = rect[..., 2], rect[..., 3]
    u = (uv[..., 0] - torch.floor(uv[..., 0])) * (w - 1.0)
    v = (uv[..., 1] - torch.floor(uv[..., 1])) * (h - 1.0)
    x = torch.clamp_min(torch.minimum(w - 2.0, torch.floor(u)), 0.0)
    y = torch.clamp_min(torch.minimum(h - 2.0, torch.floor(v)), 0.0)
    xi = (rect[..., 0] + x).long()
    yi = (rect[..., 1] + y).long()
    row = yi * stack.data.shape[1] + xi
    q = None if stack.qrows.requires_grad else stack.qrows[row]
    return w - 1.0, h - 1.0, x, y, row, q


def sample_stack(stack: TextureStack, idx: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample textures `idx` ([N] int) at `uv` ([N, 2]); returns [N, C].
    Lanes with idx < 0 return zeros, and so does every lane of an empty
    stack. The gather goes through `ops.lut.named` (kept across a
    differentiable bounce's recomputation under `remat="trace_lut"`)."""
    c = stack.data.shape[-1]
    if stack.table.shape[0] == 0:
        return torch.zeros(idx.shape + (c,), dtype=torch.float32, device=uv.device)
    wm1, hm1, x, y, row, q = lut.named(lambda: _gather(stack, idx, uv))
    if q is None:
        q = stack.qrows[row]  # [N, 4C]
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    fu = (u * wm1 - x)[..., None]
    fv = (v * hm1 - y)[..., None]
    s00, s10, s01, s11 = q[..., 0:c], q[..., c : 2 * c], q[..., 2 * c : 3 * c], q[..., 3 * c :]
    out = (s00 * (1 - fv) + s01 * fv) * (1 - fu) + (s10 * (1 - fv) + s11 * fv) * fu
    return torch.where((idx >= 0)[..., None], out, 0.0)
