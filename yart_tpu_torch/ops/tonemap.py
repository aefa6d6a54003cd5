"""AgX tonemapping with ASC-CDL looks (src/core/tonemapping.hpp:14-92);
port of `yart_tpu/ops/tonemap.py`. Operates on [..., 3] linear HDR RGB.

The 3x3 colour matrices are applied as explicit per-channel sums rather
than a matmul, so no TF32 or library GEMM path can touch them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Rows of the reference's `M * val` (tonemapping.hpp:57-61,84-88), as
# Python floats (no module-level tensors).
_AGX_MAT = (
    (0.842479062253094, 0.0784335999999992, 0.0792237451477643),
    (0.0423282422610123, 0.878468636469772, 0.0791661274605434),
    (0.0423756549057051, 0.0784336, 0.879142973793104),
)
_AGX_MAT_INV = (
    (1.19687900512017, -0.0980208811401368, -0.0990297440797205),
    (-0.0528968517574562, 1.15190312990417, -0.0989611768448433),
    (-0.0529716355144438, -0.0980434501171241, 1.15107367264116),
)
_MIN_EV = -12.47393
_MAX_EV = 4.026069
_LW = (0.2126, 0.7152, 0.0722)


class Look(NamedTuple):
    """ASC-CDL-style grade (tonemapping.hpp:16-33)."""

    offset: tuple
    slope: tuple
    power: tuple
    sat: float


LOOKS = {
    "none": Look((0.0,) * 3, (1.0,) * 3, (1.0,) * 3, 1.0),
    "golden": Look((0.0,) * 3, (1.0, 0.9, 0.5), (0.8,) * 3, 0.8),
    "punchy": Look((0.0,) * 3, (1.0,) * 3, (1.35,) * 3, 1.4),
}


def _mat3(x, m):
    c = [x[..., j] for j in range(3)]
    return torch.stack(
        [c[0] * m[i][0] + c[1] * m[i][1] + c[2] * m[i][2] for i in range(3)], dim=-1
    )


def _contrast(x):
    """6th-order sigmoid fit (tonemapping.hpp:42-54)."""
    x2 = x * x
    x4 = x2 * x2
    return (
        15.5 * x4 * x2
        - 40.14 * x4 * x
        + 31.96 * x4
        - 6.868 * x2 * x
        + 0.4298 * x2
        + 0.1191 * x
        - 0.00232
    )


def agx(hdr, look="none"):
    """Full AgX pipeline on [..., 3] linear HDR; returns linear display RGB."""
    if isinstance(look, str):
        look = LOOKS[look]
    val = _mat3(hdr, _AGX_MAT)
    val = torch.clamp(torch.log2(torch.clamp_min(val, 1e-10)), _MIN_EV, _MAX_EV)
    val = (val - _MIN_EV) / (_MAX_EV - _MIN_EV)
    val = _contrast(val)

    luma = (val[..., 0] * _LW[0] + val[..., 1] * _LW[1] + val[..., 2] * _LW[2])[..., None]
    vec = lambda t: torch.tensor(t, dtype=val.dtype, device=val.device)
    val = torch.clamp_min(val * vec(look.slope) + vec(look.offset), 0.0) ** vec(look.power)
    val = luma + look.sat * (val - luma)

    val = _mat3(val, _AGX_MAT_INV)
    val = torch.clamp(val, 0.0, 1.0)
    return val ** 2.2


def tonemap(hdr, kind: str = "agx", look: str = "none"):
    """Dispatch: 'agx' or 'none' (identity)."""
    if kind == "none":
        return hdr
    if kind == "agx":
        return agx(hdr, look)
    raise ValueError(f"unknown tonemap: {kind}")
