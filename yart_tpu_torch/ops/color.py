"""Color transfer functions; port of `yart_tpu/ops/color.py`
(src/core/color-utils.hpp:12-40, texture.hpp:112-114, ppm.cpp:5-21)."""

from __future__ import annotations

import numpy as np
import torch


def srgb_decode(v):
    """sRGB EOTF: encoded [0, 1] -> linear."""
    return torch.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)


def srgb_encode(v):
    """Linear [0, 1] -> sRGB-encoded."""
    safe = torch.clamp_min(v, 1e-12)
    return torch.where(v <= 0.0031308, v * 12.92, 1.055 * safe ** (1.0 / 2.4) - 0.055)


def gamma2_decode(v):
    """Texture storage decode: linear = stored * stored."""
    return v * v


def gamma22_encode(v):
    """Output gamma 1/2.2 clamp-encode of the PPM writer."""
    return torch.clamp(v, 0.0, 1.0) ** (1.0 / 2.2)


def srgb_decode_np(v: np.ndarray) -> np.ndarray:
    """Host-side sRGB decode for texture loading (float32)."""
    v = np.asarray(v, np.float32)
    return np.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4).astype(np.float32)


def srgb_encode_np(v: np.ndarray) -> np.ndarray:
    """Host-side sRGB encode for texture export (float32)."""
    v = np.asarray(v, np.float32)
    safe = np.maximum(v, 1e-12)
    return np.where(v <= 0.0031308, v * 12.92, 1.055 * safe ** (1.0 / 2.4) - 0.055).astype(np.float32)


def gamma2_encode_np(v: np.ndarray) -> np.ndarray:
    """Host-side gamma-2 texture storage encode: stored = sqrt(linear)."""
    return np.sqrt(np.maximum(np.asarray(v, np.float32), 0.0)).astype(np.float32)
