"""Equirect -> octahedral HDRI resampler; port of
`yart_tpu/tools/convert_hdri.py` (the reference's tools/convert-hdri.cpp
no longer compiles). Environment maps are stored octahedrally
(src/math/math.hpp:151-179).

Usage: python -m yart_tpu_torch.tools.convert_hdri in.hdr out.hdr [size]
"""

from __future__ import annotations

import sys

import numpy as np

from yart_tpu_torch.io.image import load_hdr, save_hdr


def equirect_to_octahedral(img: np.ndarray, size: int = 1024) -> np.ndarray:
    """Bilinear resample of an equirect [H, W, 3] map onto an octahedral grid."""
    # Octahedral UV grid -> directions (inverse of math.hpp:168-179).
    u = (np.arange(size) + 0.5) / size
    uu, vv = np.meshgrid(u, u)
    x = 2.0 * uu - 1.0
    z = 2.0 * vv - 1.0
    y = 1.0 - (np.abs(x) + np.abs(z))
    below = y < 0.0
    sx = np.where(x == 0.0, 1.0, np.sign(x))
    sz = np.where(z == 0.0, 1.0, np.sign(z))
    xf = (1.0 - np.abs(z)) * sx
    zf = (1.0 - np.abs(x)) * sz
    x = np.where(below, xf, x)
    z = np.where(below, zf, z)
    d = np.stack([x, y, z], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    # Directions -> equirect UV (math.hpp:136-142).
    phi = np.arctan2(-d[..., 2], -d[..., 0])
    phi = np.where(phi < 0.0, phi + 2.0 * np.pi, phi)
    theta = np.arccos(np.clip(d[..., 1], -1.0, 1.0))
    eu = phi / (2.0 * np.pi)
    ev = theta / np.pi

    h, w = img.shape[:2]
    fx = eu * (w - 1)
    fy = ev * (h - 1)
    x0 = np.clip(fx.astype(np.int32), 0, w - 2)
    y0 = np.clip(fy.astype(np.int32), 0, h - 2)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    out = (
        img[y0, x0] * (1 - tx) * (1 - ty)
        + img[y0, x0 + 1] * tx * (1 - ty)
        + img[y0 + 1, x0] * (1 - tx) * ty
        + img[y0 + 1, x0 + 1] * tx * ty
    )
    return out.astype(np.float32)


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if len(args) < 2:
        print(__doc__)
        return 1
    size = int(args[2]) if len(args) > 2 else 1024
    save_hdr(args[1], equirect_to_octahedral(load_hdr(args[0]), size))
    print(f"wrote {args[1]} ({size}x{size} octahedral)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
