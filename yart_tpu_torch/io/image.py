"""Image output: PPM (src/output/ppm.cpp:5-21) and a dependency-free PNG
encoder; port of the writers in `yart_tpu/io/image.py`."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _encode_gamma22(img: np.ndarray) -> np.ndarray:
    out = np.clip(img, 0.0, 1.0) ** (1.0 / 2.2)
    return (out * 255.0 + 0.5).astype(np.uint8)


def write_ppm(path: str, display: np.ndarray) -> None:
    """P6 writer with the reference's gamma-1/2.2 encode; display [H, W, 3]."""
    h, w = display.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(_encode_gamma22(display[..., :3]).tobytes())


def encode_png(display: np.ndarray) -> bytes:
    """RGB8 PNG bytes of [H, W, 3] display values in [0, 1], written as they
    are (the tonemapper's output is already display-encoded)."""
    h, w = display.shape[:2]
    data = np.clip(display[..., :3] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    raw = b"".join(b"\x00" + data[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        crc = struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        return struct.pack(">I", len(payload)) + tag + payload + crc

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, display: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(display))
