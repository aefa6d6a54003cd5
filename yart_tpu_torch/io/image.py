"""Image I/O: PPM (src/output/ppm.cpp:5-21), a dependency-free PNG
encoder, and Radiance RGBE (.hdr) environments (the reference reads them
with stb's loadf, src/core/texture.cpp:5-19); port of
`yart_tpu/io/image.py`. PNG decoding is `io/png.py`."""

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


def encode_png(display: np.ndarray, keep_alpha: bool = False) -> bytes:
    """RGB8 PNG bytes of [H, W, 3|4] values in [0, 1], written as they are
    (the tonemapper's output is already display-encoded, and the GLB
    exporter passes storage-encoded texels). `keep_alpha` writes RGBA8
    when a fourth channel is present (alpha-tested base-color textures)."""
    h, w = display.shape[:2]
    nc = 4 if (keep_alpha and display.shape[-1] >= 4) else 3
    data = np.clip(display[..., :nc] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    raw = b"".join(b"\x00" + data[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        crc = struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        return struct.pack(">I", len(payload)) + tag + payload + crc

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if nc == 3 else 6, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, display: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(display))


def load_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) reader -> [H, W, 3] float32 linear. Reads
    new-style run-length scanlines and flat ones; -Y H +X W only."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = data.find(b"\n\n")
    if pos < 0:
        raise ValueError(f"{path}: bad HDR header")
    dims_end = data.find(b"\n", pos + 2)
    dims = data[pos + 2 : dims_end].split()
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"{path}: unsupported HDR orientation: {dims}")
    h, w = int(dims[1]), int(dims[3])

    rgbe = np.zeros((h, w, 4), np.uint8)
    p = dims_end + 1
    buf = np.frombuffer(data, np.uint8)
    for y in range(h):
        if 8 <= w < 32768 and buf[p] == 2 and buf[p + 1] == 2:  # new-style RLE scanline
            if (int(buf[p + 2]) << 8 | int(buf[p + 3])) != w:
                raise ValueError(f"{path}: HDR scanline width mismatch")
            p += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(buf[p])
                    p += 1
                    if count > 128:  # a run of one byte
                        rgbe[y, x : x + count - 128, c] = buf[p]
                        x += count - 128
                        p += 1
                    else:  # literal bytes
                        rgbe[y, x : x + count, c] = buf[p : p + count]
                        x += count
                        p += count
        else:
            rgbe[y] = buf[p : p + w * 4].reshape(w, 4)
            p += w * 4

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def save_hdr(path: str, image: np.ndarray) -> None:
    """Radiance RGBE (.hdr) writer, flat (uncompressed) scanlines; image
    [H, W, 3] linear."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    maxc = img.max(axis=-1)
    nz = maxc > 1e-32
    f, e = np.frexp(np.where(nz, maxc, 1.0))  # maxc = f * 2^e, f in [0.5, 1)
    scale = np.where(nz, f * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    mant = np.clip(img * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    exp = np.where(nz, e + 128, 0).astype(np.uint8)
    rgbe = np.concatenate([mant, exp[..., None]], axis=-1)
    with open(path, "wb") as fo:
        fo.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        fo.write(f"-Y {h} +X {w}\n".encode())
        fo.write(rgbe.tobytes())
