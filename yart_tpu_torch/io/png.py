"""PNG decoder on the standard library's zlib and numpy.

`decode_png(data)` returns what `PIL.Image.open(...).convert("RGBA")`
gives for the same file, the call the JAX package's glTF loader makes:
a uint8 array [H, W, 4]. It reads every colour type (0 grey, 2 RGB,
3 palette, 4 grey + alpha, 6 RGBA) at every bit depth the PNG
specification allows for it, PLTE and tRNS, the five row filters, Adam7
interlacing, and checks every chunk's CRC. Where PIL reads a file in a way
of its own, this decoder reads it the same way:

- 16-bit samples of colour types 2, 4 and 6 keep their high byte;
- 16-bit grey goes through PIL's "I;16" image, whose conversion clamps the
  sample to 255 (it does not scale it);
- grey of 2 and 4 bits is scaled to 8 bits (x 85, x 17) and 1-bit grey
  to 0 / 255;
- a tRNS key of grey or RGB keeps its low byte, which is compared with
  the pixel after that conversion (so a key of 2-bit grey matches the
  sample 1 only as 85); a 1-bit grey key is 0 (black) or, if it is not
  0, white;
- palette indices past the PLTE entries read as black, and palette
  entries past the tRNS entries are opaque.

Rows filtered with Sub, Up or None are undone a whole row at a time. Rows
filtered with Average or Paeth depend on the byte before them in the same
row, so an image that has any are undone along anti-diagonals: every
pixel of a diagonal depends only on the two diagonals before it, so each
step is a numpy operation over all rows at once (H + W steps).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class PngError(ValueError):
    """A malformed or unsupported PNG stream."""


def _chunks(data: bytes):
    """(type, payload) of every chunk, each CRC checked."""
    if not data.startswith(SIGNATURE):
        raise PngError("not a PNG file (bad signature)")
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 12 > len(data):
            raise PngError(f"truncated chunk header at byte {pos}")
        (n,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        end = pos + 8 + n
        if end + 4 > len(data):
            raise PngError(f"chunk {tag!r} at byte {pos} declares {n} bytes past the end of the file")
        payload = data[pos + 8 : end]
        (crc,) = struct.unpack_from(">I", data, end)
        if zlib.crc32(tag + payload) & 0xFFFFFFFF != crc:
            raise PngError(f"chunk {tag!r} at byte {pos}: CRC mismatch")
        yield tag, payload
        if tag == b"IEND":
            return
        pos = end + 4
    raise PngError("no IEND chunk")


def _unfilter_rows(filt: np.ndarray, raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo filters 0-2 row by row; raw is [h, stride] uint8."""
    out = np.empty_like(raw)
    prev = np.zeros(raw.shape[1], np.uint8)
    for y in range(raw.shape[0]):
        f, r = filt[y], raw[y]
        if f == 0:
            cur = r
        elif f == 2:
            cur = r + prev
        else:  # Sub: a running sum of each byte lane of the pixel
            cur = np.cumsum(r.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        out[y] = cur
        prev = cur
    return out


def _unfilter_diagonal(filt: np.ndarray, raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo any mix of the five filters along anti-diagonals. Pixel (y, x)
    (a group of bpp bytes) is stored skewed at column x + y + 1 of row
    y + 1, so its left, up and up-left neighbours are columns s - 1 (row
    y + 1), s - 1 and s - 2 (row y); row 0 and column 0 stay zero."""
    h, stride = raw.shape
    w = stride // bpp
    raw_px = raw.reshape(h, w, bpp).astype(np.int16)
    z = np.zeros((w + h + 1, h + 1, bpp), np.int16)  # [column, row, byte]
    rows = np.arange(h)
    for s in range(1, w + h):
        lo, hi = max(0, s - w), min(h, s)
        ys = rows[lo:hi]
        a = z[s - 1, lo + 1 : hi + 1]
        b = z[s - 1, lo:hi]
        c = z[s - 2, lo:hi]
        f = filt[lo:hi, None]
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(f == 4, paeth, np.where(f == 3, (a + b) >> 1, np.where(f == 2, b, np.where(f == 1, a, 0))))
        z[s, lo + 1 : hi + 1] = (raw_px[ys, s - 1 - ys] + pred) & 0xFF
    cols = rows[:, None] + np.arange(w)[None, :] + 1
    return z[cols, rows[:, None] + 1].astype(np.uint8).reshape(h, stride)


def _unfilter(scan: memoryview, h: int, stride: int, bpp: int) -> np.ndarray:
    """The [h, stride] bytes of one (sub-)image from its filtered scanlines."""
    lines = np.frombuffer(scan, np.uint8).reshape(h, stride + 1)
    filt = lines[:, 0]
    if filt.size and filt.max() > 4:
        raise PngError(f"unknown row filter {int(filt.max())}")
    raw = np.ascontiguousarray(lines[:, 1:])
    if not (filt >= 3).any():
        return _unfilter_rows(filt, raw, bpp)
    return _unfilter_diagonal(filt, raw, bpp)


def _samples(rows: np.ndarray, w: int, depth: int, nch: int) -> np.ndarray:
    """Unfiltered bytes [h, stride] -> samples [h, w, nch] (uint16 at depth
    16, else uint8 at the file's depth)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(h, w, nch).astype(np.uint16)
    if depth == 8:
        return rows.reshape(h, w, nch)
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w, None]


def _to_rgba(s: np.ndarray, ctype: int, depth: int, plte, trns) -> np.ndarray:
    """Samples [h, w, nch] -> PIL's convert("RGBA") of the same image."""
    h, w = s.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    if ctype == 3:
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        if plte is not None:
            entries = np.frombuffer(plte, np.uint8)[: (len(plte) // 3) * 3].reshape(-1, 3)[:256]
            pal[: len(entries), :3] = entries
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            pal[: len(alpha), 3] = alpha
        return pal[s[..., 0]]
    if ctype in (0, 4):
        g = s[..., 0]
        if depth == 16:
            grey = np.minimum(g, 255).astype(np.uint8) if ctype == 0 else (g >> 8).astype(np.uint8)
        else:
            grey = (g.astype(np.uint16) * (255 // ((1 << depth) - 1))).astype(np.uint8)
        out[..., 0] = out[..., 1] = out[..., 2] = grey
        if ctype == 4:
            a = s[..., 1]
            out[..., 3] = (a >> 8).astype(np.uint8) if depth == 16 else a
        else:
            out[..., 3] = 255
            if trns is not None and len(trns) >= 2:
                (key,) = struct.unpack(">H", trns[:2])
                key = (255 if key else 0) if depth == 1 else key & 0xFF
                out[..., 3] = np.where(grey == key, 0, 255)
        return out
    rgb = (s[..., :3] >> 8).astype(np.uint8) if depth == 16 else s[..., :3]
    out[..., :3] = rgb
    if ctype == 6:
        a = s[..., 3]
        out[..., 3] = (a >> 8).astype(np.uint8) if depth == 16 else a
    else:
        out[..., 3] = 255
        if trns is not None and len(trns) >= 6:
            key = np.asarray(struct.unpack(">HHH", trns[:6]), np.int32) & 0xFF
            out[..., 3] = np.where((rgb.astype(np.int32) == key).all(axis=-1), 0, 255)
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 RGBA [H, W, 4], as PIL's convert("RGBA") reads them."""
    ihdr = plte = trns = None
    idat = []
    for tag, payload in _chunks(bytes(data)):
        if tag == b"IHDR":
            if len(payload) != 13:
                raise PngError(f"IHDR holds {len(payload)} bytes, not 13")
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            plte = payload
        elif tag == b"tRNS":
            trns = payload
        elif tag == b"IDAT":
            idat.append(payload)
    if ihdr is None:
        raise PngError("no IHDR chunk")
    w, h, depth, ctype, comp, filt_method, interlace = ihdr
    if ctype not in _CHANNELS:
        raise PngError(f"unknown colour type {ctype}")
    if depth not in _DEPTHS[ctype]:
        raise PngError(f"bit depth {depth} is not allowed for colour type {ctype}")
    if comp != 0 or filt_method != 0 or interlace not in (0, 1):
        raise PngError(f"unsupported compression / filter method / interlace {comp} / {filt_method} / {interlace}")
    if w == 0 or h == 0:
        raise PngError(f"empty image {w}x{h}")
    if ctype == 3 and plte is None:
        raise PngError("palette image without a PLTE chunk")
    if not idat:
        raise PngError("no IDAT chunk")
    try:
        stream = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError(f"IDAT stream: {e}") from None
    nch = _CHANNELS[ctype]
    bits = nch * depth
    bpp = max(1, bits // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = None
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * bits + 7) // 8
        need = ph * (stride + 1)
        if pos + need > len(stream):
            raise PngError(f"image data holds {len(stream)} bytes; {w}x{h} needs more (truncated IDAT)")
        rows = _unfilter(memoryview(stream)[pos : pos + need], ph, stride, bpp)
        pos += need
        s = _samples(rows, pw, depth, nch)
        if not interlace:
            samples = s
            break
        if samples is None:
            samples = np.zeros((h, w, nch), s.dtype)
        samples[y0::dy, x0::dx] = s
    return _to_rgba(samples, ctype, depth, plte, trns)
