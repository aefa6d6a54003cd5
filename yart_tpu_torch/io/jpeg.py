"""JPEG decoder: markers and tables in Python, Huffman decoding in C++,
the inverse DCT, upsampling and colour conversion in numpy.

`decode_jpeg(data)` returns what `PIL.Image.open(...).convert("RGBA")`
gives for the same file, the call the JAX package's glTF loader makes: a
uint8 array [H, W, 4]. PIL decodes JPEG through libjpeg-turbo with its
defaults (the integer "islow" IDCT, fancy upsampling, block smoothing),
so this decoder computes what those integer paths compute, from ITU T.81
and libjpeg-turbo's documented arithmetic:

- the IDCT is `jidctint.c` `jpeg_idct_islow`: CONST_BITS 13, PASS1_BITS
  2, a 32-bit workspace between the column and the row pass, each output
  descaled with rounding by 2^18 and looked up in the `range_limit` table
  of `jdmaster.c` `prepare_range_limit_table` at `value & 1023`, which
  adds the level shift of 128 and clamps for |value| <= 511 and wraps
  beyond (`idct_islow`, `IDCT_RANGE_LIMIT`);
- chroma at half width goes through `jdsample.c` `h2v1_fancy_upsample`
  ((3 near + far + 1) >> 2 and (3 near + far + 2) >> 2), at half width
  and height through `h2v2_fancy_upsample` (column sums 3 near + far,
  then (3 s + s' + 8) >> 4 and (3 s + s' + 7) >> 4), edges replicated;
  a component at most 2 samples wide is replicated instead (the fancy
  paths need `downsampled_width > 2`). The rows and columns past the
  component's real size (`downsampled_width`, `downsampled_height`) are
  never read: the row below the last is the last real row, as
  `jdmainct.c` `set_bottom_pointers` makes it, and the row above the
  first is the first (`upsample`);
- YCbCr goes to RGB through `jdcolor.c` `build_ycc_rgb_table`'s 16-bit
  fixed-point tables, the green term shifted after the two table entries
  are summed (`ycc_to_rgb`, `YCC_TABLES`);
- the colour space is chosen as `jdapimin.c` `default_decompress_parms`
  does: 1 component grey; 3 components YCbCr after a JFIF APP0, else as
  an Adobe APP14's transform says (0 RGB), else RGB if the component ids
  are 'R', 'G', 'B', else YCbCr; 4 components CMYK unless an Adobe
  transform says YCCK;
- PIL reads 4-component data as inverted CMYK ("CMYK;I", Adobe's
  convention) and converts it with `Convert.c` `cmyk2rgb`:
  255 - k - muldiv255(c, 255 - k) with muldiv255(a, b) =
  ((t >> 8) + t) >> 8 for t = a b + 128 (`cmyk_to_rgb`);
- a non-interleaved scan covers ceil(component width / 8) blocks a row,
  an interleaved one whole MCUs; a progressive DC first scan stores the
  predicted value shifted left by Al, and an AC refinement walks the
  nonzero coefficients as `jdphuff.c` does (`csrc/host/jpeg_scan.cpp`).

What libjpeg would decode with a warning, this decoder refuses: every
such case, and every variant it does not read, raises JpegError naming
it. It reads SOF0 / SOF1 (Huffman sequential) and SOF2 (progressive) at 8
bits, with 1, 3 or 4 components at 4:4:4, 4:2:2 or 4:2:0 (the first
component 1x1, 2x1 or 2x2, the others 1x1), 8- and 16-bit quantisation
tables, restart intervals, and fill bytes before markers. It refuses
arithmetic coding, 12-bit, lossless and hierarchical frames, DNL, other
sampling factors, YCCK, a Huffman table or quantisation table a scan
needs but no DHT or DQT gave, entropy data that is truncated or corrupt,
and a progressive file whose scans leave any of coefficients 1-9 of a
component unrefined (libjpeg would smooth the blocks then). EXIF
orientation is ignored, as PIL's `open` ignores it.

The Huffman decoding runs in the port's own C++ (`csrc/host/jpeg_scan.cpp`),
built with g++ at first use like the native BVH builder
(`kernels/build.py` HOST_LIBRARIES); a missing or failing g++ raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
import threading
from typing import List, Optional

import numpy as np

SOI = b"\xff\xd8"
MAX_PIXELS = 2 * 89_478_485  # PIL.Image.MAX_IMAGE_PIXELS twice: DecompressionBombError past it
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_lock = threading.Lock()
_lib = None

# Frame markers this decoder does not read, by the name T.81 gives them.
_REFUSED_SOF = {
    0xC3: "lossless (SOF3)",
    0xC5: "hierarchical differential sequential (SOF5)",
    0xC6: "hierarchical differential progressive (SOF6)",
    0xC7: "hierarchical differential lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)",
    0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "hierarchical arithmetic-coded sequential (SOF13)",
    0xCE: "hierarchical arithmetic-coded progressive (SOF14)",
    0xCF: "hierarchical arithmetic-coded lossless (SOF15)",
}
_REFUSED_MARKERS = {
    0xCC: "arithmetic-coding conditioning (DAC)",
    0xDC: "number of lines (DNL)",
    0xDE: "hierarchical progression (DHP)",
    0xDF: "reference component expansion (EXP)",
}
# Names of the subsamplings refused by name: first component's (h, v).
_SUBSAMPLING_NAMES = {(1, 2): "4:4:0", (4, 1): "4:1:1", (1, 4): "4:1:1 vertical", (4, 2): "4:1:0"}

# jidctint.c constants: FIX(x) = round(x * 2^13).
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172
_IDCT_CHUNK = 2048  # blocks per numpy pass of idct_islow


class JpegError(ValueError):
    """A malformed JPEG stream, or a variant this decoder does not read."""


def _library() -> ctypes.CDLL:
    """The scan decoder with its prototype bound; built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            from yart_tpu_torch.kernels import build

            lib = build.load("yartjpeg")[0]
            lib.yart_jpeg_scan.restype = ctypes.c_int
            lib.yart_jpeg_scan.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_void_p), _I32P, _I32P, _I32P, _I32P, _I32P, _U8P, _U8P,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int,
            ]
            _lib = lib
        return _lib


def _idct_range_limit() -> np.ndarray:
    """jdmaster.c `prepare_range_limit_table` as the IDCT indexes it
    (`range_limit = sample_range_limit + CENTERJSAMPLE`, index & 1023)."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


def _ycc_tables() -> tuple:
    """jdcolor.c `build_ycc_rgb_table`: SCALEBITS 16, ONE_HALF 2^15;
    (Cr_r, Cb_b, Cr_g, Cb_g) as int32 [256] indexed by the sample."""
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * 65536 + 0.5)

    half = 1 << 15
    tabs = ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)
    return tuple(t.astype(np.int32) for t in tabs)


IDCT_RANGE_LIMIT = _idct_range_limit()
YCC_TABLES = _ycc_tables()


def _idct_1d(x):
    """One 8-point pass of jpeg_idct_islow on x[0..7] (int64 arrays of one
    shape); the eight sums before the pass's descale, in output order."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    t0 = t0 * _F0298 + z1 + z3
    t1 = t1 * _F2053 + z2 + z4
    t2 = t2 * _F3072 + z2 + z3
    t3 = t3 * _F1501 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Dequantise and inverse-transform blocks: coef int16 [N, 64] and
    qtable [64], both in natural (row-major) order -> uint8 [N, 8, 8]
    samples, as jpeg_idct_islow computes them (module docstring). Runs
    over chunks of blocks that stay in cache."""
    q = np.asarray(qtable, np.int64).reshape(1, 8, 8)
    d1 = _CONST_BITS - _PASS1_BITS
    d2 = _CONST_BITS + _PASS1_BITS + 3
    coef = coef.reshape(-1, 8, 8)
    out = np.empty(coef.shape, np.uint8)
    for lo in range(0, coef.shape[0], _IDCT_CHUNK):
        c = coef[lo : lo + _IDCT_CHUNK].astype(np.int64) * q
        ws = np.empty(c.shape, np.int32)  # the int workspace between the passes
        for j, o in enumerate(_idct_1d([c[:, k, :] for k in range(8)])):
            ws[:, j, :] = (o + (1 << (d1 - 1))) >> d1
        ws = ws.astype(np.int64)
        res = np.empty(c.shape, np.int64)
        for j, o in enumerate(_idct_1d([ws[:, :, k] for k in range(8)])):
            res[:, :, j] = (o + (1 << (d2 - 1))) >> d2
        out[lo : lo + _IDCT_CHUNK] = IDCT_RANGE_LIMIT[res & 1023]
    return out


def upsample(plane: np.ndarray, h: int, v: int) -> np.ndarray:
    """A component's samples uint8 [dh, dw] (its real rows and columns)
    upsampled h x v, for (h, v) in (1, 1), (2, 1), (2, 2): jdsample.c's
    fancy upsampling where dw > 2, its replication otherwise."""
    if (h, v) == (1, 1):
        return plane
    if plane.shape[1] <= 2:
        return np.repeat(np.repeat(plane, h, axis=1), v, axis=0)
    p = plane.astype(np.int32)
    if v == 2:  # column sums: 3 x nearest row + next-nearest row (edges replicated)
        above = np.concatenate([p[:1], p[:-1]])
        below = np.concatenate([p[1:], p[-1:]])
        rows = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
        rows[0::2] = 3 * p + above
        rows[1::2] = 3 * p + below
        p, shift, left_bias, right_bias = rows, 4, 8, 7
    else:
        shift, left_bias, right_bias = 2, 1, 2
    prev = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    nxt = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
    out[:, 0::2] = (3 * p + prev + left_bias) >> shift
    out[:, 1::2] = (3 * p + nxt + right_bias) >> shift
    return out.astype(np.uint8)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c `ycc_rgb_convert` on uint8 planes -> uint8 [..., 3]."""
    cr_r, cb_b, cr_g, cb_g = YCC_TABLES
    yi = y.astype(np.int32)
    out = np.empty((*y.shape, 3), np.uint8)
    for ch, term in enumerate((cr_r[cr], (cb_g[cb] + cr_g[cr]) >> 16, cb_b[cb])):
        out[..., ch] = np.clip(yi + term, 0, 255)
    return out


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's `cmyk2rgb` on uint8 [..., 4] (already inverted, as PIL reads
    "CMYK;I") -> uint8 [..., 3]."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


@dataclasses.dataclass
class _Component:
    cid: int
    h: int
    v: int
    tq: int
    dw: int = 0  # downsampled_width / height: the component's real samples
    dh: int = 0
    plane: Optional[np.ndarray] = None  # int16 [rows, cols, 64], MCU-padded
    qtable: Optional[np.ndarray] = None  # latched at the component's first scan
    coef_bits: Optional[np.ndarray] = None  # per coefficient: last Al, -1 never coded
    scanned: bool = False


@dataclasses.dataclass
class _Frame:
    progressive: bool
    height: int
    width: int
    comps: List[_Component]
    max_h: int = 1
    max_v: int = 1
    mcus_x: int = 0
    mcus_y: int = 0


def _seg(data: bytes, pos: int, name: str) -> tuple:
    """The payload of the marker segment whose length field is at pos, and
    the offset past it."""
    if pos + 2 > len(data):
        raise JpegError(f"{name} segment at byte {pos} is truncated")
    (n,) = struct.unpack_from(">H", data, pos)
    if n < 2 or pos + n > len(data):
        raise JpegError(f"{name} segment at byte {pos} declares {n} bytes past the end of the file")
    return data[pos + 2 : pos + n], pos + n


def _read_frame(marker: int, p: bytes) -> _Frame:
    if len(p) < 6:
        raise JpegError("SOF segment too short")
    prec, height, width, nf = struct.unpack_from(">BHHB", p)
    if prec != 8:
        raise JpegError(f"{prec}-bit samples (SOF{marker - 0xC0}): only 8-bit JPEG is read")
    if height == 0:
        raise JpegError("frame height 0: the height is defined by a DNL marker, which this decoder does not read")
    if width == 0 or width > 65500 or height > 65500:
        raise JpegError(f"frame size {width}x{height} outside 1..65500")
    if width * height > MAX_PIXELS:
        raise JpegError(f"frame size {width}x{height} is over {MAX_PIXELS} pixels (PIL's decompression-bomb "
                        "limit, where its open raises)")
    if nf not in (1, 3, 4):
        raise JpegError(f"{nf} components: only 1 (grey), 3 (YCbCr / RGB) and 4 (CMYK) are read")
    if len(p) < 6 + 3 * nf:
        raise JpegError("SOF segment too short for its components")
    comps = []
    for i in range(nf):
        cid, hv, tq = p[6 + 3 * i : 9 + 3 * i]
        if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4) or tq > 3:
            raise JpegError(f"component {cid}: bad sampling factors {hv >> 4}x{hv & 15} or table {tq}")
        comps.append(_Component(cid, hv >> 4, hv & 15, tq))
    if len({c.cid for c in comps}) != nf:
        raise JpegError("duplicate component ids in SOF")
    factors = [(c.h, c.v) for c in comps]
    if nf > 1 and (factors[0] not in ((1, 1), (2, 1), (2, 2)) or any(f != (1, 1) for f in factors[1:])):
        name = _SUBSAMPLING_NAMES.get(factors[0], "unsupported")
        raise JpegError(f"{name} sampling (factors {', '.join(f'{h}x{v}' for h, v in factors)}): only 4:4:4, "
                        "4:2:2 and 4:2:0 with the other components at 1x1 are read")
    f = _Frame(marker == 0xC2, height, width, comps)
    f.max_h, f.max_v = max(c.h for c in comps), max(c.v for c in comps)
    f.mcus_x = -(-width // (8 * f.max_h))
    f.mcus_y = -(-height // (8 * f.max_v))
    for c in comps:
        c.dw = -(-width * c.h // f.max_h)
        c.dh = -(-height * c.v // f.max_v)
        c.plane = np.zeros((f.mcus_y * c.v, f.mcus_x * c.h, 64), np.int16)
        c.coef_bits = np.full(64, -1, np.int32)
    return f


def _read_dqt(p: bytes, qt: list) -> None:
    i = 0
    while i < len(p):
        pq, tq = p[i] >> 4, p[i] & 15
        if pq > 1 or tq > 3:
            raise JpegError(f"DQT: bad precision {pq} or table {tq}")
        n = 64 * (1 + pq)
        if i + 1 + n > len(p):
            raise JpegError(f"DQT table {tq} is truncated")
        vals = np.frombuffer(p, np.uint8 if pq == 0 else ">u2", 64, i + 1).astype(np.int64)
        table = np.empty(64, np.int64)
        table[_NATURAL] = vals
        qt[tq] = table
        i += 1 + n


def _read_dht(p: bytes, dc: list, ac: list) -> None:
    i = 0
    while i < len(p):
        tc, th = p[i] >> 4, p[i] & 15
        if tc > 1 or th > 3:
            raise JpegError(f"DHT: bad class {tc} or table {th}")
        if i + 17 > len(p):
            raise JpegError("DHT segment is truncated")
        counts = bytes(p[i + 1 : i + 17])
        n = sum(counts)
        if n > 256 or i + 17 + n > len(p):
            raise JpegError(f"DHT table {tc}/{th} declares {n} symbols past its segment")
        (ac if tc else dc)[th] = (counts, bytes(p[i + 17 : i + 17 + n]))
        i += 17 + n


def _check_huffman(table, is_dc: bool, what: str) -> None:
    """jdhuff.c `jpeg_make_d_derived_tbl`'s checks: no code of all ones, DC
    symbols at most 15."""
    if table is None:
        raise JpegError(f"{what} Huffman table is used by a scan but no DHT defines it")
    counts, vals = table
    code = 0
    for length, n in enumerate(counts, 1):
        code += n
        if n and code >= 1 << length:
            raise JpegError(f"{what} Huffman table is invalid (more codes than fit in {length} bits)")
        code <<= 1
    if is_dc and any(v > 15 for v in vals):
        raise JpegError(f"{what} Huffman table has a DC category over 15")


# Zigzag index -> natural index (T.81 figure A.6).
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
    21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63,
])


def _scan(data: bytes, p: bytes, pos: int, f: _Frame, qt, dc, ac, restart: int) -> int:
    """Check one SOS header, decode its scan into the component planes and
    return the offset of the marker after its data."""
    ns = p[0] if p else 0
    if not 1 <= ns <= 4 or len(p) != 4 + 2 * ns:
        raise JpegError(f"SOS with {ns} components and a {len(p)}-byte header")
    by_id = {c.cid: c for c in f.comps}
    comps, tabs = [], []
    for i in range(ns):
        cid, t = p[1 + 2 * i], p[2 + 2 * i]
        if cid not in by_id or by_id[cid] in comps:
            raise JpegError(f"SOS names component {cid}, which the frame lacks or the scan repeats")
        if t >> 4 > 3 or t & 15 > 3:
            raise JpegError(f"SOS component {cid}: bad Huffman table {t >> 4}/{t & 15}")
        comps.append(by_id[cid])
        tabs.append((t >> 4, t & 15))
    ss, se, ah, al = p[1 + 2 * ns], p[2 + 2 * ns], p[3 + 2 * ns] >> 4, p[3 + 2 * ns] & 15
    if not f.progressive:
        if (ss, se, ah, al) != (0, 63, 0, 0):
            raise JpegError(f"sequential scan with Ss={ss} Se={se} Ah={ah} Al={al}")
        if any(c.scanned for c in comps):
            raise JpegError("sequential frame codes a component in two scans")
    else:
        if ss > se or se > 63 or (ss == 0) != (se == 0) or al > 13 or (ah and al != ah - 1):
            raise JpegError(f"bad progression parameters Ss={ss} Se={se} Ah={ah} Al={al}")
        if ss and ns != 1:
            raise JpegError("progressive AC scan with more than one component")
        for c in comps:
            if ss and c.coef_bits[0] < 0:
                raise JpegError(f"bad progression: AC scan of component {c.cid} before its DC scan")
            if (np.maximum(c.coef_bits[ss : se + 1], 0) != ah).any():
                raise JpegError(f"bad progression: component {c.cid} Ss={ss} Se={se} Ah={ah} does not follow "
                                "its earlier scans")
            c.coef_bits[ss : se + 1] = al
    for c, (td, ta) in zip(comps, tabs):
        if not f.progressive or (ss == 0 and ah == 0):
            _check_huffman(dc[td], True, f"DC {td}")
        if not f.progressive or ss:
            _check_huffman(ac[ta], False, f"AC {ta}")
        if c.qtable is None:
            if qt[c.tq] is None:
                raise JpegError(f"component {c.cid} uses quantisation table {c.tq}, which no DQT defines")
            c.qtable = qt[c.tq].copy()
        c.scanned = True
    counts = np.zeros((8, 17), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    for k, table in enumerate(dc + ac):
        if table is not None:
            counts[k, :16] = np.frombuffer(table[0], np.uint8)
            vals[k, : len(table[1])] = np.frombuffer(table[1], np.uint8)
    if ns == 1:  # non-interleaved: MCU = one block, over the component's own blocks
        c = comps[0]
        mcus_y, mcus_x, bh, bw = -(-c.dh // 8), -(-c.dw // 8), [1], [1]
    else:
        mcus_y, mcus_x = f.mcus_y, f.mcus_x
        bh, bw = [c.v for c in comps], [c.h for c in comps]

    def i32(xs):
        a = np.asarray(xs, np.int32)
        return a, a.ctypes.data_as(_I32P)

    planes = (ctypes.c_void_p * ns)(*[c.plane.ctypes.data for c in comps])
    keep = [i32([c.plane.shape[1] for c in comps]), i32(bh), i32(bw), i32([t[0] for t in tabs]),
            i32([t[1] for t in tabs])]
    end = ctypes.c_int64(0)
    msg = ctypes.create_string_buffer(256)
    rc = _library().yart_jpeg_scan(
        data, len(data), pos, ns, planes, *(k[1] for k in keep),
        counts.ctypes.data_as(_U8P), vals.ctypes.data_as(_U8P), mcus_y, mcus_x, restart,
        int(f.progressive), ss, se, ah, al, ctypes.byref(end), msg, len(msg))
    if rc != 0:
        raise JpegError(f"scan at byte {pos}: {msg.value.decode()}")
    return end.value


def _markers(data: bytes):
    """Parse the stream: -> (frame, colour space). Every scan is decoded
    into the frame's coefficient planes on the way."""
    if not data.startswith(SOI):
        raise JpegError("not a JPEG file (no SOI marker)")
    pos, qt, dc, ac = 2, [None] * 4, [None] * 4, [None] * 4
    frame, space, restart, jfif, adobe = None, None, 0, False, None
    while True:
        if pos >= len(data):
            raise JpegError("the file ends before its EOI marker (truncated file)")
        if data[pos] != 0xFF:
            raise JpegError(f"expected a marker at byte {pos}, found 0x{data[pos]:02X}")
        while pos + 1 < len(data) and data[pos + 1] == 0xFF:  # fill bytes
            pos += 1
        if pos + 1 >= len(data):
            raise JpegError("the file ends before its EOI marker (truncated file)")
        m = data[pos + 1]
        pos += 2
        if m == 0xD9:  # EOI
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:  # stray RSTn / TEM: no segment
            continue
        if m in _REFUSED_SOF:
            raise JpegError(f"{_REFUSED_SOF[m]} JPEG is not read (only Huffman baseline, extended and "
                            "progressive)")
        if m in _REFUSED_MARKERS:
            raise JpegError(f"{_REFUSED_MARKERS[m]} marker is not read")
        if m == 0x00 or m == 0xD8:
            raise JpegError(f"unexpected marker 0xFF{m:02X} at byte {pos - 2}")
        p, nxt = _seg(data, pos, f"marker 0xFF{m:02X}")
        if m in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise JpegError("a second SOF marker")
            frame = _read_frame(m, p)
        elif m == 0xC4:
            _read_dht(p, dc, ac)
        elif m == 0xDB:
            _read_dqt(p, qt)
        elif m == 0xDD:
            if len(p) != 2:
                raise JpegError("DRI segment of the wrong length")
            (restart,) = struct.unpack(">H", p)
        elif m == 0xE0 and space is None:
            jfif = jfif or (len(p) >= 14 and p.startswith(b"JFIF\0"))
        elif m == 0xEE and space is None:
            if len(p) >= 12 and p.startswith(b"Adobe"):
                adobe = p[11]
        elif m == 0xDA:
            if frame is None:
                raise JpegError("SOS before any SOF marker")
            if space is None:
                space = _colour_space(frame, jfif, adobe)
            nxt = _scan(data, p, nxt, frame, qt, dc, ac, restart)
        pos = nxt
    if frame is None or space is None:
        raise JpegError("no frame or no scan before EOI")
    for c in frame.comps:
        if not c.scanned:
            raise JpegError(f"component {c.cid} is coded in no scan")
        if frame.progressive:
            if c.coef_bits[0] < 0:
                raise JpegError(f"progressive component {c.cid} has no DC scan")
            if (c.coef_bits[1:10] != 0).any():
                raise JpegError(f"progressive component {c.cid} leaves coefficients 1-9 unrefined (coefficient "
                                f"bits {c.coef_bits[1:10].tolist()}); libjpeg would smooth its blocks")
    return frame, space


def _colour_space(f: _Frame, jfif: bool, adobe: Optional[int]) -> str:
    """jdapimin.c `default_decompress_parms`."""
    n = len(f.comps)
    if n == 1:
        return "grey"
    if n == 3:
        if jfif:
            return "ycc"
        if adobe is not None:
            return "rgb" if adobe == 0 else "ycc"
        return "rgb" if [c.cid for c in f.comps] == [82, 71, 66] else "ycc"
    if adobe not in (None, 0):
        raise JpegError(f"YCCK colour (Adobe transform {adobe}) is not read")
    return "cmyk"


def component_samples(plane: np.ndarray, qtable, dh: int, dw: int, h: int, v: int) -> np.ndarray:
    """A component's samples at full resolution: its coefficient plane
    int16 [rows, cols, 64] (blocks in raster order) through idct_islow,
    cut to its real dh x dw samples and upsampled h x v."""
    rows, cols = -(-dh // 8), -(-dw // 8)
    blocks = idct_islow(plane[:rows, :cols].reshape(-1, 64), qtable)
    pix = blocks.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)
    return upsample(pix[:dh, :dw], h, v)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 RGBA [H, W, 4], equal to PIL's
    `Image.open(...).convert("RGBA")` (module docstring)."""
    data = bytes(data)
    f, space = _markers(data)
    chans = [component_samples(c.plane, c.qtable, c.dh, c.dw, f.max_h // c.h, f.max_v // c.v)[: f.height, : f.width]
             for c in f.comps]
    out = np.empty((f.height, f.width, 4), np.uint8)
    out[..., 3] = 255
    if space == "grey":
        out[..., :3] = chans[0][..., None]
    elif space == "ycc":
        out[..., :3] = ycc_to_rgb(*chans)
    elif space == "rgb":
        out[..., :3] = np.stack(chans, axis=-1)
    else:
        out[..., :3] = cmyk_to_rgb(255 - np.stack(chans, axis=-1))
    return out
