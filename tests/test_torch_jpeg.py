"""The port's JPEG decoder (`yart_tpu_torch/io/jpeg.py`) against PIL.

`decode_jpeg` must return the bytes of `PIL.Image.open(...).convert("RGBA")`,
what the JAX package's glTF loader calls, exactly (`np.array_equal`):
- on files PIL writes here over a grid of sizes (1x1 to 37x53, widths of
  at most 2 and 4 chroma samples among them) and variants (grey, YCbCr at
  4:4:4, 4:2:2 and 4:2:0, Adobe RGB, CMYK; baseline, progressive and
  optimized tables; restart markers; quality 1 to 100);
- on the committed fixtures of tests/data/jpeg against their manifest's
  hashes, and on hand-edited headers that the decoder reads (no JFIF, an
  Adobe transform, SOF1, 16-bit quantisation tables, fill bytes, COM and
  EXIF segments);
- on hand-edited headers that it refuses: each raises JpegError naming
  the variant (SOF9, 12-bit, 4:4:0, 4:1:1, YCCK, DNL, a truncated scan, a
  wrong restart marker, a progressive file that leaves coefficients 1-9
  unrefined, ...);
- on PIL-written files with bytes overwritten at random: an image or
  JpegError, nothing else, and PIL's image wherever the coefficients stay
  in the range where libjpeg-turbo's C and SIMD IDCTs agree.
Each numpy stage is also held to libjpeg-turbo's arithmetic on hand-made
inputs: the islow IDCT and its range_limit wrap, h2v1 / h2v2 fancy
upsampling and the replication at widths of at most 2, the YCbCr tables,
and PIL's CMYK conversion. A missing g++ raises: the Huffman decoding has
no Python fallback.
"""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest

from yart_tpu_torch.io import jpeg as J
from yart_tpu_torch.io.jpeg import JpegError, decode_jpeg
from yart_tpu_torch.kernels import build

Image = pytest.importorskip("PIL.Image")
features = pytest.importorskip("PIL.features")

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}
SIZES = [(1, 1), (2, 3), (3, 2), (4, 4), (5, 9), (6, 6), (16, 16), (17, 33), (37, 53)]
# (mode, subsampling, quality, options)
VARIANTS = {
    "ycc420": ("RGB", "420", 75, {}),
    "ycc422": ("RGB", "422", 75, {}),
    "ycc444": ("RGB", "444", 75, {}),
    "ycc420_prog": ("RGB", "420", 50, {"progressive": True}),
    "ycc422_prog_opt": ("RGB", "422", 95, {"progressive": True, "optimize": True}),
    "ycc444_opt_q100": ("RGB", "444", 100, {"optimize": True}),
    "ycc420_rst_q1": ("RGB", "420", 1, {"restart_marker_blocks": 1}),
    "grey_prog": ("L", "444", 50, {"progressive": True}),
    "grey_rst": ("L", "444", 95, {"restart_marker_blocks": 2}),
    "adobe_rgb": ("RGB", "444", 90, {"keep_rgb": True}),
    "cmyk": ("CMYK", "444", 75, {}),
    "cmyk420_prog": ("CMYK", "420", 75, {"progressive": True}),
}


def _image(w, h, mode, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx * 7 + yy * 3) % 256,
                       ((xx // 3 + yy // 3) % 2) * 220], -1)
    a = np.where(rng.random((h, w, 1)) < 0.3, rng.integers(0, 256, (h, w, 4)), smooth).astype(np.uint8)
    if mode == "L":
        return Image.fromarray(a[..., 0], "L")
    return Image.fromarray(a if mode == "CMYK" else a[..., :3], mode)


def _encode(w, h, mode="RGB", sub="420", quality=75, seed=0, **opts):
    buf = io.BytesIO()
    _image(w, h, mode, seed).save(buf, "JPEG", quality=quality, subsampling=SUBSAMPLING[sub], **opts)
    return buf.getvalue()


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _split(data):
    """[(marker, payload)] of the segments before the first SOS, and the
    bytes from that SOS on."""
    pos, segs = 2, []
    while data[pos + 1] != 0xDA:
        (n,) = struct.unpack_from(">H", data, pos + 2)
        segs.append((data[pos + 1], data[pos + 4 : pos + 2 + n]))
        pos += 2 + n
    return segs, data[pos:]


def _join(segs, rest):
    return b"\xff\xd8" + b"".join(bytes([0xFF, m]) + struct.pack(">H", len(p) + 2) + p for m, p in segs) + rest


def _edit(data, marker, fn):
    """The file with fn(payload) in place of the payload of each segment
    `marker` before the first SOS (fn returns None to drop the segment)."""
    segs, rest = _split(data)
    out = []
    for m, p in segs:
        if m == marker:
            p = fn(bytearray(p))
            if p is None:
                continue
        out.append((m, bytes(p)))
    return _join(out, rest)


def _set(offset, value):
    def fn(p):
        p[offset] = value
        return p
    return fn


# ---------------------------------------------------------------- PIL's bytes


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_grid_equals_pil(size, variant):
    mode, sub, quality, opts = VARIANTS[variant]
    data = _encode(*size, mode, sub, quality, seed=size[0] * 100 + size[1], **opts)
    got, ref = decode_jpeg(data), _pil(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (size[1], size[0], 4)
    assert np.array_equal(got, ref), f"{(got != ref).any(-1).sum()} pixels differ"


def test_large_image_equals_pil():
    """A 2048x2048 4:2:0 progressive texture: every MCU row, the chunked IDCT."""
    yy, xx = np.mgrid[0:2048, 0:2048]
    img = np.stack([xx // 9 % 256, yy // 5 % 256, (xx ^ yy) % 256], -1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=85, progressive=True)
    assert np.array_equal(decode_jpeg(buf.getvalue()), _pil(buf.getvalue()))


def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_manifest()["files"]))
def test_fixture_matches_manifest(name):
    entry = _manifest()["files"][name]
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    out = decode_jpeg(data)
    assert list(out.shape) == entry["shape"]
    assert hashlib.sha256(out.tobytes()).hexdigest() == entry["rgba_sha256"]


def test_pil_decodes_fixtures_as_manifest_says():
    """The manifest was written by this Pillow and libjpeg-turbo; a sandbox
    with others may decode otherwise, and then this test names both."""
    m = _manifest()
    here = (Image.__version__, features.version("libjpeg_turbo"))
    for name, entry in m["files"].items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            sha = hashlib.sha256(_pil(f.read()).tobytes()).hexdigest()
        assert sha == entry["rgba_sha256"], (
            f"{name}: PIL's decode here (Pillow {here[0]}, libjpeg-turbo {here[1]}) differs from the manifest's "
            f"(Pillow {m['pillow']}, libjpeg-turbo {m['libjpeg_turbo']})")
    names = set(m["files"])
    assert sum(n.startswith("atrium_") for n in names) >= 4
    assert os.path.getsize(os.path.join(FIXTURES, "manifest.json")) + sum(
        os.path.getsize(os.path.join(FIXTURES, n)) for n in names) < 1 << 20


def _strip_app(marker):
    return lambda data: _edit(data, marker, lambda p: None)


def _adobe(transform):
    return bytes(b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))


# Files the decoder reads, made by editing PIL-written ones.
ACCEPTED = {
    "no_jfif_ids_123": (lambda: _encode(37, 21), _strip_app(0xE0)),
    "rgb_ids_no_adobe": (lambda: _encode(19, 17, sub="444", keep_rgb=True), _strip_app(0xEE)),
    "adobe_transform_1": (lambda: _encode(19, 17), lambda d: _join([(0xEE, _adobe(1))] + _split(_strip_app(0xE0)(d))[0],
                                                                    _split(d)[1])),
    "adobe_0_on_ycc": (lambda: _encode(19, 17), lambda d: _join([(0xEE, _adobe(0))] + _split(_strip_app(0xE0)(d))[0],
                                                                 _split(d)[1])),
    "jfif_and_adobe_0": (lambda: _encode(19, 17), lambda d: _join(_split(d)[0] + [(0xEE, _adobe(0))], _split(d)[1])),
    "cmyk_no_adobe": (lambda: _encode(13, 11, "CMYK", sub="444"), _strip_app(0xEE)),
    "sof1": (lambda: _encode(21, 13), lambda d: d.replace(b"\xff\xc0", b"\xff\xc1", 1)),
    "dqt_16bit": (lambda: _encode(21, 13, quality=30), lambda d: _edit(d, 0xDB, lambda p: bytes(
        b"".join(bytes([0x10 | p[i]]) + np.frombuffer(p, np.uint8, 64, i + 1).astype(">u2").tobytes()
                 for i in range(0, len(p), 65))))),
    "fill_bytes": (lambda: _encode(21, 13), lambda d: d.replace(b"\xff\xdb", b"\xff\xff\xff\xdb", 1).replace(
        b"\xff\xda", b"\xff\xff\xda", 1)),
    "com_and_exif": (lambda: _encode(21, 13), lambda d: _join(
        [(0xFE, b"a comment"), (0xE1, b"Exif\x00\x00MM\x00\x2a\x00\x00\x00\x08\x00\x01\x01\x12\x00\x03\x00\x00"
                                      b"\x00\x01\x00\x06\x00\x00\x00\x00\x00\x00")] + _split(d)[0], _split(d)[1])),
    "trailing_rst": (lambda: _encode(9, 9, quality=90), lambda d: d[:-2] + b"\xff\xd0\xff\xd9"),
}


@pytest.mark.parametrize("name", list(ACCEPTED))
def test_edited_headers_equal_pil(name):
    make, edit = ACCEPTED[name]
    data = edit(make())
    assert np.array_equal(decode_jpeg(data), _pil(data))


def _progressive_cut(data, n_scans):
    """The first n_scans scans of a progressive file, then EOI."""
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    after = sos[n_scans - 1] + 2
    nxt = min(i for i in range(after, len(data) - 1) if data[i] == 0xFF and data[i + 1] in (0xC4, 0xDA, 0xD9))
    return data[:nxt] + b"\xff\xd9"


def _wrong_rst(data):
    i = data.index(b"\xff\xd0", data.index(b"\xff\xda"))
    return data[:i] + b"\xff\xd1" + data[i + 2 :]


# Files it refuses: (make, edit, what the message names).
REFUSED = {
    "sof9_arithmetic": (lambda: _encode(8, 8), lambda d: d.replace(b"\xff\xc0", b"\xff\xc9", 1), "SOF9"),
    "sof3_lossless": (lambda: _encode(8, 8), lambda d: d.replace(b"\xff\xc0", b"\xff\xc3", 1), "lossless"),
    "sof5_hierarchical": (lambda: _encode(8, 8), lambda d: d.replace(b"\xff\xc0", b"\xff\xc5", 1), "hierarchical"),
    "12_bit": (lambda: _encode(8, 8), lambda d: _edit(d, 0xC0, _set(0, 12)), "12-bit"),
    "dnl_height_0": (lambda: _encode(8, 8), lambda d: _edit(d, 0xC0, lambda p: p[:1] + b"\x00\x00" + p[3:]), "DNL"),
    "sampling_440": (lambda: _encode(16, 16, sub="444"), lambda d: _edit(d, 0xC0, _set(7, 0x12)), "4:4:0"),
    "sampling_411": (lambda: _encode(32, 16, sub="444"), lambda d: _edit(d, 0xC0, _set(7, 0x41)), "4:1:1"),
    "chroma_not_1x1": (lambda: _encode(16, 16, sub="420"), lambda d: _edit(d, 0xC0, _set(10, 0x21)),
                       "sampling"),
    "two_components": (lambda: _encode(8, 8), lambda d: _edit(d, 0xC0, _set(5, 2)), "2 components"),
    "decompression_bomb": (lambda: _encode(8, 8), lambda d: _edit(d, 0xC0, lambda p: p[:1] + b"\xfd\xe8" * 2 + p[5:]),
                           "decompression-bomb"),
    "ycck": (lambda: _encode(8, 8, "CMYK", sub="444"),
             lambda d: _edit(d, 0xEE, lambda p: p[:11] + b"\x02"), "YCCK"),
    "truncated_scan": (lambda: _encode(37, 53, quality=90), lambda d: d[: len(d) * 2 // 3], "truncated"),
    "no_eoi": (lambda: _encode(8, 8), lambda d: d[:-2], "truncated"),
    "wrong_restart": (lambda: _encode(37, 53, restart_marker_blocks=1), _wrong_rst, "RST"),
    "unrefined_progressive": (lambda: _encode(37, 53, progressive=True), lambda d: _progressive_cut(d, 3),
                              "unrefined"),
    "no_dht": (lambda: _encode(8, 8), lambda d: _edit(d, 0xC4, lambda p: None), "no DHT"),
    "no_dqt": (lambda: _encode(8, 8), lambda d: _edit(d, 0xDB, lambda p: None), "no DQT"),
    "dac": (lambda: _encode(8, 8), lambda d: _join([(0xCC, b"\x00\x10")] + _split(d)[0], _split(d)[1]), "DAC"),
    "not_jpeg": (lambda: b"\x89PNG\r\n\x1a\n", lambda d: d, "no SOI"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_unsupported_variants_raise(name):
    make, edit, what = REFUSED[name]
    with pytest.raises(JpegError, match=what):
        decode_jpeg(edit(make()))


def test_unrefined_progressive_is_smoothed_by_pil():
    """Why it is refused: PIL decodes the cut file with libjpeg's block
    smoothing, which this decoder does not reproduce."""
    data = _progressive_cut(_encode(37, 53, progressive=True), 3)
    assert _pil(data).shape == (53, 37, 4)
    full = _progressive_cut(_encode(37, 53, progressive=True), 10)
    assert np.array_equal(decode_jpeg(full), _pil(full))  # all ten scans: every coefficient refined


def _normal_range(data):
    """True if no component's dequantised coefficients, IDCT workspace or
    output leave the ranges where libjpeg-turbo's C and SIMD islow paths
    agree (int16, and -512..511 before the range limit; beyond, PIL's SIMD
    build saturates where jidctint.c wraps)."""
    frame, _ = J._markers(data)
    for c in frame.comps:
        rows, cols = -(-c.dh // 8), -(-c.dw // 8)
        deq = c.plane[:rows, :cols].reshape(-1, 8, 8).astype(np.int64) * c.qtable.reshape(1, 8, 8)
        ws = np.stack([(o + 1024) >> 11 for o in J._idct_1d([deq[:, k, :] for k in range(8)])], axis=1)
        out = np.stack([(o + (1 << 17)) >> 18 for o in J._idct_1d([ws[:, :, k] for k in range(8)])], axis=2)
        if np.abs(deq).max() > 32767 or np.abs(ws).max() > 32767 or out.min() < -512 or out.max() > 511:
            return False
    return True


@pytest.mark.parametrize("where", ["headers", "anywhere"])
def test_corrupt_files_raise_or_match_pil(where):
    """Bytes of PIL-written files overwritten at random (and cut short): the
    decoder returns an image or raises JpegError, nothing else, and every
    image it returns inside the normal range is PIL's."""
    rng = np.random.default_rng(17 if where == "headers" else 18)
    bases = [_encode(37, 53), _encode(37, 53, progressive=True), _encode(16, 16, "L", sub="444", restart_marker_blocks=1),
             _encode(13, 11, "CMYK", sub="444"), _encode(21, 13, sub="422", optimize=True, progressive=True)]
    decoded = compared = 0
    for i in range(300):
        base = bases[i % len(bases)]
        d = bytearray(base)
        end = base.index(b"\xff\xda") + 16 if where == "headers" else len(d)
        for _ in range(rng.integers(1, 4)):
            d[rng.integers(2, end)] = rng.integers(0, 256)
        if where == "anywhere" and rng.random() < 0.2:
            d = d[: rng.integers(2, len(d))]
        try:
            got = decode_jpeg(bytes(d))
        except JpegError:
            continue
        decoded += 1
        try:
            ref = _pil(bytes(d))
        except OSError:  # PIL refuses it (UnidentifiedImageError is an OSError)
            continue
        if _normal_range(bytes(d)):
            compared += 1
            assert np.array_equal(got, ref), f"mutation {i} decodes otherwise than PIL"
    assert decoded > 30 and compared > 20


# ---------------------------------------------------------------- numpy stages


def test_idct_range_limit_wraps():
    """A DC-only block gives (DC q + 4) >> 3 at every sample; jdmaster.c's
    table adds 128, clamps within +-511 and wraps beyond (np.clip would
    give 255 for 600 and 0 for -600)."""
    t = J.IDCT_RANGE_LIMIT
    assert t.shape == (1024,) and t[0] == 128 and t[127] == 255 and t[511] == 255 and t[512] == 0
    assert t[895] == 0 and t[896] == 0 and t[1023] == 127
    values = np.array([0, 127, -128, 300, -300, 511, -512, 600, -600, 1000])
    coef = np.zeros((values.size, 64), np.int16)
    coef[:, 0] = values
    out = J.idct_islow(coef, np.r_[8, np.ones(63)])
    assert (out == out[:, :1, :1]).all()
    assert out[:, 0, 0].tolist() == [128, 255, 0, 255, 0, 255, 0, 0, 255, 104]


def test_idct_matches_float_idct():
    """On blocks within the normal range the integer IDCT is the exact
    8x8 IDCT to within one step (jidctint.c's rounding)."""
    rng = np.random.default_rng(3)
    coef = np.zeros((500, 8, 8), np.int16)
    coef[:, 0, 0] = rng.integers(-800, 800, 500)
    coef[:, :4, :4] += rng.integers(-60, 60, (500, 4, 4)).astype(np.int16)
    q = rng.integers(1, 6, 64)
    deq = coef.reshape(500, 64).astype(np.float64) * q
    k = np.arange(8)
    basis = np.cos((2 * k[:, None] + 1) * k[None, :] * np.pi / 16) * np.where(k == 0, np.sqrt(0.5), 1.0)[None] / 2
    ref = np.einsum("xu,nuv,yv->nxy", basis, deq.reshape(500, 8, 8), basis) + 128
    got = J.idct_islow(coef.reshape(500, 64), q).astype(np.float64)
    inside = (ref > 0.5) & (ref < 254.5)
    assert np.abs(got - np.clip(np.round(ref), 0, 255))[inside].max() <= 1


def _h2v1_loop(row):
    """jdsample.c h2v1_fancy_upsample, transcribed loop for loop."""
    n, out = len(row), []
    out += [row[0], (row[0] * 3 + row[1] + 2) >> 2]
    for i in range(1, n - 1):
        v = row[i] * 3
        out += [(v + row[i - 1] + 1) >> 2, (v + row[i + 1] + 2) >> 2]
    out += [(row[-1] * 3 + row[-2] + 1) >> 2, row[-1]]
    return out


def _h2v2_loop(plane):
    """jdsample.c h2v2_fancy_upsample with jdmainct.c's context rows (the
    first row above row 0, the last real row below the last)."""
    rows = []
    h = len(plane)
    for y in range(h):
        for near, far in ((plane[y], plane[max(y - 1, 0)]), (plane[y], plane[min(y + 1, h - 1)])):
            s = [3 * a + b for a, b in zip(near, far)]
            out = [(s[0] * 4 + 8) >> 4, (s[0] * 3 + s[1] + 7) >> 4]
            for i in range(1, len(s) - 1):
                out += [(s[i] * 3 + s[i - 1] + 8) >> 4, (s[i] * 3 + s[i + 1] + 7) >> 4]
            out += [(s[-1] * 3 + s[-2] + 8) >> 4, (s[-1] * 4 + 7) >> 4]
            rows.append(out)
    return rows


@pytest.mark.parametrize("shape", [(1, 3), (2, 5), (3, 4), (5, 7)])
def test_fancy_upsampling_matches_libjpeg_loops(shape):
    plane = np.random.default_rng(shape[1]).integers(0, 256, shape).astype(np.uint8)
    rows = plane.astype(int).tolist()
    assert J.upsample(plane, 2, 1).tolist() == [_h2v1_loop(r) for r in rows]
    assert J.upsample(plane, 2, 2).tolist() == _h2v2_loop(rows)
    assert J.upsample(plane, 1, 1) is plane


@pytest.mark.parametrize("width", [1, 2])
def test_narrow_components_are_replicated(width):
    plane = np.arange(3 * width, dtype=np.uint8).reshape(3, width) * 40
    assert np.array_equal(J.upsample(plane, 2, 1), np.repeat(plane, 2, axis=1))
    assert np.array_equal(J.upsample(plane, 2, 2), np.repeat(np.repeat(plane, 2, axis=1), 2, axis=0))


def test_ycc_tables_and_conversion():
    """jdcolor.c's tables: nearest integers of 1.402 and 1.772 times
    Cr / Cb - 128, the green terms scaled by 2^16 with ONE_HALF in Cb_g."""
    cr_r, cb_b, cr_g, cb_g = J.YCC_TABLES
    x = np.arange(256) - 128
    assert np.array_equal(cr_r, np.floor(91881 * x / 65536 + 0.5).astype(int))
    assert np.array_equal(cb_b, np.floor(116130 * x / 65536 + 0.5).astype(int))
    assert np.array_equal(cr_g, -46802 * x) and np.array_equal(cb_g, -22554 * x + 32768)
    assert (cr_r[0], cr_r[255], cb_b[0], cb_b[255]) == (-179, 178, -227, 225)
    rng = np.random.default_rng(5)
    y, cb, cr = (rng.integers(0, 256, 4000).astype(np.uint8) for _ in range(3))
    got = J.ycc_to_rgb(y, cb, cr).astype(int)
    yi, cbi, cri = (v.astype(int) for v in (y, cb, cr))
    ref = np.stack([yi + cr_r[cri], yi + ((cb_g[cbi] + cr_g[cri]) >> 16), yi + cb_b[cbi]], -1)
    assert np.array_equal(got, np.clip(ref, 0, 255))
    fl = np.stack([yi + 1.402 * (cri - 128), yi - 0.34414 * (cbi - 128) - 0.71414 * (cri - 128),
                   yi + 1.772 * (cbi - 128)], -1)
    assert np.abs(got - np.clip(fl, 0, 255)).max() <= 1


def test_cmyk_conversion_equals_pil():
    rng = np.random.default_rng(6)
    cmyk = rng.integers(0, 256, (16, 16, 4)).astype(np.uint8)
    ref = np.asarray(Image.fromarray(cmyk, "CMYK").convert("RGB"))
    assert np.array_equal(J.cmyk_to_rgb(cmyk), ref)


# ---------------------------------------------------------------- the C++ scan decoder


def test_missing_gxx_raises(tmp_path, monkeypatch):
    """No Python fallback: without g++ the first decode raises."""
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(J, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ there
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        decode_jpeg(_encode(8, 8))


def test_library_built_with_the_host_flags():
    decode_jpeg(_encode(8, 8))
    path = build.library_path("yartjpeg", build.HOST_LIBRARIES["yartjpeg"])
    assert os.path.exists(path) and path.startswith(build.BUILD_ROOT)
    assert build.load("yartjpeg") == (J._library(), False)
