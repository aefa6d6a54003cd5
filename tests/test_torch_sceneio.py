"""The port's scene-file I/O against the JAX package, on the CPU.

- `io/png.py` `decode_png` equals PIL's `Image.open(...).convert("RGBA")`
  (what the JAX glTF loader calls) on PIL-written PNGs of every mode PIL
  writes (1, L, LA, P at 1, 2, 4 and 8 bits, RGB, RGBA, I;16, each with
  and without a tRNS chunk where PIL writes one), and on PNGs this file
  writes: each of the five row filters alone and mixed, Adam7 interlace,
  every colour type at every bit depth the specification allows, tRNS
  keys and palettes; exactly, byte for byte. A bad CRC and a truncated
  stream are refused. The loader's `_decode_image` decodes a JPEG
  (tests/test_torch_jpeg.py holds io/jpeg.py to PIL), refuses GIF, BMP,
  WebP and KTX2 by name, and names the texture of a corrupt image.
- `load_hdr` / `save_hdr` bit-equal to the JAX package's on a flat file
  and on a run-length file written here; `equirect_to_octahedral` and
  `convert_hdri.main` bitwise.
- `export_glb` of a port-built scene writes the bytes the JAX `export_glb`
  writes for the same JAX-built scene (cornell-mat, a scene using every
  exporter branch with instances to flatten, atrium(ivy=True,
  tex_res=64)); `export_env_hdr` likewise.
- The JAX-exported cornell-mat GLB loads into builder arrays and compiled
  tables bit-equal to the JAX loader's, and a 24x24 render of it agrees
  with the JAX Renderer's at tests/test_torch_render.py's image bar.
"""

import dataclasses
import io
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

from torch_native_lib import numpy_twins
from yart_tpu.io import glb_export as JX
from yart_tpu.io import image as JI
from yart_tpu.scene import procedural as JP
from yart_tpu.scene import showcase as JS
from yart_tpu.scene.builder import SceneBuilder as JSB
from yart_tpu.scene.gltf import load as j_load
from yart_tpu.tools import convert_hdri as JH
from yart_tpu_torch.io import glb_export as TX
from yart_tpu_torch.io import image as TI
from yart_tpu_torch.io.png import PngError, decode_png
from yart_tpu_torch.ops.color import gamma2_encode_np, srgb_decode_np
from yart_tpu_torch.scene import procedural as TP
from yart_tpu_torch.scene import showcase as TS
from yart_tpu_torch.scene.builder import SceneBuilder as TSB
from yart_tpu_torch.scene.gltf import GltfError, _decode_image
from yart_tpu_torch.scene.gltf import load as t_load
from yart_tpu_torch.tools import convert_hdri as TH

torch.set_num_threads(2)

# ---------------------------------------------------------------- a PNG writer

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _filter_rows(rows, bpp, filters):
    """Filter [h, stride] bytes, row y with filters[y % len(filters)]."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for y in range(rows.shape[0]):
        r = rows[y].astype(np.int32)
        f = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 4:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        else:
            pred = (0, left, prev, (left + prev) >> 1)[f]
        out.append(bytes([f]) + ((r - pred) & 255).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def _pack(samples, depth):
    h, w, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, w * n).view(np.uint8).reshape(h, -1)
    flat = samples.reshape(h, w * n).astype(np.uint8)
    if depth == 8:
        return flat
    per = 8 // depth
    flat = np.concatenate([flat, np.zeros((h, (-flat.shape[1]) % per), np.uint8)], 1).reshape(h, -1, per)
    return (flat.astype(np.uint16) << (8 - depth * (np.arange(per) + 1))).sum(-1).astype(np.uint8)


def _chunk(tag, payload):
    return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)


def encode_test_png(samples, ctype, depth, filters=(0,), interlace=0, plte=None, trns=None):
    """PNG bytes of integer samples [H, W, channels] at any colour type and
    bit depth, rows filtered in turn with `filters`, Adam7 if `interlace`."""
    h, w, n = samples.shape
    bpp = max(1, n * depth // 8)
    if interlace:
        raw = b"".join(_filter_rows(_pack(samples[y0::dy, x0::dx], depth), bpp, filters)
                       for x0, y0, dx, dy in _ADAM7 if x0 < w and y0 < h)
    else:
        raw = _filter_rows(_pack(samples, depth), bpp, filters)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _pil_rgba(data):
    image = pytest.importorskip("PIL.Image")
    return np.asarray(image.open(io.BytesIO(data)).convert("RGBA"), np.uint8)


def _random_png(rng, ctype, depth, filters, interlace, trns):
    h, w = (int(x) for x in rng.integers(1, 40, 2))
    maxv = (1 << depth) - 1
    s = rng.integers(0, maxv + 1, (h, w, _CHANNELS[ctype]))
    if depth == 16:
        s[::2] = rng.integers(0, 300, s[::2].shape)  # 16-bit grey near 255: PIL's clamp
    plte = key = None
    if ctype == 3:
        n_pal = int(rng.integers(1, maxv + 2))  # indices past the palette too
        plte = rng.integers(0, 256, 3 * n_pal).astype(np.uint8).tobytes()
        if trns:
            key = rng.integers(0, 256, int(rng.integers(1, n_pal + 1))).astype(np.uint8).tobytes()
    elif trns and ctype in (0, 2):
        key = struct.pack(">" + "H" * _CHANNELS[ctype], *(int(v) for v in s[0, 0]))
    return encode_test_png(s, ctype, depth, filters, interlace, plte, key)


# ---------------------------------------------------------------- PNG decoder

_VARIANTS = [(c, d) for c, ds in {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}.items()
             for d in ds]
_FILTERS = {"none": (0,), "sub": (1,), "up": (2,), "average": (3,), "paeth": (4,), "mixed": (4, 0, 3, 1, 2)}


@pytest.mark.parametrize("filters", list(_FILTERS), ids=list(_FILTERS))
@pytest.mark.parametrize("interlace", [0, 1], ids=["flat", "adam7"])
def test_png_decoder_equals_pil_on_test_written_files(filters, interlace):
    """Every colour type at every allowed depth, with and without tRNS."""
    rng = np.random.default_rng(sorted(_FILTERS).index(filters) * 2 + interlace)
    for ctype, depth in _VARIANTS:
        for trns in (False, True):
            data = _random_png(rng, ctype, depth, _FILTERS[filters], interlace, trns)
            np.testing.assert_array_equal(decode_png(data), _pil_rgba(data), err_msg=f"{ctype}/{depth}/{trns}")


@pytest.mark.parametrize("key", [0, 1, 2, 85, 255, 256, 488, 65535])
def test_png_decoder_trns_keys_match_pil(key):
    """Grey keys at 1, 2, 8 and 16 bits and RGB keys at 8 and 16 bits past
    the sample range: PIL keeps the key's low byte (1-bit: 0 or white)."""
    grey = np.arange(4)[None, :, None]
    for depth, s in ((1, grey % 2), (2, grey), (8, grey * 85), (16, np.asarray([[[0], [232], [255], [1000]]]))):
        data = encode_test_png(s, 0, depth, trns=struct.pack(">H", key))
        np.testing.assert_array_equal(decode_png(data), _pil_rgba(data), err_msg=f"grey {depth}")
    rgb = np.asarray([[[0, 0, 0], [1, 2, 3], [232, 1, 1], [255, 255, 255]]])
    for depth, s in ((8, rgb), (16, rgb * 257)):
        data = encode_test_png(s, 2, depth, trns=struct.pack(">HHH", key, key & 0xFF, 1))
        np.testing.assert_array_equal(decode_png(data), _pil_rgba(data), err_msg=f"rgb {depth}")


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_png_decoder_equals_pil_on_palettes(bits):
    """Palette images at every depth, PLTE shorter than the index range,
    tRNS shorter than PLTE, written by PIL (bits=) and by this file."""
    image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(bits)
    idx = rng.integers(0, 1 << bits, (13, 37)).astype(np.uint8)
    im = image.fromarray(idx, "P")
    im.putpalette(rng.integers(0, 256, 3 * (1 << bits)).astype(np.uint8).tolist())
    for kw in ({}, {"transparency": rng.integers(0, 256, max(1, (1 << bits) // 2)).astype(np.uint8).tobytes()}):
        buf = io.BytesIO()
        im.save(buf, "PNG", bits=bits, **kw)
        np.testing.assert_array_equal(decode_png(buf.getvalue()), _pil_rgba(buf.getvalue()))
    for interlace in (0, 1):
        data = encode_test_png(idx[..., None], 3, bits, (4, 3), interlace,
                               plte=(np.arange(3 * max(1, (1 << bits) - 1)) % 251).astype(np.uint8).tobytes(),
                               trns=b"\x00\x80")
        np.testing.assert_array_equal(decode_png(data), _pil_rgba(data))


@pytest.mark.parametrize("mode", ["1", "L", "LA", "RGB", "RGBA", "I;16"])
def test_png_decoder_equals_pil_on_pil_written_files(mode):
    image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(len(mode))
    h, w = 21, 34
    if mode == "I;16":
        arr = rng.integers(0, 600, (h, w)).astype(np.uint16)
        ims = [image.fromarray(arr, "I;16")]
    elif mode == "1":
        ims = [image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))]
    else:
        n = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        arr = rng.integers(0, 256, (h, w, n)).astype(np.uint8)
        ims = [image.fromarray(arr[..., 0] if n == 1 else arr, mode)]
    im = ims[0]
    if mode in ("1", "L", "I;16"):
        ims.append(im.copy())
        ims[-1].info["transparency"] = int(np.asarray(im)[0, 0])
    elif mode == "RGB":
        ims.append(im.copy())
        ims[-1].info["transparency"] = tuple(int(v) for v in np.asarray(im)[0, 0])
    for im in ims:
        for opt in ({}, {"optimize": True, "compress_level": 9}):
            buf = io.BytesIO()
            im.save(buf, "PNG", **opt)
            data = buf.getvalue()
            got = decode_png(data)
            assert got.shape == (h, w, 4) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, _pil_rgba(data))


def test_png_decoder_refuses_bad_streams():
    data = encode_test_png(np.zeros((4, 4, 3), np.uint8), 2, 8)
    bad_crc = bytearray(data)
    bad_crc[20] ^= 1  # inside IHDR's payload
    with pytest.raises(PngError, match="CRC"):
        decode_png(bytes(bad_crc))
    with pytest.raises(PngError):
        decode_png(data[:-20])
    with pytest.raises(PngError, match="signature"):
        decode_png(b"GIF89a" + data[6:])
    short = encode_test_png(np.zeros((4, 4, 3), np.uint8), 2, 8)
    ihdr = struct.pack(">IIBBBBB", 4, 9, 8, 2, 0, 0, 0)  # 9 rows declared, 4 stored
    with pytest.raises(PngError, match="truncated"):
        decode_png(short[:8] + _chunk(b"IHDR", ihdr) + short[33:])
    with pytest.raises(PngError, match="bit depth 4"):
        decode_png(data[:8] + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 4, 2, 0, 0, 0)) + data[33:])


def test_jpeg_texture_raises_gltf_error():
    """A JPEG texture decodes (io/jpeg.py, to PIL's bytes); GIF, BMP, WebP
    and KTX2 still raise GltfError naming their format; a corrupt JPEG or
    PNG raises GltfError naming the texture."""
    image = pytest.importorskip("PIL.Image")
    rgb = np.random.default_rng(2).integers(0, 256, (9, 7, 3)).astype(np.uint8)
    buf = io.BytesIO()
    image.fromarray(rgb).save(buf, "JPEG", quality=90)
    jpeg = buf.getvalue()
    np.testing.assert_array_equal(_decode_image(jpeg, "texture 0"),
                                  np.asarray(image.open(io.BytesIO(jpeg)).convert("RGBA")))
    for fmt in ("GIF", "BMP", "WebP"):
        buf = io.BytesIO()
        image.fromarray(rgb).save(buf, fmt.upper())
        with pytest.raises(GltfError, match=f"texture 1 \\(image 3\\) is a {fmt} image.*PNG and JPEG"):
            _decode_image(buf.getvalue(), "texture 1 (image 3)")
    with pytest.raises(GltfError, match="is a KTX2 image"):
        _decode_image(b"\xabKTX 20\xbb\r\n\x1a\n" + bytes(64), "texture 2")
    with pytest.raises(GltfError, match="texture 0 \\(image 2\\): scan at byte .*truncated"):
        _decode_image(jpeg[: jpeg.index(b"\xff\xda") + 20] + b"\xff\xd9", "texture 0 (image 2)")
    with pytest.raises(GltfError, match="texture 0: .*12-bit"):
        _decode_image(jpeg.replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c", 1), "texture 0")
    with pytest.raises(GltfError, match="texture 0: chunk"):
        _decode_image(encode_test_png(np.zeros((2, 2, 1), np.uint8), 0, 8)[:-8] + b"\x00" * 8, "texture 0")
    np.testing.assert_array_equal(_decode_image(encode_test_png(np.full((2, 2, 1), 7), 0, 8), "t")[..., :3], 7)


# ---------------------------------------------------------------- HDR files


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(np.atleast_1d(a)).view(np.uint8)


def _rle_hdr(rgbe):
    """A Radiance file of new-style run-length scanlines (runs and literals)."""
    h, w, _ = rgbe.shape
    out = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n", f"-Y {h} +X {w}\n".encode()]
    for y in range(h):
        out.append(bytes([2, 2, w >> 8, w & 255]))
        for c in range(4):
            row, x = rgbe[y, :, c], 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run >= 3:
                    out.append(bytes([128 + run, row[x]]))
                    x += run
                else:
                    n = min(128, w - x)
                    out.append(bytes([n]) + row[x : x + n].tobytes())
                    x += n
    return b"".join(out)


def test_hdr_io_bit_equal_to_jax(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.lognormal(0, 3, (19, 37, 3)).astype(np.float32)
    img[0, :5] = 0.0
    img[1, 0] = 1e-40
    j, t = tmp_path / "j.hdr", tmp_path / "t.hdr"
    JI.save_hdr(str(j), img)
    TI.save_hdr(str(t), img)
    assert j.read_bytes() == t.read_bytes()
    np.testing.assert_array_equal(_bits(TI.load_hdr(str(j))), _bits(JI.load_hdr(str(j))))
    # Run-length scanlines: constant runs, literals, a run at a row's end.
    rgbe = rng.integers(0, 256, (9, 40, 4)).astype(np.uint8)
    rgbe[:, 5:20] = rgbe[:, 5:6]
    rgbe[:, 33:] = 7
    rle = tmp_path / "rle.hdr"
    rle.write_bytes(_rle_hdr(rgbe))
    flat = tmp_path / "flat.hdr"
    flat.write_bytes(b"#?RGBE\n\n-Y 9 +X 40\n" + rgbe.tobytes())
    got = TI.load_hdr(str(rle))
    np.testing.assert_array_equal(_bits(got), _bits(JI.load_hdr(str(rle))))
    np.testing.assert_array_equal(_bits(got), _bits(TI.load_hdr(str(flat))))
    with pytest.raises(ValueError, match="not a Radiance"):
        bad = tmp_path / "bad.hdr"
        bad.write_bytes(b"P6\n4 4\n255\n")
        TI.load_hdr(str(bad))


def test_equirect_to_octahedral_bitwise(tmp_path):
    rng = np.random.default_rng(6)
    eq = rng.lognormal(0, 1, (24, 48, 3)).astype(np.float32)
    for size in (1, 16, 33):
        np.testing.assert_array_equal(_bits(TH.equirect_to_octahedral(eq, size)),
                                      _bits(JH.equirect_to_octahedral(eq, size)))
    src = tmp_path / "eq.hdr"
    JI.save_hdr(str(src), eq)
    assert TH.main([str(src), str(tmp_path / "t.hdr"), "20"]) == 0
    assert JH.main([str(src), str(tmp_path / "j.hdr"), "20"]) == 0
    assert (tmp_path / "t.hdr").read_bytes() == (tmp_path / "j.hdr").read_bytes()
    assert TH.main([]) == 1


# ---------------------------------------------------------------- GLB export


def _u8_storage_rgba(rng, h, w, alpha=False):
    """A random texture on the 8-bit sRGB grid, storage-encoded."""
    u8 = rng.integers(0, 256, size=(h, w, 4)).astype(np.float32) / 255.0
    out = u8.copy()
    out[..., :3] = gamma2_encode_np(srgb_decode_np(u8[..., :3]))
    if not alpha:
        out[..., 3] = 1.0
    return out


def _export_scene(sb, uv_sphere):
    """tests/test_glb_export.py's scene, built with builder class `sb`,
    plus a normal map, a metallic-roughness texture and a prototype
    instanced twice (flattened by the exporter) and an environment."""
    rng = np.random.default_rng(3)
    b = sb()
    t_base = b.add_texture("rgba", _u8_storage_rgba(rng, 16, 16))
    t_cut = b.add_texture("rgba", _u8_storage_rgba(rng, 8, 8, alpha=True))
    t_nrm = b.add_texture("rgb", rng.random((8, 8, 3)).astype(np.float32))
    t_mr = b.add_texture("2ch", rng.random((4, 8, 2)).astype(np.float32))
    m_tex = b.add_material(roughness=0.6, tex_base=t_base, tex_normal=t_nrm, normal_scale=0.7, tex_mr=t_mr)
    m_gold = b.add_material(base_color=(0.9, 0.7, 0.3, 1.0), metallic=1.0, roughness=0.3)
    m_glass = b.add_material(base_color=(1, 1, 1, 1), transmission=1.0, roughness=0.05, ior=1.45)
    m_cut = b.add_material(roughness=0.8, tex_base=t_cut, has_alpha=True)
    m_lamp = b.add_material(emission=(4.0, 3.0, 2.0), emission_strength=2.0)
    m_dim = b.add_material(emission=(0.5, 0.25, 0.0))
    m_coat = b.add_material(base_color=(0.6, 0.05, 0.05, 1.0), roughness=0.4, clearcoat=0.8, cc_roughness=0.1)
    m_vol = b.add_material(base_color=(1, 1, 1, 1), transmission=1.0, roughness=0.02, ior=1.5, thin=False,
                           volume_color=(0.9, 0.6, 0.3), volume_density=2.0)
    quad = np.asarray([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32)
    quv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    qidx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    b.add_mesh(quad, qidx, m_tex, uvs=quv)
    for center, r, mat in (((0.0, 0.8, 0.0), 0.5, m_gold), ((1.0, 0.6, 0.6), 0.35, m_glass),
                           ((-1.2, 0.5, -0.5), 0.3, m_coat), ((1.2, 0.5, -0.8), 0.3, m_vol)):
        pos, nrm, tri = uv_sphere(center, r, n_theta=6, n_phi=8)
        b.add_mesh(pos, tri, mat, normals=nrm)
    b.add_mesh(quad * 0.4 + np.asarray([[-1.0, 0.9, 0.5]], np.float32), qidx, m_cut, uvs=quv)
    b.add_mesh(quad * 0.25 + np.asarray([[0.0, 2.2, 0.0]], np.float32), qidx[:, ::-1], [m_lamp, m_dim], uvs=quv)
    pos, nrm, tri = uv_sphere((0.0, 0.0, 0.0), 0.2, n_theta=5, n_phi=6)
    pid = b.add_prototype(pos, tri, np.arange(tri.shape[0]) % 2 + m_gold, normals=nrm)
    rot = np.eye(4)
    rot[:3, :3] = [[0, 0, 2], [0, 1, 0], [-1, 0, 0]]
    rot[:3, 3] = (0.5, 1.5, -1.0)
    b.add_instance(pid, rot)
    b.add_instance(pid)
    b.set_env(np.abs(rng.normal(size=(16, 16, 3))).astype(np.float32), scale=2.0)
    return b


@pytest.mark.parametrize("name", ["cornell_mat", "exporter_branches", "atrium_ivy"])
def test_export_glb_byte_identical_to_jax(name, tmp_path):
    if name == "cornell_mat":
        jb, tb = JP.cornell_box(extra_materials=True), TP.cornell_box(extra_materials=True)
    elif name == "exporter_branches":
        jb, tb = _export_scene(JSB, JP.uv_sphere), _export_scene(TSB, TP.uv_sphere)
    else:
        jb, tb = JS.atrium(ivy=True, tex_res=64), TS.atrium(ivy=True, tex_res=64)
    js = JX.export_glb(jb, str(tmp_path / "j.glb"))
    ts = TX.export_glb(tb, str(tmp_path / "t.glb"))
    assert ts == js and ts["tris"] > 0
    assert (tmp_path / "t.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()
    if name == "exporter_branches":
        assert ts["textures"] == 4
        for scale in (False, True):
            assert TX.export_env_hdr(tb, str(tmp_path / "t.hdr"), apply_scale=scale)
            assert JX.export_env_hdr(jb, str(tmp_path / "j.hdr"), apply_scale=scale)
            assert (tmp_path / "t.hdr").read_bytes() == (tmp_path / "j.hdr").read_bytes()
    if name == "cornell_mat":
        assert not TX.export_env_hdr(tb, str(tmp_path / "none.hdr"))


# ---------------------------------------------------------------- cornell-mat GLB


def compare_builders(jb, tb):
    """Every builder array, texture and MaterialDesc field bit-equal."""
    for f in ("_positions", "_normals", "_tangents", "_uvs", "_tris", "_tri_mat",
              "textures_rgba", "textures_rgb", "textures_2ch", "textures_mono"):
        ja, ta = getattr(jb, f), getattr(tb, f)
        assert len(ja) == len(ta), f
        for a, b in zip(ja, ta):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=f)
    assert [dataclasses.asdict(m) for m in tb._materials] == [dataclasses.asdict(m) for m in jb._materials]
    assert len(tb._protos) == len(jb._protos) and len(tb._instances) == len(jb._instances)
    for jp, tp in zip(jb._protos, tb._protos):
        assert sorted(jp) == sorted(tp)
        for k in jp:
            np.testing.assert_array_equal(_bits(tp[k]), _bits(jp[k]), err_msg=k)
    for (jpid, jm), (tpid, tm) in zip(jb._instances, tb._instances):
        assert jpid == tpid
        np.testing.assert_array_equal(_bits(tm), _bits(jm))


def compare_tables(a, b, name="scene"):
    """A port compiled scene / meta against the JAX one, recursively, bit
    for bit (tensors against arrays, NamedTuples, dataclasses, tuples)."""
    if isinstance(a, torch.Tensor):
        x, y = np.atleast_1d(a.numpy()), np.atleast_1d(np.asarray(b))  # the 0-d scene_radius is [1] here
        assert x.shape == y.shape and x.dtype == y.dtype, (name, x.shape, y.shape, x.dtype, y.dtype)
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=name)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if hasattr(b, f.name):  # fields of the port's alone (none yet) are skipped
                compare_tables(getattr(a, f.name), getattr(b, f.name), f"{name}.{f.name}")
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        for g in a._fields:
            compare_tables(getattr(a, g), getattr(b, g), f"{name}.{g}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            compare_tables(x, y, f"{name}[{i}]")
    else:
        assert a == b, (name, a, b)


def compile_both(jb, tb):
    """(JAX scene as numpy leaves, JAX scene, JAX meta, port scene, port
    meta); both builders on their numpy BVH paths."""
    with pytest.MonkeyPatch.context() as mp:
        numpy_twins(mp)
        js, jm = jb.compile()
        ts, tm = tb.compile(device="cpu")
    compare_tables(ts, jax.tree_util.tree_map(np.asarray, js))
    compare_tables(tm, jm, "meta")
    return js, jm, ts, tm


def render_matches_jax(js, jm, ts, tm, position, forward, integrator="mis"):
    """A 24x24, 4-spp, depth-4 render against the JAX Renderer at
    tests/test_torch_render.py's image bar (>= 95% of pixels within rtol
    1e-4 / atol 1e-5, mean absolute difference <= 1% of the mean, channel
    means within 0.5%)."""
    from yart_tpu.config import CameraConfig as JCam
    from yart_tpu.config import RenderConfig as JCfg
    from yart_tpu.render.renderer import Renderer as JRenderer
    from yart_tpu_torch.config import CameraConfig, RenderConfig
    from yart_tpu_torch.render.renderer import Renderer

    kw = dict(image_size=(24, 24), focal_length=35.0, position=position, forward=forward)
    cfg = dict(samples=4, max_depth=4, integrator=integrator, estimator="mean", tonemap="none",
               first_wave_samples=4, max_wave_samples=4)
    img = Renderer(ts, tm, CameraConfig(**kw), RenderConfig(**cfg), device="cpu").render().hdr
    ref = np.asarray(JRenderer(js, jm, JCam(**kw), JCfg(**cfg)).render().hdr)
    assert img.shape == ref.shape and np.isfinite(img).all() and ref.mean() > 1e-3
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.95, close.mean()
    assert np.abs(img - ref).mean() <= 0.01 * ref.mean()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)), rtol=5e-3)


def test_cornell_mat_glb_loads_and_renders_like_jax(tmp_path):
    path = str(tmp_path / "cornell_mat.glb")
    JX.export_glb(JP.cornell_box(extra_materials=True), path)
    jb, tb = j_load(path), t_load(path)
    compare_builders(jb, tb)
    assert len(tb._materials) == 6 and all(m.thin and m.cc_roughness == 0.03 for m in tb._materials)
    js, jm, ts, tm = compile_both(jb, tb)
    assert tm.n_lights > 0 and tm.n_tris <= 4096
    render_matches_jax(js, jm, ts, tm, (0, 1.0, 3.4), (0, 0, -1))
