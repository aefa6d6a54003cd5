"""The port's glTF loader against the JAX package's, on the CPU.

On every GLB that tests/test_gltf.py builds (the two-triangle quad, strips
and fans, a sparse accessor, an interleaved byte stride, a mesh shared by
three nodes, the points / lines and TEXCOORD_1 warnings) and on further
files made here (the quad with five textures of different PNG colour
types, bit depths, filters and interlacing, one of them a data URI, used
by two materials; a shared mesh with a mirrored node, which is baked; a
.gltf file with an external buffer and image, a node hierarchy with
rotations and a matrix, normalized integer texture coordinates and uint8
indices; a file with no materials):
- the port's `load` gives every builder array, texture and MaterialDesc
  field bit-equal to the JAX `load`, with the same warnings;
- the compiled scene tables and meta are bit-equal to the JAX builder's
  (on its numpy BVH path);
- every malformed file of tests/test_gltf.py raises GltfError with the
  JAX loader's message;
- the textured quad with JPEG base-colour, metallic-roughness and normal
  textures loads bit-equal to the JAX loader (PIL there, io/jpeg.py
  here), compiles to the same tables and renders like it; a GIF texture,
  which the JAX loader decodes through PIL, raises GltfError naming GIF;
- a 24x24 render of the textured quad under an HDR environment (written by
  the port, read by each package's `load_hdr`) agrees with the JAX
  Renderer's (naive integrator) at tests/test_torch_render.py's image bar.
PIL is needed for the JAX loader's textures only."""

import base64
import io
import json
import struct
import warnings

import numpy as np
import pytest
import torch

from test_gltf import _build_glb, _quad_doc, _tri_doc_bin, _write_glb
from test_torch_sceneio import compare_builders, compile_both, encode_test_png, render_matches_jax
from yart_tpu.io.image import load_hdr as j_load_hdr
from yart_tpu.scene.gltf import GltfError as JGltfError
from yart_tpu.scene.gltf import load as j_load
from yart_tpu_torch.io.image import load_hdr as t_load_hdr
from yart_tpu_torch.io.image import save_hdr
from yart_tpu_torch.scene.gltf import GltfError
from yart_tpu_torch.scene.gltf import load as t_load

torch.set_num_threads(2)


def _read_glb(path):
    raw = open(path, "rb").read()
    (js_len,) = struct.unpack("<I", raw[12:16])
    doc = json.loads(raw[20 : 20 + js_len])
    (bin_len,) = struct.unpack("<I", raw[20 + js_len : 24 + js_len])
    return doc, raw[28 + js_len : 28 + js_len + bin_len]


def _append_view(doc, blob, data):
    """Append `data` to the BIN blob (4-byte aligned) as a new bufferView."""
    blob += b"\x00" * ((-len(blob)) % 4)
    doc["bufferViews"].append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)})
    blob += data
    doc["buffers"][0]["byteLength"] = len(blob)
    return len(doc["bufferViews"]) - 1, blob


def _texture_pngs():
    """Five PNGs: RGBA8 with alpha (Adam7, all filters), RGB16 (Paeth),
    a 4-bit palette with tRNS, 2-bit grey (Adam7), 16-bit grey + alpha."""
    rng = np.random.default_rng(11)
    rgba = rng.integers(0, 256, (16, 16, 4))
    rgba[:8, :, 3] = 255
    return [
        encode_test_png(rgba, 6, 8, (4, 0, 3, 1, 2), 1),
        encode_test_png(rng.integers(0, 65536, (8, 8, 3)), 2, 16, (4,)),
        encode_test_png(rng.integers(0, 16, (8, 8, 1)), 3, 4, (3, 4), 0,
                        plte=rng.integers(0, 256, 48).astype(np.uint8).tobytes(), trns=b"\xff\x40\x00"),
        encode_test_png(rng.integers(0, 4, (9, 7, 1)), 0, 2, (1, 2, 4), 1),
        encode_test_png(rng.integers(0, 65536, (8, 8, 2)), 4, 16, (2, 3)),
    ]


def _textured_quad(tmp_path, replace=None):
    """tests/test_gltf.py's quad with base colour, metallic-roughness,
    normal, emissive and transmission textures; the base colour texture is
    shared with a second material on a second primitive. `replace`:
    {image index: (bytes, mimeType)} in place of the PNGs."""
    doc, blob = _read_glb(_build_glb(tmp_path))
    images = [(png, "image/png") for png in _texture_pngs()]
    images = [(replace or {}).get(i, im) for i, im in enumerate(images)]
    doc["images"] = []
    for i, (data, mime) in enumerate(images):
        if i == 3:
            doc["images"].append({"uri": f"data:{mime};base64," + base64.b64encode(data).decode()})
        else:
            view, blob = _append_view(doc, blob, data)
            doc["images"].append({"bufferView": view, "mimeType": mime})
    doc["textures"] = [{"source": i} for i in range(len(images))]
    m = doc["materials"][0]
    m["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}
    m["pbrMetallicRoughness"]["metallicRoughnessTexture"] = {"index": 1}
    m["normalTexture"] = {"index": 2, "scale": 0.8}
    m["emissiveTexture"] = {"index": 3}
    m["extensions"]["KHR_materials_transmission"]["transmissionTexture"] = {"index": 4}
    doc["materials"].append({"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}, "metallicFactor": 0.2}})
    prim = dict(doc["meshes"][0]["primitives"][0], material=1)
    doc["meshes"][0]["primitives"].append(prim)
    return _write_glb(tmp_path, doc, blob, "textured.glb")


def _shared_mesh(tmp_path):
    """tests/test_gltf.py's three nodes sharing the quad's mesh, and a
    fourth, mirrored one (baked)."""
    doc, blob = _read_glb(_build_glb(tmp_path))
    doc["nodes"] = [
        {"mesh": 0, "translation": [0.0, 0.0, 0.0]},
        {"mesh": 0, "translation": [3.0, 0.0, 0.0]},
        {"mesh": 0, "translation": [0.0, 3.0, 0.0], "scale": [2, 2, 2]},
        {"mesh": 0, "translation": [0.0, -3.0, 0.0], "scale": [-1, 1, 1]},
    ]
    doc["scenes"] = [{"nodes": [0, 1, 2, 3]}]
    return _write_glb(tmp_path, doc, blob, "shared.glb")


def _strip_fan(tmp_path, mode):
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    views = [{"buffer": 0, "byteOffset": 0, "byteLength": 48}]
    accessors = [{"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"}]
    if mode == 5:
        blob, prim = pos.tobytes(), {"attributes": {"POSITION": 0}, "mode": 5, "material": 0}
    else:
        blob = pos.tobytes() + np.asarray([0, 1, 3, 2], np.uint16).tobytes()
        views.append({"buffer": 0, "byteOffset": 48, "byteLength": 8})
        accessors.append({"bufferView": 1, "componentType": 5123, "count": 4, "type": "SCALAR"})
        prim = {"attributes": {"POSITION": 0}, "indices": 1, "mode": 6, "material": 0}
    return _write_glb(tmp_path, _quad_doc(pos, [prim], accessors, blob, views), blob, f"mode{mode}.glb")


def _points_lines(tmp_path):
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    blob = pos.tobytes()
    doc = _quad_doc(pos, [{"attributes": {"POSITION": 0}, "mode": 0, "material": 0},
                          {"attributes": {"POSITION": 0}, "mode": 1, "material": 0},
                          {"attributes": {"POSITION": 0}, "mode": 4, "material": 0}],
                    [{"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"}], blob,
                    [{"buffer": 0, "byteOffset": 0, "byteLength": 36}])
    return _write_glb(tmp_path, doc, blob, "points.glb")


def _texcoord1(tmp_path):
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    uv = np.asarray([[0, 0], [1, 0], [0, 1]], np.float32)
    blob = pos.tobytes() + uv.tobytes() + uv.tobytes()
    views = [{"buffer": 0, "byteOffset": o, "byteLength": n} for o, n in ((0, 36), (36, 24), (60, 24))]
    accessors = [{"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
                 {"bufferView": 1, "componentType": 5126, "count": 3, "type": "VEC2"},
                 {"bufferView": 2, "componentType": 5126, "count": 3, "type": "VEC2"}]
    doc = _quad_doc(pos, [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1, "TEXCOORD_1": 2}, "material": 0}],
                    accessors, blob, views)
    return _write_glb(tmp_path, doc, blob, "uv1.glb")


def _sparse(tmp_path):
    pos = np.zeros((4, 3), np.float32)
    blob = (pos.tobytes() + np.asarray([[1, 0, 0], [0, 1, 0]], np.float32).tobytes()
            + np.asarray([1, 2], np.uint16).tobytes() + np.asarray([0, 1, 2, 1, 3, 2], np.uint16).tobytes())
    views = [{"buffer": 0, "byteOffset": o, "byteLength": n} for o, n in ((0, 48), (48, 24), (72, 4), (76, 12))]
    accessors = [{"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3",
                  "sparse": {"count": 2, "indices": {"bufferView": 2, "componentType": 5123},
                             "values": {"bufferView": 1}}},
                 {"bufferView": 3, "componentType": 5123, "count": 6, "type": "SCALAR"}]
    doc = _quad_doc(pos, [{"attributes": {"POSITION": 0}, "indices": 1, "material": 0}], accessors, blob, views)
    return _write_glb(tmp_path, doc, blob, "sparse.glb")


def _interleaved(tmp_path):
    inter = np.zeros((3, 6), np.float32)
    inter[:, :3] = [[0, 0, 0], [1, 0, 0], [0, 1, 0]]
    inter[:, 3:] = [0, 0, 1]
    blob = inter.tobytes()
    views = [{"buffer": 0, "byteOffset": 0, "byteLength": 72, "byteStride": 24}]
    accessors = [{"bufferView": 0, "byteOffset": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
                 {"bufferView": 0, "byteOffset": 12, "componentType": 5126, "count": 3, "type": "VEC3"}]
    doc = _quad_doc(inter, [{"attributes": {"POSITION": 0, "NORMAL": 1}, "material": 0}], accessors, blob, views)
    return _write_glb(tmp_path, doc, blob, "inter.glb")


def _hierarchy_gltf(tmp_path):
    """A .gltf with an external buffer, an external PNG, normalized uint16
    uvs, uint8 indices, tangents, and a node tree with rotations and a
    matrix."""
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    uv = np.asarray([[0, 0], [65535, 0], [65535, 65535], [0, 32768]], np.uint16)
    tan = np.tile(np.asarray([[1, 0, 0, -1]], np.float32), (4, 1))
    idx = np.asarray([0, 1, 2, 0, 2, 3], np.uint8)
    blob = pos.tobytes() + uv.tobytes() + tan.tobytes() + idx.tobytes()
    (tmp_path / "h.bin").write_bytes(blob)
    (tmp_path / "h.png").write_bytes(encode_test_png(np.random.default_rng(2).integers(0, 256, (5, 6, 3)), 2, 8, (4,)))
    q = np.asarray([0.2, -0.4, 0.1, 0.9])
    q = (q / np.linalg.norm(q)).tolist()
    doc = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}],
        "nodes": [
            {"children": [1, 2], "rotation": q, "translation": [0.5, 1.0, -2.0]},
            {"mesh": 0, "scale": [1.5, 0.5, 2.0], "rotation": [0, 0.7071068, 0, 0.7071068]},
            {"children": [3], "matrix": [0.8, 0.0, -0.6, 0, 0, 1, 0, 0, 0.6, 0, 0.8, 0, 1, 2, 3, 1]},
            {"mesh": 0, "translation": [0.0, 0.0, 1.0]},
        ],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1, "TANGENT": 2}, "indices": 3}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}},
                       "extensions": {"KHR_materials_anisotropy": {"anisotropyStrength": 0.3}}}],
        "images": [{"uri": "h.png"}],
        "textures": [{"source": 0}],
        "buffers": [{"uri": "h.bin", "byteLength": len(blob)}],
        "bufferViews": [{"buffer": 0, "byteOffset": o, "byteLength": n} for o, n in ((0, 48), (48, 16), (64, 64), (128, 6))],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "normalized": True, "count": 4, "type": "VEC2"},
            {"bufferView": 2, "componentType": 5126, "count": 4, "type": "VEC4"},
            {"bufferView": 3, "componentType": 5121, "count": 6, "type": "SCALAR"},
        ],
    }
    path = tmp_path / "h.gltf"
    path.write_text(json.dumps(doc))
    return str(path)


def _no_materials(tmp_path):
    doc, blob = _tri_doc_bin()
    del doc["materials"]
    del doc["meshes"][0]["primitives"][0]["material"]
    return _write_glb(tmp_path, doc, blob, "nomat.glb")


GLBS = {
    "quad": _build_glb,
    "quad_textured": _textured_quad,
    "strip": lambda t: _strip_fan(t, 5),
    "fan": lambda t: _strip_fan(t, 6),
    "points_lines": _points_lines,
    "texcoord1": _texcoord1,
    "sparse": _sparse,
    "interleaved": _interleaved,
    "shared_mesh": _shared_mesh,
    "hierarchy_gltf": _hierarchy_gltf,
    "no_materials": _no_materials,
}


def _load_both(path):
    """(JAX builder, port builder), each with the warnings it raised."""
    out = []
    for load in (j_load, t_load):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            b = load(path)
        out.append((b, [str(x.message) for x in w if issubclass(x.category, UserWarning)]))
    return out


@pytest.mark.parametrize("name", list(GLBS))
def test_load_and_compile_equal_jax(name, tmp_path):
    pytest.importorskip("PIL")
    path = GLBS[name](tmp_path)
    (jb, jw), (tb, tw) = _load_both(path)
    assert tw == jw
    assert bool(tw) == (name in ("points_lines", "texcoord1"))
    compare_builders(jb, tb)
    if name == "shared_mesh":  # one prototype, three instances, the mirrored node baked
        assert len(tb._protos) == 1 and len(tb._instances) == 3 and len(tb._positions) == 1
    _, jm, _, tm = compile_both(jb, tb)
    if name == "quad_textured":
        assert len(tb.textures_rgba) == 1 and len(tb.textures_rgb) == 2 and tm.any_alpha and tm.any_textures
        assert len(tb.textures_2ch) == len(tb.textures_mono) == 1
    if name == "shared_mesh":
        assert tm.n_tris == 4 * 2 and tm.n_instances == 4  # the baked mesh is one more instance
    if name == "no_materials":
        assert len(tb._materials) == 2  # the JAX loader's default material and its fallback
    assert tm.n_tris == jm.n_tris > 0


# ---------------------------------------------------------------- malformed files


def _truncated(t):
    doc, blob = _tri_doc_bin()
    data = open(_write_glb(t, doc, blob, "good.glb"), "rb").read()
    (t / "trunc.glb").write_bytes(data[:-16])
    return str(t / "trunc.glb")


def _edited(field):
    def make(t):
        doc, blob = _tri_doc_bin()
        field(doc)
        return _write_glb(t, doc, blob, "bad.glb")
    return make


def _bad_vertex_index(t):
    doc, _ = _tri_doc_bin()
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    return _write_glb(t, doc, pos.tobytes() + np.asarray([0, 1, 9], np.uint16).tobytes(), "vidx.glb")


def _no_json(t):
    blob = b"\x00" * 8
    (t / "nojson.glb").write_bytes(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(blob))
                                   + struct.pack("<II", len(blob), 0x004E4942) + blob)
    return str(t / "nojson.glb")


def _bad_version(t):
    doc, blob = _tri_doc_bin()
    data = bytearray(open(_write_glb(t, doc, blob, "v.glb"), "rb").read())
    struct.pack_into("<I", data, 4, 9)
    (t / "ver.glb").write_bytes(bytes(data))
    return str(t / "ver.glb")


def _sparse_overrun(t):
    doc, blob = _tri_doc_bin()
    extra = blob + np.asarray([7], np.uint16).tobytes() + b"\x00\x00" + np.asarray([[9, 9, 9]], np.float32).tobytes()
    doc["bufferViews"] += [{"buffer": 0, "byteOffset": len(blob), "byteLength": 2},
                           {"buffer": 0, "byteOffset": len(blob) + 4, "byteLength": 12}]
    doc["buffers"][0]["byteLength"] = len(extra)
    doc["accessors"][0]["sparse"] = {"count": 1, "indices": {"bufferView": 2, "componentType": 5123},
                                     "values": {"bufferView": 3}}
    return _write_glb(t, doc, extra, "sparse.glb")


# The malformed files of tests/test_gltf.py:369-506, with the message each raises.
MALFORMED = {
    "truncated_bin_chunk": (_truncated, "truncated"),
    "bin_shorter_than_declared": (_edited(lambda d: d["buffers"][0].update(byteLength=1042)), "BIN chunk"),
    "accessor_count_overrun": (_edited(lambda d: (d["accessors"][0].update(count=10_000),
                                                  d["bufferViews"][0].update(byteLength=42))), "overrun|needs"),
    "accessor_byteoffset_overrun": (_edited(lambda d: d["accessors"][0].update(byteOffset=1 << 20)), "overrun|needs"),
    "bufferview_overrun": (_edited(lambda d: d["bufferViews"][0].update(byteLength=42 + 512)), "truncated|spans"),
    "unknown_component_type": (_edited(lambda d: d["accessors"][1].update(componentType=5130)), "componentType"),
    "missing_buffer": (_edited(lambda d: d["bufferViews"][0].update(buffer=3)), "buffer"),
    "accessor_index_out_of_range": (_edited(lambda d: d["meshes"][0]["primitives"][0]["attributes"].update(
        POSITION=42)), "accessor 42"),
    "vertex_index_out_of_range": (_bad_vertex_index, "out of range"),
    "nontriple_indices": (_edited(lambda d: d["accessors"][1].update(count=2)), "multiple of 3"),
    "no_json_chunk": (_no_json, "JSON"),
    "bad_glb_version": (_bad_version, "version"),
    "sparse_index_overrun": (_sparse_overrun, "sparse"),
}


@pytest.mark.parametrize("name", list(MALFORMED))
def test_malformed_raises_gltf_error(name, tmp_path):
    make, match = MALFORMED[name]
    path = make(tmp_path)
    with pytest.raises(JGltfError, match=match) as je:
        j_load(path)
    with pytest.raises(GltfError, match=match) as te:
        t_load(path)
    assert str(te.value) == str(je.value)


def test_jpeg_texture_refused_by_name(tmp_path):
    """The textured quad with JPEG base-colour (baseline 4:2:0),
    metallic-roughness (progressive 4:4:4) and normal (optimized 4:2:2)
    textures: builder arrays, textures and compiled tables bit-equal to the
    JAX loader's (PIL decodes them there), and a 24x24 render like the JAX
    Renderer's at test_textured_quad_renders_like_jax's bar. A GIF texture,
    which PIL also decodes, is still refused by name."""
    image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(1)

    def jpeg(shape, **kw):
        buf = io.BytesIO()
        image.fromarray(rng.integers(0, 256, shape).astype(np.uint8)).save(buf, "JPEG", **kw)
        return buf.getvalue(), "image/jpeg"

    path = _textured_quad(tmp_path, {0: jpeg((16, 16, 3), quality=80, subsampling=2),
                                     1: jpeg((8, 8, 3), quality=95, subsampling=0, progressive=True),
                                     2: jpeg((8, 8, 3), quality=90, subsampling=1, optimize=True)})
    (jb, jw), (tb, tw) = _load_both(path)
    assert tw == jw
    compare_builders(jb, tb)
    assert tb.textures_rgba[0].shape == (16, 16, 4) and tb.textures_2ch[0].shape == (8, 8, 2)
    assert sorted(t.shape for t in tb.textures_rgb) == [(8, 8, 3), (9, 7, 3)]  # the JPEG normal map, the emissive PNG
    sky = str(tmp_path / "sky.hdr")
    save_hdr(sky, np.random.default_rng(8).lognormal(-1, 1, (16, 16, 3)).astype(np.float32))
    jb.set_env(j_load_hdr(sky), 1.5)
    tb.set_env(t_load_hdr(sky), 1.5)
    js, jm, ts, tm = compile_both(jb, tb)
    assert tm.has_env and tm.any_textures and not tm.any_alpha and tm.n_lights == 2
    render_matches_jax(js, jm, ts, tm, (2.0, 3.0, 7.0), (0.0, 0.0, -1.0), integrator="naive")

    buf = io.BytesIO()
    image.fromarray(rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)).save(buf, "GIF")
    (tmp_path / "gif").mkdir()
    path = _textured_quad(tmp_path / "gif", {0: (buf.getvalue(), "image/gif")})
    assert j_load(path).textures_rgba[0].shape == (8, 8, 4)  # PIL decodes it for the JAX loader
    with pytest.raises(GltfError, match="texture 0 .*GIF image.*PNG and JPEG"):
        t_load(path)


# ---------------------------------------------------------------- render


def test_textured_quad_renders_like_jax(tmp_path):
    pytest.importorskip("PIL")
    path = _textured_quad(tmp_path)
    sky = str(tmp_path / "sky.hdr")
    save_hdr(sky, np.random.default_rng(8).lognormal(-1, 1, (16, 16, 3)).astype(np.float32))
    (jb, _), (tb, _) = _load_both(path)
    jb.set_env(j_load_hdr(sky), 1.5)
    tb.set_env(t_load_hdr(sky), 1.5)
    js, jm, ts, tm = compile_both(jb, tb)
    assert tm.has_env and tm.any_alpha and tm.n_lights == 2
    # The naive integrator: the JAX MIS integrator's compile for a textured,
    # alpha-tested scene on XLA:CPU would take this file past its minute.
    render_matches_jax(js, jm, ts, tm, (2.0, 3.0, 7.0), (0.0, 0.0, -1.0), integrator="naive")
