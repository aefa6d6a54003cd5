"""glTF 2.0 / GLB scene loader; port of `yart_tpu/scene/gltf.py`.

Reads the raw glTF JSON (the reference uses fastgltf, src/gltf/gltf.cpp):
the GLB container, external and data-URI buffers, POSITION / NORMAL /
TEXCOORD_0 / TANGENT accessors (sparse, strided, normalized integers),
TRIANGLES / TRIANGLE_STRIP / TRIANGLE_FAN primitives, per-node TRS or
matrix transforms applied through the SceneBuilder (a world-space
pretransform in place of the reference's runtime scene graph), meshes
shared by several nodes as prototypes and instances, and the material
mapping:

- baseColorFactor + sRGB RGBA texture (gltf.cpp:69-77)
- metallic / roughness factors + channels (G, B) of the MR texture as a
  2-channel non-colour texture (gltf.cpp:79-89)
- KHR_materials_transmission factor + mono texture (gltf.cpp:91-103)
- thinTransmission hard-coded true (gltf.cpp:104-105), except with a
  KHR_materials_volume density, which needs a solid interior
- KHR_materials_anisotropy strength / rotation (gltf.cpp:108-113)
- KHR_materials_clearcoat factor / roughness (default 0.03, gltf.cpp:115-121)
- emissiveFactor x KHR_materials_emissive_strength + sRGB texture
  (gltf.cpp:123-133)
- normalTexture + scale (gltf.cpp:136-145)
- KHR_materials_volume: attenuationColor, density = 1 / attenuationDistance
  (gltf.cpp:147-153)

Emissive triangles become area lights in SceneBuilder.compile
(gltf.cpp:299-314). Textures are decoded by the port's own decoders,
`io/png.py` and `io/jpeg.py` (glTF 2.0 core's two image types), equal to
what PIL's convert("RGBA") gives the JAX loader; an image of another
format (GIF, BMP, WebP, KTX2), or a JPEG variant `io/jpeg.py` does not
read, raises GltfError naming it.
"""

from __future__ import annotations

import base64
import json
import os
import struct
import warnings
from typing import Dict, List, Optional

import numpy as np

from yart_tpu_torch.io.jpeg import SOI, JpegError, decode_jpeg
from yart_tpu_torch.io.png import SIGNATURE, PngError, decode_png
from yart_tpu_torch.ops.color import gamma2_encode_np, srgb_decode_np
from yart_tpu_torch.scene.builder import MaterialDesc, SceneBuilder


class GltfError(ValueError):
    """Malformed glTF / GLB input, raised for every structural defect
    (truncated chunks, accessor overruns, unknown componentTypes, missing
    buffers, undecodable textures): the loader never emits geometry from a
    bad file (fastgltf's validation in the reference, gltf.cpp:323-337)."""


_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}
# Leading bytes of image formats outside glTF 2.0 core, refused by name.
_IMAGE_MAGIC = (
    (b"GIF8", "GIF"),
    (b"BM", "BMP"),
    (b"\xabKTX 20\xbb", "KTX2"),
)


class _Gltf:
    def __init__(self, doc: dict, buffers: List[bytes], base_dir: str):
        self.doc = doc
        self.buffers = buffers
        self.base_dir = base_dir

    def _view_buffer(self, bv_idx, what: str):
        """bufferView -> (view dict, backing bytes), every index and length
        checked."""
        views = self.doc.get("bufferViews", [])
        if not (0 <= bv_idx < len(views)):
            raise GltfError(f"{what}: bufferView {bv_idx} out of range (file has {len(views)})")
        bv = views[bv_idx]
        bi = bv.get("buffer", 0)
        if not (0 <= bi < len(self.buffers)):
            raise GltfError(f"{what}: bufferView {bv_idx} references buffer {bi} "
                            f"but the file has {len(self.buffers)} buffer(s)")
        buf = self.buffers[bi]
        end = bv.get("byteOffset", 0) + bv.get("byteLength", 0)
        if end > len(buf):
            raise GltfError(f"{what}: bufferView {bv_idx} spans bytes [{bv.get('byteOffset', 0)}, {end}) "
                            f"but buffer {bi} holds only {len(buf)} bytes (truncated file?)")
        return bv, buf

    def accessor(self, idx: int) -> np.ndarray:
        accs = self.doc.get("accessors", [])
        if not (0 <= idx < len(accs)):
            raise GltfError(f"accessor {idx} out of range (file has {len(accs)})")
        acc = accs[idx]
        n = acc["count"]
        if acc["type"] not in _TYPE_COUNTS:
            raise GltfError(f"accessor {idx}: unknown type {acc['type']!r}")
        ncomp = _TYPE_COUNTS[acc["type"]]
        if acc["componentType"] not in _COMPONENT_DTYPES:
            raise GltfError(f"accessor {idx}: unknown componentType {acc['componentType']} "
                            f"(spec values: {sorted(_COMPONENT_DTYPES)})")
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize * ncomp

        if "bufferView" not in acc:
            out = np.zeros((n, ncomp), dtype)
        else:
            bv, buf = self._view_buffer(acc["bufferView"], f"accessor {idx}")
            offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", itemsize)
            need = offset + ((n - 1) * stride + itemsize if n else 0)
            if need > len(buf):
                raise GltfError(f"accessor {idx}: count={n} stride={stride} at byte offset {offset} needs "
                                f"{need} bytes but buffer holds {len(buf)} (accessor overrun / truncated buffer)")
            if stride == itemsize:
                out = np.frombuffer(buf, dtype, count=n * ncomp, offset=offset).reshape(n, ncomp)
            else:
                raw = np.frombuffer(buf, np.uint8, count=(n - 1) * stride + itemsize, offset=offset)
                out = np.lib.stride_tricks.as_strided(
                    raw.view(dtype), shape=(n, ncomp), strides=(stride, np.dtype(dtype).itemsize)
                ).copy()
        if "sparse" in acc:
            # Sparse overlay (glTF 2.0 3.6.2.3): replace `count` elements of
            # the (possibly zero) base.
            sp = acc["sparse"]
            out = np.array(out)
            si = sp["indices"]
            sbv, sbuf = self._view_buffer(si["bufferView"], f"accessor {idx} sparse indices")
            if si["componentType"] not in _COMPONENT_DTYPES:
                raise GltfError(f"accessor {idx}: sparse indices componentType {si['componentType']} unknown")
            sdt = _COMPONENT_DTYPES[si["componentType"]]
            soff = sbv.get("byteOffset", 0) + si.get("byteOffset", 0)
            if soff + sp["count"] * np.dtype(sdt).itemsize > len(sbuf):
                raise GltfError(f"accessor {idx}: sparse indices overrun buffer")
            sidx = np.frombuffer(sbuf, sdt, count=sp["count"], offset=soff).astype(np.int64)
            if sp["count"] and (sidx.min() < 0 or sidx.max() >= n):
                raise GltfError(f"accessor {idx}: sparse index {int(sidx.max())} outside accessor count {n}")
            sv = sp["values"]
            vbv, vbuf = self._view_buffer(sv["bufferView"], f"accessor {idx} sparse values")
            voff = vbv.get("byteOffset", 0) + sv.get("byteOffset", 0)
            if voff + sp["count"] * itemsize > len(vbuf):
                raise GltfError(f"accessor {idx}: sparse values overrun buffer")
            out[sidx] = np.frombuffer(vbuf, dtype, count=sp["count"] * ncomp, offset=voff).reshape(sp["count"], ncomp)
        if acc.get("normalized") and dtype != np.float32:
            out = out.astype(np.float32) / np.iinfo(dtype).max
        return out

    def image_bytes(self, img_idx: int) -> bytes:
        img = self.doc["images"][img_idx]
        if "bufferView" in img:
            bv, buf = self._view_buffer(img["bufferView"], f"image {img_idx}")
            off = bv.get("byteOffset", 0)
            return bytes(buf[off : off + bv["byteLength"]])
        return _load_buffer_uri(img["uri"], self.base_dir)


def _load_doc(path: str) -> _Gltf:
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        data = f.read()

    if data[:4] == b"glTF":  # GLB container
        if len(data) < 12:
            raise GltfError(f"{path}: GLB header truncated ({len(data)} bytes)")
        _, version, length = struct.unpack_from("<III", data, 0)
        if version != 2:
            raise GltfError(f"{path}: unsupported GLB version {version}")
        if length > len(data):
            raise GltfError(f"{path}: GLB header declares {length} bytes but the file holds {len(data)} "
                            "(truncated file)")
        pos = 12
        doc = None
        bin_chunk = b""
        while pos < length:
            if pos + 8 > length:
                raise GltfError(f"{path}: GLB chunk header truncated at {pos}")
            clen, ctype = struct.unpack_from("<II", data, pos)
            if pos + 8 + clen > length:
                raise GltfError(f"{path}: GLB chunk at {pos} declares {clen} bytes but only "
                                f"{length - pos - 8} remain (truncated chunk)")
            chunk = data[pos + 8 : pos + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                try:
                    doc = json.loads(chunk)
                except json.JSONDecodeError as e:
                    raise GltfError(f"{path}: GLB JSON chunk invalid: {e}")
            elif ctype == 0x004E4942:  # BIN
                bin_chunk = chunk
            pos += 8 + clen
        if doc is None:
            raise GltfError(f"{path}: GLB file has no JSON chunk")
        buffers = []
        for bidx, b in enumerate(doc.get("buffers", [])):
            if "uri" not in b:
                if b.get("byteLength", 0) > len(bin_chunk):
                    raise GltfError(f"{path}: buffer {bidx} declares byteLength {b['byteLength']} but the "
                                    f"BIN chunk holds {len(bin_chunk)} bytes (truncated BIN chunk)")
                buffers.append(bin_chunk)
            else:
                buffers.append(_load_buffer_uri(b["uri"], base_dir))
        return _Gltf(doc, buffers, base_dir)

    doc = json.loads(data)
    return _Gltf(doc, [_load_buffer_uri(b["uri"], base_dir) for b in doc.get("buffers", [])], base_dir)


def _load_buffer_uri(uri: str, base_dir: str) -> bytes:
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    with open(os.path.join(base_dir, uri), "rb") as f:
        return f.read()


def _decode_image(raw: bytes, what: str) -> np.ndarray:
    """Encoded image bytes -> uint8 RGBA [H, W, 4]; PNG or JPEG."""
    if raw.startswith(SIGNATURE):
        decode, error = decode_png, PngError
    elif raw.startswith(SOI + b"\xff"):
        decode, error = decode_jpeg, JpegError
    else:
        fmt = next((name for magic, name in _IMAGE_MAGIC if raw.startswith(magic)), None)
        if fmt is None and raw[:4] == b"RIFF" and raw[8:12] == b"WEBP":
            fmt = "WebP"
        raise GltfError(f"{what} is a {fmt or 'non-PNG, non-JPEG'} image: this loader decodes PNG and JPEG "
                        "(glTF 2.0 core's image types); re-encode it as one of them")
    try:
        return decode(raw)
    except error as e:
        raise GltfError(f"{what}: {e}") from None


def _decode_texture(g: _Gltf, tex_idx: int, kind: str, channels: Optional[List[int]] = None) -> np.ndarray:
    """A glTF texture as storage-encoded float32 [H, W, C]. kind 'srgb':
    sRGB decoded, then gamma-2 re-encoded (texture.hpp:78-86); 'noncolor':
    the linear 8-bit values as they are."""
    tex = g.doc["textures"][tex_idx]
    rgba = _decode_image(g.image_bytes(tex["source"]), f"texture {tex_idx} (image {tex['source']})")
    arr = rgba.astype(np.float32) / 255.0  # [H, W, 4]
    if channels is not None:
        arr = arr[..., channels]
    if kind == "srgb":
        out = arr.copy()
        out[..., :3] = gamma2_encode_np(srgb_decode_np(arr[..., :3]))
        return out
    return arr


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.asarray([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def _material(g: _Gltf, b: SceneBuilder, gm: dict, cached_texture) -> MaterialDesc:
    """One glTF material as a MaterialDesc (gltf.cpp:69-153)."""
    pbr = gm.get("pbrMetallicRoughness", {})
    desc = MaterialDesc(base_color=tuple(pbr.get("baseColorFactor", [1, 1, 1, 1])),
                        metallic=pbr.get("metallicFactor", 1.0), roughness=pbr.get("roughnessFactor", 1.0))
    ext = gm.get("extensions", {})
    if "baseColorTexture" in pbr:
        desc.tex_base = cached_texture("rgba", pbr["baseColorTexture"]["index"], "srgb", None)
        desc.has_alpha = bool(np.any(b.textures_rgba[desc.tex_base][..., 3] < 1.0))
    if "metallicRoughnessTexture" in pbr:
        # channels (G, B) = (roughness, metallic) (gltf.cpp:86-88)
        desc.tex_mr = cached_texture("2ch", pbr["metallicRoughnessTexture"]["index"], "noncolor", [1, 2])

    tr = ext.get("KHR_materials_transmission")
    if tr:
        desc.transmission = tr.get("transmissionFactor", 0.0)
        if "transmissionTexture" in tr:
            desc.tex_transmission = cached_texture("mono", tr["transmissionTexture"]["index"], "noncolor", [0])
    desc.thin = True  # gltf.cpp:104-105
    desc.ior = ext.get("KHR_materials_ior", {}).get("ior", 1.5)

    an = ext.get("KHR_materials_anisotropy")
    if an:
        desc.anisotropic = an.get("anisotropyStrength", 0.0)
        desc.aniso_rotation = an.get("anisotropyRotation", 0.0)

    cc = ext.get("KHR_materials_clearcoat")
    desc.cc_roughness = 0.03  # gltf.cpp:116
    if cc:
        desc.clearcoat = cc.get("clearcoatFactor", 0.0)
        desc.cc_roughness = cc.get("clearcoatRoughnessFactor", 0.0)

    desc.emission = tuple(gm.get("emissiveFactor", [0, 0, 0]))
    desc.emission_strength = ext.get("KHR_materials_emissive_strength", {}).get("emissiveStrength", 1.0)
    if "emissiveTexture" in gm:
        desc.tex_emission = cached_texture("rgb", gm["emissiveTexture"]["index"], "srgb", [0, 1, 2])

    if "normalTexture" in gm:
        desc.tex_normal = cached_texture("rgb", gm["normalTexture"]["index"], "noncolor", [0, 1, 2])
        desc.normal_scale = gm["normalTexture"].get("scale", 1.0)

    vol = ext.get("KHR_materials_volume")
    if vol:
        desc.volume_color = tuple(vol.get("attenuationColor", [1, 1, 1]))
        att_dist = vol.get("attenuationDistance", float("inf"))
        desc.volume_density = 1.0 / att_dist if att_dist > 0 else 0.0
        if desc.volume_density > 0.0:
            # Beer-Lambert attenuation accrues over an interior path, which
            # thin transmission never has: a volume makes the material solid
            # (the reference's hard-coded thin flag disables its own volume
            # import; the JAX package diverges from it here, and so does this
            # port).
            desc.thin = False
    return desc


def _primitive(g: _Gltf, prim: dict, mat_ids: List[int]):
    """(positions, normals, uvs, tangents, [T, 3] indices, material) of one
    triangle primitive, or None for points and lines (warned)."""
    mode = prim.get("mode", 4)
    if mode not in (4, 5, 6):
        warnings.warn(f"gltf: skipping primitive with non-triangle mode {mode} "
                      "(points/lines are not renderable geometry)")
        return None
    attrs = prim["attributes"]
    if "TEXCOORD_1" in attrs:
        warnings.warn("gltf: TEXCOORD_1 present but only TEXCOORD_0 is sampled "
                      "(matches the reference, gltf.cpp:238-246)")
    pos = g.accessor(attrs["POSITION"]).astype(np.float32)
    nrm, uv, tan = (g.accessor(attrs[k]).astype(np.float32) if k in attrs else None
                    for k in ("NORMAL", "TEXCOORD_0", "TANGENT"))
    if "indices" in prim:
        seq = g.accessor(prim["indices"]).reshape(-1).astype(np.int64)
        if seq.size and (seq.min() < 0 or seq.max() >= pos.shape[0]):
            raise GltfError(f"primitive index {int(seq.max())} out of range for {pos.shape[0]} vertices "
                            "(corrupt index buffer)")
    else:
        seq = np.arange(pos.shape[0], dtype=np.int64)
    if mode == 4:  # TRIANGLES
        if seq.shape[0] % 3:
            raise GltfError(f"TRIANGLES primitive has {seq.shape[0]} indices (not a multiple of 3)")
        idx = seq.reshape(-1, 3)
    elif mode == 5:  # TRIANGLE_STRIP: (i, i+1, i+2), odd triangles swap the first two
        idx = np.stack([seq[:-2], seq[1:-1], seq[2:]], axis=1)
        odd = np.arange(seq.shape[0] - 2) % 2 == 1
        idx[odd] = idx[odd][:, [1, 0, 2]]
    else:  # TRIANGLE_FAN: (0, i+1, i+2)
        idx = np.stack([np.full(seq.shape[0] - 2, seq[0], np.int64), seq[1:-1], seq[2:]], axis=1)
    mat = mat_ids[prim.get("material", 0)] if mat_ids else 0
    return pos, nrm, uv, tan, idx, mat


def load(path: str, builder: Optional[SceneBuilder] = None) -> SceneBuilder:
    """Load a .gltf / .glb file into a SceneBuilder (gltf.cpp:319-365)."""
    g = _load_doc(path)
    b = builder or SceneBuilder()

    tex_cache: Dict[tuple, int] = {}

    def cached_texture(kind_stack: str, tex_idx: int, decode_kind: str, channels):
        key = (kind_stack, tex_idx, tuple(channels or ()))
        if key not in tex_cache:
            tex_cache[key] = b.add_texture(kind_stack, _decode_texture(g, tex_idx, decode_kind, channels))
        return tex_cache[key]

    mat_ids = [b.add_material_desc(_material(g, b, gm, cached_texture)) for gm in g.doc.get("materials", [{}])]
    if not g.doc.get("materials"):
        mat_ids = [b.add_material()]

    # Meshes: their primitives (gltf.cpp:178-270).
    meshes = []
    for gmesh in g.doc.get("meshes", []):
        prims = (_primitive(g, prim, mat_ids) for prim in gmesh.get("primitives", []))
        meshes.append([p for p in prims if p is not None])

    # The node tree (gltf.cpp:272-317). A mesh referenced by more than one
    # node becomes a prototype with an instance per node (the reference
    # shares one Mesh across Nodes, scene.hpp:48-66); a mirrored node
    # transform (determinant <= 0) bakes its copy instead.
    nodes = g.doc.get("nodes", [])
    scene_desc = g.doc.get("scenes", [{}])[g.doc.get("scene", 0)]
    roots = scene_desc.get("nodes", range(len(nodes)))
    mesh_refs: Dict[int, int] = {}

    def count(node_idx: int):
        node = nodes[node_idx]
        if "mesh" in node:
            mesh_refs[node["mesh"]] = mesh_refs.get(node["mesh"], 0) + 1
        for child in node.get("children", []):
            count(child)

    for root in roots:
        count(root)
    proto_ids: Dict[int, list] = {}

    def visit(node_idx: int, parent: np.ndarray):
        node = nodes[node_idx]
        m = parent @ _node_matrix(node)
        if "mesh" in node:
            gm = node["mesh"]
            if mesh_refs.get(gm, 0) > 1 and np.linalg.det(m[:3, :3]) > 0:
                if gm not in proto_ids:
                    proto_ids[gm] = [b.add_prototype(pos, idx, mat, normals=nrm, uvs=uv, tangents=tan)
                                     for pos, nrm, uv, tan, idx, mat in meshes[gm]]
                for pid in proto_ids[gm]:
                    b.add_instance(pid, m)
            else:
                for pos, nrm, uv, tan, idx, mat in meshes[gm]:
                    b.add_mesh(pos, idx, mat, normals=nrm, uvs=uv, tangents=tan, transform=m)
        for child in node.get("children", []):
            visit(child, m)

    for root in roots:
        visit(root, np.eye(4))
    return b
