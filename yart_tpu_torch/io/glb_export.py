"""GLB 2.0 exporter for SceneBuilder scenes; port of
`yart_tpu/io/glb_export.py`, writing the same bytes for the same builder.

The procedural scenes exist only inside this framework; exported as
standard GLB they load in any glTF consumer and round-trip through
`scene/gltf.py`. Layout:
- one scene, one node per mesh unit, geometry in world space (the builder
  stores world-space data; instances are flattened);
- one primitive per (mesh unit, material) face group with POSITION /
  NORMAL / TEXCOORD_0 float32 accessors and uint32 indices;
- materials through pbrMetallicRoughness (+ KHR_materials_ior /
  _transmission / _emissive_strength / _clearcoat / _volume where not the
  default);
- textures embedded as PNG (`io/image.py` encode_png): base colour as
  sRGB8 + A (storage is gamma-2 -> linear -> sRGB, texture.hpp:80-86),
  metallic-roughness as G = roughness, B = metallic (the loader's
  channels [1, 2]), normal maps as their stored bytes;
- alphaMode MASK for alpha-tested materials (the reference ignores it and
  reads the alpha channel stochastically, ray-integrator.cpp:208-219).
"""

from __future__ import annotations

import json
import struct
from typing import List, Optional

import numpy as np

from yart_tpu_torch.io.image import encode_png, save_hdr
from yart_tpu_torch.ops.color import srgb_encode_np


def _png_from_storage(stor: np.ndarray, kind: str) -> bytes:
    """Storage-encoded float texture -> PNG bytes. kind 'srgb': the rgb
    channels are gamma-2 encoded (linear = v ** 2), alpha linear;
    'noncolor': the values as stored."""
    arr = np.asarray(stor, np.float32)
    if kind == "srgb":
        out = arr.copy()
        out[..., :3] = srgb_encode_np(arr[..., :3] ** 2)
    else:
        out = arr
    return encode_png(out, keep_alpha=True)


def _mr_png(stor_2ch: np.ndarray) -> bytes:
    """[H, W, 2] storage (roughness, metallic) -> an RGB PNG with them in G, B."""
    h, w, _ = stor_2ch.shape
    rgb = np.zeros((h, w, 3), np.float32)
    rgb[..., 1] = stor_2ch[..., 0]
    rgb[..., 2] = stor_2ch[..., 1]
    return encode_png(rgb)


def _material_json(builder, m, add_texture_png, used_exts: set) -> dict:
    pbr = {
        "baseColorFactor": [float(c) for c in m.base_color],
        "metallicFactor": float(m.metallic),
        "roughnessFactor": float(m.roughness),
    }
    if m.tex_base >= 0:
        png = _png_from_storage(builder.textures_rgba[m.tex_base], "srgb")
        pbr["baseColorTexture"] = {"index": add_texture_png(png, ("rgba", m.tex_base))}
    if m.tex_mr >= 0:
        png = _mr_png(builder.textures_2ch[m.tex_mr])
        pbr["metallicRoughnessTexture"] = {"index": add_texture_png(png, ("2ch", m.tex_mr))}
    mat = {"pbrMetallicRoughness": pbr, "doubleSided": True}
    if m.tex_normal >= 0:
        png = _png_from_storage(builder.textures_rgb[m.tex_normal], "noncolor")
        mat["normalTexture"] = {"index": add_texture_png(png, ("rgb", m.tex_normal)),
                                "scale": float(m.normal_scale)}
    if m.has_alpha:
        mat["alphaMode"] = "MASK"
        mat["alphaCutoff"] = 0.5
    em = np.asarray(m.emission, np.float32)
    exts = {}
    if np.any(em > 0):
        mat["emissiveFactor"] = [float(min(c, 1.0)) for c in em]
        if m.emission_strength != 1.0 or em.max() > 1.0:
            s = float(m.emission_strength) * float(max(em.max(), 1.0))
            mat["emissiveFactor"] = [float(c / max(em.max(), 1.0)) for c in em]
            exts["KHR_materials_emissive_strength"] = {"emissiveStrength": s}
    if m.ior != 1.5:
        exts["KHR_materials_ior"] = {"ior": float(m.ior)}
    if m.transmission > 0:
        exts["KHR_materials_transmission"] = {"transmissionFactor": float(m.transmission)}
    if m.clearcoat > 0:
        exts["KHR_materials_clearcoat"] = {"clearcoatFactor": float(m.clearcoat),
                                           "clearcoatRoughnessFactor": float(m.cc_roughness)}
    if m.volume_density > 0:
        exts["KHR_materials_volume"] = {"attenuationColor": [float(c) for c in m.volume_color],
                                        "attenuationDistance": float(1.0 / m.volume_density)}
    if exts:
        mat["extensions"] = exts
        used_exts.update(exts)
    return mat


def _mesh_units(builder) -> list:
    """(positions, normals, uvs, [T, 3] local indices, per-face materials)
    of every mesh, then of every instance transformed to world space."""
    units = []
    starts = np.cumsum([0] + [p.shape[0] for p in builder._positions])
    for i in range(len(builder._positions)):
        units.append((builder._positions[i], builder._normals[i], builder._uvs[i],
                      builder._tris[i] - starts[i], builder._tri_mat[i]))
    for proto, tf in builder._instances:
        p = builder._protos[proto]
        pos, nrm, uv = p["positions"], p["normals"], p["uvs"]
        if tf is not None:
            mtx = np.asarray(tf, np.float64).reshape(4, 4)
            pos = pos @ mtx[:3, :3].T + mtx[:3, 3]
            nm = np.linalg.inv(mtx[:3, :3]).T
            nrm = nrm @ nm.T
            nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
        units.append((pos.astype(np.float32), nrm.astype(np.float32), uv.astype(np.float32),
                      np.asarray(p["tris"], np.int64), np.asarray(p["tri_mat"], np.int32)))
    return units


def export_glb(builder, path: str) -> dict:
    """Write `builder`'s scene as a .glb; returns summary counts."""
    bin_parts: List[bytes] = []
    buffer_views = []
    accessors = []
    images = []
    textures = []
    meshes = []
    nodes = []

    def add_view(data: bytes, target: Optional[int] = None) -> int:
        off = sum(len(p) for p in bin_parts)
        pad = (-off) % 4  # 4-byte alignment
        if pad:
            bin_parts.append(b"\x00" * pad)
            off += pad
        bin_parts.append(data)
        v = {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
        if target is not None:
            v["target"] = target
        buffer_views.append(v)
        return len(buffer_views) - 1

    def add_accessor(arr: np.ndarray, ctype: int, atype: str, target: int, minmax: bool = False) -> int:
        acc = {"bufferView": add_view(np.ascontiguousarray(arr).tobytes(), target), "componentType": ctype,
               "count": arr.shape[0], "type": atype}
        if minmax:
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    tex_cache: dict = {}

    def add_texture_png(png: bytes, key) -> int:
        if key not in tex_cache:
            images.append({"bufferView": add_view(png), "mimeType": "image/png"})
            textures.append({"source": len(images) - 1, "sampler": 0})
            tex_cache[key] = len(textures) - 1
        return tex_cache[key]

    used_exts: set = set()
    materials = [_material_json(builder, m, add_texture_png, used_exts) for m in builder._materials]

    n_tris = 0
    for pos, nrm, uv, idx, tmat in _mesh_units(builder):
        prims = []
        a_pos = add_accessor(pos.astype(np.float32), 5126, "VEC3", 34962, minmax=True)
        a_nrm = add_accessor(nrm.astype(np.float32), 5126, "VEC3", 34962)
        a_uv = add_accessor(uv.astype(np.float32), 5126, "VEC2", 34962)
        for mat_id in np.unique(np.asarray(tmat)):
            faces = np.asarray(idx)[np.asarray(tmat) == mat_id]
            flat = faces.reshape(-1).astype(np.uint32)
            a_idx = add_accessor(flat[:, None], 5125, "SCALAR", 34963)
            accessors[a_idx]["count"] = flat.shape[0]
            prims.append({"attributes": {"POSITION": a_pos, "NORMAL": a_nrm, "TEXCOORD_0": a_uv},
                          "indices": a_idx, "material": int(mat_id), "mode": 4})
            n_tris += faces.shape[0]
        meshes.append({"primitives": prims})
        nodes.append({"mesh": len(meshes) - 1})

    doc = {
        "asset": {"version": "2.0", "generator": "yart_tpu glb_export"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "materials": materials,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "samplers": [{"wrapS": 10497, "wrapT": 10497}],
    }
    if images:
        doc["images"] = images
        doc["textures"] = textures
    else:
        del doc["samplers"]
    if used_exts:
        doc["extensionsUsed"] = sorted(used_exts)

    bin_blob = b"".join(bin_parts)
    bin_blob += b"\x00" * ((-len(bin_blob)) % 4)
    doc["buffers"] = [{"byteLength": len(bin_blob)}]
    js = json.dumps(doc, separators=(",", ":")).encode()
    js += b" " * ((-len(js)) % 4)

    total = 12 + 8 + len(js) + 8 + len(bin_blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<I", len(js)) + b"JSON" + js)
        f.write(struct.pack("<I", len(bin_blob)) + b"BIN\x00" + bin_blob)
    return {"meshes": len(meshes), "tris": n_tris, "materials": len(materials), "textures": len(textures),
            "bytes": total}


def export_env_hdr(builder, path: str, apply_scale: bool = False) -> bool:
    """Write the builder's octahedral environment image as Radiance HDR
    (the reference's loadTextureHDR reads it, texture.cpp:5-19). Returns
    False if the scene has no image environment."""
    img = builder._env_image
    if img is None or img.size <= 3:
        return False
    out = img * builder._env_scale if apply_scale else img
    save_hdr(path, np.asarray(out, np.float32))
    return True
