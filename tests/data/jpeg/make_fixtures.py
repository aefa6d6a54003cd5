"""Write the JPEG fixtures of this directory with PIL, and their manifest.

The port decodes JPEG without PIL (`yart_tpu_torch/io/jpeg.py`), and the
smoke test on the machine with the GPU uses no PIL either, so the files
the decoder is held to there are made here once with PIL and committed:

- `grid_*.jpg`: small files over the variants the decoder reads: 4:4:4,
  4:2:2 and 4:2:0; baseline, progressive and optimized Huffman tables;
  restart markers; grey, YCbCr, Adobe RGB and CMYK; quality 1, 50, 95 and
  100; sizes 1x1, 3x2, 5x9 and 37x53;
- `atrium_*.jpg`: eight opaque textures of `showcase.atrium(ivy=True)`,
  each encoded from the 8-bit image `io/glb_export.py` writes as its PNG
  (base colours as sRGB, the metallic-roughness map with roughness in G
  and metallic in B, normal maps as stored), so a GLB of the atrium whose
  PNGs are swapped for these differs from the exported one only by
  JPEG's loss;
- `manifest.json`: for each file its shape, the SHA-256 of PIL's
  `convert("RGBA")` bytes, and for an atrium texture the SHA-256 of the
  RGBA pixels of the PNG it replaces (pixels, not bytes: another zlib
  may compress them otherwise); with the Pillow and libjpeg-turbo
  versions.

Run from the root of the repository: `python tests/data/jpeg/make_fixtures.py`.
"""

import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image, features

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.abspath(os.path.join(HERE, "..", "..", "..")))

from yart_tpu_torch.io import glb_export  # noqa: E402
from yart_tpu_torch.io.png import decode_png  # noqa: E402
from yart_tpu_torch.scene import showcase  # noqa: E402

SUBSAMPLING = {"444": 0, "422": 1, "420": 2}
TAGS = {"progressive": "prog", "optimize": "opt", "restart_marker_blocks": "rstblocks",
        "restart_marker_rows": "rstrows", "keep_rgb": "adobergb"}  # file-name tag of each option
# (size, mode, subsampling, quality, options) of each grid file.
GRID = [
    ((1, 1), "RGB", "420", 95, {}),
    ((1, 1), "L", "444", 50, {"progressive": True}),
    ((3, 2), "RGB", "422", 50, {}),
    ((3, 2), "RGB", "420", 100, {"progressive": True}),
    ((3, 2), "CMYK", "444", 95, {}),
    ((5, 9), "RGB", "444", 1, {}),
    ((5, 9), "RGB", "420", 50, {"optimize": True}),
    ((5, 9), "L", "444", 95, {"restart_marker_blocks": 1}),
    ((5, 9), "RGB", "422", 95, {"progressive": True, "optimize": True}),
    ((37, 53), "RGB", "420", 50, {}),
    ((37, 53), "RGB", "422", 95, {"restart_marker_blocks": 3}),
    ((37, 53), "RGB", "444", 100, {"optimize": True}),
    ((37, 53), "RGB", "420", 1, {"progressive": True}),
    ((37, 53), "RGB", "420", 95, {"progressive": True, "restart_marker_rows": 1}),
    ((37, 53), "L", "444", 50, {"progressive": True}),
    ((37, 53), "CMYK", "444", 50, {"progressive": True}),
    ((37, 53), "CMYK", "420", 95, {}),
    ((37, 53), "RGB", "444", 95, {"keep_rgb": True}),
    ((37, 53), "RGB", "422", 1, {"optimize": True, "restart_marker_blocks": 2}),
]
# Atrium textures: (name, builder table, index, kind, subsampling, quality, options).
ATRIUM = [
    ("brick_base", "textures_rgba", 0, "srgb", "420", 90, {}),
    ("brick_normal", "textures_rgb", 0, "noncolor", "444", 95, {}),
    ("tile_base", "textures_rgba", 1, "srgb", "420", 90, {"progressive": True}),
    ("tile_mr", "textures_2ch", 0, "mr", "444", 95, {"progressive": True}),
    ("tile_normal", "textures_rgb", 1, "noncolor", "444", 95, {"optimize": True}),
    ("marble", "textures_rgba", 2, "srgb", "422", 90, {"progressive": True}),
    ("cloth_red", "textures_rgba", 3, "srgb", "420", 90, {"optimize": True}),
    ("cloth_green", "textures_rgba", 4, "srgb", "420", 90, {"progressive": True}),
]


def grid_image(w: int, h: int, mode: str, seed: int) -> Image.Image:
    """Gradients, edges and noise, so every band of coefficients is used."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + yy) * 6 % 256,
                       ((xx // 4 + yy // 4) % 2) * 200], -1)
    a = np.where(rng.random((h, w, 1)) < 0.25, rng.integers(0, 256, (h, w, 4)), smooth).astype(np.uint8)
    if mode == "L":
        return Image.fromarray(a[..., 0], "L")
    return Image.fromarray(a if mode == "CMYK" else a[..., :3], mode)


def texture_png(builder, table: str, index: int, kind: str) -> bytes:
    """The PNG `export_glb` writes for this texture."""
    stor = getattr(builder, table)[index]
    return glb_export._mr_png(stor) if kind == "mr" else glb_export._png_from_storage(stor, kind)


def rgba_sha256(data: bytes) -> tuple:
    rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    return hashlib.sha256(np.ascontiguousarray(rgba).tobytes()).hexdigest(), list(rgba.shape)


def main() -> None:
    files = {}

    def write(name, img, sub, quality, opts, **extra):
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=quality, subsampling=SUBSAMPLING[sub], **opts)
        data = buf.getvalue()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        sha, shape = rgba_sha256(data)
        files[name] = dict(shape=shape, rgba_sha256=sha, bytes=len(data), **extra)

    for i, ((w, h), mode, sub, q, opts) in enumerate(GRID):
        tags = "".join(f"_{TAGS[k]}{'' if v is True else v}" for k, v in opts.items())
        write(f"grid_{w}x{h}_{mode.lower()}_{sub}_q{q}{tags}.jpg", grid_image(w, h, mode, i), sub, q, opts)
    builder = showcase.atrium(ivy=True)
    for name, table, index, kind, sub, q, opts in ATRIUM:
        png = texture_png(builder, table, index, kind)
        rgba = decode_png(png)
        write(f"atrium_{name}.jpg", Image.fromarray(rgba[..., :3], "RGB"), sub, q, opts,
              replaces_png_rgba_sha256=hashlib.sha256(rgba.tobytes()).hexdigest(), texture=f"{table}[{index}]")
    manifest = {"pillow": Image.__version__, "libjpeg_turbo": features.version("libjpeg_turbo"), "files": files}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
