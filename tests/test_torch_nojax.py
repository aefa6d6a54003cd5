"""yart_tpu_torch imports no JAX: the machine with the GPU has none.

A fresh interpreter in which jax and the JAX package cannot be imported
imports every module of the port, builds and renders tiny cornell-mat
(also with shade_kernel="pallas": B6's and B5's twins), spheres,
textured-box and instanced scenes through the renderer and the CLI
(spheres through the block trace, the textured box through the gated
brute, the instanced scene through B3's instanced mode), traces a few rays
through bin-trace and the round-based block trace (plain and gated), parses the flagship scenes, writes
the textured box as a GLB and an HDR environment with the port's writers and renders both through the
CLI (its PNG textures decoded without PIL), and again with its opaque textures swapped for a committed
JPEG fixture (decoded by `io/jpeg.py` and its C++ scan decoder, without PIL), renders over two CPU ranks
through the CLI (`--devices 2 --device cpu`, `parallel/`), imports the live view (`io/preview.py`), and then checks that no module of
`jax`, of the JAX package `yart_tpu` or of PIL was ever loaded."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys


class _NoJax:
    # jax, jaxlib, the JAX package and PIL cannot be imported in this process.
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "yart_tpu", "PIL"):
            raise ImportError(f"{name} cannot be imported here")
        return None


sys.meta_path.insert(0, _NoJax())
import yart_tpu_torch
for m in pkgutil.walk_packages(yart_tpu_torch.__path__, "yart_tpu_torch."):
    importlib.import_module(m.name)
import torch
torch.set_num_threads(1)
from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.cli import parse_args
from yart_tpu_torch.render.renderer import Renderer
from yart_tpu_torch.scene.procedural import cornell_box
parse_args(["cornell-mat", "--device", "cpu"])
scene, meta = cornell_box(extra_materials=True).compile(device="cpu")
res = Renderer(scene, meta, CameraConfig(image_size=(4, 4)), RenderConfig(samples=2, max_depth=2), device="cpu").render()
assert res.samples_taken == 2
# The fused shade tail: B6's and B5's twins on the CPU.
from yart_tpu_torch.kernels import shade
res = Renderer(scene, meta, CameraConfig(image_size=(4, 4)),
               RenderConfig(samples=2, max_depth=3, shade_kernel="pallas"), device="cpu").render()
assert res.samples_taken == 2 and res.hdr.mean() > 0 and shade.COUNTS_SHADE.launches == 0
# spheres (14,402 triangles, env-lit) through the block trace's twins.
from yart_tpu_torch.scene.procedural import material_test_spheres
scene, meta = material_test_spheres().compile(device="cpu")
assert meta.n_tris > 4096 and meta.has_env
res = Renderer(scene, meta, CameraConfig(image_size=(4, 4), position=(0, 2.2, 5.5), forward=(0, -1.8, -6.1)),
               RenderConfig(samples=2, max_depth=3), device="cpu").render()
assert res.samples_taken == 2 and res.hdr.mean() > 0
# Bin-trace (its collect loop, pair layout and B4's twin) on the same scene.
from yart_tpu_torch.render.bintrace import intersect_bintrace
o = torch.tensor([[0.0, 2.2, 5.5]]).repeat(64, 1)
d = torch.nn.functional.normalize(torch.tensor([[0.0, -1.8, -6.1]]) + 0.01 * torch.randn(64, 3), dim=1)
assert intersect_bintrace(scene, meta, o, d, 100.0).mask.any()
# The round-based block trace (B7a's and B7b's twins), plain and gated.
from yart_tpu_torch.render.blocktrace import intersect_blocktrace, intersect_blocktrace_gated
assert (intersect_blocktrace(scene, meta, o, d, 100.0, fused=False)[4] >= 0).any()
assert intersect_blocktrace_gated(scene, meta, o, d, 100.0, fused=False).mask.any()
# The textured box (every texture class, alpha cutout, thin glass) through
# the gated brute; the flagship scenes parse.
from yart_tpu_torch.scene.procedural import textured_box_scene
scene, meta = textured_box_scene().compile(device="cpu")
assert meta.any_alpha and meta.any_textures and meta.any_transparent
res = Renderer(scene, meta, CameraConfig(image_size=(4, 4), position=(0, 1.6, 3.2), forward=(0, -0.9, -3.0)),
               RenderConfig(samples=2, max_depth=3), device="cpu").render()
assert res.samples_taken == 2 and res.hdr.mean() > 0
for name in ("atrium", "atrium-ivy", "atrium-inst", "roadster", "luxball"):
    parse_args([name, "--device", "cpu"])
# An instanced scene (two rotated, scaled instances of one prototype over a
# baked floor) through B3's instanced mode (its twin here).
import numpy as np
from yart_tpu_torch.scene.builder import SceneBuilder
from yart_tpu_torch.scene.procedural import uv_sphere
b = SceneBuilder()
m = b.add_material(roughness=0.5)
pos, nrm, tri = uv_sphere((0, 0, 0), 0.5, n_theta=6, n_phi=8)
pid = b.add_prototype(pos, tri, m, normals=nrm)
b.add_instance(pid, np.diag([1.0, 2.0, 1.0, 1.0]))
rot = np.eye(4)
rot[:3, :3] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]
rot[:3, 3] = (1.2, 0.0, 0.0)
b.add_instance(pid, rot)
b.add_mesh(np.asarray([[-3, -1, -3], [3, -1, -3], [3, -1, 3], [-3, -1, 3]], np.float32), [[0, 2, 1], [0, 3, 2]], m)
b.set_env_uniform((0.5, 0.5, 0.5))
scene, meta = b.compile(device="cpu")
assert meta.n_instances == 3 and meta.n_inst_clusters == 3
res = Renderer(scene, meta, CameraConfig(image_size=(4, 4), position=(0, 0.5, 4.0), forward=(0, -0.1, -1)),
               RenderConfig(samples=2, max_depth=3), device="cpu").render()
assert res.samples_taken == 2 and res.hdr.mean() > 0
import tempfile, os
from yart_tpu_torch.cli import main
with tempfile.TemporaryDirectory() as tmp:
    assert main(["spheres", "--device", "cpu", "--size", "4x4", "--spp", "1", "--max-depth", "2",
                 "--quiet", "-o", os.path.join(tmp, "s.png")]) == 0
    assert main(["cornell-mat", "--device", "cpu", "--size", "4x4", "--spp", "1", "--max-depth", "3",
                 "--shade-kernel", "pallas", "--quiet", "-o", os.path.join(tmp, "c.png")]) == 0
# Scene files: the textured box (every texture class, an alpha cutout) as a
# GLB and an HDR sky, both written by the port, loaded and rendered through
# the CLI; its PNG textures decode without PIL.
from yart_tpu_torch.io.glb_export import export_glb
from yart_tpu_torch.io.image import load_hdr, save_hdr
from yart_tpu_torch.scene.gltf import load
with tempfile.TemporaryDirectory() as tmp:
    glb, sky = os.path.join(tmp, "box.glb"), os.path.join(tmp, "sky.hdr")
    stats = export_glb(textured_box_scene(), glb)
    save_hdr(sky, np.linspace(0.1, 2.0, 8 * 16 * 3, dtype=np.float32).reshape(8, 16, 3))
    b = load(glb)
    assert stats["textures"] >= 3 and b.textures_rgba and b.textures_rgb and b.textures_2ch
    assert load_hdr(sky).shape == (8, 16, 3)
    # The same GLB with its opaque textures as JPEG fixtures (io/jpeg.py and
    # its C++ scan decoder, no PIL).
    import chip_smoke
    from yart_tpu_torch.io.png import decode_png
    doc, blob = chip_smoke.read_glb(glb)
    opaque = [i for i in range(len(doc["images"]))
              if (decode_png(chip_smoke.glb_image_bytes(doc, blob, i))[..., 3] == 255).all()]
    fixture = open(os.path.join(chip_smoke.JPEG_FIXTURES, "grid_37x53_rgb_420_q50.jpg"), "rb").read()
    glb_j = os.path.join(tmp, "box_jpeg.glb")
    chip_smoke.glb_swap_images(glb, glb_j, {i: fixture for i in opaque})
    bj = load(glb_j)
    assert opaque and sum(t.shape[:2] == (53, 37) for t in bj.textures_rgba + bj.textures_rgb + bj.textures_2ch)
    for scene in (glb, glb_j, "cornell"):
        assert main([scene, "--env-hdr", sky, "--env-scale", "0.5", "--device", "cpu", "--size", "4x4",
                     "--spp", "1", "--max-depth", "2", "--camera-pos", "0,1.6,3.2", "--quiet",
                     "-o", os.path.join(tmp, "g.png")]) == 0
# Two CPU ranks on gloo through the CLI (parallel/ imports no JAX either),
# and the live view's module.
from yart_tpu_torch.io.preview import PreviewServer
from yart_tpu_torch.parallel import distributed, sharding
with tempfile.TemporaryDirectory() as tmp:
    assert main(["cornell-mat", "--device", "cpu", "--devices", "2", "--size", "8x16", "--spp", "1",
                 "--max-depth", "2", "--quiet", "-o", os.path.join(tmp, "r.png")]) == 0
    assert os.path.exists(os.path.join(tmp, "r.png")) and not distributed.is_initialized()
bad = sorted(m for m in sys.modules if m in ("jax", "yart_tpu", "PIL")
             or m.startswith(("jax.", "jaxlib", "yart_tpu.", "PIL.")))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
