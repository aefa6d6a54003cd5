"""Host build seconds of the large scenes, the scene builder's C++ BVH
build and collapse (`yart_tpu_torch/native.py`) against their numpy twins
(`scene/bvh.py`), in one process.

Usage: python -m yart_tpu_torch.tools.build_times [--device cuda|cpu] [SCENE ...]

SCENE is one of atrium-ivy (127,972 triangles), atrium-ivy-glb (the same
scene written by `export_glb` and loaded back, as the CLI loads a user's
file), atrium-dense (`atrium(density=3)`, bin-trace), atrium-ivy-dense
(`atrium(ivy=True, density=3)`, the stack traversals) and
atrium-inst-dense (`atrium(density=3, instanced=True)`, the per-instance
loop); all of them by default. Each scene is authored, then compiled with
the host library, and authored and compiled again with the numpy twins; one
JSON line a scene gives each compile's seconds and the builder's
`timings` (bvh_s: the SAH build, collapse_s: the BVH8 collapse, tables_s:
all of the scene's host tables, those two included; summed over the
prototypes of an instanced scene).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import torch

from yart_tpu_torch import native
from yart_tpu_torch.device import resolve
from yart_tpu_torch.scene import bvh

SCENES = ("atrium-ivy", "atrium-ivy-glb", "atrium-dense", "atrium-ivy-dense", "atrium-inst-dense")


def author(name: str, tmp: str):
    """A fresh SceneBuilder of scene `name` (GLBs are written under `tmp`)."""
    from yart_tpu_torch.scene.showcase import atrium

    if name == "atrium-ivy":
        return atrium(ivy=True)
    if name == "atrium-ivy-glb":
        from yart_tpu_torch.io.glb_export import export_glb
        from yart_tpu_torch.scene.gltf import load

        path = os.path.join(tmp, "atrium-ivy.glb")
        if not os.path.exists(path):
            export_glb(atrium(ivy=True), path)
        return load(path)
    if name == "atrium-dense":
        return atrium(density=3)
    if name == "atrium-ivy-dense":
        return atrium(ivy=True, density=3)
    if name == "atrium-inst-dense":
        return atrium(density=3, instanced=True)
    raise SystemExit(f"unknown scene {name!r}; one of {', '.join(SCENES)}")


@contextlib.contextmanager
def numpy_twins():
    """The builder's BVH build and collapse from the numpy twins."""
    saved = native.build_bvh, native.collapse_bvh8
    native.build_bvh, native.collapse_bvh8 = bvh.build_bvh, bvh.collapse_bvh8
    try:
        yield
    finally:
        native.build_bvh, native.collapse_bvh8 = saved


def compile_timed(builder, device) -> dict:
    t0 = time.perf_counter()
    scene, meta = builder.compile(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out = {"compile_s": time.perf_counter() - t0, **builder.timings, "n_tris": int(meta.n_tris),
           "nodes": int(scene.node_pack.shape[0]), "bvh8_groups": int(scene.wide_pack.shape[0])}
    if meta.n_instances:
        out.update(nodes=sum(int(p.node_pack.shape[0]) for p in scene.protos),
                   bvh8_groups=sum(int(p.wide_pack.shape[0]) for p in scene.protos))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scenes", nargs="*", default=list(SCENES), help="scenes to build (default: all)")
    ap.add_argument("--device", default="cuda", help="where the compiled tables go (default: the card)")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    native.library()  # the host library's build is no part of a scene's seconds
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.scenes:
            t0 = time.perf_counter()
            b = author(name, tmp)
            rec = {"scene": name, "device": str(device), "author_s": time.perf_counter() - t0,
                   "native": compile_timed(b, device)}
            b = author(name, tmp)
            with numpy_twins():
                rec["numpy_twin"] = compile_timed(b, device)
            del b
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
