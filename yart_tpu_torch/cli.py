"""Command-line renderer for the port.

Usage:
    python -m yart_tpu_torch.cli scene.glb --env-hdr sky.hdr -o out.png --spp 64 --device cuda
    python -m yart_tpu_torch.cli cornell-mat -o out.png --spp 64 --size 512x512 --device cuda

Mirrors `yart_tpu/cli.py` for what the port supports: glTF / GLB scene
files (`scene/gltf.py`, PNG textures only) and Radiance HDR environments
(`--env-hdr`, `--env-scale`) on any scene, the procedural scenes
`cornell` and `cornell-mat` (area lights, kernel B1), `furnace` (env
light, B1), `spheres` (env light, 14,402 triangles through the block trace
B2 + B3), the textured flagship scenes `atrium`, `roadster` and `luxball`
(sky HDRI, block trace), `atrium-ivy` (alpha-tested ivy: the gated re-cast
loop with B3's alpha-mask cull) and `atrium-inst` (the columns and
planters as instances: B3's instanced mode), the MIS and naive
integrators, the fused shade tail (`--shade-kernel xla|pallas`: B6 + B5),
the zsobol and hash samplers, every estimator, AgX with its looks, the
thin-lens camera and checkpoint/resume. Every other flag of the JAX CLI is
refused with an error naming the ROADMAP.md item that will bring it; none
is ignored.
"""

from __future__ import annotations

import argparse
import os
import sys

SCENES = ("cornell", "cornell-mat", "spheres", "furnace", "atrium", "atrium-ivy", "atrium-inst",
          "roadster", "luxball")

# JAX-CLI flags this slice lacks: dest -> (value meaning "unused", ROADMAP item)
_REFUSED = {
    "config": (None, "A.10 application layer (JSON flag files)"),
    "preview": (None, "A.10 application layer (preview PNG)"),
    "serve": (None, "A.10 application layer (preview server)"),
    "serve_host": ("127.0.0.1", "A.10 application layer (preview server)"),
    "profile": (None, "A.7 renderer and bench (device traces)"),
    "debug_nan": (False, "A.10 application layer"),
    "devices": (None, "A.10 application layer (torch.distributed sharding)"),
    "distributed": (False, "A.10 application layer (torch.distributed sharding)"),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="yart-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("scene", help=".gltf/.glb path or procedural scene: " + " | ".join(SCENES))
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("-o", "--output", default="out.png", help="output image (.png/.ppm)")
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--size", default="512x512", help="WxH")
    p.add_argument("--max-depth", type=int, default=30)
    p.add_argument("--integrator", choices=["mis", "naive"], default="mis")
    p.add_argument("--sampler", default="zsobol", help="zsobol | zsobol:fastowen | hash")
    p.add_argument("--estimator", choices=["gmon", "gmonb", "mon", "mean"], default="gmon")
    p.add_argument("--tonemap", choices=["agx", "none"], default="agx")
    p.add_argument("--look", choices=["none", "golden", "punchy"], default="none")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--exposure", type=float, default=None,
                   help="EV stops (default: the scene's, +3 atrium, +1 roadster and luxball)")
    p.add_argument("--focal", type=float, default=35.0, help="focal length mm")
    p.add_argument("--fnumber", type=float, default=0.0, help="aperture f-number, 0 = no DoF")
    p.add_argument("--aperture-sides", type=int, default=0)
    p.add_argument("--camera-pos", default=None, help="x,y,z")
    p.add_argument("--camera-target", default=None, help="x,y,z")
    p.add_argument("--background", default="0,0,0")
    p.add_argument("--first-wave", type=int, default=8)
    p.add_argument("--max-wave", type=int, default=128)
    p.add_argument("--regularize-specular", type=int, default=None, metavar="K")
    p.add_argument("--shade-kernel", choices=["off", "xla", "pallas"], default="off",
                   help="bounce tail: off = classic; xla = the fused shade math in plain PyTorch; "
                        "pallas = B6 + B5 as CUDA kernels")
    p.add_argument("--clamp", type=float, default=None)
    p.add_argument("--chunk-pixels", type=int, default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--env-hdr", default=None, help="octahedral Radiance HDR environment map path")
    p.add_argument("--env-scale", type=float, default=1.0)
    p.add_argument("--quiet", action="store_true")
    # Accepted only to refuse them by name (see _REFUSED).
    p.add_argument("--config", default=None, help=argparse.SUPPRESS)
    p.add_argument("--preview", default=None, help=argparse.SUPPRESS)
    p.add_argument("--serve", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--serve-host", default="127.0.0.1", help=argparse.SUPPRESS)
    p.add_argument("--profile", default=None, help=argparse.SUPPRESS)
    p.add_argument("--debug-nan", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--devices", default=None, help=argparse.SUPPRESS)
    p.add_argument("--distributed", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.scene not in SCENES and not os.path.isfile(args.scene):
        p.error(f"scene {args.scene!r}: no such file (a .gltf/.glb path) and no procedural scene "
                f"({' | '.join(SCENES)})")
    if args.env_hdr is not None and not os.path.isfile(args.env_hdr):
        p.error(f"--env-hdr {args.env_hdr!r}: no such file")
    for dest, (unused, item) in _REFUSED.items():
        if getattr(args, dest) != unused:
            p.error(f"--{dest.replace('_', '-')} is not ported yet (ROADMAP.md {item})")
    if args.shade_kernel == "pallas" and args.regularize_specular is not None:
        from yart_tpu_torch.render.integrator import PALLAS_REG_SPECULAR

        p.error(f"--shade-kernel pallas --regularize-specular: {PALLAS_REG_SPECULAR}")
    if args.sampler not in ("zsobol", "zsobol:fastowen", "hash"):
        p.error(
            f"--sampler {args.sampler!r} is not ported yet (ROADMAP.md A.2: "
            "stratified and the null/binary/owen scramblers); use zsobol or hash"
        )
    return args


def build_scene(args, device, density: int = 1):
    """The scene of the parsed arguments: a procedural scene or a glTF
    file, with the `--env-hdr` environment if given; `density` multiplies
    the atrium scenes' tessellation (showcase.atrium: 3 gives the
    1,094,508-triangle atrium that bin-trace serves)."""
    from yart_tpu_torch.scene import procedural, showcase

    if args.scene not in SCENES:
        from yart_tpu_torch.scene.gltf import load

        b = load(args.scene)
    elif args.scene == "spheres":
        b = procedural.material_test_spheres()
    elif args.scene == "furnace":
        b = procedural.furnace()
    elif args.scene in ("atrium", "atrium-ivy", "atrium-inst"):
        b = showcase.atrium(ivy=args.scene == "atrium-ivy", density=density,
                            instanced=args.scene == "atrium-inst")
    elif args.scene == "roadster":
        b = showcase.roadster()
    elif args.scene == "luxball":
        b = showcase.luxball()
    else:
        b = procedural.cornell_box(extra_materials=args.scene == "cornell-mat")
    if args.env_hdr:
        from yart_tpu_torch.io.image import load_hdr

        b.set_env(load_hdr(args.env_hdr), args.env_scale)
    b.set_background([float(x) for x in args.background.split(",")])
    return b.compile(device)


# The JAX CLI's cameras and exposures (yart_tpu/cli.py:162-187):
# (position, target), and EV stops for interior scenes under the sky; a
# scene file takes DEFAULT_CAMERA and 0 EV.
CAMERAS = {
    "cornell": ((0, 1.0, 3.4), (0, 1.0, 0)),
    "cornell-mat": ((0, 1.0, 3.4), (0, 1.0, 0)),
    "spheres": ((0, 2.2, 5.5), (0, 0.4, -0.6)),
    "furnace": ((0, 0, 3.5), (0, 0, 0)),
    "atrium": ((-10.0, 1.8, 0.0), (8.0, 2.6, 0.0)),
    "atrium-ivy": ((-10.0, 1.8, 0.0), (8.0, 2.6, 0.0)),
    "atrium-inst": ((-10.0, 1.8, 0.0), (8.0, 2.6, 0.0)),
    "roadster": ((4.4, 1.7, 5.0), (0.0, 0.5, 0.0)),
    "luxball": ((0.12, 0.28, 0.35), (0.0, 0.06, 0.0)),
}
DEFAULT_CAMERA = ((0, 1, 4), (0, 1, 0))
EXPOSURE = {"atrium": 3.0, "atrium-ivy": 3.0, "atrium-inst": 3.0, "roadster": 1.0, "luxball": 1.0}


def default_camera(args):
    pos, target = CAMERAS.get(args.scene, DEFAULT_CAMERA)
    if args.camera_pos:
        pos = tuple(float(x) for x in args.camera_pos.split(","))
    if args.camera_target:
        target = tuple(float(x) for x in args.camera_target.split(","))
    return pos, tuple(t - q for q, t in zip(pos, target))


def render_configs(args):
    """(CameraConfig, RenderConfig) of the parsed arguments."""
    from yart_tpu_torch.config import CameraConfig, RenderConfig

    w, h = (int(x) for x in args.size.lower().split("x"))
    pos, fwd = default_camera(args)
    cam = CameraConfig(
        image_size=(w, h), focal_length=args.focal, f_number=args.fnumber,
        position=pos, forward=fwd,
        exposure=EXPOSURE.get(args.scene, 0.0) if args.exposure is None else args.exposure,
        aperture_sides=args.aperture_sides,
    )
    cfg = RenderConfig(
        samples=args.spp, max_depth=args.max_depth, integrator=args.integrator,
        sampler=args.sampler, estimator=args.estimator, tonemap=args.tonemap,
        agx_look=args.look, seed=args.seed, first_wave_samples=args.first_wave,
        max_wave_samples=args.max_wave, lane_chunk=args.chunk_pixels,
        clamp=args.clamp, regularize_specular=args.regularize_specular,
        shade_kernel=args.shade_kernel,
    )
    return cam, cfg


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from yart_tpu_torch.io.image import write_png, write_ppm
    from yart_tpu_torch.render.renderer import Renderer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device is available "
            "(torch.cuda.is_available() is False); pass --device cpu to render on the CPU"
        )
    scene, meta = build_scene(args, device)
    cam, cfg = render_configs(args)
    w, h = cam.image_size
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if not args.quiet:
        print(
            f"scene: {args.scene} ({meta.n_tris} tris, {meta.n_lights} lights, env={meta.has_env}); "
            f"{w}x{h} @ {args.spp}spp on {device} ({dev_name})"
        )

    def on_wave(wd, preview):
        if not args.quiet:
            mrays = wd.rays / max(wd.time, 1e-9) / 1e6
            print(f"wave {wd.wave}: {wd.samples_taken}/{wd.total_samples} spp, "
                  f"{mrays:.2f} Mrays/s, {wd.time:.1f}s, compaction {wd.compact}")

    res = Renderer(scene, meta, cam, cfg, device=device).render(
        on_wave=on_wave, checkpoint=args.checkpoint
    )
    if args.output.endswith(".ppm"):
        write_ppm(args.output, res.display)
    else:
        write_png(args.output, res.display)
    if not args.quiet:
        print(
            f"wrote {args.output}: {res.samples_taken}spp, {res.total_rays / 1e6:.1f} Mrays, "
            f"{res.total_time:.1f}s ({res.total_rays / max(res.total_time, 1e-9) / 1e6:.2f} "
            f"Mrays/s on {dev_name})"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
