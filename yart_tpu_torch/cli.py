"""Command-line renderer for the port.

Usage:
    python -m yart_tpu_torch.cli scene.glb --env-hdr sky.hdr -o out.png --spp 64 --device cuda
    python -m yart_tpu_torch.cli cornell-mat -o out.png --spp 64 --size 512x512 --device cuda
    python -m yart_tpu_torch.cli atrium --devices all --serve 8000      # a rank per card
    python -m yart_tpu_torch.cli cornell --devices 2 --device cpu        # two CPU ranks on gloo
    torchrun --nproc-per-node 8 -m yart_tpu_torch.cli atrium --distributed

Mirrors `yart_tpu/cli.py` flag for flag: glTF / GLB scene files
(`scene/gltf.py`) and Radiance HDR environments (`--env-hdr`,
`--env-scale`) on any scene, every procedural scene of the JAX CLI, both
integrators, every sampler (zsobol with each scrambler, stratified, hash),
every estimator, AgX with its looks, the thin-lens camera, the fused
shade tail (`--shade-kernel xla|pallas`: B6 + B5), checkpoint / resume,
JSON flag files (`--config`), the preview PNG and the live view
(`--preview`, `--serve`), a profiler trace (`--profile`), NaN checks
(`--debug-nan`) and multi-rank renders (`--devices`, `--distributed`; one
process a card, rank 0 prints and writes the image). It refuses only what
ROADMAP.md C records as a divergence from the JAX package: glTF textures
that are not PNG, and `--shade-kernel pallas` with
`--regularize-specular`, which the JAX package refuses too. The port's own
`--device` picks the card (or the CPU) and is a valid `--config` key.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

SCENES = ("cornell", "cornell-mat", "spheres", "furnace", "atrium", "atrium-ivy", "atrium-inst",
          "roadster", "luxball")
SCRAMBLERS = ("null", "binary", "fastowen", "owen")
CHUNK_PREVIEW_S = 2.0  # the live view's partial frames within a wave, at most one per this many seconds


def _parser():
    p = argparse.ArgumentParser(prog="yart-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("scene", help=".gltf/.glb path or procedural scene: " + " | ".join(SCENES))
    p.add_argument("--config", default=None,
                   help="JSON file of flag defaults (keys are flag names); flags given on the command line win")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("-o", "--output", default="out.png", help="output image (.png/.ppm)")
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--size", default="512x512", help="WxH")
    p.add_argument("--max-depth", type=int, default=30)
    p.add_argument("--integrator", choices=["mis", "naive"], default="mis")
    p.add_argument("--sampler", default="zsobol",
                   help="zsobol | stratified | hash | zsobol:<scrambler>, scrambler in {"
                        + ", ".join(SCRAMBLERS) + "} (zsobol = zsobol:fastowen, the reference's pick)")
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
    p.add_argument("--checkpoint", default=None, help="checkpoint file; resumed if present, saved every wave")
    p.add_argument("--env-hdr", default=None, help="octahedral Radiance HDR environment map path")
    p.add_argument("--env-scale", type=float, default=1.0)
    p.add_argument("--preview", default=None,
                   help="write the tonemapped image to this PNG after every wave (and within long waves)")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve a live view of the render over HTTP (0 picks a free port)")
    p.add_argument("--serve-host", default="127.0.0.1",
                   help="bind address of --serve (loopback by default; 0.0.0.0 exposes it)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="profile the render with torch.profiler (CPU and CUDA activities) and write "
                        "its chrome trace to DIR/trace.json")
    p.add_argument("--debug-nan", action="store_true",
                   help="raise FloatingPointError when a chunk's estimate, ray count or live counts hold "
                        "a NaN (the reference drops NaN samples silently, estimator.hpp:35)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--devices", default=None,
                   help="render over N ranks on this host, one process a card (cuda:0 .. cuda:N-1, NCCL), "
                        "or N CPU processes on gloo with --device cpu; 'all' = every card")
    p.add_argument("--distributed", action="store_true",
                   help="join the torchrun group of the environment (RANK, WORLD_SIZE, LOCAL_RANK, "
                        "MASTER_ADDR, MASTER_PORT) and render over all its ranks")
    return p


def parse_args(argv=None):
    p = _parser()
    args = p.parse_args(argv)
    if args.config:
        # Re-parse over the file's values: flags on the command line win.
        p.set_defaults(**_config_defaults(p, args.config))
        args = p.parse_args(argv)
    if args.scene not in SCENES and not os.path.isfile(args.scene):
        p.error(f"scene {args.scene!r}: no such file (a .gltf/.glb path) and no procedural scene "
                f"({' | '.join(SCENES)})")
    if args.env_hdr is not None and not os.path.isfile(args.env_hdr):
        p.error(f"--env-hdr {args.env_hdr!r}: no such file")
    if args.shade_kernel == "pallas" and args.regularize_specular is not None:
        from yart_tpu_torch.render.integrator import PALLAS_REG_SPECULAR

        p.error(f"--shade-kernel pallas --regularize-specular: {PALLAS_REG_SPECULAR}")
    s = args.sampler
    if not (s in ("hash", "stratified", "zsobol")
            or (s.startswith("zsobol:") and s.split(":", 1)[1] in SCRAMBLERS)):
        p.error(f"invalid --sampler {s!r}: expected zsobol | stratified | hash | "
                f"zsobol:{{{','.join(SCRAMBLERS)}}}")
    if args.devices is not None:
        d = str(args.devices)
        if not (d == "all" or (d.isdigit() and int(d) >= 1)):
            p.error(f"invalid --devices {args.devices!r}: expected a count >= 1 or 'all'")
        args.devices = d if d == "all" else int(d)
    return args


def _config_defaults(p, path: str) -> dict:
    """The flag values of a JSON --config file, keyed by argparse dest;
    exits naming an unknown key."""
    try:
        with open(path) as f:
            cfg = json.load(f)
    except (OSError, ValueError) as e:
        p.error(f"--config {path!r}: {e}")
    if not isinstance(cfg, dict):
        p.error(f"--config {path!r}: expected a JSON object of flag values")
    dests = {a.dest for a in p._actions} - {"help"}
    out = {}
    for k, v in cfg.items():
        dest = k.lstrip("-").replace("-", "_")
        if dest not in dests:
            p.error(f"--config {path!r}: unknown config key: {k}")
        out[dest] = v
    return out


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


def ranks_for(devices, device) -> int:
    """The rank count of --devices for ranks of `device` (a torch.device):
    'all' is every card (one CPU rank)."""
    import torch

    if devices == "all":
        return torch.cuda.device_count() if device.type == "cuda" else 1
    return int(devices)


def _render(args, device, devices=None) -> int:
    """Build, render and (on rank 0) write the image of the parsed
    arguments on `device`; `devices` as Renderer takes it."""
    import torch

    from yart_tpu_torch.io.image import write_png, write_ppm
    from yart_tpu_torch.ops.tonemap import tonemap
    from yart_tpu_torch.parallel import distributed
    from yart_tpu_torch.render.renderer import Renderer

    lead = distributed.rank() == 0  # rank 0 alone prints, serves and writes
    say = lead and not args.quiet
    scene, meta = build_scene(args, device)
    cam, cfg = render_configs(args)
    w, h = cam.image_size
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    r = Renderer(scene, meta, cam, cfg, device=device, devices=devices, debug_nan=args.debug_nan)
    if say:
        print(
            f"scene: {args.scene} ({meta.n_tris} tris, {meta.n_lights} lights, env={meta.has_env}); "
            f"{w}x{h} @ {args.spp}spp on {device} ({dev_name})"
            + (f"; {r.n_devices} ranks ({torch.distributed.get_backend()})" if r.sharded else "")
        )
    server = None
    if args.serve is not None and lead:
        from yart_tpu_torch.io.preview import PreviewServer

        server = PreviewServer(args.serve, host=args.serve_host)
        if say:
            print(f"live view: http://{args.serve_host}:{server.port}/")

    def on_wave(wd, preview):
        if say:
            mrays = wd.rays / max(wd.time, 1e-9) / 1e6
            print(f"wave {wd.wave}: {wd.samples_taken}/{wd.total_samples} spp, "
                  f"{mrays:.2f} Mrays/s, {wd.time:.1f}s, compaction {wd.compact}")
        if args.preview and lead:
            write_png(args.preview, preview)
        if server is not None:
            server.update(preview, wd)

    # Partial frames within a wave, at most one per CHUNK_PREVIEW_S, when
    # someone watches (on_wave shows each wave's last chunk).
    on_chunk = None
    if server is not None or (args.preview and lead):
        last = [0.0]

        def on_chunk(cd, merged_hdr):
            now = time.monotonic()
            if cd.chunk + 1 >= cd.n_chunks or now - last[0] < CHUNK_PREVIEW_S:
                return
            last[0] = now
            img = tonemap(torch.from_numpy(merged_hdr()), cfg.tonemap, cfg.agx_look).numpy()
            if server is not None:
                server.update(img)
            if args.preview:
                write_png(args.preview, img)

    prof = None
    if args.profile and lead:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    try:
        res = r.render(on_wave=on_wave, on_chunk=on_chunk, checkpoint=args.checkpoint)
        if server is not None:
            server.update(res.display, done=True)
    finally:
        if prof is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            prof.stop()
        if server is not None:
            server.close()
    if prof is not None:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    if not lead:
        return 0
    if args.output.endswith(".ppm"):
        write_ppm(args.output, res.display)
    else:
        write_png(args.output, res.display)
    if say:
        if args.profile:
            print(f"profile: {os.path.join(args.profile, 'trace.json')}")
        print(
            f"wrote {args.output}: {res.samples_taken}spp, {res.total_rays / 1e6:.1f} Mrays, "
            f"{res.total_time:.1f}s ({res.total_rays / max(res.total_time, 1e-9) / 1e6:.2f} "
            f"Mrays/s on {dev_name})"
        )
    return 0


def _rank_main(rank: int, argv) -> None:
    """A rank of `--devices` started by rank 0's process: render its parts."""
    from yart_tpu_torch.parallel import distributed

    args = parse_args(argv)
    _render(args, distributed.rank_device(args.device), devices=distributed.world_size())


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    import torch

    from yart_tpu_torch.parallel import distributed

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device is available "
            "(torch.cuda.is_available() is False); pass --device cpu to render on the CPU"
        )
    if args.distributed:
        # torchrun's group (one rank alone without its environment), all of it.
        owned = not distributed.is_initialized()
        distributed.init_distributed(device=device)
        try:
            return _render(args, distributed.rank_device(device) if owned else device,
                           devices="all" if distributed.is_initialized() else None)
        finally:
            if owned:
                distributed.shutdown()
    if args.devices is None:
        return _render(args, device)
    if distributed.is_initialized():
        raise SystemExit("--devices starts ranks of its own; in a torch.distributed group pass --distributed")
    n = ranks_for(args.devices, device)
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"--devices {args.devices}: this host has {torch.cuda.device_count()} CUDA device(s), "
                         f"and a rank runs on a card of its own (NCCL refuses two ranks on one card)")
    if n < 1:
        raise SystemExit(f"--devices {args.devices}: this host has no CUDA device")
    # This process is rank 0 (it prints and writes); ranks 1 .. n-1 are
    # spawned processes on the other cards (or CPU processes on gloo).
    init = f"tcp://127.0.0.1:{distributed.free_port()}"
    procs = distributed.start_ranks(_rank_main, n, range(1, n), init, device=device.type, args=(argv,))
    try:
        distributed.init_distributed(init, n, 0, device=device.type)
        try:
            rc = _render(args, distributed.rank_device(device), devices=n)
        finally:
            distributed.shutdown()
        distributed.join_ranks(procs)
    finally:
        distributed.stop_ranks(procs)
    return rc


if __name__ == "__main__":
    sys.exit(main())
