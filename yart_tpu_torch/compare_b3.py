"""B3 builds timed in turns on chip_smoke.py's B3 cases, on the card.

    python -m yart_tpu_torch.compare_b3 OLD.cu yart_tpu_torch/csrc/fused_trace.cu

Run from the root of a checkout: the scenes, rays, timer and bounds are
chip_smoke.py's own. Each argument is a B3 source with the launcher of
`csrc/fused_trace.cu` (`fused_trace_launch`, the same C signature), built
with the package's nvcc flags into `build/compare_b3/`. The first line
names the card and each build's registers and spills (ptxas). Then, for
each B3 case of chip_smoke.py, one JSON line:

- 3b the bench scene's 262,144 incoherent and coherent rays (closest);
- 3c the spheres render's 2^20 camera rays and their shadow rays (`nee`);
- 3d atrium-ivy's 2^20 camera rays, `amask` cast 0 and cast 1, and beside
  them (not a chip_smoke.py case) the same casts of rays leaving their
  hits in random directions, as a render's later bounces send them;
- 3f atrium-inst's 2^20 camera rays (instanced) and sun shadow rays
  (`instanced+nee`);
- 3g the gated instanced scene's 2^16 camera rays, `instanced+amask`
  casts 0 and 1.

A line holds the case's bounds (chip_smoke.b3_bounds: `bound_ms` over the
work the inputs need, `sweep_bound_ms` over a sweep of every box by every
live ray) and, per source, whether its output equals `fused_trace_plain`'s
bitwise in all 8 columns and its median milliseconds (chip_smoke.cuda_ms,
11 launches) at each of its turns: the sources run in the order given and then in reverse
(A B B A), on the same tensors. A source that computes less than B3 (a
variant that times a part of it) is timed all the same; its
`bitwise_equal` is then false.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

CASE_REPS = 11  # launches per timed turn


def build_source(path: str):
    """nvcc `path` into build/compare_b3/ (cached by content and flags);
    returns (library path, ptxas report)."""
    from yart_tpu_torch.kernels import build

    with open(path, "rb") as f:
        src = f.read()
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode() + b"\0" + src).hexdigest()[:16]
    out_dir = os.path.join(os.path.dirname(build.BUILD_ROOT), "compare_b3",
                           f"{os.path.splitext(os.path.basename(path))[0]}-{h}")
    lib = os.path.join(out_dir, "libb3.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", tmp, os.path.abspath(path)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {path}:\n{proc.stdout}\n{proc.stderr}")
        with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return lib, build.parse_ptxas(os.path.join(out_dir, "ptxas.txt"))


def amask_cases(cs, name, scene, meta, o, d, seeds):
    """chip_smoke.compare_amask's two casts: (name, B3 arguments) each."""
    import torch

    from yart_tpu_torch.kernels import fusedtrace
    from yart_tpu_torch.render import blocktrace

    n = o.shape[0]
    t_max = torch.full((n,), 1e30, device=o.device)
    rays = blocktrace.ray_matrix(o, d, t_max)
    order, blive0, slots = blocktrace.fused_order(scene, meta, o, d, t_max, torch.zeros(n, device=o.device), 1e-3)
    tables = (scene.clus_box, scene.clus_pack, blocktrace.cluster_counts(scene, meta))
    inst = blocktrace.inst_tables(scene, meta)
    args0 = (rays[order].contiguous(), slots, *tables, blive0, 1e-3, False, True, inst)
    yield f"{name}_cast0", args0
    rays1, blive1, _, _ = cs.amask_cast1(scene, meta, o, d, seeds, order, blive0,
                                         fusedtrace.fused_trace_plain(*args0))
    yield f"{name}_cast1", (rays1, slots, *tables, blive1, 1e-3, False, True, inst)


def cases(cs, dev):
    """(name, B3 arguments) of every B3 case of chip_smoke.py, built as
    its phases 3b-3g build them."""
    import torch

    from yart_tpu_torch.cli import CAMERAS
    from yart_tpu_torch.config import CameraConfig
    from yart_tpu_torch.render import blocktrace
    from yart_tpu_torch.scene.procedural import material_test_spheres
    from yart_tpu_torch.scene.showcase import atrium, instanced_leaves

    def camera(name, side=1024, seeds=False):
        pos, target = CAMERAS[name]
        fwd = tuple(t - p for p, t in zip(pos, target))
        return cs.camera_rays(CameraConfig(image_size=(side, side), focal_length=35.0, position=pos,
                                           forward=fwd), dev, seeds=seeds)

    big, big_meta = cs.big_scene(dev)
    lanes = 262144
    for case, coherent in (("incoherent", False), ("coherent", True)):
        bo, bd = (torch.from_numpy(a).to(dev) for a in cs.make_rays(lanes, coherent))
        bt = torch.full((lanes,), 100.0, device=dev)
        if not coherent:
            bt[: 1 << 14] = -1.0
        yield f"bigscene_{case}", cs.blocktrace_case(big, big_meta, bo, bd, bt)[2]
    del big

    spheres, spheres_meta = material_test_spheres().compile(dev)
    so, sd = camera("spheres")
    st = torch.full((so.shape[0],), 1e30, device=dev)
    yield "spheres_camera", cs.blocktrace_case(spheres, spheres_meta, so, sd, st)[2]
    t_hit, _, _, _, tri_hit, _, _ = blocktrace.intersect_blocktrace(spheres, spheres_meta, so, sd, st)
    yield "spheres_shadow_nee", cs.blocktrace_case(spheres, spheres_meta,
                                                   *cs.shadow_rays(so, sd, t_hit, tri_hit >= 0), nee=True)[2]

    ivy, ivy_meta = atrium(ivy=True).compile(dev)
    io, idr, iseed = camera("atrium-ivy", seeds=True)
    yield from amask_cases(cs, "atrium_ivy_camera", ivy, ivy_meta, io, idr, iseed)
    i_hit = blocktrace.intersect_blocktrace(ivy, ivy_meta, io, idr, torch.full((io.shape[0],), 1e30, device=dev))
    so2, sd2, _ = cs.shadow_rays(io, idr, i_hit[0], i_hit[4] >= 0)
    yield from amask_cases(cs, "atrium_ivy_secondary", ivy, ivy_meta, so2, sd2, iseed)
    del ivy

    inst, inst_meta = atrium(instanced=True).compile(dev)
    ao, ad = camera("atrium-inst")
    at = torch.full((ao.shape[0],), 1e30, device=dev)
    yield "atrium_inst_camera", cs.blocktrace_case(inst, inst_meta, ao, ad, at)[2]
    a_hit = blocktrace.intersect_blocktrace(inst, inst_meta, ao, ad, at)
    yield "atrium_inst_sun_shadow_nee", cs.blocktrace_case(
        inst, inst_meta, *cs.shadow_rays(ao, ad, a_hit[0], a_hit[4] >= 0, cs.SUN), nee=True)[2]
    del inst

    lv, lv_meta = instanced_leaves().compile(dev)
    lcam = CameraConfig(image_size=(256, 256), focal_length=30.0, position=(0.0, 1.2, 4.5),
                        forward=(0.0, -0.1, -1.0))
    yield from amask_cases(cs, "instanced_leaves_camera_2^16", lv, lv_meta, *cs.camera_rays(lcam, dev, seeds=True))


def main(argv=None) -> int:
    sources = list(sys.argv[1:] if argv is None else argv)
    if len(sources) < 1 or any(not s.endswith(".cu") for s in sources):
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_b3 measures the card: it needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from yart_tpu_torch.kernels import fusedtrace

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(build_source, sources))
    fns = [fusedtrace.bind(ctypes.CDLL(lib)) for lib, _ in built]
    print(json.dumps({"device": cs.nvidia_smi(), "sources": sources,
                      "ptxas": {s: p for s, (_, p) in zip(sources, built)}}), flush=True)
    turns = list(range(len(sources))) + list(reversed(range(len(sources))))
    for name, args in cases(cs, dev):
        ref = fusedtrace.fused_trace_plain(*args)
        rays, blive = args[0], args[5]
        rec = {"case": name, "mode": fusedtrace.mode_name(args[7], args[8], args[9] is not None),
               "n_rays": int(rays.shape[0]), "live_rays": int((rays[:, 6] > 0).sum()),
               "live_blocks": int(blive.sum()), **cs.b3_bounds(args, ref, prefix="")}
        per = {s: {"bitwise_equal": cs.bits_equal(fusedtrace.launch(*args, fn=fn), ref), "ms": []}
               for s, fn in zip(sources, fns)}
        for i in turns:
            per[sources[i]]["ms"].append(cs.cuda_ms(lambda: fusedtrace.launch(*args, fn=fns[i]), reps=CASE_REPS))
        for p in per.values():
            p["ms_mean"] = sum(p["ms"]) / len(p["ms"])
        rec["sources"] = per
        print(json.dumps(rec), flush=True)
        del ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
