"""Where a render's time goes on the card.

    python -m yart_tpu_torch.profile_render spheres --spp 16 --size 512x512 [--out DIR]
    python -m yart_tpu_torch.profile_render atrium --density 3 --spp 4 --size 512x512
    python -m yart_tpu_torch.profile_render atrium-ivy --density 3 --spp 4 --size 256x256
    python -m yart_tpu_torch.profile_render cornell-mat --spp 4 --shade-kernel pallas

Takes the CLI's scene, camera and render flags (after the scene name, any
flag of `python -m yart_tpu_torch.cli`; `--density` multiplies the atrium
scenes' tessellation: 3 gives the dense atriums, baked through
bin-trace, with ivy through the stack traversals, instanced through the
per-instance loop), renders once without the
profiler (the timing of record, and the warm-up: the kernels build
there), then once under `torch.profiler` with CPU and CUDA activities, and
prints one JSON line:

- wall seconds, rays and Mrays/s of both renders;
- kernel launches and summed kernel milliseconds of the profiled render,
  the bounces it ran (one per depth per compaction stage) and the kernel
  launches per bounce, and the device's busy share there (kernel time /
  profiled wall; one stream, so kernels do not overlap);
- kernel milliseconds and launches grouped as the port's kernels B1-B6
  (by their CUDA function names), sorting, and the rest (PyTorch's own
  kernels), with the 12 kernels of most device time;
- the peak device memory of the profiled render (scene tables included);
- the phases of the big-scene paths, from their profiler ranges: bin-trace's
  (`render/bintrace.py`) collect loop (plain PyTorch) and pair phase
  (layout, B4, the per-ray reduction), the stack traversals' loop
  (`render/stacktrace.py`, plain PyTorch) and the per-instance loop
  (`render/intersect.py`; it holds its prototypes' paths), each with its
  calls, host milliseconds and the device milliseconds of the kernels it
  launched (these kernels are also in the groups above).

With --out DIR the profiler's chrome trace is written to DIR/trace.json.
The card is required: this measures the device, never the CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

GROUPS = (  # (group, substring of the CUDA kernel's name, lower case)
    ("B1 brute_intersect", "brute_intersect_kernel"),
    ("B2 presort_keys", "presort_keys_kernel"),
    ("B3 fused_trace", "fused_trace_kernel"),
    ("B4 cluster_pairs", "cluster_pairs_kernel"),
    ("B5 shade", "shade_kernel"),
    ("B6 draws", "draws_kernel"),
    ("sort", "sort"),  # cub's radix sort kernels ("DeviceRadixSort...")
)


def _render(scene, meta, cam, cfg, device):
    import torch

    from yart_tpu_torch.render.renderer import Renderer

    torch.cuda.synchronize()
    t0 = time.time()
    res = Renderer(scene, meta, cam, cfg, device=device).render()
    torch.cuda.synchronize()
    wall = time.time() - t0
    return {"wall_s": wall, "rays": res.total_rays, "mrays_per_s": res.total_rays / wall / 1e6}


def _tally(prof, range_names):
    """({CUDA kernel name: [launches, us]}, {range: {calls, host_ms,
    device_ms}}) from the profiler's raw events. Torch's own event tree
    (`prof.events()`) takes over ten minutes for the dense atrium's ~1.4 M
    launches; this pass is linear. A kernel counts toward the range whose
    span holds its launch on the host: the CUDA runtime or driver call with
    its correlation id, else the start of the op it is linked to. Runtime
    calls number their correlation ids apart from ops and ranges, so the
    two are kept in separate tables."""
    import bisect

    from torch.autograd import DeviceType

    by_name = collections.defaultdict(lambda: [0, 0.0])
    launch_at, op_start, spans, kernels = {}, {}, {r: [] for r in range_names}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name() in spans:
                spans[e.name()].append((e.start_ns(), e.end_ns()))
            if e.name().startswith("cu"):  # a CUDA runtime or driver call (cudaLaunchKernel, ...)
                launch_at[e.correlation_id()] = e.start_ns()
            elif e.linked_correlation_id() == 0:  # an op or a range
                op_start[e.correlation_id()] = e.start_ns()
        elif e.device_type() == DeviceType.CUDA and e.name() not in spans:  # a range's device copy is no kernel
            by_name[e.name()][0] += 1
            by_name[e.name()][1] += e.duration_ns() / 1e3
            t = launch_at.get(e.correlation_id())
            kernels.append((t if t is not None else op_start.get(e.linked_correlation_id()), e.duration_ns()))
    ranges = {}
    for r, sp in spans.items():
        sp.sort()
        starts = [a for a, _ in sp]
        device_ns = 0
        for t, ns in kernels:
            i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            if i >= 0 and t <= sp[i][1]:
                device_ns += ns
        ranges[r] = {"calls": len(sp), "host_ms": sum(b - a for a, b in sp) / 1e6, "device_ms": device_ns / 1e6}
    return by_name, ranges


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="directory for the chrome trace")
    ap.add_argument("--density", type=int, default=1, help="atrium tessellation (3: the bin-trace scene)")
    own, rest = ap.parse_known_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from yart_tpu_torch import cli
    from yart_tpu_torch.render import bintrace, integrator, intersect, stacktrace

    args = cli.parse_args(rest)
    if not torch.cuda.is_available() or torch.device(args.device).type != "cuda":
        raise SystemExit("profile_render measures the card: it needs a CUDA device")
    device = torch.device(args.device)
    scene, meta = cli.build_scene(args, device, own.density)
    cam, cfg = cli.render_configs(args)

    plain = _render(scene, meta, cam, cfg, device)
    integrator.BOUNCES.reset()
    torch.cuda.reset_peak_memory_stats(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = _render(scene, meta, cam, cfg, device)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    bounces = integrator.BOUNCES.bounces

    by_name, ranges = _tally(prof, bintrace.RANGES + (stacktrace.RANGE, intersect.INSTANCED_RANGE))
    total_us = sum(us for _, us in by_name.values())
    launches = sum(n for n, _ in by_name.values())
    groups = collections.OrderedDict((g, 0.0) for g, _ in GROUPS)
    groups["other"] = 0.0
    group_launches = collections.OrderedDict((g, 0) for g in groups)
    for name, (n, us) in by_name.items():
        g = next((g for g, key in GROUPS if key in name.lower()), "other")
        groups[g] += us / 1e3
        group_launches[g] += n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    if own.out:
        os.makedirs(own.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(own.out, "trace.json"))
    print(json.dumps({
        "scene": args.scene, "n_tris": meta.n_tris, "size": list(cam.image_size), "spp": cfg.samples,
        "max_depth": cfg.max_depth, "shade_kernel": cfg.shade_kernel, "device": torch.cuda.get_device_name(device),
        "unprofiled": plain, "profiled": profiled,
        "kernel_launches": launches, "bounces": bounces, "launches_per_bounce": launches / max(bounces, 1),
        "kernel_ms": total_us / 1e3,
        "busy_share_profiled": total_us / 1e6 / profiled["wall_s"],
        "kernel_ms_by_group": groups, "kernel_launches_by_group": group_launches, "phases": ranges, "peak_gib_profiled": peak_gib,
        "top_kernels": [{"name": n[:120], "launches": c, "ms": us / 1e3} for n, (c, us) in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
