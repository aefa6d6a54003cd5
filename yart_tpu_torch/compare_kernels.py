"""Builds of one kernel timed in turns on chip_smoke.py's cases, on the card.

    python -m yart_tpu_torch.compare_kernels --kernel b1 OLD.cu yart_tpu_torch/csrc/brute_intersect.cu
    python -m yart_tpu_torch.compare_kernels --kernel b5 OLD.cu yart_tpu_torch/csrc/shade.cu
    python -m yart_tpu_torch.compare_kernels --kernel b6 yart_tpu_torch/csrc/draws.cu --sass DIR
    python -m yart_tpu_torch.compare_kernels --kernel b3 OLD.cu yart_tpu_torch/csrc/fused_trace.cu
    python -m yart_tpu_torch.compare_kernels --kernel b2 OLD.cu yart_tpu_torch/csrc/presort_keys.cu
    python -m yart_tpu_torch.compare_kernels --kernel b4 OLD.cu yart_tpu_torch/csrc/cluster_pairs.cu@128
    python -m yart_tpu_torch.compare_kernels --kernel b7a OLD.cu yart_tpu_torch/csrc/select_clusters.cu
    python -m yart_tpu_torch.compare_kernels --kernel b7b OLD.cu yart_tpu_torch/csrc/test_clusters.cu
    ... [--sass DIR]

Run from the root of a checkout: the scenes, rays, timer and bounds are
chip_smoke.py's own. Each argument is a source of the kernel with the
package's launcher (the same C signature as `csrc/brute_intersect.cu`
(B1), `csrc/presort_keys.cu` (B2), `csrc/fused_trace.cu` (B3),
`csrc/cluster_pairs.cu` (B4), `csrc/shade.cu` (B5), `csrc/draws.cu`
(B6), `csrc/select_clusters.cu` (B7a) or `csrc/test_clusters.cu` (B7b)),
built with the package's nvcc flags into `build/compare_kernels/` (a
variant is a patched copy of the source, its local headers beside it).
For B4 a source may
also have the earlier padded-block launcher (block cid, first and live
flags, recognised by its signature): its pairs are then laid out as that
design laid them out (each cluster's pairs in whole blocks of 1024 rows,
the rest empty rows) and its results are compared per pair. `@T` after a
B4 source lays its pairs out in tiles of T (default `clusterpairs.TILE`).
A B7a source may also have the first B7 design's launcher without the
per-block records, and a B7b source that design's launcher without the
cluster counts (each recognised by its signature); that B7b tests all C
columns, and its output is compared with the twin's with the counts,
which equals the twin's without them on the scene's packs.

The first line names the card and each build's registers and spills
(ptxas) and its build seconds. With `--sass DIR` each build's SASS
(`cuobjdump -sass`) is written to DIR, and the line gives each kernel
function's instruction count, its local loads and stores (LDL, STL) and
its innermost loops: their instruction counts and those of the
instructions that make a slab (B2, B7a), plane (B4, B7b) or
Moller-Trumbore test (B1's triangle loop). Then, for each case, one JSON line: the case's bounds
(chip_smoke's `b1_work` and `b1_floor_ms`, `b2_bounds`, `b3_bounds`,
`b4_work` and `b4_floor_ms`, `b5_bytes`, `b6_bound`, `b7a_bounds`,
`b7b_bounds`: `bound_ms` over the work the inputs need, beside it the
parent design's sweep bound or the no-FMA floor; B5's lobe mix, `kernels/shade.py` `mixed_warps`), and per source
whether its output equals the plain twin's bitwise and its median
milliseconds (chip_smoke.cuda_ms, 11 launches, the launch alone: the
wrapper's checks and allocations are made once before) at each of its
turns: the sources run in the order given and then in reverse (A B B A),
`--rounds` times, on the same tensors. A source that computes less than
the kernel (a variant that times a part of it) is timed all the same; its
`bitwise_equal` is then false.

Cases:
- b1: chip_smoke.py phase 3's cases (`b1_cases`): cornell-mat's 2^20
  camera rays against its 36 triangles, a 4096-triangle soup at 2^20 rays
  (a block retired) and a ragged 1000, and the edge cases (T = 0, 1, 255,
  256, 257 and 4096 at 2^16 + 77 rays, equal-t ties, NaN and zero
  directions, det at +-1e-12).
- b5: chip_smoke.py phase 3k's cases (`b5_cases`): real depth-1 bounces
  of cornell-mat and atrium-ivy (2^20 lanes) and roadster (2^16), 2^20
  random all-gates lanes (also with mis off and with no lights), dead
  blocks, tiles of one lobe, the four lobes interleaved lane by lane, dead
  tiles, n = 1, 127, 129 and 2^20 + 77, and inputs with a storage offset.
  The bounces are captured with the plain twin, so no build under test
  makes another's inputs.
- b6: chip_smoke.py phase 3j's cases (`b6_cases`): the 8 draws of a
  512x512 render's 2^20 lanes at bounce dimensions 4 and 28, ZSobol at 16
  and 8 spp, a ragged 1000, and the hash sampler.
- b3: 3b the bench scene's 262,144 incoherent and coherent rays; 3c the
  spheres render's 2^20 camera rays and their shadow rays (`nee`); 3d
  atrium-ivy's 2^20 camera rays, `amask` casts 0 and 1, and beside them
  the same casts of rays leaving their hits in random directions; 3f
  atrium-inst's camera rays (instanced) and sun shadow rays
  (`instanced+nee`); 3g the gated instanced scene's 2^16 camera rays,
  `instanced+amask` casts 0 and 1.
- b2: the B2 calls of those phases on rays in lane order: the bench
  scene's incoherent and coherent rays, the spheres render's camera and
  shadow rays, atrium-ivy's camera rays and rays leaving their hits in
  random directions, atrium-inst's camera and sun shadow rays.
- b7a, b7b: chip_smoke.py phase 3l's cases, the round-based path on the
  bench scene at 262,144 incoherent and coherent rays, round 1 and the
  first later round with converged blocks (`b7_round`); B7b on the slots
  that B7a's twin picks, with the clusters' counts.
- b4: bin-trace's rounds 1 and 2 of the dense atrium's 2^20 camera rays
  (atrium(density=3), built here: ~90 s on the host), round 1 of rays
  leaving their hits in random directions, and round 1 of the bench scene
  at C = 16 with 262,144 incoherent rays.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

CASE_REPS = 11  # launches per timed turn
# Instructions that make a slab test (B2), a plane test (B4) or a
# Moller-Trumbore test (B1) in SASS.
SASS_OPS = ("FMNMX", "FMUL", "FADD", "FSETP", "FSEL", "LDS", "MUFU", "FFMA")
LOCAL_OPS = ("LDL", "STL")  # local-memory loads and stores (spills, local arrays)


def build_source(path: str):
    """nvcc `path` into build/compare_kernels/ (cached by content and
    flags); returns (library path, ptxas report, build seconds: 0.0 for a
    cached build)."""
    from yart_tpu_torch.kernels import build

    with open(path, "rb") as f:
        src = f.read()
    for inc in sorted(set(re.findall(rb'#include "([^"]+)"', src))):  # its local headers, hashed with it
        with open(os.path.join(os.path.dirname(os.path.abspath(path)), inc.decode()), "rb") as f:
            src += b"\0" + f.read()
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode() + b"\0" + src).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(path))[0]
    out_dir = os.path.join(os.path.dirname(build.BUILD_ROOT), "compare_kernels", f"{stem}-{h}")
    lib = os.path.join(out_dir, f"lib{stem}.so")
    seconds = 0.0
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", tmp, os.path.abspath(path)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {path}:\n{proc.stdout}\n{proc.stderr}")
        with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return lib, build.parse_ptxas(os.path.join(out_dir, "ptxas.txt")), round(seconds, 3)


def sass_loops(lib: str, out_path: str) -> dict:
    """Write `cuobjdump -sass` of `lib` to `out_path`; return, per kernel
    function, its instruction count and its innermost loops (a backward
    branch and the instructions it spans that hold no other loop), each
    with its instruction count and the counts of SASS_OPS in it."""
    from yart_tpu_torch.kernels import build

    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    with open(out_path, "w") as f:
        f.write(text)
    out, name, ins, labels = {}, None, [], {}

    def close():
        if name is None:
            return
        loops = []
        for i, (addr, op, target) in enumerate(ins):
            if op.startswith("BRA") and target is not None:
                t = labels.get(target, target) if isinstance(target, str) else target
                if isinstance(t, int) and t <= addr:
                    loops.append((t, addr))
        inner = [lp for lp in loops if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        rows = []
        for a, b in sorted(set(inner)):
            body = [op for addr, op, _ in ins if a <= addr <= b]
            rows.append({"start": hex(a), "instructions": len(body),
                         **{k: sum(1 for op in body if op.split(".")[0] == k) for k in SASS_OPS}})
        out[name] = {"instructions": len(ins), **{k: sum(1 for _, op, _ in ins if op.split(".")[0] == k)
                                                   for k in LOCAL_OPS}, "innermost_loops": rows}

    pending = []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            name, ins, labels, pending = m.group(1), [], {}, []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if m and name is not None:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            tgt = re.search(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b", m.group(3)) if m.group(2).startswith("BRA") else None
            target = None if tgt is None else (tgt.group(1) or int(tgt.group(2), 16))
            ins.append((addr, m.group(2), target))
    close()
    return out


class Source:
    """One build of the kernel under comparison: `path[@TILE]`."""

    def __init__(self, arg: str, kernel: str):
        self.arg = arg
        self.path, _, tile = arg.partition("@")
        if tile and kernel != "b4":
            raise SystemExit(f"{arg}: a tile size is a B4 source's option")
        with open(self.path) as f:
            text = f.read()
        self.padded = kernel == "b4" and "block_live" in text
        launcher = re.search(r'extern "C" int \w+_launch\(([^)]*)\)', text)
        # The first B7 design's launchers: B7a without `stats`, B7b without `counts`.
        self.first_b7 = kernel in ("b7a", "b7b") and launcher is not None and not re.search(
            r"\b(stats|counts)\b", launcher.group(1))
        if tile and self.padded:
            raise SystemExit(f"{arg}: the padded-block B4 has no tiles")
        self.tile = int(tile) if tile else None
        self.lib = self.ptxas = self.fn = None

    def bind(self, kernel: str):
        from yart_tpu_torch.kernels import blocktrace, brute, clusterpairs, fusedtrace, presort, shade

        lib = ctypes.CDLL(self.lib)
        if self.padded:
            self.fn = bind_padded(lib)
        elif self.first_b7:
            self.fn = bind_first_b7(lib, kernel)
        elif kernel in ("b7a", "b7b"):
            self.fn = (blocktrace.bind_select if kernel == "b7a" else blocktrace.bind_test)(lib)
        else:
            self.fn = {"b1": brute.bind, "b2": presort.bind, "b3": fusedtrace.bind, "b4": clusterpairs.bind,
                       "b5": shade.bind_shade, "b6": shade.bind_draws}[kernel](lib)


def bind_padded(lib):
    """The earlier padded-block B4 launcher, typed."""
    fn = lib.cluster_pairs_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_float] + [ctypes.c_void_p] * 6
    return fn


def bind_first_b7(lib, kernel: str):
    """The first B7 design's B7a launcher (no per-block records) or B7b
    launcher (no cluster counts), typed, behind the package launcher's
    arguments: the argument it lacks is dropped."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if kernel == "b7a":
        fn = lib.select_clusters_launch
        fn.argtypes = [p, i, p, i, p, p, i, f, p, p, p, p]
        drop = 11  # stats
    else:
        fn = lib.test_clusters_launch
        fn.argtypes = [p, i, p, i, p, p, p, i, f, p, p]
        drop = 4  # counts
    fn.restype = ctypes.c_int
    return lambda *args: fn(*args[:drop], *args[drop + 1:])


def padded_layout(lay, clus_first):
    """The earlier padded layout for the pairs of compact layout `lay`: each
    cluster's rows in whole blocks of 1024, the rest zero rows (tmax 0).
    Returns (x, block_cid, block_first, block_live, pos: each compact row's
    row in x)."""
    import torch

    dev = lay.x.device
    cid = torch.repeat_interleave(lay.tiles[:, 0], lay.tiles[:, 3].long(), output_size=lay.x.shape[0]).long()
    cids, cnt = torch.unique_consecutive(cid, return_counts=True)
    blocks = (cnt + 1023) // 1024
    blk_end = torch.cumsum(blocks, 0)
    run = torch.repeat_interleave(torch.arange(cids.numel(), device=dev), cnt, output_size=cid.numel())
    rank = torch.arange(cid.numel(), device=dev) - (torch.cumsum(cnt, 0) - cnt)[run]
    pos = ((blk_end - blocks)[run] + rank // 1024) * 1024 + rank % 1024
    n_blocks = int(blk_end[-1])
    x = torch.zeros((n_blocks * 1024, 8), dtype=torch.float32, device=dev)
    x[pos] = lay.x
    block_cid = torch.repeat_interleave(cids, blocks, output_size=n_blocks).to(torch.int32)
    return (x, block_cid, clus_first[block_cid.long()].contiguous(),
            torch.ones(n_blocks, dtype=torch.int32, device=dev), pos)


def launch_padded(fn, clus_pack, c, padded, t_min):
    import torch

    x, cid, first, live, pos = padded
    p = x.shape[0]
    t, u, v = (torch.empty(p, device=x.device) for _ in range(3))
    back = torch.empty(p, dtype=torch.bool, device=x.device)
    tri = torch.empty(p, dtype=torch.int32, device=x.device)
    err = fn(clus_pack.data_ptr(), int(c), cid.data_ptr(), first.data_ptr(), live.data_ptr(), int(cid.shape[0]),
             x.data_ptr(), float(t_min), t.data_ptr(), u.data_ptr(), v.data_ptr(), back.data_ptr(), tri.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cluster_pairs (padded) launch failed: cudaError {err}")
    return t, u, v, back, tri


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


def camera(cs, name, dev, side=1024, seeds=False):
    from yart_tpu_torch.cli import CAMERAS
    from yart_tpu_torch.config import CameraConfig

    pos, target = CAMERAS[name]
    fwd = tuple(t - p for p, t in zip(pos, target))
    return cs.camera_rays(CameraConfig(image_size=(side, side), focal_length=35.0, position=pos, forward=fwd),
                          dev, seeds=seeds)


def b3_cases(cs, dev):
    """(name, B3 arguments) of every B3 case of chip_smoke.py, built as
    its phases 3b-3g build them."""
    import torch

    from yart_tpu_torch.config import CameraConfig
    from yart_tpu_torch.render import blocktrace
    from yart_tpu_torch.scene.procedural import material_test_spheres
    from yart_tpu_torch.scene.showcase import atrium, instanced_leaves

    big, big_meta = cs.big_scene(dev)
    for case, (bo, bd, bt) in bench_rays(cs, dev):
        yield f"bigscene_{case}", cs.blocktrace_case(big, big_meta, bo, bd, bt)[2]
    del big

    spheres, spheres_meta = material_test_spheres().compile(dev)
    so, sd = camera(cs, "spheres", dev)
    st = torch.full((so.shape[0],), 1e30, device=dev)
    yield "spheres_camera", cs.blocktrace_case(spheres, spheres_meta, so, sd, st)[2]
    t_hit, _, _, _, tri_hit, _, _ = blocktrace.intersect_blocktrace(spheres, spheres_meta, so, sd, st)
    yield "spheres_shadow_nee", cs.blocktrace_case(spheres, spheres_meta,
                                                   *cs.shadow_rays(so, sd, t_hit, tri_hit >= 0), nee=True)[2]

    ivy, ivy_meta = atrium(ivy=True).compile(dev)
    io, idr, iseed = camera(cs, "atrium-ivy", dev, seeds=True)
    yield from amask_cases(cs, "atrium_ivy_camera", ivy, ivy_meta, io, idr, iseed)
    i_hit = blocktrace.intersect_blocktrace(ivy, ivy_meta, io, idr, torch.full((io.shape[0],), 1e30, device=dev))
    so2, sd2, _ = cs.shadow_rays(io, idr, i_hit[0], i_hit[4] >= 0)
    yield from amask_cases(cs, "atrium_ivy_secondary", ivy, ivy_meta, so2, sd2, iseed)
    del ivy

    inst, inst_meta = atrium(instanced=True).compile(dev)
    ao, ad = camera(cs, "atrium-inst", dev)
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


def bench_rays(cs, dev):
    """chip_smoke 3b's 262,144 incoherent (a block of them retired) and
    coherent rays: (case, (o, d, t_max)) each."""
    import torch

    lanes = 262144
    for case, coherent in (("incoherent", False), ("coherent", True)):
        bo, bd = (torch.from_numpy(a).to(dev) for a in cs.make_rays(lanes, coherent))
        bt = torch.full((lanes,), 100.0, device=dev)
        if not coherent:
            bt[: 1 << 14] = -1.0
        yield case, (bo, bd, bt)


def b7_cases(cs, dev):
    """(name, (scene, meta, rays, w_key, act)) of chip_smoke.py phase 3l's
    B7a / B7b cases."""
    import torch

    big, big_meta = cs.big_scene(dev)
    for case, coherent in (("incoherent", False), ("coherent", True)):
        o, d = (torch.from_numpy(a).to(dev) for a in cs.make_rays(262144, coherent))
        for later in (False, True):
            rays, w_key, act, rnd = cs.b7_round(big, big_meta, o, d, later)
            yield f"bigscene_{case}_{'later' if later else 'round1'}", (big, big_meta, rays, w_key, act, rnd)


def b2_cases(cs, dev):
    """(name, (rays, clus_box, n_clus)) of B2's calls in chip_smoke.py's
    phases 3b-3f, rays in lane order as the block trace hands them over."""
    import torch

    from yart_tpu_torch.render import blocktrace
    from yart_tpu_torch.scene.procedural import material_test_spheres
    from yart_tpu_torch.scene.showcase import atrium

    def case(scene, meta, o, d, t_max):
        return blocktrace.ray_matrix(o, d, t_max), scene.clus_box, blocktrace.n_clus(meta)

    big, big_meta = cs.big_scene(dev)
    for name, rays in bench_rays(cs, dev):
        yield f"bigscene_{name}", case(big, big_meta, *rays)
    del big
    spheres, spheres_meta = material_test_spheres().compile(dev)
    so, sd = camera(cs, "spheres", dev)
    st = torch.full((so.shape[0],), 1e30, device=dev)
    yield "spheres_camera", case(spheres, spheres_meta, so, sd, st)
    t_hit, _, _, _, tri_hit, _, _ = blocktrace.intersect_blocktrace(spheres, spheres_meta, so, sd, st)
    yield "spheres_shadow", case(spheres, spheres_meta, *cs.shadow_rays(so, sd, t_hit, tri_hit >= 0))
    for name, kw in (("atrium_ivy", {"ivy": True}), ("atrium_inst", {"instanced": True})):
        sc, sc_meta = atrium(**kw).compile(dev)
        o, d = camera(cs, name.replace("_", "-"), dev)
        t = torch.full((o.shape[0],), 1e30, device=dev)
        yield f"{name}_camera", case(sc, sc_meta, o, d, t)
        h = blocktrace.intersect_blocktrace(sc, sc_meta, o, d, t)
        if name == "atrium_ivy":
            yield f"{name}_random_directions", case(sc, sc_meta, *cs.shadow_rays(o, d, h[0], h[4] >= 0))
        else:
            yield f"{name}_sun_shadow", case(sc, sc_meta, *cs.shadow_rays(o, d, h[0], h[4] >= 0, cs.SUN))
        del sc


def bintrace_layouts(scene, meta, o, d, t_max, rounds: int):
    """The pair layouts of intersect_bintrace's first `rounds` rounds for
    rays o, d, t_max (closest hit), made as its loop makes them."""
    import torch

    from yart_tpu_torch.render import bintrace, blocktrace

    n, dev, t_min, k = o.shape[0], o.device, 1e-3, meta.bintrace_k
    counts = blocktrace.cluster_counts(scene, meta)
    t = t_max.clone()
    w_e = torch.full((n,), -1.0, device=dev)
    w_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    done = t <= t_min
    for rnd in range(rounds):
        slots, n_col, bound_e, bound_id = bintrace.collect_clusters(scene, meta, o, d, t, t_min, w_e, w_id, ~done, k)
        yield rnd + 1, bintrace.pair_layout(scene, meta, slots, n_col, o, d, t)
        t2, _, _, _, _, got = bintrace.pairs_phase(scene, meta, slots, n_col, o, d, t, t_min, counts)
        t = torch.where(got & ~done, t2, t)
        done = done | (bound_e >= bintrace._BIG) | (t <= bound_e)
        w_e, w_id = bound_e, bound_id


def b4_cases(cs, dev):
    """(name, (scene, meta, compact layout)) of B4's cases."""
    import torch

    from yart_tpu_torch.render import bintrace
    from yart_tpu_torch.scene.showcase import atrium

    dense, dense_meta = atrium(density=3).compile(dev)
    do, dd = camera(cs, "atrium", dev)
    dt = torch.full((do.shape[0],), 1e30, device=dev)
    for rnd, lay in bintrace_layouts(dense, dense_meta, do, dd, dt, 2):
        yield f"atrium_dense_camera_round{rnd}", (dense, dense_meta, lay)
    h = bintrace.intersect_bintrace(dense, dense_meta, do, dd, dt)
    ro, rd, rt = cs.shadow_rays(do, dd, h.t, h.mask)
    for rnd, lay in bintrace_layouts(dense, dense_meta, ro, rd, rt, 1):
        yield "atrium_dense_random_directions_round1", (dense, dense_meta, lay)
    del dense
    big16, big16_meta = cs.big_scene(dev, cluster_size=16)
    bo, bd, bt = next(bench_rays(cs, dev))[1]
    for rnd, lay in bintrace_layouts(big16, big16_meta, bo, bd, torch.full_like(bt, 100.0), 1):
        yield "bigscene_c16_incoherent_round1", (big16, big16_meta, lay)


def prepare(kernel: str, cs, case, sources):
    """(record, ref, {source arg: callable launching it once}, equal)
    of one case: its bounds, the twin's output, and how each source runs
    and is compared with the twin."""
    import torch

    from yart_tpu_torch.kernels import clusterpairs, fusedtrace, presort
    from yart_tpu_torch.render import bintrace, blocktrace

    if kernel == "b1":
        from yart_tpu_torch.kernels import brute

        tri_pack, o, d, t_max, n_tris = case
        ref = brute.brute_plain(tri_pack, o, d, t_max, n_tris, 1e-3)
        rec = {"n_rays": int(o.shape[0]), "n_tris": int(n_tris), "live_rays": int((t_max > 1e-3).sum()),
               "hit_frac": float((ref[4] >= 0).float().mean())}
        rec["bound_ms"], rec["bound_by"] = cs.bound(*cs.b1_work(tri_pack, o, d, t_max, n_tris, ref))
        rec["nofma_floor_ms"] = cs.b1_floor_ms(t_max, n_tris)
        calls = {s.arg: brute.prepare(tri_pack, o, d, t_max, n_tris, 1e-3, fn=s.fn) for s in sources}
        return rec, calls, lambda out: all(cs.bits_equal(a, b) for a, b in zip(out, ref))
    if kernel == "b5":
        from yart_tpu_torch.kernels import shade

        inp, gates, mis, any_lights, tables = case
        ref = shade.shade_plain(inp, gates, mis, any_lights, tables)
        rec = cs.b5_record(inp, gates, mis, any_lights, tables)
        calls = {s.arg: shade.prepare_shade(inp, gates, mis, any_lights, tables, fn=s.fn) for s in sources}
        return rec, calls, lambda out: all(cs.bits_equal(out[k], ref[k].contiguous()) for k in ref)
    if kernel == "b6":
        from yart_tpu_torch.kernels import shade

        setup = shade.sampler_draw_setup(*case)
        n = int(setup.state.shape[0])
        ref = shade.draws_plain(setup, n)
        rec = {"n": n, "kind": setup.kind, **cs.b6_bound(setup, n)}
        calls = {s.arg: shade.prepare_draws(setup, n, fn=s.fn) for s in sources}
        return rec, calls, lambda out: all(cs.bits_equal(out[k], ref[k].contiguous()) for k in ref)
    if kernel in ("b7a", "b7b"):
        from yart_tpu_torch.kernels import blocktrace as legacy

        scene, meta, rays, w_key, act, rnd = case
        box, pack, c, k = scene.clus_box, scene.clus_pack, meta.cluster_size, cs.B7_K
        sel = legacy.select_clusters_plain(rays, box, w_key, act, k, 1e-3)
        rec = {"round": rnd, "live_blocks": int(act.sum())}
        if kernel == "b7a":
            rec.update(cs.b7a_bounds(rays, box, w_key, act, blocktrace.n_clus(meta), 1e-3, sel))
            calls = {s.arg: legacy.prepare_select(rays, box, w_key, act, k, 1e-3, fn=s.fn) for s in sources}
            return rec, calls, lambda out: all(torch.equal(a, b) for a, b in zip(out, sel))
        counts = blocktrace.cluster_counts(scene, meta)
        slots = blocktrace.round_slots(scene, sel[0], sel[2], act)
        ref = legacy.test_clusters_plain(rays, pack, *slots, c, k, 1e-3, counts)
        rec.update({"live_slots": int(slots[0].sum()), **cs.b7b_bounds(rays, slots, ref, counts, c)})
        calls = {s.arg: legacy.prepare_test(rays, pack, *slots, c, k, 1e-3, counts, fn=s.fn) for s in sources}
        return rec, calls, lambda out: cs.bits_equal(out, ref)
    if kernel == "b3":
        args = case
        ref = fusedtrace.fused_trace_plain(*args)
        rays, blive = args[0], args[5]
        rec = {"mode": fusedtrace.mode_name(args[7], args[8], args[9] is not None),
               "n_rays": int(rays.shape[0]), "live_rays": int((rays[:, 6] > 0).sum()),
               "live_blocks": int(blive.sum()), **cs.b3_bounds(args, ref, prefix="")}
        calls = {s.arg: (lambda fn=s.fn: fusedtrace.launch(*args, fn=fn)) for s in sources}
        return rec, calls, lambda out: cs.bits_equal(out, ref)
    if kernel == "b2":
        rays, box, n_clus = case
        ref = presort.presort_plain(rays, box, n_clus, 1e-3)
        rec = {"n_rays": int(rays.shape[0]), "n_clusters": n_clus, "live_rays": int((rays[:, 6] > 0).sum()),
               **cs.b2_bounds(rays, n_clus, ref, prefix="")}
        calls = {s.arg: (lambda fn=s.fn: presort.launch(rays, box, n_clus, 1e-3, fn=fn)) for s in sources}
        return rec, calls, lambda out: torch.equal(out, ref)
    scene, meta, lay = case
    c = meta.cluster_size
    counts = blocktrace.cluster_counts(scene, meta)
    args = (scene.clus_pack, counts, lay.tiles, lay.x, c, 1e-3)
    ref = clusterpairs.cluster_pairs_plain(*args)
    rec = {"cluster_size": c, **cs.b4_rows(lay), "pair_hit_frac": float((ref[4] >= 0).float().mean()),
           "pair_column_tests": cs.b4_tests(lay, counts)}
    rec["bound_ms"], rec["bound_by"] = cs.bound(*cs.b4_work(lay, c, counts))
    rec["nofma_floor_ms"] = cs.b4_floor_ms(lay, counts)
    calls, pos = {}, None
    cid_rows = torch.repeat_interleave(lay.tiles[:, 0], lay.tiles[:, 3].long(), output_size=lay.x.shape[0])
    for s in sources:
        if s.padded:
            padded = padded_layout(lay, scene.clus_first)
            pos = padded[4]
            calls[s.arg] = lambda fn=s.fn, p=padded: launch_padded(fn, scene.clus_pack, c, p, 1e-3)
        else:
            tiles = bintrace.tile_table(cid_rows, scene.clus_first, s.tile or clusterpairs.TILE)
            rec[f"tiles@{s.tile or clusterpairs.TILE}"] = int(tiles.shape[0])
            calls[s.arg] = lambda fn=s.fn, tl=tiles: clusterpairs.launch(scene.clus_pack, counts, tl, lay.x, c,
                                                                         1e-3, fn=fn)

    def equal(out):
        if out[0].shape[0] != lay.x.shape[0]:  # padded: its rows of the pairs
            out = [a[pos] for a in out]
        return all(cs.bits_equal(a, b) for a, b in zip(out, ref))

    return rec, calls, equal


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernel", choices=("b1", "b2", "b3", "b4", "b5", "b6", "b7a", "b7b"), required=True)
    ap.add_argument("--sass", default=None, help="directory for each build's SASS and its loop counts")
    ap.add_argument("--rounds", type=int, default=1, help="rounds of turns (each A B .. B A)")
    ap.add_argument("sources", nargs="+", help="kernel sources (.cu), B4's with an optional @TILE")
    args = ap.parse_args(argv)
    sources = [Source(a, args.kernel) for a in args.sources]
    if any(not s.path.endswith(".cu") for s in sources):
        raise SystemExit("sources must be .cu files")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels measures the card: it needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    paths = sorted({s.path for s in sources})
    with ThreadPoolExecutor(len(paths)) as pool:
        built = dict(zip(paths, pool.map(build_source, paths)))
    for s in sources:
        s.lib, s.ptxas, _ = built[s.path]
        s.bind(args.kernel)
    head = {"device": cs.nvidia_smi(), "kernel": args.kernel, "sources": args.sources,
            "ptxas": {p: b[1] for p, b in built.items()}, "build_s": {p: b[2] for p, b in built.items()}}
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        head["sass"] = {p: sass_loops(b[0], os.path.join(args.sass, f"{i}_{os.path.basename(p)}.sass"))
                        for i, (p, b) in enumerate(built.items())}
    print(json.dumps(head), flush=True)
    turns = (list(range(len(sources))) + list(reversed(range(len(sources))))) * args.rounds
    gen = {"b1": lambda cs, dev: ((n, a) for n, a, _ in cs.b1_cases(dev)),
           "b2": b2_cases, "b3": b3_cases, "b4": b4_cases, "b7a": b7_cases, "b7b": b7_cases,
           "b5": lambda cs, dev: ((n, a) for n, a, _ in cs.b5_cases(dev, twin=True)),
           "b6": lambda cs, dev: ((n, a) for n, a, _ in cs.b6_cases(dev))}[args.kernel](cs, dev)
    for name, case in gen:
        rec, calls, equal = prepare(args.kernel, cs, case, sources)
        per = {s.arg: {"bitwise_equal": bool(equal(calls[s.arg]())), "ms": []} for s in sources}
        for i in turns:
            per[sources[i].arg]["ms"].append(cs.cuda_ms(calls[sources[i].arg], reps=CASE_REPS))
        for p in per.values():
            p["ms_mean"] = sum(p["ms"]) / len(p["ms"])
        print(json.dumps({"case": name, **rec, "sources": per}), flush=True)
        del case, calls
    return 0


if __name__ == "__main__":
    sys.exit(main())
