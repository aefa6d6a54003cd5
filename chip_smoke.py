"""On-card smoke test of the PyTorch + CUDA port (yart_tpu_torch).

    python3 chip_smoke.py            # needs one CUDA GPU (an H100 for sm_90a)

Phases, each printing one JSON line; any failure raises, so the script
exits non-zero and prints no final "ok" line:
  1. device  — require CUDA; print the card's name and power limit.
  2. build   — build every kernel of the render paths from csrc/ (nvcc)
               and the host libraries from csrc/host/ (g++: the scene
               builder's binned-SAH BVH build and its BVH8 collapse, the
               JPEG decoder's scan decoder), one compiler per library, all
               started together.
  3. kernel  — B1 (brute-force intersection) against its plain PyTorch twin
               on the card, bitwise, at cornell-mat's triangles with 2^20
               camera rays and at a seeded 4096-triangle soup with 2^20
               random rays (+ a ragged N and retired t_max = -1 lanes),
               and at its edges (`b1_cases`: T = 0, 1, 255, 256, 257 and
               4096 at 2^16 + 77 rays, equal-t ties, NaN and zero
               directions, det at +-1e-12); median times of the launch
               alone from CUDA events (the wrapper's once beside them),
               with the bound and the no-FMA floor.
  3b. kernel — B2 (presort) and B3 (fused trace) against their twins,
               bitwise, on the bench's big scene (60 seeded spheres,
               132,480 triangles, clusters of 128, built by the port's own
               builder) with 262,144 incoherent and coherent rays (+ a
               block of retired lanes and a ragged N through the whole
               block trace); median times from CUDA events, and B3's
               two bounds (`b3_bounds`: over the work its inputs need,
               and over a sweep of every box by every live ray).
  3c. kernel — B2 and B3 against their twins, bitwise, at the spheres
               render's shapes: 2^20 camera rays from the CLI's camera
               (closest hit), then shadow rays from their hits as any-hit
               queries (nee) with a finite t_max. This case gives the
               kernels line its times and bounds.
  3d. kernel — B3 in its alpha-mask (`amask`) mode against its twin,
               bitwise, on the port-built atrium-ivy (127,972 triangles,
               alpha-tested ivy, built and timed here on the host): cast 0
               is 2^20 camera rays from the CLI's camera, cast 1 re-casts
               the lanes whose first hit the alpha gate passed through,
               with floor = that hit, reusing cast 0's order and slots as
               the gated loop does. B2 on these rays against its twin too,
               and on rays leaving their hits in random directions, in
               lane order (a later bounce's rays, which a block's cull
               cannot thin). Each timed B2 record has two bounds
               (`b2_bounds`: over the work its inputs need, and over a
               sweep of every box by every live ray). The scene's
               triangle BVH and BVH8 come from the host library
               (`native_tree_check`: the tree built again and checked, its
               leaf order a permutation, its leaves covering every
               triangle once, every box the union of its children's, and
               the compiled tables holding it; the builder's SAH build and
               collapse seconds), and the same scene is built from the
               numpy twins (their seconds; rendered beside it in 4f).
  3e. gated  — the gated re-cast loop (intersect_blocktrace_gated), kernel
               path against twin path bitwise, on 2^16 atrium-ivy camera
               rays and on shadow rays from their hits (nee), with the
               active count of every cast.
  3j. kernel — B6 (the bounce's 8 sampler draws) against its twin (the
               sampler's own ops/qmc.py draws), bitwise on all 8 outputs, at
               2^20 lanes of a 512x512 render's first chunk at bounce 0
               and 3 (dim0 = 4, 28): ZSobol at 16 spp (even log2spp) and 8
               spp (odd: the pow2_samples branch), hash; a ragged 1000;
               timed (the launch alone; the wrapper's once beside it),
               with its bound (INT32 operations).
  3k. kernel — B5 (the fused shade tail) against its twin
               (shade_math.shade), bitwise on every output and lane, on
               the lanes of a real depth-1 bounce of cornell-mat and
               atrium-ivy (2^20) and of roadster (2^16; metallic,
               transmissive and clearcoat gates on; built here), on 2^20
               random lanes with all four gates on (also with mis off and
               with no lights), on 2^16 with whole dead blocks, and at the
               edges of its tiles (`b5_cases`: tiles of one lobe, the four
               lobes interleaved lane by lane, dead tiles, n = 1, 127, 129
               and 2^20 + 77, inputs with a storage offset); each record
               with its lobe mix (lanes per lobe, mixed warps before and
               after grouping); timed (the launch alone; the wrapper's
               once beside it), with its bound (bytes).
  4. render  — the earlier main paths: Renderer on cuda, cornell-mat
               512x512, 16 spp (`--spp`), max depth 30, ZSobol, GMoN, AgX, in the
               CLI's waves; B1's launch count must be > 0 and the plain twin
               must not have run on CUDA.
  4b. render — the same for `spheres` (14,402 triangles, env-lit, the
               CLI's camera): every ray goes through B2 and B3.
  3f. kernel — B3 in its instanced mode against its twin, bitwise, on the
               port-built atrium-inst (124,972 virtual triangles, 95
               instances of 41 prototypes; every ray goes through the
               instanced mode): 2^20 camera rays from the CLI's camera
               (closest hit), then their sun shadow rays (nee); B2 over the
               instance-cluster boxes against its twin on both. Counts of
               tested (ray, cluster) and (ray, triangle) pairs and the
               bound; this case gives the kernels line its B2 and B3 times.
  3g. gated  — B3 instanced + `amask` against its twin, bitwise, on the
               port's small gated instanced scene (`instanced_leaves`:
               alpha-tested leaf quads under rotated, non-uniformly scaled
               transforms, a glass pane instance, a baked floor), cast 0 and
               a floored cast 1; the gated loop there, kernel path against
               twin path, for camera and shadow rays.
  3h. kernel — B4 (bin-trace's pair test) against its twin, bitwise on
               t/u/v/back/tri, at round 1's collect and pair layout of 2^20
               camera rays on the dense atrium (atrium(density=3): 1,094,508
               triangles, 12,079 clusters) and of 262,144 incoherent rays on
               the bench scene at C = 16 (11,866 clusters), both built here
               on the host first (their seconds are reported); times, bound
               and no-FMA floor, tiles and live pairs, rounds and collect
               iterations; B4 must touch no row that is not a live pair
               (rows touched == live pairs; the parent layout's padded rows
               are reported beside).
  3i. bintrace — intersect_bintrace, kernel path against twin path, bitwise
               on every Hit field and on rounds and collect iterations, at
               2^16 dense-atrium camera rays and their sun shadow rays (nee).
  4c. render — atrium-ivy 512x512, depth 30, +3 EV, 16 spp: B2 and B3 in
               `amask` mode must launch, no twin may run on CUDA; casts per
               gated call are reported.
  4d. render — atrium-inst 512x512, depth 30, +3 EV, 16 spp: B2 and B3 in
               the instanced modes (closest, nee) must launch and B3 in no
               other mode, no twin may run on CUDA; the host's scene build
               seconds are reported.
  4e. render — this slice's main path: the dense atrium 512x512, depth 30,
               +3 EV, 4 spp (DENSE_SPP), through bin-trace: B4 must
               launch and B1, B2 and B3 must not; rounds per call and
               collect iterations per round, the host build seconds.
  4f. render — this slice's main path: cornell-mat and atrium-ivy
               512x512, 16 spp, depth 30 with shade_kernel="pallas": B5 and
               B6 must launch once per bounce, no twin on CUDA, the
               intersection kernels' counts beside phase 4/4c's "off"
               renders; against "off" at _assert_images_equivalent's bar
               (tests/test_shade_kernel.py:209-222) at the 4 spp and depth
               4 where that test sets it, that bar's numbers at 16 spp,
               depth 30. Then the numpy twins' atrium-ivy of 3d at the
               same settings: its channel means within 2% of the
               host-library build's render, and the share of pixels
               equal bitwise.
  5. reference — the golden_v1 cornell_mat_64 and spheres_dof
               configurations: the kernel path's image must equal the
               plain-twin path's bitwise, and its per-channel mean must
               lie within 2% of the golden's; golden_v1 `textured` from the
               port-built textured_box_scene (gated brute, no kernel) within
               2%; small atrium-ivy, atrium-inst and dense-atrium (32x32)
               renders (2 spp, depth 4), kernel path == twin path bitwise;
               atrium-inst against the baked atrium at
               64x64, 16 spp (channel means within 0.5%, >= 98% of pixels
               within rtol/atol 2e-2: tests/test_instancing.py's bar);
               cornell-mat, atrium-ivy and roadster at 64x64, 2 spp, depth
               4 with shade_kernel="pallas" equal bitwise to "xla".
  3l. legacy — this slice's main path, the round-based block trace
               (intersect_blocktrace(fused=False): B7a select_clusters and
               B7b test_clusters) on the bench scene (C = 128): B7a and B7b
               bitwise against their twins at 262,144 incoherent and
               coherent rays, at round 1 and at the first later round with
               converged blocks, timed (the launch alone), with their
               bounds and no-FMA floors (B7a's over the pairs its rays
               enter and a bundle test per block and box, `b7a_bounds`,
               and over the first design's sweep beside them), B7a's live
               rays, kept boxes and live keys per block and B7b's columns
               tested beside C x live slots; the whole cast at
               262,144 rays with every count set to 0 just before and read
               just after (B7a and B7b once per round, no twin, no B2/B3),
               converged within 512 rounds (the blocks the JAX default of 64
               leaves active reported), against the fused path (masks
               equal, t bitwise, tri equal but on ties, u/v/back where tri
               agrees), both walls; the kernel path against the twin path,
               bitwise with equal rounds, at 2^16 rays (closest, nee, a
               floored re-cast) and the gated loop with fused=False on
               atrium-ivy's 2^16 camera rays. No render of phases 4-4f
               may launch B7a or B7b.
  6. fwdbwd — the differentiable path (`render_wave(differentiable=True)`
               and the backward of the mean radiance) at bench.py's fwd+bwd
               shapes, each record with the card's name and power limit:
               6a cornell-mat 256x256, 8 spp (524,288 lanes), depth 6,
               roulette off, w.r.t. base_color, each remat policy
               ("trace_lut", "trace", "all") with shade "off" and "xla";
               6b atrium-ivy 128x128, 4 spp, depth 6, compaction (4, 2),
               w.r.t. base_color and the rgba atlas the alpha gate reads
               (B2 + B3 amask); 6c atrium 128x128, 4 spp, depth 8,
               roulette on, compaction "auto", w.r.t. base_color and the
               env image; 6d roadster 128x128, 4 spp, depth 6, compaction
               (2, 4), w.r.t. base_color, clearcoat and volume density;
               6e atrium-inst 128x128, 2 spp, depth 4, w.r.t. the
               prototype vertices (`proto_pos`, B3 instanced); 6f the
               inverse render of tests/test_inverse.py at 64x64, 4 spp
               (60 Adam steps: loss down > 95%, the wall within 0.05, the
               frozen rows untouched); and atrium-ivy at 512x512, 4 spp
               (2^20 lanes), depth 8, roulette on, "trace_lut". Each
               records the forward-only and the fwd+bwd wall (the last of
               two runs), Mrays/s over the rays the forward counts, their
               ratio, peak memory and B1-B3's launches in the forward and
               the backward. Raises unless the gradients are finite and
               non-zero, the traversal kernels launched in every forward
               and none in a backward, the differentiable forward equals
               the plain render bitwise (6e: the refit's image on
               average), the remat policies agree (radiance bitwise,
               gradients within GRAD_REL_TOL of the largest entry), and,
               in 6a, 6b and 6e, the kernel path agrees with the twin
               path likewise (6b at 8x8, 4 spp and 6e at 16x16, 2 spp:
               B2's and B3's twins are slow on the card).
  7. stack  — the stack traversals and the per-instance loop
               (`stack_phases`): 7a atrium(ivy=True, density=3) built on
               the host (1,103,508 triangles, 14,044 clusters: gated past
               the cap; BVH8 depth, groups, leaves at triangle >= 2^20,
               the SAH build and BVH8 collapse seconds, the host library's
               tree checked by `native_tree_check`), 2^20 camera rays
               from the CLI's camera and their sun shadow rays through
               `intersect_bvh_sorted` (after a warm-up cast of 2^17), with
               every count set to 0 just before: no kernel launch, the
               iterations and the working set at each host check, the
               wall; 4,096 lanes of each (half on triangles >= 2^20) held
               against the gated brute on the card (masks exact, t, u, v
               bitwise where the triangle agrees, other triangles only on
               ties in t, unoccluded attenuation within rtol 1e-4 / atol
               1e-5); 7b its render at 256x256, 4 spp, depth 8 with
               shade_kernel="pallas" (B5 and B6 once per bounce, no
               B1-B4/B7), and "pallas" against "off" at 64x64, 2 spp,
               depth 4 at _assert_images_equivalent's bar; 7c
               atrium(density=3, instanced=True) built on the host (95
               instances, 12,055 instance clusters), the per-instance
               loop's kernel path against its twin path bitwise on every
               Hit field at 2^16 camera rays and their sun shadow rays
               (B1/B2/B3 launches a cast), and its render at 256x256, 4
               spp, depth 8 with channel means within 0.5% of the baked
               dense atrium's (phase 3h's scene, bin-trace) at the same
               camera and settings.
  8. scene files — (`scene_file_phases`, after phase 7) scenes written by
               the port's exporters to a temporary directory and rendered
               through `yart_tpu_torch.cli.main` on the card: 8a atrium-ivy
               as a GLB (`export_glb`) with its sky as Radiance HDR
               (`export_env_hdr`), `scene.glb --env-hdr sky.hdr` at
               512x512, 16 spp, depth 30, +3 EV, the CLI's atrium camera,
               `--shade-kernel pallas`: B2, B3 `amask`, B5 and B6 (once a
               bounce) launch, no twin on CUDA, channel means within 2% of
               phase 4f's procedural "pallas" render (the export, load and
               compile host seconds, the render's wall, Mrays/s, peak
               memory and launches); 8b the compiled atrium-inst builder
               as a GLB of one mesh per prototype and a node with a
               `matrix` per instance (`export_glb_instanced`), loaded back
               as prototypes and instances, rendered through the CLI at
               128x128 (cut from 256x256 for the script's limit), 4 spp,
               depth 8: B2 and B3's instanced modes launch, means within
               2% of the procedural atrium-inst at the same settings; 8c
               kernel path == twin path bitwise at 2 spp on the GLB scenes
               of 8a (16x16, depth 2), 8b (16x16, depth 4) and cornell-mat
               (B1; 32x32, depth 4); the host seconds of decoding a
               2048x2048 RGBA PNG with every row Paeth-filtered; 8d
               (after 8a) every JPEG fixture of tests/data/jpeg decoded
               by `io/jpeg.py` (its C++ scan decoder built with g++) to
               the SHA-256 of PIL's decode in the manifest, PIL never
               imported, and the host seconds of each; 8a's GLB with the
               eight opaque atrium textures swapped for their JPEG
               fixtures (the ivy leaf stays PNG) through the CLI at 8a's
               settings: B2, B3 `amask`, B5 and B6 (once a bounce), means
               within 2% of 8a's; the host seconds of the decoder's numpy
               stages on a 2048x2048 4:2:0 image.
  9. application layer — (`app_layer_phases`, after phase 8) 9a
               atrium-ivy at 512x512, `--spp`, depth 30, +3 EV, "pallas"
               over two ranks spawned on the one card with backend gloo,
               each loading the compiled scene the parent saved as CPU
               tensors and warming up at 64x64: the image and the ray count
               bitwise to phase 4f's one-process render, each rank's wall,
               its own rays and
               Mrays/s and its B2 / B3 amask / B5 / B6 launches (B5 = B6 =
               bounces); 9b `cli.main([... "--devices", "all"])`, one NCCL
               rank on the one card, bitwise to the same render without
               --devices; 9c cornell-mat at 128x128 through `cli.main`
               with --config (the file sets spp and size, an explicit
               --seed wins), --preview, --serve 0 (/status and /frame.png
               fetched over loopback as each frame is pushed), --profile
               (the chrome trace names B1's and B5's kernels) and
               --debug-nan (passes), then the same render with the
               estimate forced to NaN, which must raise FloatingPointError;
               9d cornell-mat at 32x32, 2 spp, depth 4, "pallas" with each
               sampler B6 does not draw (stratified, zsobol:null,
               zsobol:binary, zsobol:owen): kernel path == twin path
               bitwise (B1, B5 and B6 on their twins), B6 never launched,
               B5 once a bounce.
The kernels line lists B1-B7b with their launches on the main paths (B1:
cornell-mat; B2, B3: atrium-inst, with B3's launches per mode, and the
earlier paths' beside them; B4: the dense atrium; B5, B6: cornell-mat
with "pallas", atrium-ivy beside it; B7a, B7b: the incoherent round-based
cast of 3l, the coherent one beside it; B1-B3 also per phase-6 case,
forward and backward, and per cast of the per-instance loop (7c); B5, B6
also on the dense ivy atrium's render, 7b; B1-B3, B5 and B6 also on the
scene files of phase 8; B1, B2, B3, B5 and B6 also per phase-9 case,
each rank's in 9a), times and bounds; then the card as
nvidia-smi reports it; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
GOLDEN = os.path.join(ROOT, "tests", "goldens", "golden_v1.npz")
GOLDEN_MEAN_RTOL = 0.02  # statistical: the port's own scene has another triangle order
# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores and HBM bandwidth; the bound of a kernel is the larger of its
# operations over the first and its bytes over the second.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
FLOPS_MT = 40  # B1: one Moller-Trumbore ray-triangle test
FLOPS_SLAB = 24  # B2 and B3's sweep: one conservative ray-box slab test with margins
FLOPS_PLANE = 30  # B3 and B7b: one plane + barycentric ray-triangle test
# B7a: one ray-box slab test without margins (6 multiplies, 6 subtracts, 6
# min/max per axis pair, 4 across axes, the t_min max, 3 compares and the
# running minimum over the block's rays).
FLOPS_SELECT = 27
# B7a as the bitwise contract builds it (--fmad=false): the same 27 float
# instructions a (ray, box) test, each issued alone (no FMA pairs them), at
# one instruction a lane a clock: the reachable floor beside B7a's bound.
INSTR_SLAB_NOFMA = 27
B7_K = 24  # the round-based path's default slots per block and round
# B3 amask: the alpha-mask bit test (2 multiplies, 4 clamps, index, shift),
# counted on the candidates that run it (B3's output column 7).
FLOPS_AMASK = 6
# B3 instanced: the ray's transform into the prototype's object space per
# tested (ray, instance cluster): 9 multiplies + 9 adds for o, 9 + 6 for d.
FLOPS_XFORM = 33
# B5: float operations per live lane, a lower count from shade.cu (frames
# and VNDF sampling ~150, one lobe's sample ~120, 13 LUT lerps ~200, the
# NEE f and pdf of up to four lobes ~400, the update and roulette ~60;
# a transcendental counted once).
FLOPS_SHADE = 900
# B4 as the bitwise contract builds it (--fmad=false): per (pair, column) 37
# float instructions issued alone (six 3-term dot products: 18 multiplies,
# 12 adds; t's subtract; u and v a multiply, an add and a subtract each)
# and ~8 for the IEEE division (reciprocal, refinement, quotient, its
# correction and range check), at one instruction a lane a clock: 128
# lanes x 132 SMs x 1.98 GHz. The reachable floor beside B4's bound.
INSTR_PLANE_NOFMA = 45
PEAK_FP32_INSTR = 132 * 128 * 1.98e9
# B1 likewise, per (ray, triangle) Moller-Trumbore test: pvec 9 (6
# multiplies, 3 subtracts), det 5, the two |det| tests and the select 3,
# the IEEE reciprocal ~8, b 3, u 6, qvec 9, v 6, t 6, the six range tests
# with u + v 7 and their combination 2, the five-way update 5.
INSTR_MT_NOFMA = 69
INSTANCED_MEAN_RTOL = 5e-3  # instanced vs baked atrium (tests/test_instancing.py:120-136)
INSTANCED_PIXEL_TOL = 2e-2
INSTANCED_PIXEL_SHARE = 0.98
DENSE_SPP = 4  # samples per pixel of the dense atrium render (phase 4e; 16 until phase 7 came)
# How the plain twins that take seconds are timed (`timed_call`): not
# comparable with the warm medians taken before phase 7 came.
PLAIN_ONE_CALL = "one cold call, the one held against the kernel"
B3_KEYS = ("b3_ms", "b3_plain_ms", "b3_bound_ms", "b3_bound_by", "b3_sweep_bound_ms")  # B3's timed records
B2_KEYS = ("b2_ms", "b2_plain_ms", "b2_bound_ms", "b2_bound_by", "b2_sweep_bound_ms")  # B2's timed records
B4_ROWS = ("tiles", "live_pairs", "rows_touched", "parent_layout_rows")  # B4's layout records
B1_KEYS = ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by", "nofma_floor_ms")  # B1's timed records
B5_KEYS = ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")  # B5's timed records
SUN = (0.45, 0.72, 0.3)  # the sun direction of the shadow-ray cases (unnormalised)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warmup_s: float = 0.25, warmup_calls: int = 2) -> float:
    """Median milliseconds of fn() from CUDA events, after at least
    `warmup_calls` warm-up calls and `warmup_s` seconds of them (so the
    clocks have ramped up before a sub-millisecond kernel is timed)."""
    import torch

    calls, t_end = 0, time.perf_counter() + warmup_s
    while calls < warmup_calls or time.perf_counter() < t_end:
        fn()
        torch.cuda.synchronize()
        calls += 1
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def timed_call(fn):
    """(fn(), its milliseconds from CUDA events) of one call: how the plain
    twins that take seconds are timed, on the call whose result the kernel
    is held against (a warm-up call would double their cost)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bits_equal(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
    return bool(torch.equal(a, b))


def b1_work(tri_pack, o, d, t_max, n_tris, out):
    """(flops, bytes) of a B1 call: one test per (live ray, triangle);
    each input read once and each output written once."""
    live = int((t_max > 1e-3).sum())
    return FLOPS_MT * live * n_tris, nbytes(tri_pack[:n_tris], o, d, t_max, *out)


def b1_floor_ms(t_max, n_tris) -> float:
    """B1's no-FMA issue floor: INSTR_MT_NOFMA instructions a (live ray,
    triangle) test at the card's FP32 issue rate."""
    return int((t_max > 1e-3).sum()) * n_tris * INSTR_MT_NOFMA / PEAK_FP32_INSTR * 1e3


def compare_brute(name, tri_pack, o, d, t_max, n_tris, timed: bool = False):
    """Kernel vs plain twin on the same card tensors; raises on any bit
    difference. Timed: the launch alone (`brute.prepare`) and, once, the
    whole wrapper. Returns the phase record."""
    import torch

    from yart_tpu_torch.kernels import brute

    k = brute.brute_cuda(tri_pack, o, d, t_max, n_tris, 1e-3)
    p = brute.brute_plain(tri_pack, o, d, t_max, n_tris, 1e-3)
    torch.cuda.synchronize()
    fields = ("t", "u", "v", "back", "tri")
    diff = [f for f, a, b in zip(fields, k, p) if not bits_equal(a, b)]
    hit = k[4] >= 0
    err = max(float((a[hit] - b[hit]).abs().max()) if hit.any() else 0.0
              for a, b in zip(k[:3], p[:3]))
    if diff:
        raise AssertionError(f"{name}: kernel and plain twin differ in {diff} (max abs {err})")
    rec = {"case": name, "n_rays": int(o.shape[0]), "n_tris": int(n_tris),
           "hit_frac": float(hit.float().mean()), "bitwise_equal": True, "max_abs_err": err}
    if timed:
        rec["ms"] = cuda_ms(brute.prepare(tri_pack, o, d, t_max, n_tris, 1e-3), reps=21)
        rec["wrapper_ms"] = cuda_ms(lambda: brute.brute_cuda(tri_pack, o, d, t_max, n_tris, 1e-3), reps=21)
        rec["plain_ms"] = cuda_ms(lambda: brute.brute_plain(tri_pack, o, d, t_max, n_tris, 1e-3), reps=3)
        rec["bound_ms"], rec["bound_by"] = bound(*b1_work(tri_pack, o, d, t_max, n_tris, k))
        rec["nofma_floor_ms"] = b1_floor_ms(t_max, n_tris)
    return rec


def b1_soup(rng, n_tris: int, n_rays: int, dev, spread: float = 0.15):
    """A seeded soup of `n_tris` triangles around [-2, 2]^3 and `n_rays`
    rays from [-3, 3]^3 towards [-1.5, 1.5]^3: (tri_pack, o, d, t_max)."""
    import numpy as np
    import torch

    centers = rng.uniform(-2, 2, (max(n_tris, 1), 1, 3))
    soup = np.zeros((max(n_tris, 1), 12), np.float32)
    soup[:, :9] = (centers + rng.normal(0, spread, (max(n_tris, 1), 3, 3))).reshape(-1, 9)
    ro = rng.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    rd = rng.uniform(-1.5, 1.5, (n_rays, 3)).astype(np.float32) - ro
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tm = np.full(n_rays, 1e30, np.float32)
    return [torch.from_numpy(a).to(dev) for a in (soup, ro, rd, tm)]


def b1_cases(dev, cornell=None):
    """(name, (tri_pack, o, d, t_max, n_tris), timed) of phase 3: B1 at
    cornell-mat's 36 triangles with 2^20 camera rays (`cornell`: its
    compiled (scene, meta), else built here) and at a seeded 4096-triangle
    soup with 2^20 random rays (a block retired, t_max = -1) and a ragged
    1000 of them, all timed but the last; then the edges of the kernel's
    tiles and resident set at 2^16 + 77 rays (not a multiple of a tile):
    T = 0, 1, 255, 256, 257 and 4096; triangles repeated at several
    indices (equal t: the lowest index wins); NaN and zero directions; and
    det at exactly +-1e-12 and just inside it."""
    import numpy as np
    import torch

    from yart_tpu_torch.config import CameraConfig
    from yart_tpu_torch.kernels import brute
    from yart_tpu_torch.scene.procedural import cornell_box

    scene, meta = cornell or cornell_box(extra_materials=True).compile(dev)
    o, d = camera_rays(CameraConfig(image_size=(1024, 1024), focal_length=28.0,
                                    position=(0, 1.0, 3.4), forward=(0, 0, -1)), dev)
    yield "cornell_mat_camera", (scene.tri_pack, o, d, torch.full((o.shape[0],), 1e30, device=dev), meta.n_tris), True
    rng = np.random.default_rng(1234)
    soup, ro, rd, tm = b1_soup(rng, brute.MAX_TRIS, 1 << 20, dev)
    tm[: 1 << 16] = -1.0  # a block of retired lanes
    yield "soup_4096", (soup, ro, rd, tm, brute.MAX_TRIS), True
    yield "soup_4096_ragged_1000", (soup, ro[-1000:], rd[-1000:], tm[-1000:], brute.MAX_TRIS), False

    n = (1 << 16) + 77
    for n_tris in (0, 1, 255, 256, 257, brute.MAX_TRIS):
        tri, eo, ed, et = b1_soup(np.random.default_rng(n_tris), n_tris, n, dev, spread=0.3)
        et[: n // 10] = -1.0
        yield f"edge_T{n_tris}_n{n}", (tri, eo, ed, et, n_tris), False
    tri, eo, ed, et = b1_soup(np.random.default_rng(7), 300, n, dev, spread=0.3)
    tri = torch.cat([tri[:100], tri[:100], tri[100:]])  # triangles 0-99 again at 100-199
    yield "edge_ties_repeated_triangles", (tri.contiguous(), eo, ed, et, tri.shape[0]), False
    ed = ed.clone()
    ed[::7] = float("nan")
    ed[3::7] = 0.0
    ed[5::7, 1] = float("nan")
    yield "edge_nan_and_zero_directions", (tri.contiguous(), eo, ed, et, tri.shape[0]), False
    # det = e1 . (d x e2) with d = +z, e2 = +y is -e1.x: triangles whose e1.x
    # is +-1e-12 (float32) and the float next to it inside, each hit head-on.
    ex = np.float32(1e-12)
    e1x = np.array([ex, -ex, np.nextafter(ex, np.float32(0)), -np.nextafter(ex, np.float32(0))], np.float32)
    dt = np.zeros((4, 12), np.float32)  # p0 = (0, 2j, 0)
    dt[:, 1] = [0.0, 2.0, 4.0, 6.0]
    dt[:, 3] = e1x  # p1 = p0 + (e1x, 0, 1)
    dt[:, 4] = dt[:, 1]
    dt[:, 5] = 1.0
    dt[:, 7] = dt[:, 1] + 1.0  # p2 = p0 + (0, 1, 0)
    do = np.zeros((4 * 64, 3), np.float32)
    do[:, 1] = np.repeat(dt[:, 1], 64) + np.tile(np.linspace(-0.2, 1.2, 64, dtype=np.float32), 4)
    do[:, 2] = -1.0
    dd = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (4 * 64, 1))
    yield "edge_det_1e-12", tuple(torch.from_numpy(a).to(dev) for a in (dt, do, dd)) + (
        torch.full((4 * 64,), 1e30, device=dev), 4), False


def big_scene(dev, cluster_size: int = 128):
    """tools/perf_trace.py:31-43 `build_scene(60, 128)`, the bench's big
    scene, built by the port's builder (with `cluster_size` 16 it has 11,866
    clusters, past the block trace's cap: a bin-trace scene)."""
    import numpy as np

    from yart_tpu_torch.scene.builder import SceneBuilder
    from yart_tpu_torch.scene.procedural import uv_sphere

    rng = np.random.default_rng(7)
    b = SceneBuilder()
    m = b.add_material(roughness=0.4)
    for _ in range(60):
        c = rng.uniform(-6, 6, size=3)
        r = rng.uniform(0.4, 1.2)
        pos, nrm, tri = uv_sphere(c, r, n_theta=24, n_phi=48)
        b.add_mesh(pos, tri, m, normals=nrm)
    return b.compile(dev, cluster_size=cluster_size)


def make_rays(n: int, coherent: bool):
    """tools/perf_trace.py:46-57 (the rays of bench.py's bigscene rows)."""
    import numpy as np

    rng = np.random.default_rng(11)
    if coherent:
        o = np.tile(np.asarray([[0.0, 0.0, 20.0]], np.float32), (n, 1))
        xy = rng.uniform(-0.45, 0.45, size=(n, 2))
        d = np.concatenate([xy, -np.ones((n, 1))], axis=1).astype(np.float32)
    else:
        o = rng.uniform(-8, 8, size=(n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def camera_rays(cam_cfg, dev, seeds: bool = False):
    """One ZSobol-jittered camera ray per pixel of the square image of
    `cam_cfg`, as a render's first bounce makes them; with `seeds` also
    each lane's alpha-test seed of bounce 0."""
    import torch

    from yart_tpu_torch.ops.qmc import make_sampler
    from yart_tpu_torch.render.camera import build_camera, generate_rays

    side = cam_cfg.image_size[0]
    cam = build_camera(cam_cfg, dev)
    yy, xx = torch.meshgrid(torch.arange(side, device=dev), torch.arange(side, device=dev), indexing="ij")
    px, py = xx.reshape(-1), yy.reshape(-1)
    sampler = make_sampler("zsobol", 1, (side, side), device=dev)
    state = sampler.init_lanes(px, py, torch.zeros_like(px))
    o, d = generate_rays(cam, px, py, sampler.get2d(state, 0), sampler.get2d(state, 2))
    if seeds:
        return o.contiguous(), d.contiguous(), sampler.lane_seed(state)
    return o.contiguous(), d.contiguous()


def b3_bounds(args, out, prefix: str = "b3_") -> dict:
    """Both bounds of one B3 call with `fused_trace`'s arguments `args` and
    output `out`, counted from this call's data in every mode alike.
    `bound_ms` counts the work the inputs need, read from the output
    columns the kernel must equal its twin's: the plane tests (column 6),
    the mask tests (column 7), one ray transform per tested instance
    cluster and one slab test per (ray, cluster it tested) (column 5), and
    one box test per (live block, box). `sweep_bound_ms` counts, instead of
    the last two, the sweep of a kernel with one thread a ray: every live
    ray of a live block slab-tests all n_clus boxes (with `nee`, a ray
    that hit counts the clusters it tested), as PERF.md's earlier B3
    bounds do. The bytes are
    each input read once and the output written once."""
    import torch

    from yart_tpu_torch.render import blocktrace

    rays, n_clus, blive, nee, inst = args[0], args[4].shape[0], args[5], args[7], args[9]
    live = (rays[:, 6] > 0) & (blive.repeat_interleave(blocktrace.BLOCK) != 0)
    hit = out[:, 4].contiguous().view(torch.int32) >= 0
    tested = out[:, 5].double()
    sweep = float((live & ~hit).sum() if nee else live.sum()) * n_clus
    if nee:
        sweep += float(tested[live & hit].sum())
    slab = float(tested.sum()) + float(blive.sum()) * n_clus
    flops = FLOPS_PLANE * float(out[:, 6].double().sum()) + FLOPS_AMASK * float(out[:, 7].double().sum())
    if inst is not None:
        flops += FLOPS_XFORM * float(tested.sum())
    nb = nbytes(*args[:6], *(inst or ()), out)
    rec = {f"{prefix}slab_tests": slab, f"{prefix}sweep_slab_tests": sweep}
    rec[f"{prefix}bound_ms"], rec[f"{prefix}bound_by"] = bound(flops + FLOPS_SLAB * slab, nb)
    rec[f"{prefix}sweep_bound_ms"], rec[f"{prefix}sweep_bound_by"] = bound(flops + FLOPS_SLAB * sweep, nb)
    return rec


def b2_bounds(rays, n_clus: int, pk, prefix: str = "b2_") -> dict:
    """Both bounds of one B2 call on `rays` with output `pk`. `bound_ms`
    counts the work the inputs need: one box test per (128-lane block with
    a live ray, box) and one slab test per (ray, box it enters), the sum of
    output column 5. `sweep_bound_ms` counts a slab test per (live ray,
    box), the sweep of the earlier one-thread-a-ray kernel. The bytes are the rays, the boxes
    and the output, each once."""
    import torch

    live = rays[:, 6] > 0
    blocks = int(torch.unique(torch.nonzero(live)[:, 0] // 128).numel())
    entered = float(pk[:, 5].double().sum())
    nb = nbytes(rays, pk) + 24 * n_clus
    rec = {f"{prefix}block_box_tests": blocks * n_clus, f"{prefix}entered": entered}
    rec[f"{prefix}bound_ms"], rec[f"{prefix}bound_by"] = bound(FLOPS_SLAB * (blocks * n_clus + entered), nb)
    rec[f"{prefix}sweep_bound_ms"], rec[f"{prefix}sweep_bound_by"] = bound(
        FLOPS_SLAB * float(live.sum()) * n_clus, nb)
    return rec


def b2_timed(rays, box, n_clus: int, t_min: float, pk) -> dict:
    """B2's kernel and twin times on one call's inputs, with its bounds."""
    from yart_tpu_torch.kernels import presort

    rec = {"b2_ms": cuda_ms(lambda: presort.presort_cuda(rays, box, n_clus, t_min), reps=11),
           "b2_plain_ms": cuda_ms(lambda: presort.presort_plain(rays, box, n_clus, t_min), reps=3)}
    rec.update(b2_bounds(rays, n_clus, pk))
    return rec


def compare_presort(name, scene, meta, o, d, t_max) -> dict:
    """B2 alone against its twin, bitwise, on rays in lane order, as the
    block trace calls it; timed, with both bounds. Raises on any
    difference; returns the phase record."""
    import torch

    from yart_tpu_torch.kernels import presort
    from yart_tpu_torch.render import blocktrace

    t_min = 1e-3
    rays = blocktrace.ray_matrix(o, d, t_max)
    box, n_clus = scene.clus_box, blocktrace.n_clus(meta)
    pk = presort.presort_cuda(rays, box, n_clus, t_min)
    pk_p = presort.presort_plain(rays, box, n_clus, t_min)
    torch.cuda.synchronize()
    rows = int((pk != pk_p).any(dim=1).sum())
    if rows:
        raise AssertionError(f"{name}: B2 kernel and plain twin differ on {rows} rows")
    live = int((rays[:, 6] > 0).sum())
    rec = {"case": name, "n_rays": int(o.shape[0]), "n_clusters": int(n_clus), "live_rays": live,
           "bitwise_equal": True, "b2_rows_differ": 0, "b2_max_abs_err": 0.0,
           "entered_mean": float(pk[:, 5].double().sum() / max(live, 1))}
    rec.update(b2_timed(rays, box, n_clus, t_min, pk))
    return rec


def blocktrace_case(scene, meta, o, d, t_max, nee: bool = False):
    """The block trace's B2 and B3 inputs for rays o, d, t_max, as
    `intersect_blocktrace` makes them (ray matrix, B2 kernel, schedule, one
    gather): (rays, B2 rows, B3 arguments)."""
    from yart_tpu_torch.kernels import presort
    from yart_tpu_torch.render import blocktrace

    rays = blocktrace.ray_matrix(o, d, t_max)
    pk = presort.presort_cuda(rays, scene.clus_box, blocktrace.n_clus(meta), 1e-3)
    order, blive = blocktrace.schedule(pk)
    args = (rays[order].contiguous(), pk[order, 1 : 1 + presort.N_SLOTS].contiguous(), scene.clus_box,
            scene.clus_pack, blocktrace.cluster_counts(scene, meta), blive, 1e-3, nee, False,
            blocktrace.inst_tables(scene, meta))
    return rays, pk, args


def amask_cast1(scene, meta, o, d, seeds, order, blive0, out0):
    """Cast 1 of the gated loop after an `amask` cast 0 whose sorted output
    is `out0`: the lanes whose first hit the alpha gate passed through
    re-cast with floor = that hit, in cast 0's order. Returns (sorted
    rays, blive, cast 0's hit mask, the pass-through mask)."""
    import torch

    from yart_tpu_torch.render import blocktrace

    n = o.shape[0]
    t_max = torch.full((n,), 1e30, device=o.device)
    res = torch.empty_like(out0)
    res[order] = out0
    res = res[:n]
    tri = res[:, 4].contiguous().view(torch.int32)
    hit = tri >= 0
    ok, _, _ = blocktrace.hit_gates(scene, meta, res[:, 1], res[:, 2], tri, d, False, seeds)
    passthru = hit & ~ok
    rays1 = blocktrace.ray_matrix(o, d, torch.where(passthru, t_max, -1.0),
                                  torch.where(passthru, res[:, 0], 0.0))[order].contiguous()
    blive1 = ((rays1[:, 6] > 0.0).view(-1, blocktrace.BLOCK).any(dim=1) & (blive0 != 0)).to(torch.int32)
    return rays1, blive1, hit, passthru


def shadow_rays(o, d, t_hit, hit, sun=None, seed: int = 5):
    """Shadow rays from the hits (t_hit, hit) of rays o, d, the misses
    retired: toward `sun` with t_max 100 or, without it, in seeded random
    directions on the camera's side with a random finite t_max (phases 3c,
    3e, 3f)."""
    import torch

    dev = o.device
    if sun is not None:
        sun = torch.tensor(sun, device=dev)
        sh_o = (o + torch.where(hit, t_hit, 0.0)[:, None] * d).contiguous()
        return sh_o, (sun / sun.norm()).expand_as(d).contiguous(), torch.where(hit, 100.0, -1.0)
    sh_o = (o + t_hit[:, None] * d).contiguous()  # a miss keeps its far origin, retired all the same
    gen = torch.Generator(device=dev).manual_seed(seed)
    sh_d = torch.randn(o.shape, generator=gen, device=dev)
    sh_d = sh_d / sh_d.norm(dim=1, keepdim=True)
    sh_d = torch.where((sh_d * d).sum(dim=1, keepdim=True) > 0, -sh_d, sh_d)  # back toward the camera side
    sh_t = torch.where(hit, torch.rand(o.shape[0], generator=gen, device=dev) * 20.0 + 0.1, -1.0)
    return sh_o, sh_d.contiguous(), sh_t


def compare_blocktrace(name, scene, meta, o, d, t_max, timed: bool, nee: bool = False):
    """B2 and B3 kernels vs their plain twins on the same card tensors, as
    the block trace calls them (ray matrix, presort, schedule, one gather);
    raises on any bit difference. Returns the phase record."""
    import torch

    from yart_tpu_torch.kernels import fusedtrace, presort
    from yart_tpu_torch.render import blocktrace

    t_min = 1e-3
    rays, pk, args = blocktrace_case(scene, meta, o, d, t_max, nee)
    box, n_clus, blive, inst = scene.clus_box, blocktrace.n_clus(meta), args[5], args[9]
    pk_p = presort.presort_plain(rays, box, n_clus, t_min)
    torch.cuda.synchronize()
    b2_rows = int((pk != pk_p).any(dim=1).sum())
    b2_err = float((pk.long() - pk_p.long()).abs().max())
    if b2_rows:
        raise AssertionError(f"{name}: B2 kernel and plain twin differ on {b2_rows} rows (max abs {b2_err})")
    out = fusedtrace.fused_trace_cuda(*args)
    out_p, plain_ms = timed_call(lambda: fusedtrace.fused_trace_plain(*args))
    hit = out[:, 4].contiguous().view(torch.int32) >= 0
    b3_err = max(float((out[hit, i] - out_p[hit, i]).abs().max()) if hit.any() else 0.0 for i in range(3))
    if not bits_equal(out, out_p):
        diff = [i for i in range(8) if not bits_equal(out[:, i].contiguous(), out_p[:, i].contiguous())]
        raise AssertionError(f"{name}: B3 kernel and plain twin differ in columns {diff} "
                             f"(max abs t/u/v over hits {b3_err})")
    live = int((rays[:, 6] > 0).sum())
    rec = {"case": name, "mode": fusedtrace.mode_name(nee, False, inst is not None),
           "n_rays": int(o.shape[0]), "n_tris": int(meta.n_tris),
           "n_clusters": int(n_clus), "live_rays": live, "hit_frac": float(hit.float().mean()),
           "bitwise_equal": True, "b2_rows_differ": b2_rows, "b2_max_abs_err": b2_err,
           "b3_max_abs_err": b3_err, "live_blocks": int(blive.sum()),
           "clusters_tested": float(out[:, 5].double().sum()),
           "tris_tested": float(out[:, 6].double().sum()),
           "entered_mean": float(pk[:, 5].double().sum() / max(live, 1))}
    if timed:
        rec.update(b2_timed(rays, box, n_clus, t_min, pk))
        rec["b3_ms"] = cuda_ms(lambda: fusedtrace.fused_trace_cuda(*args), reps=11)
        rec["b3_plain_ms"] = plain_ms
        rec["b3_plain_timing"] = PLAIN_ONE_CALL
        rec.update(b3_bounds(args, out))
        rec["pipeline_ms"] = cuda_ms(
            lambda: blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, nee=nee), reps=11)
        rec["mrays_per_s"] = o.shape[0] / rec["pipeline_ms"] / 1e3
    return rec


def compare_amask(name, scene, meta, o, d, seeds, timed: bool = True):
    """B3's `amask` mode against its twin, bitwise, at the gated loop's
    shapes: cast 0 over all rays, then cast 1 over the lanes whose first
    hit the alpha gate passed through, with floor = that hit and cast 0's
    order, `blive` flags and slots reused. B2 on the same rays against its
    twin. Raises on any bit difference; returns the phase record."""
    import torch

    from yart_tpu_torch.kernels import fusedtrace, presort
    from yart_tpu_torch.render import blocktrace

    t_min = 1e-3
    n = o.shape[0]
    t_max = torch.full((n,), 1e30, device=o.device)
    zeros = torch.zeros(n, device=o.device)
    rays = blocktrace.ray_matrix(o, d, t_max)
    box, n_clus = scene.clus_box, blocktrace.n_clus(meta)
    inst = blocktrace.inst_tables(scene, meta)
    pk = presort.presort_cuda(rays, box, n_clus, t_min)
    pk_p = presort.presort_plain(rays, box, n_clus, t_min)
    torch.cuda.synchronize()
    b2_rows = int((pk != pk_p).any(dim=1).sum())
    if b2_rows:
        raise AssertionError(f"{name}: B2 kernel and plain twin differ on {b2_rows} rows")
    order, blive0, slots = blocktrace.fused_order(scene, meta, o, d, t_max, zeros, t_min)
    counts = blocktrace.cluster_counts(scene, meta)
    rec = {"case": name, "mode": fusedtrace.mode_name(False, True, inst is not None), "n_rays": n,
           "n_tris": int(meta.n_tris), "n_clusters": int(n_clus), "bitwise_equal": True, "b2_rows_differ": 0}
    casts = []

    def cast(tag, rays_s, blive):
        args = (rays_s.contiguous(), slots, box, scene.clus_pack, counts, blive, t_min, False, True, inst)
        out = fusedtrace.fused_trace_cuda(*args)
        out_p, plain_ms = timed_call(lambda: fusedtrace.fused_trace_plain(*args))
        hit = out[:, 4].contiguous().view(torch.int32) >= 0
        err = max(float((out[hit, i] - out_p[hit, i]).abs().max()) if hit.any() else 0.0 for i in range(3))
        if not bits_equal(out, out_p):
            diff = [i for i in range(8) if not bits_equal(out[:, i].contiguous(), out_p[:, i].contiguous())]
            raise AssertionError(f"{name} {tag}: B3 amask kernel and twin differ in columns {diff} "
                                 f"(max abs t/u/v over hits {err})")
        live = int((rays_s[:, 6] > 0).sum())
        casts.append({"cast": tag, "live_rays": live, "live_blocks": int(blive.sum()),
                      "hit_frac_of_live": float(hit.sum()) / max(live, 1), "max_abs_err": err,
                      "clusters_tested": float(out[:, 5].double().sum()),
                      "tris_tested": float(out[:, 6].double().sum()),
                      "mask_tests": float(out[:, 7].double().sum())})
        return args, out, plain_ms

    args0, out0, plain0 = cast("cast0", rays[order], blive0)
    rays1, blive1, hit, passthru = amask_cast1(scene, meta, o, d, seeds, order, blive0, out0)
    args1, out1, _ = cast("cast1", rays1, blive1)
    floor_ok = out1[:, 4].contiguous().view(torch.int32) >= 0
    if not bool((out1[floor_ok, 0] > rays1[floor_ok, 7]).all()):
        raise AssertionError(f"{name}: a cast-1 hit lies at or below its floor")
    rec.update(casts=casts, hit_frac=float(hit.float().mean()),
               passthrough_share_of_hits=float(passthru.sum()) / max(int(hit.sum()), 1),
               max_abs_err=max(c["max_abs_err"] for c in casts))
    if not timed:
        return rec
    rec.update(b2_timed(rays, box, n_clus, t_min, pk))
    rec["b3_ms"] = cuda_ms(lambda: fusedtrace.fused_trace_cuda(*args0), reps=11)
    rec["b3_closest_ms"] = cuda_ms(lambda: fusedtrace.fused_trace_cuda(*args0[:8], False, inst), reps=11)
    rec["b3_cast1_ms"] = cuda_ms(lambda: fusedtrace.fused_trace_cuda(*args1), reps=11)
    rec["b3_plain_ms"] = plain0
    rec["b3_plain_timing"] = PLAIN_ONE_CALL
    rec.update(b3_bounds(args0, out0))
    rec.update(b3_bounds(args1, out1, "b3_cast1_"))
    return rec


def compare_gated(name, scene, meta, o, d, t_max, seeds, nee: bool, fused: bool = True):
    """intersect_blocktrace_gated, kernel path against twin path, bitwise
    on every Hit field and on the per-cast active counts (and, with
    fused=False, on the rounds of the round-based casts)."""
    import torch

    from yart_tpu_torch.render import blocktrace

    trace_k, trace_p = [], []
    torch.cuda.synchronize()
    blocktrace.LEGACY.reset()
    t0 = time.perf_counter()
    hk = blocktrace.intersect_blocktrace_gated(scene, meta, o, d, t_max, nee=nee, alpha_seed=seeds,
                                               trace=trace_k, fused=fused)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rounds_k = blocktrace.LEGACY.rounds
    blocktrace.LEGACY.reset()
    t0 = time.perf_counter()
    with intersection_forced_to_plain():
        hp = blocktrace.intersect_blocktrace_gated(scene, meta, o, d, t_max, nee=nee, alpha_seed=seeds,
                                                   trace=trace_p, fused=fused)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    diff = [f for f in hk._fields if not bits_equal(getattr(hk, f), getattr(hp, f))]
    if diff or trace_k != trace_p or rounds_k != blocktrace.LEGACY.rounds:
        raise AssertionError(f"{name}: gated loop kernel path and twin path differ in {diff}; "
                             f"casts {trace_k} vs {trace_p}; rounds {rounds_k} vs {blocktrace.LEGACY.rounds}")
    rec = {"case": name, "nee": nee, "fused": fused, "n_rays": int(o.shape[0]), "bitwise_equal": True,
           "casts": len(trace_k), "active_per_cast": trace_k, "hit_frac": float(hk.mask.float().mean()),
           "kernel_path_ms": ms, "twin_path_s": plain_s}
    if not fused:
        rec["rounds"] = rounds_k
    return rec


def b7a_bounds(rays, box, w_key, act, n_clus: int, t_min: float, sel) -> dict:
    """B7a's bounds from this call's data. `bound_ms` counts the work the
    inputs need: one bundle test per (active block, box column) and one
    slab test per (ray of an active block, box it enters: the twin's
    `block_entries` below F32_MAX); `nofma_floor_ms` counts the same tests
    at INSTR_SLAB_NOFMA instructions each. `sweep_bound_ms` counts a slab
    test per (ray of an active block, real box) instead, the sweep of the
    first B7a design. Bytes: the active blocks' rays, the real boxes, the
    window keys and flags, the outputs `sel`."""
    import torch

    from yart_tpu_torch.kernels import blocktrace as legacy

    n_blocks, cpad = act.shape[0], box.shape[1]
    blocks = torch.nonzero(act != 0)[:, 0]
    rays3, step = rays.view(n_blocks, legacy.BLOCK, 8), max(1, legacy.PLAIN_BUDGET // (legacy.BLOCK * cpad))
    entered = sum(int((legacy.block_entries(rays3[blocks[i : i + step]], box, t_min) < legacy.F32_MAX).sum())
                  for i in range(0, blocks.numel(), step))
    live_blocks = int(blocks.numel())
    tests, sweep = live_blocks * cpad + entered, live_blocks * legacy.BLOCK * n_clus
    nb = nbytes(rays) * live_blocks // n_blocks + n_clus * box.shape[0] * 4 + nbytes(w_key, act, *sel)
    ms, by = bound(FLOPS_SELECT * tests, nb)
    sweep_ms, sweep_by = bound(FLOPS_SELECT * sweep, nb)
    return {"bound_ms": ms, "bound_by": by, "nofma_floor_ms": INSTR_SLAB_NOFMA * tests / PEAK_FP32_INSTR * 1e3,
            "sweep_bound_ms": sweep_ms, "sweep_bound_by": sweep_by, "bound_tests": tests, "entered": entered,
            "sweep_tests": sweep}


def b7b_bounds(rays, slots, out, counts, c: int) -> dict:
    """B7b's bound over the block's rays against the real triangles of each
    live slot's cluster (bytes: every ray in and out, the slot tables, pack
    rows 0-3 of the real triangles of each cluster a live slot names), its
    no-FMA floor, and the columns the kernel tests (each live slot's real
    ones and the first after them, in whole 16-byte words) beside C x live
    slots."""
    slot_clus = slots[2][slots[0] != 0].long()
    used = slot_clus.unique()
    live_tris, used_tris = int(counts[slot_clus].sum()), int(counts[used].sum())
    ms, by = bound(FLOPS_PLANE * 128 * live_tris, nbytes(rays, *slots, out) + used_tris * 4 * 3 * 4)
    return {"bound_ms": ms, "bound_by": by, "nofma_floor_ms": INSTR_PLANE_NOFMA * 128 * live_tris / PEAK_FP32_INSTR * 1e3,
            "live_slot_tris": live_tris, "columns_tested": int(((counts[slot_clus] + 4) // 4 * 4).clamp(max=c).sum()),
            "columns_all": int(slot_clus.numel()) * c}


def b7_round(scene, meta, o, d, later: bool):
    """B7a's inputs (rays, w_key, act) and the round's number at round 1, or
    with `later` the first round with both converged and active blocks, as
    blocktrace.round_inputs captures them from the path (t_max 100, k = 24,
    t_min = 1e-3)."""
    from yart_tpu_torch.render import blocktrace

    return blocktrace.round_inputs(scene, meta, o, d, 100.0, B7_K, later, 1e-3)


def compare_legacy_kernels(name, scene, meta, o, d, later: bool):
    """B7a and B7b against their twins on the same card tensors, bitwise, at
    one round of the round-based path with its default k = 24 (`b7_round`;
    B7b with the clusters' counts, as the path calls it); timed (the launch
    alone), with their bounds and no-FMA floors from this call's data, and
    per active block B7a's live rays, kept boxes and live keys, and B7b's
    columns tested beside C x live slots. Returns the phase record."""
    import torch

    from yart_tpu_torch.kernels import blocktrace as legacy
    from yart_tpu_torch.render import blocktrace

    t_min, c, k = 1e-3, meta.cluster_size, B7_K
    rays, w_key, act, rnd = b7_round(scene, meta, o, d, later)
    box, pack = scene.clus_box, scene.clus_pack
    counts = blocktrace.cluster_counts(scene, meta)
    stats = torch.zeros((act.shape[0], 3), dtype=torch.int32, device=rays.device)
    sel = legacy.select_clusters_cuda(rays, box, w_key, act, k, t_min, stats=stats)
    sel_p = legacy.select_clusters_plain(rays, box, w_key, act, k, t_min)
    torch.cuda.synchronize()
    diff = [f for f, a, b in zip(("ids", "bound_key", "n_live"), sel, sel_p) if not torch.equal(a, b)]
    sel_err = max(float((a.long() - b.long()).abs().max()) for a, b in zip(sel, sel_p))
    if diff:
        raise AssertionError(f"{name}: B7a kernel and plain twin differ in {diff} (max abs {sel_err})")
    slots = blocktrace.round_slots(scene, sel[0], sel[2], act)
    out = legacy.test_clusters_cuda(rays, pack, *slots, c, k, t_min, counts)
    out_p = legacy.test_clusters_plain(rays, pack, *slots, c, k, t_min, counts)
    torch.cuda.synchronize()
    hit = out[:, 4].view(torch.int32) >= 0
    test_err = max(float((out[hit, i] - out_p[hit, i]).abs().max()) if hit.any() else 0.0 for i in range(3))
    if not bits_equal(out, out_p):
        cols = [i for i in range(8) if not bits_equal(out[:, i].contiguous(), out_p[:, i].contiguous())]
        raise AssertionError(f"{name}: B7b kernel and plain twin differ in columns {cols} "
                             f"(max abs t/u/v over hits {test_err})")
    n_clus = blocktrace.n_clus(meta)
    on = act != 0
    per_block = lambda a: {"mean": float(a.double().mean()), "min": int(a.min()), "max": int(a.max()),
                           **{f"p{q}": float(a.double().quantile(q / 100)) for q in (50, 90, 99)}}
    b7a, b7b = b7a_bounds(rays, box, w_key, act, n_clus, t_min, sel), b7b_bounds(rays, slots, out, counts, c)
    rec = {"case": name, "round": rnd, "k": k, "n_rays": int(o.shape[0]), "n_clusters": int(n_clus),
           "cpad": int(box.shape[1]), "c": int(c), "bitwise_equal": True, "live_blocks": int(on.sum()),
           "n_blocks": int(act.shape[0]), "live_slots": int(slots[0].sum()), "live_slot_tris": b7b["live_slot_tris"],
           "blocks_overflowing_k": int((sel[1][on] != legacy.KEY_DEAD).sum()),
           "new_hits": int(hit.sum()), "select_max_abs_err": sel_err, "test_max_abs_err": test_err,
           "select_live_rays_per_block": per_block(stats[on, 0]),
           "select_kept_boxes_per_block": per_block(stats[on, 1]),
           "select_live_keys_per_block": per_block(stats[on, 2]),
           "select_exact_tests": int((stats[on, 0].long() * stats[on, 1].long()).sum()),
           "select_bound_tests": b7a["bound_tests"], "select_entered": b7a["entered"],
           "select_sweep_tests": b7a["sweep_tests"],
           "test_columns_tested": b7b["columns_tested"], "test_columns_all": b7b["columns_all"]}
    rec["select_ms"] = cuda_ms(legacy.prepare_select(rays, box, w_key, act, k, t_min), reps=11)
    rec["select_plain_ms"] = cuda_ms(lambda: legacy.select_clusters_plain(rays, box, w_key, act, k, t_min),
                                     reps=3)
    rec.update({f"select_{key}": b7a[key] for key in ("bound_ms", "bound_by", "nofma_floor_ms", "sweep_bound_ms")})
    rec["test_ms"] = cuda_ms(legacy.prepare_test(rays, pack, *slots, c, k, t_min, counts), reps=11)
    rec["test_plain_ms"] = cuda_ms(lambda: legacy.test_clusters_plain(rays, pack, *slots, c, k, t_min, counts),
                                   reps=1, warmup_s=0.0, warmup_calls=1)
    rec.update({f"test_{key}": b7b[key] for key in ("bound_ms", "bound_by", "nofma_floor_ms")})
    return rec


def wall_ms(fn, reps: int = 3) -> float:
    """Median host-clock milliseconds of fn() ending in a synchronize,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def legacy_cast(name, scene, meta, o, d, t_max):
    """This slice's main path: one intersect_blocktrace(fused=False) cast
    on the card with every count set to 0 just before and read just after
    (B7a and B7b once per round, no twin, no B2 or B3), converged within
    512 rounds, held to the fused path on the same rays: masks equal, t
    bitwise on every lane, tri equal except where both triangles lie at
    the same t, u/v/back equal where tri agrees. Both walls timed. Returns
    (record, {kernel: launches})."""
    import torch

    from yart_tpu_torch.kernels import blocktrace as legacy
    from yart_tpu_torch.kernels import fusedtrace, presort
    from yart_tpu_torch.render import blocktrace

    max_rounds = 512
    trace = []
    reset_counts()
    h = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, fused=False, max_rounds=max_rounds, trace=trace)
    torch.cuda.synchronize()
    launches = {"select_clusters": legacy.COUNTS_SELECT.launches, "test_clusters": legacy.COUNTS_TEST.launches,
                "plain_cuda": legacy.COUNTS_SELECT.plain_cuda + legacy.COUNTS_TEST.plain_cuda,
                "presort_keys": presort.COUNTS.launches, "fused_trace": fusedtrace.COUNTS.launches,
                "rounds": blocktrace.LEGACY.rounds}
    if launches["select_clusters"] != len(trace) or launches["test_clusters"] != len(trace) \
            or launches["plain_cuda"] or launches["presort_keys"] or launches["fused_trace"]:
        raise AssertionError(f"{name}: the round-based cast did not run B7a and B7b once per round alone: "
                             f"{launches}, {len(trace)} rounds")
    if len(trace) >= max_rounds:
        raise AssertionError(f"{name}: blocks still active after {max_rounds} rounds")
    f = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max)
    torch.cuda.synchronize()
    hit, f_hit = h[4] >= 0, f[4] >= 0
    if not torch.equal(hit, f_hit) or not bits_equal(h[0], f[0]):
        raise AssertionError(f"{name}: round-based and fused casts differ in the mask or in t")
    # Each path's t is its own triangle's t from the same plane test, so
    # with t bit-equal on every lane a lane whose tri differs is a tie: both
    # triangles lie at the same t (B7b keeps the earlier slot, B3 the lower
    # triangle index).
    same = h[4] == f[4]
    tie = hit & ~same
    for i, field in ((1, "u"), (2, "v"), (3, "back")):
        if not torch.equal(h[i][same & hit], f[i][same & hit]):
            raise AssertionError(f"{name}: {field} differs where tri agrees")
    rec = {"case": name, "n_rays": int(o.shape[0]), "rounds": len(trace), "active_blocks_per_round": trace,
           "unconverged_blocks_at_64_rounds": trace[64] if len(trace) > 64 else 0,
           "launches": launches, "hit_frac": float(hit.float().mean()), "tri_ties": int(tie.sum()),
           "slots_tested_per_ray": float(h[5].double().mean())}
    rec["legacy_ms"] = wall_ms(lambda: blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, fused=False,
                                                                      max_rounds=max_rounds))
    rec["fused_ms"] = wall_ms(lambda: blocktrace.intersect_blocktrace(scene, meta, o, d, t_max))
    rec["legacy_over_fused"] = rec["legacy_ms"] / rec["fused_ms"]
    return rec, launches


def compare_legacy_paths(name, scene, meta, o, d, t_max, nee: bool = False, floor=None):
    """intersect_blocktrace(fused=False), kernel path against twin path,
    bitwise on every output and on the active blocks of every round."""
    import torch

    from yart_tpu_torch.render import blocktrace

    trace_k, trace_p = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hk = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, nee=nee, floor=floor, fused=False,
                                         trace=trace_k)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with intersection_forced_to_plain():
        hp = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, nee=nee, floor=floor, fused=False,
                                             trace=trace_p)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    fields = ("t", "u", "v", "back", "tri", "slots_tested", "tris_tested")
    diff = [f for f, a, b in zip(fields, hk, hp) if not bits_equal(a, b)]
    if diff or trace_k != trace_p:
        raise AssertionError(f"{name}: round-based kernel path and twin path differ in {diff}; "
                             f"rounds {trace_k} vs {trace_p}")
    return {"case": name, "nee": nee, "floor": floor is not None, "n_rays": int(o.shape[0]),
            "bitwise_equal": True, "rounds": len(trace_k), "active_blocks_per_round": trace_k,
            "hit_frac": float((hk[4] >= 0).float().mean()), "kernel_path_ms": ms, "twin_path_s": plain_s}, hk


def b4_tests(lay, clus_count) -> float:
    """The (pair, column) tests of one B4 call on layout `lay`: each live
    pair against its cluster's triangles (`clus_count`; the cluster's other
    columns are zero and never valid, so no test of them is needed)."""
    return float((lay.tiles[:, 3].double() * clus_count[lay.tiles[:, 0].long()].double()).sum())


def b4_work(lay, c: int, clus_count):
    """(flops, bytes) of one B4 call on layout `lay`, from its data: the
    plane tests of `b4_tests`; each live pair row read and its hit written
    once, each cluster with pairs has its triangles' [4, 3] columns read
    once, and the tile table and counts once."""
    import torch

    cids = torch.unique(lay.tiles[:, 0]).long()
    return (FLOPS_PLANE * b4_tests(lay, clus_count),
            lay.pair.numel() * (32 + 17) + float(clus_count[cids].double().sum()) * 4 * 3 * 4
            + lay.tiles.numel() * 4 + cids.numel() * 4)


def b4_floor_ms(lay, clus_count) -> float:
    """B4's reachable floor under --fmad=false (INSTR_PLANE_NOFMA a test)."""
    return b4_tests(lay, clus_count) * INSTR_PLANE_NOFMA / PEAK_FP32_INSTR * 1e3


def b4_rows(lay) -> dict:
    """The layout's tiles, live pairs and the rows B4 touches (reads,
    tests and writes: its tiles' rows), beside the rows the parent's
    layout had (each cluster's pairs in whole blocks of 1024)."""
    import torch

    cnt = torch.zeros(int(lay.tiles[:, 0].max()) + 1 if lay.tiles.numel() else 1, dtype=torch.int64,
                      device=lay.tiles.device)
    cnt.index_add_(0, lay.tiles[:, 0].long(), lay.tiles[:, 3].long())
    return {"tiles": int(lay.tiles.shape[0]), "live_pairs": int(lay.pair.numel()),
            "rows_touched": int(lay.tiles[:, 3].sum()), "layout_rows": int(lay.x.shape[0]),
            "parent_layout_rows": int(((cnt + 1023) // 1024).sum()) * 1024}


def compare_pairs(name, scene, meta, o, d, t_max):
    """B4 kernel vs its plain twin on the same card tensors, bitwise on t,
    u, v, back and tri, at bin-trace's round-1 shapes for these rays (the
    collect phase, then the pair layout); timed. Raises on any bit
    difference, or if B4 touches a row that is not a live pair; returns
    the phase record."""
    import torch

    from yart_tpu_torch.kernels import build, clusterpairs
    from yart_tpu_torch.render import bintrace, blocktrace

    t_min, n, k = 1e-3, o.shape[0], meta.bintrace_k
    t0 = time.perf_counter()
    slots, n_col, _, _ = bintrace.collect_clusters(
        scene, meta, o, d, t_max, t_min, torch.full((n,), -1.0, device=o.device),
        torch.full((n,), -1, dtype=torch.int32, device=o.device), torch.ones(n, dtype=torch.bool, device=o.device), k)
    lay = bintrace.pair_layout(scene, meta, slots, n_col, o, d, t_max)
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    rows = b4_rows(lay)
    if not rows["rows_touched"] == rows["live_pairs"] == rows["layout_rows"]:
        raise AssertionError(f"{name}: B4 touches rows that are not live pairs: {rows}")
    counts = blocktrace.cluster_counts(scene, meta)
    args = (scene.clus_pack, counts, lay.tiles, lay.x, meta.cluster_size, t_min)
    out = clusterpairs.cluster_pairs_cuda(*args)
    out_p = clusterpairs.cluster_pairs_plain(*args)
    torch.cuda.synchronize()
    fields = ("t", "u", "v", "back", "tri")
    if any(a.shape[0] != rows["live_pairs"] for a in out):
        raise AssertionError(f"{name}: B4 wrote {out[0].shape[0]} rows for {rows['live_pairs']} live pairs")
    hit = out[4] >= 0
    err = max(float((a[hit] - b[hit]).abs().max()) if hit.any() else 0.0 for a, b in zip(out[:3], out_p[:3]))
    diff = [f for f, a, b in zip(fields, out, out_p) if not bits_equal(a, b)]
    if diff:
        raise AssertionError(f"{name}: B4 kernel and plain twin differ in {diff} (max abs t/u/v over hits {err})")
    bintrace.COUNTS.reset()
    bintrace.intersect_bintrace(scene, meta, o, d, t_max)
    rec = {"case": name, "n_rays": n, "n_tris": int(meta.n_tris), "n_clusters": int(meta.n_clusters),
           "cluster_size": int(meta.cluster_size), "bitwise_equal": True, "max_abs_err": err, **rows,
           "pair_hit_frac": float(hit.float().mean()),
           "collect_iters_round1": bintrace.COUNTS.iters[0], "rounds": bintrace.COUNTS.rounds,
           "collect_iters_per_round": bintrace.COUNTS.iters, "round1_collect_and_layout_s": layout_s,
           "occupancy_blocks_per_sm": build.occupancy("cluster_pairs", meta.cluster_size)}
    rec["ms"] = cuda_ms(lambda: clusterpairs.launch(*args), reps=11)  # the kernel, not the tile check
    rec["plain_ms"] = cuda_ms(lambda: clusterpairs.cluster_pairs_plain(*args), reps=1, warmup_s=0.0,
                              warmup_calls=1)
    rec["pair_column_tests"] = b4_tests(lay, counts)
    rec["bound_ms"], rec["bound_by"] = bound(*b4_work(lay, meta.cluster_size, counts))
    rec["nofma_floor_ms"] = b4_floor_ms(lay, counts)
    return rec


def compare_bintrace(name, scene, meta, o, d, t_max, nee: bool):
    """intersect_bintrace, kernel path against twin path, bitwise on every
    Hit field, the round count and the collect iterations."""
    import torch

    from yart_tpu_torch.render import bintrace

    res = []
    for forced in (False, True):
        bintrace.COUNTS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with intersection_forced_to_plain() if forced else contextlib.nullcontext():
            h = bintrace.intersect_bintrace(scene, meta, o, d, t_max, nee=nee)
        torch.cuda.synchronize()
        res.append((h, bintrace.COUNTS.rounds, list(bintrace.COUNTS.iters), time.perf_counter() - t0))
    (hk, rk, ik, sk), (hp, rp, ip, sp) = res
    diff = [f for f in hk._fields if not bits_equal(getattr(hk, f), getattr(hp, f))]
    if diff or (rk, ik) != (rp, ip):
        raise AssertionError(f"{name}: bin-trace kernel path and twin path differ in {diff}; "
                             f"rounds {rk} vs {rp}, collect iterations {ik} vs {ip}")
    return {"case": name, "nee": nee, "n_rays": int(o.shape[0]), "bitwise_equal": True, "rounds": rk,
            "collect_iters_per_round": ik, "hit_frac": float(hk.mask.float().mean()),
            "kernel_path_s": sk, "twin_path_s": sp}


def b6_instructions(setup) -> int:
    """SASS instructions one B6 lane issues for this call's sampler, read
    off the sm_90a build (`python -m yart_tpu_torch.compare_kernels
    --kernel b6 yart_tpu_torch/csrc/draws.cu --sass DIR`, nvcc 12.8; 1,984
    instructions, no local memory). ZSobol: six base-4 digit loops (the
    two 2D draws' 173 instructions per 4 unrolled digits, 46 per remainder
    digit; the four 1D draws' 167 and 44) over n_base4_digits - (log2spp &
    1) digits; the odd-log2spp tail (23) after each; the two 2D draws'
    Sobol' column loops (27 per 4 unrolled columns, 10 per remainder
    column); 303 instructions outside the loops (the scrambles, floats,
    stores), and each loop's entry when it runs (28 for the six unrolled
    digit loops, 13 for their remainders, 4 and 6 for the column loops').
    Hash: 165. The integers split ~38% IMAD (the FMA pipe), ~56% SHF /
    LOP3 / IADD3 (the ALU pipe), the rest uniform, constant and branch
    instructions."""
    if setup.kind == "hash":
        return 165
    s = setup.sampler
    last = s.log2spp & 1
    q, r = divmod(s.n_base4_digits - last, 4)
    qc, rc = divmod(len(s._matrix1), 4)
    return (303 + 28 * (q > 0) + 13 * (r > 0) + 4 * (qc > 0) + 6 * (rc > 0) + 6 * 23 * last
            + 2 * (173 * q + 46 * r) + 4 * (167 * q + 44 * r) + 2 * (27 * qc + 10 * rc))


def b6_bound(setup, n: int) -> dict:
    """B6's bound over n lanes: its SASS instructions at the card's issue
    rate (4 warp instructions a clock an SM: PEAK_FP32_INSTR lane
    instructions a second, whichever pipes they use), or its bytes (8 in,
    32 out a lane)."""
    instr = b6_instructions(setup)
    t_ops, t_bytes = instr * n / PEAK_FP32_INSTR * 1e3, (8 + 8 * 4) * n / PEAK_BYTES * 1e3
    return {"instructions_per_lane": instr, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def compare_draws(name, sampler, state, dim0: int, timed: bool = False):
    """B6 against its twin (the sampler's own draws) on the same card
    lanes, bitwise on all 8 outputs; timed with its bound. Raises on any
    bit difference; returns the phase record."""
    import torch

    from yart_tpu_torch.kernels import shade

    setup = shade.sampler_draw_setup(sampler, state, dim0)
    n = int(state.shape[0])
    k = shade.draws_cuda(setup, n)
    p = shade.draws_plain(setup, n)
    torch.cuda.synchronize()
    diff = {key: int((k[key].view(torch.int32) != p[key].contiguous().view(torch.int32)).sum())
            for key in shade.DRAW_OUT}
    diff = {key: v for key, v in diff.items() if v}
    err = max(float((k[key] - p[key]).abs().max()) for key in shade.DRAW_OUT)
    if diff:
        raise AssertionError(f"{name}: B6 and its twin differ on lanes {diff} (max abs {err})")
    rec = {"case": name, "kind": setup.kind, "n": n, "dim0": dim0, "bitwise_equal": True, "max_abs_err": err}
    if setup.kind == "zsobol":
        rec.update(log2spp=sampler.log2spp, n_base4_digits=sampler.n_base4_digits)
    if timed:
        rec["ms"] = cuda_ms(shade.prepare_draws(setup, n), reps=21)
        rec["wrapper_ms"] = cuda_ms(lambda: shade.draws_cuda(setup, n), reps=21)
        rec["plain_ms"] = cuda_ms(lambda: shade.draws_plain(setup, n), reps=3)
        rec.update(b6_bound(setup, n))
    return rec


def b5_bytes(inp, mis: bool, any_lights: bool, tables) -> int:
    """The bytes B5 must move for this call: every input it reads for a live
    lane (active or found) once, only the pass-through fields for a dead
    one, every output once, and the six LUTs once."""
    from yart_tpu_torch.kernels import shade
    from yart_tpu_torch.kernels import shade_math as SM

    n = int(inp["active"].shape[0])
    live = int((inp["active"] | inp["found"]).sum())
    per_live = sum(12 if k in SM.V3_KEYS else 1 if k in SM.B_KEYS else 4 for k in shade._needs(mis, any_lights))
    per_dead = 3 + 4 * 12 + 2 * 4  # 3 flags, atten / o / d / last_p, last_pdf / acc_rough
    out = 12 * len(SM.OUT_V3) + 4 * len(SM.OUT_F) + len(SM.OUT_B)
    return live * per_live + (n - live) * per_dead + n * out + nbytes(*(tables[k] for k in shade.LUT_KEYS))


def b5_record(inp, gates, mis: bool, any_lights: bool, tables) -> dict:
    """A B5 case's size, its bound and its lobe mix: the lanes of each
    picked lobe (and dead), and the warps that hold more than one of them
    in lane order and after the kernel's grouping (`shade.mixed_warps`)."""
    from yart_tpu_torch.kernels import shade

    n = int(inp["active"].shape[0])
    live = int((inp["active"] | inp["found"]).sum())
    rec = {"n": n, "live": live, "gates": list(gates), "mis": mis, "any_lights": any_lights}
    rec["bound_ms"], rec["bound_by"] = bound(FLOPS_SHADE * live, b5_bytes(inp, mis, any_lights, tables))
    rec["lobe_mix"] = shade.mixed_warps(shade.lobe_keys(inp, gates, tables))
    return rec


def compare_shade(name, inp, gates, mis: bool, any_lights: bool, tables, timed: bool = False):
    """B5 against its twin (shade_math.shade) on the same card tensors,
    bitwise on every output and every lane (dead lanes included: the
    kernel writes their pass-through state, the twin zeroes their contrib
    and shadow_d). Raises on any bit difference; returns the phase record.
    Timed: the launch alone (`shade.prepare_shade`) and, once, the whole
    wrapper."""
    import torch

    from yart_tpu_torch.kernels import shade

    k = shade.shade_cuda(inp, gates, mis, any_lights, tables)
    p = shade.shade_plain(inp, gates, mis, any_lights, tables)
    torch.cuda.synchronize()
    diff = {}
    for key in k:
        a, b = k[key], p[key].contiguous()
        ne = a.view(torch.int32) != b.view(torch.int32) if a.dtype == torch.float32 else a != b
        if ne.any():
            lanes = torch.nonzero(ne.reshape(ne.shape[0], -1).any(dim=1))[:, 0]
            diff[key] = {"lanes": int(lanes.numel()), "first": [
                (int(j), a[j].tolist(), b[j].tolist()) for j in lanes[:3].tolist()]}
    err = max(float((k[key] - p[key]).abs().max()) for key in k if k[key].dtype == torch.float32)
    if diff:
        raise AssertionError(f"{name}: B5 and its twin differ: {diff} (max abs {err})")
    rec = {"case": name, **b5_record(inp, gates, mis, any_lights, tables),
           "nee_need": int(k["nee_need"].sum()), "bitwise_equal": True, "max_abs_err": err}
    if timed:
        rec["ms"] = cuda_ms(shade.prepare_shade(inp, gates, mis, any_lights, tables), reps=21)
        rec["wrapper_ms"] = cuda_ms(lambda: shade.shade_cuda(inp, gates, mis, any_lights, tables), reps=21)
        rec["plain_ms"] = cuda_ms(lambda: shade.shade_plain(inp, gates, mis, any_lights, tables), reps=3)
    return rec


def lobe_lanes(n: int, seed: int, dev, lobes):
    """Random lanes (`random_shade_lanes`) whose materials force each lane's
    lobe pick under all four gates: lane i picks lobes[i % len(lobes)]
    ("coat": clearcoat 1, uc2 0; "metal": metallic 1; "dielectric":
    transmission 1; "glossy": neither), every lane active and found."""
    import torch

    inp = random_shade_lanes(n, seed, dev)
    n = inp["active"].shape[0]
    kind = torch.arange(n, device=dev) % len(lobes)
    one, zero = torch.ones(n, device=dev), torch.zeros(n, device=dev)
    pick = {name: kind == i for i, name in enumerate(lobes)}
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    inp["clearcoat"] = torch.where(pick.get("coat", none), one, zero)
    inp["uc2"] = torch.where(pick.get("coat", none), zero, inp["uc2"])
    inp["metallic"] = torch.where(pick.get("metal", none), one, zero)
    inp["transmission"] = torch.where(pick.get("dielectric", none), one, zero)
    inp["active"] = torch.ones(n, dtype=torch.bool, device=dev)
    inp["found"] = inp["active"].clone()
    return inp


def b5_cases(dev, scenes=None, twin: bool = False):
    """(name, (inp, gates, mis, any_lights, tables), timed) of phase 3k:
    real depth-1 bounces of cornell-mat and atrium-ivy at 2^20 lanes and of
    roadster at 2^16 (`scenes`: {name: (scene, meta)} of the three, each
    built here where missing; `twin`: capture them with the plain twin, not
    the kernel), 2^20 random all-gates lanes (also with mis off
    and with no lights), whole dead blocks; then the edges of the kernel's
    tiles: every lane of a tile on one lobe, the four lobes interleaved
    lane by lane, every other tile dead, n = 1, 127, 129 and 2^20 + 77, and
    every input a view with a storage offset (not 16-byte aligned)."""
    import torch

    from yart_tpu_torch.cli import CAMERAS
    from yart_tpu_torch.config import CameraConfig
    from yart_tpu_torch.ops import lut
    from yart_tpu_torch.scene.procedural import cornell_box
    from yart_tpu_torch.scene.showcase import atrium, roadster

    scenes = scenes or {}
    cornell = scenes.get("cornell-mat") or cornell_box(extra_materials=True).compile(dev)
    cornell_cam = CameraConfig(image_size=(512, 512), focal_length=35.0,
                               position=(0, 1.0, 3.4), forward=(0, 0, -3.4))
    yield "cornell-mat_bounce1_2^20", capture_shade_call(*cornell, cornell_cam, 4, dev, twin=twin), True
    ivy = scenes.get("atrium-ivy") or atrium(ivy=True).compile(dev)
    ivy_pos, ivy_target = CAMERAS["atrium-ivy"]
    ivy_cam = CameraConfig(image_size=(512, 512), focal_length=35.0, position=ivy_pos,
                           forward=tuple(t - p for p, t in zip(ivy_pos, ivy_target)), exposure=3.0)
    yield "atrium-ivy_bounce1_2^20", capture_shade_call(*ivy, ivy_cam, 4, dev, twin=twin), True
    road, road_meta = scenes.get("roadster") or roadster().compile(dev)
    road_gates = (road_meta.any_metallic, road_meta.any_transmissive, road_meta.any_clearcoat,
                  road_meta.any_anisotropy)
    if not all(road_gates[:3]):
        raise AssertionError(f"roadster's metallic, transmissive and clearcoat gates are not all on: {road_gates}")
    road_pos, road_target = CAMERAS["roadster"]
    road_cam = CameraConfig(image_size=(256, 256), focal_length=35.0, position=road_pos,
                            forward=tuple(t - p for p, t in zip(road_pos, road_target)), exposure=1.0)
    yield "roadster_bounce1_2^16", capture_shade_call(road, road_meta, road_cam, 1, dev, twin=twin), True
    del road
    tables = lut.load_tables(dev)
    all_gates = (True, True, True, True)
    rnd = random_shade_lanes(1 << 20, 3, dev)
    yield "random_all_gates_2^20", (rnd, all_gates, True, True, tables), True
    yield "random_all_gates_mis_off", (rnd, all_gates, False, True, tables), True
    yield "random_all_gates_no_lights", (rnd, all_gates, True, False, tables), True
    del rnd
    yield "random_dead_blocks_2^16", (random_shade_lanes(1 << 16, 4, dev, dead_blocks=True), all_gates, True, True,
                                      tables), False
    yield "one_lobe_metal_2^16", (lobe_lanes(1 << 16, 5, dev, ("metal",)), all_gates, True, True, tables), False
    yield "lobes_interleaved_2^16", (lobe_lanes(1 << 16, 6, dev, ("coat", "metal", "dielectric", "glossy")),
                                     all_gates, True, True, tables), False
    dead = random_shade_lanes(1 << 16, 7, dev)
    tile_dead = (torch.arange(1 << 16, device=dev) // 128) % 2 == 0
    dead["active"] = dead["active"] & ~tile_dead
    dead["found"] = dead["found"] & ~tile_dead
    yield "dead_tiles_2^16", (dead, all_gates, True, True, tables), False
    for n in (1, 127, 129, (1 << 20) + 77):
        yield f"n_{n}", (random_shade_lanes(n, 8 + n % 7, dev), all_gates, True, True, tables), False
    for off in (1, 3):
        whole = random_shade_lanes(1000 + off, 20 + off, dev)
        view = {k: v[off:] if isinstance(v, torch.Tensor) else v for k, v in whole.items()}
        yield f"storage_offset_{off}_lanes", (view, all_gates, True, True, tables), False


def random_shade_lanes(n: int, seed: int, dev, dead_blocks: bool = False):
    """B5's inputs for `n` random lanes with every lobe in play (the
    material ranges of tests/test_shade_kernel.py:30-64, smooth, thin and
    anisotropic lanes among them), random light samples and state; with
    `dead_blocks` every other run of 4096 lanes is neither active nor
    found."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def unit():
        v = rng.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)

    def uni(lo=0.0, hi=1.0, shape=(n,)):
        return rng.uniform(lo, hi, size=shape).astype(np.float32)

    rough = uni()
    rough[: n // 8] = uni(0.0, 0.03, (n // 8,))  # a smooth band
    active = rng.uniform(size=n) < 0.9
    if dead_blocks:
        active &= (np.arange(n) // 4096) % 2 == 1
    a = dict(
        o=uni(-1, 1, (n, 3)), d=unit(), n=unit(), p=uni(-1, 1, (n, 3)), atten=uni(0.05, 1, (n, 3)),
        last_p=uni(-1, 1, (n, 3)), base=uni(0.05, 1, (n, 3)),
        emission=np.where(rng.uniform(size=(n, 1)) < 0.3, uni(0.5, 5, (n, 3)), 0).astype(np.float32),
        volume_color=uni(0, 1, (n, 3)), ls_wi=unit(), ls_Li=uni(0, 4, (n, 3)), ls_n=unit(),
        ls_p=uni(-2, 2, (n, 3)),
        last_pdf=uni(0, 3), acc_rough=uni(0, 1), hit_t=uni(0, 3),
        u0=uni(), u1=uni(), uc=uni(), uc2=uni(), u_rr=uni(),
        metallic=uni(), roughness=rough, roughness_base=rough, transmission=uni(), ior=uni(1.05, 2.2),
        anisotropic=uni(), aniso_rotation=uni(-3, 3), clearcoat=uni(), cc_roughness=uni(),
        cc_roughness_base=uni(), volume_density=uni(0, 2), pdf_area=uni(0, 2), sel_p=uni(0, 1),
        ls_pdf=uni(0, 2), ls_select_p=uni(0, 1),
        active=active, found=active & (rng.uniform(size=n) < 0.9), specular_prev=rng.uniform(size=n) < 0.2,
        light_neg=rng.uniform(size=n) < 0.7, hit_back=rng.uniform(size=n) < 0.3,
        thin=rng.uniform(size=n) < 0.3, ls_valid=rng.uniform(size=n) < 0.9,
        ls_is_env=rng.uniform(size=n) < 0.3,
    )
    inp = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in a.items()}
    inp.update(depth0=False, rr_on=True, reg_threshold=0.5)
    return inp


def capture_shade_call(scene, meta, cam_cfg, spp: int, dev, call: int = 1, twin: bool = False):
    """The inputs of B5's call number `call` (0 = bounce 0; the first wave
    runs its first bounces at full width) in a render with
    shade_kernel="pallas": (inp, gates, mis, any_lights, tables). With
    `twin` the render's shade calls run B5's plain twin."""
    from yart_tpu_torch.config import RenderConfig
    from yart_tpu_torch.kernels import shade
    from yart_tpu_torch.render.renderer import Renderer

    got = []
    orig = shade.shade

    def record(inp, gates, mis, any_lights, tables):
        if len(got) <= call:
            got.append((dict(inp), gates, mis, any_lights, tables))
        return (shade.shade_plain if twin else orig)(inp, gates, mis, any_lights, tables)

    cfg = RenderConfig(samples=spp, max_depth=call + 1, first_wave_samples=spp, max_wave_samples=spp,
                       shade_kernel="pallas", tonemap="none", estimator="mean")
    shade.shade = record
    try:
        Renderer(scene, meta, cam_cfg, cfg, device=dev).render()
    finally:
        shade.shade = orig
    return got[call]


def b6_cases(dev):
    """(name, (sampler, lane states, dim0), timed) of phase 3j: the lane
    states of a 512x512 render's first chunk (4 samples a pixel: 2^20
    lanes) at bounce dimensions 4 and 28, ZSobol at 16 spp (even log2spp)
    and 8 spp (odd: the pow2_samples branch), a ragged 1000, and hash."""
    from yart_tpu_torch.ops import qmc

    for spp in (16, 8):
        zs = qmc.ZSobolSampler(spp, (512, 512), device=dev)
        lanes = pixel_lanes(512, 4, zs, dev)
        for d0 in (4, 28):
            yield f"zsobol_{spp}spp_dim{d0}_2^20", (zs, lanes, d0), d0 == 4
        yield f"zsobol_{spp}spp_ragged_1000", (zs, lanes[:1000].contiguous(), 12), False
    hs = qmc.HashSampler(16, (512, 512), device=dev)
    yield "hash_dim4_2^20", (hs, pixel_lanes(512, 4, hs, dev), 4), True


def pixel_lanes(side: int, spp: int, sampler, dev):
    """The lane states of a side x side, spp render's first chunk."""
    import torch

    yy, xx = torch.meshgrid(torch.arange(side, device=dev), torch.arange(side, device=dev), indexing="ij")
    px = xx.reshape(-1).repeat_interleave(spp)
    py = yy.reshape(-1).repeat_interleave(spp)
    s = torch.arange(spp, device=dev).repeat(side * side)
    return sampler.init_lanes(px, py, s)


@contextlib.contextmanager
def intersection_forced_to_plain():
    """Test-only switch for phases 3e, 3i, 3l and 5: route the intersection
    paths' B1, B2, B3, B4, B7a and B7b calls to the plain twins (on the
    same CUDA tensors) instead of the kernels."""
    from yart_tpu_torch.kernels import blocktrace as legacy
    from yart_tpu_torch.kernels import brute, clusterpairs, fusedtrace, presort

    saved = (brute.brute_intersect, presort.presort_keys, fusedtrace.fused_trace, clusterpairs.cluster_pairs,
             legacy.select_clusters, legacy.test_clusters)
    brute.brute_intersect = brute.brute_plain
    presort.presort_keys = presort.presort_plain
    fusedtrace.fused_trace = fusedtrace.fused_trace_plain
    clusterpairs.cluster_pairs = clusterpairs.cluster_pairs_plain
    legacy.select_clusters = legacy.select_clusters_plain
    legacy.test_clusters = legacy.test_clusters_plain
    try:
        yield
    finally:
        (brute.brute_intersect, presort.presort_keys, fusedtrace.fused_trace, clusterpairs.cluster_pairs,
         legacy.select_clusters, legacy.test_clusters) = saved


def reset_counts():
    from yart_tpu_torch.kernels import blocktrace as legacy
    from yart_tpu_torch.kernels import brute, clusterpairs, fusedtrace, presort, shade
    from yart_tpu_torch.render import bintrace, blocktrace, integrator, stacktrace

    for m in (brute, presort, fusedtrace, clusterpairs, bintrace, stacktrace):
        m.COUNTS.reset()
    shade.COUNTS_SHADE.reset()
    shade.COUNTS_DRAWS.reset()
    legacy.COUNTS_SELECT.reset()
    legacy.COUNTS_TEST.reset()
    blocktrace.GATED.reset()
    blocktrace.LEGACY.reset()
    integrator.BOUNCES.reset()


def main_path_config(spp: int, max_depth: int = 30, shade_kernel: str = "off"):
    """The RenderConfig of the main-path renders. The CLI's wave plan
    (first wave 8, doubling up to 128): the first wave probes per-depth
    live lanes and the later ones run the compaction the autotune picks,
    so the staged-compaction path runs on the card."""
    from yart_tpu_torch.config import RenderConfig

    return RenderConfig(samples=spp, max_depth=max_depth, sampler="zsobol", estimator="gmon",
                        tonemap="agx", first_wave_samples=8, max_wave_samples=128, shade_kernel=shade_kernel)


def render_main_path(name, scene, meta, cam_cfg, spp, dev, shade_kernel: str = "off", max_depth: int = 30):
    """Drive Renderer on the card with every kernel count set to 0 just
    before; returns (record, {kernel: launches}, HDR image) read just
    after."""
    import numpy as np
    import torch

    from yart_tpu_torch.io.image import write_png
    from yart_tpu_torch.kernels import blocktrace as legacy
    from yart_tpu_torch.kernels import brute, clusterpairs, fusedtrace, presort, shade
    from yart_tpu_torch.render import bintrace, blocktrace, integrator, stacktrace
    from yart_tpu_torch.render.renderer import Renderer

    cfg = main_path_config(spp, max_depth, shade_kernel)
    waves = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.time()
    res = Renderer(scene, meta, cam_cfg, cfg, device=dev).render(
        on_wave=lambda wd, _: waves.append(
            {"wave": wd.wave, "spp": wd.wave_samples, "compaction": wd.compact,
             "seconds": round(wd.time, 3)}
        )
    )
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernel_launches(), shade=shade.COUNTS_SHADE.launches, draws=shade.COUNTS_DRAWS.launches)
    bounces = integrator.BOUNCES.bounces
    modes = dict(fusedtrace.COUNTS.modes)
    gated = {"calls": blocktrace.GATED.calls, "casts": blocktrace.GATED.casts,
             "casts_per_call": blocktrace.GATED.casts / max(blocktrace.GATED.calls, 1)}
    bt = bintrace.COUNTS
    bins = {"calls": bt.calls, "rounds": bt.rounds, "rounds_per_call": bt.rounds / max(bt.calls, 1),
            "collect_iters_per_round": sum(bt.iters) / max(len(bt.iters), 1),
            "collect_iters_max": max(bt.iters, default=0)}
    sc = stacktrace.COUNTS
    stack = {"calls": sc.calls, "iters_per_call": sum(sc.iters) / max(sc.calls, 1),
             "iters_max": max(sc.iters, default=0)}
    plain_cuda = (brute.COUNTS.plain_cuda + presort.COUNTS.plain_cuda + fusedtrace.COUNTS.plain_cuda
                  + clusterpairs.COUNTS.plain_cuda + shade.COUNTS_SHADE.plain_cuda + shade.COUNTS_DRAWS.plain_cuda
                  + legacy.COUNTS_SELECT.plain_cuda + legacy.COUNTS_TEST.plain_cuda)
    peak = torch.cuda.max_memory_allocated(dev)
    if plain_cuda != 0:
        raise AssertionError(f"{name}: the plain twins ran {plain_cuda} times on CUDA tensors in the render")
    if launches["select_clusters"] or launches["test_clusters"]:
        raise AssertionError(f"{name}: a render took the round-based block trace (B7a / B7b): {launches}")
    hdr = res.hdr
    if not np.isfinite(hdr).all() or not hdr.mean() > 0.01:
        raise AssertionError(f"{name}: bad image: finite={np.isfinite(hdr).all()} mean={hdr.mean()}")
    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, f"{name}_{shade_kernel}_{cam_cfg.image_size[0]}_d{max_depth}.png")
    write_png(png, res.display)
    rec = {"phase": "render", "scene": name, "shade_kernel": shade_kernel, "n_tris": int(meta.n_tris),
           "size": list(cam_cfg.image_size), "spp": res.samples_taken, "max_depth": max_depth,
           "wall_s": round(wall, 3), "rays": res.total_rays,
           "mrays_per_s": res.total_rays / wall / 1e6, "peak_mem_gib": peak / 2 ** 30,
           "launches": launches, "bounces": bounces, "fused_trace_modes": modes, "gated": gated,
           "bintrace": bins, "stack": stack, "plain_calls_on_cuda": plain_cuda, "waves": waves,
           "hdr_mean": [float(x) for x in hdr.mean(axis=(0, 1))], "png": os.path.relpath(png, ROOT)}
    return rec, dict(launches, fused_trace_modes=modes, bounces=bounces, rays=res.total_rays, stack=stack), hdr


def images_equivalent(a, b, rays_a, rays_b) -> dict:
    """tests/test_shade_kernel.py:209-222 `_assert_images_equivalent`'s four
    criteria, measured: >= 99% of pixels within 1e-3 relative, the median
    relative difference under 1e-5, the means within 2%, the ray counts
    within max(8, 0.5%)."""
    import numpy as np

    rel = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
    r = {"close_share": float((rel < 1e-3).mean()), "median_rel": float(np.median(rel)),
         "mean_rel": float(abs(a.mean() - b.mean()) / max(a.mean(), 1e-6)), "rays": [rays_a, rays_b]}
    r["meets_bar"] = bool(r["close_share"] > 0.99 and r["median_rel"] < 1e-5 and r["mean_rel"] < 0.02
                          and abs(rays_a - rays_b) <= max(8.0, 0.005 * rays_a))
    return r


def pallas_equals_xla(name, scene, meta, cam, dev):
    """A small render with shade_kernel="pallas" (B6 + B5) equal bitwise to
    the same render with "xla" (their plain PyTorch math), on the card."""
    import numpy as np

    from yart_tpu_torch.config import RenderConfig
    from yart_tpu_torch.kernels import shade
    from yart_tpu_torch.render.renderer import Renderer

    imgs = {}
    for mode in ("xla", "pallas"):
        cfg = RenderConfig(samples=2, max_depth=4, tonemap="none", estimator="mean", first_wave_samples=2,
                           max_wave_samples=2, shade_kernel=mode)
        before = shade.COUNTS_SHADE.launches
        res = Renderer(scene, meta, cam, cfg, device=dev).render()
        imgs[mode] = (res.hdr, res.total_rays, shade.COUNTS_SHADE.launches - before)
    (a, ra, la), (b, rb, lb) = imgs["xla"], imgs["pallas"]
    if la != 0 or lb <= 0:
        raise AssertionError(f"{name}: B5 launched {la} times under xla and {lb} under pallas")
    if not (np.isfinite(b).all() and np.array_equal(a.view(np.int32), b.view(np.int32)) and ra == rb):
        raise AssertionError(f"{name}: pallas and xla images differ (max abs {np.abs(a - b).max()}, "
                             f"rays {ra} vs {rb})")
    return {"phase": "reference", "scene": name, "size": list(cam.image_size), "spp": 2, "max_depth": 4,
            "pallas_eq_xla_bitwise": True, "b5_launches": lb, "rays": ra, "mean": float(b.mean())}


def reference_check(name, scene, meta, gcam, gcfg, golden_key, dev, twin: bool = True):
    """Kernel-path image == plain-path image bitwise (with `twin`); channel
    means within GOLDEN_MEAN_RTOL of the golden's (with a `golden_key`)."""
    import numpy as np

    from yart_tpu_torch.render.renderer import Renderer

    t0 = time.time()
    img_k = Renderer(scene, meta, gcam, gcfg, device=dev).render().hdr
    if not np.isfinite(img_k).all():
        raise AssertionError(f"{name}: non-finite pixels")
    rec = {"phase": "reference", "scene": name, "size": list(gcam.image_size), "spp": gcfg.samples,
           "max_depth": gcfg.max_depth, "kernel_path_s": round(time.time() - t0, 3)}
    if twin:
        t0 = time.time()
        with intersection_forced_to_plain():
            img_p = Renderer(scene, meta, gcam, gcfg, device=dev).render().hdr
        if not np.array_equal(img_k.view(np.int32), img_p.view(np.int32)):
            raise AssertionError(
                f"{name}: kernel-path and plain-path images differ (max abs {np.abs(img_k - img_p).max()})"
            )
        rec.update(kernel_eq_plain_bitwise=True, twin_path_s=round(time.time() - t0, 3))
    if golden_key is None:
        return dict(rec, mean=[float(x) for x in img_k.mean(axis=(0, 1))])
    with np.load(GOLDEN) as z:
        golden = z[golden_key]
    gm, km = golden.mean(axis=(0, 1)), img_k.mean(axis=(0, 1))
    rel = np.abs(km - gm) / gm
    if not (rel <= GOLDEN_MEAN_RTOL).all():
        raise AssertionError(f"{name}: channel means {km} vs golden {gm}: rel {rel} > {GOLDEN_MEAN_RTOL}")
    return dict(rec, config=f"golden_v1 {golden_key}", mean=[float(x) for x in km],
                golden_mean=[float(x) for x in gm], rel_err=[float(x) for x in rel], rtol=GOLDEN_MEAN_RTOL)


def instanced_vs_baked(inst, inst_meta, pos, fwd, dev):
    """The instanced atrium against the baked atrium() (built here on the
    host), both through the kernels, at 64x64, 16 spp: identical sample
    streams, so only the rounding of transform-at-trace against baked
    vertices differs (tests/test_instancing.py:120-136's bar)."""
    import numpy as np

    from yart_tpu_torch.config import CameraConfig, RenderConfig
    from yart_tpu_torch.render.renderer import Renderer
    from yart_tpu_torch.scene.showcase import atrium

    t0 = time.time()
    baked, baked_meta = atrium().compile(dev)
    build_s = time.time() - t0
    cam = CameraConfig(image_size=(64, 64), focal_length=35.0, position=pos, forward=fwd, exposure=3.0)
    cfg = RenderConfig(samples=16, max_depth=4, tonemap="none", estimator="mean",
                       first_wave_samples=16, max_wave_samples=16)
    img_i = Renderer(inst, inst_meta, cam, cfg, device=dev).render().hdr
    img_b = Renderer(baked, baked_meta, cam, cfg, device=dev).render().hdr
    if not (np.isfinite(img_i).all() and np.isfinite(img_b).all()):
        raise AssertionError("atrium-inst vs baked: non-finite pixels")
    close = float(np.isclose(img_i, img_b, rtol=INSTANCED_PIXEL_TOL, atol=INSTANCED_PIXEL_TOL).mean())
    mi, mb = img_i.mean(axis=(0, 1)), img_b.mean(axis=(0, 1))
    rel = np.abs(mi - mb) / np.abs(mb)
    if close < INSTANCED_PIXEL_SHARE or not (rel <= INSTANCED_MEAN_RTOL).all():
        raise AssertionError(f"atrium-inst vs baked atrium: {close:.4f} of pixels within "
                             f"{INSTANCED_PIXEL_TOL}, channel means rel {rel}")
    return {"phase": "reference", "scene": "atrium-inst vs baked atrium", "size": [64, 64], "spp": 16,
            "max_depth": 4, "baked_build_s": round(build_s, 3), "baked_n_tris": int(baked_meta.n_tris),
            "pixels_close": close, "pixel_tol": INSTANCED_PIXEL_TOL, "mean": [float(x) for x in mi],
            "baked_mean": [float(x) for x in mb], "rel_err": [float(x) for x in rel],
            "mean_rtol": INSTANCED_MEAN_RTOL}


# The differentiable path (phase 6): the kernel path's gradient against the
# twin path's, and each remat policy's against the first, within this share
# of the gradient's largest entry (the backward of a gather accumulates with
# atomics on the card, so the last bits of a sum may differ between runs;
# the radiance is compared bitwise).
GRAD_REL_TOL = 1e-5


def traversal_launches() -> dict:
    """B1-B3 launches so far (B3's also by mode) and their twins' calls on
    CUDA tensors."""
    from yart_tpu_torch.kernels import brute, fusedtrace, presort

    out = {"brute_intersect": brute.COUNTS.launches, "presort_keys": presort.COUNTS.launches,
           "fused_trace": fusedtrace.COUNTS.launches,
           "plain_cuda": brute.COUNTS.plain_cuda + presort.COUNTS.plain_cuda + fusedtrace.COUNTS.plain_cuda}
    out.update({f"fused_trace.{k}": v for k, v in fusedtrace.COUNTS.modes.items()})
    return out


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a.get(k, 0) for k in b if b[k] - a.get(k, 0)}


def diff_leaves(scene, names, cfg):
    """({name: leaf that requires grad}, the scene rebuilt on them, cfg):
    a material field by name, "env_image" (its rows rebuilt from it, as
    `diff.env_grads` does), "tex_rgba" (its quad rows rebuilt, as
    `diff.texture_grads`) or "proto_pos" (with diff_geometry on)."""
    import dataclasses

    from yart_tpu_torch.render.lights import env_rows_from_image
    from yart_tpu_torch.render.texture import qrows_from_data

    xs, mats = {}, {}
    for k in names:
        if k == "env_image":
            x = xs[k] = scene.env_image.clone().requires_grad_(True)
            scene = dataclasses.replace(scene, env_image=x, env_rows=env_rows_from_image(x, scene.env_rows[:, 12]))
        elif k == "tex_rgba":
            x = xs[k] = scene.tex_rgba.data.clone().requires_grad_(True)
            scene = dataclasses.replace(scene, tex_rgba=scene.tex_rgba._replace(data=x, qrows=qrows_from_data(x)))
        elif k == "proto_pos":
            x = xs[k] = scene.proto_pos.clone().requires_grad_(True)
            scene = dataclasses.replace(scene, proto_pos=x)
            cfg = dataclasses.replace(cfg, diff_geometry=True)
        else:
            mats[k] = xs[k] = getattr(scene.materials, k).clone().requires_grad_(True)
    if mats:
        scene = dataclasses.replace(scene, materials=scene.materials._replace(**mats))
    return xs, scene, cfg


def fwdbwd_inputs(cam_cfg, spp: int, dev):
    """(camera, ZSobol sampler, (px, py, sample index)) of every pixel and
    sample of the square image of `cam_cfg`."""
    import torch

    from yart_tpu_torch.ops.qmc import make_sampler
    from yart_tpu_torch.render.camera import build_camera

    side = cam_cfg.image_size[0]
    yy, xx = torch.meshgrid(torch.arange(side, device=dev), torch.arange(side, device=dev), indexing="ij")
    lanes = (xx.reshape(-1).repeat_interleave(spp), yy.reshape(-1).repeat_interleave(spp),
             torch.arange(spp, device=dev).repeat(side * side))
    return build_camera(cam_cfg, dev), make_sampler("zsobol", spp, (side, side), 0, device=dev), lanes


def fwdbwd_once(scene, meta, cam, sampler, cfg, lanes, leaves) -> dict:
    """One differentiable render and the backward of its mean radiance
    w.r.t. `leaves`, timed (host clock, synchronised); the B1-B3 launches
    of the forward and of the backward."""
    import torch

    from yart_tpu_torch.render.integrator import render_wave

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs, s, c = diff_leaves(scene, leaves, cfg)
    l0 = traversal_launches()
    rad, rays = render_wave(s, meta, cam, sampler, c, *lanes, differentiable=True)
    loss = rad.mean()
    l1 = traversal_launches()
    grads = torch.autograd.grad(loss, list(xs.values()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"rad": rad.detach(), "rays": float(rays), "grads": dict(zip(xs, grads)), "wall": wall,
            "fwd": _delta(l0, l1), "bwd": _delta(l1, traversal_launches())}


def grad_rel_err(a: dict, b: dict) -> dict:
    """max |a - b| over the largest |b|, per leaf."""
    return {k: float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-30) for k in b}


def fwdbwd_case(name, scene, meta, cam_cfg, spp: int, dev, cfg, leaves, kernels, policies=None,
                shade_kernels=("off",), twin: bool = False, reps: int = 2) -> dict:
    """Phase 6's measurement of one fwd+bwd shape: the forward-only render
    (`render_wave`, no grad) and, per shade kernel and remat policy, the
    differentiable render with the backward of its mean radiance w.r.t.
    `leaves`, each `reps` times (the last one timed: wall, Mrays/s over the
    rays the forward counts, the ratio to the forward, peak memory). Raises
    unless the gradients are finite and non-zero, every traversal kernel of
    `kernels` launched in the forward, none of B1-B3 in a backward, no twin
    on CUDA; and unless every policy's radiance equals the first's bitwise
    and its gradients within GRAD_REL_TOL. With `twin`, the same for the
    first configuration with the traversal forced to the plain twins, at
    the case's shape (True) or at (side, spp[, max_depth])."""
    import dataclasses

    import torch

    from yart_tpu_torch.render.integrator import render_wave

    t_case = time.time()
    side = cam_cfg.image_size[0]
    cam, sampler, lanes = fwdbwd_inputs(cam_cfg, spp, dev)
    rec = {"phase": "fwdbwd", "case": name, "smi": nvidia_smi(), "lanes": int(lanes[0].shape[0]),
           "size": [side, side], "spp": spp, "max_depth": cfg.max_depth, "rr_start_depth": cfg.rr_start_depth,
           "compact": [cfg.compact_depth, cfg.compact_factor], "leaves": list(leaves), "forward": {}, "runs": {}}
    firsts = {}
    for sk in shade_kernels:
        fwd_walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                rad_f, rays_f = render_wave(scene, meta, cam, sampler, dataclasses.replace(cfg, shade_kernel=sk),
                                            *lanes)
            torch.cuda.synchronize()
            fwd_walls.append(time.perf_counter() - t0)
        rec["forward"][sk] = {"wall_s": round(fwd_walls[-1], 4), "rays": float(rays_f),
                              "mrays_per_s": float(rays_f) / fwd_walls[-1] / 1e6}
        for remat in policies or (cfg.remat,):
            c = dataclasses.replace(cfg, shade_kernel=sk, remat=remat)
            for _ in range(reps):
                torch.cuda.reset_peak_memory_stats(dev)
                r = fwdbwd_once(scene, meta, cam, sampler, c, lanes, leaves)
            peak = torch.cuda.max_memory_allocated(dev)
            key = f"{sk}/{remat}"
            bad = [k for k, g in r["grads"].items() if not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
            if bad:
                raise AssertionError(f"{name} {key}: gradients not finite or all zero: {bad}")
            if r["bwd"] or any(r["fwd"].get(k, 0) <= 0 for k in kernels) or r["fwd"].get("plain_cuda"):
                raise AssertionError(f"{name} {key}: traversal launches forward {r['fwd']} backward {r['bwd']}")
            if "proto_pos" in leaves:
                # The refit re-solves t, u, v from the vertices (MT in world space
                # against the traversal's cluster test: u and v move by up to ~2e-4
                # at 20 m, and a texel edge can move with them), so the image is
                # held to the plain one on average: mean |difference| within 1e-3
                # of the mean radiance; the largest difference is recorded.
                diff = (r["rad"] - rad_f).abs()
                refit = {"max_abs": float(diff.max()), "mean_abs": float(diff.mean()),
                         "mean_radiance": float(rad_f.abs().mean())}
                # A moved hit point can change a lane's later rays: the counts
                # within 0.5%.
                refit["rays"], refit["plain_rays"] = r["rays"], float(rays_f)
                if abs(r["rays"] - float(rays_f)) > 5e-3 * float(rays_f) \
                        or not refit["mean_abs"] <= 1e-3 * refit["mean_radiance"]:
                    raise AssertionError(f"{name} {key}: the refit forward is off the plain render: {refit}")
                rec["refit_vs_plain"] = refit
            elif r["rays"] != float(rays_f) or not bits_equal(r["rad"], rad_f):
                raise AssertionError(f"{name} {key}: the differentiable forward differs from the plain render")
            run = {"wall_s": round(r["wall"], 4), "mrays_per_s": r["rays"] / r["wall"] / 1e6,
                   "fwdbwd_over_forward": r["wall"] / fwd_walls[-1], "peak_mem_gib": peak / 2 ** 30,
                   "launches_forward": r["fwd"], "launches_backward": r["bwd"],
                   "grad_abs_max": {k: float(g.abs().max()) for k, g in r["grads"].items()}}
            if sk not in firsts:
                firsts[sk] = r
            else:
                run["grad_rel_err_vs_first_policy"] = err = grad_rel_err(r["grads"], firsts[sk]["grads"])
                if not bits_equal(r["rad"], firsts[sk]["rad"]) or max(err.values()) > GRAD_REL_TOL:
                    raise AssertionError(f"{name} {key}: differs from the first policy: {err}")
            rec["runs"][key] = run
    first = firsts[shade_kernels[0]]
    rec["rays"] = first["rays"]
    if len(shade_kernels) > 1:
        # The fused shade math orders its floats otherwise, and at 524,288
        # lanes over 6 bounces the gradients part by ~8e-4 of the largest
        # entry on an H100 (PERF.md §5): a sanity bar of 5e-3.
        rec["grad_rel_err_xla_vs_off"] = err = grad_rel_err(firsts[shade_kernels[1]]["grads"], first["grads"])
        if max(err.values()) > 5e-3:
            raise AssertionError(f"{name}: {shade_kernels[1]} against {shade_kernels[0]}: {err}")
    if twin:
        # The twins of B2 and B3 are slow on the card (6b's twin path took 678 s
        # at its 65,536 lanes and 78 s at 1,024 on an H100): `twin` = (side,
        # spp) compares the two paths at that smaller shape, True at the case's.
        c = dataclasses.replace(cfg, shade_kernel=shade_kernels[0], remat=(policies or (cfg.remat,))[0])
        if twin is not True and len(twin) > 2:
            c = dataclasses.replace(c, max_depth=twin[2])
        t_in = (cam, sampler, lanes) if twin is True else fwdbwd_inputs(
            dataclasses.replace(cam_cfg, image_size=(twin[0], twin[0])), twin[1], dev)
        k = first if twin is True else fwdbwd_once(scene, meta, *t_in[:2], c, t_in[2], leaves)
        with intersection_forced_to_plain():
            t = fwdbwd_once(scene, meta, *t_in[:2], c, t_in[2], leaves)
        err = grad_rel_err(t["grads"], k["grads"])
        if any(t["fwd"].get(k_, 0) for k_ in kernels) or t["bwd"] or k["bwd"] or not bits_equal(t["rad"], k["rad"]) \
                or max(err.values()) > GRAD_REL_TOL:
            raise AssertionError(f"{name}: kernel path against twin path: rel err {err}, launches {t['fwd']}")
        rec["twin"] = {"lanes": int(t_in[2][0].shape[0]), "radiance_bitwise": True, "grad_rel_err": err,
                       "twin_wall_s": round(t["wall"], 4)}
    rec["seconds"] = round(time.time() - t_case, 3)
    emit(rec)
    return rec


def inverse_render_case(dev, side: int = 64, spp: int = 4, steps: int = 60) -> dict:
    """Phase 6f: tests/test_inverse.py's problem on the card at 64x64, 4
    spp, depth 3: the cornell red wall perturbed to (0.3, 0.3, 0.6), 60 Adam
    steps at lr 0.05, only row 1 free. Raises unless the loss falls by more
    than 95%, the colour comes back within 0.05 and the frozen rows stay
    as they were; B1 launches exactly in the forwards (the autotune probe
    and one per step), never in a backward. Emits and returns the record."""
    import dataclasses

    import numpy as np
    import torch

    from yart_tpu_torch.config import CameraConfig, RenderConfig
    from yart_tpu_torch.render.integrator import render_wave
    from yart_tpu_torch.scene.procedural import cornell_box
    from yart_tpu_torch.tools.inverse_render import optimize_materials

    scene, meta = cornell_box().compile(dev)
    cam, sampler, lanes = fwdbwd_inputs(CameraConfig(image_size=(side, side), focal_length=28.0,
                                                     position=(0, 1.0, 3.4), forward=(0, 0, -1)), spp, dev)
    cfg = RenderConfig(samples=spp, max_depth=3, rr_start_depth=99)
    l0 = traversal_launches()
    with torch.no_grad():
        target, _ = render_wave(scene, meta, cam, sampler, cfg, *lanes)
    per_forward = _delta(l0, traversal_launches()).get("brute_intersect", 0)
    bc_true = scene.materials.base_color.cpu().numpy()
    bc_bad = bc_true.copy()
    bc_bad[1, :3] = (0.3, 0.3, 0.6)
    bad = dataclasses.replace(scene, materials=scene.materials._replace(base_color=torch.from_numpy(bc_bad).to(dev)))
    mask = np.zeros(bc_bad.shape[0], bool)
    mask[1] = True
    torch.cuda.synchronize()
    l0 = traversal_launches()
    t0 = time.perf_counter()
    res = optimize_materials(bad, meta, cam, sampler, cfg, *lanes, target, steps=steps, lr=0.05, mask=mask)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _delta(l0, traversal_launches())
    got = res.base_color.cpu().numpy()
    rec = {"phase": "fwdbwd", "case": "inverse_render", "smi": nvidia_smi(), "lanes": int(lanes[0].shape[0]),
           "size": [side, side], "spp": spp, "max_depth": 3, "steps": steps, "wall_s": round(wall, 3),
           "s_per_step": wall / steps, "loss_first": res.losses[0], "loss_last": res.losses[-1],
           "loss_drop": 1.0 - res.losses[-1] / res.losses[0], "recovered": got[1, :3].tolist(),
           "true": bc_true[1, :3].tolist(), "launches": launches, "b1_per_forward": per_forward}
    if not (res.losses[-1] < 0.05 * res.losses[0] and np.abs(got[1, :3] - bc_true[1, :3]).max() <= 0.05
            and np.array_equal(np.delete(got, 1, axis=0), np.delete(bc_bad, 1, axis=0))):
        raise AssertionError(f"inverse render did not recover the wall: {rec}")
    if launches != {"brute_intersect": (steps + 1) * per_forward}:
        raise AssertionError(f"inverse render: B1 launched {launches}, not {steps + 1} forwards x {per_forward}")
    emit(rec)
    return rec


def fwdbwd_launch_table(recs: dict, kernel: str) -> dict:
    """{case: {"forward": launches, "backward": launches}} of `kernel` in
    one fwd+bwd of each phase-6 case (its first configuration; the inverse
    render's whole loop)."""
    out = {}
    for rec in recs.values():
        if not isinstance(rec, dict):
            continue
        if "runs" in rec:
            run = next(iter(rec["runs"].values()))
            f, b = run["launches_forward"].get(kernel, 0), run["launches_backward"].get(kernel, 0)
        else:
            f, b = rec["launches"].get(kernel, 0), 0
        if f or b:
            out[rec["case"]] = {"forward": f, "backward": b}
    return out


def fwdbwd_phases(dev, scenes: dict) -> dict:
    """Phase 6: the differentiable path on the card, shapes from bench.py's
    fwd+bwd rows. `scenes` maps cornell-mat, atrium-ivy, atrium, roadster
    and atrium-inst to (scene, meta, camera position, forward). Emits each
    record as its case completes; returns them by case."""
    from yart_tpu_torch.config import CameraConfig, RenderConfig

    def cam(key, side, exposure=0.0):
        pos, fwd = scenes[key][2:]
        return CameraConfig(image_size=(side, side), focal_length=35.0, position=pos, forward=fwd,
                            exposure=exposure)

    recs = {}
    t0 = time.time()
    sc, mt = scenes["cornell-mat"][:2]
    recs["6a"] = fwdbwd_case(
        "cornell_fwdbwd", sc, mt, cam("cornell-mat", 256), 8, dev,
        RenderConfig(samples=8, max_depth=6, rr_start_depth=99, compact_depth=None), ("base_color",),
        ("brute_intersect",), policies=("trace_lut", "trace", "all"), shade_kernels=("off", "xla"), twin=True)
    sc, mt = scenes["atrium-ivy"][:2]
    recs["6b"] = fwdbwd_case(
        "atrium_ivy_fwdbwd", sc, mt, cam("atrium-ivy", 128, 3.0), 4, dev,
        RenderConfig(samples=4, max_depth=6, rr_start_depth=99, compact_depth=4, compact_factor=2),
        ("base_color", "tex_rgba"), ("presort_keys", "fused_trace.amask"), twin=(8, 4))
    sc, mt = scenes["atrium"][:2]
    recs["6c"] = fwdbwd_case(
        "atrium_fwdbwd_rr", sc, mt, cam("atrium", 128, 3.0), 4, dev,
        RenderConfig(samples=4, max_depth=8, rr_start_depth=2, compact_depth="auto"),
        ("base_color", "env_image"), ("presort_keys", "fused_trace.closest", "fused_trace.nee"))
    sc, mt = scenes["roadster"][:2]
    recs["6d"] = fwdbwd_case(
        "roadster_fwdbwd", sc, mt, cam("roadster", 128, 1.0), 4, dev,
        RenderConfig(samples=4, max_depth=6, rr_start_depth=99, compact_depth=2, compact_factor=4),
        ("base_color", "clearcoat", "volume_density"), ("presort_keys", "fused_trace"))
    sc, mt = scenes["atrium-inst"][:2]
    recs["6e"] = fwdbwd_case(
        "atrium_inst_geometry", sc, mt, cam("atrium-inst", 128, 3.0), 2, dev,
        RenderConfig(samples=2, max_depth=4, rr_start_depth=99, compact_depth=None),
        ("proto_pos",), ("presort_keys", "fused_trace.instanced", "fused_trace.instanced+nee"), twin=(16, 2))
    recs["6f"] = inverse_render_case(dev)
    sc, mt = scenes["atrium-ivy"][:2]
    recs["full_width"] = fwdbwd_case(
        "atrium_ivy_fwdbwd_2^20", sc, mt, cam("atrium-ivy", 512, 3.0), 4, dev,
        RenderConfig(samples=4, max_depth=8, rr_start_depth=2, compact_depth="auto", remat="trace_lut"),
        ("base_color",), ("presort_keys", "fused_trace.amask"), reps=1)
    recs["seconds"] = round(time.time() - t0, 3)
    return recs


# ---- phase 7: the stack traversals and the per-instance loop --------------


def kernel_launches() -> dict:
    """Launches of B1-B4, B7a and B7b so far."""
    from yart_tpu_torch.kernels import blocktrace as legacy
    from yart_tpu_torch.kernels import brute, clusterpairs, fusedtrace, presort

    return {"brute_intersect": brute.COUNTS.launches, "presort_keys": presort.COUNTS.launches,
            "fused_trace": fusedtrace.COUNTS.launches, "cluster_pairs": clusterpairs.COUNTS.launches,
            "select_clusters": legacy.COUNTS_SELECT.launches, "test_clusters": legacy.COUNTS_TEST.launches}


def timed_cast(scene, meta, o, d, t_max, **kw):
    """intersect() with every count set to 0 just before: (Hit, wall ms,
    kernel launches, stack-traversal calls, iterations and working sets)."""
    import torch

    from yart_tpu_torch.render import stacktrace
    from yart_tpu_torch.render.intersect import intersect

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    h = intersect(scene, meta, o, d, t_max, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    sc = stacktrace.COUNTS
    return h, ms, kernel_launches(), {"calls": sc.calls, "iters": list(sc.iters), "working_sets": list(sc.sets)}


def native_tree_check(name, builder, scene) -> dict:
    """The host library's tree of `builder`'s triangles (a scene without
    instances), built again here and checked: its leaf order a
    permutation, its leaves covering every triangle once (at most 4 each),
    every box the exact union of its children's (a leaf's, of its
    triangles'), and `scene` (compiled from `builder`) holding this tree
    and its 8-wide collapse in `node_pack` / `wide_pack` and its leaf order
    in `tri_v`. Raises AssertionError on the first check that fails."""
    import numpy as np

    from yart_tpu_torch import native

    pos, tri = np.concatenate(builder._positions), np.concatenate(builder._tris)
    v = [pos[tri[:, k]].astype(np.float32) for k in range(3)]
    t0 = time.perf_counter()
    hb = native.build_bvh(*v)
    bvh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hb8 = native.collapse_bvh8(hb)
    collapse_s = time.perf_counter() - t0
    n = tri.shape[0]

    def check(ok, what):
        if not ok:
            raise AssertionError(f"{name}: the native tree fails: {what}")

    check(np.array_equal(np.sort(hb.tri_order), np.arange(n)), "its leaf order is no permutation")
    leaf = hb.count > 0
    first, count = hb.left[leaf], hb.count[leaf]
    o = np.argsort(first, kind="stable")
    ends = first[o] + count[o]
    check(count.max() <= 4 and first[o][0] == 0 and ends[-1] == n and np.array_equal(first[o][1:], ends[:-1]),
          "its leaves do not cover every triangle once")
    inner = np.nonzero(~leaf)[0]
    lc, rc = hb.left[inner], hb.left[inner] + 1
    check(np.array_equal(hb.node_min[inner], np.minimum(hb.node_min[lc], hb.node_min[rc]))
          and np.array_equal(hb.node_max[inner], np.maximum(hb.node_max[lc], hb.node_max[rc])),
          "a parent box is not the union of its children's")
    lo = np.minimum(np.minimum(v[0], v[1]), v[2])[hb.tri_order]
    hi = np.maximum(np.maximum(v[0], v[1]), v[2])[hb.tri_order]
    li = np.nonzero(leaf)[0][o]
    check(np.array_equal(hb.node_min[li], np.minimum.reduceat(lo, first[o]))
          and np.array_equal(hb.node_max[li], np.maximum.reduceat(hi, first[o])),
          "a leaf box is not the union of its triangles'")
    bits = lambda a: np.ascontiguousarray(a, np.int32).view(np.float32)
    node_pack = np.concatenate([hb.node_min, hb.node_max, bits(hb.left)[:, None], bits(hb.count)[:, None]], axis=1)
    wide_pack = np.concatenate([hb8.boxes.reshape(-1, 48), bits(hb8.child).reshape(-1, 8)], axis=1)
    for key, mine in (("node_pack", node_pack), ("wide_pack", wide_pack)):
        check(np.array_equal(getattr(scene, key).cpu().numpy().view(np.int32), mine.view(np.int32)),
              f"the compiled {key} is another tree")
    check(np.array_equal(scene.tri_v.cpu().numpy(), tri[hb.tri_order].astype(np.int32)),
          "the compiled triangles are in another order")
    return {"n_tris": int(n), "nodes": int(hb.left.shape[0]), "leaves": int(leaf.sum()), "depth": hb.depth,
            "bvh8_groups": int(hb8.child.shape[0]), "bvh8_depth": hb8.depth,
            "rebuild_bvh_s": round(bvh_s, 4), "rebuild_collapse_s": round(collapse_s, 4)}


def leaf_refs_past(wide_pack, first: int) -> int:
    """Leaves of a triangle BVH8 whose first triangle is >= `first`."""
    import torch

    enc = wide_pack[:, 48:56].contiguous().view(torch.int32).long()
    v = -(enc + 2)
    return int(((enc <= -2) & ((v >> 4) >= first)).sum())


def hold_against_gated_brute(name, scene, meta, o, d, t_max, seeds, h, nee: bool, n: int = 4096):
    """The stack traversal's hits `h` on `n` of its lanes (half of them, as
    far as there are, hits on triangles >= 2^20) against the port's gated
    brute on the same lanes, on the card: masks exact; t bitwise where the
    triangle agrees (the same Moller-Trumbore arithmetic); a differing
    triangle only where two triangles tie in t; for shadow rays the
    unoccluded attenuation within rtol 1e-4 / atol 1e-5. Returns the
    record."""
    import torch

    from yart_tpu_torch.render.intersect import intersect_brute

    dev = o.device
    gen = torch.Generator(device=dev).manual_seed(13)
    high = torch.nonzero(h.mask & (h.tri >= (1 << 20)))[:, 0]
    high = high[torch.randperm(high.numel(), generator=gen, device=dev)[: n // 2]]
    rest = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    rest[high] = False
    rest = torch.nonzero(rest)[:, 0]
    idx = torch.cat([high, rest[torch.randperm(rest.numel(), generator=gen, device=dev)[: n - high.numel()]]])
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (o.shape[0],))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = intersect_brute(scene, meta, o[idx].contiguous(), d[idx].contiguous(), t_max[idx], nee=nee,
                        alpha_seed=seeds[idx])
    torch.cuda.synchronize()
    brute_s = time.perf_counter() - t0
    s = {f: getattr(h, f)[idx] for f in h._fields}
    m = b.mask
    if not torch.equal(s["mask"], m):
        raise AssertionError(f"{name}: masks differ from the gated brute on {int((s['mask'] != m).sum())} lanes")
    rec = {"case": name, "nee": nee, "lanes": n, "lanes_hitting_tri_ge_2^20": int(high.numel()),
           "hits": int(m.sum()), "gated_brute_s": brute_s, "masks_equal": True}
    if nee:
        un = ~m
        if not torch.allclose(s["attenuation"][un], b.attenuation[un], rtol=1e-4, atol=1e-5):
            raise AssertionError(f"{name}: unoccluded attenuation differs from the gated brute")
        rec.update(unoccluded=int(un.sum()), attenuated=int((b.attenuation[un] < 1.0).any(dim=1).sum()),
                   attenuation_max_abs_err=float((s["attenuation"][un] - b.attenuation[un]).abs().max())
                   if un.any() else 0.0)
        return rec
    same = m & (s["tri"] == b.tri)
    t_bits = s["t"].view(torch.int32) == b.t.view(torch.int32)
    diff = m & ~same
    ties = diff & t_bits
    if not bool(t_bits[same].all()) or bool((diff & ~t_bits).any()):
        raise AssertionError(f"{name}: t differs from the gated brute on {int((same & ~t_bits).sum())} lanes with "
                             f"the same triangle, {int((diff & ~t_bits).sum())} with another")
    rec.update(t_bitwise_where_tri_equal=True, tri_equal=int(same.sum()), tri_ties=int(ties.sum()),
               u_v_bitwise_where_tri_equal=bool(torch.equal(s["u"][same].view(torch.int32),
                                                            b.u[same].view(torch.int32))
                                                and torch.equal(s["v"][same].view(torch.int32),
                                                                b.v[same].view(torch.int32))))
    return rec


def stack_phases(dev, dense, dense_meta) -> dict:
    """Phase 7: 7a the dense ivy atrium through the stack traversals, 7b
    its render, 7c the dense instanced atrium through the per-instance loop
    (the baked dense atrium of phase 3h, `dense`, beside it). Emits each
    record; returns what the kernels line needs."""
    import numpy as np
    import torch

    from yart_tpu_torch.cli import CAMERAS
    from yart_tpu_torch.config import CameraConfig
    from yart_tpu_torch.render import blocktrace
    from yart_tpu_torch.render.intersect import intersect
    from yart_tpu_torch.scene.showcase import atrium

    out = {}
    t_phase = time.time()
    pos, target = CAMERAS["atrium-ivy"]
    fwd = tuple(t - p for p, t in zip(pos, target))

    # ---- 7a. the dense ivy atrium through the stack traversals ----------
    t0 = time.time()
    builder = atrium(ivy=True, density=3)
    author_s = time.time() - t0
    t0 = time.time()
    ivy3, ivy3_meta = builder.compile(dev)
    torch.cuda.synchronize()
    compile_s = time.time() - t0
    timings = builder.timings
    emit({"phase": "native_build", "scene": "atrium(ivy=True, density=3)", "compile_s": round(compile_s, 3),
          **timings, **native_tree_check("atrium(ivy=True, density=3)", builder, ivy3)})
    del builder
    past = leaf_refs_past(ivy3.wide_pack, 1 << 20)
    emit({"phase": "scene", "scene": "atrium(ivy=True, density=3)", "n_tris": ivy3_meta.n_tris,
          "n_clusters": ivy3_meta.n_clusters, "any_alpha": ivy3_meta.any_alpha,
          "any_transparent": ivy3_meta.any_transparent, "wide_depth": ivy3_meta.wide_depth,
          "bvh_depth": ivy3_meta.bvh_depth, "bvh8_groups": int(ivy3.wide_pack.shape[0]),
          "leaves_first_ge_2^20": past, "textures_and_meshes_s": round(author_s, 3),
          "compile_s": round(compile_s, 3), "build_s": round(author_s + compile_s, 3),
          "sah_build_s": timings["bvh_s"], "bvh8_collapse_s": timings["collapse_s"],
          "tables_s": timings["tables_s"], "collapse_share_of_compile": timings["collapse_s"] / compile_s})
    if ivy3_meta.n_clusters <= blocktrace.MAX_CLUSTERS or not ivy3_meta.any_alpha or past == 0:
        raise AssertionError("the dense ivy atrium is not a gated scene past the cluster cap with leaves at 2^20")
    o, d, seeds = camera_rays(CameraConfig(image_size=(1024, 1024), focal_length=35.0, position=pos, forward=fwd),
                              dev, seeds=True)
    # The process's first stack traversal loads PyTorch's kernels for it:
    # time a cast of 131,072 of the rays (the sorted path) first.
    first_ms = timed_cast(ivy3, ivy3_meta, o[: 1 << 17], d[: 1 << 17], 1e30, alpha_seed=seeds[: 1 << 17])[1]
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    h, ms, launches, stack = timed_cast(ivy3, ivy3_meta, o, d, 1e30, alpha_seed=seeds)
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
    sh_o, sh_d, sh_t = shadow_rays(o, d, h.t, h.mask, SUN)
    sh_seeds = seeds ^ 0x6A09E667
    hn, ms_n, launches_n, stack_n = timed_cast(ivy3, ivy3_meta, sh_o, sh_d, sh_t, nee=True, alpha_seed=sh_seeds)
    for lk in (launches, launches_n):
        if any(lk.values()):
            raise AssertionError(f"the stack traversal launched a kernel: {lk}")
    if stack["calls"] != 1 or stack_n["calls"] != 1:
        raise AssertionError(f"2^20 rays took {stack['calls']} / {stack_n['calls']} stack traversals, not 1")
    casts = {}
    for case, nee, rays, hh, cms, st in (("camera_2^20", False, (o, d, 1e30, seeds), h, ms, stack),
                                          ("sun_shadow_2^20", True, (sh_o, sh_d, sh_t, sh_seeds), hn, ms_n,
                                           stack_n)):
        rec = hold_against_gated_brute(f"atrium_ivy_dense_{case}", ivy3, ivy3_meta, *rays, hh, nee)
        rec.update({"phase": "stack", "path": "intersect_bvh_sorted", "wall_ms": cms, "iterations": st["iters"][0],
                    "working_set_per_check": st["working_sets"][0], "kernel_launches": 0,
                    "hit_frac": float(hh.mask.float().mean()),
                    "hits_tri_ge_2^20": int((hh.mask & (hh.tri >= 1 << 20)).sum())})
        if not nee:
            rec.update({"peak_gib_above_scene": peak, "first_cast_2^17_wall_ms": first_ms})
        emit(rec)
        casts[case] = rec
    out["7a"] = casts
    del h, hn, sh_o, sh_d, sh_t, o, d, seeds, sh_seeds

    # ---- 7b. its render with the fused shade tail (B5 + B6) -------------
    cam = CameraConfig(image_size=(256, 256), focal_length=35.0, position=pos, forward=fwd, exposure=3.0)
    rec, lp, _ = render_main_path("atrium-ivy-dense", ivy3, ivy3_meta, cam, 4, dev, shade_kernel="pallas",
                                  max_depth=8)
    rec["scene_build_s"] = round(author_s + compile_s, 3)
    if lp["bounces"] <= 0 or lp["shade"] != lp["bounces"] or lp["draws"] != lp["bounces"]:
        raise AssertionError(f"dense ivy: B5 / B6 launched {lp['shade']} / {lp['draws']} over {lp['bounces']} bounces")
    if any(lp[k] for k in ("brute_intersect", "presort_keys", "fused_trace", "cluster_pairs", "select_clusters",
                           "test_clusters")) or lp["stack"]["calls"] <= 0:
        raise AssertionError(f"dense ivy: the render left the stack traversals: {lp}")
    small = CameraConfig(image_size=(64, 64), focal_length=35.0, position=pos, forward=fwd, exposure=3.0)
    _, l_off, i_off = render_main_path("atrium-ivy-dense", ivy3, ivy3_meta, small, 2, dev, max_depth=4)
    _, l_pal, i_pal = render_main_path("atrium-ivy-dense", ivy3, ivy3_meta, small, 2, dev, shade_kernel="pallas",
                                       max_depth=4)
    rec["vs_off_64_2spp_depth4"] = images_equivalent(i_off, i_pal, l_off["rays"], l_pal["rays"])
    emit(rec)
    if not rec["vs_off_64_2spp_depth4"]["meets_bar"]:
        raise AssertionError(f"dense ivy: pallas against off misses the bar: {rec['vs_off_64_2spp_depth4']}")
    out["7b"] = (rec, lp)
    del ivy3

    # ---- 7c. the dense instanced atrium through the per-instance loop ---
    t0 = time.time()
    builder = atrium(density=3, instanced=True)
    author_s = time.time() - t0
    t0 = time.time()
    inst3, inst3_meta = builder.compile(dev)
    torch.cuda.synchronize()
    compile_s = time.time() - t0
    timings = builder.timings  # the prototypes' builds summed
    del builder
    emit({"phase": "scene", "scene": "atrium(density=3, instanced=True)", "n_tris": inst3_meta.n_tris,
          "n_instances": inst3_meta.n_instances, "n_prototypes": len(inst3.protos),
          "n_inst_clusters": inst3_meta.n_inst_clusters, "textures_and_meshes_s": round(author_s, 3),
          "compile_s": round(compile_s, 3), "build_s": round(author_s + compile_s, 3), **timings})
    if inst3_meta.n_inst_clusters <= blocktrace.MAX_CLUSTERS:
        raise AssertionError("the dense instanced atrium fits the block trace's cap")
    pos, target = CAMERAS["atrium-inst"]
    fwd = tuple(t - p for p, t in zip(pos, target))
    # 2^16 rays (2^14 while the dense builds' numpy SAH held the script
    # within 100 s of its limit).
    o, d = camera_rays(CameraConfig(image_size=(256, 256), focal_length=35.0, position=pos, forward=fwd), dev)
    loop = {}
    hk = None
    for case, nee in (("camera_2^16", False), ("sun_shadow_2^16", True)):
        if nee:
            o, d, t_max = shadow_rays(o, d, hk.t, hk.mask, SUN)
        else:
            t_max = torch.full((o.shape[0],), 1e30, device=dev)
        hk, ms, lk, st = timed_cast(inst3, inst3_meta, o, d, t_max, nee=nee)
        t0 = time.perf_counter()
        with intersection_forced_to_plain():
            hp = intersect(inst3, inst3_meta, o, d, t_max, nee=nee)
        twin_s = time.perf_counter() - t0
        diff = [f for f in hk._fields if not bits_equal(getattr(hk, f), getattr(hp, f))]
        if diff:
            raise AssertionError(f"dense instanced loop {case}: kernel path and twin path differ in {diff}")
        if st["calls"] or lk["cluster_pairs"] or lk["select_clusters"] or lk["test_clusters"] \
                or not (lk["brute_intersect"] and lk["presort_keys"] and lk["fused_trace"]):
            raise AssertionError(f"dense instanced loop {case}: unexpected kernels {lk}, stack {st}")
        loop[case] = {"phase": "instanced_loop", "case": case, "nee": nee, "n_rays": int(o.shape[0]),
                      "bitwise_equal": True, "wall_ms": ms, "twin_path_s": twin_s, "launches_per_cast": lk,
                      "hit_frac": float(hk.mask.float().mean())}
        emit(loop[case])
    out["7c"] = loop
    cam = CameraConfig(image_size=(256, 256), focal_length=35.0, position=pos, forward=fwd, exposure=3.0)
    rec_i, lp_i, img_i = render_main_path("atrium-inst-dense", inst3, inst3_meta, cam, 4, dev, max_depth=8)
    rec_i["scene_build_s"] = round(author_s + compile_s, 3)
    rec_b, lp_b, img_b = render_main_path("atrium-dense-256", dense, dense_meta, cam, 4, dev, max_depth=8)
    mi, mb = img_i.mean(axis=(0, 1)), img_b.mean(axis=(0, 1))
    rel = np.abs(mi - mb) / np.abs(mb)
    rec_i["vs_baked_dense"] = {"mean": [float(x) for x in mi], "baked_mean": [float(x) for x in mb],
                               "rel_err": [float(x) for x in rel], "mean_rtol": INSTANCED_MEAN_RTOL,
                               "baked_wall_s": rec_b["wall_s"], "baked_launches": rec_b["launches"]}
    emit(rec_i)
    if not (rel <= INSTANCED_MEAN_RTOL).all():
        raise AssertionError(f"dense instanced atrium against the baked one: channel means rel {rel}")
    if lp_i["cluster_pairs"] or lp_i["stack"]["calls"] or not lp_i["brute_intersect"] or not lp_i["fused_trace"]:
        raise AssertionError(f"dense instanced render: unexpected kernels {lp_i}")
    out["7c_render"] = (rec_i, lp_i)
    del inst3
    emit({"phase": "stack_total", "seconds": round(time.time() - t_phase, 3)})
    return out


# ---- phase 8: scene files ------------------------------------------------

SCENE_FILE_MEAN_RTOL = 0.02  # a scene through another route: tests/test_torch_render.py:205-213's bar


def export_glb_instanced(builder, path: str) -> dict:
    """Write `builder` as a GLB whose prototypes with instances are one mesh
    each (object space, a primitive per material) and whose instances are
    nodes with a `matrix`, the way tests/test_gltf.py:160-200 writes a
    shared mesh, so the loader makes them prototypes and instances again;
    materials, textures and baked meshes as the package's export_glb writes
    them (it flattens instances). Returns export_glb's counts and the
    instance nodes."""
    import copy

    import numpy as np

    from yart_tpu_torch.io.glb_export import export_glb

    base = copy.copy(builder)
    base._instances = []
    stats = export_glb(base, path)
    doc, blob = read_glb(path)
    blob = bytearray(blob)

    def add_accessor(arr, ctype: int, atype: str, target: int, minmax: bool = False) -> int:
        blob.extend(b"\x00" * ((-len(blob)) % 4))
        data = np.ascontiguousarray(arr).tobytes()
        doc["bufferViews"].append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data), "target": target})
        blob.extend(data)
        acc = {"bufferView": len(doc["bufferViews"]) - 1, "componentType": ctype, "count": int(arr.shape[0]),
               "type": atype}
        if minmax:
            acc["min"], acc["max"] = [float(x) for x in arr.min(axis=0)], [float(x) for x in arr.max(axis=0)]
        doc["accessors"].append(acc)
        return len(doc["accessors"]) - 1

    proto_mesh = {}
    for pid, mtx in builder._instances:
        if pid not in proto_mesh:
            p = builder._protos[pid]
            attrs = {"POSITION": add_accessor(p["positions"].astype(np.float32), 5126, "VEC3", 34962, True),
                     "NORMAL": add_accessor(p["normals"].astype(np.float32), 5126, "VEC3", 34962),
                     "TEXCOORD_0": add_accessor(p["uvs"].astype(np.float32), 5126, "VEC2", 34962)}
            tmat, tris = np.asarray(p["tri_mat"]), np.asarray(p["tris"])
            prims = [{"attributes": attrs, "material": int(m), "mode": 4,
                      "indices": add_accessor(tris[tmat == m].reshape(-1).astype(np.uint32), 5125, "SCALAR", 34963)}
                     for m in np.unique(tmat)]
            doc["meshes"].append({"primitives": prims})
            proto_mesh[pid] = len(doc["meshes"]) - 1
        doc["nodes"].append({"mesh": proto_mesh[pid], "matrix": [float(x) for x in np.asarray(mtx).T.reshape(-1)]})
        doc["scenes"][0]["nodes"].append(len(doc["nodes"]) - 1)
    return dict(stats, proto_meshes=len(proto_mesh), instance_nodes=len(builder._instances),
                bytes=write_glb(path, doc, blob))


@contextlib.contextmanager
def cli_probe():
    """Around one `yart_tpu_torch.cli.main` call: the host seconds of the
    glTF load and of the scene compile, the compiled (scene, meta), and the
    Renderer's result and wall, in the dict yielded."""
    import torch

    from yart_tpu_torch import cli
    from yart_tpu_torch.render.renderer import Renderer
    from yart_tpu_torch.scene import gltf
    from yart_tpu_torch.scene.builder import SceneBuilder

    seen = {}
    saved = gltf.load, SceneBuilder.compile, cli.build_scene, Renderer.render

    def timed(key, fn, sync=False):
        def run(*a, **k):
            t0 = time.time()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            seen[key] = time.time() - t0
            return out
        return run

    def build_scene(*a, **k):
        seen["scene"] = saved[2](*a, **k)
        return seen["scene"]

    def render(self, *a, **k):
        seen["result"] = timed("render_wall_s", saved[3], sync=True)(self, *a, **k)
        return seen["result"]

    gltf.load = timed("load_s", saved[0])
    SceneBuilder.compile = timed("compile_s", saved[1], sync=True)
    cli.build_scene, Renderer.render = build_scene, render
    try:
        yield seen
    finally:
        gltf.load, SceneBuilder.compile, cli.build_scene, Renderer.render = saved


def cli_render(name, argv, dev):
    """cli.main(argv) on the card with every kernel count set to 0 just
    before: (record, launches read just after, HDR image, (scene, meta))."""
    import numpy as np
    import torch

    from yart_tpu_torch import cli
    from yart_tpu_torch.kernels import blocktrace as legacy
    from yart_tpu_torch.kernels import brute, clusterpairs, fusedtrace, presort, shade
    from yart_tpu_torch.render import blocktrace, integrator

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.time()
    with cli_probe() as seen:
        if cli.main(argv) != 0:
            raise AssertionError(f"{name}: cli.main returned non-zero")
    wall = time.time() - t0
    res = seen["result"]
    launches = dict(kernel_launches(), shade=shade.COUNTS_SHADE.launches, draws=shade.COUNTS_DRAWS.launches)
    plain_cuda = (brute.COUNTS.plain_cuda + presort.COUNTS.plain_cuda + fusedtrace.COUNTS.plain_cuda
                  + clusterpairs.COUNTS.plain_cuda + shade.COUNTS_SHADE.plain_cuda + shade.COUNTS_DRAWS.plain_cuda
                  + legacy.COUNTS_SELECT.plain_cuda + legacy.COUNTS_TEST.plain_cuda)
    if plain_cuda != 0:
        raise AssertionError(f"{name}: the plain twins ran {plain_cuda} times on CUDA tensors")
    hdr = res.hdr
    if not np.isfinite(hdr).all() or not hdr.mean() > 0.01:
        raise AssertionError(f"{name}: bad image: finite={np.isfinite(hdr).all()} mean={hdr.mean()}")
    scene, meta = seen["scene"]
    rec = {"phase": "scene_file", "case": name, "argv": argv, "n_tris": int(meta.n_tris),
           "n_instances": int(meta.n_instances), "load_s": round(seen.get("load_s", 0.0), 3),
           "compile_s": round(seen["compile_s"], 3), "render_wall_s": round(seen["render_wall_s"], 3),
           "cli_wall_s": round(wall, 3), "rays": res.total_rays,
           "mrays_per_s": res.total_rays / seen["render_wall_s"] / 1e6,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30, "launches": launches,
           "fused_trace_modes": dict(fusedtrace.COUNTS.modes), "bounces": integrator.BOUNCES.bounces,
           "gated_casts_per_call": blocktrace.GATED.casts / max(blocktrace.GATED.calls, 1),
           "hdr_mean": [float(x) for x in hdr.mean(axis=(0, 1))]}
    return rec, dict(launches, fused_trace_modes=rec["fused_trace_modes"], bounces=rec["bounces"]), hdr, (scene, meta)


def means_within(name, img, ref, rtol: float = SCENE_FILE_MEAN_RTOL) -> dict:
    """Channel means of `img` within `rtol` of `ref`'s, or raise."""
    import numpy as np

    m, r = img.mean(axis=(0, 1)), ref.mean(axis=(0, 1))
    rel = np.abs(m - r) / np.abs(r)
    out = {"mean": [float(x) for x in m], "procedural_mean": [float(x) for x in r],
           "rel_err": [float(x) for x in rel], "rtol": rtol}
    if not (rel <= rtol).all():
        raise AssertionError(f"{name}: channel means {m} against the procedural scene's {r}: rel {rel} > {rtol}")
    return out


def paeth_png(rgba):
    """RGBA8 PNG bytes of `rgba` [H, W, 4] with every row Paeth-filtered."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = rgba.shape
    x = rgba.reshape(h, w * 4).astype(np.int16)
    a = np.pad(x, ((0, 0), (4, 0)))[:, :-4]  # left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]  # up
    c = np.pad(x, ((1, 0), (4, 0)))[:-1, :-4]  # up-left
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((h, 1), 4, np.uint8), ((x - pred) & 255).astype(np.uint8)], axis=1)

    def chunk(tag, payload):
        return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", zlib.crc32(tag + payload))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def png_decode_case(side: int = 2048) -> dict:
    """Host seconds of io/png.py decoding a side x side RGBA PNG whose rows
    are all Paeth-filtered (the anti-diagonal path), checked exact."""
    import numpy as np

    from yart_tpu_torch.io.png import decode_png

    y, x = np.mgrid[:side, :side]
    img = np.stack([(7 * x + y) % 256, (x ^ y) % 256, (x * y) % 256, 255 - (x + y) % 256], -1).astype(np.uint8)
    data = paeth_png(img)
    secs = []
    for _ in range(2):
        t0 = time.time()
        out = decode_png(data)
        secs.append(time.time() - t0)
    if not np.array_equal(out, img):
        raise AssertionError("png decode of the Paeth-filtered image differs from its source")
    return {"phase": "scene_file", "case": f"png_decode_{side}x{side}_rgba_paeth", "png_bytes": len(data),
            "decode_s": [round(s, 3) for s in secs]}


JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "jpeg")


def jpeg_manifest() -> dict:
    with open(os.path.join(JPEG_FIXTURES, "manifest.json")) as f:
        return json.load(f)


def read_glb(path: str) -> tuple:
    """(JSON document, BIN chunk bytes) of a GLB file."""
    import struct

    with open(path, "rb") as f:
        raw = f.read()
    (js_len,) = struct.unpack_from("<I", raw, 12)
    (bin_len,) = struct.unpack_from("<I", raw, 20 + js_len)
    return json.loads(raw[20 : 20 + js_len]), raw[28 + js_len : 28 + js_len + bin_len]


def write_glb(path: str, doc: dict, blob) -> int:
    """Write a GLB of `doc` and its BIN chunk `blob` (padded to 4 bytes,
    the one buffer's byteLength set); returns the file's size."""
    import struct

    blob = bytes(blob) + b"\0" * (-len(blob) % 4)
    doc["buffers"] = [{"byteLength": len(blob)}]
    js = json.dumps(doc, separators=(",", ":")).encode()
    js += b" " * (-len(js) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(blob)))
        f.write(struct.pack("<I", len(js)) + b"JSON" + js + struct.pack("<I", len(blob)) + b"BIN\x00" + blob)
    return 28 + len(js) + len(blob)


def glb_image_bytes(doc: dict, blob: bytes, i: int) -> bytes:
    view = doc["bufferViews"][doc["images"][i]["bufferView"]]
    start = view.get("byteOffset", 0)
    return blob[start : start + view["byteLength"]]


def glb_swap_images(src: str, dst: str, swap: dict) -> int:
    """Copy GLB `src` to `dst` with image i's bytes replaced by swap[i]
    (JPEG, mimeType image/jpeg); every bufferView is laid out anew,
    4-byte aligned, in its order. Returns the new file's size."""
    doc, blob = read_glb(src)
    new = {doc["images"][i]["bufferView"]: data for i, data in swap.items()}
    for i in swap:
        doc["images"][i]["mimeType"] = "image/jpeg"
    parts, off = [], 0
    for k, view in enumerate(doc["bufferViews"]):
        start = view.get("byteOffset", 0)
        data = new.get(k, blob[start : start + view["byteLength"]])
        parts.append(b"\0" * (-off % 4))
        off += -off % 4
        view["byteOffset"], view["byteLength"] = off, len(data)
        parts.append(data)
        off += len(data)
    return write_glb(dst, doc, b"".join(parts))


def atrium_jpeg_swaps(glb: str) -> dict:
    """{image index: fixture bytes} for the images of GLB `glb` that an
    atrium fixture of tests/data/jpeg replaces (the manifest's SHA-256 of
    the pixels of the PNG it was encoded from)."""
    import hashlib

    from yart_tpu_torch.io.png import decode_png

    doc, blob = read_glb(glb)
    by_png = {e["replaces_png_rgba_sha256"]: name for name, e in jpeg_manifest()["files"].items()
              if "replaces_png_rgba_sha256" in e}
    out = {}
    for i in range(len(doc.get("images", []))):
        name = by_png.get(hashlib.sha256(decode_png(glb_image_bytes(doc, blob, i)).tobytes()).hexdigest())
        if name is not None:
            with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
                out[i] = f.read()
    return out


def jpeg_fixture_case() -> dict:
    """Every JPEG fixture decoded by io/jpeg.py on this host and hashed
    against the manifest PIL wrote; the host seconds of each (the first
    decode also builds the scan decoder with g++) and of all of them."""
    import hashlib
    import importlib.util

    from yart_tpu_torch.io.jpeg import _library, decode_jpeg

    t0 = time.time()
    _library()
    build_s = time.time() - t0
    files = jpeg_manifest()["files"]
    secs, bad = {}, []
    for name in sorted(files):
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            data = f.read()
        t0 = time.time()
        rgba = decode_jpeg(data)
        secs[name] = round(time.time() - t0, 4)
        if list(rgba.shape) != files[name]["shape"] or \
                hashlib.sha256(rgba.tobytes()).hexdigest() != files[name]["rgba_sha256"]:
            bad.append(name)
    if bad:
        raise AssertionError(f"8d: io/jpeg.py decodes {bad} otherwise than the manifest's PIL decode")
    if any(m == "PIL" or m.startswith("PIL.") for m in sys.modules):
        raise AssertionError("8d: PIL was imported")
    atrium = {k: v for k, v in secs.items() if k.startswith("atrium_")}
    return {"phase": "scene_file", "case": "8d_jpeg_fixtures", "files": len(secs), "all_match_manifest": True,
            "pil_importable": importlib.util.find_spec("PIL") is not None, "library_load_s": round(build_s, 3),
            "decode_s": secs, "decode_all_s": round(sum(secs.values()), 4),
            "decode_atrium_textures_s": round(sum(atrium.values()), 4)}


def jpeg_stage_case(side: int = 2048) -> dict:
    """Host seconds of io/jpeg.py's numpy stages (the islow IDCT, h2v2
    fancy upsampling and the YCbCr tables) on the coefficient planes of a
    side x side 4:2:0 image (random, within the normal range)."""
    import numpy as np

    from yart_tpu_torch.io.jpeg import component_samples, ycc_to_rgb

    rng = np.random.default_rng(0)
    q = rng.integers(1, 12, 64)
    planes = []
    for n in (side // 8, side // 16, side // 16):
        c = np.zeros((n, n, 64), np.int16)
        c[..., 0] = rng.integers(-600, 600, (n, n))
        c[..., 1:10] = rng.integers(-20, 20, (n, n, 9))
        planes.append(c)
    secs = []
    for _ in range(2):
        t0 = time.time()
        rgb = ycc_to_rgb(*(component_samples(c, q, 8 * c.shape[0], 8 * c.shape[1], side // (8 * c.shape[1]),
                                             side // (8 * c.shape[0])) for c in planes))
        secs.append(time.time() - t0)
    if rgb.shape != (side, side, 3):
        raise AssertionError(f"jpeg stages gave {rgb.shape}")
    return {"phase": "scene_file", "case": f"jpeg_numpy_stages_{side}x{side}_420",
            "seconds": [round(s, 3) for s in secs]}


def scene_file_phases(dev, spp: int, ivy_builder, ivy_pallas_img, inst_builder, inst, inst_meta,
                      cornell_builder, side_a: int = 512, side_b: int = 128) -> dict:
    """Phase 8: scenes written with the port's exporters to a temporary
    directory and rendered through `yart_tpu_torch.cli.main` on the card.
    8a atrium-ivy as a GLB with its sky as Radiance HDR (`side_a` square,
    512 for the image of phase 4f, `spp`, depth 30, +3 EV, "pallas"): B2, B3 amask, B5 and B6 (once a bounce),
    means within 2% of the procedural render of phase 4f (`ivy_pallas_img`);
    8b the compiled atrium-inst builder as a GLB of prototype meshes and
    instance nodes (`side_b` square, 128 since the script came within
    100 s of its limit, 4 spp, depth 8): the loader's
    prototypes and instances, B2 and B3's instanced modes, means within 2% of the
    procedural atrium-inst at the same settings; 8c kernel path == twin
    path bitwise at 2 spp on the GLB scenes of 8a (16x16, depth 2), 8b
    (16x16, depth 4) and cornell-mat (B1; 32x32, depth 4); the host
    seconds of a 2048x2048 Paeth PNG decode; 8d (after 8a) every JPEG
    fixture of tests/data/jpeg decoded by io/jpeg.py to the manifest's
    hash, with the host seconds of each, then 8a's GLB with its eight
    opaque textures swapped for the atrium fixtures rendered at 8a's
    settings (B2, B3 amask, B5 = B6 = bounces; means within 2% of 8a's),
    and the host seconds of io/jpeg.py's numpy stages on a 2048x2048 4:2:0
    image. Emits each record; returns them."""
    import tempfile

    import numpy as np
    import torch

    from yart_tpu_torch.cli import CAMERAS
    from yart_tpu_torch.config import CameraConfig, RenderConfig
    from yart_tpu_torch.io.glb_export import export_env_hdr, export_glb
    from yart_tpu_torch.scene.gltf import load

    t_phase = time.time()
    out = {}
    pos, target = CAMERAS["atrium-ivy"]
    cam_args = [f"--camera-pos={','.join(map(str, pos))}", f"--camera-target={','.join(map(str, target))}",
                "--exposure", "3", "--device", str(dev), "--quiet"]  # "=": the position starts with "-"
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 8a. atrium-ivy as a GLB under its sky as an HDR file ----------
        glb, sky = os.path.join(tmp, "atrium_ivy.glb"), os.path.join(tmp, "sky.hdr")
        t0 = time.time()
        stats = export_glb(ivy_builder, glb)
        export_s = time.time() - t0
        t0 = time.time()
        if not export_env_hdr(ivy_builder, sky):
            raise AssertionError("atrium-ivy has no image environment to export")
        hdr_s = time.time() - t0
        rec, l8a, img, ivy_glb = cli_render("8a_atrium_ivy_glb", [
            glb, "--env-hdr", sky, "--env-scale", repr(ivy_builder._env_scale), "--size", f"{side_a}x{side_a}",
            "--spp", str(spp), "--max-depth", "30", "--shade-kernel", "pallas", "-o", os.path.join(OUT_DIR, "atrium_ivy_glb.png"),
            *cam_args], dev)
        rec.update(export_s=round(export_s, 3), export_env_hdr_s=round(hdr_s, 3), glb=stats,
                   vs_procedural=means_within("8a atrium-ivy GLB", img, ivy_pallas_img))
        emit(rec)
        modes = l8a["fused_trace_modes"]
        if l8a["presort_keys"] <= 0 or modes.get("amask", 0) <= 0 or l8a["brute_intersect"] != 0:
            raise AssertionError(f"8a: the atrium-ivy GLB did not go through B2 and B3 amask: {l8a}")
        if l8a["bounces"] <= 0 or l8a["shade"] != l8a["bounces"] or l8a["draws"] != l8a["bounces"]:
            raise AssertionError(f"8a: B5 / B6 launched {l8a['shade']} / {l8a['draws']} times over "
                                 f"{l8a['bounces']} bounces")
        out["8a"] = (rec, l8a)

        # ---- 8d. the same GLB with its opaque textures as JPEG -------------
        # The fixtures decode to PIL's bytes on this host without PIL; the
        # eight atrium fixtures replace the PNGs they were encoded from (the
        # ivy leaf stays PNG: its alpha drives B3 amask), and the render at
        # 8a's settings must keep 8a's channel means within 2%.
        out["8d_fixtures"] = jpeg_fixture_case()
        emit(out["8d_fixtures"])
        swaps = atrium_jpeg_swaps(glb)
        n_atrium = sum(k.startswith("atrium_") for k in jpeg_manifest()["files"])
        if len(swaps) != n_atrium:
            raise AssertionError(f"8d: {len(swaps)} of the GLB's images match the {n_atrium} atrium fixtures")
        glb_j = os.path.join(tmp, "atrium_ivy_jpeg.glb")
        glb_swap_images(glb, glb_j, swaps)
        rec, l8d, img_j, _ = cli_render("8d_atrium_ivy_jpeg_glb", [
            glb_j, "--env-hdr", sky, "--env-scale", repr(ivy_builder._env_scale), "--size", f"{side_a}x{side_a}",
            "--spp", str(spp), "--max-depth", "30", "--shade-kernel", "pallas",
            "-o", os.path.join(OUT_DIR, "atrium_ivy_jpeg_glb.png"), *cam_args], dev)
        rec.update(jpeg_images=len(swaps), glb_bytes=os.path.getsize(glb_j), png_glb_bytes=os.path.getsize(glb),
                   decode_atrium_textures_s=out["8d_fixtures"]["decode_atrium_textures_s"],
                   vs_png_glb=means_within("8d atrium-ivy JPEG GLB", img_j, img))
        emit(rec)
        modes = l8d["fused_trace_modes"]
        if l8d["presort_keys"] <= 0 or modes.get("amask", 0) <= 0 or l8d["brute_intersect"] != 0:
            raise AssertionError(f"8d: the atrium-ivy JPEG GLB did not go through B2 and B3 amask: {l8d}")
        if l8d["bounces"] <= 0 or l8d["shade"] != l8d["bounces"] or l8d["draws"] != l8d["bounces"]:
            raise AssertionError(f"8d: B5 / B6 launched {l8d['shade']} / {l8d['draws']} times over "
                                 f"{l8d['bounces']} bounces")
        out["8d"] = (rec, l8d)
        out["jpeg_stages"] = jpeg_stage_case()
        emit(out["jpeg_stages"])

        # ---- 8b. atrium-inst: prototypes as meshes, instances as nodes -----
        glb_i, sky_i = os.path.join(tmp, "atrium_inst.glb"), os.path.join(tmp, "sky_inst.hdr")
        t0 = time.time()
        stats_i = export_glb_instanced(inst_builder, glb_i)
        export_env_hdr(inst_builder, sky_i)
        export_s = time.time() - t0
        b_i = load(glb_i)
        n_shared = len({p for p, _ in b_i._instances})
        if not (b_i._instances and b_i._protos):
            raise AssertionError("8b: the atrium-inst GLB's shared meshes did not load as prototypes and instances")
        side = side_b
        rec, l8b, img_i, inst_glb = cli_render("8b_atrium_inst_glb", [
            glb_i, "--env-hdr", sky_i, "--env-scale", repr(inst_builder._env_scale), "--size", f"{side}x{side}",
            "--spp", "4", "--max-depth", "8", "-o", os.path.join(OUT_DIR, "atrium_inst_glb.png"), *cam_args], dev)
        _, _, ref_i = render_main_path("atrium-inst", inst, inst_meta, CameraConfig(
            image_size=(side, side), focal_length=35.0, position=pos,
            forward=tuple(t - p for p, t in zip(pos, target)), exposure=3.0), 4, dev, max_depth=8)
        rec.update(export_s=round(export_s, 3), glb=stats_i, loaded_prototypes=len(b_i._protos),
                   loaded_instances=len(b_i._instances), prototypes_with_instances=n_shared,
                   baked_meshes=len(b_i._positions), procedural_instances=int(inst_meta.n_instances),
                   vs_procedural=means_within("8b atrium-inst GLB", img_i, ref_i))
        emit(rec)
        modes = l8b["fused_trace_modes"]
        if l8b["presort_keys"] <= 0 or modes.get("instanced", 0) <= 0 or modes.get("instanced+nee", 0) <= 0:
            raise AssertionError(f"8b: the atrium-inst GLB did not go through B2 and B3's instanced modes: {l8b}")
        out["8b"] = (rec, l8b)

        # ---- 8c. kernel path == twin path on the GLB scenes ----------------
        glb_c = os.path.join(tmp, "cornell_mat.glb")
        export_glb(cornell_builder, glb_c)
        cornell_glb = load(glb_c).compile(dev)
        # The atrium GLBs at 16x16, the ivy's at depth 2: its twin path (B2's
        # and B3's plain amask twins, whose cost barely falls with the lane
        # count) took 63.0 s at 32x32 and 34.6 s at 16x16, depth 4, on the card.
        fwd = tuple(t - p for p, t in zip(pos, target))
        for name, (sc, sc_meta), cam, depth in (
                ("8c_atrium_ivy_glb", ivy_glb, CameraConfig(image_size=(16, 16), focal_length=35.0, position=pos,
                                                             forward=fwd, exposure=3.0), 2),
                ("8c_atrium_inst_glb", inst_glb, CameraConfig(image_size=(16, 16), focal_length=35.0, position=pos,
                                                               forward=fwd, exposure=3.0), 4),
                ("8c_cornell_mat_glb", cornell_glb, CameraConfig(image_size=(32, 32), focal_length=35.0,
                                                                 position=(0, 1.0, 3.4), forward=(0, 0, -1)), 4)):
            cfg = RenderConfig(samples=2, max_depth=depth, tonemap="none", estimator="mean", first_wave_samples=2,
                               max_wave_samples=2)
            reset_counts()
            rec = dict(reference_check(name, sc, sc_meta, cam, cfg, None, dev), phase="scene_file",
                       launches=kernel_launches())
            emit(rec)
            out[name] = rec
        if out["8c_cornell_mat_glb"]["launches"]["brute_intersect"] <= 0:
            raise AssertionError("8c: the cornell-mat GLB did not go through B1")
    out["png"] = png_decode_case()
    emit(out["png"])
    out["seconds"] = round(time.time() - t_phase, 3)
    emit({"phase": "scene_file_total", "seconds": out["seconds"]})
    return out


# ---- phase 9: the application layer (ranks, CLI flags, samplers) ---------

APP_SAMPLERS = ("stratified", "zsobol:null", "zsobol:binary", "zsobol:owen")  # the samplers B6 does not draw


@contextlib.contextmanager
def shade_forced_to_plain():
    """Test-only switch for phase 9d: route B5 and B6 to their plain twins
    (on the same CUDA tensors), as `intersection_forced_to_plain` does for
    the intersection kernels."""
    from yart_tpu_torch.kernels import shade

    saved = shade.shade, shade.draws
    shade.shade, shade.draws = shade.shade_plain, shade.draws_plain
    try:
        yield
    finally:
        shade.shade, shade.draws = saved


def shade_launches() -> dict:
    """kernel_launches() with B5's and B6's, B3's launches by mode and the
    bounces so far."""
    from yart_tpu_torch.kernels import fusedtrace, shade
    from yart_tpu_torch.render import integrator

    return dict(kernel_launches(), shade=shade.COUNTS_SHADE.launches, draws=shade.COUNTS_DRAWS.launches,
                fused_trace_modes=dict(fusedtrace.COUNTS.modes), bounces=integrator.BOUNCES.bounces)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def app_rank(rank, scene_path, cam_cfg, cfg, out_dir, device_type):
    """A rank of phase 9a, in a process of its own: the compiled scene from
    the parent's file (CPU tensors), a warm-up render, then its render over
    the group on this rank's card with every count set to 0 just before;
    writes its wall, the rays of its own parts and its launches (rank 0
    also the image)."""
    import dataclasses

    import numpy as np
    import torch

    from yart_tpu_torch.parallel import distributed
    from yart_tpu_torch.render.renderer import Renderer

    dev = distributed.rank_device(device_type)
    scene, meta = torch.load(scene_path, weights_only=False)
    own = [0.0]
    wave = Renderer._wave

    def counted(self, *a):  # the rays of this rank's own parts
        est, rays, live = wave(self, *a)
        own[0] += float(rays)
        return est, rays, live

    # A first render in the process loads the kernels' libraries and the
    # LUTs; one at 64x64 keeps that out of the timed render, as 4f's
    # process is warm when it renders.
    Renderer(scene, meta, dataclasses.replace(cam_cfg, image_size=(64, 64)), dataclasses.replace(cfg, samples=2),
             device=dev, devices="all").render()
    Renderer._wave = counted
    r = Renderer(scene, meta, cam_cfg, cfg, device=dev, devices="all")
    sync(dev)
    reset_counts()
    t0 = time.time()
    res = r.render()
    sync(dev)
    wall = time.time() - t0
    rec = {"rank": rank, "world": r.n_devices, "backend": torch.distributed.get_backend(), "device": str(dev),
           "wall_s": round(wall, 3), "rays": own[0], "mrays_per_s": own[0] / wall / 1e6,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else None,
           "launches": shade_launches()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    if rank == 0:
        np.savez(os.path.join(out_dir, "image.npz"), hdr=res.hdr, rays=res.total_rays)


def cli_checkpoint(argv, ck, dev):
    """cli.main(argv + checkpoint) with every count set to 0 just before:
    (hdr, rays, samples, launches, wall s)."""
    import numpy as np

    from yart_tpu_torch import cli

    reset_counts()
    t0 = time.time()
    if cli.main(argv + ["--checkpoint", ck]) != 0:
        raise AssertionError(f"cli.main({argv}) returned non-zero")
    sync(dev)
    wall = time.time() - t0
    with np.load(ck) as z:
        return z["hdr"], float(z["rays"]), int(z["samples_taken"]), shade_launches(), wall


def app_layer_phases(dev, spp: int, ivy, ivy_meta, ivy_cam, ivy_img, ivy_rays, cornell, cornell_meta) -> dict:
    """Phase 9: 9a atrium-ivy (`ivy_cam`, `spp`, depth 30, "pallas") over
    two gloo ranks spawned on the one card, each given the compiled scene
    as CPU tensors from a file, bitwise to phase 4f's one-process image
    and ray count (`ivy_img`, `ivy_rays`); 9b `cli.main(--devices all)`:
    one NCCL rank, bitwise to the same render without --devices; 9c
    cornell-mat through `cli.main` with --config, --preview, --serve 0
    (its /status and /frame.png fetched over loopback during the render),
    --profile (the trace names B1 and B5) and --debug-nan, then the
    estimate forced to NaN: FloatingPointError; 9d the samplers B6 does
    not draw, kernel path == twin path bitwise on cornell-mat (32x32, 2
    spp, depth 4, "pallas"), B6 never launched and B5 once a bounce.
    Emits each record; returns them."""
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    from yart_tpu_torch import cli
    from yart_tpu_torch.config import CameraConfig, RenderConfig
    from yart_tpu_torch.io import preview
    from yart_tpu_torch.io.png import decode_png
    from yart_tpu_torch.parallel import distributed
    from yart_tpu_torch.render import renderer
    from yart_tpu_torch.render.renderer import Renderer

    t_phase = time.time()
    out = {}
    smi = nvidia_smi()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 9a. two gloo ranks on the one card, the slice at full width ---
        t0 = time.time()
        scene_path = os.path.join(tmp, "atrium_ivy.pt")
        torch.save((ivy.to("cpu"), ivy_meta), scene_path)
        save_s = time.time() - t0
        cfg = main_path_config(spp, 30, "pallas")
        t0 = time.time()
        distributed.spawn(app_rank, 2, (scene_path, ivy_cam, cfg, tmp, dev.type), device=dev.type, backend="gloo")
        spawn_s = time.time() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        with np.load(os.path.join(tmp, "image.npz")) as z:
            hdr, rays = z["hdr"], float(z["rays"])
        bitwise = bool(np.array_equal(hdr.view(np.int32), ivy_img.view(np.int32)) and rays == ivy_rays)
        rec = {"phase": "app", "case": "9a_atrium_ivy_two_gloo_ranks", "smi": smi, "size": list(ivy_cam.image_size),
               "spp": spp, "max_depth": 30, "shade_kernel": "pallas", "ranks": ranks, "rays": rays,
               "one_process_rays": ivy_rays, "bitwise_to_4f": bitwise, "scene_file_s": round(save_s, 3),
               "spawn_to_join_s": round(spawn_s, 3), "rays_by_rank": [x["rays"] for x in ranks]}
        emit(rec)
        if not bitwise:
            raise AssertionError(f"9a: two ranks differ from phase 4f's one-process render (max abs "
                                 f"{np.abs(hdr - ivy_img).max()}, rays {rays} vs {ivy_rays})")
        for x in ranks:
            lx = x["launches"]
            if (lx["presort_keys"] <= 0 or lx["fused_trace_modes"].get("amask", 0) <= 0 or lx["bounces"] <= 0
                    or lx["shade"] != lx["bounces"] or lx["draws"] != lx["bounces"]):
                raise AssertionError(f"9a: rank {x['rank']} did not go through B2, B3 amask, B5 and B6: {lx}")
        if abs(sum(x["rays"] for x in ranks) - ivy_rays) > 0:
            raise AssertionError(f"9a: the ranks' own rays {[x['rays'] for x in ranks]} do not sum to {ivy_rays}")
        out["9a"] = rec

        # ---- 9b. --devices all on the one card: one NCCL rank --------------
        argv = ["cornell-mat", "--device", dev.type, "--size", "128x128", "--spp", "4", "--max-depth", "8",
                "--shade-kernel", "pallas", "--quiet", "-o", os.path.join(tmp, "b.png")]
        one = cli_checkpoint(argv, os.path.join(tmp, "b1.npz"), dev)
        nccl = cli_checkpoint(argv + ["--devices", "all"], os.path.join(tmp, "b2.npz"), dev)
        bitwise = bool(np.array_equal(one[0].view(np.int32), nccl[0].view(np.int32)) and one[1] == nccl[1])
        rec = {"phase": "app", "case": "9b_cli_devices_all_one_nccl_rank", "ranks": cli.ranks_for("all", dev),
               "rays": nccl[1], "bitwise_to_one_process": bitwise, "wall_s": [round(one[4], 3), round(nccl[4], 3)],
               "launches": nccl[3]}
        emit(rec)
        if not bitwise or nccl[3]["brute_intersect"] <= 0 or distributed.is_initialized():
            raise AssertionError(f"9b: --devices all differs from one process or left its group: {rec}")
        out["9b"] = rec

        # ---- 9c. the CLI's flags ------------------------------------------
        config = os.path.join(tmp, "c.json")
        with open(config, "w") as f:
            json.dump({"spp": 4, "size": "128x128", "seed": 3, "max-depth": 8, "first-wave": 2}, f)
        prev, prof = os.path.join(tmp, "preview.png"), os.path.join(tmp, "prof")
        seen = []
        update = preview.PreviewServer.update

        def probe(self, img, wave_data=None, done=False):
            update(self, img, wave_data, done)
            got = [urllib.request.urlopen(f"http://127.0.0.1:{self.port}{p}", timeout=10).read()
                   for p in ("/status", "/frame.png")]
            seen.append((json.loads(got[0]), decode_png(got[1]).shape))

        argv = ["cornell-mat", "--config", config, "--seed", "1", "--device", dev.type, "--shade-kernel", "pallas",
                "--preview", prev, "--serve", "0", "--profile", prof, "--debug-nan", "--quiet",
                "-o", os.path.join(tmp, "c.png")]
        preview.PreviewServer.update = probe
        try:
            hdr_c, rays_c, spp_c, launches_c, wall_c = cli_checkpoint(argv, os.path.join(tmp, "c.npz"), dev)
        finally:
            preview.PreviewServer.update = update
        with open(os.path.join(prof, "trace.json")) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        traced = {k: sum(k in n for n in names) > 0 for k in ("brute_intersect_kernel", "shade_kernel")}
        with np.load(os.path.join(tmp, "c.npz")) as z:
            seed_c = int(z["seed"])
        rec = {"phase": "app", "case": "9c_cli_flags", "pixels": hdr_c.shape[0], "spp": spp_c, "seed": seed_c,
               "served": [{"samples_taken": s["samples_taken"], "frame": s["frame"], "done": s["done"],
                           "png_shape": list(shape)} for s, shape in seen],
               "preview_png_shape": list(decode_png(open(prev, "rb").read()).shape), "trace_kernels": traced,
               "trace_events": len(names), "launches": launches_c, "wall_s": round(wall_c, 3), "rays": rays_c}
        if not (hdr_c.shape == (128 * 128, 3) and spp_c == 4 and seed_c == 1 and all(traced.values())
                and seen and seen[-1][0]["done"] and seen[-1][1] == (128, 128, 4)
                and rec["preview_png_shape"] == [128, 128, 4] and launches_c["shade"] == launches_c["bounces"]):
            raise AssertionError(f"9c: the CLI's flags did not act as asked: {rec}")
        estimate = renderer.estimate
        renderer.estimate = lambda samples, *a: torch.full((samples.shape[0], 3), float("nan"), device=samples.device)
        try:
            cli_checkpoint(argv[:argv.index("--preview")] + ["--debug-nan", "--quiet", "-o", os.path.join(
                tmp, "n.png")], os.path.join(tmp, "n.npz"), dev)
            raise AssertionError("9c: --debug-nan let a NaN estimate through")
        except FloatingPointError as e:
            rec["debug_nan_raised"] = str(e)
        finally:
            renderer.estimate = estimate
        emit(rec)
        out["9c"] = rec

    # ---- 9d. the samplers B6 does not draw: kernel path == twin path ------
    cam = CameraConfig(image_size=(32, 32), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
    for kind in APP_SAMPLERS:
        cfg = RenderConfig(samples=2, max_depth=4, tonemap="none", estimator="mean", first_wave_samples=2,
                           max_wave_samples=2, shade_kernel="pallas", sampler=kind)
        reset_counts()
        img_k = Renderer(cornell, cornell_meta, cam, cfg, device=dev).render()
        launches = shade_launches()
        with intersection_forced_to_plain(), shade_forced_to_plain():
            img_p = Renderer(cornell, cornell_meta, cam, cfg, device=dev).render()
        bitwise = bool(np.array_equal(img_k.hdr.view(np.int32), img_p.hdr.view(np.int32))
                       and img_k.total_rays == img_p.total_rays)
        rec = {"phase": "app", "case": f"9d_sampler_{kind}", "size": [32, 32], "spp": 2, "max_depth": 4,
               "kernel_eq_twin_bitwise": bitwise, "launches": launches, "rays": img_k.total_rays,
               "mean": [float(x) for x in img_k.hdr.mean(axis=(0, 1))]}
        emit(rec)
        if not (bitwise and np.isfinite(img_k.hdr).all() and img_k.hdr.mean() > 0):
            raise AssertionError(f"9d: {kind}: kernel path and twin path differ: {rec}")
        if launches["draws"] != 0 or launches["shade"] != launches["bounces"] or launches["brute_intersect"] <= 0:
            raise AssertionError(f"9d: {kind}: B6 launched or B1 / B5 not once a bounce: {launches}")
        out[f"9d_{kind}"] = rec
    out["seconds"] = round(time.time() - t_phase, 3)
    emit({"phase": "app_total", "seconds": out["seconds"]})
    return out




def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--spp", type=int, default=16, help="samples per pixel of the 512x512 renders (phases 4-4d)")
    args = ap.parse_args()
    t_start = time.time()

    import numpy as np
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA GPU")
    # Imported before anything is printed: a copy of this script without the
    # package fails here with no output.
    from yart_tpu_torch.cli import CAMERAS
    from yart_tpu_torch.config import CameraConfig, RenderConfig
    from yart_tpu_torch.kernels import brute, build
    from yart_tpu_torch.ops import lut, qmc
    from yart_tpu_torch.render import bintrace, blocktrace
    from yart_tpu_torch.scene.procedural import cornell_box, material_test_spheres, textured_box_scene
    from yart_tpu_torch.scene.showcase import atrium, instanced_leaves, roadster
    from yart_tpu_torch.tools.build_times import numpy_twins

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind, "count": count,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 2. build: one nvcc per source, all started together -------------
    t0 = time.time()
    compiled = build.build_all()
    emit({"phase": "build", "kernels": list(compiled), "compiled_now": compiled,
          "seconds": round(time.time() - t0, 3), "ptxas": {k: build.ptxas_report(k) for k in build.LIBRARIES},
          "host_libraries": {k: build.library_path(k, v) for k, v in build.HOST_LIBRARIES.items()}})

    # ---- 3. B1 vs plain twin --------------------------------------------
    scene, meta = cornell_box(extra_materials=True).compile(dev)
    side = 1024  # 2^20 camera rays, one per pixel: one chunk of the render
    b1 = []
    for name, b1_args, timed in b1_cases(dev, (scene, meta)):
        b1.append(compare_brute(name, *b1_args, timed=timed))
        emit({"phase": "kernel", **b1[-1]})
        if name == "soup_4096":
            soup_t, ro_t, rd_t, tm_t, n_soup = b1_args
            if bool((brute.brute_cuda(soup_t, ro_t[: 1 << 16], rd_t[: 1 << 16], tm_t[: 1 << 16], n_soup,
                                      1e-3)[4] >= 0).any()):
                raise AssertionError("a t_max = -1 lane reported a hit")
    rec_a = b1[0]

    # ---- 3b. B2 + B3 vs plain twins on the bench's big scene ------------
    t0 = time.time()
    big, big_meta = big_scene(dev)
    emit({"phase": "scene", "scene": "bench bigscene (60 spheres)", "n_tris": big_meta.n_tris,
          "n_clusters": big_meta.n_clusters, "n_clus_pad": big_meta.n_clus_pad,
          "build_s": round(time.time() - t0, 3)})
    lanes = 262144  # bench.py's lane count
    recs = {}
    for case, coherent in (("incoherent", False), ("coherent", True)):
        bo, bd = (torch.from_numpy(a).to(dev) for a in make_rays(lanes, coherent))
        bt = torch.full((lanes,), 100.0, device=dev)
        if not coherent:
            bt[: 1 << 14] = -1.0  # a block of retired lanes
        recs[case] = compare_blocktrace(f"bigscene_{case}", big, big_meta, bo, bd, bt, timed=True)
        emit({"phase": "kernel", **recs[case]})
    rec_r = compare_blocktrace("bigscene_incoherent_ragged_1000", big, big_meta, bo[-1000:], bd[-1000:],
                               torch.full((1000,), 100.0, device=dev), timed=False)
    emit({"phase": "kernel", **rec_r})

    # ---- 3c. B2 + B3 vs plain twins at the spheres render's shapes -------
    # A chunk of 2^20 camera rays from the CLI's camera (closest hit), then
    # shadow rays from their hits as any-hit queries (nee) with a finite
    # t_max, the misses retired, as the render's NEE sends them.
    spheres, spheres_meta = material_test_spheres().compile(dev)
    pos, target = CAMERAS["spheres"]
    spheres_fwd = tuple(t - p for p, t in zip(pos, target))
    so, sd = camera_rays(CameraConfig(image_size=(side, side), focal_length=35.0, position=pos,
                                      forward=spheres_fwd), dev)
    st = torch.full((so.shape[0],), 1e30, device=dev)
    rec_s = compare_blocktrace("spheres_camera", spheres, spheres_meta, so, sd, st, timed=True)
    emit({"phase": "kernel", **rec_s})
    t_hit, _, _, _, tri_hit, _, _ = blocktrace.intersect_blocktrace(spheres, spheres_meta, so, sd, st)
    sh_o, sh_d, sh_t = shadow_rays(so, sd, t_hit, tri_hit >= 0)
    rec_n = compare_blocktrace("spheres_shadow_nee", spheres, spheres_meta, sh_o, sh_d, sh_t,
                               timed=False, nee=True)
    emit({"phase": "kernel", **rec_n})
    bt_recs = [recs["incoherent"], recs["coherent"], rec_r, rec_s, rec_n]

    # ---- 3d. B3 amask mode (and B2) at atrium-ivy's gated shapes ---------
    t0 = time.time()
    ivy_builder = atrium(ivy=True)
    author_s = time.time() - t0
    t0 = time.time()
    ivy, ivy_meta = ivy_builder.compile(dev)
    torch.cuda.synchronize()
    compile_s = time.time() - t0
    emit({"phase": "scene", "scene": "atrium-ivy", "n_tris": ivy_meta.n_tris,
          "n_clusters": ivy_meta.n_clusters, "any_alpha": ivy_meta.any_alpha,
          "any_transparent": ivy_meta.any_transparent, "textures_and_meshes_s": round(author_s, 3),
          "compile_s": round(compile_s, 3), "build_s": round(author_s + compile_s, 3), **ivy_builder.timings})
    # The host library's tree checked, and the same scene from the numpy
    # twins (rendered beside the native one in 4f).
    rec_nat = {"phase": "native_build", "scene": "atrium-ivy", "compile_s": round(compile_s, 3),
               **ivy_builder.timings, **native_tree_check("atrium-ivy", ivy_builder, ivy)}
    twin_builder = atrium(ivy=True)
    t0 = time.time()
    with numpy_twins():
        ivy_np, ivy_np_meta = twin_builder.compile(dev)
    torch.cuda.synchronize()
    rec_nat["numpy_twin"] = {"compile_s": round(time.time() - t0, 3), **twin_builder.timings,
                             "nodes": int(ivy_np.node_pack.shape[0]), "bvh8_groups": int(ivy_np.wide_pack.shape[0]),
                             "n_clusters": ivy_np_meta.n_clusters}
    rec_nat["n_clusters"] = ivy_meta.n_clusters
    emit(rec_nat)
    del twin_builder
    ivy_pos, ivy_target = CAMERAS["atrium-ivy"]
    ivy_fwd = tuple(t - p for p, t in zip(ivy_pos, ivy_target))
    io, idr, iseed = camera_rays(CameraConfig(image_size=(side, side), focal_length=35.0, position=ivy_pos,
                                              forward=ivy_fwd), dev, seeds=True)
    rec_i = compare_amask("atrium_ivy_camera", ivy, ivy_meta, io, idr, iseed)
    emit({"phase": "kernel", **rec_i})
    # B2 on rays leaving those hits in random directions, in lane order, as
    # a render's later bounces send them: the case a block's cull cannot thin.
    i_hit = blocktrace.intersect_blocktrace(ivy, ivy_meta, io, idr, torch.full((io.shape[0],), 1e30, device=dev))
    rec_ir = compare_presort("atrium_ivy_random_directions", ivy, ivy_meta,
                             *shadow_rays(io, idr, i_hit[0], i_hit[4] >= 0))
    emit({"phase": "kernel", **rec_ir})
    del i_hit

    # ---- 3e. the gated re-cast loop: kernel path vs twin path ------------
    # At 2^16 rays (2^14 while the dense builds' numpy SAH held the script
    # within 100 s of its limit; the twin paths take ~21 s each).
    go, gd, gseed = camera_rays(CameraConfig(image_size=(256, 256), focal_length=35.0, position=ivy_pos,
                                             forward=ivy_fwd), dev, seeds=True)
    g_tmax = torch.full((go.shape[0],), 1e30, device=dev)
    rec_g = compare_gated("atrium_ivy_camera_2^16", ivy, ivy_meta, go, gd, g_tmax, gseed, nee=False)
    emit({"phase": "gated", **rec_g})
    gh = blocktrace.intersect_blocktrace_gated(ivy, ivy_meta, go, gd, g_tmax, alpha_seed=gseed)
    sh_o, sh_d, sh_t = shadow_rays(go, gd, gh.t, gh.mask, SUN)
    rec_gs = compare_gated("atrium_ivy_shadow_2^16", ivy, ivy_meta, sh_o, sh_d, sh_t, gseed ^ 0x6A09E667,
                           nee=True)
    emit({"phase": "gated", **rec_gs})

    # ---- 3f. B3 instanced (and B2) at atrium-inst's shapes --------------
    t0 = time.time()
    inst_builder = atrium(instanced=True)
    inst_author_s = time.time() - t0
    t0 = time.time()
    inst, inst_meta = inst_builder.compile(dev)
    torch.cuda.synchronize()
    inst_compile_s = time.time() - t0
    inst_build_s = round(inst_author_s + inst_compile_s, 3)
    emit({"phase": "scene", "scene": "atrium-inst", "n_tris": inst_meta.n_tris,
          "n_instances": inst_meta.n_instances, "n_prototypes": len(set(inst_meta.inst_proto)),
          "n_inst_clusters": inst_meta.n_inst_clusters, "n_clus_pad": inst_meta.n_clus_pad,
          "pack_rows": int(inst.clus_pack.shape[0]), "stored_tris": int(inst.shade_pack.shape[0]),
          "any_alpha": inst_meta.any_alpha, "textures_and_meshes_s": round(inst_author_s, 3),
          "compile_s": round(inst_compile_s, 3), "build_s": inst_build_s})
    inst_pos, inst_target = CAMERAS["atrium-inst"]
    inst_fwd = tuple(t - p for p, t in zip(inst_pos, inst_target))
    ao, ad = camera_rays(CameraConfig(image_size=(side, side), focal_length=35.0, position=inst_pos,
                                      forward=inst_fwd), dev)
    at = torch.full((ao.shape[0],), 1e30, device=dev)
    rec_ic = compare_blocktrace("atrium_inst_camera", inst, inst_meta, ao, ad, at, timed=True)
    emit({"phase": "kernel", **rec_ic})
    a_hit = blocktrace.intersect_blocktrace(inst, inst_meta, ao, ad, at)
    sun_o, sun_d, sun_t = shadow_rays(ao, ad, a_hit[0], a_hit[4] >= 0, SUN)
    rec_in = compare_blocktrace("atrium_inst_sun_shadow_nee", inst, inst_meta, sun_o, sun_d, sun_t,
                                timed=True, nee=True)
    emit({"phase": "kernel", **rec_in})

    # ---- 3g. B3 instanced + amask and the gated loop, instanced ---------
    lv, lv_meta = instanced_leaves().compile(dev)
    lcam = CameraConfig(image_size=(256, 256), focal_length=30.0, position=(0.0, 1.2, 4.5),
                        forward=(0.0, -0.1, -1.0))
    lo_, ld_, lseed = camera_rays(lcam, dev, seeds=True)
    rec_la = compare_amask("instanced_leaves_camera_2^16", lv, lv_meta, lo_, ld_, lseed, timed=False)
    emit({"phase": "kernel", **rec_la})
    l_tmax = torch.full((lo_.shape[0],), 1e30, device=dev)
    rec_lg = compare_gated("instanced_leaves_camera_2^16", lv, lv_meta, lo_, ld_, l_tmax, lseed, nee=False)
    emit({"phase": "gated", **rec_lg})
    lh = blocktrace.intersect_blocktrace_gated(lv, lv_meta, lo_, ld_, l_tmax, alpha_seed=lseed)
    l_sho = (lo_ + torch.where(lh.mask, lh.t, 0.0)[:, None] * ld_).contiguous()
    rec_lgs = compare_gated("instanced_leaves_shadow_2^16", lv, lv_meta, l_sho, sun_d[: lo_.shape[0]].contiguous(),
                            torch.where(lh.mask, 100.0, -1.0), lseed ^ 0x6A09E667, nee=True)
    emit({"phase": "gated", **rec_lgs})
    if rec_lg["casts"] < 2 or rec_lgs["casts"] < 2:
        raise AssertionError("the instanced gated loop took a single cast: nothing passed through")

    # ---- 3h. B4 at the dense atrium's and the bench scene's shapes ------
    # Both bin-trace scenes build here on the host (the host library's SAH
    # build; the numpy twin's took about a minute and a half for the dense
    # atrium).
    t0 = time.time()
    dense_builder = atrium(density=3)
    dense_author_s = time.time() - t0
    t0 = time.time()
    dense, dense_meta = dense_builder.compile(dev)
    dense_compile_s = time.time() - t0
    dense_timings = dense_builder.timings
    del dense_builder
    dense_build_s = round(dense_author_s + dense_compile_s, 3)
    emit({"phase": "scene", "scene": "atrium(density=3)", "n_tris": dense_meta.n_tris,
          "n_clusters": dense_meta.n_clusters, "coarse_groups": int(dense.coarse_pack.shape[0]),
          "coarse_depth": dense_meta.coarse_depth, "any_alpha": dense_meta.any_alpha,
          "any_transparent": dense_meta.any_transparent,
          "textures_and_meshes_s": round(dense_author_s, 3),
          "compile_s": round(dense_compile_s, 3), "build_s": dense_build_s, **dense_timings})
    t0 = time.time()
    big16, big16_meta = big_scene(dev, cluster_size=16)
    emit({"phase": "scene", "scene": "bench bigscene (60 spheres), C = 16", "n_tris": big16_meta.n_tris,
          "n_clusters": big16_meta.n_clusters, "build_s": round(time.time() - t0, 3)})
    if dense_meta.n_clusters <= blocktrace.MAX_CLUSTERS or big16_meta.n_clusters <= blocktrace.MAX_CLUSTERS:
        raise AssertionError("a bin-trace scene fits the block trace's cluster cap")
    dense_pos, dense_target = CAMERAS["atrium"]
    dense_fwd = tuple(t - p for p, t in zip(dense_pos, dense_target))
    do, dd = camera_rays(CameraConfig(image_size=(side, side), focal_length=35.0, position=dense_pos,
                                      forward=dense_fwd), dev)
    rec_h = compare_pairs("atrium_dense_camera", dense, dense_meta, do, dd,
                          torch.full((do.shape[0],), 1e30, device=dev))
    emit({"phase": "kernel", **rec_h})
    bo, bd = (torch.from_numpy(a).to(dev) for a in make_rays(lanes, False))
    rec_hb = compare_pairs("bigscene_c16_incoherent", big16, big16_meta, bo, bd,
                           torch.full((lanes,), 100.0, device=dev))
    emit({"phase": "kernel", **rec_hb})

    # ---- 3i. intersect_bintrace: kernel path vs twin path ----------------
    go, gd = camera_rays(CameraConfig(image_size=(256, 256), focal_length=35.0, position=dense_pos,
                                      forward=dense_fwd), dev)
    g_tmax = torch.full((go.shape[0],), 1e30, device=dev)
    rec_i1 = compare_bintrace("atrium_dense_camera_2^16", dense, dense_meta, go, gd, g_tmax, nee=False)
    emit({"phase": "bintrace", **rec_i1})
    gh = bintrace.intersect_bintrace(dense, dense_meta, go, gd, g_tmax)
    sun = torch.tensor([0.45, 0.72, 0.3], device=dev)
    sh_d = (sun / sun.norm()).expand_as(gd).contiguous()
    sh_o = (go + torch.where(gh.mask, gh.t, 0.0)[:, None] * gd).contiguous()
    rec_i2 = compare_bintrace("atrium_dense_sun_shadow_2^16", dense, dense_meta, sh_o, sh_d,
                              torch.where(gh.mask, 100.0, -1.0), nee=True)
    emit({"phase": "bintrace", **rec_i2})

    # ---- 3j. B6 (the bounce's sampler draws) against its twin -----------
    # The lane states of a 512x512 render's first chunk (4 samples a pixel:
    # 2^20 lanes), at bounce 0 and 3, ZSobol at 16 spp (even log2spp) and
    # 8 spp (odd: the pow2_samples branch), hash; and a ragged 1000.
    b6 = []
    for name, (smp, lanes, d0), timed in b6_cases(dev):
        b6.append(compare_draws(name, smp, lanes, d0, timed=timed))
        emit({"phase": "kernel", **b6[-1]})
    rec_j = b6[0]

    # ---- 3k. B5 (the fused shade tail) against its twin -----------------
    # The lanes of a real bounce (depth 1) of cornell-mat and atrium-ivy at
    # 2^20 lanes and of roadster (metallic, transmissive and clearcoat
    # gates on) at 2^16; 2^20 random lanes with all four gates on, also
    # with mis and any_lights off; a set with whole dead blocks; the edges
    # of the kernel's tiles (`b5_cases`).
    cornell_cam = CameraConfig(image_size=(512, 512), focal_length=35.0,
                               position=(0, 1.0, 3.4), forward=(0, 0, -3.4))
    ivy_cam = CameraConfig(image_size=(512, 512), focal_length=35.0, position=ivy_pos, forward=ivy_fwd,
                           exposure=3.0)
    t0 = time.time()
    road, road_meta = roadster().compile(dev)
    emit({"phase": "scene", "scene": "roadster", "n_tris": road_meta.n_tris,
          "gates": [road_meta.any_metallic, road_meta.any_transmissive, road_meta.any_clearcoat,
                    road_meta.any_anisotropy], "build_s": round(time.time() - t0, 3)})
    road_pos, road_target = CAMERAS["roadster"]
    road_fwd = tuple(t - p for p, t in zip(road_pos, road_target))
    b5 = []
    for name, b5_args, timed in b5_cases(dev, {"cornell-mat": (scene, meta), "atrium-ivy": (ivy, ivy_meta),
                                               "roadster": (road, road_meta)}):
        b5.append(compare_shade(name, *b5_args, timed=timed))
        emit({"phase": "kernel", **b5[-1]})

    # ---- 3l. this slice's main path: the round-based block trace ---------
    # intersect_blocktrace(fused=False) with B7a (select) and B7b (test) on
    # the bench scene (C = 128) at 262,144 incoherent and coherent rays:
    # each kernel against its twin at round 1 and at a later round; the
    # whole cast with every count reset just before and read just after,
    # against the fused path; its kernel path against its twin path at 2^16
    # rays (closest, nee, a floored re-cast) and the gated loop with
    # fused=False on atrium-ivy's 2^16 camera rays.
    t0 = time.time()
    b7, b7_cast, b7_launches = [], {}, {}
    bench_lanes = 262144  # bench.py's lane count
    for case, coherent in (("incoherent", False), ("coherent", True)):
        lo, ld = (torch.from_numpy(a).to(dev) for a in make_rays(bench_lanes, coherent))
        for later in (False, True):
            b7.append(compare_legacy_kernels(f"bigscene_{case}_{'later' if later else 'round1'}", big, big_meta,
                                             lo, ld, later))
            emit({"phase": "kernel", **b7[-1]})
        b7_cast[case], b7_launches[case] = legacy_cast(f"bigscene_{case}", big, big_meta, lo, ld,
                                                       torch.full((bench_lanes,), 100.0, device=dev))
        emit({"phase": "legacy", **b7_cast[case]})
    po, pd = (torch.from_numpy(a).to(dev) for a in make_rays(1 << 16, False))
    pt = torch.full((1 << 16,), 100.0, device=dev)
    rec_l, hl = compare_legacy_paths("bigscene_closest_2^16", big, big_meta, po, pd, pt)
    emit({"phase": "legacy", **rec_l})
    emit({"phase": "legacy", **compare_legacy_paths("bigscene_nee_2^16", big, big_meta, po, pd,
                                                    torch.full((1 << 16,), 8.0, device=dev), nee=True)[0]})
    emit({"phase": "legacy", **compare_legacy_paths("bigscene_floor_2^16", big, big_meta, po, pd, pt,
                                                    floor=hl[0])[0]})
    lgo, lgd, lgseed = camera_rays(CameraConfig(image_size=(256, 256), focal_length=35.0, position=ivy_pos,
                                                forward=ivy_fwd), dev, seeds=True)
    emit({"phase": "gated", **compare_gated("atrium_ivy_camera_2^16_round_based", ivy, ivy_meta, lgo, lgd,
                                            torch.full((lgo.shape[0],), 1e30, device=dev), lgseed, nee=False,
                                            fused=False)})
    emit({"phase": "legacy_total", "seconds": round(time.time() - t0, 3)})
    del lo, ld, po, pd, pt, hl, lgo, lgd, lgseed

    # ---- 4. main paths: cornell-mat (B1) and spheres (B2 + B3) ----------
    rec, launches_cornell, off_cornell = render_main_path("cornell-mat", scene, meta, cornell_cam, args.spp, dev)
    emit(rec)
    if launches_cornell["brute_intersect"] <= 0:
        raise AssertionError("the cornell-mat render launched B1 no time")

    spheres_cam = CameraConfig(image_size=(512, 512), focal_length=35.0, position=pos, forward=spheres_fwd)
    rec, launches_spheres, _ = render_main_path("spheres", spheres, spheres_meta, spheres_cam, args.spp, dev)
    emit(rec)
    if launches_spheres["presort_keys"] <= 0 or launches_spheres["fused_trace"] <= 0:
        raise AssertionError(f"the spheres render did not launch B2 and B3: {launches_spheres}")
    if launches_spheres["brute_intersect"] != 0:
        raise AssertionError("a spheres ray went to B1 instead of the block trace")

    # ---- 4c. atrium-ivy (gated loop, B3 amask) ---------------------------
    rec, launches_ivy, off_ivy = render_main_path("atrium-ivy", ivy, ivy_meta, ivy_cam, args.spp, dev)
    rec["scene_build_s"] = round(author_s + compile_s, 3)
    emit(rec)
    if launches_ivy["presort_keys"] <= 0 or launches_ivy["fused_trace_modes"].get("amask", 0) <= 0:
        raise AssertionError(f"the atrium-ivy render did not launch B2 and B3 in amask mode: {launches_ivy}")
    if launches_ivy["brute_intersect"] != 0:
        raise AssertionError("an atrium-ivy ray went to B1 instead of the block trace")

    # ---- 4d. this slice's main path: atrium-inst (B3 instanced) ---------
    inst_cam = CameraConfig(image_size=(512, 512), focal_length=35.0, position=inst_pos, forward=inst_fwd,
                            exposure=3.0)
    rec, launches_inst, _ = render_main_path("atrium-inst", inst, inst_meta, inst_cam, args.spp, dev)
    rec["scene_build_s"] = inst_build_s
    emit(rec)
    inst_modes = launches_inst["fused_trace_modes"]
    if launches_inst["presort_keys"] <= 0 or inst_modes.get("instanced", 0) <= 0 \
            or inst_modes.get("instanced+nee", 0) <= 0:
        raise AssertionError(f"the atrium-inst render did not launch B2 and B3's instanced modes: {launches_inst}")
    if set(inst_modes) != {"instanced", "instanced+nee"} or launches_inst["brute_intersect"] != 0:
        raise AssertionError(f"an atrium-inst ray left B3's instanced modes: {launches_inst}")

    # ---- 4e. this slice's main path: the dense atrium (bin-trace, B4) ---
    dense_cam = CameraConfig(image_size=(512, 512), focal_length=35.0, position=dense_pos, forward=dense_fwd,
                             exposure=3.0)
    rec, launches_dense, _ = render_main_path("atrium-dense", dense, dense_meta, dense_cam, DENSE_SPP, dev)
    rec["scene_build_s"] = dense_build_s
    emit(rec)
    if launches_dense["cluster_pairs"] <= 0:
        raise AssertionError(f"the dense atrium render launched B4 no time: {launches_dense}")
    if any(launches_dense[k] for k in ("brute_intersect", "presort_keys", "fused_trace")):
        raise AssertionError(f"a dense atrium ray left bin-trace for B1, B2 or B3: {launches_dense}")

    # ---- 4f. this slice's main path: the fused shade tail (B6 + B5) -----
    # cornell-mat and atrium-ivy with shade_kernel="pallas": B6 and B5 must
    # launch once per bounce (per depth and compaction stage), no twin on
    # CUDA; the intersection kernels' counts beside phase 4/4c's "off"
    # render. The image against "off" at _assert_images_equivalent's bar
    # (tests/test_shade_kernel.py:209-222) at the spp and depth where that
    # test sets it (4 spp, depth 4), at 512x512; at 16 spp and depth 30 the
    # two bodies' float orders drift apart over long paths (from the same
    # state they take the same decisions), and the bar's four numbers are
    # reported.
    fused, pallas_imgs = {}, {}
    for name, sc, sc_meta, cam, off_img, off_l in (
            ("cornell-mat", scene, meta, cornell_cam, off_cornell, launches_cornell),
            ("atrium-ivy", ivy, ivy_meta, ivy_cam, off_ivy, launches_ivy)):
        rec, lp, img = render_main_path(name, sc, sc_meta, cam, args.spp, dev, shade_kernel="pallas")
        if lp["bounces"] <= 0 or lp["shade"] != lp["bounces"] or lp["draws"] != lp["bounces"]:
            raise AssertionError(f"{name}: B5 / B6 launched {lp['shade']} / {lp['draws']} times "
                                 f"over {lp['bounces']} bounces")
        keys = ("brute_intersect", "presort_keys", "fused_trace", "cluster_pairs")
        if any((lp[k] > 0) != (off_l[k] > 0) for k in keys):
            raise AssertionError(f"{name}: pallas and off take different intersection kernels: {lp} vs {off_l}")
        rec["off"] = {"launches": {k: off_l[k] for k in keys}, "fused_trace_modes": off_l["fused_trace_modes"],
                      "bounces": off_l["bounces"], "rays": off_l["rays"]}
        rec["vs_off_depth30"] = images_equivalent(off_img, img, off_l["rays"], lp["rays"])
        _, l4o, i4o = render_main_path(name, sc, sc_meta, cam, 4, dev, max_depth=4)
        _, l4p, i4p = render_main_path(name, sc, sc_meta, cam, 4, dev, shade_kernel="pallas", max_depth=4)
        rec["vs_off_4spp_depth4"] = images_equivalent(i4o, i4p, l4o["rays"], l4p["rays"])
        emit(rec)
        if not rec["vs_off_4spp_depth4"]["meets_bar"]:
            raise AssertionError(f"{name}: pallas against off at 4 spp, depth 4 misses the bar: "
                                 f"{rec['vs_off_4spp_depth4']}")
        fused[name] = (rec, lp)
        pallas_imgs[name] = img
    # The numpy twins' atrium-ivy at 4f's settings beside the native-built
    # one: another tree cuts other clusters, so the paths' float orders and
    # the image's bits may part; the means must agree.
    rec, lp_np, img_np = render_main_path("atrium-ivy (numpy twin build)", ivy_np, ivy_np_meta, ivy_cam, args.spp, dev,
                                          shade_kernel="pallas")
    img_nat = pallas_imgs["atrium-ivy"]
    rec.update(phase="native_vs_numpy_build", native_hdr_mean=[float(x) for x in img_nat.mean(axis=(0, 1))],
               bitwise_pixel_share=float((img_np.view(np.int32) == img_nat.view(np.int32)).all(axis=-1).mean()),
               mean_rel=float(abs(img_np.mean() - img_nat.mean()) / img_nat.mean()),
               native_wall_s=fused["atrium-ivy"][0]["wall_s"], native_rays=fused["atrium-ivy"][1]["rays"])
    emit(rec)
    if rec["mean_rel"] > SCENE_FILE_MEAN_RTOL:
        raise AssertionError(f"atrium-ivy: the native-built render's mean is {rec['mean_rel']} off the numpy-built one's")
    del ivy_np, img_np

    # ---- 5. reference checks --------------------------------------------
    gcam = CameraConfig(image_size=(64, 64), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
    gcfg = RenderConfig(samples=16, max_depth=6, tonemap="none", estimator="gmon",
                        first_wave_samples=16, max_wave_samples=16)
    emit(reference_check("cornell-mat", scene, meta, gcam, gcfg, "cornell_mat_64", dev))
    scam = CameraConfig(image_size=(48, 48), focal_length=40.0, f_number=2.8, position=(0, 2.2, 5.5),
                        forward=(0, -1.8, -6.1), aperture_sides=6)
    scfg = RenderConfig(samples=16, max_depth=6, tonemap="none", estimator="mean",
                        first_wave_samples=16, max_wave_samples=16)
    emit(reference_check("spheres", spheres, spheres_meta, scam, scfg, "spheres_dof", dev))
    tb, tb_meta = textured_box_scene().compile(dev)
    tcam = CameraConfig(image_size=(48, 48), focal_length=26.0, position=(0, 1.6, 3.2), forward=(0, -0.9, -3.0))
    tcfg = RenderConfig(samples=16, max_depth=5, tonemap="none", estimator="mean",
                        first_wave_samples=16, max_wave_samples=16)
    emit(reference_check("textured_box", tb, tb_meta, tcam, tcfg, "textured", dev, twin=False))
    # atrium-ivy and atrium-inst at 32x32, depth 4 (16x16, the ivy at depth
    # 2, while the dense builds' numpy SAH held the script within 100 s of
    # its limit; their twin paths, B3's plain amask and instanced twins,
    # took 54.7 and 14.6 s at this size).
    icam = CameraConfig(image_size=(32, 32), focal_length=35.0, position=ivy_pos, forward=ivy_fwd, exposure=3.0)
    icfg = RenderConfig(samples=2, max_depth=4, tonemap="none", estimator="mean",
                        first_wave_samples=2, max_wave_samples=2)
    emit(reference_check("atrium-ivy", ivy, ivy_meta, icam, icfg, None, dev))

    acam = CameraConfig(image_size=(32, 32), focal_length=35.0, position=inst_pos, forward=inst_fwd, exposure=3.0)
    emit(reference_check("atrium-inst", inst, inst_meta, acam, icfg, None, dev))
    dcam = CameraConfig(image_size=(32, 32), focal_length=35.0, position=dense_pos, forward=dense_fwd, exposure=3.0)
    emit(reference_check("atrium-dense", dense, dense_meta, dcam, icfg, None, dev))
    emit(instanced_vs_baked(inst, inst_meta, inst_pos, inst_fwd, dev))
    emit(pallas_equals_xla("cornell-mat", scene, meta, gcam, dev))
    emit(pallas_equals_xla("atrium-ivy", ivy, ivy_meta, CameraConfig(
        image_size=(64, 64), focal_length=35.0, position=ivy_pos, forward=ivy_fwd, exposure=3.0), dev))
    emit(pallas_equals_xla("roadster", road, road_meta, CameraConfig(
        image_size=(64, 64), focal_length=35.0, position=road_pos, forward=road_fwd, exposure=1.0), dev))

    # ---- 6. the differentiable path (fwd+bwd): B1-B3 in every forward ----
    # bounce and in no backward pass, under every remat policy.
    t0 = time.time()
    atr, atr_meta = atrium().compile(dev)
    emit({"phase": "scene", "scene": "atrium", "n_tris": atr_meta.n_tris, "build_s": round(time.time() - t0, 3)})
    atr_pos, atr_target = CAMERAS["atrium"]
    fwdbwd = fwdbwd_phases(dev, {
        "cornell-mat": (scene, meta, cornell_cam.position, cornell_cam.forward),
        "atrium-ivy": (ivy, ivy_meta, ivy_pos, ivy_fwd),
        "atrium": (atr, atr_meta, atr_pos, tuple(t - p for p, t in zip(atr_pos, atr_target))),
        "roadster": (road, road_meta, road_pos, road_fwd),
        "atrium-inst": (inst, inst_meta, inst_pos, inst_fwd)})
    emit({"phase": "fwdbwd_total", "seconds": fwdbwd["seconds"]})
    del atr

    # ---- 7. the stack traversals and the per-instance loop --------------
    # The dense ivy atrium (gated, past the cluster cap) through
    # intersect_bvh_sorted and held against the gated brute; its render
    # with "pallas"; the dense instanced atrium through the per-instance
    # loop, kernel path against twin path, its render against the baked
    # dense atrium's.
    p7 = stack_phases(dev, dense, dense_meta)

    # ---- 8. scene files -------------------------------------------------
    # atrium-ivy and atrium-inst written as GLBs with their skies as HDR
    # files, rendered through the CLI; kernel path == twin path on the GLB
    # scenes; the PNG decoder's host seconds.
    p8 = scene_file_phases(dev, args.spp, ivy_builder, pallas_imgs["atrium-ivy"], inst_builder, inst, inst_meta,
                           cornell_box(extra_materials=True))

    # ---- 9. the application layer ----------------------------------------
    # atrium-ivy over two gloo ranks on the card, bitwise to 4f; the CLI's
    # --devices all (one NCCL rank) and its flags; the samplers B6 does not
    # draw, kernel path == twin path.
    p9 = app_layer_phases(dev, args.spp, ivy, ivy_meta, ivy_cam, pallas_imgs["atrium-ivy"],
                          fused["atrium-ivy"][1]["rays"], scene, meta)

    emit({"phase": "total", "seconds": round(time.time() - t_start, 3)})
    fused["atrium-ivy-dense"] = p7["7b"]
    fused["atrium-ivy GLB (8a)"] = p8["8a"]
    fused["atrium-ivy JPEG GLB (8d)"] = p8["8d"]
    l8a, l8b, l8d = p8["8a"][1], p8["8b"][1], p8["8d"][1]

    def app_launches(kernel, cases=("9b", "9c") + tuple(f"9d_{k}" for k in APP_SAMPLERS)):
        """Phase 9's launches of `kernel`: each rank's in 9a, then the CLI
        and sampler cases."""
        out = {f"9a rank {x['rank']} (atrium-ivy, 2 gloo ranks)": x["launches"][kernel] for x in p9["9a"]["ranks"]}
        return out | {c: p9[c]["launches"][kernel] for c in cases}

    def loop_launches(kernel):  # the per-instance loop's launches of B1-B3 (phase 7c)
        return {f"instanced loop, {case} cast": r["launches_per_cast"][kernel] for case, r in p7["7c"].items()} | {
            "atrium-inst-dense render": p7["7c_render"][1][kernel]}

    print(json.dumps({"kernels": [
        {"name": "brute_intersect", "route": "cuda",
         "source": "yart_tpu_torch/csrc/brute_intersect.cu",
         "replaces": "yart_tpu/kernels/pallas_intersect.py:132",
         "launches": launches_cornell["brute_intersect"],
         "launches_by_path": {"cornell-mat": launches_cornell["brute_intersect"], **loop_launches("brute_intersect"),
                              "cornell-mat GLB (8c)": p8["8c_cornell_mat_glb"]["launches"]["brute_intersect"],
                              **app_launches("brute_intersect")},
         "fwdbwd_launches": fwdbwd_launch_table(fwdbwd, "brute_intersect"),
         "max_abs_err": max(r["max_abs_err"] for r in b1),
         "ms": rec_a["ms"], "plain_ms": rec_a["plain_ms"],
         "bound_ms": rec_a["bound_ms"], "bound_by": rec_a["bound_by"], "library_ms": None,
         "wrapper_ms": rec_a["wrapper_ms"], "nofma_floor_ms": rec_a["nofma_floor_ms"],
         "ptxas": build.ptxas_report("brute_intersect"),
         "soup_4096": {k: b1[1][k] for k in B1_KEYS}},
        {"name": "presort_keys", "route": "cuda",
         "source": "yart_tpu_torch/csrc/presort_keys.cu",
         "replaces": "yart_tpu/kernels/pallas_fusedtrace.py:999",
         "launches": launches_inst["presort_keys"],
         "launches_by_path": {"spheres": launches_spheres["presort_keys"],
                              "atrium-ivy": launches_ivy["presort_keys"],
                              "atrium-inst": launches_inst["presort_keys"], **loop_launches("presort_keys"),
                              "atrium-ivy GLB (8a)": l8a["presort_keys"], "atrium-inst GLB (8b)": l8b["presort_keys"],
                              "atrium-ivy JPEG GLB (8d)": l8d["presort_keys"],
                              **app_launches("presort_keys", ())},
         "fwdbwd_launches": fwdbwd_launch_table(fwdbwd, "presort_keys"),
         "max_abs_err": max(r["b2_max_abs_err"] for r in bt_recs + [rec_ic, rec_in, rec_ir]),
         "ms": rec_ic["b2_ms"], "plain_ms": rec_ic["b2_plain_ms"],
         "bound_ms": rec_ic["b2_bound_ms"], "bound_by": rec_ic["b2_bound_by"], "library_ms": None,
         "sweep_bound_ms": rec_ic["b2_sweep_bound_ms"],
         "ptxas": build.ptxas_report("presort_keys"),
         "occupancy_blocks_per_sm": build.occupancy("presort_keys"),
         **{r["case"]: {k: r[k] for k in B2_KEYS} for r in (rec_i, rec_ir, rec_in, recs["incoherent"], rec_s)}},
        {"name": "fused_trace", "route": "cuda",
         "source": "yart_tpu_torch/csrc/fused_trace.cu",
         "replaces": "yart_tpu/kernels/pallas_fusedtrace.py:1128",
         "launches": launches_inst["fused_trace"],
         "modes": launches_inst["fused_trace_modes"],
         "launches_by_path": {"spheres": launches_spheres["fused_trace_modes"],
                              "atrium-ivy": launches_ivy["fused_trace_modes"],
                              "atrium-inst": launches_inst["fused_trace_modes"], **loop_launches("fused_trace"),
                              "atrium-ivy GLB (8a)": l8a["fused_trace_modes"],
                              "atrium-inst GLB (8b)": l8b["fused_trace_modes"],
                              "atrium-ivy JPEG GLB (8d)": l8d["fused_trace_modes"],
                              **app_launches("fused_trace_modes", ())},
         "fwdbwd_launches": fwdbwd_launch_table(fwdbwd, "fused_trace"),
         "max_abs_err": max([r["b3_max_abs_err"] for r in bt_recs + [rec_ic, rec_in]]
                            + [rec_i["max_abs_err"], rec_la["max_abs_err"]]),
         "ms": rec_ic["b3_ms"], "plain_ms": rec_ic["b3_plain_ms"],
         "bound_ms": rec_ic["b3_bound_ms"], "bound_by": rec_ic["b3_bound_by"], "library_ms": None,
         "sweep_bound_ms": rec_ic["b3_sweep_bound_ms"],
         "ptxas": build.ptxas_report("fused_trace"),
         "instanced_nee": {k: rec_in[k] for k in B3_KEYS},
         "amask_atrium_ivy": {k: rec_i[k] for k in B3_KEYS + ("b3_cast1_ms", "b3_cast1_bound_ms",
                                                                "b3_cast1_sweep_bound_ms")},
         **{r["case"]: {k: r[k] for k in B3_KEYS} for r in (recs["incoherent"], recs["coherent"], rec_s)}},
        {"name": "cluster_pairs", "route": "cuda",
         "source": "yart_tpu_torch/csrc/cluster_pairs.cu",
         "replaces": "yart_tpu/kernels/pallas_cluster.py:200",
         "launches": launches_dense["cluster_pairs"],
         "max_abs_err": max(rec_h["max_abs_err"], rec_hb["max_abs_err"]),
         "ms": rec_h["ms"], "plain_ms": rec_h["plain_ms"],
         "bound_ms": rec_h["bound_ms"], "bound_by": rec_h["bound_by"], "library_ms": None,
         "nofma_floor_ms": rec_h["nofma_floor_ms"], "ptxas": build.ptxas_report("cluster_pairs"),
         "occupancy_blocks_per_sm": rec_h["occupancy_blocks_per_sm"],
         **{k: rec_h[k] for k in B4_ROWS},
         "bench_bigscene_c16": {k: rec_hb[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "nofma_floor_ms")
                                + B4_ROWS}},
        {"name": "shade", "route": "cuda",
         "source": "yart_tpu_torch/csrc/shade.cu",
         "replaces": "yart_tpu/kernels/pallas_shade.py:168",
         "launches": fused["cornell-mat"][1]["shade"],
         "launches_by_path": {k: {"shade": v[1]["shade"], "bounces": v[1]["bounces"]} for k, v in fused.items()}
         | app_launches("shade"),
         "max_abs_err": max(r["max_abs_err"] for r in b5),
         "ms": b5[0]["ms"], "plain_ms": b5[0]["plain_ms"],
         "bound_ms": b5[0]["bound_ms"], "bound_by": b5[0]["bound_by"], "library_ms": None,
         "wrapper_ms": b5[0]["wrapper_ms"], "ptxas": build.ptxas_report("shade"),
         "occupancy_blocks_per_sm": build.occupancy("shade"),
         **{r["case"]: {k: r[k] for k in B5_KEYS} for r in b5 if "ms" in r and r is not b5[0]}},
        {"name": "draws", "route": "cuda",
         "source": "yart_tpu_torch/csrc/draws.cu",
         "replaces": "yart_tpu/kernels/pallas_shade.py:283",
         "launches": fused["cornell-mat"][1]["draws"],
         "launches_by_path": {k: {"draws": v[1]["draws"], "bounces": v[1]["bounces"]} for k, v in fused.items()}
         | app_launches("draws"),
         "max_abs_err": max(r["max_abs_err"] for r in b6),
         "ms": rec_j["ms"], "plain_ms": rec_j["plain_ms"],
         "bound_ms": rec_j["bound_ms"], "bound_by": rec_j["bound_by"], "library_ms": None,
         "wrapper_ms": rec_j["wrapper_ms"],
         "zsobol_odd_log2spp": {k: b6[3][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "hash": {k: b6[-1][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}},
        {"name": "select_clusters", "route": "cuda",
         "source": "yart_tpu_torch/csrc/select_clusters.cu",
         "replaces": "yart_tpu/kernels/pallas_blocktrace.py:174",
         "launches": b7_launches["incoherent"]["select_clusters"],
         "launches_by_path": {k: v["select_clusters"] for k, v in b7_launches.items()},
         "max_abs_err": max(r["select_max_abs_err"] for r in b7),
         "ms": b7[0]["select_ms"], "plain_ms": b7[0]["select_plain_ms"],
         "bound_ms": b7[0]["select_bound_ms"], "bound_by": b7[0]["select_bound_by"], "library_ms": None,
         "nofma_floor_ms": b7[0]["select_nofma_floor_ms"], "sweep_bound_ms": b7[0]["select_sweep_bound_ms"],
         "ptxas": build.ptxas_report("select_clusters"),
         **{f"{r['case']}": {k: r[f"select_{k}"] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "nofma_floor_ms",
                                                            "sweep_bound_ms")}
            for r in b7[1:]}},
        {"name": "test_clusters", "route": "cuda",
         "source": "yart_tpu_torch/csrc/test_clusters.cu",
         "replaces": "yart_tpu/kernels/pallas_blocktrace.py:294",
         "launches": b7_launches["incoherent"]["test_clusters"],
         "launches_by_path": {k: v["test_clusters"] for k, v in b7_launches.items()},
         "max_abs_err": max(r["test_max_abs_err"] for r in b7),
         "ms": b7[0]["test_ms"], "plain_ms": b7[0]["test_plain_ms"],
         "bound_ms": b7[0]["test_bound_ms"], "bound_by": b7[0]["test_bound_by"], "library_ms": None,
         "nofma_floor_ms": b7[0]["test_nofma_floor_ms"], "ptxas": build.ptxas_report("test_clusters"),
         **{f"{r['case']}": {k: r[f"test_{k}"] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "nofma_floor_ms")}
            for r in b7[1:]}},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
