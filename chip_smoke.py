"""On-card smoke test of the PyTorch + CUDA port (yart_tpu_torch).

    python3 chip_smoke.py            # needs one CUDA GPU (an H100 for sm_90a)

Phases, each printing one JSON line; any failure raises, so the script
exits non-zero and prints no final "ok" line:
  1. device  — require CUDA; print the card's name and power limit.
  2. build   — build every kernel of the render path from csrc/ (nvcc).
  3. kernel  — B1 (brute-force intersection) against its plain PyTorch twin
               on the card, bitwise, at cornell-mat's triangles with 2^20
               camera rays and at a seeded 4096-triangle soup with 2^20
               random rays (+ a ragged N and retired t_max = -1 lanes);
               median times from CUDA events.
  4. render  — the main path: Renderer on cuda, cornell-mat 512x512, max
               depth 30, ZSobol, GMoN, AgX, 64 spp in the CLI's waves;
               B1's launch count must be > 0 and the plain twin must not
               have run on CUDA.
  5. reference — the golden_v1 cornell_mat_64 configuration: the kernel
               path's image must equal the plain-twin path's bitwise, and
               its per-channel mean must lie within 2% of the golden's.
The line before the last is the card as nvidia-smi reports it; the last
line is {"ok": true, "device": {...}}.
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warmup_s: float = 0.25) -> float:
    """Median milliseconds of fn() from CUDA events, after at least two
    warm-up calls and `warmup_s` seconds of them (so the clocks have ramped
    up before a sub-millisecond kernel is timed)."""
    import torch

    calls, t_end = 0, time.perf_counter() + warmup_s
    while calls < 2 or time.perf_counter() < t_end:
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


def bits_equal(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
    return bool(torch.equal(a, b))


def compare_brute(name, tri_pack, o, d, t_max, n_tris):
    """Kernel vs plain twin on the same card tensors; raises on any bit
    difference. Returns the phase record."""
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
    if o.shape[0] >= 1 << 20:
        rec["ms"] = cuda_ms(lambda: brute.brute_cuda(tri_pack, o, d, t_max, n_tris, 1e-3), reps=21)
        rec["plain_ms"] = cuda_ms(lambda: brute.brute_plain(tri_pack, o, d, t_max, n_tris, 1e-3), reps=3)
    return rec


@contextlib.contextmanager
def intersection_forced_to_plain():
    """Test-only switch for phase 5a: route the render path's B1 calls to
    the plain twin (on the same CUDA tensors) instead of the kernel."""
    from yart_tpu_torch.kernels import brute

    saved = brute.brute_intersect
    brute.brute_intersect = brute.brute_plain
    try:
        yield
    finally:
        brute.brute_intersect = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--spp", type=int, default=64, help="samples per pixel of the 512x512 render")
    args = ap.parse_args()

    import numpy as np
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA GPU")
    # Imported before anything is printed: a copy of this script without the
    # package fails here with no output.
    from yart_tpu_torch.config import CameraConfig, RenderConfig
    from yart_tpu_torch.io.image import write_png
    from yart_tpu_torch.kernels import brute
    from yart_tpu_torch.ops.qmc import make_sampler
    from yart_tpu_torch.render.camera import build_camera, generate_rays
    from yart_tpu_torch.render.renderer import Renderer
    from yart_tpu_torch.scene.procedural import cornell_box

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind, "count": count,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 2. build -------------------------------------------------------
    t0 = time.time()
    compiled = brute.build()
    emit({"phase": "build", "kernel": "brute_intersect", "compiled_now": compiled,
          "seconds": round(time.time() - t0, 3)})

    # ---- 3. kernel vs plain twin ----------------------------------------
    scene, meta = cornell_box(extra_materials=True).compile(dev)
    side = 1024  # 2^20 camera rays, one per pixel
    cam = build_camera(CameraConfig(image_size=(side, side), focal_length=28.0,
                                    position=(0, 1.0, 3.4), forward=(0, 0, -1)), dev)
    yy, xx = torch.meshgrid(torch.arange(side, device=dev), torch.arange(side, device=dev), indexing="ij")
    px, py = xx.reshape(-1), yy.reshape(-1)
    sampler = make_sampler("zsobol", 1, (side, side), device=dev)
    state = sampler.init_lanes(px, py, torch.zeros_like(px))
    o, d = generate_rays(cam, px, py, sampler.get2d(state, 0), sampler.get2d(state, 2))
    o, d = o.contiguous(), d.contiguous()
    t_max = torch.full((o.shape[0],), 1e30, device=dev)
    rec_a = compare_brute("cornell_mat_camera", scene.tri_pack, o, d, t_max, meta.n_tris)
    emit({"phase": "kernel", **rec_a})

    rng = np.random.default_rng(1234)
    n_soup = brute.MAX_TRIS
    centers = rng.uniform(-2, 2, (n_soup, 1, 3))
    soup = np.zeros((n_soup, 12), np.float32)
    soup[:, :9] = (centers + rng.normal(0, 0.15, (n_soup, 3, 3))).reshape(n_soup, 9)
    soup_t = torch.from_numpy(soup).to(dev)
    n_rays = 1 << 20
    ro = rng.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    rd = rng.uniform(-1.5, 1.5, (n_rays, 3)).astype(np.float32) - ro
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tm = np.full(n_rays, 1e30, np.float32)
    tm[: 1 << 16] = -1.0  # a block of retired lanes
    ro_t, rd_t, tm_t = (torch.from_numpy(a).to(dev) for a in (ro, rd, tm))
    rec_b = compare_brute("soup_4096", soup_t, ro_t, rd_t, tm_t, n_soup)
    if bool((brute.brute_cuda(soup_t, ro_t[: 1 << 16], rd_t[: 1 << 16], tm_t[: 1 << 16], n_soup, 1e-3)[4] >= 0).any()):
        raise AssertionError("a t_max = -1 lane reported a hit")
    emit({"phase": "kernel", **rec_b})
    rec_c = compare_brute("soup_4096_ragged_1000", soup_t, ro_t[-1000:], rd_t[-1000:], tm_t[-1000:], n_soup)
    emit({"phase": "kernel", **rec_c})

    # ---- 4. main path ---------------------------------------------------
    cam_cfg = CameraConfig(image_size=(512, 512), focal_length=35.0,
                           position=(0, 1.0, 3.4), forward=(0, 0, -3.4))
    # The CLI's wave plan (first wave 8, doubling up to 128): the first wave
    # probes per-depth live lanes and the later ones run the compaction
    # the autotune picks, so the staged-compaction path runs on the card.
    cfg = RenderConfig(samples=args.spp, max_depth=30, sampler="zsobol",
                       estimator="gmon", tonemap="agx",
                       first_wave_samples=8, max_wave_samples=128)
    waves = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    brute.COUNTS.reset()
    t0 = time.time()
    res = Renderer(scene, meta, cam_cfg, cfg, device=dev).render(
        on_wave=lambda wd, _: waves.append(
            {"wave": wd.wave, "spp": wd.wave_samples, "compaction": wd.compact,
             "seconds": round(wd.time, 3)}
        )
    )
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, plain_cuda = brute.COUNTS.launches, brute.COUNTS.plain_cuda
    peak = torch.cuda.max_memory_allocated(dev)
    if launches <= 0:
        raise AssertionError("the render path launched B1 no time")
    if plain_cuda != 0:
        raise AssertionError(f"the plain twin ran {plain_cuda} times on CUDA tensors in the render")
    hdr = res.hdr
    if not np.isfinite(hdr).all() or not hdr.mean() > 0.01:
        raise AssertionError(f"bad image: finite={np.isfinite(hdr).all()} mean={hdr.mean()}")
    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, "cornell_mat_512.png")
    write_png(png, res.display)
    emit({"phase": "render", "scene": "cornell-mat", "size": [512, 512], "spp": res.samples_taken,
          "max_depth": 30, "wall_s": round(wall, 3), "rays": res.total_rays,
          "mrays_per_s": res.total_rays / wall / 1e6, "peak_mem_gib": peak / 2 ** 30,
          "b1_launches": launches, "plain_calls_on_cuda": plain_cuda, "waves": waves,
          "hdr_mean": [float(x) for x in hdr.mean(axis=(0, 1))], "png": os.path.relpath(png, ROOT)})

    # ---- 5. reference check --------------------------------------------
    gcam = CameraConfig(image_size=(64, 64), focal_length=28.0, position=(0, 1.0, 3.4), forward=(0, 0, -1))
    gcfg = RenderConfig(samples=16, max_depth=6, tonemap="none", estimator="gmon",
                        first_wave_samples=16, max_wave_samples=16)
    img_k = Renderer(scene, meta, gcam, gcfg, device=dev).render().hdr
    with intersection_forced_to_plain():
        img_p = Renderer(scene, meta, gcam, gcfg, device=dev).render().hdr
    if not np.array_equal(img_k.view(np.int32), img_p.view(np.int32)):
        raise AssertionError(
            f"kernel-path and plain-path images differ (max abs {np.abs(img_k - img_p).max()})"
        )
    with np.load(GOLDEN) as z:
        golden = z["cornell_mat_64"]
    gm, km = golden.mean(axis=(0, 1)), img_k.mean(axis=(0, 1))
    rel = np.abs(km - gm) / gm
    if not (rel <= GOLDEN_MEAN_RTOL).all():
        raise AssertionError(f"channel means {km} vs golden {gm}: rel {rel} > {GOLDEN_MEAN_RTOL}")
    emit({"phase": "reference", "config": "golden_v1 cornell_mat_64", "kernel_eq_plain_bitwise": True,
          "mean": [float(x) for x in km], "golden_mean": [float(x) for x in gm],
          "rel_err": [float(x) for x in rel], "rtol": GOLDEN_MEAN_RTOL})

    print(json.dumps({"kernels": [{
        "name": "brute_intersect", "route": "cuda",
        "source": "yart_tpu_torch/csrc/brute_intersect.cu",
        "replaces": "yart_tpu/kernels/pallas_intersect.py:132",
        "launches": launches,
        "max_abs_err": max(rec_a["max_abs_err"], rec_b["max_abs_err"], rec_c["max_abs_err"]),
        "ms": rec_a["ms"], "plain_ms": rec_a["plain_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
