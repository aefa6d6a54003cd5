"""Progressive wave renderer on one device or over ranks.

Port of `yart_tpu/render/renderer.py` (src/cpu/tile-renderer.hpp): the
image is one dense wavefront of (pixel, sample) lanes cut into chunks of
about 2^20 lanes; waves of samples double from `first_wave_samples` to
`max_wave_samples`; the estimator reduces within a wave and waves merge by
sample-count weights (tile-renderer.hpp:220-232). The first wave measures
per-depth live-lane counts and `choose_compaction` picks staged compaction
for the later ones. A checkpoint (HDR + samples taken) is written
atomically after every wave and resumed from.

With `devices` ("all" or the group's size) the renderer is one rank of a
torch.distributed group (`parallel/`): every chunk is split over the
ranks, each renders its part on its own device with the replicated scene,
the parts' estimates are all-gathered in chunk order and the ray and live
counters summed, so every rank holds the whole image. Samplers are pure
functions of (pixel, sample, dim) and no per-lane result depends on the
lanes beside it, so the image and the ray count are bitwise those of one
process. Rank 0 writes the checkpoint; every rank resumes from it.

The JAX package pads the last chunk to a static shape; here the last chunk
is simply shorter (lanes are independent, so the image is the same), and
no lane is rendered twice.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from yart_tpu_torch.config import CameraConfig, RenderConfig
from yart_tpu_torch.device import resolve
from yart_tpu_torch.ops.qmc import make_sampler
from yart_tpu_torch.ops.tonemap import tonemap
from yart_tpu_torch.parallel import distributed, sharding
from yart_tpu_torch.render.camera import build_camera
from yart_tpu_torch.render.estimator import estimate
from yart_tpu_torch.render.integrator import render_wave
from yart_tpu_torch.scene.types import CompiledScene, SceneMeta


@dataclasses.dataclass
class WaveData:
    """Progress callback payload (src/core/renderer.hpp:30-43)."""

    wave: int
    wave_samples: int
    samples_taken: int
    total_samples: int
    rays: float
    time: float
    compact: object = None  # None (off) or (split, factor) this wave ran with
    live: object = None  # per-depth live-lane counts (numpy)


@dataclasses.dataclass
class ChunkData:
    """Within-wave progress payload, the tile-complete analog
    (src/core/renderer.hpp:45-50, src/cpu/tile-renderer.hpp:243-262): one
    per chunk of pixels, `rays` counted over the render so far."""

    wave: int
    wave_samples: int
    chunk: int
    n_chunks: int
    lanes_done: int
    lanes_total: int
    rays: float
    time: float


@dataclasses.dataclass
class RenderResult:
    """Final render state (src/core/renderer.hpp:22-28)."""

    hdr: np.ndarray  # [H, W, 3] linear
    display: np.ndarray  # [H, W, 3] tonemapped
    samples_taken: int
    total_rays: float
    total_time: float


def choose_compaction(live, n: int, max_depth: int):
    """(split, factor) for staged compaction from measured per-depth
    live-lane counts, or None; the JAX package's cost model verbatim
    (renderer.py:82-116)."""
    live = np.asarray(live, np.float64)
    n = float(max(n, 1))
    ran = np.nonzero(live > 0)[0]
    if ran.size == 0:
        return None
    d_max = int(ran[-1]) + 1
    best = None
    for split in range(1, d_max):
        frac = live[split] / n
        for factor in (8, 6, 4, 3, 2):
            if frac <= 0.8 / factor:
                cost = split + (d_max - split) / factor + 0.75
                if best is None or cost < best[0]:
                    best = (cost, split, factor)
                break
    if best is not None and best[0] <= 0.8 * d_max:
        return int(best[1]), int(best[2])
    return None


def wave_plan(total: int, first: int, max_wave: int):
    """Progressive wave sample counts (tile-renderer.hpp:104-108,284-289)."""
    waves = []
    left = total
    w = first if total > first else total
    while left > 0:
        w = min(w, left, max_wave)
        waves.append(w)
        left -= w
        w *= 2
    return waves


def group_size(devices) -> int:
    """Ranks a Renderer with `devices` renders over: None, 0 and 1 mean
    this process alone; "all" means every rank of the torch.distributed
    group (this process alone without one); N > 1 must be the group's
    size."""
    if devices in (None, 0, 1, "1"):
        return 1
    if devices == "all":
        return distributed.world_size()
    n = int(devices)
    if n != distributed.world_size():
        raise ValueError(
            f"devices={n}: this process is one rank of a group of {distributed.world_size()}. A render "
            f"over {n} ranks runs in {n} processes joined by torch.distributed "
            "(yart_tpu_torch.parallel.distributed.init_distributed), one a card: the CLI's "
            f"--devices {n}, torchrun with --distributed, or parallel.distributed.spawn")
    return n


class Renderer:
    """Progressive renderer on one device (`device`: "cuda" by default,
    "cuda:1", "cpu", ...; a CUDA device without a card raises), or one
    rank of a multi-rank render (`devices`: see `group_size`; module doc),
    the rank's own device given as `device`. `debug_nan` raises
    FloatingPointError, naming the wave and chunk, when a chunk's
    estimate, ray count or live counts hold a NaN.

    A chunk that the image's end cuts short (a ragged last chunk) renders
    its real pixels only, so the ray and live counts, and the compaction
    autotune that reads the live counts, cover exactly the image's lanes,
    whatever `chunk_pixels` is. The JAX Renderer pads that chunk with
    wrapped pixels and counts their lanes too
    (yart_tpu/render/renderer.py:355-360, :384): at such sizes its ray
    count, and so its Mrays/s, is larger than the port's. This divergence
    is intended; the images are the same."""

    def __init__(self, scene: CompiledScene, meta: SceneMeta, cam_cfg: CameraConfig,
                 cfg: RenderConfig = RenderConfig(), device="cuda", devices=None, debug_nan: bool = False):
        self.n_devices = group_size(devices)
        # Collectives whenever a group renders, even a group of one.
        self.sharded = devices not in (None, 0, 1, "1") and distributed.is_initialized()
        self.rank = distributed.rank() if self.sharded else 0
        self.debug_nan = debug_nan
        self.device = resolve(device)
        self.scene = scene.to(self.device)
        self.meta = meta
        self.cfg = cfg
        self.cam = build_camera(cam_cfg, self.device)
        self.width, self.height = cam_cfg.image_size
        res = max(self.width, self.height)
        self.sampler = make_sampler(cfg.sampler, cfg.samples, (res, res), cfg.seed, device=self.device)
        # Per-wave compaction autotune state (persists across render calls).
        self._compact_override = None
        self._compact_decided = False

    def _wave(self, k: int, compact, px, py, sample_base: int):
        """[P] pixels x k samples -> estimator-reduced [P, 3], rays, live."""
        cfg = self.cfg
        if compact == "off":
            cfg = dataclasses.replace(cfg, compact_depth=None)
        elif isinstance(compact, tuple):
            cfg = dataclasses.replace(cfg, compact_depth=compact[0], compact_factor=compact[1])
        p = px.shape[0]
        lane_px = px.repeat_interleave(k)
        lane_py = py.repeat_interleave(k)
        sidx = torch.arange(k, dtype=torch.int64, device=self.device).repeat(p) + sample_base
        radiance, rays, live = render_wave(
            self.scene, self.meta, self.cam, self.sampler, cfg, lane_px, lane_py, sidx,
            return_live=True,
        )
        return estimate(radiance.reshape(p, k, 3), cfg.estimator, cfg.estimator_buckets), rays, live

    def _chunk(self, k: int, compact, px, py, sample_base: int):
        """The chunk's [P, 3] estimates, ray count and live counts: this
        process's render, or the ranks' parts gathered and summed."""
        if not self.sharded:
            return self._wave(k, compact, px, py, sample_base)
        n = px.shape[0]
        s, e = sharding.rank_part(n, self.n_devices, self.rank)
        if e > s:
            est, rays, live = self._wave(k, compact, px[s:e], py[s:e], sample_base)
        else:  # a rank past the chunk's last part renders nothing
            est = torch.zeros((0, 3), dtype=torch.float32, device=self.device)
            rays = torch.zeros((), dtype=torch.float64, device=self.device)
            live = torch.zeros(self.cfg.max_depth, dtype=torch.float64, device=self.device)
        return sharding.gather_rows(est, n), sharding.sum_ranks(rays), sharding.sum_ranks(live)

    def _abort(self, should_abort) -> bool:
        """`should_abort()`, agreed by every rank (true if any rank's is)."""
        flag = should_abort is not None and bool(should_abort())
        return sharding.any_rank(flag, self.device) if self.sharded else flag

    def render(
        self,
        on_wave: Optional[Callable[[WaveData, np.ndarray], None]] = None,
        on_chunk: Optional[Callable[[ChunkData, Callable], None]] = None,
        chunk_pixels: Optional[int] = None,
        checkpoint: Optional[str] = None,
        max_waves: Optional[int] = None,
        should_abort: Optional[Callable[[], bool]] = None,
    ) -> RenderResult:
        """Render progressively. `on_wave(wd, preview)` after every wave
        with the tonemapped image; `on_chunk(cd, merged_hdr)` after every
        chunk, `merged_hdr()` building the partial [H, W, 3] HDR image
        (this wave merged over the chunks done, the earlier waves
        elsewhere) for live previews; `checkpoint` resumes from and
        saves to an .npz file; `should_abort` is polled before every wave
        and chunk (a partial wave is discarded)."""
        cfg = self.cfg
        h, w = self.height, self.width
        n_pix = h * w
        fixed = chunk_pixels or cfg.lane_chunk

        def chunk_for(k: int) -> int:
            # A lane budget of ~2^20 rays per chunk bounds device memory;
            # a rank renders a part of a chunk, never more.
            return min(fixed or max(1, (1 << 20) // max(k, 1)), n_pix)

        yy, xx = torch.meshgrid(
            torch.arange(h, device=self.device), torch.arange(w, device=self.device), indexing="ij"
        )
        px_all = xx.reshape(-1).to(torch.int32)
        py_all = yy.reshape(-1).to(torch.int32)

        hdr = torch.zeros((n_pix, 3), dtype=torch.float32, device=self.device)
        samples_taken = 0
        total_rays = 0.0
        if checkpoint and os.path.exists(checkpoint):
            with np.load(checkpoint) as z:
                if z["hdr"].shape == (n_pix, 3) and int(z["seed"]) == cfg.seed:
                    hdr = torch.from_numpy(z["hdr"].astype(np.float32)).to(self.device)
                    samples_taken = int(z["samples_taken"])
                    total_rays = float(z["rays"])
        t0 = time.time()

        plan = wave_plan(cfg.samples, cfg.first_wave_samples, cfg.max_wave_samples)
        done = samples_taken
        remaining = []
        for k in plan:  # skip waves a resumed checkpoint already covers
            if done >= k:
                done -= k
            else:
                remaining.append(k - done)
                done = 0
        if max_waves is not None:
            remaining = remaining[:max_waves]
        autotune = cfg.compact_depth == "auto"
        auto_static = (2, cfg.compact_factor) if self.meta.has_env else None
        for wave_i, k in enumerate(remaining):
            if self._abort(should_abort):
                break
            override = self._compact_override
            if override is not None:
                effective = None if override == "off" else override
            elif autotune:
                effective = auto_static
            elif cfg.compact_depth:
                effective = (cfg.compact_depth, cfg.compact_factor)
            else:
                effective = None
            chunk = chunk_for(k)
            n_chunks = -(-n_pix // chunk)
            wave_img = torch.empty((n_pix, 3), dtype=torch.float32, device=self.device)
            wave_live = torch.zeros(cfg.max_depth, dtype=torch.float64, device=self.device)
            wave_rays = torch.zeros((), dtype=torch.float64, device=self.device)
            lanes_done = 0

            def merged_hdr():
                # The partial image: this wave merged where its chunks have
                # landed, the earlier waves' HDR elsewhere.
                if samples_taken == 0:
                    out = wave_img.clone()
                else:
                    out = hdr * (samples_taken / (samples_taken + k)) + wave_img * (k / (samples_taken + k))
                out[lanes_done:] = hdr[lanes_done:]
                return out.reshape(h, w, 3).cpu().numpy()

            aborted = False
            for ci, start in enumerate(range(0, n_pix, chunk)):
                if ci > 0 and self._abort(should_abort):
                    aborted = True  # a partial wave is discarded
                    break
                end = min(start + chunk, n_pix)
                est, rays, live = self._chunk(k, override, px_all[start:end], py_all[start:end], samples_taken)
                if self.debug_nan and bool(torch.isnan(est).any() | torch.isnan(rays) | torch.isnan(live).any()):
                    raise FloatingPointError(
                        f"NaN in wave {wave_i} ({k} spp) chunk {ci} of {n_chunks} (pixels {start}-{end}): "
                        f"estimate {int(torch.isnan(est).any(dim=-1).sum())} pixels, rays {float(rays)}, "
                        f"live {live.cpu().numpy()}")
                wave_img[start:end] = est
                wave_rays += rays
                wave_live += live
                lanes_done = end
                if on_chunk is not None:
                    on_chunk(ChunkData(wave=wave_i, wave_samples=k, chunk=ci, n_chunks=n_chunks, lanes_done=end,
                                       lanes_total=n_pix, rays=total_rays + float(wave_rays),
                                       time=time.time() - t0), merged_hdr)
            if aborted:
                break
            total_rays += float(wave_rays)
            live_np = wave_live.cpu().numpy()

            if autotune and not self._compact_decided:
                choice = choose_compaction(live_np, n_pix * k, cfg.max_depth)
                self._compact_decided = True
                if choice != auto_static:
                    self._compact_override = choice if choice is not None else "off"

            w_cur = samples_taken / (samples_taken + k)
            w_new = k / (samples_taken + k)
            hdr = hdr * w_cur + wave_img * w_new
            samples_taken += k

            if checkpoint and self.rank == 0:
                # Atomic: a kill mid-write never corrupts the resume state.
                tmp = checkpoint + ".tmp.npz"
                np.savez(tmp, hdr=hdr.cpu().numpy(), samples_taken=samples_taken,
                         rays=total_rays, seed=cfg.seed)
                os.replace(tmp, checkpoint)

            if on_wave is not None:
                preview = tonemap(hdr.reshape(h, w, 3), cfg.tonemap, cfg.agx_look).cpu().numpy()
                on_wave(
                    WaveData(
                        wave=wave_i, wave_samples=k, samples_taken=samples_taken,
                        total_samples=cfg.samples, rays=total_rays, time=time.time() - t0,
                        compact=effective, live=live_np,
                    ),
                    preview,
                )

        display = tonemap(hdr.reshape(h, w, 3), cfg.tonemap, cfg.agx_look)
        return RenderResult(
            hdr=hdr.reshape(h, w, 3).cpu().numpy(),
            display=display.cpu().numpy(),
            samples_taken=samples_taken,
            total_rays=total_rays,
            total_time=time.time() - t0,
        )
