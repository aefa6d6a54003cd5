"""Wavefront ray-scene intersection.

Port of `yart_tpu/render/intersect.py` `Hit`, `intersect_brute`, the
ray-order key `coherence_key` (:584-612) and the dispatcher `intersect`
(:937-1025). "Gates" are
the per-hit tests a hit must pass: the stochastic alpha test
(`meta.any_alpha`) and, for shadow rays, transparent surfaces
(`nee and meta.any_transparent`). The dispatcher (:981-1011):

- at most 4096 triangles, no gates: B1 (`kernels/brute.py`);
- at most 4096 triangles with gates: `intersect_brute` with gates, plain
  PyTorch on every device (XLA in the JAX package, no kernel);
- more triangles, no gates: the block trace (`render/blocktrace.py`,
  kernels B2 and B3) up to its cap of 8192 clusters, bin-trace
  (`render/bintrace.py`, kernel B4) past it;
- more triangles with gates: the block trace's gated re-cast loop
  (`intersect_blocktrace_gated`, B2 once, B3 per cast in `amask` mode when
  the scene has alpha), up to the cluster cap.

An instanced scene takes the block trace whatever its size, gated or not,
with B3 in its instanced mode, as the JAX package does on the TPU
(:954-976): its traversal clusters are the (instance, prototype cluster)
pairs, at most 8192 of them.

CUDA tensors run the Hopper kernels, CPU tensors their plain twins. Shadow
rays of ungated scenes are closest-hit queries for B1 and any-hit queries
for the block trace and bin-trace, exactly as in the JAX package. Gated
scenes past the cluster cap and instanced scenes past it raise
NotImplementedError with their ROADMAP.md item.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from yart_tpu_torch.kernels import brute as _brute
from yart_tpu_torch.render import bintrace, blocktrace
from yart_tpu_torch.scene.types import CompiledScene, SceneMeta

F32_MAX = 3.0e38
BRUTE_CHUNK = 256  # triangles per step of the gated brute (the JAX scan's chunk)
PLAIN_BUDGET = 1 << 20  # rays x triangles per gated-brute step


class Hit(NamedTuple):
    """SoA hit record (src/cpu/hit.hpp:8-17). All [N]-leading."""

    t: torch.Tensor  # hit distance; t_max on a miss
    tri: torch.Tensor  # int32 triangle index, -1 on a miss
    u: torch.Tensor  # barycentric u
    v: torch.Tensor  # barycentric v
    back_side: torch.Tensor  # bool
    attenuation: torch.Tensor  # [N, 3] NEE transparent-shadow throughput; ones elsewhere
    mask: torch.Tensor  # bool, True = real hit


def _hit(t, u, v, back, tri) -> Hit:
    return Hit(t, tri, u, v, back, torch.ones((t.shape[0], 3), dtype=torch.float32, device=t.device),
               tri >= 0)


def part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int64 x with two zero bits between each
    (the Morton helper `_part1by2`)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def coherence_key(scene: CompiledScene, o, d) -> torch.Tensor:
    """Per-ray sort key [N] int64 of 24 bits (`_coherence_key`): the
    direction octant, then the Morton code of the origin's cell in a 128^3
    grid over the scene's bounding sphere box."""
    octant = (d[:, 0] < 0).long() | ((d[:, 1] < 0).long() << 1) | ((d[:, 2] < 0).long() << 2)
    lo = scene.scene_center - scene.scene_radius
    inv = 1.0 / torch.clamp_min(2.0 * scene.scene_radius, 1e-20)
    cell = (torch.clamp((o - lo) * inv, 0.0, 1.0) * 127.0).long()
    morton = part1by2(cell[:, 0]) | (part1by2(cell[:, 1]) << 1) | (part1by2(cell[:, 2]) << 2)
    return (octant << 21) | morton


def has_gates(meta: SceneMeta, nee: bool) -> bool:
    return bool(meta.any_alpha or (nee and meta.any_transparent))


def check_supported(meta: SceneMeta) -> None:
    """Raise for scenes the ported intersection paths cannot take."""
    if meta.n_instances:
        if not 0 < meta.n_inst_clusters <= blocktrace.MAX_CLUSTERS:
            raise NotImplementedError(
                f"{meta.n_inst_clusters} instance clusters: instanced scenes past "
                f"{blocktrace.MAX_CLUSTERS} need the per-instance traversal loop "
                "`_intersect_instanced`, not ported yet (ROADMAP.md A.10, the application layer)"
            )
        return
    if (meta.n_tris > _brute.MAX_TRIS and meta.n_clusters > blocktrace.MAX_CLUSTERS
            and has_gates(meta, nee=True)):
        raise NotImplementedError(
            f"{meta.n_clusters} clusters with alpha or transparency gates: gated scenes past "
            f"{blocktrace.MAX_CLUSTERS} clusters need the stack traversals `intersect_bvh8` / "
            "`intersect_bvh_sorted`, not ported yet (ROADMAP.md A.9)"
        )


def intersect_brute(scene: CompiledScene, meta: SceneMeta, o, d, t_max, t_min: float = 1e-3,
                    nee: bool = False, alpha_seed=None) -> Hit:
    """Every ray against every triangle, on any device: without gates B1's
    plain twin (the reference of both traversals); with gates the port of
    the JAX package's gated brute (:235-390), plain PyTorch."""
    if not has_gates(meta, nee):
        return _hit(*_brute.brute_plain(scene.tri_pack, o, d, t_max, meta.n_tris, t_min))
    return _gated_brute(scene, meta, o, d, t_max, t_min, nee, alpha_seed)


def _gated_brute(scene, meta, o, d, t_max, t_min, nee, alpha_seed) -> Hit:
    """The JAX scan over chunks of 256 triangles: per chunk the
    Moller-Trumbore test below the carried t, the per-hit gates of every
    candidate (`blocktrace.hit_gates`), and for shadow rays the
    transparent-surface factor of every valid transparent hit; then the
    chunk's first minimum replaces the carry where it is closer."""
    n = o.shape[0]
    dev = o.device
    n_tris = meta.n_tris
    tp = scene.tri_pack[:n_tris]
    p0 = tp[:, 0:3]
    e1 = tp[:, 3:6] - p0
    e2 = tp[:, 6:9] - p0
    if alpha_seed is None:
        alpha_seed = torch.zeros(n, dtype=torch.int64, device=dev)
    alpha_seed = torch.broadcast_to(alpha_seed, (n,))

    bt = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n,)).clone()
    bi = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    bb = torch.zeros(n, dtype=torch.bool, device=dev)
    anyh = torch.zeros(n, dtype=torch.bool, device=dev)
    atten = torch.ones((n, 3), dtype=torch.float32, device=dev)

    chunk = min(BRUTE_CHUNK, n_tris)
    lanes = max(1, PLAIN_BUDGET // chunk)
    for l0 in range(0, n, lanes):
        sl = slice(l0, min(n, l0 + lanes))
        oi, di = o[sl], d[sl]
        ox, oy, oz = (oi[:, k : k + 1] for k in range(3))
        dx, dy, dz = (di[:, k : k + 1] for k in range(3))
        for c0 in range(0, n_tris, chunk):
            cs = slice(c0, min(n_tris, c0 + chunk))
            det, uu, vv, t = _brute.mt_test(
                ox, oy, oz, dx, dy, dz, *(a[None, cs, k] for a in (p0, e1, e2) for k in range(3)))
            cur = bt[sl]
            valid = ((det.abs() >= _brute.EPS_DET) & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0)
                     & (uu + vv <= 1.0) & (t > t_min) & (t < cur[:, None]))
            tri_ids = torch.arange(c0, cs.stop, dtype=torch.int32, device=dev)[None, :]
            alpha_ok, transparent, factor = blocktrace.hit_gates(
                scene, meta, uu, vv, tri_ids, di[:, None, :], nee, alpha_seed[sl, None])
            valid = valid & alpha_ok
            if nee and meta.any_transparent:
                factor = torch.where((valid & transparent)[..., None], factor, 1.0)
                atten[sl] = atten[sl] * torch.prod(factor, dim=1)
                valid = valid & ~transparent
            j = torch.argmin(torch.where(valid, t, F32_MAX), dim=1, keepdim=True)
            got = valid.any(dim=1)
            take = lambda a: a.gather(1, j)[:, 0]
            t2 = torch.where(got, take(t), cur)
            upd = got & (t2 < cur)
            bt[sl] = torch.where(upd, t2, cur)
            bi[sl] = torch.where(upd, (j[:, 0] + c0).to(torch.int32), bi[sl])
            bu[sl] = torch.where(upd, take(uu), bu[sl])
            bv[sl] = torch.where(upd, take(vv), bv[sl])
            bb[sl] = torch.where(upd, take(det) < 0.0, bb[sl])
            anyh[sl] = anyh[sl] | got
    return Hit(bt, bi, bu, bv, bb, atten, anyh)


def intersect(scene: CompiledScene, meta: SceneMeta, o, d, t_max, t_min: float = 1e-3,
              nee: bool = False, alpha_seed=None) -> Hit:
    """Dispatch (yart_tpu/render/intersect.py:981-1011); `alpha_seed` [N]
    (u32 values in int64) keys the stochastic alpha test of gated scenes."""
    check_supported(meta)
    gates = has_gates(meta, nee)
    if meta.n_tris <= _brute.MAX_TRIS and not meta.n_instances:
        if gates:
            return _gated_brute(scene, meta, o, d, t_max, t_min, nee, alpha_seed)
        return _hit(*_brute.brute_intersect(scene.tri_pack, o, d, t_max, meta.n_tris, t_min))
    if not meta.n_instances and meta.n_clusters > blocktrace.MAX_CLUSTERS:
        return bintrace.intersect_bintrace(scene, meta, o, d, t_max, t_min, nee)
    if gates:
        return blocktrace.intersect_blocktrace_gated(scene, meta, o, d, t_max, t_min, nee, alpha_seed)
    t, u, v, back, tri, _, _ = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, t_min, nee)
    return _hit(t, u, v, back, tri)
