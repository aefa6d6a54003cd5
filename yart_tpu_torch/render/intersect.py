"""Wavefront ray-scene intersection.

Port of `yart_tpu/render/intersect.py` `intersect_brute`, the
per-instance loop `_intersect_instanced` (:872-935) and the dispatcher
`intersect` (:937-1025), with the TPU's choices on every device (`Hit`
and `coherence_key` are in render/hit.py). "Gates" are the
per-hit tests a hit must pass: the stochastic alpha test
(`meta.any_alpha`) and, for shadow rays, transparent surfaces
(`nee and meta.any_transparent`). The dispatcher:

- an instanced scene of at most 8192 instance clusters takes the block
  trace (`render/blocktrace.py`: B2, then B3 in its instanced mode; the
  gated re-cast loop where gated), whatever its size (:954-976); any other
  instanced scene the per-instance loop, which traverses each instance's
  prototype by this dispatcher;
- otherwise at most 4096 triangles take B1 (`kernels/brute.py`) or, with
  gates, `intersect_brute` with gates (plain PyTorch on every device: XLA
  in the JAX package, no kernel);
- more triangles, up to the block trace's cap of 8192 clusters, the
  block trace (B2 and B3; the gated re-cast loop `intersect_blocktrace_gated` with
  gates, B3 in `amask` mode where the scene has alpha);
- past the cap, without gates, bin-trace (`render/bintrace.py`, B4); with
  gates the stack traversals (`render/stacktrace.py`, plain PyTorch, XLA
  in the JAX package): `intersect_bvh_sorted` for 131,072 rays or more,
  `intersect_bvh8` below.

CUDA tensors run the Hopper kernels, CPU tensors their plain twins. Shadow
rays of ungated scenes are closest-hit queries for B1 and any-hit queries
for the traversals, exactly as in the JAX package. No scene that the JAX
package can intersect is refused.
"""

from __future__ import annotations

import torch

from yart_tpu_torch.kernels import brute as _brute
from yart_tpu_torch.render import bintrace, blocktrace, stacktrace
from yart_tpu_torch.render.hit import Hit
from yart_tpu_torch.scene.types import CompiledScene, SceneMeta

F32_MAX = 3.0e38
BRUTE_CHUNK = 256  # triangles per step of the gated brute (the JAX scan's chunk)
PLAIN_BUDGET = 1 << 20  # rays x triangles per gated-brute step
SORTED_MIN_RAYS = 131072  # gated rays past the cluster cap that take the coherence sort
INSTANCED_RANGE = "intersect.instanced"  # the per-instance loop's profiler range


def _hit(t, u, v, back, tri) -> Hit:
    return Hit(t, tri, u, v, back, torch.ones((t.shape[0], 3), dtype=torch.float32, device=t.device),
               tri >= 0)


def has_gates(meta: SceneMeta, nee: bool) -> bool:
    return bool(meta.any_alpha or (nee and meta.any_transparent))


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


def intersect_instanced(scene, meta: SceneMeta, o, d, t_max, t_min: float = 1e-3, nee: bool = False,
                        alpha_seed=None) -> Hit:
    """Closest hit (or NEE any-hit) over the instances, one at a time
    (`_intersect_instanced`; the reference's testNode, ray-integrator.cpp:
    20-54): a static loop in which each instance's prototype is traversed by
    `intersect` (whatever path its size and gates select) on rays mapped by
    the instance's unnormalised inverse 3x4 (`inst_rows[i, 0:12]`), so t
    stays the world parameter. A closer hit replaces the best (strictly:
    the earlier instance keeps a tie), its triangle lifted to the
    instance's virtual range (`inst_tri_base`), and the best t bounds every
    later instance's traversal. Shadow rays keep `t_max` per instance, OR
    the masks and multiply the attenuations. Runs inside the profiler range
    INSTANCED_RANGE (read by profile_render)."""
    n, dev = o.shape[0], o.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n,)).contiguous()
    best = Hit(t_max, torch.full((n,), -1, dtype=torch.int32, device=dev),
               torch.zeros(n, dtype=torch.float32, device=dev), torch.zeros(n, dtype=torch.float32, device=dev),
               torch.zeros(n, dtype=torch.bool, device=dev), torch.ones((n, 3), dtype=torch.float32, device=dev),
               torch.zeros(n, dtype=torch.bool, device=dev))
    with torch.profiler.record_function(INSTANCED_RANGE):
        for i, p in enumerate(meta.inst_proto):
            rm = scene.inst_rows[i, 0:12].reshape(3, 4)  # row k: object coordinate k
            o_l = o[:, 0:1] * rm[:, 0] + o[:, 1:2] * rm[:, 1] + o[:, 2:3] * rm[:, 2] + rm[:, 3]
            d_l = d[:, 0:1] * rm[:, 0] + d[:, 1:2] * rm[:, 1] + d[:, 2:3] * rm[:, 2]
            h = intersect(scene.protos[p], meta.proto_metas[p], o_l, d_l, t_max if nee else best.t,
                          t_min=t_min, nee=nee, alpha_seed=alpha_seed)
            if nee:
                best = best._replace(attenuation=best.attenuation * h.attenuation, mask=best.mask | h.mask)
                continue
            better = h.mask & (h.t < best.t)
            best = Hit(torch.where(better, h.t, best.t),
                       torch.where(better, h.tri + scene.inst_tri_base[i], best.tri),
                       torch.where(better, h.u, best.u), torch.where(better, h.v, best.v),
                       torch.where(better, h.back_side, best.back_side), best.attenuation, best.mask | better)
    return best


def intersect(scene: CompiledScene, meta: SceneMeta, o, d, t_max, t_min: float = 1e-3,
              nee: bool = False, alpha_seed=None) -> Hit:
    """Dispatch (yart_tpu/render/intersect.py:937-1025, the module
    docstring has the rules; the JAX `use_bvh` override is left out, as no
    caller sets it); `alpha_seed` [N] (u32 values in int64) keys the
    stochastic alpha test of gated scenes."""
    gates = has_gates(meta, nee)
    if meta.n_instances:
        if 0 < meta.n_inst_clusters <= blocktrace.MAX_CLUSTERS:
            return _blocktrace(scene, meta, o, d, t_max, t_min, nee, gates, alpha_seed)
        return intersect_instanced(scene, meta, o, d, t_max, t_min, nee, alpha_seed)
    if meta.n_tris <= _brute.MAX_TRIS:
        if gates:
            return _gated_brute(scene, meta, o, d, t_max, t_min, nee, alpha_seed)
        return _hit(*_brute.brute_intersect(scene.tri_pack, o, d, t_max, meta.n_tris, t_min))
    if meta.n_clusters <= blocktrace.MAX_CLUSTERS:
        return _blocktrace(scene, meta, o, d, t_max, t_min, nee, gates, alpha_seed)
    if not gates:
        return bintrace.intersect_bintrace(scene, meta, o, d, t_max, t_min, nee)
    if o.shape[0] >= SORTED_MIN_RAYS:
        return stacktrace.intersect_bvh_sorted(scene, meta, o, d, t_max, t_min, nee, alpha_seed)
    return stacktrace.intersect_bvh8(scene, meta, o, d, t_max, t_min, nee, alpha_seed)


def _blocktrace(scene, meta, o, d, t_max, t_min, nee, gates, alpha_seed) -> Hit:
    if gates:
        return blocktrace.intersect_blocktrace_gated(scene, meta, o, d, t_max, t_min, nee, alpha_seed)
    t, u, v, back, tri, _, _ = blocktrace.intersect_blocktrace(scene, meta, o, d, t_max, t_min, nee)
    return _hit(t, u, v, back, tri)
