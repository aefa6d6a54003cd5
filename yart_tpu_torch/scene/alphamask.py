"""Conservative per-triangle barycentric alpha masks.

The port's own copy of `yart_tpu/scene/alphamask.py` (numpy only; the port
imports nothing of the JAX package). Per alpha-tested triangle it bakes an
8x8 bitmask over the barycentric domain: bit (iu, iv) = 0 iff the alpha
channel is identically zero over every texture sample reachable from cell
[iu/8, (iu+1)/8) x [iv/8, (iv+1)/8), conservatively over the cell's uv
bounding box, repeat-wrap aware, including the bilinear 2x2 support and the
sampler's base-texel clamp (render/texture.py `sample_stack`).

Exactness: bilinear alpha == 0 at a hit makes the gate's accept test
`u_a < alpha` false for every draw u_a in [0, 1), so a masked-out hit would
always have passed through. Culling it inside the fused trace (B3's `amask`
mode, kernels/fusedtrace.py) therefore leaves the gated result
bit-identical (render/blocktrace.py `intersect_blocktrace_gated`).

Mask words ride in pack row 5 (lanes [0:C] = bits 0..31, lanes [C:2C] =
bits 32..63, bit-cast int32 -> float32). Triangles without alpha testing
get all-ones masks; pack padding lanes stay zero.
"""

from __future__ import annotations

from typing import List

import numpy as np

GRID = 8  # cells per barycentric axis; 64 bits = 2 packed u32 words


def _integral(nz: np.ndarray) -> np.ndarray:
    """2D inclusive prefix-sum with a zero top/left border: S[i+1, j+1] =
    count of nz in [0..i, 0..j]."""
    s = np.zeros((nz.shape[0] + 1, nz.shape[1] + 1), np.int64)
    s[1:, 1:] = np.cumsum(np.cumsum(nz.astype(np.int64), axis=0), axis=1)
    return s


def _axis_segments(lo: np.ndarray, hi: np.ndarray, size: int):
    """Vectorized texel index segments touched by continuous spans
    [lo, hi] in uv units, repeat-wrapped, for the sampler's mapping
    U = frac(u)*(size-1) with bilinear texels {clamp(floor(U), 0,
    size-2), +1}.

    The bake uses exact float64 span endpoints but the kernels/gate
    interpolate uv in f32, so a hit uv can land a few ulps outside the
    exact span. Two safe-direction allowances cover that: each index range is widened by one texel downward (upward is
    already covered by the bilinear +1), and when an endpoint sits
    within `err` of a PERIOD boundary an explicit wrap segment admits
    the opposite edge's texels (f32 rounding across the boundary flips
    frac() to the other end — e.g. uv rounding up to exactly 1.0 samples
    texel 0). Expanding lo/hi in uv space instead would wrap EVERY
    cell touching uv==0 onto the far texel column and gut the cull.

    Returns a list of (a, b, use) inclusive index ranges with validity
    masks."""
    bad = ~np.isfinite(lo) | ~np.isfinite(hi)
    full = bad | (hi - lo >= 1.0)
    lo = np.where(bad, 0.0, lo)
    hi = np.where(bad, 0.0, hi)
    f0 = lo - np.floor(lo)
    f1 = hi - np.floor(hi)
    scale = size - 1
    err = np.maximum(np.abs(lo), np.abs(hi)) * 4e-6 + 1e-6

    def rng(a, b):
        # -1: one-texel slack for f32 rounding of the interpolated uv;
        # +1: bilinear upper texel (upward slack rides on it).
        x0 = np.clip(np.floor(a * scale).astype(np.int64) - 1, 0, size - 1)
        x1 = np.clip(
            np.floor(b * scale).astype(np.int64) + 1, 0, size - 1
        )
        return x0, x1

    one = f1 >= f0
    a0, b0 = rng(f0, np.where(one, f1, 1.0))
    a1, b1 = rng(np.zeros_like(f1), f1)
    a0 = np.where(full, 0, a0)
    b0 = np.where(full, size - 1, b0)
    always = np.ones_like(full)
    segs = [(a0, b0, always), (a1, b1, ~one & ~full)]
    # Cross-period f32 slack: endpoint within err of an integer.
    zero_i = np.zeros_like(a0)
    last = np.full_like(a0, size - 1)
    wrap_hi = ((1.0 - f1) <= err) & ~full  # frac -> 0: texels [0, 1]
    segs.append((zero_i, np.minimum(zero_i + 1, last), wrap_hi))
    # frac -> ~1: texels [size-2, size-1]. Only boundaries >= 1 can be
    # crossed downward: the gate's uv is a sum of products of NONNEGATIVE
    # f32 values (barycentric weights x corner uvs), which cannot round
    # below 0 — so cells sitting exactly at uv == 0 (every atlas edge)
    # keep their tight footprint and the cull stays effective there.
    wrap_lo = (f0 <= err) & (np.floor(lo) >= 1.0) & ~full
    segs.append((np.maximum(last - 1, zero_i), last, wrap_lo))
    return segs


def bake_tri_masks(uv: np.ndarray, tri_mat: np.ndarray,
                   mat_has_alpha: np.ndarray, mat_tex: np.ndarray,
                   textures_rgba: List[np.ndarray]) -> np.ndarray:
    """Masks for triangles in pack order (vectorized — flagship foliage
    runs to ~100k alpha triangles x 64 cells, far too many for a Python
    cell loop).

    uv [n, 3, 2] per-corner texture coordinates (corner 0 = barycentric
    w, 1 = u, 2 = v — matching the traversal's u/v and _hit_gates'
    `w*uv0 + u*uv1 + v*uv2`); tri_mat [n] material ids; mat_has_alpha /
    mat_tex per material; textures_rgba the builder's original [H, W, 4]
    arrays (alpha channel as stored). Returns [n, 2] uint32 words.
    """
    n = uv.shape[0]
    out = np.full((n, 2), 0xFFFFFFFF, np.uint32)
    if n == 0 or len(textures_rgba) == 0:
        return out
    mat_has_alpha = np.asarray(mat_has_alpha, bool)
    mat_tex = np.asarray(mat_tex, np.int64)
    alpha_tri = mat_has_alpha[tri_mat] & (mat_tex[tri_mat] >= 0)
    if not alpha_tri.any():
        return out

    # Barycentric cell-corner uvs for all cells at once.
    g = (np.arange(GRID + 1) / GRID).astype(np.float64)
    gu, gv = np.meshgrid(g, g, indexing="ij")  # [G+1, G+1]
    wb = 1.0 - gu - gv

    tri_tex = mat_tex[tri_mat]
    for ti in np.unique(tri_tex[alpha_tri]):
        a = np.asarray(textures_rgba[int(ti)])
        nz = a[..., 3] != 0 if a.shape[-1] >= 4 else np.ones(
            a.shape[:2], bool
        )
        s = _integral(nz)
        h, w = nz.shape
        sel = np.nonzero(alpha_tri & (tri_tex == ti))[0]
        uv0 = uv[sel, 0].astype(np.float64)  # [m, 2]
        uv1 = uv[sel, 1].astype(np.float64)
        uv2 = uv[sel, 2].astype(np.float64)
        # [m, G+1, G+1, 2] corner uvs
        cu = (
            wb[None, :, :, None] * uv0[:, None, None, :]
            + gu[None, :, :, None] * uv1[:, None, None, :]
            + gv[None, :, :, None] * uv2[:, None, None, :]
        )
        # Per-cell bbox over its 2x2 corner window: [m, G, G, 2]
        c00 = cu[:, :-1, :-1]
        c10 = cu[:, 1:, :-1]
        c01 = cu[:, :-1, 1:]
        c11 = cu[:, 1:, 1:]
        lo = np.minimum(np.minimum(c00, c10), np.minimum(c01, c11))
        hi = np.maximum(np.maximum(c00, c10), np.maximum(c01, c11))
        row_segs = _axis_segments(lo[..., 1], hi[..., 1], h)
        col_segs = _axis_segments(lo[..., 0], hi[..., 0], w)

        def box_any(r0, r1, c0, c1):
            return (
                s[r1 + 1, c1 + 1] - s[r0, c1 + 1] - s[r1 + 1, c0]
                + s[r0, c0]
            ) > 0

        any_nz = np.zeros(lo.shape[:-1], bool)
        for r0, r1, ru in row_segs:
            for c0, c1, cu in col_segs:
                any_nz |= ru & cu & box_any(r0, r1, c0, c1)

        # Pack [m, G, G] -> two u32 words (bit index iu*GRID + iv).
        bits = any_nz.reshape(len(sel), GRID * GRID).astype(np.uint64)
        shifts = np.arange(GRID * GRID, dtype=np.uint64)
        packed = (bits << shifts[None, :]).sum(axis=1, dtype=np.uint64)
        out[sel, 0] = (packed & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        out[sel, 1] = (packed >> np.uint64(32)).astype(np.uint32)
    return out


def write_mask_rows(pack: np.ndarray, masks: np.ndarray, first, count,
                    c: int) -> None:
    """Scatter [n, 2] u32 mask words into pack row 5 (lanes [0:C] = word
    0, [C:2C] = word 1, bitcast f32) per cluster, in place."""
    mf = masks.view(np.float32)  # [n, 2]
    for ci in range(pack.shape[0]):
        f, cnt = int(first[ci]), int(count[ci])
        pack[ci, 5, 0:cnt] = mf[f : f + cnt, 0]
        pack[ci, 5, c : c + cnt] = mf[f : f + cnt, 1]
