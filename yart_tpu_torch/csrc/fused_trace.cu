// Fused block-trace closest hit for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel yart_tpu/kernels/pallas_fusedtrace.py
// `fused_trace_pallas` (its pallas_call at :1128) in its closest-hit,
// any-hit (`nee`), alpha-mask (`amask`) and instanced modes and their
// combinations. It computes what that kernel computes, not how; the
// specification is the module docstring of
// yart_tpu_torch/kernels/fusedtrace.py, and `fused_trace_plain` there is
// the twin it equals bitwise in all 8 output columns.
//
// Per ray (row of the presorted ray matrix: o3, d3, t_cur, floor):
// - visit order: the (up to) 4 nearest clusters of its presort slots
//   (kernel B2), nearest first, then every other cluster in ascending id;
// - a cluster is tested when the ray enters its box (B2's slab test and
//   margins, `enters`) and its entry is <= the ray's best t at that moment;
// - a test runs `_t_only`'s plane test over the cluster's real triangles:
//   t = (cn - n.o) / n.d, u = eu.o + t (eu.d) - cu, v likewise, dot products
//   x + y + z; valid when |n.d| >= 1e-12, 0 <= u <= 1, v >= 0, u + v <= 1,
//   t > t_min, t > floor, and (t, tri) is lexicographically below the
//   carried best (ties at bit-equal t go to the lowest triangle index);
// - with `amask` a candidate is valid only if bit (iu, iv) of its
//   triangle's 8x8 alpha mask (pack row 5) is set, and the mask tests
//   counted are those of the candidates that pass the geometric tests and
//   beat the carried best and every accepted column before them;
// - with `nee` the ray stops after the first cluster that gives it a hit;
// - instanced (`clus_src` non-null): traversal cluster `cid` is one
//   (instance, prototype cluster) pair with a world box; its triangles are
//   pack row clus_src[cid], tested with the ray mapped by the instance's
//   unnormalised inverse 3x4 r = inst_flat[clus_inst[cid] * 12 ..]:
//   o'_a = ((o0 r[4a] + o1 r[4a+1]) + o2 r[4a+2]) + r[4a+3], d'_a likewise
//   without the translation; tri = clus_fid[cid] + column.
// Output row: t, u, v, back, tri bits (-1 = miss, t = t_cur), clusters
// tested, triangles tested, alpha-mask tests run (0 without `amask`).
//
// What bounds it on this card. A design with one thread a ray, each ray
// walking every cluster alone, is bound by its own waste: each ray
// slab-tests all n_clus boxes (the sweep B2 has just run, ~60
// instructions a test with the NaN-propagating min/max) and tests each
// entered cluster's <= C triangles in series with 12 scalar global loads
// a column, the warp running the union of its 32 rays' visits. Measured
// on an H100 (python -m yart_tpu_torch.compare_b3, PERF.md §6): on
// atrium-ivy's 2^20 camera rays (`amask` cast 0) that design took 9.4 ms,
// 6.5 of them in the sweep alone (the same kernel without its cluster
// tests); on atrium-inst's, 4.8 of 5.7 ms; on atrium-ivy rays that leave
// their hits in random directions, 16.3 ms. This design takes 2.2, 0.8
// and 4.9 ms there. What is left is the plane tests, whose divides and
// unfused multiply-adds the bitwise contract keeps (about 1.6 ms of cast
// 0), and, for random rays, the walk's per-cluster barriers, which few
// rays share. The work the inputs need (every plane, mask and entry test
// the twin's columns count, and one box test per block and box) is far
// smaller and compute-bound: it is the kernels line's `bound_ms`.
//
// Design: one 128-thread block per 128-ray presort block; the block walks
// the visit order in lockstep, and the tests of a cluster are shared by
// the block.
// 1. Per-block box cull. The block's live rays (t_cur > t_min, finite
//    1/d and o/d, a floor that is a number: every other ray provably enters
//    nothing) form a bundle: per axis the box of their origins, the
//    interval of their 1/d and the largest |1/d| and |o/d|. Each tile of
//    128 boxes is first tested once per box against the bundle, with
//    directed rounding (__fmul_rd / __fmul_ru, __fsub_rd / __fsub_ru):
//    x = b (1/d) - o/d of any bundle ray lies within (b - o) (1/d), the
//    interval product, widened by 2^-23 (|b| max|1/d| + max|o/d|) + 2^-126,
//    which covers both roundings of x; the entry margins are taken twice
//    as wide as B2's (2e-6 relative, 2e-7 absolute), which covers theirs.
//    A box is dropped only when the bounds prove that no bundle ray enters
//    it at the tile's largest best t, so the kept set is a superset of
//    what the rays' own tests enter: a NaN anywhere in the bounds keeps
//    the box. Column 5 equal to the twin's is the proof on the card.
// 2. Per ray, the exact `enters` (unchanged, NaN rules and all) runs only
//    on the kept boxes, with the tile's starting best t; a box that some
//    ray enters becomes a candidate, and each ray remembers its own bits.
//    Random rays defeat the block's cull, so a ray first tests the union
//    box of each 8 kept boxes: its x are monotone in the box coordinate,
//    so a member's entry is >= the union's and its exit <=, and the
//    union's margins are bounded as in point 1. When few rays of a warp
//    pass a union box, the warp's lanes take the (passing ray, box) pairs,
//    8 lanes a ray, instead of running every member's test in lockstep
//    with the one lane that needs it; when many pass, each tests its own.
//    The walk then takes the candidates in ascending id, and a ray whose
//    best t fell since then repeats its test: that is the twin's rule at
//    the moment of the visit. Phase A (the slots) first gathers each
//    step's distinct slot clusters in ascending id, loading each box once
//    into shared memory, and walks them the same way.
// 3. When at least one ray enters the walk's current cluster (a block-wide
//    count), the block has already copied its pack rows 0-3 (and row 5's
//    2C mask words with `amask`) into shared memory with 16-byte cp.async
//    copies (4-byte ones when C is not a multiple of 4). The copies are
//    double-buffered: the next candidate's copy is issued before this
//    one's tests, so its latency hides behind them.
// 4. The (entering ray, column) pairs are spread over the block: either a
//    warp takes one entering ray at a time and its lanes the columns, with
//    the lexicographic (t, column) minimum reduced by warp shuffles, then
//    compared with the carried best under the tie rule, and the `amask`
//    count from a warp prefix-min over the columns (the twin's cummin,
//    kernels/fusedtrace.py); or, when many rays enter, a thread takes one
//    entering ray and runs its columns in series, the parent's carry. The
//    block picks by the instruction slots each needs: ceil(m / 32) warps x cnt
//    steps for the second, m rays x (ceil(cnt / 32) steps + 1 for the
//    reduction, 2 steps a round with `amask` for the scan) for the first.
//    The entering ray's o and d come from shared memory, mapped by the
//    instance's 3x4 in the instanced mode by the ray's own thread.
// 5. Dead rays (blive 0, t_cur <= t_min, non-finite 1/d or o/d, a NaN
//    floor) take part in no bundle, vote or test and write the miss row;
//    with `nee` a block whose live rays have all stopped leaves the walk.
// Built with --fmad=false and without fast math, the kernel repeats the
// plain twin's float operations one by one and visits the same clusters
// in the same order per ray, so the two agree bitwise.
//
// ptxas (sm_90a, --fmad=false): 96 registers, 12 bytes of spill stores and
// loads (chip_smoke.py prints them in its kernels line); the bundle sits in
// shared memory, not in registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;  // boxes per tile of the ascending walk: one a thread in the cull
constexpr int kGroup = 8;  // kept boxes per union box of a ray's own cull
constexpr int kPairMax = 16;  // most rays of a warp passing a union box for its (ray, box) pairs
constexpr int kIdMask = (1 << 13) - 1;
constexpr int kKeyDead = 0x7fffffff;
constexpr int kSlots = 4;
constexpr int kNone = 0x7fffffff;
constexpr float kEpsDet = 1e-12f;
constexpr float kInf = __builtin_huge_valf();

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}

struct Ray {
  float o[3], d[3], ia[3], oia[3];
  float t0, floor_t;
};

struct Best {
  float t, u, v;
  int back, tri, n_clus, n_tris, n_mask;
};

// Entry test of one box (lo.xyz, hi.xyz) with the presort's margins; true
// when the ray enters it and the entry does not exceed the current best t.
__device__ __forceinline__ bool enters(const Ray& r, const float* box, int stride, float t_min,
                                       float t_best) {
  float ent = 0.f, ext = 0.f;
  for (int a = 0; a < 3; ++a) {
    const float x0 = box[a * stride] * r.ia[a] - r.oia[a];
    const float x1 = box[(a + 3) * stride] * r.ia[a] - r.oia[a];
    const float a0 = nan_min(x0, x1);
    const float a1 = nan_max(x0, x1);
    ent = a == 0 ? a0 : nan_max(ent, a0);
    ext = a == 0 ? a1 : nan_min(ext, a1);
  }
  const float e = nan_max(ent - (fabsf(ent) * 1e-6f + 1e-7f), t_min);
  const float xt = ext + (fabsf(ext) * 1e-6f + 1e-7f);
  return xt >= e && e < r.t0 && xt > r.floor_t && e <= t_best;
}

// The block's bundle of live rays (see the note, design point 1).
struct Bundle {
  float o_lo[3], o_hi[3], ia_lo[3], ia_hi[3], ia_abs[3], oia_abs[3];
  float t0_max, floor_min;
};
constexpr int kBundle = 20;  // floats of a Bundle
__device__ __forceinline__ bool bundle_min(int q) { return q < 3 || (q >= 6 && q < 9) || q == 19; }

// Bounds [lo, hi] of x = fl(fl(b * ia) - oia) over every ray of the bundle.
__device__ __forceinline__ void slab_bounds(float b, const Bundle& B, int a, float& lo, float& hi) {
  const float d_lo = __fsub_rd(b, B.o_hi[a]), d_hi = __fsub_ru(b, B.o_lo[a]);
  const float p_lo = nan_min(nan_min(__fmul_rd(d_lo, B.ia_lo[a]), __fmul_rd(d_lo, B.ia_hi[a])),
                             nan_min(__fmul_rd(d_hi, B.ia_lo[a]), __fmul_rd(d_hi, B.ia_hi[a])));
  const float p_hi = nan_max(nan_max(__fmul_ru(d_lo, B.ia_lo[a]), __fmul_ru(d_lo, B.ia_hi[a])),
                             nan_max(__fmul_ru(d_hi, B.ia_lo[a]), __fmul_ru(d_hi, B.ia_hi[a])));
  const float err =
      __fadd_ru(__fmul_ru(__fadd_ru(__fmul_ru(fabsf(b), B.ia_abs[a]), B.oia_abs[a]), 0x1p-23f), 0x1p-126f);
  lo = __fsub_rd(p_lo, err);
  hi = __fadd_ru(p_hi, err);
}

// False only when no bundle ray with best t <= tb_max enters the box.
__device__ __forceinline__ bool may_enter(const float* box, int stride, const Bundle& B, float t_min,
                                          float tb_max) {
  float ent = 0.f, ext = 0.f;
  for (int a = 0; a < 3; ++a) {
    float lo0, hi0, lo1, hi1;
    slab_bounds(box[a * stride], B, a, lo0, hi0);
    slab_bounds(box[(a + 3) * stride], B, a, lo1, hi1);
    const float a0 = nan_min(lo0, lo1);  // <= min(x0, x1)
    const float a1 = nan_max(hi0, hi1);  // >= max(x0, x1)
    ent = a == 0 ? a0 : nan_max(ent, a0);
    ext = a == 0 ? a1 : nan_min(ext, a1);
  }
  const float e = nan_max(__fsub_rd(ent, __fadd_ru(__fmul_ru(fabsf(ent), 2e-6f), 2e-7f)), t_min);
  const float xt = __fadd_ru(ext, __fadd_ru(__fmul_ru(fabsf(ext), 2e-6f), 2e-7f));
  return !(xt < e || e >= B.t0_max || xt <= B.floor_min || e > tb_max);
}

// One ray against the union box of a group of boxes: false only when the
// ray enters no box of the group. Its x = fl(fl(b / d) - o / d) are
// monotone in b, so a member's entry is >= the union's and its exit <=;
// the margins are bounded as in may_enter, and a NaN keeps the group.
__device__ __forceinline__ bool group_may_enter(const Ray& r, const float* box, int stride, float t_min,
                                                float t_best) {
  float ent = 0.f, ext = 0.f;
  for (int a = 0; a < 3; ++a) {
    const float x0 = box[a * stride] * r.ia[a] - r.oia[a];
    const float x1 = box[(a + 3) * stride] * r.ia[a] - r.oia[a];
    ent = a == 0 ? nan_min(x0, x1) : nan_max(ent, nan_min(x0, x1));
    ext = a == 0 ? nan_max(x0, x1) : nan_min(ext, nan_max(x0, x1));
  }
  const float e = nan_max(__fsub_rd(ent, __fadd_ru(__fmul_ru(fabsf(ent), 2e-6f), 2e-7f)), t_min);
  const float xt = __fadd_ru(ext, __fadd_ru(__fmul_ru(fabsf(ext), 2e-6f), 2e-7f));
  return !(xt < e || e >= r.t0 || xt <= r.floor_t || e > t_best);
}

// The alpha-mask cull (`_amask_valid`, pallas_cluster.py:38-58): bit
// (iu, iv) of the triangle's 8x8 barycentric mask, the words staged from
// pack row 5 (w[col] = bits 0..31, w[c + col] = bits 32..63). A 0 bit means
// the alpha texture is identically zero over that cell. Called only on
// candidates that passed the geometric tests, so u and v are finite; the
// clamps still mirror the twin's.
__device__ __forceinline__ bool amask_bit(const float* w, int c, int col, float u, float v) {
  const int iu = (int)fminf(fmaxf(u * 8.f, 0.f), 7.f);
  const int iv = (int)fminf(fmaxf(v * 8.f, 0.f), 7.f);
  const int bit = min(max(iu * 8 + iv, 0), 63);
  const unsigned word = (unsigned)__float_as_int(w[bit < 32 ? col : c + col]);
  return ((word >> (bit & 31)) & 1u) != 0u;
}

// The scene's cluster tables; the instanced ones are null for a scene
// without instances.
struct Clusters {
  const float* __restrict__ pack;
  const int32_t* __restrict__ count;
  int c;
  const int32_t* __restrict__ src;
  const int32_t* __restrict__ inst;
  const int32_t* __restrict__ fid;
  const float* __restrict__ inst_flat;
};

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's share of the copy of pack row `src`'s rows 0-3 (12C floats)
// and, with `amask`, row 5's 2C mask words, into `s`. Each thread copies the
// same chunks of every buffer, so its own cp.async.wait_group orders its
// copies into one buffer.
__device__ __forceinline__ void stage(const Clusters& k, int src, float* s, int amask, int vec16) {
  const float* g = k.pack + (size_t)src * 24 * k.c;
  const int rows = 12 * k.c;
  if (vec16) {
    for (int q = threadIdx.x; q < rows / 4; q += kThreads)
      cp_async16(reinterpret_cast<float4*>(s) + q, reinterpret_cast<const float4*>(g) + q);
    if (amask)
      for (int q = threadIdx.x; q < k.c / 2; q += kThreads)
        cp_async16(reinterpret_cast<float4*>(s + rows) + q, reinterpret_cast<const float4*>(g + 15 * k.c) + q);
  } else {
    for (int q = threadIdx.x; q < rows; q += kThreads) cp_async4(s + q, g + q);
    if (amask)
      for (int q = threadIdx.x; q < 2 * k.c; q += kThreads) cp_async4(s + rows + q, g + 15 * k.c + q);
  }
}

// The per-block state in shared memory.
struct Shared {
  float box[6][kTile];         // the tile's boxes, or phase A's slot boxes
  int list_cid[kTile];         // the walk: cluster ids in visit order
  int list_box[kTile];         //   and each one's column of `box`
  int list_kept[kTile];        //   and (phase B) its index among the kept boxes
  int kept[kTile];             // phase B: the kept boxes' columns, ascending
  float gbox[6][kTile / kGroup];  // phase B: the union box of each kGroup kept boxes
  unsigned rbits[kTile / 32][kThreads];  // per ray: the kept boxes it may enter
  unsigned kmask[kTile / 32];  // the cull's kept boxes
  unsigned cmask[kTile / 32];  // the candidates: kept boxes some ray enters
  int smin[3];                 // phase A: the step's next slot cluster
  int wcount[2][kWarps];       // per warp: rays entering the walk's cluster
  int wact[2][kWarps];         // per warp: rays still walking
  float wred[kWarps][kBundle];  // per warp reductions
  Bundle bundle;
  // One row per entering ray ("slot"): the ray as tested, its carried best
  // and, after the test, its new best and mask tests.
  float ro[3][kThreads], rd[3][kThreads], cur_t[kThreads], fl[kThreads];
  int cur_i[kThreads];
  float res_t[kThreads], res_u[kThreads], res_v[kThreads];
  int res_tri[kThreads], res_back[kThreads], res_nmask[kThreads];
};

// The block's tests of one staged cluster (pack rows at `p`, mask words at
// `w`) for its m entering rays in slots 0..m-1; writes each slot's result
// (res_tri = kNone: no better hit).
__device__ __forceinline__ void test_cluster(Shared& sh, const float* __restrict__ p,
                                             const float* __restrict__ w, int c, int m, int cnt,
                                             int first, float t_min, int amask) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wd = 3 * c;
  const int rounds = (cnt + 31) / 32;
  const bool by_rays = ((m + 31) / 32) * cnt <= m * (rounds * (amask ? 2 : 1) + 1);
  if (by_rays) {
    // A thread per entering ray, the columns in series: the parent's carry.
    if (tid >= m) return;
    const float o0 = sh.ro[0][tid], o1 = sh.ro[1][tid], o2 = sh.ro[2][tid];
    const float d0 = sh.rd[0][tid], d1 = sh.rd[1][tid], d2 = sh.rd[2][tid];
    const float floor_t = sh.fl[tid];
    float bt = sh.cur_t[tid], bu = 0.f, bv = 0.f;
    int bi = sh.cur_i[tid], bb = 0, nm = 0;
    bool better = false;
    for (int col = 0; col < cnt; ++col) {
      const float nx = p[col], ny = p[wd + col], nz = p[2 * wd + col];
      const float ux = p[c + col], uy = p[wd + c + col], uz = p[2 * wd + c + col];
      const float vx = p[2 * c + col], vy = p[wd + 2 * c + col], vz = p[2 * wd + 2 * c + col];
      const float cn = p[3 * wd + col], cu = p[3 * wd + c + col], cv = p[3 * wd + 2 * c + col];
      const float no = o0 * nx + o1 * ny + o2 * nz;
      const float uo = o0 * ux + o1 * uy + o2 * uz;
      const float vo = o0 * vx + o1 * vy + o2 * vz;
      const float nd = d0 * nx + d1 * ny + d2 * nz;
      const float ud = d0 * ux + d1 * uy + d2 * uz;
      const float vd = d0 * vx + d1 * vy + d2 * vz;
      const float t = (cn - no) / nd;
      const float u = uo + t * ud - cu;
      const float v = vo + t * vd - cv;
      const int tri = first + col;
      if (fabsf(nd) >= kEpsDet && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f && t > t_min &&
          t > floor_t && (t < bt || (t == bt && bi >= 0 && tri < bi))) {
        if (amask) {
          nm += 1;
          if (!amask_bit(w, c, col, u, v)) continue;
        }
        bt = t;
        bu = u;
        bv = v;
        bb = nd > 0.f;
        bi = tri;
        better = true;
      }
    }
    sh.res_t[tid] = bt;
    sh.res_u[tid] = bu;
    sh.res_v[tid] = bv;
    sh.res_back[tid] = bb;
    sh.res_tri[tid] = better ? bi : kNone;
    sh.res_nmask[tid] = nm;
    return;
  }
  // A warp per entering ray, its lanes over the columns.
  for (int s = warp; s < m; s += kWarps) {
    const float o0 = sh.ro[0][s], o1 = sh.ro[1][s], o2 = sh.ro[2][s];
    const float d0 = sh.rd[0][s], d1 = sh.rd[1][s], d2 = sh.rd[2][s];
    const float floor_t = sh.fl[s], cur_t = sh.cur_t[s];
    const int cur_i = sh.cur_i[s];
    float bt = kInf, bu = 0.f, bv = 0.f, bnd = 0.f;
    int bc = kNone, nm = 0;
    float carry = kInf;  // least t of the accepted columns of earlier rounds
    for (int c0 = 0; c0 < cnt; c0 += 32) {
      const int col = c0 + lane;
      float t = kInf, u = 0.f, v = 0.f, nd = 0.f;
      bool g = false;
      if (col < cnt) {
        const float nx = p[col], ny = p[wd + col], nz = p[2 * wd + col];
        const float ux = p[c + col], uy = p[wd + c + col], uz = p[2 * wd + c + col];
        const float vx = p[2 * c + col], vy = p[wd + 2 * c + col], vz = p[2 * wd + 2 * c + col];
        const float cn = p[3 * wd + col], cu = p[3 * wd + c + col], cv = p[3 * wd + 2 * c + col];
        const float no = o0 * nx + o1 * ny + o2 * nz;
        const float uo = o0 * ux + o1 * uy + o2 * uz;
        const float vo = o0 * vx + o1 * vy + o2 * vz;
        nd = d0 * nx + d1 * ny + d2 * nz;
        const float ud = d0 * ux + d1 * uy + d2 * uz;
        const float vd = d0 * vx + d1 * vy + d2 * vz;
        t = (cn - no) / nd;
        u = uo + t * ud - cu;
        v = vo + t * vd - cv;
        g = fabsf(nd) >= kEpsDet && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f && t > t_min &&
            t > floor_t;
      }
      bool ok = g;
      if (amask) {
        // The parent counts a mask test for a candidate that passes the
        // geometric tests and beats the carried best and every accepted
        // column before it; those have lower ids, so only a smaller t beats
        // them: the exclusive prefix-min of the accepted t over the columns.
        ok = g && amask_bit(w, c, col, u, v);
        float scan = ok ? t : kInf;
        for (int off = 1; off < 32; off <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, scan, off);
          if (lane >= off) scan = fminf(scan, y);
        }
        float before = __shfl_up_sync(0xffffffffu, scan, 1);
        before = fminf(carry, lane == 0 ? kInf : before);
        const int tri = first + col;
        const bool beats = t < cur_t || (t == cur_t && cur_i >= 0 && tri < cur_i);
        nm += __popc(__ballot_sync(0xffffffffu, g && beats && t < before));
        carry = fminf(carry, __shfl_sync(0xffffffffu, scan, 31));
      }
      if (ok && t < bt) {  // a lane's columns ascend: the first of equal t stays
        bt = t;
        bc = col;
        bu = u;
        bv = v;
        bnd = nd;
      }
    }
    // The lexicographic (t, column) minimum over the warp.
    for (int off = 16; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(0xffffffffu, bt, off);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
      if (ot < bt || (ot == bt && oc < bc)) {
        bt = ot;
        bc = oc;
      }
    }
    const int src = bc == kNone ? 0 : (bc & 31);  // the lane whose own best is the winner
    const float wu = __shfl_sync(0xffffffffu, bu, src);
    const float wv = __shfl_sync(0xffffffffu, bv, src);
    const float wnd = __shfl_sync(0xffffffffu, bnd, src);
    if (lane == 0) {
      const int tri = bc == kNone ? -1 : first + bc;
      const bool better = bc != kNone && (bt < cur_t || (bt == cur_t && cur_i >= 0 && tri < cur_i));
      sh.res_t[s] = bt;
      sh.res_u[s] = wu;
      sh.res_v[s] = wv;
      sh.res_back[s] = wnd > 0.f;
      sh.res_tri[s] = better ? tri : kNone;
      sh.res_nmask[s] = nm;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_trace_kernel(const float* __restrict__ rays, const int32_t* __restrict__ slots,
                   const float* __restrict__ clus_box, int cpad, Clusters clus, int n_clus,
                   const int32_t* __restrict__ blive, float t_min, int nee, int amask, int vec16,
                   float* __restrict__ out) {
  __shared__ Shared sh;
  extern __shared__ float4 dyn_smem[];  // two pack buffers of buf_floats each
  float* bufs = reinterpret_cast<float*>(dyn_smem);
  const int c = clus.c;
  const int buf_floats = (12 * c + (amask ? 2 * c : 0) + 3) & ~3;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * kThreads + tid;  // n is a multiple of kThreads
  const float* rp = rays + (size_t)i * 8;
  Ray r;
  r.t0 = rp[6];
  r.floor_t = rp[7];
  Best b = {r.t0, 0.f, 0.f, 0, -1, 0, 0, 0};

  if (blive[blockIdx.x] != 0) {  // uniform over the block
    bool live = r.t0 > t_min && r.floor_t == r.floor_t;
    for (int a = 0; a < 3; ++a) {
      r.o[a] = rp[a];
      r.d[a] = rp[3 + a];
      const float safe = fabsf(r.d[a]) < 1e-20f ? (r.d[a] < 0.f ? -1e-20f : 1e-20f) : r.d[a];
      r.ia[a] = 1.0f / safe;
      r.oia[a] = r.o[a] * r.ia[a];
      live = live && isfinite(r.ia[a]) && isfinite(r.oia[a]);
    }
    int sc[kSlots];
    for (int k = 0; k < kSlots; ++k) {
      const int key = slots[(size_t)i * kSlots + k];
      sc[k] = key == kKeyDead ? -1 : (key & kIdMask);
    }
    bool active = live;  // may still enter a cluster
    bool changed = false;  // phase B: best t fell since the tile's candidate pass

    // The bundle of the block's live rays, into sh.bundle (read after the
    // next barrier).
    {
      float v[kBundle];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        v[a] = live ? r.o[a] : kInf;               // o_lo (min)
        v[3 + a] = live ? r.o[a] : -kInf;          // o_hi (max)
        v[6 + a] = live ? r.ia[a] : kInf;          // ia_lo (min)
        v[9 + a] = live ? r.ia[a] : -kInf;         // ia_hi (max)
        v[12 + a] = live ? fabsf(r.ia[a]) : 0.f;   // ia_abs (max)
        v[15 + a] = live ? fabsf(r.oia[a]) : 0.f;  // oia_abs (max)
      }
      v[18] = live ? r.t0 : -kInf;      // t0_max
      v[19] = live ? r.floor_t : kInf;  // floor_min
#pragma unroll
      for (int q = 0; q < kBundle; ++q) {
        for (int off = 16; off > 0; off >>= 1) {
          const float y = __shfl_xor_sync(0xffffffffu, v[q], off);
          v[q] = bundle_min(q) ? fminf(v[q], y) : fmaxf(v[q], y);
        }
        if (lane == 0) sh.wred[warp][q] = v[q];
      }
      __syncthreads();
      if (tid < kBundle) {
        float x = sh.wred[0][tid];
        for (int w = 1; w < kWarps; ++w) x = bundle_min(tid) ? fminf(x, sh.wred[w][tid]) : fmaxf(x, sh.wred[w][tid]);
        reinterpret_cast<float*>(&sh.bundle)[tid] = x;
      }
    }
    const Bundle& B = sh.bundle;

    // Walk the list (list_cid, list_box[, list_kept]) of n clusters in
    // order; `pred(e)` says whether this thread's ray enters entry e now.
    // Returns false when, with `nee`, no ray of the block walks any more.
    auto walk = [&](int n, auto pred) -> bool {
      bool going = true;
      if (n == 0) return going;
      stage(clus, clus.src ? clus.src[sh.list_cid[0]] : sh.list_cid[0], bufs, amask, vec16);
      cp_commit();
      for (int e = 0; e < n; ++e) {
        const int par = e & 1;
        float* buf = bufs + par * buf_floats;
        const int cid = sh.list_cid[e];
        const bool enter = active && pred(e);
        const unsigned bal = __ballot_sync(0xffffffffu, enter);
        const unsigned act = __ballot_sync(0xffffffffu, active);
        if (lane == 0) {
          sh.wcount[par][warp] = __popc(bal);
          sh.wact[par][warp] = __popc(act);
        }
        // The other buffer's previous copy has landed (only this entry's is
        // younger); its readers are past the last test's barrier.
        cp_wait<1>();
        if (e + 1 < n) {
          const int nxt = sh.list_cid[e + 1];
          stage(clus, clus.src ? clus.src[nxt] : nxt, bufs + (par ^ 1) * buf_floats, amask, vec16);
        }
        cp_commit();
        __syncthreads();
        int m = 0, slot = 0, n_act = 0;
        for (int w = 0; w < kWarps; ++w) {
          if (w < warp) slot += sh.wcount[par][w];
          m += sh.wcount[par][w];
          n_act += sh.wact[par][w];
        }
        if (n_act == 0) {
          going = false;
          break;
        }
        if (m == 0) continue;
        slot += __popc(bal & ((1u << lane) - 1u));
        const int cnt = clus.count[cid];
        const int first = clus.src ? clus.fid[cid] : __float_as_int(clus.pack[(size_t)cid * 24 * c + 12 * c]);
        if (enter) {
          b.n_clus += 1;
          b.n_tris += cnt;
          if (clus.src) {
            const float* mt = clus.inst_flat + (size_t)clus.inst[cid] * 12;
            for (int a = 0; a < 3; ++a) {
              const float m0 = mt[4 * a], m1 = mt[4 * a + 1], m2 = mt[4 * a + 2];
              sh.ro[a][slot] = r.o[0] * m0 + r.o[1] * m1 + r.o[2] * m2 + mt[4 * a + 3];
              sh.rd[a][slot] = r.d[0] * m0 + r.d[1] * m1 + r.d[2] * m2;
            }
          } else {
            for (int a = 0; a < 3; ++a) {
              sh.ro[a][slot] = r.o[a];
              sh.rd[a][slot] = r.d[a];
            }
          }
          sh.cur_t[slot] = b.t;
          sh.cur_i[slot] = b.tri;
          sh.fl[slot] = r.floor_t;
        }
        cp_wait<1>();  // this entry's copy has landed
        __syncthreads();
        test_cluster(sh, buf, buf + 12 * c, c, m, cnt, first, t_min, amask);
        __syncthreads();
        if (enter) {
          const int tri = sh.res_tri[slot];
          if (tri != kNone) {
            b.t = sh.res_t[slot];
            b.u = sh.res_u[slot];
            b.v = sh.res_v[slot];
            b.back = sh.res_back[slot];
            b.tri = tri;
            changed = true;
          }
          b.n_mask += sh.res_nmask[slot];
          if (nee && b.tri >= 0) active = false;
        }
      }
      cp_wait<0>();
      return going;
    };

    // Phase A: the presort's nearest clusters, nearest first. Each step
    // gathers its distinct slot clusters in ascending id (one box load
    // each) and walks them; a ray meets only its own.
    bool going = true;
    for (int k = 0; k < kSlots && going; ++k) {
      const int mine = sc[k];
      bool pending = active && mine >= 0 && mine < n_clus;
      __syncthreads();  // the previous step's list and boxes are no longer read
      if (tid < 3) sh.smin[tid] = kNone;
      __syncthreads();
      int n = 0;
      for (int round = 0;; ++round) {
        if (pending) atomicMin(&sh.smin[round % 3], mine);
        __syncthreads();
        const int cid = sh.smin[round % 3];
        if (cid == kNone) break;
        if (tid == 0) {
          sh.smin[(round + 2) % 3] = kNone;
          sh.list_cid[n] = cid;
          sh.list_box[n] = n;
        }
        if (tid < 6) sh.box[tid][n] = clus_box[(size_t)tid * cpad + cid];
        pending = pending && mine != cid;
        ++n;
      }
      __syncthreads();
      going = walk(n, [&](int e) {
        return mine == sh.list_cid[e] && enters(r, &sh.box[0][sh.list_box[e]], kTile, t_min, b.t);
      });
    }

    // Phase B: every other cluster in ascending id, a tile at a time.
    for (int base = 0; base < n_clus && going; base += kTile) {
      const int nb = min(kTile, n_clus - base);
      __syncthreads();  // the previous walk's boxes and lists are no longer read
      if (tid < nb)
        for (int q = 0; q < 6; ++q) sh.box[q][tid] = clus_box[(size_t)q * cpad + base + tid];
      float tb = active ? b.t : -kInf;
      for (int off = 16; off > 0; off >>= 1) tb = fmaxf(tb, __shfl_xor_sync(0xffffffffu, tb, off));
      const unsigned act = __ballot_sync(0xffffffffu, active);
      if (lane == 0) {
        sh.wred[warp][0] = tb;
        sh.wact[0][warp] = __popc(act);
      }
      __syncthreads();
      float tb_max = sh.wred[0][0];
      int n_act = sh.wact[0][0];
      for (int w = 1; w < kWarps; ++w) {
        tb_max = fmaxf(tb_max, sh.wred[w][0]);
        n_act += sh.wact[0][w];
      }
      if (n_act == 0) break;
      // 1. The cull: one box a thread against the bundle.
      const bool keep = tid < nb && may_enter(&sh.box[0][tid], kTile, B, t_min, tb_max);
      const unsigned kb = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) sh.kmask[warp] = kb;
      __syncthreads();
      int n_kept = 0, pos = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) pos += __popc(sh.kmask[w]);
        n_kept += __popc(sh.kmask[w]);
      }
      if (keep) sh.kept[pos + __popc(kb & ((1u << lane) - 1u))] = tid;
      if (tid < kTile / 32) sh.cmask[tid] = 0u;
      __syncthreads();
      if (n_kept == 0) continue;
      {  // The union box of each kGroup kept boxes: thread e holds kept box e.
        const bool in = tid < n_kept;
        float g[6];
        for (int q = 0; q < 3; ++q) {
          const float lo = in ? sh.box[q][sh.kept[tid]] : kInf, hi = in ? sh.box[q + 3][sh.kept[tid]] : -kInf;
          g[q] = in ? fminf(lo, hi) : kInf;
          g[q + 3] = in ? fmaxf(lo, hi) : -kInf;
        }
        for (int off = 1; off < kGroup; off <<= 1)
          for (int q = 0; q < 3; ++q) {
            g[q] = fminf(g[q], __shfl_xor_sync(0xffffffffu, g[q], off));
            g[q + 3] = fmaxf(g[q + 3], __shfl_xor_sync(0xffffffffu, g[q + 3], off));
          }
        if (in && tid % kGroup == 0)
          for (int q = 0; q < 6; ++q) sh.gbox[q][tid / kGroup] = g[q];
      }
      __syncthreads();
      // 2. Each ray's own entry test on the kept boxes at the tile's
      //    starting best t; the candidates are the boxes some ray enters.
      //    A ray first tests the union box of each group of kGroup kept
      //    boxes. When many rays of a warp pass it, each tests the group's
      //    boxes itself; when few do, the warp's lanes take the (passing
      //    ray, box) pairs, kGroup lanes a ray, so that random rays, which
      //    the block's cull cannot thin, do not run every box's test in
      //    lockstep with the one lane that needs it.
      unsigned word = 0u;
      const int n_groups = (n_kept + kGroup - 1) / kGroup;
      for (int q = 0; q < n_groups; ++q) {
        const int e0 = q * kGroup, ne = min(kGroup, n_kept - e0);
        const bool gp = active && group_may_enter(r, &sh.gbox[0][q], kTile / kGroup, t_min, b.t);
        const unsigned gb = __ballot_sync(0xffffffffu, gp);
        const int n_pass = __popc(gb);
        unsigned bits = 0u;
        if (n_pass > kPairMax) {
          if (gp)
            for (int m = 0; m < ne; ++m) {
              const int j = sh.kept[e0 + m];
              const int cid = base + j;
              const bool own = cid == sc[0] || cid == sc[1] || cid == sc[2] || cid == sc[3];
              if (!own && enters(r, &sh.box[0][j], kTile, t_min, b.t)) bits |= 1u << m;
            }
        } else if (n_pass > 0) {
          const int rank = __popc(gb & ((1u << lane) - 1u));
          for (int p0 = 0; p0 < n_pass * kGroup; p0 += 32) {
            const int k = (p0 + lane) / kGroup, m = lane % kGroup;
            unsigned left = gb;  // drop the k lowest passing lanes: the k-th is the pair's ray
            for (int x = 0; x < k && left; ++x) left &= left - 1u;
            const int src = left ? __ffs(left) - 1 : 0;
            Ray pr;
            for (int a = 0; a < 3; ++a) {
              pr.ia[a] = __shfl_sync(0xffffffffu, r.ia[a], src);
              pr.oia[a] = __shfl_sync(0xffffffffu, r.oia[a], src);
            }
            pr.t0 = __shfl_sync(0xffffffffu, r.t0, src);
            pr.floor_t = __shfl_sync(0xffffffffu, r.floor_t, src);
            const float pt = __shfl_sync(0xffffffffu, b.t, src);
            int ps[kSlots];
            for (int x = 0; x < kSlots; ++x) ps[x] = __shfl_sync(0xffffffffu, sc[x], src);
            bool in = false;
            if (k < n_pass && m < ne) {
              const int j = sh.kept[e0 + m];
              const int cid = base + j;
              in = cid != ps[0] && cid != ps[1] && cid != ps[2] && cid != ps[3] &&
                   enters(pr, &sh.box[0][j], kTile, t_min, pt);
            }
            const unsigned hb = __ballot_sync(0xffffffffu, in);
            if (gp && rank / (32 / kGroup) == p0 / 32)
              bits = (hb >> ((rank % (32 / kGroup)) * kGroup)) & ((1u << kGroup) - 1u);
          }
        }
        word |= bits << (e0 & 31);
        if ((e0 + kGroup) % 32 == 0 || q == n_groups - 1) {
          sh.rbits[e0 >> 5][tid] = word;
          const unsigned any = __reduce_or_sync(0xffffffffu, word);
          if (lane == 0 && any) atomicOr(&sh.cmask[e0 >> 5], any);
          word = 0u;
        }
      }
      changed = false;
      __syncthreads();
      int n_cand = 0;
      for (int w = 0; w < kTile / 32; ++w) {
        const unsigned cm = sh.cmask[w];
        if (tid >> 5 == w && ((cm >> lane) & 1u)) {
          const int at = n_cand + __popc(cm & ((1u << lane) - 1u));
          sh.list_kept[at] = tid;
          sh.list_box[at] = sh.kept[tid];
          sh.list_cid[at] = base + sh.kept[tid];
        }
        n_cand += __popc(cm);
      }
      __syncthreads();
      // 3.-4. The walk over the candidates; a ray whose best t fell since
      //       its entry test repeats it.
      going = walk(n_cand, [&](int e) {
        const int q = sh.list_kept[e];
        if (!((sh.rbits[q >> 5][tid] >> (q & 31)) & 1u)) return false;
        return !changed || enters(r, &sh.box[0][sh.list_box[e]], kTile, t_min, b.t);
      });
    }
  }

  float* w = out + (size_t)i * 8;
  w[0] = b.t;
  w[1] = b.u;
  w[2] = b.v;
  w[3] = b.back ? 1.f : 0.f;
  w[4] = __int_as_float(b.tri);
  w[5] = (float)b.n_clus;
  w[6] = (float)b.n_tris;
  w[7] = (float)b.n_mask;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// n must be a multiple of 128 (the wrapper pads). n_clus traversal
// clusters; clus_src, clus_inst, clus_fid and inst_flat are null for a
// scene without instances.
extern "C" int fused_trace_launch(const float* rays, const int32_t* slots, int n,
                                  const float* clus_box, int cpad, const float* pack,
                                  const int32_t* count, int n_clus, int c,
                                  const int32_t* clus_src, const int32_t* clus_inst,
                                  const int32_t* clus_fid, const float* inst_flat,
                                  const int32_t* blive, float t_min, int nee, int amask,
                                  float* out, cudaStream_t stream) {
  if (n > 0) {
    const Clusters k = {pack, count, c, clus_src, clus_inst, clus_fid, inst_flat};
    const size_t buf_floats = ((size_t)12 * c + (amask ? 2 * (size_t)c : 0) + 3) & ~(size_t)3;
    const size_t dyn = 2 * buf_floats * sizeof(float);
    if (dyn > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(fused_trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
      if (e != cudaSuccess) return (int)e;
    }
    const int vec16 = c % 4 == 0 && reinterpret_cast<uintptr_t>(pack) % 16 == 0;
    fused_trace_kernel<<<n / kThreads, kThreads, dyn, stream>>>(rays, slots, clus_box, cpad, k, n_clus,
                                                                blive, t_min, nee, amask, vec16, out);
  }
  return (int)cudaGetLastError();
}
