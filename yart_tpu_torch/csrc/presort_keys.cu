// Block-trace presort keys for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel yart_tpu/kernels/pallas_fusedtrace.py
// `presort_keys_pallas` (its pallas_call at :999, body `_presort_body`
// :927-974): every ray is tested against every cluster AABB with the
// conservative slab test, and the ray's row of sort keys is written.
//
// Output row per ray (int32 x 8):
//   0   primary sort key   nothing | heavy | cid0 | cid1
//   1-4 packed (entry bits & ~ID_MASK) | cid keys of the 4 nearest entered
//       clusters, ascending, KEY_DEAD-padded
//   5   entered-cluster count
//   6   secondary sort key nothing | cid2 | cid3
//   7   0
// The row depends only on the set of boxes the ray enters (the 4 smallest
// keys, which are distinct, and their count), not on the order in which
// they are found: that is what lets this kernel skip boxes.
//
// The exact test of one (ray, box), as the plain twin
// (yart_tpu_torch/kernels/presort.py `sweep_bounds`) computes it:
//   x0 = lo_a * ia_a - oia_a, x1 = hi_a * ia_a - oia_a  (ia = 1 / safe d,
//   oia = o * ia), ent = max over axes of min(x0, x1), ext = min over axes
//   of max(x0, x1), both NaN-propagating;
//   e = max(ent - (|ent| 1e-6 + 1e-7), t_min), xt = ext + (|ext| 1e-6 + 1e-7);
//   entered when xt >= e, e < t_max and xt > floor.
//
// What bounds it on this card. The parent design (one thread a ray, every
// ray sweeping every box) did n_rays x n_clus such tests, each an
// 85-instruction SASS loop iteration: compare-and-select chains for the
// eleven NaN-propagating min/max, six scalar shared loads a box, and no use
// of the coherence of a block of camera rays. The work the inputs need is
// far smaller: one box test per (block, box) and one exact test per box a
// ray enters. On an NVIDIA H100 80GB HBM3 (700 W; PERF.md §6) atrium-ivy's
// 2^20 camera rays x 1,761 boxes took the parent 5.841 ms and take this
// design 0.244; rays in random directions 5.095 and 1.015 ms.
//
// Design (one 128-thread block per 128 rays in lane order):
// 1. Fewer instructions a test. The NaN-propagating min and max are the
//    single instructions min.NaN.f32 / max.NaN.f32 (PTX, sm_80 and later;
//    FMNMX.NAN in SASS), which give the canonical NaN on a NaN input as the
//    parent's chains did. Their rule for +0 against -0 differs from the
//    parent's `a < b ? a : b` (which returns b on any tie), and no output
//    bit depends on it: where the two rules differ, both results are zeros,
//    so every min and max of ent and ext has the same value under either
//    rule, only perhaps another sign of zero. ent and ext then reach the
//    output only through |ent|, |ext|, ent - m and ext + m with m >= 1e-7
//    (a signed zero gives -m and +m either way) and comparisons, under
//    which +0 == -0. The last max, with t_min, keeps the parent's select:
//    ent - m is never -0, but t_min may be, and e's bits are the key's.
//    A box is two 16-byte shared loads (lo.xyz_, hi.xyz_), not six scalar:
//    an exact test is 55-60 SASS instructions (10 FMNMX) where it was 85.
// 2. A block cull: B3's design point 1 (csrc/fused_trace.cu:153-205), with
//    each ray's t_max and floor as the limits in place of B3's best t. The
//    block's live rays (t_max > 0 and > t_min, a floor that is a number, finite
//    1/d and o/d; every other ray provably enters nothing: the exact test
//    then yields a NaN entry or exit, or e >= t_min >= t_max) form a
//    bundle: per axis the box of their origins, the interval of their 1/d,
//    the largest |1/d| and |o/d|, the largest t_max and the least floor.
//    Each tile of 128 boxes is tested once, a box a thread, against the
//    bundle with directed rounding: x of any bundle ray lies within the
//    interval product (b - o)(1/d) widened by 2^-23 (|b| max|1/d| +
//    max|o/d|) + 2^-126, and the margins are taken twice as wide as the
//    exact test's. A box is dropped only when the bounds prove that no
//    bundle ray enters it; a NaN anywhere in them keeps it.
// 3. Union boxes of 8 (B3's design point 2): each ray first tests the union
//    box of each 8 kept boxes. x is monotone in the box coordinate, so a
//    member's entry is >= the union's and its exit <=, and the union's
//    margins are bounded as in 2. When many rays of a warp pass a union box,
//    each tests the 8 members itself; when at most 16 pass, the warp's lanes
//    take the (passing ray, member) pairs, 8 lanes a ray, and each ray then
//    repeats the exact test only on the members it enters, for their keys.
//    Random directions (a render's later bounces, in lane order) defeat the
//    block's cull; the union boxes and the pairs are what is left for them.
// The bundle and union code is a copy of fused_trace.cu's (with the
// single-instruction min/max), not a shared header: sharing it would change
// B3, which this kernel's redesign leaves as it is.
// Built with --fmad=false and without fast math, the exact test repeats the
// twin's float operations one by one, so the integer rows are equal.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;  // boxes per tile: one a thread in the cull
constexpr int kGroup = 8;  // kept boxes per union box
constexpr int kPairMax = 16;  // most rays of a warp passing a union box for its (ray, box) pairs
constexpr int kIdBits = 13;
constexpr int kIdMask = (1 << kIdBits) - 1;
constexpr int kKeyDead = 0x7fffffff;
constexpr int kSkeyHeavy = 1 << (2 * kIdBits);
constexpr int kSkeyNothing = kSkeyHeavy << 1;
constexpr int kSlots = 4;
constexpr float kInf = __builtin_huge_valf();

// NaN-propagating min / max, one instruction each (see design point 1).
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The parent's NaN-propagating max, for the max with t_min.
__device__ __forceinline__ float max_nan_select(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

struct Ray {
  float o[3], ia[3], oia[3];
  float t0, floor_t;
};

// The exact test; true when the ray enters the box, with e its entry.
__device__ __forceinline__ bool enters(const Ray& r, const float4& lo, const float4& hi, float t_min,
                                       float& e) {
  const float l[3] = {lo.x, lo.y, lo.z}, h[3] = {hi.x, hi.y, hi.z};
  float ent = 0.f, ext = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float x0 = l[a] * r.ia[a] - r.oia[a];
    const float x1 = h[a] * r.ia[a] - r.oia[a];
    const float a0 = min_nan(x0, x1);
    const float a1 = max_nan(x0, x1);
    ent = a == 0 ? a0 : max_nan(ent, a0);
    ext = a == 0 ? a1 : min_nan(ext, a1);
  }
  e = max_nan_select(ent - (fabsf(ent) * 1e-6f + 1e-7f), t_min);
  const float xt = ext + (fabsf(ext) * 1e-6f + 1e-7f);
  return xt >= e && e < r.t0 && xt > r.floor_t;
}

// The block's bundle of live rays (design point 2).
struct Bundle {
  float o_lo[3], o_hi[3], ia_lo[3], ia_hi[3], ia_abs[3], oia_abs[3];
  float t0_max, floor_min;
};
constexpr int kBundle = 20;  // floats of a Bundle
__device__ __forceinline__ bool bundle_min(int q) { return q < 3 || (q >= 6 && q < 9) || q == 19; }

// Bounds [lo, hi] of x = fl(fl(b * ia) - oia) over every ray of the bundle.
__device__ __forceinline__ void slab_bounds(float b, const Bundle& B, int a, float& lo, float& hi) {
  const float d_lo = __fsub_rd(b, B.o_hi[a]), d_hi = __fsub_ru(b, B.o_lo[a]);
  const float p_lo = min_nan(min_nan(__fmul_rd(d_lo, B.ia_lo[a]), __fmul_rd(d_lo, B.ia_hi[a])),
                             min_nan(__fmul_rd(d_hi, B.ia_lo[a]), __fmul_rd(d_hi, B.ia_hi[a])));
  const float p_hi = max_nan(max_nan(__fmul_ru(d_lo, B.ia_lo[a]), __fmul_ru(d_lo, B.ia_hi[a])),
                             max_nan(__fmul_ru(d_hi, B.ia_lo[a]), __fmul_ru(d_hi, B.ia_hi[a])));
  const float err =
      __fadd_ru(__fmul_ru(__fadd_ru(__fmul_ru(fabsf(b), B.ia_abs[a]), B.oia_abs[a]), 0x1p-23f), 0x1p-126f);
  lo = __fsub_rd(p_lo, err);
  hi = __fadd_ru(p_hi, err);
}

// False only when no bundle ray enters the box (lo.xyz, hi.xyz).
__device__ __forceinline__ bool may_enter(const float* lo, const float* hi, const Bundle& B, float t_min) {
  float ent = 0.f, ext = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float lo0, hi0, lo1, hi1;
    slab_bounds(lo[a], B, a, lo0, hi0);
    slab_bounds(hi[a], B, a, lo1, hi1);
    const float a0 = min_nan(lo0, lo1);  // <= min(x0, x1)
    const float a1 = max_nan(hi0, hi1);  // >= max(x0, x1)
    ent = a == 0 ? a0 : max_nan(ent, a0);
    ext = a == 0 ? a1 : min_nan(ext, a1);
  }
  const float e = max_nan(__fsub_rd(ent, __fadd_ru(__fmul_ru(fabsf(ent), 2e-6f), 2e-7f)), t_min);
  const float xt = __fadd_ru(ext, __fadd_ru(__fmul_ru(fabsf(ext), 2e-6f), 2e-7f));
  return !(xt < e || e >= B.t0_max || xt <= B.floor_min);
}

// One ray against the union box of a group of boxes: false only when the
// ray enters no box of the group (design point 3).
__device__ __forceinline__ bool group_may_enter(const Ray& r, const float4& lo, const float4& hi,
                                                float t_min) {
  const float l[3] = {lo.x, lo.y, lo.z}, h[3] = {hi.x, hi.y, hi.z};
  float ent = 0.f, ext = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float x0 = l[a] * r.ia[a] - r.oia[a];
    const float x1 = h[a] * r.ia[a] - r.oia[a];
    ent = a == 0 ? min_nan(x0, x1) : max_nan(ent, min_nan(x0, x1));
    ext = a == 0 ? max_nan(x0, x1) : min_nan(ext, max_nan(x0, x1));
  }
  const float e = max_nan(__fsub_rd(ent, __fadd_ru(__fmul_ru(fabsf(ent), 2e-6f), 2e-7f)), t_min);
  const float xt = __fadd_ru(ext, __fadd_ru(__fmul_ru(fabsf(ext), 2e-6f), 2e-7f));
  return !(xt < e || e >= r.t0 || xt <= r.floor_t);
}

struct Shared {
  float4 box[kTile][2];  // the tile's boxes: lo.xyz_, hi.xyz_
  float4 gbox[kTile / kGroup][2];  // the union box of each kGroup kept boxes
  int kept[kTile];  // the kept boxes' columns, ascending
  unsigned kmask[kWarps];  // the cull's kept boxes
  float wred[kWarps][kBundle];  // per warp reductions
  int wlive[kWarps];
  Bundle bundle;
};

__global__ void __launch_bounds__(kThreads)
presort_keys_kernel(const float* __restrict__ rays, int n, const float* __restrict__ clus_box, int cpad,
                    int n_clus, float t_min, int32_t* __restrict__ out) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * kThreads + tid;
  const bool in_range = i < n;

  Ray r;
  r.t0 = -1.f;
  r.floor_t = 0.f;
  bool live = false;
  for (int a = 0; a < 3; ++a) r.o[a] = r.ia[a] = r.oia[a] = 0.f;
  if (in_range) {
    const float* rp = rays + (size_t)i * 8;
    r.t0 = rp[6];
    r.floor_t = rp[7];
    live = r.t0 > 0.f && r.t0 > t_min && r.floor_t == r.floor_t;  // t_max <= 0: a retired lane
    for (int a = 0; a < 3; ++a) {
      r.o[a] = rp[a];
      const float d = rp[3 + a];
      const float safe = fabsf(d) < 1e-20f ? (d < 0.f ? -1e-20f : 1e-20f) : d;
      r.ia[a] = 1.0f / safe;
      r.oia[a] = r.o[a] * r.ia[a];
      live = live && isfinite(r.ia[a]) && isfinite(r.oia[a]);
    }
  }

  // The bundle of the block's live rays, and their count.
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
    const unsigned lb = __ballot_sync(0xffffffffu, live);
    if (lane == 0) sh.wlive[warp] = __popc(lb);
    __syncthreads();
    if (tid < kBundle) {
      float x = sh.wred[0][tid];
      for (int w = 1; w < kWarps; ++w) x = bundle_min(tid) ? fminf(x, sh.wred[w][tid]) : fmaxf(x, sh.wred[w][tid]);
      reinterpret_cast<float*>(&sh.bundle)[tid] = x;
    }
  }
  int n_live = 0;
  for (int w = 0; w < kWarps; ++w) n_live += sh.wlive[w];
  const Bundle& B = sh.bundle;

  int slot[kSlots] = {kKeyDead, kKeyDead, kKeyDead, kKeyDead};
  int count = 0;
  auto insert = [&](float e, int cid) {
    ++count;
    int key = (__float_as_int(e) & ~kIdMask) | cid;  // ascending 4-slot list; keys are distinct
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (key < slot[k]) {
        const int tmp = slot[k];
        slot[k] = key;
        key = tmp;
      }
    }
  };

  for (int base = 0; base < n_clus && n_live > 0; base += kTile) {
    const int nb = min(kTile, n_clus - base);
    // 1. The cull: one box a thread against the bundle.
    float lo[3] = {0.f, 0.f, 0.f}, hi[3] = {0.f, 0.f, 0.f};
    if (tid < nb)
      for (int a = 0; a < 3; ++a) {
        lo[a] = clus_box[(size_t)a * cpad + base + tid];
        hi[a] = clus_box[(size_t)(a + 3) * cpad + base + tid];
      }
    __syncthreads();  // the bundle is written; the previous tile is no longer read
    const bool keep = tid < nb && may_enter(lo, hi, B, t_min);
    if (tid < nb) {
      sh.box[tid][0] = make_float4(lo[0], lo[1], lo[2], 0.f);
      sh.box[tid][1] = make_float4(hi[0], hi[1], hi[2], 0.f);
    }
    const unsigned kb = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) sh.kmask[warp] = kb;
    __syncthreads();
    int n_kept = 0, pos = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) pos += __popc(sh.kmask[w]);
      n_kept += __popc(sh.kmask[w]);
    }
    if (keep) sh.kept[pos + __popc(kb & ((1u << lane) - 1u))] = tid;
    __syncthreads();
    if (n_kept == 0) continue;
    {  // The union box of each kGroup kept boxes: thread e holds kept box e.
      const bool in = tid < n_kept;
      float g[6];
      for (int q = 0; q < 3; ++q) {
        const float* bl = reinterpret_cast<const float*>(&sh.box[in ? sh.kept[tid] : 0][0]);
        const float l = bl[q], h = bl[4 + q];
        g[q] = in ? fminf(l, h) : kInf;
        g[q + 3] = in ? fmaxf(l, h) : -kInf;
      }
      for (int off = 1; off < kGroup; off <<= 1)
        for (int q = 0; q < 3; ++q) {
          g[q] = fminf(g[q], __shfl_xor_sync(0xffffffffu, g[q], off));
          g[q + 3] = fmaxf(g[q + 3], __shfl_xor_sync(0xffffffffu, g[q + 3], off));
        }
      if (in && tid % kGroup == 0) {
        sh.gbox[tid / kGroup][0] = make_float4(g[0], g[1], g[2], 0.f);
        sh.gbox[tid / kGroup][1] = make_float4(g[3], g[4], g[5], 0.f);
      }
    }
    __syncthreads();
    // 2. Each ray's union tests, then its exact tests on the members.
    const int n_groups = (n_kept + kGroup - 1) / kGroup;
    for (int q = 0; q < n_groups; ++q) {
      const int e0 = q * kGroup, ne = min(kGroup, n_kept - e0);
      const bool gp = live && group_may_enter(r, sh.gbox[q][0], sh.gbox[q][1], t_min);
      const unsigned gb = __ballot_sync(0xffffffffu, gp);
      const int n_pass = __popc(gb);
      if (n_pass > kPairMax) {
        if (gp)
          for (int m = 0; m < ne; ++m) {
            const int j = sh.kept[e0 + m];
            float e;
            if (enters(r, sh.box[j][0], sh.box[j][1], t_min, e)) insert(e, base + j);
          }
      } else if (n_pass > 0) {
        // The warp's lanes take the (passing ray, member) pairs, kGroup
        // lanes a ray; each ray gets the bits of the members it enters.
        const int rank = __popc(gb & ((1u << lane) - 1u));
        unsigned bits = 0u;
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
          bool in = false;
          if (k < n_pass && m < ne) {
            const int j = sh.kept[e0 + m];
            float e;
            in = enters(pr, sh.box[j][0], sh.box[j][1], t_min, e);
          }
          const unsigned hb = __ballot_sync(0xffffffffu, in);
          if (gp && rank / (32 / kGroup) == p0 / 32)
            bits = (hb >> ((rank % (32 / kGroup)) * kGroup)) & ((1u << kGroup) - 1u);
        }
        while (bits) {  // the entered members again, for their keys
          const int m = __ffs(bits) - 1;
          bits &= bits - 1u;
          const int j = sh.kept[e0 + m];
          float e;
          if (enters(r, sh.box[j][0], sh.box[j][1], t_min, e)) insert(e, base + j);
        }
      }
    }
  }

  if (!in_range) return;
  int32_t* w = out + (size_t)i * 8;
  const bool nothing = slot[0] == kKeyDead;
  const int c0 = slot[0] & kIdMask, c1 = slot[1] & kIdMask;
  const int c2 = slot[2] & kIdMask, c3 = slot[3] & kIdMask;
  w[0] = nothing ? kSkeyNothing : ((count > kSlots ? kSkeyHeavy : 0) | (c0 << kIdBits) | c1);
  for (int k = 0; k < kSlots; ++k) w[1 + k] = slot[k];
  w[5] = count;
  w[6] = nothing ? kSkeyNothing : ((c2 << kIdBits) | c3);
  w[7] = 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int presort_keys_launch(const float* rays, int n, const float* clus_box,
                                   int cpad, int n_clus, float t_min,
                                   int32_t* out, cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    presort_keys_kernel<<<blocks, kThreads, 0, stream>>>(rays, n, clus_box, cpad,
                                                         n_clus, t_min, out);
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or -1 on an error.
extern "C" int presort_keys_occupancy(void) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, presort_keys_kernel, kThreads, 0) != cudaSuccess)
    return -1;
  return blocks;
}
