// Round-based block trace, select step (B7a) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel yart_tpu/kernels/pallas_blocktrace.py
// `select_clusters_pallas` (its pallas_call at :174). Per block of 128 rays
// (rays [Np, 8]: o3, d3, t_cur, floor) and per cluster column j of
// clus_box [8, cpad] (lo.xyz, hi.xyz, pad) it takes the least slab entry
// over the block's rays (`_entry_chunk`, :61-83):
//   ia = 1 / (|d| < 1e-20 ? +-1e-20 : d),  x0 = lo*ia - o*ia,  x1 likewise
//   ent = max_a min(x0, x1),  ext = min_a max(x0, x1)   (NaN-propagating)
//   e = max(ent, t_min);  entry = (ext >= e && e < t_cur && ext > floor) ? e : 3e38
// packs it into key = (bits(entry) & ~0x1fff) | j, KEY_DEAD (int32 max) where
// the least entry is not below 3e38 or the key lies below the block's signed
// window w_key[b], and extracts the K smallest keys in order: ids [n_blocks, K]
// (-1 past the last live key), bound_key [n_blocks] (the least key left,
// KEY_DEAD if none), n_live [n_blocks]. A block with act[b] == 0 writes ids
// -1, bound_key KEY_DEAD and n_live 0.
//
// What bounds it on this card. The parent design (one thread a box, every
// box against all 128 rays of every active block, then K + 1 block-wide
// minimum reductions that each rescanned the whole row twice) made 537 M
// (ray, box) tests at round 1 of the bench scene's 262,144 rays, each with 8
// scalar shared loads and compare-and-select chains for its NaN-propagating
// min/max (77 SASS instructions a test): 1.827 ms for the launch alone
// against a 0.165 ms bound. The work the inputs need is smaller: one bundle
// test per (block, box), the exact test only on the boxes some ray of the
// block may enter, and one selection per block. This design keeps 430 of
// 2,048 boxes a block there (112.6 M exact tests of 29 instructions) and
// takes 0.294 ms; without the cull 0.73 ms (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md §6).
//
// Design (one 256-thread block per ray block):
// 1. Live rays. A ray is live when t_cur > t_min, its floor is a number and
//    its 1/d and o/d are finite. Every other ray enters no box: its e or ext
//    is NaN, or ext = -inf, or e >= t_min >= t_cur, or ext > NaN fails; its
//    entry is 3e38, which leaves the running minimum's bits as they are. The
//    live rays are packed in ray order as two 16-byte words each, (ia.xyz,
//    t_cur) and (o*ia.xyz, floor).
// 2. A block cull (B2's, csrc/presort_keys.cu:141-178, adapted). The live
//    rays form a bundle: per axis the box of their origins, the interval of
//    their 1/d and the largest |o/d|; the largest t_cur and the least floor.
//    Every column, pad columns included, is tested once against it with
//    directed rounding. x = fl(fl(b/d) - o/d) of any bundle ray lies within
//    y +- (2^-22 (|y| + 2 max|o/d|) + 2^-126), y in the interval product
//    (b - o)(1/d), which covers the exact test's three roundings (the test
//    has no margins); where b/d or the difference may overflow the bound
//    opens to -inf or +inf. B2's error term, 2^-23 (|b| max|1/d| + max|o/d|),
//    overflows for the pad boxes at +3e38 and would keep them all. A box is
//    dropped only when the bounds prove that every live ray misses it or
//    enters it at or past 3e38: its key is KEY_DEAD. A NaN in a bound keeps
//    it. A pad box is kept where a ray with t_cur past its entry may enter
//    it below 3e38 (directions with |d| > 1 on every axis).
// 3. The exact test on the kept boxes, two boxes a thread in registers and
//    one live ray a step from the two 16-byte words (broadcast loads), with
//    the single-instruction min.NaN.f32 / max.NaN.f32. With t_min > 0 every
//    entry that reaches a key is >= t_min > 0, so no sign of zero reaches an
//    output bit: where the one-instruction and the parent's select rules
//    differ both results are zeros, every min/max of the test then has the
//    same value under either rule, ent reaches a key only through max(ent,
//    t_min) = t_min, and ext only through comparisons. Entries are positive,
//    so the least entry over the block is order-free: a warp's work item is
//    64 boxes against a chunk of 32 live rays, and the chunks of a box meet
//    in a shared atomicMin on the entries' bits (their int order is their
//    float order). With t_min <= 0 an entry of +-0 can reach a key's sign
//    bit, and the kernel runs the parent's arithmetic instead: the select
//    min/max and one work item a box over all live rays in ray order.
// 4. One selection. The live keys (below KEY_DEAD, at or above w_key) are
//    distinct. When more than K are live, a radix select over their bits (4
//    passes of 8 bits, a shared histogram and a block scan each) finds the
//    (K+1)-th smallest, which is bound_key; the K keys below it (or every
//    live key) are packed and each one's rank among them places its id.
//    Nothing rescans the row per slot.
// Built with --fmad=false and without fast math, the test repeats the
// twin's float operations one by one, so the integer outputs agree BITWISE
// with the plain PyTorch twin in yart_tpu_torch/kernels/blocktrace.py. The
// bundle code is an adapted copy of presort_keys.cu's, not a shared header:
// sharing it would change B2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // rays per block (BLOCK)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBoxes = 2;  // boxes a thread in the exact test
constexpr int kItemBoxes = 32 * kBoxes;  // boxes of a warp's work item
constexpr int kChunk = 32;  // live rays of a work item (t_min > 0)
constexpr int kMaxK = 128;  // MAX_K
constexpr int kIdMask = (1 << 13) - 1;
constexpr int kKeyDead = 0x7fffffff;
constexpr float kFar = 3.0e38f;  // F32_MAX
constexpr float kFltMax = 3.40282347e38f;
constexpr float kInf = __builtin_huge_valf();
static_assert(kThreads == 256, "the radix select keeps one histogram bin a thread");

// NaN-propagating min / max, one instruction each (see design point 3).
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

// The parent's NaN-propagating min / max (t_min <= 0).
__device__ __forceinline__ float min_select(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}

__device__ __forceinline__ float max_select(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

// The block's bundle of live rays (design point 2).
struct Bundle {
  float o_lo[3], o_hi[3], ia_lo[3], ia_hi[3], oia_abs[3];
  float t0_max, floor_min;
};
constexpr int kBundle = 17;  // floats of a Bundle
__device__ __forceinline__ bool bundle_min(int q) { return q < 3 || (q >= 6 && q < 9) || q == 16; }

// Bounds [lo, hi] of x = fl(fl(b * ia) - oia) over every ray of the bundle
// (design point 2): y = (b - o) ia lies in [p_lo, p_hi], and
// |x - y| <= 2^-22 (|y| + 2 |o ia|) + 2^-126 while nothing overflows.
__device__ __forceinline__ void slab_bounds(float b, const Bundle& B, int a, float& lo, float& hi) {
  const float d_lo = __fsub_rd(b, B.o_hi[a]), d_hi = __fsub_ru(b, B.o_lo[a]);
  const float p_lo = min_nan(min_nan(__fmul_rd(d_lo, B.ia_lo[a]), __fmul_rd(d_lo, B.ia_hi[a])),
                             min_nan(__fmul_rd(d_hi, B.ia_lo[a]), __fmul_rd(d_hi, B.ia_hi[a])));
  const float p_hi = max_nan(max_nan(__fmul_ru(d_lo, B.ia_lo[a]), __fmul_ru(d_lo, B.ia_hi[a])),
                             max_nan(__fmul_ru(d_hi, B.ia_lo[a]), __fmul_ru(d_hi, B.ia_hi[a])));
  const float q = B.oia_abs[a];
  const float slack = __fadd_ru(__fmul_ru(q, 0x1p-20f), 0x1p-126f);
  lo = __fsub_rd(__fsub_rd(p_lo, __fmul_ru(fabsf(p_lo), 0x1p-22f)), slack);
  hi = __fadd_ru(__fadd_ru(p_hi, __fmul_ru(fabsf(p_hi), 0x1p-22f)), slack);
  // Where b ia or the difference may overflow, x may be -inf or +inf (a NaN lands here too).
  if (!(__fsub_rd(p_lo, __fmul_ru(q, 2.f)) > -kFltMax)) lo = -kInf;
  if (!(__fadd_ru(p_hi, __fmul_ru(q, 2.f)) < kFltMax)) hi = kInf;
}

// False only when no bundle ray gives the box (lo.xyz, hi.xyz) an entry
// below min(t_cur, 3e38): its key is then KEY_DEAD.
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
  const float e = max_nan(ent, t_min);
  return !(ext < e || e >= B.t0_max || e >= kFar || ext <= B.floor_min);
}

struct Shared {
  float4 ray[kBlock][2];  // the live rays in ray order: (ia.xyz, t_cur), (o*ia.xyz, floor)
  float wred[kWarps][kBundle];  // per warp bundle reductions
  int wcount[kWarps];
  int hist[256];  // the radix select's histogram
  int sel[kMaxK + 1];  // the selected keys
  int n_kept, n_sel, digit, rank;
  Bundle bundle;
};

// Sum of v over the block; every thread gets it. Uses sh.wcount.
__device__ __forceinline__ int block_sum(int v, Shared& sh) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // sh.wcount is free
  if ((threadIdx.x & 31) == 0) sh.wcount[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
  for (int w = 0; w < kWarps; ++w) v += sh.wcount[w];
  return v;
}

// The exact test of work item (boxes g * kItemBoxes + lane + 32 i, live rays
// [r0, r1)) with the min/max of design point 3; its entries go to s_key.
template <bool kPos>
__device__ __forceinline__ void sweep(const Shared& sh, const float* __restrict__ clus_box, int cpad,
                                      const int* s_kept, int* s_key, int n_kept, int g, int r0, int r1,
                                      float t_min) {
  const int lane = threadIdx.x & 31;
  float lo[kBoxes][3], hi[kBoxes][3], emin[kBoxes];
#pragma unroll
  for (int i = 0; i < kBoxes; ++i) {
    const int q = g * kItemBoxes + i * 32 + lane;
    const int j = q < n_kept ? s_kept[q] : 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[i][a] = clus_box[a * cpad + j];
      hi[i][a] = clus_box[(3 + a) * cpad + j];
    }
    emin[i] = kFar;
  }
  for (int r = r0; r < r1; ++r) {
    const float4 A = sh.ray[r][0], O = sh.ray[r][1];
    const float ia[3] = {A.x, A.y, A.z}, oia[3] = {O.x, O.y, O.z};
#pragma unroll
    for (int i = 0; i < kBoxes; ++i) {
      float ent = 0.f, ext = 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float x0 = lo[i][a] * ia[a] - oia[a];
        const float x1 = hi[i][a] * ia[a] - oia[a];
        if (kPos) {
          const float a0 = min_nan(x0, x1), a1 = max_nan(x0, x1);
          ent = a == 0 ? a0 : max_nan(ent, a0);
          ext = a == 0 ? a1 : min_nan(ext, a1);
        } else {
          const float a0 = min_select(x0, x1), a1 = max_select(x0, x1);
          ent = a == 0 ? a0 : max_select(ent, a0);
          ext = a == 0 ? a1 : min_select(ext, a1);
        }
      }
      const float e = kPos ? max_nan(ent, t_min) : max_select(ent, t_min);
      if (ext >= e && e < A.w && ext > O.w) {
        // The parent's min(emin, hit ? e : 3e38): a miss leaves emin's bits.
        if (kPos)
          emin[i] = fminf(emin[i], e);  // both positive: no sign of zero, no NaN
        else
          emin[i] = emin[i] < e ? emin[i] : e;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kBoxes; ++i) {
    const int q = g * kItemBoxes + i * 32 + lane;
    if (q >= n_kept) continue;
    if (kPos) {
      if (emin[i] < kFar) atomicMin(s_key + q, __float_as_int(emin[i]));
    } else {
      s_key[q] = __float_as_int(emin[i]);  // one work item a box
    }
  }
}

__global__ void __launch_bounds__(kThreads)
select_clusters_kernel(const float* __restrict__ rays, const float* __restrict__ clus_box, int cpad,
                       const int32_t* __restrict__ w_key, const int32_t* __restrict__ act, int k,
                       float t_min, int32_t* __restrict__ ids, int32_t* __restrict__ bound_key,
                       int32_t* __restrict__ n_live, int32_t* __restrict__ stats) {
  extern __shared__ int s_mem[];  // [cpad] kept columns, then [cpad] entries / keys
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  int32_t* out_ids = ids + (size_t)b * k;
  int* s_kept = s_mem;
  int* s_key = s_mem + cpad;

  int n_lr = 0, n_kept = 0, n_keys = 0, n_sel = 0, bound = kKeyDead;
  if (act[b] == 0) goto write;  // uniform over the block

  {  // 1. The live rays, packed in ray order, and the bundle.
    bool live = false;
    float o[3] = {0.f, 0.f, 0.f}, ia[3] = {0.f, 0.f, 0.f}, oia[3] = {0.f, 0.f, 0.f};
    float t0 = 0.f, floor_t = 0.f;
    if (tid < kBlock) {
      const float* row = rays + ((size_t)b * kBlock + tid) * 8;
      t0 = row[6];
      floor_t = row[7];
      live = t0 > t_min && floor_t == floor_t;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        o[a] = row[a];
        const float da = row[3 + a];
        const float safe = fabsf(da) < 1e-20f ? (da < 0.f ? -1e-20f : 1e-20f) : da;
        ia[a] = 1.f / safe;
        oia[a] = o[a] * ia[a];
        live = live && isfinite(ia[a]) && isfinite(oia[a]);
      }
    }
    float v[kBundle];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = live ? o[a] : kInf;                // o_lo (min)
      v[3 + a] = live ? o[a] : -kInf;           // o_hi (max)
      v[6 + a] = live ? ia[a] : kInf;           // ia_lo (min)
      v[9 + a] = live ? ia[a] : -kInf;          // ia_hi (max)
      v[12 + a] = live ? fabsf(oia[a]) : 0.f;   // oia_abs (max)
    }
    v[15] = live ? t0 : -kInf;       // t0_max
    v[16] = live ? floor_t : kInf;   // floor_min
#pragma unroll
    for (int q = 0; q < kBundle; ++q) {
      for (int off = 16; off > 0; off >>= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, v[q], off);
        v[q] = bundle_min(q) ? fminf(v[q], y) : fmaxf(v[q], y);
      }
      if (lane == 0) sh.wred[warp][q] = v[q];
    }
    const unsigned lb = __ballot_sync(0xffffffffu, live);
    if (lane == 0) sh.wcount[warp] = __popc(lb);
    if (tid == 0) sh.n_kept = 0;
    sh.hist[tid] = 0;  // kThreads == 256 bins
    __syncthreads();
    int pos = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) pos += sh.wcount[w];
      n_lr += sh.wcount[w];
    }
    if (live) {
      pos += __popc(lb & ((1u << lane) - 1u));
      sh.ray[pos][0] = make_float4(ia[0], ia[1], ia[2], t0);
      sh.ray[pos][1] = make_float4(oia[0], oia[1], oia[2], floor_t);
    }
    if (tid < kBundle) {
      float x = sh.wred[0][tid];
      for (int w = 1; w < kWarps; ++w) x = bundle_min(tid) ? fminf(x, sh.wred[w][tid]) : fmaxf(x, sh.wred[w][tid]);
      reinterpret_cast<float*>(&sh.bundle)[tid] = x;
    }
    __syncthreads();
  }
  if (n_lr == 0) goto write;  // no ray enters a box: every key is KEY_DEAD

  // 2. The cull: every column once against the bundle; the kept ones listed.
  for (int j0 = 0; j0 < cpad; j0 += kThreads) {
    const int j = j0 + tid;
    bool keep = false;
    if (j < cpad) {
      float lo[3], hi[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = clus_box[a * cpad + j];
        hi[a] = clus_box[(3 + a) * cpad + j];
      }
      keep = may_enter(lo, hi, sh.bundle, t_min);
    }
    const unsigned kb = __ballot_sync(0xffffffffu, keep);
    int base = 0;
    if (lane == 0 && kb) base = atomicAdd(&sh.n_kept, __popc(kb));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (keep) s_kept[base + __popc(kb & ((1u << lane) - 1u))] = j;
  }
  __syncthreads();
  n_kept = sh.n_kept;
  for (int q = tid; q < n_kept; q += kThreads) s_key[q] = __float_as_int(kFar);
  __syncthreads();

  {  // 3. The exact test: work items of kItemBoxes kept boxes x a chunk of live rays.
    const int n_groups = (n_kept + kItemBoxes - 1) / kItemBoxes;
    if (t_min > 0.f) {
      const int n_chunks = (n_lr + kChunk - 1) / kChunk;
      for (int it = warp; it < n_groups * n_chunks; it += kWarps) {
        const int g = it / n_chunks, ch = it - g * n_chunks;
        sweep<true>(sh, clus_box, cpad, s_kept, s_key, n_kept, g, ch * kChunk, min(n_lr, (ch + 1) * kChunk),
                    t_min);
      }
    } else {
      for (int g = warp; g < n_groups; g += kWarps)
        sweep<false>(sh, clus_box, cpad, s_kept, s_key, n_kept, g, 0, n_lr, t_min);
    }
  }
  __syncthreads();

  {  // The keys, in place of the entries.
    const int wk = w_key[b];
    int count = 0;
    for (int q = tid; q < n_kept; q += kThreads) {
      const int bits = s_key[q];
      const int key = (bits & ~kIdMask) | s_kept[q];
      const bool live = __int_as_float(bits) < kFar && key >= wk;
      s_key[q] = live ? key : kKeyDead;
      count += live;
    }
    n_keys = block_sum(count, sh);  // its barriers publish s_key
  }

  // 4. The selection: bound_key = the (K+1)-th smallest live key, by radix select.
  if (n_keys > k) {
    unsigned prefix = 0u, pmask = 0u;
    int rank = k;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int q = tid; q < n_kept; q += kThreads) {
        const int key = s_key[q];
        const unsigned u = (unsigned)key ^ 0x80000000u;  // signed order as unsigned
        if (key != kKeyDead && (u & pmask) == prefix) atomicAdd(&sh.hist[(u >> shift) & 255u], 1);
      }
      __syncthreads();
      const int h = sh.hist[tid];  // kThreads == 256 bins
      sh.hist[tid] = 0;  // for the next pass, after this thread's read
      int incl = h;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) sh.wcount[warp] = incl;
      __syncthreads();
      int excl = incl - h;
      for (int w = 0; w < warp; ++w) excl += sh.wcount[w];
      if (h > 0 && excl <= rank && rank < excl + h) {
        sh.digit = tid;
        sh.rank = rank - excl;
      }
      __syncthreads();
      prefix |= (unsigned)sh.digit << shift;
      pmask |= 255u << shift;
      rank = sh.rank;
    }
    bound = (int)(prefix ^ 0x80000000u);
  }

  {  // The keys below the bound (all live keys when none is left), packed and ranked.
    if (tid == 0) sh.n_sel = 0;
    __syncthreads();
    for (int q = tid; q < n_kept; q += kThreads) {
      const int key = s_key[q];
      if (key < bound) sh.sel[atomicAdd(&sh.n_sel, 1)] = key;
    }
    __syncthreads();
    n_sel = sh.n_sel;  // min(n_keys, k)
    if (tid < n_sel) {
      const int key = sh.sel[tid];
      int rank = 0;
      for (int m = 0; m < n_sel; ++m) rank += sh.sel[m] < key;
      out_ids[rank] = key & kIdMask;
    }
  }

write:
  for (int s = n_sel + tid; s < k; s += kThreads) out_ids[s] = -1;
  if (tid == 0) {
    bound_key[b] = bound;
    n_live[b] = n_sel;
    if (stats) {
      stats[3 * b] = n_lr;
      stats[3 * b + 1] = n_kept;
      stats[3 * b + 2] = n_keys;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// `stats` (may be null) receives per block its live rays, the boxes its
// cull kept and its live keys, int32 [n_blocks, 3].
extern "C" int select_clusters_launch(const float* rays, int n_blocks, const float* clus_box,
                                      int cpad, const int32_t* w_key, const int32_t* act, int k,
                                      float t_min, int32_t* ids, int32_t* bound_key,
                                      int32_t* n_live, int32_t* stats, cudaStream_t stream) {
  if (n_blocks > 0) {
    if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)2 * cpad * sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          select_clusters_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    select_clusters_kernel<<<n_blocks, kThreads, smem, stream>>>(
        rays, clus_box, cpad, w_key, act, k, t_min, ids, bound_key, n_live, stats);
  }
  return (int)cudaGetLastError();
}
