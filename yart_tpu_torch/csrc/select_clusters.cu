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
// Design
// - One thread block per ray block, 256 threads. Threads 0-127 stage the
//   block's rays as ia.xyz, o*ia.xyz, t_cur and floor columns in shared memory
//   (4 KB). Each thread then owns the clusters j = tid, tid + 256, ...: it
//   reads the cluster's box once, runs the slab test against the 128 rays
//   (shared-memory broadcasts) and writes the cluster's key into a shared
//   [cpad] int32 row (at most 32 KB at 8192 clusters).
// - Extraction: K block-wide min reductions over the row (a warp shuffle,
//   then one word per warp). Keys are unique but for KEY_DEAD, so each round
//   retires exactly the winner (the TPU kernel retires every key equal to the
//   minimum); the first KEY_DEAD minimum ends the extraction. One more
//   reduction gives bound_key. A thread touches only its own keys, so the
//   row needs no barrier of its own.
// - The least entry over the rays starts at 3e38 instead of the first ray's
//   entry. Both give the same key: every entry is e < t_cur or 3e38 and never
//   NaN (a NaN e fails `ext >= e`), and any least entry >= 3e38 gives KEY_DEAD.
// - Numerics follow the twin operation by operation, built with --fmad=false
//   and without fast math, with NaN-propagating min/max as torch.minimum /
//   torch.maximum: the kernel agrees BITWISE with the plain PyTorch twin in
//   yart_tpu_torch/kernels/blocktrace.py.
//
// Bound on this card: ~24 flops per (ray, box) slab test over 128 x cpad
// tests per active block (537 M tests, ~13 GFLOP, at 2,048 blocks x 2,048
// boxes), against 4 KB of rays and cpad x 32 B of boxes read per block: it is
// compute-bound on FP32. Left for later: the box sweep in shared-memory tiles
// of boxes with several rays per thread, and a partial sort per warp in place
// of K block-wide reductions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // rays per block (BLOCK)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIdMask = (1 << 13) - 1;
constexpr int kKeyDead = 0x7fffffff;
constexpr float kFar = 3.0e38f;  // F32_MAX

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}

// Minimum of v over the thread block; every thread gets it.
__device__ __forceinline__ int block_min(int v, int* s_red) {
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // s_red is free: every thread has read the previous result
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = s_red[0];
  for (int w = 1; w < kWarps; ++w) v = min(v, s_red[w]);
  return v;
}

__global__ void __launch_bounds__(kThreads)
select_clusters_kernel(const float* __restrict__ rays, const float* __restrict__ clus_box, int cpad,
                       const int32_t* __restrict__ w_key, const int32_t* __restrict__ act, int k,
                       float t_min, int32_t* __restrict__ ids, int32_t* __restrict__ bound_key,
                       int32_t* __restrict__ n_live) {
  extern __shared__ float s_mem[];  // [8][kBlock] ray columns, then [cpad] int32 keys
  __shared__ int s_red[kWarps];
  const int b = blockIdx.x;
  int32_t* out_ids = ids + (size_t)b * k;

  if (act[b] == 0) {  // uniform over the block
    for (int s = threadIdx.x; s < k; s += kThreads) out_ids[s] = -1;
    if (threadIdx.x == 0) {
      bound_key[b] = kKeyDead;
      n_live[b] = 0;
    }
    return;
  }

  float* s_ia = s_mem;                 // [3][kBlock]
  float* s_oia = s_mem + 3 * kBlock;   // [3][kBlock]
  float* s_tcur = s_mem + 6 * kBlock;  // [kBlock]
  float* s_floor = s_mem + 7 * kBlock; // [kBlock]
  int* s_key = reinterpret_cast<int*>(s_mem + 8 * kBlock);
  if (threadIdx.x < kBlock) {
    const float* row = rays + ((size_t)b * kBlock + threadIdx.x) * 8;
    for (int a = 0; a < 3; ++a) {
      const float da = row[3 + a];
      const float safe = fabsf(da) < 1e-20f ? (da < 0.f ? -1e-20f : 1e-20f) : da;
      const float ia = 1.f / safe;
      s_ia[a * kBlock + threadIdx.x] = ia;
      s_oia[a * kBlock + threadIdx.x] = row[a] * ia;
    }
    s_tcur[threadIdx.x] = row[6];
    s_floor[threadIdx.x] = row[7];
  }
  __syncthreads();

  const int wk = w_key[b];
  for (int j = threadIdx.x; j < cpad; j += kThreads) {
    float lo[3], hi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = clus_box[a * cpad + j];
      hi[a] = clus_box[(3 + a) * cpad + j];
    }
    float emin = kFar;
    for (int r = 0; r < kBlock; ++r) {
      float ent = 0.f, ext = 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float ia = s_ia[a * kBlock + r];
        const float oia = s_oia[a * kBlock + r];
        const float x0 = lo[a] * ia - oia;
        const float x1 = hi[a] * ia - oia;
        const float a0 = nan_min(x0, x1);
        const float a1 = nan_max(x0, x1);
        ent = a == 0 ? a0 : nan_max(ent, a0);
        ext = a == 0 ? a1 : nan_min(ext, a1);
      }
      const float e = nan_max(ent, t_min);
      const bool hit = ext >= e && e < s_tcur[r] && ext > s_floor[r];
      emin = nan_min(emin, hit ? e : kFar);
    }
    const int key = (__float_as_int(emin) & ~kIdMask) | j;
    s_key[j] = (emin < kFar && key >= wk) ? key : kKeyDead;
  }

  int live = 0;
  int bound = kKeyDead;
  for (int s = 0; s <= k; ++s) {
    int v = kKeyDead;
    for (int j = threadIdx.x; j < cpad; j += kThreads) v = min(v, s_key[j]);
    const int m = block_min(v, s_red);
    if (s == k) {
      bound = m;
      break;
    }
    if (m == kKeyDead) break;  // uniform: nothing left, bound stays KEY_DEAD
    for (int j = threadIdx.x; j < cpad; j += kThreads)
      if (s_key[j] == m) s_key[j] = kKeyDead;
    if (threadIdx.x == 0) out_ids[s] = m & kIdMask;
    ++live;
  }
  for (int s = live + threadIdx.x; s < k; s += kThreads) out_ids[s] = -1;
  if (threadIdx.x == 0) {
    bound_key[b] = bound;
    n_live[b] = live;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int select_clusters_launch(const float* rays, int n_blocks, const float* clus_box,
                                      int cpad, const int32_t* w_key, const int32_t* act, int k,
                                      float t_min, int32_t* ids, int32_t* bound_key,
                                      int32_t* n_live, cudaStream_t stream) {
  if (n_blocks > 0) {
    const size_t smem = (size_t)8 * kBlock * sizeof(float) + (size_t)cpad * sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          select_clusters_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    select_clusters_kernel<<<n_blocks, kThreads, smem, stream>>>(
        rays, clus_box, cpad, w_key, act, k, t_min, ids, bound_key, n_live);
  }
  return (int)cudaGetLastError();
}
