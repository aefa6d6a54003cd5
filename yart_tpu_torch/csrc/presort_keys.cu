// Block-trace presort keys for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel yart_tpu/kernels/pallas_fusedtrace.py
// `presort_keys_pallas` (its pallas_call at :999, body `_presort_body`
// :927-974): every ray is swept against every cluster AABB with the
// conservative slab test, and the ray's row of sort keys is written.
//
// Output row per ray (int32 x 8):
//   0   primary sort key   nothing | heavy | cid0 | cid1
//   1-4 packed (entry bits & ~ID_MASK) | cid keys of the 4 nearest entered
//       clusters, ascending, KEY_DEAD-padded
//   5   entered-cluster count
//   6   secondary sort key nothing | cid2 | cid3
//   7   0
//
// Design
// - One thread per ray, 128 threads per block. The block stages the cluster
//   boxes through shared memory in tiles of kTile clusters (lo.xyz, hi.xyz,
//   SoA), and every thread sweeps the tile: all threads read the same word
//   at once, a broadcast. The 4 smallest keys live in registers and are
//   kept by insertion, so the sweep needs no per-ray storage.
// - A ray with t_max <= 0 (retired lanes, pad rows) enters nothing and gets
//   the dead row without sweeping; a warp of such rays skips the tile loop's
//   arithmetic. The TPU kernel writes the same row for a block of such rays.
// - Numerics follow `_sweep_bounds` and the presort margins operation by
//   operation, with NaN-propagating min/max as in XLA and PyTorch. Build
//   with --fmad=false and without fast math: the entry bits then equal the
//   plain twin's in yart_tpu_torch/kernels/presort.py, and the integer
//   outputs agree exactly.
//
// Bound on this card: ~24 flops per (ray, box) slab test against 32 B of
// ray input and 32 B of output per ray: at 262,144 rays x ~1,600 clusters
// the sweep is ~10 Gflop, compute-bound on the FP32 pipes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;
constexpr int kIdBits = 13;
constexpr int kIdMask = (1 << kIdBits) - 1;
constexpr int kKeyDead = 0x7fffffff;
constexpr int kSkeyHeavy = 1 << (2 * kIdBits);
constexpr int kSkeyNothing = kSkeyHeavy << 1;
constexpr int kSlots = 4;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}

__global__ void __launch_bounds__(kThreads)
presort_keys_kernel(const float* __restrict__ rays, int n,
                    const float* __restrict__ clus_box, int cpad, int n_clus,
                    float t_min, int32_t* __restrict__ out) {
  __shared__ float s_box[6][kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = i < n;
  float o[3] = {0.f, 0.f, 0.f}, ia[3] = {0.f, 0.f, 0.f}, oia[3] = {0.f, 0.f, 0.f};
  float t0 = -1.f, floor_t = 0.f;
  if (in_range) {
    const float* r = rays + (size_t)i * 8;
    t0 = r[6];
    floor_t = r[7];
    for (int a = 0; a < 3; ++a) {
      o[a] = r[a];
      const float d = r[3 + a];
      const float safe = fabsf(d) < 1e-20f ? (d < 0.f ? -1e-20f : 1e-20f) : d;
      ia[a] = 1.0f / safe;
      oia[a] = o[a] * ia[a];
    }
  }
  const bool live = in_range && t0 > 0.f;

  int slot[kSlots] = {kKeyDead, kKeyDead, kKeyDead, kKeyDead};
  int count = 0;
  for (int base = 0; base < n_clus; base += kTile) {
    const int cnt = min(kTile, n_clus - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      for (int r = 0; r < 6; ++r) s_box[r][j] = clus_box[(size_t)r * cpad + base + j];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      float ent = 0.f, ext = 0.f;
      for (int a = 0; a < 3; ++a) {
        const float x0 = s_box[a][j] * ia[a] - oia[a];
        const float x1 = s_box[a + 3][j] * ia[a] - oia[a];
        const float a0 = nan_min(x0, x1);
        const float a1 = nan_max(x0, x1);
        ent = a == 0 ? a0 : nan_max(ent, a0);
        ext = a == 0 ? a1 : nan_min(ext, a1);
      }
      const float e = nan_max(ent - (fabsf(ent) * 1e-6f + 1e-7f), t_min);
      const float xt = ext + (fabsf(ext) * 1e-6f + 1e-7f);
      if (xt >= e && e < t0 && xt > floor_t) {
        ++count;
        int key = (__float_as_int(e) & ~kIdMask) | (base + j);
        // Insert into the ascending 4-slot list (keys are distinct).
        for (int k = 0; k < kSlots; ++k) {
          if (key < slot[k]) {
            const int tmp = slot[k];
            slot[k] = key;
            key = tmp;
          }
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
