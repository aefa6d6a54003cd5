// Bin-trace pair test (phase 2) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel yart_tpu/kernels/pallas_cluster.py
// `cluster_pairs_pallas` (its pallas_call at :200). Bin-trace groups its
// (ray, cluster) pairs so that every block of 1024 pairs shares one triangle
// cluster. Per pair the kernel tests the ray against the cluster's C
// triangles with the plane + barycentric test of `_pair_test` /
// `_pair_test_from_proj` (:61-83, :100-132) and keeps the closest valid
// column. It computes what that kernel computes, not how: no MXU form, no
// floor, no alpha mask (bin-trace serves ungated scenes only).
//
// Per column c of the cluster's pack rows (0-2: the x/y/z components of
// [n | eu | ev] over the column blocks [0:C | C:2C | 2C:3C]; 3: cn | cu | cv):
//   no = o0*n0 + o1*n1 + o2*n2, nd likewise from d, and uo, ud, vo, vd
//   t = (cn - no) / nd,  u = uo + t*ud - cu,  v = vo + t*vd - cv
//   valid = |nd| >= 1e-12 & u >= 0 & u <= 1 & v >= 0 & u + v <= 1
//           & t > t_min & t < tmax
// The pair's result is the valid column of least t, the lowest column on a
// tie: t, u, v, back = nd > 0, tri = block_first + column. A miss, and every
// pair of a block with live == 0, writes t = 3e38, u = v = 0, back = 0,
// tri = -1.
//
// Design
// - One thread block per 1024-pair block, 256 threads, 4 pairs a thread
//   (pairs tid, tid + 256, ...: neighbouring threads read neighbouring
//   32-byte pair rows). The block stages rows 0-3 of its cluster (4 x 3C
//   floats, 6 KB at C = 128) in shared memory; every thread then reads each
//   column's 12 words as a broadcast and tests its 4 pairs against it, in
//   ascending column order with a strict `t < best` carry, which gives the
//   lowest column on a tie.
// - Signs of zero: the TPU kernel picks u and v with a masked sum (`take`),
//   which turns a picked -0.0 into +0.0. The kernel does the same
//   explicitly, so its u and v equal the twin's bit for bit.
// - Numerics follow `_pair_test` operation by operation, built with
//   --fmad=false and without fast math: the kernel agrees BITWISE with the
//   plain PyTorch twin in yart_tpu_torch/kernels/clusterpairs.py.
//
// Bound on this card: ~30 flops per (pair, column) test (six 3-term dot
// products, the division and the two barycentrics) against 32 bytes in and
// 17 out per pair and one 4 x 3C cluster row per block: at C = 128 about
// 3,800 flops per 49 bytes, so it is compute-bound on FP32.
//
// Left for later: the six projections as wgmma products (a [1024, 3] x
// [3, 3C] contraction per block, the TPU kernel's MXU form), TMA staging of
// the pair rows, and skipping dead blocks before launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPairs = 1024;  // pairs per block (B_PAIRS)
constexpr int kThreads = 256;
constexpr int kPerThread = kPairs / kThreads;
constexpr float kEpsDet = 1e-12f;  // EPS_DET
constexpr float kFar = 3.0e38f;  // F32_MAX

__global__ void __launch_bounds__(kThreads)
cluster_pairs_kernel(const float* __restrict__ clus_pack, int c,
                     const int32_t* __restrict__ block_cid,
                     const int32_t* __restrict__ block_first,
                     const int32_t* __restrict__ block_live,
                     const float* __restrict__ x, float t_min,
                     float* __restrict__ t_out, float* __restrict__ u_out,
                     float* __restrict__ v_out, uint8_t* __restrict__ back_out,
                     int32_t* __restrict__ tri_out) {
  extern __shared__ float s_rows[];  // [4][3C]: rows 0-3 of the cluster's pack
  const int b = blockIdx.x;
  const size_t base = (size_t)b * kPairs;

  if (block_live[b] == 0) {  // uniform over the block: no barrier skipped
    for (int r = 0; r < kPerThread; ++r) {
      const size_t p = base + threadIdx.x + r * kThreads;
      t_out[p] = kFar;
      u_out[p] = 0.f;
      v_out[p] = 0.f;
      back_out[p] = 0;
      tri_out[p] = -1;
    }
    return;
  }

  const int w = 3 * c;
  const float* pack = clus_pack + (size_t)block_cid[b] * 8 * w;
  for (int i = threadIdx.x; i < 4 * w; i += kThreads) s_rows[i] = pack[i];
  __syncthreads();

  float ox[kPerThread], oy[kPerThread], oz[kPerThread];
  float dx[kPerThread], dy[kPerThread], dz[kPerThread], tmax[kPerThread];
  float bt[kPerThread], bu[kPerThread], bv[kPerThread], bnd[kPerThread];
  int best[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const float4* row = reinterpret_cast<const float4*>(x + (base + threadIdx.x + r * kThreads) * 8);
    const float4 a = row[0];
    const float4 e = row[1];
    ox[r] = a.x;
    oy[r] = a.y;
    oz[r] = a.z;
    dx[r] = a.w;
    dy[r] = e.x;
    dz[r] = e.y;
    tmax[r] = e.z;
    bt[r] = kFar;
    bu[r] = 0.f;
    bv[r] = 0.f;
    bnd[r] = 0.f;
    best[r] = -1;
  }

  const float* r0 = s_rows;
  const float* r1 = s_rows + w;
  const float* r2 = s_rows + 2 * w;
  const float* r3 = s_rows + 3 * w;
  for (int j = 0; j < c; ++j) {
    const float n0 = r0[j], n1 = r1[j], n2 = r2[j];
    const float eu0 = r0[c + j], eu1 = r1[c + j], eu2 = r2[c + j];
    const float ev0 = r0[2 * c + j], ev1 = r1[2 * c + j], ev2 = r2[2 * c + j];
    const float cn = r3[j], cu = r3[c + j], cv = r3[2 * c + j];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const float no = ox[r] * n0 + oy[r] * n1 + oz[r] * n2;
      const float uo = ox[r] * eu0 + oy[r] * eu1 + oz[r] * eu2;
      const float vo = ox[r] * ev0 + oy[r] * ev1 + oz[r] * ev2;
      const float nd = dx[r] * n0 + dy[r] * n1 + dz[r] * n2;
      const float ud = dx[r] * eu0 + dy[r] * eu1 + dz[r] * eu2;
      const float vd = dx[r] * ev0 + dy[r] * ev1 + dz[r] * ev2;
      const float t = (cn - no) / nd;
      const float u = uo + t * ud - cu;
      const float v = vo + t * vd - cv;
      if (fabsf(nd) >= kEpsDet && u >= 0.f && u <= 1.f && v >= 0.f &&
          u + v <= 1.f && t > t_min && t < tmax[r] && t < bt[r]) {
        bt[r] = t;
        bu[r] = u;
        bv[r] = v;
        bnd[r] = nd;
        best[r] = j;
      }
    }
  }

  const int first = block_first[b];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const size_t p = base + threadIdx.x + r * kThreads;
    const bool hit = best[r] >= 0;
    t_out[p] = bt[r];
    u_out[p] = (hit && bu[r] != 0.f) ? bu[r] : 0.f;  // -0.0 -> +0.0, as `take`
    v_out[p] = (hit && bv[r] != 0.f) ? bv[r] : 0.f;
    back_out[p] = (uint8_t)(hit && bnd[r] > 0.f);
    tri_out[p] = hit ? first + best[r] : -1;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int cluster_pairs_launch(const float* clus_pack, int c,
                                    const int32_t* block_cid,
                                    const int32_t* block_first,
                                    const int32_t* block_live, int n_blocks,
                                    const float* x, float t_min, float* t_out,
                                    float* u_out, float* v_out,
                                    uint8_t* back_out, int32_t* tri_out,
                                    cudaStream_t stream) {
  if (n_blocks > 0) {
    const size_t smem = (size_t)4 * 3 * c * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          cluster_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    cluster_pairs_kernel<<<n_blocks, kThreads, smem, stream>>>(
        clus_pack, c, block_cid, block_first, block_live, x, t_min, t_out,
        u_out, v_out, back_out, tri_out);
  }
  return (int)cudaGetLastError();
}
