// Round-based block trace, test step (B7b) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel yart_tpu/kernels/pallas_blocktrace.py
// `test_clusters_pallas` (its pallas_call at :294). Per block of 128 rays
// (rays [Np, 8]: o3, d3, t_cur, floor) the K slots of the round run in
// order; slot s of block b is live when live[b*K + s] != 0 and then names
// cluster row ids[b*K + s] of clus_pack [n_clus, 8, 3C] and its first
// triangle first[b*K + s]. Each ray starts at (t_cur, u = v = back = 0,
// tri = -1) and per live slot runs the plane + barycentric test of
// `_test_kernel` (:202-262) on the cluster's C columns (pack rows 0-2: the
// x/y/z components of [n | eu | ev]; row 3: cn | cu | cv):
//   no = (o0*n0 + o1*n1) + o2*n2, and likewise uo, vo, nd, ud, vd
//   t = (cn - no) / nd,  u = (uo + t*ud) - cu,  v = (vo + t*vd) - cv
//   valid = |nd| >= 1e-12 & 0 <= u <= 1 & v >= 0 & u + v <= 1
//           & t > t_min & t > floor & t < t_best
// The slot's pick is the lowest column of least (valid ? t : 3e38); it
// replaces the ray's row only if its t is strictly below t_best: (t, u, v,
// back = nd > 0, tri = first + column), u and v with -0.0 turned into +0.0
// as the TPU kernel's masked-sum pick leaves them. Output [Np, 8]: t, u, v,
// back, tri (int32 bits), 0, 0, 0.
//
// Design
// - One thread block per ray block, one thread per ray (128 threads); the
//   ray's row and its best hit live in registers across the slots. The slot
//   loop is uniform over the block: a dead slot is skipped, a live one
//   stages rows 0-3 of its cluster (4 x 3C floats, 6 KB at C = 128) in
//   shared memory, and every thread reads each column's 12 words as
//   broadcasts.
// - The pick scans the columns in ascending order with a strict `<` and
//   starts from column 0 whatever its value, which is exactly "the lowest
//   column whose value equals the minimum", the TPU kernel's rule, also when
//   no column is valid.
// - Numerics follow the twin operation by operation, built with --fmad=false
//   and without fast math: the kernel agrees BITWISE with the plain PyTorch
//   twin in yart_tpu_torch/kernels/blocktrace.py.
//
// Bound on this card: ~30 flops per (ray, triangle) test over live slots x
// 128 x C tests (805 M tests, ~24 GFLOP at 2,048 blocks x 24 slots and
// C = 128) against 32 B in and 32 B out per ray and 6 KB per live slot: it
// is compute-bound on FP32. Left for later: wgmma projections (a [128, 3] x
// [3, 3C] product per slot, the TPU kernel's MXU form), double-buffered
// staging of the next live slot's rows, and several rays per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // rays per block (BLOCK), one thread each
constexpr float kEpsDet = 1e-12f;  // EPS_DET
constexpr float kFar = 3.0e38f;  // F32_MAX

__device__ __forceinline__ float plus_zero(float a) { return a == 0.f ? 0.f : a; }

__global__ void __launch_bounds__(kBlock)
test_clusters_kernel(const float* __restrict__ rays, const float* __restrict__ clus_pack, int c,
                     const int32_t* __restrict__ live, const int32_t* __restrict__ first,
                     const int32_t* __restrict__ ids, int k, float t_min,
                     float* __restrict__ out) {
  extern __shared__ float s_rows[];  // [4][3C]: rows 0-3 of the slot's cluster pack
  const int b = blockIdx.x;
  const size_t lane = (size_t)b * kBlock + threadIdx.x;
  const float4* row = reinterpret_cast<const float4*>(rays + lane * 8);
  const float4 ra = row[0];
  const float4 rb = row[1];
  const float ox = ra.x, oy = ra.y, oz = ra.z;
  const float dx = ra.w, dy = rb.x, dz = rb.y;
  const float floor_t = rb.w;
  float ct = rb.z, cu = 0.f, cv = 0.f, cback = 0.f;
  int ctri = -1;

  const int w = 3 * c;
  const float* r0 = s_rows;
  const float* r1 = s_rows + w;
  const float* r2 = s_rows + 2 * w;
  const float* r3 = s_rows + 3 * w;
  for (int s = 0; s < k; ++s) {
    const int slot = b * k + s;
    if (live[slot] == 0) continue;  // uniform over the block
    const float* pack = clus_pack + (size_t)ids[slot] * 8 * w;
    __syncthreads();  // every thread is done with the previous slot's rows
    for (int i = threadIdx.x; i < 4 * w; i += kBlock) s_rows[i] = pack[i];
    __syncthreads();

    float bt = kFar, bu = 0.f, bv = 0.f, bnd = 0.f;
    int best = 0;
    for (int j = 0; j < c; ++j) {
      const float n0 = r0[j], n1 = r1[j], n2 = r2[j];
      const float eu0 = r0[c + j], eu1 = r1[c + j], eu2 = r2[c + j];
      const float ev0 = r0[2 * c + j], ev1 = r1[2 * c + j], ev2 = r2[2 * c + j];
      const float no = ox * n0 + oy * n1 + oz * n2;
      const float uo = ox * eu0 + oy * eu1 + oz * eu2;
      const float vo = ox * ev0 + oy * ev1 + oz * ev2;
      const float nd = dx * n0 + dy * n1 + dz * n2;
      const float ud = dx * eu0 + dy * eu1 + dz * eu2;
      const float vd = dx * ev0 + dy * ev1 + dz * ev2;
      const float t = (r3[j] - no) / nd;
      const float u = uo + t * ud - r3[c + j];
      const float v = vo + t * vd - r3[2 * c + j];
      const bool valid = fabsf(nd) >= kEpsDet && u >= 0.f && u <= 1.f && v >= 0.f &&
                         u + v <= 1.f && t > t_min && t > floor_t && t < ct;
      const float tb = valid ? t : kFar;
      if (j == 0 || tb < bt) {
        bt = tb;
        bu = u;
        bv = v;
        bnd = nd;
        best = j;
      }
    }
    if (bt < ct) {
      ct = bt;
      cu = plus_zero(bu);
      cv = plus_zero(bv);
      cback = bnd > 0.f ? 1.f : 0.f;
      ctri = first[slot] + best;
    }
  }

  float4* dst = reinterpret_cast<float4*>(out + lane * 8);
  dst[0] = make_float4(ct, cu, cv, cback);
  dst[1] = make_float4(__int_as_float(ctri), 0.f, 0.f, 0.f);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int test_clusters_launch(const float* rays, int n_blocks, const float* clus_pack, int c,
                                    const int32_t* live, const int32_t* first, const int32_t* ids,
                                    int k, float t_min, float* out, cudaStream_t stream) {
  if (n_blocks > 0) {
    const size_t smem = (size_t)4 * 3 * c * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          test_clusters_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    test_clusters_kernel<<<n_blocks, kBlock, smem, stream>>>(rays, clus_pack, c, live, first, ids,
                                                             k, t_min, out);
  }
  return (int)cudaGetLastError();
}
