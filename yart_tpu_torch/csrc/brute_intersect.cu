// Brute-force closest-hit ray/triangle intersection for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel yart_tpu/kernels/pallas_intersect.py `brute_pallas`
// (its pallas_call at :132): every ray is tested against every triangle of a
// scene of at most 4096 triangles with the Moller-Trumbore test of
// yart_tpu/render/intersect.py `_mt_test` (ray-integrator.cpp:162-229). The
// kernel computes what that kernel computes, not how: there is no carried
// grid; one thread owns one ray.
//
// Design
// - One thread per ray, 256 threads per block. The block stages triangles
//   into shared memory in chunks of 256 (p0, e1 = p1 - p0, e2 = p2 - p0, nine
//   floats each, SoA so a warp reads one broadcast word per component), then
//   every thread walks the chunk in ASCENDING triangle index with the strict
//   `tt < bt` update. The lowest index wins ties, as in the TPU kernel.
// - N may be any size: threads past the end help stage triangles but test
//   and store nothing. Retired lanes arrive with t_max = -1 and come back as
//   misses (tt > t_min and tt < -1 never both hold).
// - Numerics follow `_mt_test` operation by operation. Build with
//   --fmad=false and without --use_fast_math (fast math would also flush
//   denormals): the kernel then agrees BITWISE with the plain PyTorch twin in
//   yart_tpu_torch/kernels/brute.py, which runs the same ops one at a time.
//
// Bound on this card: about 40 flops per ray-triangle pair against 48 bytes
// of ray I/O per ray (o, d, t_max in; t, u, v, back, tri out). At T = 4096
// that is ~160 kflop per 48 B, far above the H100's flop:byte ridge, so the
// kernel is compute-bound; at cornell-mat's 36 triangles (~1.4 kflop per ray)
// it is launch- and memory-bound.
//
// Left for later: the ray loads are AoS (three strided 4-byte loads per
// vector), there is no warp-level triangle broadcast or register blocking of
// several rays per thread, and FMA contraction is off for bitwise parity.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;
constexpr float kEpsDet = 1e-12f;  // reference epsilon (math_base.hpp)

__global__ void __launch_bounds__(kThreads)
brute_intersect_kernel(const float* __restrict__ tri_pack, int n_tris,
                       const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ t_max, int n, float t_min,
                       float* __restrict__ t_out, float* __restrict__ u_out,
                       float* __restrict__ v_out, uint8_t* __restrict__ back_out,
                       int32_t* __restrict__ tri_out) {
  __shared__ float s_tri[9][kChunk];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float bt = -1.f, bu = 0.f, bv = 0.f;
  int bb = 0, bi = -1;
  if (live) {
    ox = o[3 * i + 0];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i + 0];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
    bt = t_max[i];
  }

  for (int base = 0; base < n_tris; base += kChunk) {
    const int cnt = min(kChunk, n_tris - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const float* r = tri_pack + (size_t)(base + j) * 12;
      const float p0x = r[0], p0y = r[1], p0z = r[2];
      s_tri[0][j] = p0x;
      s_tri[1][j] = p0y;
      s_tri[2][j] = p0z;
      s_tri[3][j] = r[3] - p0x;
      s_tri[4][j] = r[4] - p0y;
      s_tri[5][j] = r[5] - p0z;
      s_tri[6][j] = r[6] - p0x;
      s_tri[7][j] = r[7] - p0y;
      s_tri[8][j] = r[8] - p0z;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      const float p0x = s_tri[0][j], p0y = s_tri[1][j], p0z = s_tri[2][j];
      const float e1x = s_tri[3][j], e1y = s_tri[4][j], e1z = s_tri[5][j];
      const float e2x = s_tri[6][j], e2y = s_tri[7][j], e2z = s_tri[8][j];

      // pvec = d x e2
      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const bool ok_det = fabsf(det) >= kEpsDet;
      const float inv_det = 1.0f / (fabsf(det) < kEpsDet ? 1.0f : det);

      const float bx = ox - p0x;
      const float by = oy - p0y;
      const float bz = oz - p0z;
      const float u = (bx * pvx + by * pvy + bz * pvz) * inv_det;
      // qvec = b x e1
      const float qvx = by * e1z - bz * e1y;
      const float qvy = bz * e1x - bx * e1z;
      const float qvz = bx * e1y - by * e1x;
      const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
      const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;

      if (ok_det && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f &&
          tt > t_min && tt < bt) {
        bt = tt;
        bu = u;
        bv = v;
        bb = det < 0.f;
        bi = base + j;
      }
    }
  }

  if (live) {
    t_out[i] = bt;
    u_out[i] = bu;
    v_out[i] = bv;
    back_out[i] = (uint8_t)bb;
    tri_out[i] = bi;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int brute_intersect_launch(const float* tri_pack, int n_tris,
                                      const float* o, const float* d,
                                      const float* t_max, int n, float t_min,
                                      float* t_out, float* u_out, float* v_out,
                                      uint8_t* back_out, int32_t* tri_out,
                                      cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    brute_intersect_kernel<<<blocks, kThreads, 0, stream>>>(
        tri_pack, n_tris, o, d, t_max, n, t_min, t_out, u_out, v_out, back_out,
        tri_out);
  }
  return (int)cudaGetLastError();
}
