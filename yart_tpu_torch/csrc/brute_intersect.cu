// Brute-force closest-hit ray/triangle intersection for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel yart_tpu/kernels/pallas_intersect.py `brute_pallas`
// (its pallas_call at :132): every ray is tested against every triangle of a
// scene (the render path's have at most 4096) with the Moller-Trumbore test of
// yart_tpu/render/intersect.py `_mt_test` (ray-integrator.cpp:162-229). The
// kernel computes what that kernel computes, not how: there is no carried
// grid.
//
// Design
// - Triangles in shared memory. A block stages the triangles as three
//   float4 rows each (p0, e1 = p1 - p0, e2 = p2 - p0; 48 B), so a triangle
//   read is three 16-byte broadcasts. A set of up to kChunk triangles
//   (48 KB at 1024; cornell-mat's 36 take 1.7 KB) is staged once and stays
//   resident for the block's tile; a larger one streams through in chunks
//   of kChunk, which keeps four blocks an SM (a resident 4096-triangle
//   set, 192 KB, allowed one, whose warps could not hide the test's
//   latency).
// - Register blocking. A thread owns R rays of its block's tile, so each
//   triangle read from shared memory feeds R tests. The launcher takes the
//   largest R (1 or 2) whose tiles still give every resident
//   block of the card one, and below a tile an SM blocks of 64 threads, so
//   a few thousand rays still spread over many SMs. One tile a block: a
//   persistent grid walking tiles measured slower (its per-tile barriers).
// - Live rays only. A tile's rays whose t_max is not above t_min (retired
//   lanes, NaN) can never be hit: they are written as misses at once, and
//   the live ones are packed to the front of the tile (ballots and prefix
//   counts, in lane order), so a warp tests only live rays and a tile of
//   dead rays tests nothing. A tile of live rays only keeps its order.
// - Rays are read from device memory by the thread that tests them (a
//   warp's rows are contiguous: the L1 lines serve the three components);
//   staging them in shared memory as 16-byte words measured no faster.
// - Every test keeps `_mt_test`'s operations in order, with the IEEE
//   reciprocal and fabsf(det) >= 1e-12; each ray walks the triangles in
//   ASCENDING index with the strict `tt < bt` update, so the lowest index
//   wins ties. A ray that is not live keeps t = t_max, u = v = 0, back =
//   false, tri = -1, as every test would leave it (tt > t_min and tt <
//   t_max never both hold). Build with --fmad=false and without
//   --use_fast_math: the kernel then agrees BITWISE with the plain PyTorch
//   twin in yart_tpu_torch/kernels/brute.py, which runs the same ops one at
//   a time.
//
// Bound on this card: about 40 flops per ray-triangle pair against 45 bytes
// of ray I/O per ray (o, d, t_max in; t, u, v, back, tri out). At T = 4096
// the kernel is compute-bound; the bitwise contract's no-FMA test is ~70
// SASS instructions, so its reachable floor is the issue rate, not the FP32
// peak.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEpsDet = 1e-12f;  // reference epsilon (math_base.hpp)
constexpr int kChunk = 1024;       // triangles staged at once: a set up to this size stays resident

// Dynamic shared memory of a block: the triangles (a chunk of at most
// kChunk), then its tile's t_max, the live rays before each 32-ray
// chunk of the tile (and their total), and the packed live-ray indices.
template <int THREADS, int R>
constexpr int smem_bytes(int n_tris) {
  return (n_tris < kChunk ? n_tris : kChunk) * 48 + THREADS * R * (4 + 2) +
         (THREADS * R / 32 + 1) * 4;
}

// Triangles [c0, c0 + cn) of the pack into s_tri[0, cn).
template <int THREADS>
__device__ void stage_tris(float4* s_tri, const float* __restrict__ tri_pack, int c0, int cn) {
  for (int j = threadIdx.x; j < cn; j += THREADS) {
    const float* r = tri_pack + (size_t)(c0 + j) * 12;
    const float p0x = r[0], p0y = r[1], p0z = r[2];
    s_tri[3 * j + 0] = make_float4(p0x, p0y, p0z, 0.f);
    s_tri[3 * j + 1] = make_float4(r[3] - p0x, r[4] - p0y, r[5] - p0z, 0.f);
    s_tri[3 * j + 2] = make_float4(r[6] - p0x, r[7] - p0y, r[8] - p0z, 0.f);
  }
}

template <int THREADS, int R>
__global__ void __launch_bounds__(THREADS)
brute_intersect_kernel(const float* __restrict__ tri_pack, int n_tris, const float* __restrict__ o,
                       const float* __restrict__ d, const float* __restrict__ t_max, int n, float t_min,
                       float* __restrict__ t_out, float* __restrict__ u_out, float* __restrict__ v_out,
                       uint8_t* __restrict__ back_out, int32_t* __restrict__ tri_out) {
  constexpr int kTile = THREADS * R;
  constexpr int kChunks = kTile / 32;  // 32-ray chunks of a tile, one ballot each
  const int tri_rows = n_tris < kChunk ? n_tris : kChunk;
  const bool resident = n_tris <= kChunk;
  extern __shared__ float4 smem[];
  float4* s_tri = smem;                                        // [tri_rows][3]: p0, e1, e2 (w unused)
  float* s_t = reinterpret_cast<float*>(smem + 3 * tri_rows);  // [kTile]
  int* s_pre = reinterpret_cast<int*>(s_t + kTile);            // [kChunks + 1]
  uint16_t* s_idx = reinterpret_cast<uint16_t*>(s_pre + kChunks + 1);  // [kTile]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (resident) stage_tris<THREADS>(s_tri, tri_pack, 0, n_tris);
  const int base = blockIdx.x * kTile;  // one tile of rays a block
  const int cnt = min(kTile, n - base);
  // Live rays (t_max > t_min: not retired, not NaN), counted per 32-ray
  // chunk: ray l = tid + k * THREADS lies in chunk warp + k * THREADS / 32.
  bool live[R];
  int rank[R];
  bool mine = true;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int l = tid + k * THREADS;
    const float tm = l < cnt ? t_max[base + l] : 0.f;
    s_t[l] = tm;
    live[k] = l < cnt && tm > t_min;
    mine = mine && live[k];
    const unsigned m = __ballot_sync(0xffffffffu, live[k]);
    rank[k] = __popc(m & ((1u << lane) - 1u));
    if (lane == 0) s_pre[warp + k * (THREADS / 32)] = __popc(m);
  }
  // (The barrier also ends the staging of a resident set.) A tile whose
  // rays are all live (the camera's, say) keeps its order: no packing.
  const bool full = __syncthreads_and(mine);
  if (!full && warp == 0) {  // exclusive prefix sums of the chunk counts, 32 chunks a pass; then the total
    int carry = 0;
    for (int c0 = 0; c0 < kChunks; c0 += 32) {
      const int c = c0 + lane;
      const int v = c < kChunks ? s_pre[c] : 0;
      int x = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      if (c < kChunks) s_pre[c] = carry + x - v;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) s_pre[kChunks] = carry;
  }
  if (!full) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int l = tid + k * THREADS;
      if (live[k]) {
        s_idx[s_pre[warp + k * (THREADS / 32)] + rank[k]] = (uint16_t)l;
      } else if (l < cnt) {  // never hit: the ray's miss
        const int i = base + l;
        t_out[i] = s_t[l];
        u_out[i] = 0.f;
        v_out[i] = 0.f;
        back_out[i] = 0;
        tri_out[i] = -1;
      }
    }
    __syncthreads();
  }
  const int n_live = full ? kTile : s_pre[kChunks];
  const bool testing = tid < n_live;  // whole warps past the live rays test nothing

  float ox[R], oy[R], oz[R], dx[R], dy[R], dz[R], bt[R], bu[R], bv[R];
  int bb[R], bi[R], li[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int slot = tid + k * THREADS;
    const bool has = slot < n_live;
    const int l = !has ? 0 : full ? slot : s_idx[slot];
    li[k] = has ? l : -1;
    const size_t g = 3 * (size_t)(base + l);
    ox[k] = has ? o[g + 0] : 0.f;
    oy[k] = has ? o[g + 1] : 0.f;
    oz[k] = has ? o[g + 2] : 0.f;
    dx[k] = has ? d[g + 0] : 0.f;
    dy[k] = has ? d[g + 1] : 0.f;
    dz[k] = has ? d[g + 2] : 0.f;
    bt[k] = has ? s_t[l] : -1.f;
    bu[k] = 0.f;
    bv[k] = 0.f;
    bb[k] = 0;
    bi[k] = -1;
  }

  for (int c0 = 0; c0 < n_tris && n_live > 0; c0 += kChunk) {
    const int cn = min(kChunk, n_tris - c0);
    if (!resident) {  // stream the set through: this chunk replaces the last
      __syncthreads();
      stage_tris<THREADS>(s_tri, tri_pack, c0, cn);
      __syncthreads();
    }
    if (!testing) continue;
    for (int j = 0; j < cn; ++j) {
      const float4 p0 = s_tri[3 * j + 0];
      const float4 e1 = s_tri[3 * j + 1];
      const float4 e2 = s_tri[3 * j + 2];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        // pvec = d x e2
        const float pvx = dy[k] * e2.z - dz[k] * e2.y;
        const float pvy = dz[k] * e2.x - dx[k] * e2.z;
        const float pvz = dx[k] * e2.y - dy[k] * e2.x;
        const float det = e1.x * pvx + e1.y * pvy + e1.z * pvz;
        const bool ok_det = fabsf(det) >= kEpsDet;
        const float inv_det = 1.0f / (fabsf(det) < kEpsDet ? 1.0f : det);

        const float bx = ox[k] - p0.x;
        const float by = oy[k] - p0.y;
        const float bz = oz[k] - p0.z;
        const float u = (bx * pvx + by * pvy + bz * pvz) * inv_det;
        // qvec = b x e1
        const float qvx = by * e1.z - bz * e1.y;
        const float qvy = bz * e1.x - bx * e1.z;
        const float qvz = bx * e1.y - by * e1.x;
        const float v = (dx[k] * qvx + dy[k] * qvy + dz[k] * qvz) * inv_det;
        const float tt = (e2.x * qvx + e2.y * qvy + e2.z * qvz) * inv_det;

        if (ok_det && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f && tt > t_min && tt < bt[k]) {
          bt[k] = tt;
          bu[k] = u;
          bv[k] = v;
          bb[k] = det < 0.f;
          bi[k] = c0 + j;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (li[k] >= 0) {
      const int i = base + li[k];
      t_out[i] = bt[k];
      u_out[i] = bu[k];
      v_out[i] = bv[k];
      back_out[i] = (uint8_t)bb[k];
      tri_out[i] = bi[k];
    }
  }
}

// Resident blocks of instance (THREADS, R) on an SM at this triangle count
// (0 if its shared memory does not fit or on error).
template <int THREADS, int R>
int blocks_per_sm(int n_tris) {
  const int bytes = smem_bytes<THREADS, R>(n_tris);
  if (cudaFuncSetAttribute(brute_intersect_kernel<THREADS, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess) {
    cudaGetLastError();  // clear it: the instance just does not fit
    return 0;
  }
  int bps = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, brute_intersect_kernel<THREADS, R>, THREADS, bytes) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return bps;
}

template <int THREADS, int R>
int launch(const float* tri_pack, int n_tris, const float* o, const float* d, const float* t_max, int n,
           float t_min, float* t_out, float* u_out, float* v_out, uint8_t* back_out, int32_t* tri_out,
           cudaStream_t stream) {
  const int tiles = (n + THREADS * R - 1) / (THREADS * R);
  brute_intersect_kernel<THREADS, R><<<tiles, THREADS, smem_bytes<THREADS, R>(n_tris), stream>>>(
      tri_pack, n_tris, o, d, t_max, n, t_min, t_out, u_out, v_out, back_out, tri_out);
  return (int)cudaGetLastError();
}

// Per device and triangle count, the resident blocks of each instance (a
// scene keeps its count from launch to launch, so the queries run once).
struct Occupancy {
  int dev = -1, n_tris = -1, sms = 0;
  int bps[3] = {0, 0, 0};  // 256 threads with R = 1, 2; 64 threads with R = 1
};

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int brute_intersect_launch(const float* tri_pack, int n_tris, const float* o, const float* d,
                                      const float* t_max, int n, float t_min, float* t_out, float* u_out,
                                      float* v_out, uint8_t* back_out, int32_t* tri_out, cudaStream_t stream) {
  if (n_tris < 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  static Occupancy occ;
  int dev = 0;
  cudaGetDevice(&dev);
  if (occ.dev != dev || occ.n_tris != n_tris) {
    occ.dev = dev;
    occ.n_tris = n_tris;
    cudaDeviceGetAttribute(&occ.sms, cudaDevAttrMultiProcessorCount, dev);
    occ.bps[0] = blocks_per_sm<256, 1>(n_tris);
    occ.bps[1] = blocks_per_sm<256, 2>(n_tris);
    occ.bps[2] = blocks_per_sm<64, 1>(n_tris);
  }
  const int sms = occ.sms;
  // The largest R whose tiles still give every resident block one.
  if (occ.bps[1] > 0 && (n + 511) / 512 >= sms * occ.bps[1])
    return launch<256, 2>(tri_pack, n_tris, o, d, t_max, n, t_min, t_out, u_out, v_out,
                          back_out, tri_out, stream);
  if (occ.bps[0] > 0 && (n + 255) / 256 >= sms)
    return launch<256, 1>(tri_pack, n_tris, o, d, t_max, n, t_min, t_out, u_out, v_out,
                          back_out, tri_out, stream);
  if (occ.bps[2] <= 0) return (int)cudaErrorInvalidConfiguration;  // fewer rays than an SM each: 64 a block
  return launch<64, 1>(tri_pack, n_tris, o, d, t_max, n, t_min, t_out, u_out, v_out,
                       back_out, tri_out, stream);
}
