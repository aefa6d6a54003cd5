// Bin-trace pair test (phase 2) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel yart_tpu/kernels/pallas_cluster.py
// `cluster_pairs_pallas` (its pallas_call at :200). Per (ray, cluster) pair
// the kernel tests the ray against the cluster's C triangles with the plane
// + barycentric test of `_pair_test` / `_pair_test_from_proj` (:61-83,
// :100-132) and keeps the closest valid column. It computes what that
// kernel computes, not how: no MXU form, no floor, no alpha mask (bin-trace
// serves ungated scenes only), and no padded blocks.
//
// Per column c of the cluster's pack rows (0-2: the x/y/z components of
// [n | eu | ev] over the column blocks [0:C | C:2C | 2C:3C]; 3: cn | cu | cv):
//   no = o0*n0 + o1*n1 + o2*n2, nd likewise from d, and uo, ud, vo, vd
//   t = (cn - no) / nd,  u = uo + t*ud - cu,  v = vo + t*vd - cv
//   valid = |nd| >= 1e-12 & u >= 0 & u <= 1 & v >= 0 & u + v <= 1
//           & t > t_min & t < tmax
// The pair's result is the valid column of least t, the lowest column on a
// tie: t, u, v, back = nd > 0, tri = first + column. A miss writes
// t = 3e38, u = v = 0, back = 0, tri = -1. Only the cluster's first
// clus_count[cluster] columns are tested: its triangles. Its other columns
// are zero (scene/clusters.py `woop_rows`), so n.d = 0 rejects them in the
// TPU kernel, which tests all C; skipping them changes no result.
//
// The layout (kernels/clusterpairs.py, render/bintrace.py `pair_layout`):
// the live pairs' rows [L, 8] (o3, d3, tmax, 0), sorted by cluster and
// stably by (ray, slot) within one, and a tile table [n_tiles] of (cluster,
// first triangle, first row, count <= 256): the tiles cover the rows in
// order, each row once. No row is padding, so every row the kernel reads,
// tests and writes is a live pair.
//
// What bounds it on this card. The parent design gave every cluster whole
// blocks of 1,024 rows and tested and wrote all of them: at round 1 of the
// dense atrium's 2^20 camera rays 50.6% of the rows were live, on the bench
// scene at C = 16 4.5% (PERF.md §6). Without padding what is left is the
// test: ~30 float operations per (pair, column) plus an IEEE division;
// --fmad=false, which the bitwise contract needs, issues each multiply and
// add alone, so the reachable floor is about twice the FMA-counted bound.
//
// Design
// - One 128-thread block per tile. The block stages the cluster's pack rows
//   0-3 in shared memory once, transposed to 12 floats a column (n.xyz
//   eu.x | eu.yz ev.xy | ev.z cn cu cv), so a thread reads a column as three
//   16-byte broadcasts; only the cluster's triangles' columns (the dense
//   atrium's clusters hold 90.6 of C = 128 on average).
// - Two pairs a thread: warp w takes the tile's rows 64w .. 64w + 63, lane l
//   rows 64w + l and 64w + 32 + l, so that neighbouring lanes read
//   neighbouring 32-byte rows. A warp whose rows all lie past the tile's
//   count leaves after the staging barrier; a warp with rows only in its
//   first half runs the one-pair loop. A row past the count is neither read
//   nor written. Every thread takes part in the one barrier.
// - Columns in ascending order with a strict `t < best` carry, which gives
//   the lowest column on a tie.
// - Signs of zero: the TPU kernel picks u and v with a masked sum (`take`),
//   which turns a picked -0.0 into +0.0. The kernel does the same
//   explicitly, so its u and v equal the twin's bit for bit.
// - Numerics follow `_pair_test` operation by operation, built with
//   --fmad=false and without fast math: the kernel agrees BITWISE with the
//   plain PyTorch twin in yart_tpu_torch/kernels/clusterpairs.py.
//
// On an NVIDIA H100 80GB HBM3 (700 W; PERF.md §6), round 1 of the dense
// atrium's 2^20 camera rays (4,325,036 live pairs) took the parent 3.643 ms
// and takes this design 1.035, against 0.499 ms for 45 instructions a test
// at the card's issue rate; the loop issues 72.5 SASS instructions a test.
//
// Left for later: the six projections as tensor-core products (the TPU
// kernel's MXU form), which the bitwise contract with the twin rules out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 2;  // pairs a thread
constexpr int kWarpRows = 32 * kPer;  // rows of a tile a warp takes
constexpr int kTileMax = kThreads * kPer;  // most rows a tile (clusterpairs.TILE)
constexpr float kEpsDet = 1e-12f;  // EPS_DET
constexpr float kFar = 3.0e38f;  // F32_MAX

struct Out {
  float* __restrict__ t;
  float* __restrict__ u;
  float* __restrict__ v;
  uint8_t* __restrict__ back;
  int32_t* __restrict__ tri;
};

// The tests of NP pairs a thread (rows row0 + p0 + 32 r of x) against the
// n_cols staged columns `cols` ([n_cols][3] float4).
template <int NP>
__device__ __forceinline__ void test_pairs(const float4* __restrict__ cols, int n_cols, const float* __restrict__ x,
                                           int row0, int cnt, int p0, int first, float t_min, const Out& out) {
  float ox[NP], oy[NP], oz[NP], dx[NP], dy[NP], dz[NP], tmax[NP];
  float bt[NP], bu[NP], bv[NP], bnd[NP];
  int best[NP];
#pragma unroll
  for (int r = 0; r < NP; ++r) {
    const int p = p0 + 32 * r;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), e = make_float4(0.f, 0.f, -__builtin_huge_valf(), 0.f);
    if (p < cnt) {  // a row past the count is not read: its tmax of -inf makes it miss
      const float4* row = reinterpret_cast<const float4*>(x + (size_t)(row0 + p) * 8);
      a = row[0];
      e = row[1];
    }
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

  for (int j = 0; j < n_cols; ++j) {
    const float4 c0 = cols[3 * j], c1 = cols[3 * j + 1], c2 = cols[3 * j + 2];
    const float n0 = c0.x, n1 = c0.y, n2 = c0.z;
    const float eu0 = c0.w, eu1 = c1.x, eu2 = c1.y;
    const float ev0 = c1.z, ev1 = c1.w, ev2 = c2.x;
    const float cn = c2.y, cu = c2.z, cv = c2.w;
#pragma unroll
    for (int r = 0; r < NP; ++r) {
      const float no = ox[r] * n0 + oy[r] * n1 + oz[r] * n2;
      const float uo = ox[r] * eu0 + oy[r] * eu1 + oz[r] * eu2;
      const float vo = ox[r] * ev0 + oy[r] * ev1 + oz[r] * ev2;
      const float nd = dx[r] * n0 + dy[r] * n1 + dz[r] * n2;
      const float ud = dx[r] * eu0 + dy[r] * eu1 + dz[r] * eu2;
      const float vd = dx[r] * ev0 + dy[r] * ev1 + dz[r] * ev2;
      const float t = (cn - no) / nd;
      const float u = uo + t * ud - cu;
      const float v = vo + t * vd - cv;
      if (fabsf(nd) >= kEpsDet && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f && t > t_min &&
          t < tmax[r] && t < bt[r]) {
        bt[r] = t;
        bu[r] = u;
        bv[r] = v;
        bnd[r] = nd;
        best[r] = j;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < NP; ++r) {
    const int p = p0 + 32 * r;
    if (p >= cnt) continue;
    const size_t q = (size_t)row0 + p;
    const bool hit = best[r] >= 0;
    out.t[q] = bt[r];
    out.u[q] = (hit && bu[r] != 0.f) ? bu[r] : 0.f;  // -0.0 -> +0.0, as `take`
    out.v[q] = (hit && bv[r] != 0.f) ? bv[r] : 0.f;
    out.back[q] = (uint8_t)(hit && bnd[r] > 0.f);
    out.tri[q] = hit ? first + best[r] : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
cluster_pairs_kernel(const float* __restrict__ clus_pack, const int32_t* __restrict__ clus_count, int n_clus,
                     int c, const int4* __restrict__ tiles, const float* __restrict__ x, int n_rows, float t_min,
                     Out out) {
  extern __shared__ float4 s_cols[];  // [C][3]: the cluster's columns, 12 floats each
  const int4 tl = tiles[blockIdx.x];  // cluster, first triangle, first row, count
  // A tile outside the cluster table or the rows touches nothing (the
  // wrapper checks the table; this keeps every access in bounds).
  if (tl.x < 0 || tl.x >= n_clus || tl.z < 0 || tl.z > n_rows) return;
  const int w = 3 * c;
  const int n_cols = max(0, min(c, clus_count[tl.x]));  // its triangles; the rest are zero columns
  const float* pack = clus_pack + (size_t)tl.x * 8 * w;
  float* s = reinterpret_cast<float*>(s_cols);
  for (int row = 0; row < 4; ++row)
    for (int blk = 0; blk < 3; ++blk) {
      const int slot = row < 3 ? 3 * blk + row : 9 + blk;
      const float* src = pack + row * w + blk * c;
      for (int j = threadIdx.x; j < n_cols; j += kThreads) s[12 * j + slot] = src[j];
    }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cnt = min(min(tl.w, kTileMax), n_rows - tl.z);
  const int w0 = warp * kWarpRows;
  // The 32-row groups of this warp that hold a pair (none: it leaves, after
  // the one barrier).
  const int groups = min(kPer, (cnt - w0 + 31) / 32);
  if (groups >= 4) test_pairs<4 <= kPer ? 4 : 1>(s_cols, n_cols, x, tl.z, cnt, w0 + lane, tl.y, t_min, out);
  else if (groups == 3) test_pairs<3 <= kPer ? 3 : 1>(s_cols, n_cols, x, tl.z, cnt, w0 + lane, tl.y, t_min, out);
  else if (groups == 2) test_pairs<2 <= kPer ? 2 : 1>(s_cols, n_cols, x, tl.z, cnt, w0 + lane, tl.y, t_min, out);
  else if (groups == 1) test_pairs<1>(s_cols, n_cols, x, tl.z, cnt, w0 + lane, tl.y, t_min, out);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// tiles: n_tiles x (cluster, first triangle, first row, count <= 256);
// clus_count: each cluster's triangles (its columns to test).
extern "C" int cluster_pairs_launch(const float* clus_pack, const int32_t* clus_count, int n_clus, int c,
                                    const int32_t* tiles, int n_tiles, const float* x, int n_rows,
                                    float t_min, float* t_out, float* u_out,
                                    float* v_out, uint8_t* back_out, int32_t* tri_out,
                                    cudaStream_t stream) {
  if (n_tiles > 0) {
    const size_t smem = (size_t)12 * c * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          cluster_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const Out out = {t_out, u_out, v_out, back_out, tri_out};
    cluster_pairs_kernel<<<n_tiles, kThreads, smem, stream>>>(
        clus_pack, clus_count, n_clus, c, reinterpret_cast<const int4*>(tiles), x, n_rows, t_min, out);
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel at cluster size c
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on an error.
extern "C" int cluster_pairs_occupancy(int c) {
  int blocks = 0;
  const size_t smem = (size_t)12 * c * sizeof(float);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(cluster_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cluster_pairs_kernel, kThreads, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}
