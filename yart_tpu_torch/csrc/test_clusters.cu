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
//           & t > t_min & t > floor & t < t_best & column < count
// (count: the cluster's triangles, counts[ids[b*K + s]]). The slot's pick
// is the lowest column of least (valid ? t : 3e38); it replaces the ray's
// row only if its t is strictly below t_best: (t, u, v, back = nd > 0,
// tri = first + column), u and v with -0.0 turned into +0.0 as the TPU
// kernel's masked-sum pick leaves them. Output [Np, 8]: t, u, v, back, tri
// (int32 bits), 0, 0, 0. A cluster's columns past its count
// are zeros in the scene's packs (scene/clusters.py `woop_rows`), which
// |nd| >= 1e-12 rejects, so on those packs the result is the same as with
// every count C.
//
// What bounds it on this card. The parent design copied each live slot's
// 6 KB of rows synchronously between two barriers, nothing overlapping the
// copy, made 15 scalar shared loads a (ray, column) test and tested all C
// columns, though the bench scene's clusters hold 84.6 triangles on average
// (98 SASS instructions a test): 2.567 ms for the launch alone at round 1 of
// its 262,144 rays against a 0.176 ms bound. The bitwise plane test is ~45
// float instructions without FMA; at one a lane a clock that is the floor,
// 0.528 ms. This design issues 66 instructions a test (the IEEE division
// ~10 of them) over 71% of the parent's columns and takes 1.116 ms (NVIDIA
// H100 80GB HBM3, 700 W; PERF.md §6).
//
// Design (one 128-thread block per ray block, one ray a thread, the ray and
// its best hit in registers):
// 1. Staging that overlaps the tests. The block walks its live slots in
//    slot order (any flags, not only a prefix). The next live slot's rows
//    0-3 are copied with 16-byte cp.async into the other of two buffers
//    while the current one is tested: one barrier a slot.
// 2. Only the cluster's real columns. A slot stages and tests the cluster's
//    count of columns and the first column after them (in whole 16-byte
//    words, at most C), and masks every column at or past the count. The
//    first masked column is tested because the lowest column of least value
//    is a masked one (value 3e38) when every real column holds a valid t
//    above 3e38 (t_cur = inf); later masked columns can never be picked
//    before it.
// 3. Three 16-byte loads a test. A buffer keeps the 12 row parts (n.x,
//    eu.x, ev.x, n.y, ..., cn, cu, cv) of each group of 4 columns together,
//    12 16-byte words from one base, and a thread tests 4 columns at a time
//    from 12 16-byte broadcast loads. t > t_min && t > floor is one compare
//    with the ray's max(t_min, floor) (NaN if either is), and only the last
//    column groups carry the count mask. The loop keeps the least t and its
//    column only; the pick's u, v and n.d are recomputed from the same
//    words with the same operations after the columns. Two rays a thread
//    (fewer loads a test, more registers) and 64-thread blocks of half a
//    ray block measured slower (PERF.md §6).
// Numerics follow the twin operation by operation, built with --fmad=false
// and without fast math: the kernel agrees BITWISE with the plain PyTorch
// twin in yart_tpu_torch/kernels/blocktrace.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // rays per block (BLOCK), one thread each
constexpr int kParts = 12;  // row parts of pack rows 0-3: n, eu, ev of rows 0-2, then cn, cu, cv
constexpr float kEpsDet = 1e-12f;  // EPS_DET
constexpr float kFar = 3.0e38f;  // F32_MAX
constexpr float kInf = __builtin_huge_valf();

__device__ __forceinline__ float plus_zero(float a) { return a == 0.f ? 0.f : a; }

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// The first live slot after slot s of the block whose slots start at `base`
// (k when none is left).
__device__ __forceinline__ int next_live(const int32_t* live, int base, int k, int s) {
  do {
    ++s;
  } while (s < k && live[base + s] == 0);
  return s;
}

// The real columns of cluster row `id`: its count clamped to [0, C].
__device__ __forceinline__ int real_columns(const int32_t* counts, int id, int c) {
  return min(max(counts[id], 0), c);
}

// The columns staged and tested: the real ones and the first after them, in
// whole 16-byte words, at most C (design point 2).
__device__ __forceinline__ int test_columns(int n, int c) { return min(c, (n + 4) & ~3); }

// Float index of row part p, column j in a buffer: the 12 parts of each group
// of 4 columns lie together, 12 16-byte words (design point 3).
__device__ __forceinline__ int at(int p, int j) { return ((j >> 2) * kParts + p) * 4 + (j & 3); }

// This thread's share of the copy of columns [0, nt) of the row parts of
// cluster row `id` into buffer `s`.
__device__ __forceinline__ void stage(const float* pack, int id, int c, int nt, float* s, bool vec16) {
  const float* g = pack + (size_t)id * 24 * c;  // rows 0-3 of [8, 3C]: row part p at g + p * C
  if (vec16) {
    const int w4 = nt >> 2;  // 16-byte words a row part (C and nt are multiples of 4)
    for (int q = threadIdx.x; q < kParts * w4; q += kBlock) {
      const int p = q / w4, j = (q - p * w4) * 4;
      cp_async16(s + at(p, j), g + p * c + j);
    }
  } else {
    for (int q = threadIdx.x; q < kParts * nt; q += kBlock) {
      const int p = q / nt, j = q - p * nt;
      cp_async4(s + at(p, j), g + p * c + j);
    }
  }
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float t_lo;  // max(t_min, floor), NaN if either is: t > t_min && t > floor <=> t > t_lo
};

// The plane test of one column, as the twin forms it.
__device__ __forceinline__ void plane(const Ray& r, float n0, float n1, float n2, float eu0, float eu1, float eu2,
                                      float ev0, float ev1, float ev2, float cn, float cu, float cv, float& t,
                                      float& u, float& v, float& nd) {
  const float no = r.ox * n0 + r.oy * n1 + r.oz * n2;
  const float uo = r.ox * eu0 + r.oy * eu1 + r.oz * eu2;
  const float vo = r.ox * ev0 + r.oy * ev1 + r.oz * ev2;
  nd = r.dx * n0 + r.dy * n1 + r.dz * n2;
  const float ud = r.dx * eu0 + r.dy * eu1 + r.dz * eu2;
  const float vd = r.dx * ev0 + r.dy * ev1 + r.dz * ev2;
  t = (cn - no) / nd;
  u = uo + t * ud - cu;
  v = vo + t * vd - cv;
}

// The plane test of column j of buffer S.
__device__ __forceinline__ void plane_at(const Ray& r, const float* S, int j, float& t, float& u, float& v,
                                         float& nd) {
  plane(r, S[at(0, j)], S[at(3, j)], S[at(6, j)], S[at(1, j)], S[at(4, j)], S[at(7, j)], S[at(2, j)], S[at(5, j)],
        S[at(8, j)], S[at(9, j)], S[at(10, j)], S[at(11, j)], t, u, v, nd);
}

__device__ __forceinline__ float lane4(const float4& a, int q) { return q == 0 ? a.x : q == 1 ? a.y : q == 2 ? a.z : a.w; }

// The columns j0..j0+3 for the thread's ray (t_best ct): the least valid t
// (3e38 where none) and its column, the lowest on ties; with kMask a column
// at or past n is never valid.
template <bool kMask>
__device__ __forceinline__ void group(const Ray& r, float ct, const float* S, int j0, int n, float& bt, int& best) {
  const float4* G = reinterpret_cast<const float4*>(S) + (j0 >> 2) * kParts;
  float4 w[kParts];
#pragma unroll
  for (int p = 0; p < kParts; ++p) w[p] = G[p];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float t, u, v, nd;
    plane(r, lane4(w[0], q), lane4(w[3], q), lane4(w[6], q), lane4(w[1], q), lane4(w[4], q), lane4(w[7], q),
          lane4(w[2], q), lane4(w[5], q), lane4(w[8], q), lane4(w[9], q), lane4(w[10], q), lane4(w[11], q), t, u, v,
          nd);
    const bool valid = fabsf(nd) >= kEpsDet && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f && t > r.t_lo &&
                       t < ct && (!kMask || j0 + q < n);
    const float tb = valid ? t : kFar;
    if (tb < bt) {
      bt = tb;
      best = j0 + q;
    }
  }
}

__global__ void __launch_bounds__(kBlock)
test_clusters_kernel(const float* __restrict__ rays, const float* __restrict__ clus_pack, int c,
                     const int32_t* __restrict__ counts, const int32_t* __restrict__ live,
                     const int32_t* __restrict__ first, const int32_t* __restrict__ ids, int k, float t_min,
                     bool vec16, float* __restrict__ out) {
  extern __shared__ float4 s_buf4[];  // two buffers of [C / 4][12] 16-byte words
  float* s_buf = reinterpret_cast<float*>(s_buf4);
  const int stride = ((c + 3) & ~3) * kParts;  // floats a buffer
  const int b = blockIdx.x;
  const size_t lane = (size_t)b * kBlock + threadIdx.x;
  const float4* row = reinterpret_cast<const float4*>(rays + lane * 8);
  const float4 ra = row[0];
  const float4 rb = row[1];
  const float t_lo = (t_min != t_min || rb.w != rb.w) ? __int_as_float(0x7fc00000) : fmaxf(t_min, rb.w);
  const Ray r = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, t_lo};
  float ct = rb.z, cu = 0.f, cv = 0.f, cback = 0.f;
  int ctri = -1;

  const int base = b * k;
  int s = next_live(live, base, k, -1);
  int cur = 0;
  if (s < k) {
    const int id = ids[base + s];
    stage(clus_pack, id, c, test_columns(real_columns(counts, id, c), c), s_buf, vec16);
    cp_commit();
  }
  while (s < k) {  // uniform over the block
    const int slot = base + s, id = ids[slot];
    const int n = real_columns(counts, id, c), nt = test_columns(n, c);
    cp_wait_all();
    __syncthreads();  // this slot's rows are in; every thread is done with the other buffer
    const int s_next = next_live(live, base, k, s);
    if (s_next < k) {
      const int id2 = ids[base + s_next];
      stage(clus_pack, id2, c, test_columns(real_columns(counts, id2, c), c), s_buf + (cur ^ 1) * stride, vec16);
      cp_commit();
    }
    const float* S = s_buf + cur * stride;

    float bt = kInf;  // every column's value is finite: column 0 is taken first
    int best = 0;
    const int n_full = n & ~3, n4 = nt & ~3;
    int j0 = 0;
    for (; j0 < n_full; j0 += 4) group<false>(r, ct, S, j0, n, bt, best);
    for (; j0 < n4; j0 += 4) group<true>(r, ct, S, j0, n, bt, best);
    for (int j = n4; j < nt; ++j) {  // C not a multiple of 4
      float t, u, v, nd;
      plane_at(r, S, j, t, u, v, nd);
      const bool valid = fabsf(nd) >= kEpsDet && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f &&
                         t > r.t_lo && t < ct && j < n;
      const float tb = valid ? t : kFar;
      if (tb < bt) {
        bt = tb;
        best = j;
      }
    }
    if (bt < ct) {  // the pick's u, v and n.d, as the loop formed them
      float t, u, v, nd;
      plane_at(r, S, best, t, u, v, nd);
      ct = bt;
      cu = plus_zero(u);
      cv = plus_zero(v);
      cback = nd > 0.f ? 1.f : 0.f;
      ctri = first[slot] + best;
    }
    s = s_next;
    cur ^= 1;
  }

  float4* dst = reinterpret_cast<float4*>(out + lane * 8);
  dst[0] = make_float4(ct, cu, cv, cback);
  dst[1] = make_float4(__int_as_float(ctri), 0.f, 0.f, 0.f);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// `counts` holds each cluster row's triangle count.
extern "C" int test_clusters_launch(const float* rays, int n_blocks, const float* clus_pack, int c,
                                    const int32_t* counts, const int32_t* live, const int32_t* first,
                                    const int32_t* ids, int k, float t_min, float* out, cudaStream_t stream) {
  if (n_blocks > 0) {
    const size_t smem = (size_t)2 * kParts * ((c + 3) & ~3) * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          test_clusters_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const bool vec16 = c % 4 == 0 && (uintptr_t)clus_pack % 16 == 0;
    test_clusters_kernel<<<n_blocks, kBlock, smem, stream>>>(rays, clus_pack, c, counts, live, first, ids, k,
                                                             t_min, vec16, out);
  }
  return (int)cudaGetLastError();
}
