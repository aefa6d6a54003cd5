// Fused block-trace closest hit for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel yart_tpu/kernels/pallas_fusedtrace.py
// `fused_trace_pallas` (its pallas_call at :1128) in its closest-hit,
// any-hit (`nee`), alpha-mask (`amask`) and instanced modes. It computes
// what that kernel computes, not how:
// the TPU kernel runs a block-wide nearest-entry loop over the cluster
// packs with a winners epilogue; here one thread owns one ray and walks
// the clusters itself.
//
// Per ray (row of the presorted ray matrix: o3, d3, t_cur, floor):
// - visit order: the (up to) 4 nearest clusters of its presort slots
//   (kernel B2), nearest first, then every other cluster in ascending id;
// - a cluster is tested when the ray enters its box (B2's slab test and
//   margins) and its entry is <= the ray's current best t;
// - a test runs `_t_only`'s plane test over the cluster's real triangles:
//   t = (cn - n.o) / n.d, u = eu.o + t (eu.d) - cu, v likewise, dot products
//   x + y + z; valid when |n.d| >= 1e-12, 0 <= u <= 1, v >= 0, u + v <= 1,
//   t > t_min, t > floor, and (t, tri) is lexicographically below the
//   carried best (ties at bit-equal t go to the lowest triangle index);
// - with `amask` a candidate is valid only if bit (iu, iv) of its
//   triangle's 8x8 alpha mask (pack row 5) is set, iu = int(clip(8u, 0, 7)),
//   iv likewise: the cull of certainly-transparent texels that the gated
//   re-cast loop relies on (yart_tpu_torch/scene/alphamask.py);
// - with `nee` the ray stops after the first cluster that gives it a hit;
// - instanced (`clus_src` non-null; pallas_fusedtrace.py:291-315,
//   :651-660): traversal cluster `cid` is one (instance, prototype
//   cluster) pair. Its box is world space, so the entry test above is
//   unchanged; its triangles are pack row clus_src[cid], tested with the
//   ray mapped into the prototype's object space by the instance's
//   UNNORMALISED inverse 3x4 r = inst_flat[clus_inst[cid] * 12 ..]:
//   o'_a = ((o0 r[4a] + o1 r[4a+1]) + o2 r[4a+2]) + r[4a+3], d'_a likewise
//   without the translation, so t stays the world parameter and t_min,
//   the floor and the best t compose across instances; the triangle id is
//   clus_fid[cid] + column (the pack's row 4 holds the prototype-local
//   id), and `amask` reads the prototype's own mask words.
// Output row: t, u, v, back, tri bits (-1 = miss, t = t_cur), clusters
// tested, triangles tested, alpha-mask tests run (0 without `amask`).
//
// Design
// - 128 threads per block = one presort block of rays; a block whose
//   `blive` flag is 0 enters nothing and writes the miss rows at once.
// - The ascending sweep stages the cluster boxes through shared memory in
//   tiles, as the presort does; each thread reads the pack rows of the
//   clusters it tests straight from global memory. After the presort's
//   sort the rays of a warp mostly test the same clusters, so those reads
//   are broadcasts served by L1/L2. The instanced mode reads a tested
//   cluster's 12 transform floats once and transforms the ray in
//   registers before the same triangle loop; after the presort a warp's
//   rays mostly share the instance, so those reads are broadcasts too.
// - Built with --fmad=false and without fast math, the kernel repeats the
//   plain twin's float operations (yart_tpu_torch/kernels/fusedtrace.py)
//   one by one and visits the same clusters in the same order, so the two
//   agree bitwise.
//
// Bound on this card: ~30 flops per tested (ray, triangle) pair plus ~24
// per (ray, box) slab test (+33 per tested instance cluster for the ray
// transform), against 64 B of ray and hit I/O per ray; at the
// bench's 132k triangles the tested pairs dominate and the kernel is
// compute-bound. Left for later: wgmma / tensor-core projections, TMA
// staging of the packs, and a block-wide nearest-first queue.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;
constexpr int kIdMask = (1 << 13) - 1;
constexpr int kKeyDead = 0x7fffffff;
constexpr int kSlots = 4;
constexpr float kEpsDet = 1e-12f;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}

struct Ray {
  float o[3], d[3], ia[3], oia[3];
  float t0, floor_t;
};

struct Best {
  float t, u, v;
  int back, tri, n_clus, n_tris, n_mask;
};

// Entry test of one box (lo.xyz, hi.xyz) with the presort's margins; true
// when the ray enters it and the entry does not exceed the current best t.
__device__ __forceinline__ bool enters(const Ray& r, const float box[6], float t_min,
                                       float t_best) {
  float ent = 0.f, ext = 0.f;
  for (int a = 0; a < 3; ++a) {
    const float x0 = box[a] * r.ia[a] - r.oia[a];
    const float x1 = box[a + 3] * r.ia[a] - r.oia[a];
    const float a0 = nan_min(x0, x1);
    const float a1 = nan_max(x0, x1);
    ent = a == 0 ? a0 : nan_max(ent, a0);
    ext = a == 0 ? a1 : nan_min(ext, a1);
  }
  const float e = nan_max(ent - (fabsf(ent) * 1e-6f + 1e-7f), t_min);
  const float xt = ext + (fabsf(ext) * 1e-6f + 1e-7f);
  return xt >= e && e < r.t0 && xt > r.floor_t && e <= t_best;
}

// The alpha-mask cull (`_amask_valid`, pallas_cluster.py:38-58): bit
// (iu, iv) of the triangle's 8x8 barycentric mask, with the words in pack
// row 5 (lanes [0:C] = bits 0..31, [C:2C] = bits 32..63). A 0 bit means the
// alpha texture is identically zero over that cell, so the gate would never
// accept the candidate. Called only after the geometric and best-t tests
// passed, so u and v are finite; the clamps still mirror the twin's.
__device__ __forceinline__ bool amask_bit(const float* __restrict__ p, int w, int c, int col,
                                          float u, float v) {
  const int iu = (int)fminf(fmaxf(u * 8.f, 0.f), 7.f);
  const int iv = (int)fminf(fmaxf(v * 8.f, 0.f), 7.f);
  const int bit = min(max(iu * 8 + iv, 0), 63);
  const unsigned word = (unsigned)__float_as_int(p[5 * w + (bit < 32 ? col : c + col)]);
  return ((word >> (bit & 31)) & 1u) != 0u;
}

// One cluster's triangles against the ray (o, d), which is the world ray or,
// in the instanced mode, the ray in the prototype's object space; `first`
// is the triangle id of column 0.
__device__ __forceinline__ void test_cluster(const float o[3], const float d[3], float floor_t,
                                             const float* __restrict__ p, int c, int cnt,
                                             int first, float t_min, int amask, Best& b) {
  const int w = 3 * c;
  b.n_clus += 1;
  b.n_tris += cnt;
  for (int col = 0; col < cnt; ++col) {
    const float nx = p[col], ny = p[w + col], nz = p[2 * w + col];
    const float ux = p[c + col], uy = p[w + c + col], uz = p[2 * w + c + col];
    const float vx = p[2 * c + col], vy = p[w + 2 * c + col], vz = p[2 * w + 2 * c + col];
    const float cn = p[3 * w + col], cu = p[3 * w + c + col], cv = p[3 * w + 2 * c + col];
    const float no = o[0] * nx + o[1] * ny + o[2] * nz;
    const float uo = o[0] * ux + o[1] * uy + o[2] * uz;
    const float vo = o[0] * vx + o[1] * vy + o[2] * vz;
    const float nd = d[0] * nx + d[1] * ny + d[2] * nz;
    const float ud = d[0] * ux + d[1] * uy + d[2] * uz;
    const float vd = d[0] * vx + d[1] * vy + d[2] * vz;
    const float t = (cn - no) / nd;
    const float u = uo + t * ud - cu;
    const float v = vo + t * vd - cv;
    const int tri = first + col;
    if (fabsf(nd) >= kEpsDet && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f &&
        t > t_min && t > floor_t &&
        (t < b.t || (t == b.t && b.tri >= 0 && tri < b.tri))) {
      if (amask) {
        b.n_mask += 1;
        if (!amask_bit(p, w, c, col, u, v)) continue;
      }
      b.t = t;
      b.u = u;
      b.v = v;
      b.back = nd > 0.f;
      b.tri = tri;
    }
  }
}

// The scene's cluster tables; the instanced ones are null for a scene
// without instances.
struct Clusters {
  const float* __restrict__ pack;
  const int32_t* __restrict__ count;
  int c;
  const int32_t* __restrict__ src;
  const int32_t* __restrict__ inst;
  const int32_t* __restrict__ fid;
  const float* __restrict__ inst_flat;
};

// Test traversal cluster `cid` (its box already entered).
__device__ __forceinline__ void visit(const Ray& r, const Clusters& k, int cid, float t_min,
                                      int amask, Best& b) {
  const size_t stride = (size_t)8 * 3 * k.c;
  if (k.src == nullptr) {
    const float* p = k.pack + cid * stride;
    test_cluster(r.o, r.d, r.floor_t, p, k.c, k.count[cid], __float_as_int(p[4 * 3 * k.c]),
                 t_min, amask, b);
    return;
  }
  const float* m = k.inst_flat + (size_t)k.inst[cid] * 12;
  float o[3], d[3];
  for (int a = 0; a < 3; ++a) {
    const float m0 = m[4 * a], m1 = m[4 * a + 1], m2 = m[4 * a + 2];
    o[a] = r.o[0] * m0 + r.o[1] * m1 + r.o[2] * m2 + m[4 * a + 3];
    d[a] = r.d[0] * m0 + r.d[1] * m1 + r.d[2] * m2;
  }
  test_cluster(o, d, r.floor_t, k.pack + k.src[cid] * stride, k.c, k.count[cid], k.fid[cid],
               t_min, amask, b);
}

__global__ void __launch_bounds__(kThreads)
fused_trace_kernel(const float* __restrict__ rays, const int32_t* __restrict__ slots,
                   const float* __restrict__ clus_box, int cpad, Clusters clus, int n_clus,
                   const int32_t* __restrict__ blive, float t_min, int nee, int amask,
                   float* __restrict__ out) {
  __shared__ float s_box[6][kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;  // n is a multiple of kThreads
  const float* rp = rays + (size_t)i * 8;
  Ray r;
  r.t0 = rp[6];
  r.floor_t = rp[7];
  Best b = {r.t0, 0.f, 0.f, 0, -1, 0, 0, 0};

  if (blive[blockIdx.x] != 0) {  // uniform over the block
    for (int a = 0; a < 3; ++a) {
      r.o[a] = rp[a];
      r.d[a] = rp[3 + a];
      const float safe = fabsf(r.d[a]) < 1e-20f ? (r.d[a] < 0.f ? -1e-20f : 1e-20f) : r.d[a];
      r.ia[a] = 1.0f / safe;
      r.oia[a] = r.o[a] * r.ia[a];
    }
    int sc[kSlots];
    for (int k = 0; k < kSlots; ++k) {
      const int key = slots[(size_t)i * kSlots + k];
      sc[k] = key == kKeyDead ? -1 : (key & kIdMask);
    }
    bool done = false;

    // Phase A: the presort's nearest clusters, nearest first.
    for (int k = 0; k < kSlots && !done; ++k) {
      const int cid = sc[k];
      if (cid < 0 || cid >= n_clus) continue;
      float box[6];
      for (int q = 0; q < 6; ++q) box[q] = clus_box[(size_t)q * cpad + cid];
      if (enters(r, box, t_min, b.t)) {
        visit(r, clus, cid, t_min, amask, b);
        done = nee && b.tri >= 0;
      }
    }

    // Phase B: every other cluster in ascending id.
    for (int base = 0; base < n_clus; base += kTile) {
      const int cnt = min(kTile, n_clus - base);
      __syncthreads();  // the previous tile is no longer read
      for (int j = threadIdx.x; j < cnt; j += kThreads) {
        for (int q = 0; q < 6; ++q) s_box[q][j] = clus_box[(size_t)q * cpad + base + j];
      }
      __syncthreads();
      if (done) continue;
      for (int j = 0; j < cnt && !done; ++j) {
        const int cid = base + j;
        if (cid == sc[0] || cid == sc[1] || cid == sc[2] || cid == sc[3]) continue;
        float box[6];
        for (int q = 0; q < 6; ++q) box[q] = s_box[q][j];
        if (enters(r, box, t_min, b.t)) {
          visit(r, clus, cid, t_min, amask, b);
          done = nee && b.tri >= 0;
        }
      }
    }
  }

  float* w = out + (size_t)i * 8;
  w[0] = b.t;
  w[1] = b.u;
  w[2] = b.v;
  w[3] = b.back ? 1.f : 0.f;
  w[4] = __int_as_float(b.tri);
  w[5] = (float)b.n_clus;
  w[6] = (float)b.n_tris;
  w[7] = (float)b.n_mask;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// n must be a multiple of 128 (the wrapper pads). n_clus traversal
// clusters; clus_src, clus_inst, clus_fid and inst_flat are null for a
// scene without instances.
extern "C" int fused_trace_launch(const float* rays, const int32_t* slots, int n,
                                  const float* clus_box, int cpad, const float* pack,
                                  const int32_t* count, int n_clus, int c,
                                  const int32_t* clus_src, const int32_t* clus_inst,
                                  const int32_t* clus_fid, const float* inst_flat,
                                  const int32_t* blive, float t_min, int nee, int amask,
                                  float* out, cudaStream_t stream) {
  if (n > 0) {
    const Clusters k = {pack, count, c, clus_src, clus_inst, clus_fid, inst_flat};
    fused_trace_kernel<<<n / kThreads, kThreads, 0, stream>>>(rays, slots, clus_box, cpad, k,
                                                              n_clus, blive, t_min, nee, amask,
                                                              out);
  }
  return (int)cudaGetLastError();
}
