// One bounce's 8 sampler dimensions per lane for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel yart_tpu/kernels/pallas_shade.py `draws_pallas`
// (its pallas_call at :283): u0, u1 (2D at dim0), uc (+2), uc2 (+3), uc_l
// (+4), ul0, ul1 (2D at +5) and u_rr (+7), bit-exact with the port's
// ops/qmc.py draws (its ZSobol + FastOwen sampler and the hash sampler),
// which are this kernel's plain twin (kernels/shade.py draws_plain).
//
// Design
// - One thread per lane, 256 threads per block; N may be any size.
// - ZSobol: the lane state is the port's 64-bit Morton sample key, read as
//   uint64 (the TPU kernel splits it into two u32 rows). The 14
//   per-bounce constants (perm_c at d0, +2, +3, +4, +5, +7; seed_2d_a/b at
//   d0 and d0 + 5; seed_1d at +2, +3, +4, +7), the digit count, log2spp
//   and the truncated Sobol' dimension-1 columns arrive in one argument
//   struct; the 24 packed S4 permutations are a __constant__ table.
//   mix_bits64, the 64-bit shifts and the `% 24` are 64-bit integer ops;
//   odd log2spp takes the pow2_samples branch of sampler.hpp:155-173.
// - Hash: mix32(state ^ (dim * 0xC2B2AE35)) with the products prefolded.
// - u32 -> float rounds as qmc.py u32_to_unit_float does: two exact 16-bit
//   halves, one rounding add, clamp to 1 - 2^-24 (needs --fmad=false).
//
// Bound on this card: integer work. Per lane and ZSobol draw, every base-4
// digit runs one mix_bits64 (two 64-bit multiplies, 3 IMADs each as 32-bit
// IMADs); six index computations of ~11 digits, plus the scrambles and
// the 2D draws' matrix columns. Outputs are 32 B a lane, inputs 8 B.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxCols = 52;

// Per-bounce arguments (kernels/shade.py _DrawArgs has the same layout).
struct DrawArgs {
  int kind;  // 0 = zsobol, 1 = hash
  int n_base4_digits;
  int log2spp;
  int n_cols;  // columns of the truncated Sobol' dimension-1 matrix
  uint32_t consts[14];
  uint32_t matrix1[kMaxCols];
};

namespace {

constexpr int kThreads = 256;
constexpr int kDraws = 8;

// The 24 permutations of sampler.hpp:115-140, 2 bits per digit.
__constant__ uint8_t kPermPacked[24] = {
    228, 180, 216, 120, 108, 156, 225, 177, 201, 57,  45,  141,
    198, 54,  210, 114, 78,  30,  39,  135, 27,  75,  99,  147};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint64_t mix_bits64(uint64_t v) {
  v ^= v >> 31;
  v *= 0x7FB5D329728EA185ull;
  v ^= v >> 27;
  v *= 0x81DADEF4BC2DD44Dull;
  v ^= v >> 33;
  return v;
}

__device__ __forceinline__ uint32_t reverse_bits32(uint32_t n) { return __brev(n); }

__device__ __forceinline__ uint32_t fast_owen(uint32_t v, uint32_t seed) {
  v = reverse_bits32(v);
  v ^= v * 0x3D20ADEAu;
  v += seed;
  v *= (seed >> 16) | 1u;
  v ^= v * 0x05526C56u;
  v ^= v * 0x53A22864u;
  return reverse_bits32(v);
}

__device__ __forceinline__ float u32_to_unit_float(uint32_t v) {
  const float hi = (float)(v >> 16);
  const float lo = (float)(v & 0xFFFFu);
  const float f = (hi * 65536.0f + lo) * 2.3283064365386963e-10f;  // 2^-32
  return fminf(f, 0x1.fffffep-1f);  // ONE_MINUS_EPS
}

// Base-4 digit permutation of the Morton key (sampler.hpp:155-173).
__device__ uint64_t sample_index(uint64_t morton, uint32_t perm_c, int n_digits, int log2spp) {
  const int last = log2spp & 1;
  uint64_t out = 0;
  for (int i = n_digits - 1; i >= last; --i) {
    const int shift = 2 * i - last;
    const uint64_t digit = (morton >> shift) & 3u;
    const uint64_t higher = morton >> (shift + 2);
    const uint64_t p = (mix_bits64(higher ^ (uint64_t)perm_c) >> 24) % 24u;
    const uint64_t d = (kPermPacked[p] >> (digit * 2)) & 3u;
    out |= d << shift;
  }
  if (last) {
    const uint64_t mixed = mix_bits64((morton >> 1) ^ (uint64_t)perm_c);
    out |= (morton & 1u) ^ (mixed & 1u);
  }
  return out;
}

__device__ float zsobol_1d(uint64_t morton, uint32_t perm_c, uint32_t seed, const DrawArgs& a) {
  const uint64_t idx = sample_index(morton, perm_c, a.n_base4_digits, a.log2spp);
  return u32_to_unit_float(fast_owen(reverse_bits32((uint32_t)idx), seed));
}

__device__ void zsobol_2d(uint64_t morton, uint32_t perm_c, uint32_t seed_a, uint32_t seed_b,
                          const DrawArgs& a, float* ua, float* ub) {
  const uint64_t idx = sample_index(morton, perm_c, a.n_base4_digits, a.log2spp);
  const uint32_t va = reverse_bits32((uint32_t)idx);
  uint32_t vb = 0;
  for (int i = 0; i < a.n_cols; ++i) vb ^= (uint32_t)((idx >> i) & 1u) * a.matrix1[i];
  *ua = u32_to_unit_float(fast_owen(va, seed_a));
  *ub = u32_to_unit_float(fast_owen(vb, seed_b));
}

__global__ void __launch_bounds__(kThreads)
draws_kernel(const uint64_t* __restrict__ state, int n, DrawArgs a, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float r[kDraws];
  if (a.kind == 0) {
    const uint64_t m = state[i];
    const uint32_t* c = a.consts;
    zsobol_2d(m, c[0], c[6], c[7], a, &r[0], &r[1]);  // u0, u1 at d0
    r[2] = zsobol_1d(m, c[1], c[10], a);             // uc at +2
    r[3] = zsobol_1d(m, c[2], c[11], a);             // uc2 at +3
    r[4] = zsobol_1d(m, c[3], c[12], a);             // uc_l at +4
    zsobol_2d(m, c[4], c[8], c[9], a, &r[5], &r[6]);  // ul0, ul1 at +5
    r[7] = zsobol_1d(m, c[5], c[13], a);             // u_rr at +7
  } else {
    const uint32_t s = (uint32_t)state[i];
#pragma unroll
    for (int k = 0; k < kDraws; ++k) r[k] = u32_to_unit_float(mix32(s ^ a.consts[k]));
  }
#pragma unroll
  for (int k = 0; k < kDraws; ++k) out[(size_t)k * n + i] = r[k];
}

}  // namespace

// Writes out [8, n] (rows u0, u1, uc, uc2, uc_l, ul0, ul1, u_rr). Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int draws_launch(const uint64_t* state, int n, DrawArgs args, float* out,
                            cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    draws_kernel<<<blocks, kThreads, 0, stream>>>(state, n, args, out);
  }
  return (int)cudaGetLastError();
}
