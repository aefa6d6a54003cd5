// The fused per-bounce shade tail for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel yart_tpu/kernels/pallas_shade.py `shade_pallas`
// (its pallas_call at :168): per lane, shade_math's `candidates` (frames,
// VNDF half-vectors, candidate directions), the multiscatter LUT fetches,
// and `finish` (one-sample lobe pick, emitted MIS, NEE f/pdf, throughput,
// volume attenuation, roulette, next state). Its plain twin is
// yart_tpu_torch/kernels/shade_math.py `shade`, which the kernel repeats
// float operation by float operation, in the twin's order, so the two
// agree bitwise on the card. The rules that follow from PyTorch's CUDA
// ops: `t / python_float` is t * float(1 / s); `python_float / t` is
// (1 / t) * s; clamp / maximum return a NaN operand; constants are
// float(double) casts (the F() macro below).
//
// Design (not the TPU kernel's, which packs ~85 rows into one [F, Nsub,
// 128] array because its vector unit has no per-lane gather):
// - One thread a lane, tiles of 128 lanes on a persistent grid.
//   Inputs are the integrator's own SoA tensors ([N, 3] vectors, [N]
//   scalars, [N] uint8 flags; views with a storage offset too), passed as a
//   struct of pointers and read where each value is first used; outputs go
//   to preallocated [N, 3] / [N] tensors.
// - Instances. The kernel is a template on the warp-uniform flags (NEE =
//   mis && any_lights, and the coat, dielectric, metallic and anisotropy
//   gates); the render paths' and chip_smoke's combinations have their own
//   instance, every other one runs the generic instance, which reads the
//   flags from the arguments.
// - Less code on a warp's path. Without fast math each IEEE divide, square
//   root, sine, cosine and exponential is a long sequence, and inlining every
//   GGX, Fresnel, LUT and frame helper at every call site made a body of
//   ~13,000 SASS instructions that warps at different points walked through
//   the instruction cache. The per-lane math lives in shade_lane.cuh, where
//   those helpers are out of line: one copy shared by every call site,
//   ~3,000-6,000 instructions an instance.
// - Occupancy: 8 blocks of 128 threads an SM (64 registers); the warps
//   hide each other's long dependent chains.
// - Lobe-grouped warps. Each tile lane's one-sample lobe pick (coat,
//   metallic, dielectric, glossy) is made first; where a tile's warps mix
//   live lobes, ballots and prefix counts give consecutive threads lanes of
//   one lobe, dead lanes (neither active nor found, the pass-through state)
//   last. Each thread shades its lane and writes the lane's own outputs, so
//   every output bit is the lane's. Under the coat gate the pick's frame
//   and coat half-vector stay in shared memory for the shading pass.
// - The LUT fetches run in-kernel with ops/lut.py's index arithmetic (a
//   negative coordinate takes the top bin, NaN takes bin 0, the fraction is
//   unclamped), reading the six tables (~54 KB) through the read-only
//   cache, and only where a lane's result uses them.
// - Only the picked lobe's sample is built (the twin builds all and
//   selects; the values are the same).
// - Dead lanes write the pass-through state; the twin zeroes their contrib
//   and shadow_d, so all outputs agree.
//
// Bound on this card: bytes. Per live lane 256 B of inputs (13 vectors,
// 23 scalars, 8 flags; the LUT reads mostly hit cache) and 99 B of
// outputs; the arithmetic (~900 flops and a dozen transcendentals a lane)
// stays under the bytes at 67 TFLOP/s. What the kernel reaches is set by
// latency: long dependent chains of IEEE operations at the occupancy the
// registers allow. Staging a tile's inputs in shared memory with cp.async
// before any math was measured and lost (it serialised each tile's loads
// and its math in a block); it is not kept.
//
// Build with --fmad=false and without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define F(x) ((float)(x))

// Inputs: the field order of kernels/shade.py _ShadeIn (shade_math V3_KEYS,
// F_KEYS, B_KEYS, then the LUTs).
struct ShadeIn {
  const float *o, *d, *n, *p, *atten, *last_p, *base, *emission, *volume_color, *ls_wi, *ls_Li,
      *ls_n, *ls_p;
  const float *last_pdf, *acc_rough, *hit_t, *u0, *u1, *uc, *uc2, *u_rr, *metallic, *roughness,
      *roughness_base, *transmission, *ior, *anisotropic, *aniso_rotation, *clearcoat,
      *cc_roughness, *cc_roughness_base, *volume_density, *pdf_area, *sel_p, *ls_pdf, *ls_select_p;
  const uint8_t *active, *found, *specular_prev, *light_neg, *hit_back, *thin, *ls_valid,
      *ls_is_env;
  const float *ggx_E, *ggx_Eavg, *ggx_base_E, *ggx_base_Eavg, *ggx_glass_E, *ggx_glass_inv_E;
};

struct ShadeOut {
  float *L_emit, *contrib, *shadow_d, *o, *d, *atten, *last_p;
  float *shadow_tmax, *last_pdf, *acc_rough;
  uint8_t *nee_need, *active, *specular;
};

struct ShadeArgs {
  int n;
  int use_metal, use_diel, use_coat, use_aniso;
  int mis, any_lights, depth0, rr_on;
  float reg_threshold;
  float favg15, favg15_sq;  // float(FAVG15), float(FAVG15 * FAVG15 in double)
};

namespace {

constexpr double kPi = 3.141592653589793;  // math.pi

enum : int {
  ABSORBED = 0, EMITTED = 1, REFLECTED = 2, TRANSMITTED = 4, DIFFUSE = 8, GLOSSY = 16,
  SPECULAR = 32
};

// ---------------------------------------------------------------- scalars

// torch.clamp_min / clamp_max / clamp / maximum on CUDA: a NaN input passes.
__device__ __forceinline__ float cmin0(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float safe_sqrt(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }

// ---------------------------------------------------------------- vectors

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 vsplat(float s) { return V3{s, s, s}; }
__device__ __forceinline__ V3 vadd(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 vsub(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 vmul(V3 a, V3 b) { return V3{a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 vscale(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 vneg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float vdot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 vnormalize(V3 a) {
  const float n2 = vdot(a, a);
  const float inv = n2 > 0.0f ? 1.0f / sqrtf(n2) : 0.0f;
  return vscale(a, inv);
}
__device__ __forceinline__ V3 vmirror(V3 a) { return V3{-a.x, -a.y, a.z}; }
__device__ __forceinline__ V3 reflect_about(V3 wo, V3 wm) {
  const float d2 = vdot(wo, wm) * 2.0f;
  return vsub(vscale(wm, d2), wo);
}

// ---------------------------------------------------------------- structs

struct Frame {
  V3 x, y, z;
};

struct Alphas {
  float x, y;
};

struct Phi {
  float cos2t, sin2t, cos2p, sin2p;
};

struct Outward {
  V3 w;
  bool ok;
};

struct Luts {
  const float *E, *Eavg, *base_E, *base_Eavg, *glass_E, *glass_inv_E;
};

struct Lane {
  V3 n, d, p, base, emission;
  float metallic, roughness, roughness_base, transmission, ior, anisotropic, aniso_rotation;
  float clearcoat, cc_roughness, cc_roughness_base;
  float u0, u1, uc, uc2;
  bool thin;
};

struct Cand {
  Frame frame;
  V3 wo, wo_r, wm, wi_g, wi_d, wi_l, wi_l_r, wm_coat;
  Alphas a, ac;
  bool smooth, regularized;
  float r_s, f0, ior_rel, cr_s;
};

struct Sample {
  int flags;
  V3 f, wi;
  float pdf, roughness;
};

struct NeeFet {
  float eavg_raw, e_o_abs_raw, e_i_l_abs, base_e_o_abs, base_e_i_l, base_eavg_raw;
};

struct Base {
  Frame frame;
  V3 wo;
  bool regularized;
};

// What a lane's lobe pick computes under the coat gate and its shading
// reads again: the frame and wo, the coat's alphas and half-vector.
struct Picked {
  Base b;
  float cr_s;
  Alphas ac;
  V3 wm_coat;
};

// ---------------------------------------------------------------- kernel
//
// A block owns a tile of kTile lanes, one thread a lane, and walks the tiles
// of a persistent grid. Each lane reads its inputs where they are first
// used (the integrator's SoA tensors, passed as a struct of pointers) and
// writes its own output slots.

constexpr int kTile = 128;  // lanes a tile = threads a block (kernels/shade.py SHADE_TILE)
constexpr int kWarps = kTile / 32;
constexpr int kMinBlocks = 8;  // __launch_bounds__' blocks an SM (caps the registers at 64)
constexpr int kIn = 44;   // ShadeIn's per-lane arrays: 13 vectors, 23 scalars, 8 flags
constexpr int kOut = 13;  // ShadeOut's: 7 vectors, 3 scalars, 3 flags

enum InKey : int {
  I_O, I_D, I_N, I_P, I_ATTEN, I_LAST_P, I_BASE, I_EMISSION, I_VOLUME_COLOR, I_LS_WI, I_LS_LI, I_LS_N,
  I_LS_P, I_LAST_PDF, I_ACC_ROUGH, I_HIT_T, I_U0, I_U1, I_UC, I_UC2, I_U_RR, I_METALLIC, I_ROUGHNESS,
  I_ROUGHNESS_BASE, I_TRANSMISSION, I_IOR, I_ANISOTROPIC, I_ANISO_ROTATION, I_CLEARCOAT, I_CC_ROUGHNESS,
  I_CC_ROUGHNESS_BASE, I_VOLUME_DENSITY, I_PDF_AREA, I_SEL_P, I_LS_PDF, I_LS_SELECT_P, I_ACTIVE, I_FOUND,
  I_SPECULAR_PREV, I_LIGHT_NEG, I_HIT_BACK, I_THIN, I_LS_VALID, I_LS_IS_ENV
};
enum OutKey : int {
  O_L_EMIT, O_CONTRIB, O_SHADOW_D, O_O, O_D, O_ATTEN, O_LAST_P, O_SHADOW_TMAX, O_LAST_PDF, O_ACC_ROUGH,
  O_NEE_NEED, O_ACTIVE, O_SPECULAR
};

// The picked lobe of a lane, the order of a grouped tile.
enum : int { KEY_COAT = 0, KEY_METAL = 1, KEY_DIEL = 2, KEY_GLOSSY = 3, KEY_DEAD = 4, kKeys = 5 };

// The per-lane arrays of a call (ShadeIn's first kIn pointers, ShadeOut's).
struct Arrays {
  const char* in[kIn];  // null: not read by this call
  char* out[kOut];
};

// The flags an instance is specialised on: FL >= 0 holds them as bits,
// FL < 0 reads them from the arguments (the generic instance).
enum : int { FL_NEE = 1, FL_COAT = 2, FL_DIEL = 4, FL_METAL = 8, FL_ANISO = 16 };
template <int FL>
struct Gates {
  __device__ static bool nee(const ShadeArgs& a) { return FL < 0 ? (a.mis && a.any_lights) : (FL & FL_NEE) != 0; }
  __device__ static bool coat(const ShadeArgs& a) { return FL < 0 ? a.use_coat != 0 : (FL & FL_COAT) != 0; }
  __device__ static bool diel(const ShadeArgs& a) { return FL < 0 ? a.use_diel != 0 : (FL & FL_DIEL) != 0; }
  __device__ static bool metal(const ShadeArgs& a) { return FL < 0 ? a.use_metal != 0 : (FL & FL_METAL) != 0; }
  __device__ static bool aniso(const ShadeArgs& a) { return FL < 0 ? a.use_aniso != 0 : (FL & FL_ANISO) != 0; }
};

// Lane i's inputs, each loaded where it is used.
struct Acc {
  const Arrays& s;
  int i;
  __device__ float f(int k) const { return reinterpret_cast<const float*>(s.in[k])[i]; }
  __device__ V3 v(int k) const {
    const float* p = reinterpret_cast<const float*>(s.in[k]) + 3 * (size_t)i;
    return V3{p[0], p[1], p[2]};
  }
  __device__ bool b(int k) const { return s.in[k][i] != 0; }
};


struct LaneOut {
  V3 L_emit, contrib, shadow_d, o, d, atten, last_p;
  float shadow_tmax, last_pdf, acc_rough;
  bool nee_need, active, specular;
};

#include "shade_lane.cuh"

// One lane's outputs.
__device__ void store_lane(const Arrays& s, int i, const LaneOut& r) {
  const V3* v[7] = {&r.L_emit, &r.contrib, &r.shadow_d, &r.o, &r.d, &r.atten, &r.last_p};
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    float* p = reinterpret_cast<float*>(s.out[k]) + 3 * (size_t)i;
    p[0] = v[k]->x;
    p[1] = v[k]->y;
    p[2] = v[k]->z;
  }
  reinterpret_cast<float*>(s.out[O_SHADOW_TMAX])[i] = r.shadow_tmax;
  reinterpret_cast<float*>(s.out[O_LAST_PDF])[i] = r.last_pdf;
  reinterpret_cast<float*>(s.out[O_ACC_ROUGH])[i] = r.acc_rough;
  s.out[O_NEE_NEED][i] = r.nee_need;
  s.out[O_ACTIVE][i] = r.active;
  s.out[O_SPECULAR][i] = r.specular;
}

// Per-block scratch: the lanes' picks (under the coat gate) and the grouping.
template <bool COAT>  // the picks are kept only where the coat gate can be on
struct Scratch {
  Picked pick[COAT ? kTile : 1];  // by tile lane
  unsigned char key[kTile];
  unsigned char perm[kTile];
  int count[kWarps][kKeys];
};
template <bool COAT>
__device__ __forceinline__ Picked* pick_slot(Scratch<COAT>& x, int lane) {
  return x.pick + (COAT ? lane : 0);
}

// The tile lane this thread shades and its key. Grouped: each tile lane's
// key is found first (dead past the tile's end), and ballots count each key
// by warp. A tile where no warp holds two live lobes keeps its lane order
// (dead lanes only idle in a live warp); otherwise prefix sums place the
// lanes of one key on consecutive threads (keys in order, lanes in order
// within a key, dead lanes last).
template <int FL, class X>
__device__ int tile_lane(const ShadeArgs& a, const Luts& t, const Arrays& s, int base, int cnt, X& x,
                         int* key_out) {
  const int tid = threadIdx.x;
  int key = KEY_DEAD;
  if (tid < cnt) {
    const Acc A{s, base + tid};
    if (A.b(I_ACTIVE) || A.b(I_FOUND)) key = pick_lobe<FL>(a, t, A, pick_slot(x, tid));
  }
  *key_out = key;
  const int w = tid >> 5, l = tid & 31;
  int rank = 0, lobes = 0;
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    const unsigned m = __ballot_sync(0xffffffffu, key == k);
    if (l == 0) x.count[w][k] = __popc(m);
    if (key == k) rank = __popc(m & ((1u << l) - 1u));
    lobes += k != KEY_DEAD && m != 0u;
  }
  x.key[tid] = (unsigned char)key;
  if (!__syncthreads_or(lobes > 1)) return tid;
  int pos = rank;
  for (int k = 0; k < key; ++k)
    for (int w2 = 0; w2 < kWarps; ++w2) pos += x.count[w2][k];
  for (int w2 = 0; w2 < w; ++w2) pos += x.count[w2][key];
  x.perm[pos] = (unsigned char)tid;
  __syncthreads();
  const int lane = x.perm[tid];
  *key_out = x.key[lane];
  return lane;
}

template <int FL>
__global__ void __launch_bounds__(kTile, kMinBlocks)
shade_kernel(const __grid_constant__ Luts t, const __grid_constant__ ShadeArgs a,
             const __grid_constant__ Arrays s, int n_tiles) {
  __shared__ Scratch<(FL < 0 || (FL & FL_COAT) != 0)> x;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * kTile;
    const int cnt = min(kTile, a.n - base);
    int key;
    const int lane = tile_lane<FL>(a, t, s, base, cnt, x, &key);
    if (lane < cnt) {
      const Acc A{s, base + lane};
      store_lane(s, base + lane,
                 key == KEY_DEAD ? pass_through(A) : shade_lane<FL>(a, t, A, key, *pick_slot(x, lane)));
    }
    __syncthreads();  // the scratch is free for the next tile
  }
}

// The instances: the generic one, and the flag combinations of the render
// paths (cornell-mat, atrium-ivy, roadster with NEE), of the all-gates
// cases (with and without NEE) and NEE alone.
using KernelFn = void (*)(Luts, ShadeArgs, Arrays, int);
constexpr int kSpecialised[] = {FL_NEE | FL_DIEL | FL_METAL,
                                FL_NEE | FL_METAL,
                                FL_NEE | FL_COAT | FL_DIEL | FL_METAL,
                                FL_NEE | FL_COAT | FL_DIEL | FL_METAL | FL_ANISO,
                                FL_COAT | FL_DIEL | FL_METAL | FL_ANISO,
                                FL_NEE};
constexpr int kInstances = 1 + (int)(sizeof(kSpecialised) / sizeof(int));
const KernelFn kKernels[kInstances] = {
    shade_kernel<-1>, shade_kernel<kSpecialised[0]>, shade_kernel<kSpecialised[1]>, shade_kernel<kSpecialised[2]>,
    shade_kernel<kSpecialised[3]>, shade_kernel<kSpecialised[4]>, shade_kernel<kSpecialised[5]>};

int instance(const ShadeArgs& a) {
  const int fl = ((a.mis && a.any_lights) ? FL_NEE : 0) | (a.use_coat ? FL_COAT : 0) |
                 (a.use_diel ? FL_DIEL : 0) | (a.use_metal ? FL_METAL : 0) | (a.use_aniso ? FL_ANISO : 0);
  for (int i = 0; i < kInstances - 1; ++i)
    if (kSpecialised[i] == fl) return i + 1;
  return 0;
}

// Per device, the SM count and each kernel's resident blocks (queried at
// its first launch).
struct Occupancy {
  int dev = -1, sms = 0;
  int bps[kInstances] = {};  // 0: not queried yet
};

int blocks_per_sm(Occupancy& occ, int inst) {
  int& b = occ.bps[inst];
  if (b == 0) {
    const KernelFn fn = kKernels[inst];
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, fn, kTile, 0) != cudaSuccess) b = 0;
  }
  return b;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int shade_launch(ShadeIn in, ShadeOut out, ShadeArgs args, cudaStream_t stream) {
  if (args.n <= 0) return (int)cudaGetLastError();
  static Occupancy occ;
  int dev = 0;
  cudaGetDevice(&dev);
  if (occ.dev != dev) {
    occ = Occupancy();
    occ.dev = dev;
    cudaDeviceGetAttribute(&occ.sms, cudaDevAttrMultiProcessorCount, dev);
  }
  Arrays s;
  const char* const* ins = reinterpret_cast<const char* const*>(&in);  // ShadeIn's first kIn fields
  char* const* outs = reinterpret_cast<char* const*>(&out);
  for (int k = 0; k < kIn; ++k) s.in[k] = ins[k];
  for (int k = 0; k < kOut; ++k) s.out[k] = outs[k];
  const int n_tiles = (args.n + kTile - 1) / kTile;
  const int inst = instance(args);
  const int bps = blocks_per_sm(occ, inst);
  if (bps <= 0) return (int)cudaErrorInvalidConfiguration;
  const int blocks = n_tiles < occ.sms * bps ? n_tiles : occ.sms * bps;
  const KernelFn fn = kKernels[inst];
  const Luts t{in.ggx_E, in.ggx_Eavg, in.ggx_base_E, in.ggx_base_Eavg, in.ggx_glass_E, in.ggx_glass_inv_E};
  fn<<<blocks, kTile, 0, stream>>>(t, args, s, n_tiles);
  return (int)cudaGetLastError();
}

// Resident blocks an SM of the generic instance (reported beside the
// kernel's times).
extern "C" int shade_occupancy(void) {
  int bps = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, kKernels[0], kTile, 0) != cudaSuccess) return 0;
  return bps;
}
