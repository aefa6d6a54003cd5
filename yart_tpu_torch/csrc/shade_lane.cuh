// The per-lane math of B5 (csrc/shade.cu): frames, GGX, Fresnel, the LUT
// fetches, the four lobes' samples and NEE f/pdf, and a lane's whole bounce
// tail. The frame, GGX, Fresnel and LUT helpers are out of line (HELPER):
// one copy serves every call site, which keeps each kernel instance's code
// small. shade.cu includes this file, whose structs it defines; nothing here
// is compiled on its own.

#define HELPER __device__ __noinline__

// ---------------------------------------------------------------- frames

HELPER V3 shading_tangent(V3 n) {
  const V3 tg = vnormalize(vcross(n, v3(0.0f, 1.0f, 0.0f)));
  return fabsf(n.y) > F(0.999) ? v3(1.0f, 0.0f, 0.0f) : tg;
}

HELPER Frame frame_from_normal_tangent(V3 n, V3 t) {
  const bool big = fabsf(n.x) > 0.5f;
  const V3 a = big ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  const V3 fy = vnormalize(vcross(n, a));
  const V3 fx = vcross(n, fy);
  const V3 y = vnormalize(vcross(n, t));
  const V3 x = vcross(y, n);
  const bool degen = fabsf(vdot(t, n)) > F(0.9);
  return Frame{degen ? fx : x, degen ? fy : y, n};
}

__device__ __forceinline__ V3 world_to_local(V3 v, const Frame& f) {
  return v3(vdot(v, f.x), vdot(v, f.y), vdot(v, f.z));
}
__device__ __forceinline__ V3 local_to_world(V3 v, const Frame& f) {
  return v3(v.x * f.x.x + v.y * f.y.x + v.z * f.z.x, v.x * f.x.y + v.y * f.y.y + v.z * f.z.y,
            v.x * f.x.z + v.y * f.y.z + v.z * f.z.z);
}
HELPER V3 rot_z(V3 v, float angle) {
  const float c = cosf(angle);
  const float s = sinf(angle);
  return v3(c * v.x - s * v.y, s * v.x + c * v.y, v.z);
}

// ---------------------------------------------------------------- GGX

__device__ __forceinline__ Alphas make_alphas(float r, bool aniso, float an) {
  const float alpha = r * r;
  if (!aniso) return Alphas{alpha, alpha};
  const float aspect = sqrtf(1.0f - an * F(0.9));
  return Alphas{alpha / aspect, alpha * aspect};
}
__device__ __forceinline__ bool ggx_smooth(Alphas a) {
  return a.x < F(1e-3) && a.y < F(1e-3);
}

__device__ __forceinline__ Phi phi_terms(V3 w) {
  Phi r;
  r.cos2t = w.z * w.z;
  r.sin2t = cmin0(1.0f - r.cos2t, 0.0f);
  const float safe = r.sin2t > F(1e-20) ? r.sin2t : 1.0f;
  const bool z = r.sin2t == 0.0f;
  r.cos2p = z ? 1.0f : w.x * w.x / safe;
  r.sin2p = z ? 0.0f : w.y * w.y / safe;
  return r;
}

HELPER float ggx_mdf(Alphas a, V3 w) {
  const Phi t = phi_terms(w);
  const bool ok = t.cos2t > F(1e-12);
  const float tan2t = (ok ? t.sin2t : 0.0f) / (ok ? t.cos2t : 1.0f);
  const float cos4t = ok ? t.cos2t * t.cos2t : 1.0f;
  const float ax = cmin0(a.x, F(1e-4));
  const float ay = cmin0(a.y, F(1e-4));
  const float k = tan2t * (t.cos2p / (ax * ax) + t.sin2p / (ay * ay));
  const float k2 = (1.0f + k) * (1.0f + k);
  const float d = 1.0f / (ax * F(kPi) * ay * cos4t * k2);
  return ok ? d : 0.0f;
}

HELPER float ggx_lambda(Alphas a, V3 w) {
  const Phi t = phi_terms(w);
  const bool ok = t.cos2t > F(1e-12);
  const float tan2t = (ok ? t.sin2t : 0.0f) / (ok ? t.cos2t : 1.0f);
  const float alpha2 = a.x * a.x * t.cos2p + a.y * a.y * t.sin2p;
  const float lam = (sqrtf(1.0f + alpha2 * tan2t) - 1.0f) * 0.5f;
  return ok ? lam : F(1e20);
}

__device__ __forceinline__ float ggx_g1(Alphas a, V3 w) { return 1.0f / (1.0f + ggx_lambda(a, w)); }
__device__ __forceinline__ float ggx_g(Alphas a, V3 wo, V3 wi) {
  return 1.0f / (1.0f + ggx_lambda(a, wo) + ggx_lambda(a, wi));
}
HELPER float ggx_vmdf(Alphas a, V3 w, V3 wm) {
  return ggx_g1(a, w) / cmin0(fabsf(w.z), F(1e-20)) * ggx_mdf(a, wm) * fabsf(vdot(w, wm));
}

HELPER V3 sample_visible(Alphas al, V3 w, float u0, float u1) {
  const float ax = cmin0(al.x, F(1e-4));
  const float ay = cmin0(al.y, F(1e-4));
  V3 wh = vnormalize(v3(ax * w.x, ay * w.y, w.z));
  wh = wh.z < 0.0f ? vneg(wh) : wh;
  const V3 b_raw = vnormalize(vcross(v3(0.0f, 0.0f, 1.0f), wh));
  const V3 b = wh.z < F(0.9999) ? b_raw : v3(1.0f, 0.0f, 0.0f);
  const V3 t = vcross(wh, b);
  // sample_disk_uniform
  const float r = sqrtf(u0);
  const float theta = u1 * F(2.0 * kPi);
  const float px = r * cosf(theta);
  const float py0 = r * sinf(theta);
  const float h = safe_sqrt(1.0f - px * px);
  const float mix = wh.z * 0.5f + 0.5f;
  const float py = h + (py0 - h) * mix;
  const float pz = safe_sqrt(1.0f - px * px - py * py);
  const V3 nh = vadd(vadd(vscale(b, px), vscale(t, py)), vscale(wh, pz));
  return vnormalize(v3(ax * nh.x, ay * nh.y, cmin0(nh.z, F(1e-6))));
}

HELPER V3 sample_cosine_hemisphere(float u0, float u1) {
  const float phi = u0 * 2.0f * F(kPi);
  const float sqrt_r2 = sqrtf(u1);
  return v3(cosf(phi) * sqrt_r2, sinf(phi) * sqrt_r2, safe_sqrt(1.0f - u1));
}

// ---------------------------------------------------------------- Fresnel

// `inv_ior` is the value the twin's where(below, 1 / ior, ior) takes below
// the surface: 1.0f / ior for a tensor ior, float(1 / 1.5) for the coat's.
HELPER float fresnel_dielectric(float cos_theta, float ior_in, float inv_ior) {
  cos_theta = clampf(cos_theta, -1.0f, 1.0f);
  const bool below = cos_theta < 0.0f;
  const float ior = below ? inv_ior : ior_in;
  cos_theta = fabsf(cos_theta);
  const float sin2 = 1.0f - cos_theta * cos_theta;
  const float sin2_t = sin2 / (ior * ior);
  const bool tir = sin2_t >= 1.0f;
  const float cos_t = safe_sqrt(1.0f - sin2_t);
  const float r_prl = (ior * cos_theta - cos_t) / (ior * cos_theta + cos_t + F(1e-20));
  const float r_per = (cos_theta - ior * cos_t) / (cos_theta + ior * cos_t + F(1e-20));
  const float f = 0.5f * (r_prl * r_prl + r_per * r_per);
  return tir ? 1.0f : f;
}
__device__ __forceinline__ float fresnel_t(float c, float ior) {
  return fresnel_dielectric(c, ior, 1.0f / ior);
}
__device__ __forceinline__ float fresnel_coat(float c) {
  return fresnel_dielectric(c, 1.5f, F(1.0 / 1.5));
}

__device__ __forceinline__ V3 fresnel_schlick3(V3 f0, float cos_theta) {
  const float m = 1.0f - cos_theta;
  const float m5 = (m * m) * (m * m) * m;
  return v3(f0.x + (1.0f - f0.x) * m5, f0.y + (1.0f - f0.y) * m5, f0.z + (1.0f - f0.z) * m5);
}

HELPER V3 refract(V3 wi, V3 n, float ior, bool* tir) {
  float cos_theta = vdot(wi, n);
  const bool below = cos_theta < 0.0f;
  const float eta = below ? 1.0f / ior : ior;
  cos_theta = fabsf(cos_theta);
  const V3 nn = below ? vneg(n) : n;
  const float sin2 = cmin0(1.0f - cos_theta * cos_theta, 0.0f);
  const float sin2_t = sin2 / (eta * eta);
  *tir = sin2_t >= 1.0f;
  const float cos_t = safe_sqrt(1.0f - sin2_t);
  return vadd(vscale(vneg(wi), 1.0f / eta), vscale(nn, cos_theta / eta - cos_t));
}

HELPER Outward outward(V3 wm) {
  const float n2 = vdot(wm, wm);
  const bool ok = n2 > F(1e-20);
  const float n2m = ok ? n2 : 1.0f;
  V3 w = vscale(wm, ok ? 1.0f / sqrtf(n2m) : 0.0f);
  w = w.z < 0.0f ? vneg(w) : w;
  return Outward{w, ok};
}

__device__ __forceinline__ float safe_div(float a, float b, double eps) {
  const bool small = fabsf(b) < F(eps);
  const float bb = small ? (b < 0.0f ? F(-eps) : F(eps)) : b;
  return a / bb;
}

__device__ __forceinline__ float favg_fit(float ior) {
  return (ior - 1.0f) / (ior * F(1.00071) + F(4.08567));
}

__device__ __forceinline__ float roughen(float r) {
  return tmax(r, clampf(r * 2.0f, F(0.1), F(0.3)));
}

// ---------------------------------------------------------------- LUTs
// ops/lut.py: idx = min(int(x * (n - 1)), n - 2), a negative coordinate
// takes the top bin, NaN takes bin 0, the fraction is unclamped.

__device__ __forceinline__ void ref_index(float x, int n, int* idx, float* frac) {
  const float xo = x * F(n - 1.0);
  const float safe = isnan(xo) ? 0.0f : xo;
  const int i = safe < 0.0f ? n - 2 : (int)fminf(fmaxf(safe, 0.0f), F(n - 2.0));
  *idx = i;
  *frac = xo - (float)i;
}

HELPER float fetch_1d(const float* tab, int n, float x) {
  int i;
  float f;
  ref_index(x, n, &i, &f);
  return __ldg(tab + i) * (1.0f - f) + __ldg(tab + i + 1) * f;
}

HELPER float fetch_2d(const float* tab, int n0, int n1, float x0, float x1) {
  int i0, i1;
  float f0, f1;
  ref_index(x0, n0, &i0, &f0);
  ref_index(x1, n1, &i1, &f1);
  const float g0 = 1.0f - f0;
  const float r0 = __ldg(tab + i0 * n1 + i1) * g0 + __ldg(tab + (i0 + 1) * n1 + i1) * f0;
  const float r1 = __ldg(tab + i0 * n1 + i1 + 1) * g0 + __ldg(tab + (i0 + 1) * n1 + i1 + 1) * f0;
  return r0 * (1.0f - f1) + r1 * f1;
}

HELPER float fetch_3d(const float* tab, int n, float x0, float x1, float x2) {
  int i0, i1, i2;
  float f0, f1, f2;
  ref_index(x0, n, &i0, &f0);
  ref_index(x1, n, &i1, &f1);
  ref_index(x2, n, &i2, &f2);
  const int s0 = n * n;
  const float g0 = 1.0f - f0;
  const float w1[2] = {1.0f - f1, f1};
  const float w2[2] = {1.0f - f2, f2};
  float out = 0.0f;
#pragma unroll
  for (int dj = 0; dj < 2; ++dj) {
#pragma unroll
    for (int dk = 0; dk < 2; ++dk) {
      const int off = (i1 + dj) * n + (i2 + dk);
      const float a = __ldg(tab + i0 * s0 + off) * g0 + __ldg(tab + (i0 + 1) * s0 + off) * f0;
      const float term = a * w1[dj] * w2[dk];
      out = (dj == 0 && dk == 0) ? term : out + term;
    }
  }
  return out;
}

__device__ __forceinline__ float lut_e(const Luts& t, float cos_theta, float r) {
  return fetch_2d(t.E, 32, 32, r, cos_theta);
}
__device__ __forceinline__ float lut_eavg(const Luts& t, float r) { return fetch_1d(t.Eavg, 32, r); }
__device__ __forceinline__ float lut_base_e(const Luts& t, float f0, float r, float cos_theta) {
  return fetch_3d(t.base_E, 16, f0, r, cos_theta);
}
__device__ __forceinline__ float lut_base_eavg(const Luts& t, float f0, float r) {
  return fetch_2d(t.base_Eavg, 16, 16, f0, r);
}
HELPER float lut_glass_e(const Luts& t, float ior, float r, float cos_theta) {
  const bool inv = ior < 1.0f;
  const float x = inv ? 1.0f / cmin0(ior, F(1e-6)) : ior;
  const float f0 = sqrtf(fabsf((x - 1.0f) / (x + 1.0f)));
  return fetch_3d(inv ? t.glass_inv_E : t.glass_E, 16, f0, cos_theta, r);
}

// ---------------------------------------------------------------- lane

// ---------------------------------------------------------------- samples

__device__ Sample sample_metallic(const Lane& L, const Cand& c, const Luts& t) {
  const V3 wo = c.wo_r, wm = c.wm;
  Sample s;
  if (c.smooth) {
    s.flags = REFLECTED | SPECULAR;
    s.f = vscale(fresnel_schlick3(L.base, wo.z), 1.0f / cmin0(fabsf(wo.z), F(1e-12)));
    s.wi = vmirror(wo);
    s.pdf = 1.0f;
    s.roughness = 0.0f;
    return s;
  }
  const V3 wi = c.wi_g;
  const bool valid = wo.z * wi.z >= 0.0f;
  const float pdf = ggx_vmdf(c.a, wo, wm) / cmin0(fabsf(vdot(wo, wm)) * 4.0f, F(1e-12));
  const float cos_o = fabsf(wo.z);
  const float cos_i = fabsf(wi.z);
  const V3 fss = fresnel_schlick3(L.base, fabsf(vdot(wo, wm)));
  const float m_scalar =
      ggx_mdf(c.a, wm) * ggx_g(c.a, wo, wi) / cmin0(cos_o * 4.0f * cos_i, F(1e-12));
  const V3 mss = vscale(fss, m_scalar);
  const float ess = cmin0(lut_e(t, fabsf(c.wo_r.z), c.r_s), F(1e-4));
  const float ms_gain = (1.0f - ess) / ess;
  const V3 f = vmul(mss, vadd(vsplat(1.0f), vscale(L.base, ms_gain)));
  s.flags = valid ? (REFLECTED | GLOSSY) : ABSORBED;
  s.f = valid ? f : vsplat(0.0f);
  s.wi = wi;
  s.pdf = pdf;
  s.roughness = L.roughness_base;
  return s;
}

__device__ Sample sample_dielectric(const Lane& L, const Cand& c, const Luts& t) {
  const V3 wo = c.wo_r, wm = c.wm;
  const float ior = L.ior;
  const float ior_rel = c.ior_rel;
  Sample s;
  if (c.smooth) {
    const float f_spec = fresnel_t(fabsf(wo.z), ior_rel);
    const bool refl_s = L.uc < f_spec;
    const V3 wi_s_refl = vmirror(wo);
    bool tir_s;
    V3 wi_s_refr = refract(wo, v3(0.0f, 0.0f, 1.0f), ior, &tir_s);
    wi_s_refr = L.thin ? vneg(wo) : wi_s_refr;
    tir_s = tir_s && !L.thin;
    const float t_spec = 1.0f - f_spec;
    s.wi = refl_s ? wi_s_refl : wi_s_refr;
    s.f = refl_s ? vsplat(f_spec / cmin0(fabsf(wi_s_refl.z), F(1e-12)))
                 : vscale(L.base, t_spec / cmin0(fabsf(wi_s_refr.z), F(1e-12)));
    s.pdf = refl_s ? f_spec : t_spec;
    s.flags = refl_s ? (REFLECTED | SPECULAR) : (tir_s ? ABSORBED : (TRANSMITTED | SPECULAR));
    s.roughness = 0.0f;
    return s;
  }
  const float dot_wo_wm = vdot(wo, wm);
  const float fss = fresnel_t(fabsf(dot_wo_wm), ior_rel);
  const float cos_o = fabsf(wo.z);
  const float e_o = cmin0(lut_glass_e(t, ior_rel, c.r_s, fabsf(c.wo_r.z)), F(1e-4));
  const bool refl = L.uc < fss;
  const float vm = ggx_vmdf(c.a, wo, wm) / cmin0(fabsf(dot_wo_wm) * 4.0f, F(1e-12));
  s.roughness = c.r_s;
  if (refl) {
    const V3 wi_r = c.wi_g;
    const bool ok_r = wo.z * wi_r.z >= 0.0f;
    const float cos_i_r = fabsf(wi_r.z);
    const float mss_r =
        ggx_mdf(c.a, wm) * ggx_g(c.a, wo, wi_r) / cmin0(cos_o * 4.0f * cos_i_r, F(1e-12));
    s.wi = wi_r;
    s.f = vsplat(fss * mss_r / e_o);
    s.pdf = vm * fss;
    s.flags = ok_r ? (REFLECTED | GLOSSY) : ABSORBED;
  } else if (L.thin) {
    const V3 wi_thin = v3(c.wi_g.x, c.wi_g.y, -c.wi_g.z);
    const float cos_i_t = fabsf(wi_thin.z);
    const float tss_thin =
        ggx_mdf(c.a, wm) * ggx_g(c.a, wo, wi_thin) / cmin0(cos_o * 4.0f * cos_i_t, F(1e-12));
    s.wi = wi_thin;
    s.f = vscale(L.base, (1.0f - fss) * tss_thin / e_o);
    s.pdf = vm * (1.0f - fss);
    s.flags = TRANSMITTED | GLOSSY;
  } else {
    bool tir;
    const V3 wi_t = refract(wo, wm, ior, &tir);
    const bool bad_t = tir || (wo.z * wi_t.z > 0.0f) || (wi_t.z == 0.0f);
    const float dot_wi_wm = vdot(wi_t, wm);
    const float temp = dot_wi_wm * ior_rel + dot_wo_wm;
    const float dwm_dwi = fabsf(dot_wi_wm) / cmin0(temp * temp, F(1e-12));
    const float pdf_t = ggx_vmdf(c.a, wo, wm) * dwm_dwi * (1.0f - fss);
    const float tss = ggx_mdf(c.a, wm) * ggx_g(c.a, wo, wi_t) *
                      fabsf(safe_div(dot_wi_wm * dot_wo_wm, wi_t.z * wo.z * temp * temp, 1e-20));
    s.wi = wi_t;
    s.f = vscale(L.base, (1.0f - fss) * tss / e_o);
    s.pdf = pdf_t;
    s.flags = bad_t ? ABSORBED : (TRANSMITTED | GLOSSY);
  }
  return s;
}

// The glossy lobe; *le gets its Le (emission on the diffuse branch).
__device__ Sample sample_glossy(const Lane& L, const Cand& c, const Luts& t, V3* le) {
  const V3 wo = c.wo_r, wm = c.wm;
  const float ior = L.ior;
  const float cos_o = wo.z;
  const float favg = favg_fit(ior);
  const float eavg = lut_eavg(t, c.r_s);
  const float fms = favg * favg * eavg / cmin0(1.0f - (1.0f - eavg) * favg, F(1e-6));
  const float e_o = lut_e(t, cos_o, c.r_s);  // RAW sign-carrying cosine
  const float kappa = 1.0f - (favg * e_o + fms * (1.0f - e_o));
  Sample s;
  if (L.uc < kappa) {  // diffuse
    const V3 wi_d = c.wi_d;
    const float e_wo = lut_base_e(t, c.f0, c.r_s, cos_o);
    const float e_wi = lut_base_e(t, c.f0, c.r_s, wi_d.z);
    const float eavg_b = lut_base_eavg(t, c.f0, c.r_s);
    const float c_diffuse = (1.0f - e_wo) * (1.0f - e_wi) / cmin0((1.0f - eavg_b) * F(kPi), F(1e-6));
    s.f = vscale(L.base, c_diffuse);
    s.pdf = fabsf(wi_d.z) * c_diffuse;
    s.flags = vdot(L.emission, L.emission) > 0.0f ? (REFLECTED | DIFFUSE | EMITTED)
                                                   : (REFLECTED | DIFFUSE);
    s.wi = wi_d;
    s.roughness = 1.0f;
    *le = L.emission;
    return s;
  }
  *le = vsplat(0.0f);
  if (c.smooth) {
    const float f_spec = fresnel_t(cos_o, ior);
    s.wi = vmirror(wo);
    s.f = vsplat(f_spec / cmin0(fabsf(s.wi.z), F(1e-12)));
    s.pdf = f_spec;
    s.flags = REFLECTED | SPECULAR;
    s.roughness = 0.0f;
    return s;
  }
  const V3 wi_g = c.wi_g;
  const float cos_i_g = wi_g.z;
  const bool ok_g = cos_o * cos_i_g >= 0.0f;
  const float fss = fresnel_t(vdot(wo, wm), ior);
  const float mss =
      ggx_mdf(c.a, wm) * ggx_g(c.a, wo, wi_g) / cmin0(fabsf(cos_o * 4.0f * cos_i_g), F(1e-12));
  const float e_i = lut_e(t, wi_g.z, c.r_s);
  const float mms = (1.0f - e_o) * (1.0f - e_i) / cmin0((1.0f - eavg) * F(kPi), F(1e-6));
  s.f = ok_g ? vsplat(fss * mss + fms * mms) : vsplat(0.0f);
  s.pdf = ggx_vmdf(c.a, wo, wm) / cmin0(fabsf(vdot(wo, wm)) * 4.0f, F(1e-12)) * fss;
  s.flags = ok_g ? (REFLECTED | GLOSSY) : ABSORBED;
  s.wi = wi_g;
  s.roughness = c.r_s;
  return s;
}

__device__ Sample sample_clearcoat(const Lane& L, const Cand& c) {
  const V3 wo = c.wo, wm = c.wm_coat;
  const float cos_o = wo.z;
  Sample s;
  if (ggx_smooth(c.ac)) {
    // the reference uses the MATERIAL ior here (parametric.cpp:804)
    const float f_spec = fresnel_t(cos_o, L.ior);
    s.wi = vmirror(wo);
    s.f = vsplat(f_spec / cmin0(fabsf(s.wi.z), F(1e-12)));
    s.pdf = f_spec;
    s.flags = REFLECTED | SPECULAR;
    s.roughness = 0.0f;
    return s;
  }
  const V3 wi = reflect_about(wo, wm);
  const bool ok = cos_o * wi.z >= 0.0f;
  const float fss = fresnel_coat(vdot(wo, wm));
  const float mss =
      ggx_mdf(c.ac, wm) * ggx_g(c.ac, wo, wi) / cmin0(fabsf(cos_o * 4.0f * wi.z), F(1e-12));
  s.pdf = fss * ggx_vmdf(c.ac, wo, wm) / cmin0(fabsf(vdot(wo, wm)) * 4.0f, F(1e-12));
  s.f = ok ? vsplat(fss * mss) : vsplat(0.0f);
  s.flags = ok ? (REFLECTED | GLOSSY) : ABSORBED;
  s.wi = wi;
  s.roughness = L.cc_roughness_base;
  return s;
}

// ---------------------------------------------------------------- NEE eval

__device__ V3 f_glossy(const Lane& L, const NeeFet& q, Alphas a, V3 wo, V3 wi) {
  const float cos_o = fabsf(wo.z);
  const float cos_i = fabsf(wi.z);
  const Outward o = outward(vadd(wo, wi));
  const bool ok = o.ok && cos_o > 0.0f && cos_i > 0.0f;
  if (!ok) return vsplat(0.0f);
  const bool rough_ok = !ggx_smooth(a);
  const V3 wm = o.w;
  const float favg = favg_fit(L.ior);
  const float eavg = q.eavg_raw;
  const float c_diffuse = (1.0f - q.base_e_o_abs) * (1.0f - q.base_e_i_l) /
                          cmin0((1.0f - q.base_eavg_raw) * F(kPi), F(1e-6));
  const V3 diffuse = vscale(L.base, c_diffuse);
  float spec = 0.0f;
  if (rough_ok) {
    const float fss = fresnel_t(vdot(wo, wm), L.ior);
    const float mss = ggx_mdf(a, wm) * ggx_g(a, wo, wi) / cmin0(cos_o * 4.0f * cos_i, F(1e-12));
    const float mms = (1.0f - q.e_o_abs_raw) * (1.0f - q.e_i_l_abs) /
                      cmin0((1.0f - eavg) * F(kPi), F(1e-6));
    const float fms = favg * favg * eavg / cmin0(1.0f - (1.0f - eavg) * favg, F(1e-6));
    spec = fss * mss + mms * fms;
  }
  return vadd(vsplat(spec), diffuse);
}

__device__ float pdf_glossy(const Lane& L, const NeeFet& q, Alphas a, V3 wo, V3 wi) {
  const float cos_i = fabsf(wi.z);
  const Outward o = outward(vadd(wo, wi));
  const float favg = favg_fit(L.ior);
  const float eavg = q.eavg_raw;
  const float fms = favg * favg * eavg / cmin0(1.0f - (1.0f - eavg) * favg, F(1e-6));
  const float e_o = q.e_o_abs_raw;
  const float kappa = 1.0f - (favg * e_o + fms * (1.0f - e_o));
  float spec_pdf = 0.0f;
  if (o.ok && !ggx_smooth(a)) {
    const float fss = fresnel_t(vdot(wo, o.w), L.ior);
    spec_pdf = (fss + fms) * ggx_vmdf(a, wo, o.w) / cmin0(fabsf(vdot(wo, o.w)) * 4.0f, F(1e-12));
  }
  return spec_pdf + cos_i * kappa;
}

__device__ V3 f_metallic(const Lane& L, const NeeFet& q, Alphas a, V3 wo, V3 wi) {
  const float cos_o = fabsf(wo.z);
  const float cos_i = fabsf(wi.z);
  const Outward o = outward(vadd(wo, wi));
  if (!(o.ok && cos_o > 0.0f && cos_i > 0.0f && !ggx_smooth(a))) return vsplat(0.0f);
  const V3 wm = o.w;
  const V3 fss = fresnel_schlick3(L.base, fabsf(vdot(wo, wm)));
  const float m_scalar = ggx_mdf(a, wm) * ggx_g(a, wo, wi) / cmin0(cos_o * 4.0f * cos_i, F(1e-12));
  const V3 mss = vscale(fss, m_scalar);
  const float ess = cmin0(q.e_o_abs_raw, F(1e-4));
  const V3 mms = vscale(vmul(mss, L.base), (1.0f - ess) / ess);
  return vadd(mss, mms);
}

__device__ float pdf_metallic(Alphas a, V3 wo, V3 wi) {
  const Outward o = outward(vadd(wo, wi));
  if (!(o.ok && !ggx_smooth(a))) return 0.0f;
  return ggx_vmdf(a, wo, o.w) / cmin0(fabsf(vdot(wo, o.w)) * 4.0f, F(1e-12));
}

__device__ V3 f_dielectric(const Lane& L, float glass_e_f, Alphas a, V3 wo, V3 wi) {
  const float cos_o = wo.z;
  const float cos_i = wi.z;
  const bool is_refl = cos_o * cos_i > 0.0f;
  const float ior = is_refl ? 1.0f : (cos_o > 0.0f ? L.ior : 1.0f / L.ior);
  const Outward o = outward(vadd(vscale(wi, ior), wo));
  const V3 wm = o.w;
  const bool ok = o.ok && cos_i != 0.0f && cos_o != 0.0f && !ggx_smooth(a) &&
                  vdot(wm, wi) * cos_i >= 0.0f && vdot(wm, wo) * cos_o >= 0.0f;
  if (!ok) return vsplat(0.0f);
  const float fss = fresnel_t(fabsf(vdot(wo, wm)), ior);
  const float tt = 1.0f - fss;
  const float e_o = cmin0(glass_e_f, F(1e-4));
  const float d_g = ggx_mdf(a, wm) * ggx_g(a, wo, wi);
  if (is_refl) {
    const float f_refl = fss * d_g / cmin0(fabsf(cos_o * 4.0f * cos_i), F(1e-12));
    return vsplat(f_refl / e_o);
  }
  float trans_ss;
  if (L.thin) {
    // SIGNED cos_o denominator: the reference's thin-transmission quirk
    const V3 wip = v3(wi.x, wi.y, -wi.z);
    const Outward ot = outward(vadd(wip, wo));
    const float cos_ip = fabsf(wip.z);
    const float tss_thin = ggx_mdf(a, ot.w) * ggx_g(a, wo, wip) * safe_div(1.0f, cos_o * 4.0f * cos_ip, 1e-12);
    trans_ss = ot.ok ? tss_thin : 0.0f;
  } else {
    const float temp = vdot(wi, wm) * ior + vdot(wo, wm);
    const float dwm_dwi = fabsf(vdot(wi, wm)) * fabsf(vdot(wo, wm)) / cmin0(temp * temp, F(1e-12));
    trans_ss = d_g * dwm_dwi / cmin0(fabsf(cos_i * cos_o), F(1e-12));
  }
  const V3 f_trans = vscale(L.base, tt * trans_ss);
  return vscale(f_trans, 1.0f / e_o);
}

__device__ float pdf_dielectric(const Lane& L, Alphas a, V3 wo, V3 wi) {
  const float cos_o = wo.z;
  const float cos_i = wi.z;
  const bool is_refl = cos_o * cos_i > 0.0f;
  const float ior = is_refl ? 1.0f : (cos_o > 0.0f ? L.ior : 1.0f / L.ior);
  const Outward o = outward(vadd(vscale(wi, ior), wo));
  const V3 wm = o.w;
  const bool ok = o.ok && cos_i != 0.0f && cos_o != 0.0f && !ggx_smooth(a) &&
                  vdot(wm, wi) * cos_i >= 0.0f && vdot(wm, wo) * cos_o >= 0.0f;
  if (!ok) return 0.0f;
  // NOTE: signed dot and the MATERIAL ior (parametric.cpp:438-440).
  const float f = fresnel_t(vdot(wo, wm), L.ior);
  const float tt = 1.0f - f;
  if (is_refl) return ggx_vmdf(a, wo, wm) / cmin0(fabsf(vdot(wo, wm)) * 4.0f, F(1e-12)) * f;
  if (L.thin) {
    const V3 wip = v3(wi.x, wi.y, -wi.z);
    const V3 wm_thin = outward(vadd(wip, wo)).w;
    return ggx_vmdf(a, wo, wm_thin) / cmin0(fabsf(vdot(wo, wm_thin)) * 4.0f, F(1e-12)) * tt;
  }
  const float temp2 = vdot(wi, wm) + vdot(wo, wm) / ior;
  const float dwm_dwi2 = fabsf(vdot(wo, wm)) / cmin0(temp2 * temp2, F(1e-12));
  return ggx_vmdf(a, wo, wm) * dwm_dwi2 * tt;
}

// Returns f_scalar; *fc gets Fc.
__device__ float f_clearcoat(Alphas a, V3 wo, V3 wi, float* fc) {
  const float cos_o = fabsf(wo.z);
  const float cos_i = fabsf(wi.z);
  *fc = tmax(fresnel_coat(cos_o), fresnel_coat(cos_i));
  const Outward o = outward(vadd(wo, wi));
  if (!(o.ok && cos_o > 0.0f && cos_i > 0.0f && !ggx_smooth(a))) return 0.0f;
  const float fss = fresnel_coat(vdot(wo, o.w));
  const float mss = ggx_mdf(a, o.w) * ggx_g(a, wo, wi) / cmin0(cos_o * 4.0f * cos_i, F(1e-12));
  return fss * mss;
}

__device__ float pdf_clearcoat(Alphas a, V3 wo, V3 wi, float* fc) {
  *fc = tmax(fresnel_coat(fabsf(wo.z)), fresnel_coat(fabsf(wi.z)));
  const Outward o = outward(vadd(wo, wi));
  if (!(o.ok && !ggx_smooth(a))) return 0.0f;
  const float fss = fresnel_coat(vdot(wo, o.w));
  return fss * ggx_vmdf(a, wo, o.w) / cmin0(fabsf(vdot(wo, o.w)) * 4.0f, F(1e-12));
}

// ---------------------------------------------------------------- lane

// A dead lane (neither active nor found): the pass-through state.
template <class Acc>
__device__ LaneOut pass_through(const Acc& A) {
  LaneOut r;
  r.L_emit = vsplat(0.0f);
  r.contrib = vsplat(0.0f);
  r.shadow_d = vsplat(0.0f);
  r.o = A.v(I_O);
  r.d = A.v(I_D);
  r.atten = A.v(I_ATTEN);
  r.last_p = A.v(I_LAST_P);
  r.shadow_tmax = -1.0f;
  r.last_pdf = A.f(I_LAST_PDF);
  r.acc_rough = A.f(I_ACC_ROUGH) + 0.0f;
  r.nee_need = false;
  r.active = false;
  r.specular = A.b(I_SPECULAR_PREV);
  return r;
}

// The shading frame, wo in it, and the regularization gate of a live lane.
template <class Acc>
__device__ __forceinline__ Base lane_base(const ShadeArgs& a, const Acc& A) {
  Base b;
  const V3 n = A.v(I_N);
  const V3 tg = shading_tangent(n);
  b.frame = frame_from_normal_tangent(n, tg);
  b.wo = world_to_local(vneg(A.v(I_D)), b.frame);
  b.regularized = A.f(I_ACC_ROUGH) > a.reg_threshold;
  return b;
}

// The coat's alphas and half-vector (candidates' coat part).
template <class Acc>
__device__ __forceinline__ void coat_half(const Acc& A, const Base& b, float* cr_s, Alphas* ac, V3* wm_coat) {
  const float ccr = A.f(I_CC_ROUGHNESS);
  *cr_s = b.regularized ? roughen(ccr) : ccr;
  *ac = make_alphas(*cr_s, false, 0.0f);
  *wm_coat = sample_visible(*ac, b.wo, A.f(I_U0), A.f(I_U1));
}

// bsdf_sample_c's one-sample lobe pick of a live lane (the coat's LUT
// fetches only under the coat gate).
template <int FL, class Acc>
__device__ int pick_lobe(const ShadeArgs& a, const Luts& t, const Acc& A, Picked* pk) {
  using G = Gates<FL>;
  float p_coat = 0.0f;
  if (G::coat(a)) {
    pk->b = lane_base(a, A);
    const Base& b = pk->b;
    coat_half(A, b, &pk->cr_s, &pk->ac, &pk->wm_coat);
    const float cr_s = pk->cr_s;
    const V3 wm_coat = pk->wm_coat;
    const float eavg_c = lut_eavg(t, cr_s);
    const float e_o_c = lut_e(t, clampf(fabsf(vdot(b.wo, wm_coat)), 0.0f, 1.0f), cr_s);
    const float fms_c = eavg_c * a.favg15_sq / cmin0(1.0f - (1.0f - eavg_c) * a.favg15, F(1e-6));
    const float kappa_c = 1.0f - (e_o_c * a.favg15 + fms_c * (1.0f - e_o_c));
    p_coat = A.f(I_CLEARCOAT) * (1.0f - kappa_c);
  }
  const float metallic = A.f(I_METALLIC);
  const float p_metal = (1.0f - p_coat) * metallic;
  const float p_diel = (1.0f - p_coat) * (metallic + (1.0f - metallic) * A.f(I_TRANSMISSION));
  const float uc2 = A.f(I_UC2);
  const bool sel_coat = G::coat(a) && uc2 < p_coat;
  const bool sel_metal = G::metal(a) && !sel_coat && uc2 < p_metal;
  const bool sel_diel = G::diel(a) && !sel_coat && !sel_metal && uc2 < p_diel;
  return sel_coat ? KEY_COAT : sel_metal ? KEY_METAL : sel_diel ? KEY_DIEL : KEY_GLOSSY;
}

// The bounce tail of one live lane whose lobe pick is `key` (the previous
// design's per-lane body, float operation by float operation).
template <int FL, class Acc>
__device__ LaneOut shade_lane(const ShadeArgs& a, const Luts& t, const Acc& A, int key, const Picked& pk) {
  using G = Gates<FL>;
  const bool found = A.b(I_FOUND);
  const bool active_in = A.b(I_ACTIVE);
  const bool spec_prev = A.b(I_SPECULAR_PREV);
  const V3 atten = A.v(I_ATTEN);
  const bool nee = G::nee(a);
  const bool aniso = G::aniso(a);

  Lane L;
  L.n = A.v(I_N);
  L.d = A.v(I_D);
  L.p = A.v(I_P);
  L.base = A.v(I_BASE);
  L.emission = A.v(I_EMISSION);
  L.metallic = A.f(I_METALLIC);
  L.roughness = A.f(I_ROUGHNESS);
  L.roughness_base = A.f(I_ROUGHNESS_BASE);
  L.transmission = A.f(I_TRANSMISSION);
  L.ior = A.f(I_IOR);
  L.anisotropic = A.f(I_ANISOTROPIC);
  L.aniso_rotation = A.f(I_ANISO_ROTATION);
  L.clearcoat = A.f(I_CLEARCOAT);
  L.cc_roughness = A.f(I_CC_ROUGHNESS);
  L.cc_roughness_base = A.f(I_CC_ROUGHNESS_BASE);
  L.u0 = A.f(I_U0);
  L.u1 = A.f(I_U1);
  L.uc = A.f(I_UC);
  L.uc2 = A.f(I_UC2);
  L.thin = A.b(I_THIN);

  // ---- candidates (only what the picked lobe and NEE read) ----
  Cand c;
  const Base b = G::coat(a) ? pk.b : lane_base(a, A);  // the coat's pick made it already
  c.frame = b.frame;
  c.wo = b.wo;
  c.regularized = b.regularized;
  c.r_s = c.regularized ? roughen(L.roughness) : L.roughness;
  c.wo_r = aniso ? rot_z(c.wo, -L.aniso_rotation) : c.wo;
  c.a = make_alphas(c.r_s, aniso, L.anisotropic);
  c.smooth = ggx_smooth(c.a);
  if (key != KEY_COAT) {
    c.wm = sample_visible(c.a, c.wo_r, L.u0, L.u1);
    c.wi_g = reflect_about(c.wo_r, c.wm);
  }
  if (key == KEY_GLOSSY) {
    const V3 wi_d = sample_cosine_hemisphere(L.u0, L.u1);
    c.wi_d = c.wo_r.z < 0.0f ? vneg(wi_d) : wi_d;
  }
  c.wi_l = world_to_local(A.v(I_LS_WI), c.frame);
  c.wi_l_r = aniso ? rot_z(c.wi_l, -L.aniso_rotation) : c.wi_l;
  const float r0 = (1.0f - L.ior) / (L.ior + 1.0f);
  c.f0 = r0 * r0;
  if (G::diel(a)) c.ior_rel = (L.thin || c.wo_r.z > 0.0f) ? L.ior : 1.0f / L.ior;
  if (key == KEY_COAT) {
    c.cr_s = pk.cr_s;
    c.ac = pk.ac;
    c.wm_coat = pk.wm_coat;
  }

  // ---- the picked lobe's sample ----
  V3 le = vsplat(0.0f);
  Sample smp;
  if (key == KEY_COAT) {
    smp = sample_clearcoat(L, c);
  } else if (key == KEY_METAL) {
    smp = sample_metallic(L, c, t);
  } else if (key == KEY_DIEL) {
    smp = sample_dielectric(L, c, t);
  } else {
    smp = sample_glossy(L, c, t, &le);
  }
  if (aniso && key != KEY_COAT) smp.wi = rot_z(smp.wi, L.aniso_rotation);
  const int flags = smp.flags;
  const V3 wi_world = local_to_world(smp.wi, c.frame);

  // ---- emitted radiance + MIS vs the light sampler ----
  const bool emitted = (flags & EMITTED) != 0 && found;
  float w_b = 1.0f;
  if (a.mis && !a.depth0 && !(spec_prev || A.b(I_LIGHT_NEG))) {
    const V3 dp = vsub(A.v(I_LAST_P), L.p);
    const float dist2 = vdot(dp, dp);
    float pdf_light = 0.0f;
    if (a.any_lights)
      pdf_light = A.f(I_PDF_AREA) * dist2 * A.f(I_SEL_P) / cmin0(fabsf(vdot(vneg(L.d), L.n)), F(1e-9));
    const float lp = A.f(I_LAST_PDF);
    w_b = lp / cmin0(lp + pdf_light, F(1e-20));
  }
  LaneOut r;
  r.L_emit = emitted ? vscale(vmul(atten, le), w_b) : vsplat(0.0f);
  const bool scattered = (flags & (REFLECTED | TRANSMITTED)) != 0 && found;

  // ---- NEE: f/pdf at the sampled light direction + pending contrib ----
  bool nee_need = false;
  V3 shadow_d = vsplat(0.0f), contrib = vsplat(0.0f);
  float shadow_tmax = -1.0f;
  if (nee) {
    const Alphas ar = make_alphas(L.roughness, aniso, L.anisotropic);
    NeeFet q;
    const float cos_o_abs = fabsf(c.wo_r.z);
    const float cos_l_abs = fabsf(c.wi_l_r.z);
    q.eavg_raw = lut_eavg(t, L.roughness);
    q.e_o_abs_raw = lut_e(t, cos_o_abs, L.roughness);
    q.e_i_l_abs = lut_e(t, cos_l_abs, L.roughness);
    q.base_e_o_abs = lut_base_e(t, c.f0, L.roughness, cos_o_abs);
    q.base_e_i_l = lut_base_e(t, c.f0, L.roughness, cos_l_abs);
    q.base_eavg_raw = lut_base_eavg(t, c.f0, L.roughness);
    // bsdf_f_c at the rotated pair
    const float c_diel = (1.0f - L.metallic) * L.transmission;
    const float c_glossy = (1.0f - L.metallic) * (1.0f - L.transmission);
    V3 f_l = vscale(f_glossy(L, q, ar, c.wo_r, c.wi_l_r), c_glossy);
    if (G::metal(a)) f_l = vadd(f_l, vscale(f_metallic(L, q, ar, c.wo_r, c.wi_l_r), L.metallic));
    if (G::diel(a)) {
      const bool is_refl = c.wo_r.z * c.wi_l_r.z > 0.0f;
      const float ior_f = is_refl ? 1.0f : (c.wo_r.z > 0.0f ? L.ior : 1.0f / L.ior);
      const float glass_e_f = lut_glass_e(t, ior_f, L.roughness, cos_o_abs);
      f_l = vadd(f_l, vscale(f_dielectric(L, glass_e_f, ar, c.wo_r, c.wi_l_r), c_diel));
    }
    const Alphas acc = make_alphas(L.cc_roughness, false, 0.0f);
    if (G::coat(a)) {
      float fc;
      const float f_coat = f_clearcoat(acc, c.wo_r, c.wi_l_r, &fc);
      f_l = vadd(vscale(f_l, 1.0f - L.clearcoat * fc), vsplat(L.clearcoat * f_coat));
    }
    // bsdf_pdf_c at the UNROTATED pair
    float pdf_b = c_glossy * pdf_glossy(L, q, ar, c.wo, c.wi_l);
    if (G::metal(a)) pdf_b = pdf_b + L.metallic * pdf_metallic(ar, c.wo, c.wi_l);
    if (G::diel(a)) pdf_b = pdf_b + c_diel * pdf_dielectric(L, ar, c.wo, c.wi_l);
    if (G::coat(a)) {
      float fc;
      const float pdf_coat = pdf_clearcoat(acc, c.wo, c.wi_l, &fc);
      pdf_b = (1.0f - L.clearcoat * fc) * pdf_b + L.clearcoat * pdf_coat;
    }
    const bool do_nee = scattered && (flags & (EMITTED | SPECULAR)) == 0;
    nee_need = do_nee && A.b(I_LS_VALID) && vdot(f_l, f_l) > 0.0f;
    const V3 ls_wi = A.v(I_LS_WI);
    const V3 to_l = vsub(A.v(I_LS_P), L.p);
    const float dist2_l = vdot(to_l, to_l);
    const float dist_l = sqrtf(cmin0(dist2_l, F(1e-20)));
    shadow_d = vscale(to_l, 1.0f / dist_l);
    shadow_tmax = nee_need ? dist_l - F(1e-3) : -1.0f;
    float pdf_l = A.f(I_LS_SELECT_P) * A.f(I_LS_PDF) / cmin0(fabsf(vdot(A.v(I_LS_N), ls_wi)), F(1e-9));
    pdf_l = A.b(I_LS_IS_ENV) ? pdf_l : pdf_l * dist2_l;
    const float w_nee = fabsf(vdot(ls_wi, L.n)) / cmin0(pdf_b + pdf_l, F(1e-20));
    contrib = vmul(atten, vscale(vmul(A.v(I_LS_LI), f_l), w_nee));
  }

  // ---- throughput update ----
  const V3 fcos = vscale(smp.f, fabsf(vdot(wi_world, L.n)));
  V3 atten_new = vmul(atten, vscale(fcos, 1.0f / cmin0(smp.pdf, F(1e-20))));
  if (A.b(I_HIT_BACK) && scattered && !L.thin) {
    const V3 vc = A.v(I_VOLUME_COLOR);
    const float ht = A.f(I_HIT_T);
    const float dens = A.f(I_VOLUME_DENSITY);
    const V3 vol = v3(expf((vc.x - 1.0f) * ht * dens), expf((vc.y - 1.0f) * ht * dens),
                      expf((vc.z - 1.0f) * ht * dens));
    atten_new = vmul(atten_new, vol);
  }  // a thin lane's volume factor is 1: the twin's product by 1 is exact
  bool active = active_in && scattered;
  const bool specular = (flags & SPECULAR) != 0;
  const float acc_rough = A.f(I_ACC_ROUGH) + (scattered ? smp.roughness : 0.0f);

  // ---- russian roulette ----
  if (a.mis) {
    const float q = cmin0(1.0f - tmax(atten_new.x, tmax(atten_new.y, atten_new.z)), 0.0f);
    const bool rr = a.rr_on && active;
    const bool killed = rr && A.f(I_U_RR) < q;
    active = active && !killed;
    const float scale = (rr && !killed) ? 1.0f / cmin0(1.0f - q, F(1e-9)) : 1.0f;
    atten_new = vscale(atten_new, scale);
  }

  r.contrib = contrib;
  r.shadow_d = shadow_d;
  r.o = active ? L.p : A.v(I_O);
  r.d = active ? wi_world : L.d;
  r.atten = active ? atten_new : atten;
  r.last_p = active ? L.p : A.v(I_LAST_P);
  r.shadow_tmax = shadow_tmax;
  r.last_pdf = active ? smp.pdf : A.f(I_LAST_PDF);
  r.acc_rough = acc_rough;
  r.nee_need = nee_need;
  r.active = active;
  r.specular = (active && specular) || (!active && spec_prev);
  return r;
}

#undef HELPER
