// The per-splat section that kernels K1 (fused.cu), K4 and K8 (geometry.cu)
// share, so they cannot drift apart: the frame scalars, the loads of the
// pod words, SH words and gate records (a kernel issues them all before its
// arithmetic), pod decode -> model/view transform -> projection -> EWA
// conic and radius, SH -> RGB, the colour edit, the gates (mask, per-splat
// edit, selection edit, highlight) and the opacity-aware extent.
//
// Every expression repeats, in order, the plain version in
// ops/preprocess.py (and core/edit.py::apply_edit_components for the edit);
// the library is built with --fmad=false and calls the transcendentals that
// torch's CUDA ops call (logf, sqrtf, exp2f, log2f), so a kernel and its
// plain version agree to the bit on the card.
#pragma once

#include "common.cuh"

namespace gs {

// Frame scalars; the order is ops/fused.py::_frame_param_array.
struct FrameParams {
  float m3[9], mt[3], v3[9], vt[3];
  float p00, p11, fx, fy, tanx, tany, limx, limy, width, height;
  float size2, r_pt, inv_pt;
  float cam[3];
  float z_near, z_far, depth_scale, depth_qmax;
  float sel_rgb[3], sel_params[4];  // scene-wide selection edit
  float highlight[4];               // highlight rgba
};
constexpr int kFrameFloats = 55;
static_assert(sizeof(FrameParams) == kFrameFloats * sizeof(float), "frame params");

// Integer scalars; the order is ops/fused.py::_int_param_array.
struct IntParams {
  int n, sh_comp, cov_comp, sh_degree, no_sh0, display_mode;
  int tile, tiles_x, tiles_y, max_dup, tile_shift;
  int gates, sel_flags;
  int rank_shift, model_rank;  // key bits below the model rank; the rank
  // (K1 takes sel_flags and model_rank from its FrameRecord instead)
};
constexpr int kIntParams = 15;
static_assert(sizeof(IntParams) == kIntParams * sizeof(int), "int params");

// K1's per-frame scalars of one model, in device memory (a row of the
// viewer's parameter block, ops/fused.py::write_frame_record): the floats,
// then the two ints a frame may change, the selection edit's flags and the
// model rank. K1 reads these, not IntParams' fields of the same names, so
// that a launch captured in a CUDA graph takes each frame's values.
struct FrameRecord {
  FrameParams fp;
  int sel_flags, model_rank;
  int pad[7];
};
constexpr int kRecordWords = 64;
static_assert(sizeof(FrameRecord) == kRecordWords * sizeof(int), "frame record");

enum { SH_SINGLE = 0, SH_HALF = 1, SH_NORM8 = 2, SH_REMOVE = 3 };
enum { COV_SINGLE = 0, COV_HALF = 1 };
enum { GATE_MASK = 1, GATE_EDIT = 2, GATE_SEL_EDIT = 4, GATE_HIGHLIGHT = 8 };
enum { EDIT_ENABLED = 1, EDIT_HIDDEN = 2, EDIT_OVERRIDE_COLOR = 4 };

constexpr float kAlphaEps = 1.0f / 255.0f;

// Gate tensors, read where they lie (no per-frame repack); null when absent.
struct Gates {
  const uint8_t* mask;      // (N,) keep bits
  const uint8_t* sel;       // (N,) selection bits
  const uint32_t* eflags;   // (N,) per-splat edit flags
  const float* ergb;        // (N, 3) row-major
  const float* eparams;     // (N, 4) row-major: contrast, exposure, gamma, alpha
};

struct SplatGeometry {
  float wx, wy, wz;          // world position
  float depth, px, py;       // view depth, pixel centre
  float ca, cb, cc, radius;  // conic and flat 3-sigma (or point) radius
  bool det_ok;
  float r, g, b, alpha;      // u8 colour0 and opacity
};

// One splat's pod words, loaded before any arithmetic uses them.
struct SplatWords {
  float x, y, z;
  uint32_t c0;
  uint32_t cov[6];  // f32 bits (COV_SINGLE) or 3 words of two f16 (COV_HALF)
};

template <int COV>
__device__ __forceinline__ SplatWords load_splat(const float* __restrict__ pos,
                                                 const uint32_t* __restrict__ color0,
                                                 const void* __restrict__ cov3d, int64_t n,
                                                 int64_t s) {
  SplatWords w;
  w.x = pos[s];
  w.y = pos[n + s];
  w.z = pos[2 * n + s];
  w.c0 = color0[s];
  const uint32_t* c = static_cast<const uint32_t*>(cov3d);
#pragma unroll
  for (int i = 0; i < (COV == COV_SINGLE ? 6 : 3); ++i) w.cov[i] = c[i * n + s];
  return w;
}

// Decode -> model/view transform -> projection -> EWA conic and radius.
template <int COV>
__device__ __forceinline__ SplatGeometry splat_geometry(const FrameParams& fp, int display_mode,
                                                        const SplatWords& w) {
  SplatGeometry o;
  // --- decode ---
  const uint32_t c0 = w.c0;
  o.r = gs_u8_unit(c0, 0);
  o.g = gs_u8_unit(c0, 8);
  o.b = gs_u8_unit(c0, 16);
  o.alpha = gs_u8_unit(c0, 24);
  float cv[6];
  if (COV == COV_SINGLE) {
#pragma unroll
    for (int i = 0; i < 6; ++i) cv[i] = __uint_as_float(w.cov[i]);
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      cv[2 * j] = gs_f16_bits_to_f32(w.cov[j] & 0xFFFFu);
      cv[2 * j + 1] = gs_f16_bits_to_f32(w.cov[j] >> 16);
    }
  }
  const float x0 = w.x, y0 = w.y, z0 = w.z;

  // --- model transform; covariance M Sigma M^T scaled by size^2 ---
  const float* m = fp.m3;
  o.wx = m[0] * x0 + m[1] * y0 + m[2] * z0 + fp.mt[0];
  o.wy = m[3] * x0 + m[4] * y0 + m[5] * z0 + fp.mt[1];
  o.wz = m[6] * x0 + m[7] * y0 + m[8] * z0 + fp.mt[2];
  const float sg[3][3] = {{cv[0], cv[1], cv[2]}, {cv[1], cv[3], cv[4]}, {cv[2], cv[4], cv[5]}};
  float t[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      t[i][k] = m[i * 3 + 0] * sg[0][k] + m[i * 3 + 1] * sg[1][k] + m[i * 3 + 2] * sg[2][k];
  auto cov_out = [&](int i, int j) {
    return (t[i][0] * m[j * 3 + 0] + t[i][1] * m[j * 3 + 1] + t[i][2] * m[j * 3 + 2]) * fp.size2;
  };
  const float xx = cov_out(0, 0), xy = cov_out(0, 1), xz = cov_out(0, 2);
  const float yy = cov_out(1, 1), yz = cov_out(1, 2), zz = cov_out(2, 2);

  // --- view transform, depth, projection to pixels ---
  const float* v = fp.v3;
  const float tvx = v[0] * o.wx + v[1] * o.wy + v[2] * o.wz + fp.vt[0];
  const float tvy = v[3] * o.wx + v[4] * o.wy + v[5] * o.wz + fp.vt[1];
  const float tvz = v[6] * o.wx + v[7] * o.wy + v[8] * o.wz + fp.vt[2];
  o.depth = -tvz;
  const float d = fmaxf(o.depth, 1e-6f);
  o.px = (fp.p00 * tvx / d * 0.5f + 0.5f) * fp.width;
  o.py = (0.5f - fp.p11 * tvy / d * 0.5f) * fp.height;

  // --- EWA: cov2d = (J W) Sigma (J W)^T + dilation ---
  const float txc = clampf(tvx / d, -fp.limx, fp.limx) * d;
  const float tyc = clampf(tvy / d, -fp.limy, fp.limy) * d;
  const float inv_d = 1.0f / d;
  const float inv_d2 = inv_d * inv_d;
  const float j00 = fp.fx * inv_d, j02 = fp.fx * txc * inv_d2;
  const float j11 = (-fp.fy) * inv_d, j12 = (-fp.fy) * tyc * inv_d2;
  float p[3], q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = j00 * v[k] + j02 * v[6 + k];
    q[k] = j11 * v[3 + k] + j12 * v[6 + k];
  }
  const float sp0 = xx * p[0] + xy * p[1] + xz * p[2];
  const float sp1 = xy * p[0] + yy * p[1] + yz * p[2];
  const float sp2 = xz * p[0] + yz * p[1] + zz * p[2];
  const float sq0 = xx * q[0] + xy * q[1] + xz * q[2];
  const float sq1 = xy * q[0] + yy * q[1] + yz * q[2];
  const float sq2 = xz * q[0] + yz * q[1] + zz * q[2];
  const float ka = p[0] * sp0 + p[1] * sp1 + p[2] * sp2 + 0.3f;
  const float kb = q[0] * sp0 + q[1] * sp1 + q[2] * sp2;
  const float kc = q[0] * sq0 + q[1] * sq1 + q[2] * sq2 + 0.3f;

  const float det = ka * kc - kb * kb;
  o.det_ok = det > 0.0f;
  const float inv_det = o.det_ok ? 1.0f / fmaxf(det, 1e-12f) : 0.0f;
  o.ca = kc * inv_det;
  o.cb = (-kb) * inv_det;
  o.cc = ka * inv_det;
  const float mid = 0.5f * (ka + kc);
  const float disc = sqrtf(fmaxf(mid * mid - det, 0.1f));
  o.radius = ceilf(3.0f * sqrtf(fmaxf(mid + disc, 0.0f)));
  if (display_mode == 2) {  // point: flat disc of fixed pixel radius
    o.radius = fp.r_pt;
    o.ca = fp.inv_pt;
    o.cb = 0.0f;
    o.cc = fp.inv_pt;
  }
  return o;
}

// u32 words of SH coefficients a splat holds (degree 3), by compression.
template <int SH>
constexpr int kShWords = SH == SH_SINGLE ? 45 : SH == SH_HALF ? 23 : SH == SH_NORM8 ? 12 : 0;

// Coefficient i = k * 3 + c of the splat, unpacked from its words in registers.
template <int SH>
__device__ __forceinline__ float sh_coeff(const uint32_t* w, float mn, float scale, int i) {
  if (SH == SH_SINGLE) return __uint_as_float(w[i]);
  if (SH == SH_HALF) return gs_f16_bits_to_f32((w[i / 2] >> (16 * (i % 2))) & 0xFFFFu);
  if (SH == SH_NORM8) return (float)((w[i / 4] >> (8 * (i % 4))) & 0xFFu) * scale + mn;
  return 0.0f;
}

// One splat's SH words (those the degree needs, each once; the rest 0) and
// its norm8 range, loaded before any arithmetic uses them.
template <int SH>
struct ShWords {
  uint32_t w[kShWords<SH> > 0 ? kShWords<SH> : 1];
  float mn, span;
  int n_coef;  // rest coefficients of the degree: 0, 3, 8 or 15
};

template <int SH>
__device__ __forceinline__ ShWords<SH> load_sh(int sh_degree, const void* __restrict__ sh,
                                               const float* __restrict__ sh_mn,
                                               const float* __restrict__ sh_span, int64_t n,
                                               int64_t s) {
  ShWords<SH> o;
  o.n_coef = sh_degree >= 3 ? 15 : sh_degree == 2 ? 8 : sh_degree == 1 ? 3 : 0;
  const int n_words = SH == SH_SINGLE ? 3 * o.n_coef
                      : SH == SH_HALF ? (3 * o.n_coef + 1) / 2
                                      : (3 * o.n_coef + 3) / 4;
  constexpr int kW = kShWords<SH>;
#pragma unroll
  for (int i = 0; i < kW; ++i)
    o.w[i] = i < n_words ? static_cast<const uint32_t*>(sh)[i * n + s] : 0u;
  const bool norm8 = SH == SH_NORM8 && o.n_coef > 0;
  o.mn = norm8 ? sh_mn[s] : 0.0f;
  o.span = norm8 ? sh_span[s] : 0.0f;
  return o;
}

// SH -> RGB (the degree-0 term is the u8 colour0, or 0.5 under no_sh0),
// clamped to [0, 1]. Unrolled over the 15 terms so the basis and the words
// stay in registers; each channel's sum in the plain version's order, the
// three channels interleaved, and the degree tested once per band.
template <int SH>
__device__ __forceinline__ void sh_color(const FrameParams& fp, int no_sh0, const ShWords<SH>& sw,
                                         const SplatGeometry& sg, float col[3]) {
  col[0] = no_sh0 ? 0.5f : sg.r;
  col[1] = no_sh0 ? 0.5f : sg.g;
  col[2] = no_sh0 ? 0.5f : sg.b;
  const int n_coef = sw.n_coef;
  if (n_coef > 0) {
    const float dx = sg.wx - fp.cam[0], dy = sg.wy - fp.cam[1], dz = sg.wz - fp.cam[2];
    const float inv_n = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-18f));
    const float x = dx * inv_n, y = dy * inv_n, z = dz * inv_n;
    float b[15] = {};
    b[0] = -0.4886025119029199f * y;
    b[1] = 0.4886025119029199f * z;
    b[2] = -0.4886025119029199f * x;
    const float xx2 = x * x, yy2 = y * y, zz2 = z * z;
    const float xy2 = x * y, yz2 = y * z, xz2 = x * z;
    if (n_coef >= 8) {
      b[3] = 1.0925484305920792f * xy2;
      b[4] = -1.0925484305920792f * yz2;
      b[5] = 0.31539156525252005f * (2.0f * zz2 - xx2 - yy2);
      b[6] = -1.0925484305920792f * xz2;
      b[7] = 0.5462742152960396f * (xx2 - yy2);
    }
    if (n_coef >= 15) {
      b[8] = -0.5900435899266435f * y * (3.0f * xx2 - yy2);
      b[9] = 2.890611442640554f * xy2 * z;
      b[10] = -0.4570457994644658f * y * (4.0f * zz2 - xx2 - yy2);
      b[11] = 0.3731763325901154f * z * (2.0f * zz2 - 3.0f * xx2 - 3.0f * yy2);
      b[12] = -0.4570457994644658f * x * (4.0f * zz2 - xx2 - yy2);
      b[13] = 1.445305721320277f * z * (xx2 - yy2);
      b[14] = -0.5900435899266435f * x * (xx2 - yy2);
    }
    const float scale = sw.span * (1.0f / 255.0f);
    float acc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = b[0] * sh_coeff<SH>(sw.w, sw.mn, scale, c);
#pragma unroll
    for (int k = 1; k < 15; ++k) {
      if (k == 3 && n_coef < 8) break;
      if (k == 8 && n_coef < 15) break;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[c] = acc[c] + b[k] * sh_coeff<SH>(sw.w, sw.mn, scale, k * 3 + c);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) col[c] = acc[c] + col[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) col[c] = clampf(col[c], 0.0f, 1.0f);
}

// One colour edit (core/edit.py::apply_edit_components). A record whose
// ENABLED bit is clear changes nothing. Returns whether it hides the splat.
__device__ __forceinline__ bool apply_edit(float& r, float& g, float& b, float& opacity,
                                           uint32_t flags, float er, float eg, float eb,
                                           float e_contrast, float e_exposure, float e_gamma,
                                           float e_alpha) {
  if (!(flags & EDIT_ENABLED)) return false;
  float ro = er, go = eg, bo = eb;
  if (!(flags & EDIT_OVERRIDE_COLOR)) {
    // --- rgb -> hsv ---
    const float rc = clampf(r, 0.0f, 1.0f), gc = clampf(g, 0.0f, 1.0f), bc = clampf(b, 0.0f, 1.0f);
    const float maxc = fmaxf(fmaxf(rc, gc), bc);
    const float minc = fminf(fminf(rc, gc), bc);
    float v = maxc;
    const float delta = maxc - minc;
    float s = maxc > 0.0f ? delta / fmaxf(maxc, 1e-12f) : 0.0f;
    const float sd = fmaxf(delta, 1e-12f);
    // The plain version computes the hue of all three sectors and keeps the
    // max channel's; only that one is computed here (one division).
    const int sector = maxc == rc ? 0 : (maxc == gc ? 1 : 2);
    const float hq = (sector == 0 ? gc - bc : sector == 1 ? bc - rc : rc - gc) / sd;
    float h = (sector == 0   ? hq - 6.0f * floorf(hq * (1.0f / 6.0f))
               : sector == 1 ? hq + 2.0f
                             : hq + 4.0f) *
              (1.0f / 6.0f);
    if (!(delta > 0.0f)) h = 0.0f;
    // --- adjust: hue shift, saturation and value scale ---
    h = h + er;
    s = s * eg;
    v = v * eb;
    // --- hsv -> rgb ---
    h = h - floorf(h);
    const float h6 = h * 6.0f;
    const float i = floorf(h6);
    const float f = h6 - i;
    const float pp = v * (1.0f - s);
    const float qq = v * (1.0f - s * f);
    const float tt = v * (1.0f - s * (1.0f - f));
    switch ((((int)i % 6) + 6) % 6) {  // Python's non-negative remainder
      case 0: ro = v; go = tt; bo = pp; break;
      case 1: ro = qq; go = v; bo = pp; break;
      case 2: ro = pp; go = v; bo = tt; break;
      case 3: ro = pp; go = qq; bo = v; break;
      case 4: ro = tt; go = pp; bo = v; break;
      default: ro = v; go = pp; bo = qq; break;
    }
  }
  const float gam = fmaxf(e_gamma, 1e-6f);
  const float gain = exp2f(e_exposure);
  auto tone = [&](float x) {
    x = (x - 0.5f) * (1.0f + e_contrast) + 0.5f;
    x = clampf(x * gain, 0.0f, 1.0f);
    // x^gam with x in [0, 1] as exp2(gam * log2 x); 0 stays 0.
    return x > 0.0f ? exp2f(gam * log2f(fmaxf(x, 1e-30f))) : 0.0f;
  };
  r = tone(ro);
  g = tone(go);
  b = tone(bo);
  opacity = opacity * e_alpha;
  return (flags & EDIT_HIDDEN) != 0;
}

// One splat's gate records (those the launch's gate bits name), loaded
// before any arithmetic uses them.
struct GateWords {
  bool mask, sel;
  uint32_t eflags;
  float ergb[3], eparams[4];
};

__device__ __forceinline__ GateWords load_gates(const IntParams& ip, const Gates& gt, int64_t s) {
  GateWords w{true, false, 0u, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
  if (ip.gates & GATE_MASK) w.mask = gt.mask[s] != 0;
  if (ip.gates & GATE_EDIT) {
    w.eflags = gt.eflags[s];
#pragma unroll
    for (int i = 0; i < 3; ++i) w.ergb[i] = gt.ergb[3 * s + i];
#pragma unroll
    for (int i = 0; i < 4; ++i) w.eparams[i] = gt.eparams[4 * s + i];
  }
  if (ip.gates & (GATE_SEL_EDIT | GATE_HIGHLIGHT)) w.sel = gt.sel[s] != 0;
  return w;
}

// The gates in the reference order (ops/preprocess.py): mask bit, per-splat
// edit, selection edit, highlight. Edits change colour and opacity in
// place; returns false when a gate drops the splat. The two edits run as
// one loop that is not unrolled, so the edit's code is there once.
// `sel_flags`: the selection edit's flags (IntParams' for K4 and K8, the
// frame record's for K1).
__device__ __forceinline__ bool apply_gates(const FrameParams& fp, const IntParams& ip,
                                            int sel_flags, const GateWords& gw, float& r,
                                            float& g, float& b, float& alpha) {
  bool keep = true;
  if (ip.gates & GATE_MASK) keep = gw.mask;
  const bool sel = (ip.gates & (GATE_SEL_EDIT | GATE_HIGHLIGHT)) && gw.sel;
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {  // 0: the per-splat edit, 1: the selection edit
    const bool own = k == 0;
    if (own ? !(ip.gates & GATE_EDIT) : !((ip.gates & GATE_SEL_EDIT) && sel)) continue;
    const bool hidden = apply_edit(
        r, g, b, alpha, own ? gw.eflags : (uint32_t)sel_flags,
        own ? gw.ergb[0] : fp.sel_rgb[0], own ? gw.ergb[1] : fp.sel_rgb[1],
        own ? gw.ergb[2] : fp.sel_rgb[2], own ? gw.eparams[0] : fp.sel_params[0],
        own ? gw.eparams[1] : fp.sel_params[1], own ? gw.eparams[2] : fp.sel_params[2],
        own ? gw.eparams[3] : fp.sel_params[3]);
    keep = keep && !hidden;
  }
  if ((ip.gates & GATE_HIGHLIGHT) && sel) {  // after the selection edit
    const float ha = fp.highlight[3];
    const float keep_c = 1.0f - ha;
    r = r * keep_c + fp.highlight[0] * ha;
    g = g * keep_c + fp.highlight[1] * ha;
    b = b * keep_c + fp.highlight[2] * ha;
  }
  return keep;
}

// Opacity-aware extent: the exact live radius sigma * sqrt(2 ln(a / eps))
// in splat mode, the 2-sigma flat cut in ellipse mode, as is in point mode.
__device__ __forceinline__ float live_radius(int display_mode, float radius, float alpha) {
  if (display_mode == 0) {
    const float cut = sqrtf(2.0f * fmaxf(logf(alpha * 255.0f), 0.0f));
    return radius * (cut * (1.0f / 3.0f));
  }
  if (display_mode == 1) return radius * (2.0f / 3.0f);
  return radius;
}

// Frustum, depth, determinant, alpha and extent cull, and the gates' verdict.
__device__ __forceinline__ bool splat_valid(const FrameParams& fp, const SplatGeometry& sg,
                                            float radius, float alpha, bool gate_ok) {
  const bool on_screen = (sg.px + radius > 0.0f) && (sg.px - radius < fp.width) &&
                         (sg.py + radius > 0.0f) && (sg.py - radius < fp.height);
  return sg.det_ok && sg.depth > fp.z_near && sg.depth < fp.z_far && on_screen &&
         alpha > kAlphaEps && radius > 0.0f && gate_ok;
}

}  // namespace gs
