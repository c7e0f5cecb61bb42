// K1 - fused splat front-end: flat word pod -> (N * D) packed entries.
//
// Replaces the Pallas kernel `wgpu_3dgs_viewer_app_tpu/ops/fused.py::_kernel`
// (ungated specialisation, presort off). One thread per splat: decode the pod
// words, model and view transform, EWA conic and radius, SH (degree 0-3) to
// RGB, opacity-aware extent, cull, then enumerate up to D tiles centre-out
// with the exact ellipse-tile test and pack key/p1/p2/p3. Slot d of splat s
// is written at entry s * D + d as one 16-byte store; dead slots are
// (SENTINEL, 0, 0, 0).
//
// The arithmetic repeats, expression for expression, the plain version
// (ops/preprocess.py + ops/binning.py); the library is built with
// --fmad=false so no multiply-add contracts, and the transcendentals are the
// ones torch's CUDA ops call (logf, sqrtf, rsqrtf), so kernel and plain
// version agree to the bit on almost every entry.
//
// What bounds it on an H100: memory. Per splat it reads 12 B of position,
// 4 B of colour, 12-24 B of covariance and up to 188 B of SH, and writes
// 16 * D bytes of entries; the arithmetic (~400 flops at SH degree 3) stays
// far below the card's compute rate. The design keeps every intermediate in
// registers (no per-splat temporaries in device memory, unlike the plain
// version's ~60 full-size tensors) and reads each pod plane once, coalesced
// across the warp (the pod is splat-axis-last). Warp-level staging of the
// strided 16-byte entry stores is left for a later pass.
#include <cstring>

#include "common.cuh"

namespace {

// Frame scalars; the order is ops/fused.py::_frame_param_array.
struct FrameParams {
  float m3[9], mt[3], v3[9], vt[3];
  float p00, p11, fx, fy, tanx, tany, limx, limy, width, height;
  float size2, r_pt, inv_pt;
  float cam[3];
  float z_near, z_far, depth_scale, depth_qmax;
};
constexpr int kFrameFloats = 44;
static_assert(sizeof(FrameParams) == kFrameFloats * sizeof(float), "frame params");

struct IntParams {
  int n, sh_comp, cov_comp, sh_degree, no_sh0, display_mode;
  int tile, tiles_x, tiles_y, max_dup, tile_shift;
};
constexpr int kIntParams = 11;
static_assert(sizeof(IntParams) == kIntParams * sizeof(int), "int params");

enum { SH_SINGLE = 0, SH_HALF = 1, SH_NORM8 = 2, SH_REMOVE = 3 };
enum { COV_SINGLE = 0, COV_HALF = 1 };

constexpr float kAlphaEps = 1.0f / 255.0f;

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

template <int SH>
__device__ __forceinline__ float sh_coeff(const void* sh, const float mn, const float scale,
                                          int64_t n, int64_t s, int k, int c) {
  const int i = k * 3 + c;
  if (SH == SH_SINGLE) return static_cast<const float*>(sh)[i * n + s];
  if (SH == SH_HALF) {
    const uint32_t w = static_cast<const uint32_t*>(sh)[(i / 2) * n + s];
    return gs_f16_bits_to_f32((w >> (16 * (i % 2))) & 0xFFFFu);
  }
  if (SH == SH_NORM8) {
    const uint32_t w = static_cast<const uint32_t*>(sh)[(i / 4) * n + s];
    return (float)((w >> (8 * (i % 4))) & 0xFFu) * scale + mn;
  }
  return 0.0f;
}

template <int SH, int COV>
__global__ void __launch_bounds__(128)
fused_frontend_kernel(const FrameParams fp, const IntParams ip,
                      const float* __restrict__ pos, const uint32_t* __restrict__ color0,
                      const void* __restrict__ cov3d, const void* __restrict__ sh,
                      const float* __restrict__ sh_mn, const float* __restrict__ sh_span,
                      uint4* __restrict__ out) {
  const int64_t n = ip.n;
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;

  // --- decode ---
  const uint32_t c0 = color0[s];
  const float c0r = gs_u8_unit(c0, 0), c0g = gs_u8_unit(c0, 8), c0b = gs_u8_unit(c0, 16);
  float alpha = gs_u8_unit(c0, 24);
  float cv[6];
  if (COV == COV_SINGLE) {
    const float* c = static_cast<const float*>(cov3d);
#pragma unroll
    for (int i = 0; i < 6; ++i) cv[i] = c[i * n + s];
  } else {
    const uint32_t* c = static_cast<const uint32_t*>(cov3d);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const uint32_t w = c[j * n + s];
      cv[2 * j] = gs_f16_bits_to_f32(w & 0xFFFFu);
      cv[2 * j + 1] = gs_f16_bits_to_f32(w >> 16);
    }
  }
  const float x0 = pos[s], y0 = pos[n + s], z0 = pos[2 * n + s];

  // --- model transform; covariance M Sigma M^T scaled by size^2 ---
  const float* m = fp.m3;
  const float wx = m[0] * x0 + m[1] * y0 + m[2] * z0 + fp.mt[0];
  const float wy = m[3] * x0 + m[4] * y0 + m[5] * z0 + fp.mt[1];
  const float wz = m[6] * x0 + m[7] * y0 + m[8] * z0 + fp.mt[2];
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
  const float tvx = v[0] * wx + v[1] * wy + v[2] * wz + fp.vt[0];
  const float tvy = v[3] * wx + v[4] * wy + v[5] * wz + fp.vt[1];
  const float tvz = v[6] * wx + v[7] * wy + v[8] * wz + fp.vt[2];
  const float depth = -tvz;
  const float d = fmaxf(depth, 1e-6f);
  const float px = (fp.p00 * tvx / d * 0.5f + 0.5f) * fp.width;
  const float py = (0.5f - fp.p11 * tvy / d * 0.5f) * fp.height;

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
  const bool det_ok = det > 0.0f;
  const float inv_det = det_ok ? 1.0f / fmaxf(det, 1e-12f) : 0.0f;
  float ca = kc * inv_det, cb = (-kb) * inv_det, cc = ka * inv_det;
  const float mid = 0.5f * (ka + kc);
  const float disc = sqrtf(fmaxf(mid * mid - det, 0.1f));
  float radius = ceilf(3.0f * sqrtf(fmaxf(mid + disc, 0.0f)));
  if (ip.display_mode == 2) {  // point: flat disc of fixed pixel radius
    radius = fp.r_pt;
    ca = fp.inv_pt;
    cb = 0.0f;
    cc = fp.inv_pt;
  }

  // --- SH -> RGB (degree-0 term is the u8 color0) ---
  const float base_r = ip.no_sh0 ? 0.5f : c0r;
  const float base_g = ip.no_sh0 ? 0.5f : c0g;
  const float base_b = ip.no_sh0 ? 0.5f : c0b;
  float col[3] = {base_r, base_g, base_b};
  if (ip.sh_degree >= 1) {
    const float dx = wx - fp.cam[0], dy = wy - fp.cam[1], dz = wz - fp.cam[2];
    const float inv_n = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-18f));
    const float x = dx * inv_n, y = dy * inv_n, z = dz * inv_n;
    float b[15];
    int nb = 3;
    b[0] = -0.4886025119029199f * y;
    b[1] = 0.4886025119029199f * z;
    b[2] = -0.4886025119029199f * x;
    const float xx2 = x * x, yy2 = y * y, zz2 = z * z;
    const float xy2 = x * y, yz2 = y * z, xz2 = x * z;
    if (ip.sh_degree >= 2) {
      b[3] = 1.0925484305920792f * xy2;
      b[4] = -1.0925484305920792f * yz2;
      b[5] = 0.31539156525252005f * (2.0f * zz2 - xx2 - yy2);
      b[6] = -1.0925484305920792f * xz2;
      b[7] = 0.5462742152960396f * (xx2 - yy2);
      nb = 8;
    }
    if (ip.sh_degree >= 3) {
      b[8] = -0.5900435899266435f * y * (3.0f * xx2 - yy2);
      b[9] = 2.890611442640554f * xy2 * z;
      b[10] = -0.4570457994644658f * y * (4.0f * zz2 - xx2 - yy2);
      b[11] = 0.3731763325901154f * z * (2.0f * zz2 - 3.0f * xx2 - 3.0f * yy2);
      b[12] = -0.4570457994644658f * x * (4.0f * zz2 - xx2 - yy2);
      b[13] = 1.445305721320277f * z * (xx2 - yy2);
      b[14] = -0.5900435899266435f * x * (xx2 - yy2);
      nb = 15;
    }
    const float mn = SH == SH_NORM8 ? sh_mn[s] : 0.0f;
    const float scale = SH == SH_NORM8 ? sh_span[s] * (1.0f / 255.0f) : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = b[0] * sh_coeff<SH>(sh, mn, scale, n, s, 0, c);
      for (int k = 1; k < nb; ++k) acc = acc + b[k] * sh_coeff<SH>(sh, mn, scale, n, s, k, c);
      col[c] = acc + col[c];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) col[c] = clampf(col[c], 0.0f, 1.0f);

  // --- opacity-aware extent and cull ---
  if (ip.display_mode == 0) {
    const float cut = sqrtf(2.0f * fmaxf(logf(alpha * 255.0f), 0.0f));
    radius = radius * (cut * (1.0f / 3.0f));
  } else if (ip.display_mode == 1) {
    radius = radius * (2.0f / 3.0f);
  }
  const bool on_screen = (px + radius > 0.0f) && (px - radius < fp.width) &&
                         (py + radius > 0.0f) && (py - radius < fp.height);
  const bool valid = det_ok && depth > fp.z_near && depth < fp.z_far && on_screen &&
                     alpha > kAlphaEps && radius > 0.0f;
  if (!valid) alpha = 0.0f;

  // --- per-splat entry words ---
  const float ld = logf(fmaxf(depth, 1e-6f));
  const uint32_t dkey = (uint32_t)(int)clampf((ld - (-3.0f)) * fp.depth_scale, 0.0f, fp.depth_qmax);
  const uint32_t a8 = (uint32_t)(int)clampf(alpha * 255.0f + 0.5f, 0.0f, 252.0f);
  const uint32_t key_lo = (dkey << 8) | a8;
  const uint32_t r8 = (uint32_t)(int)clampf(col[0] * 255.0f + 0.5f, 0.0f, 255.0f);
  const uint32_t g8 = (uint32_t)(int)clampf(col[1] * 255.0f + 0.5f, 0.0f, 255.0f);
  const uint32_t b8 = (uint32_t)(int)clampf(col[2] * 255.0f + 0.5f, 0.0f, 255.0f);
  const uint32_t p2 = gs_f32_to_f16_bits(ca) | (gs_f32_to_f16_bits(cb) << 16);
  const uint32_t p3 = gs_f32_to_f16_bits(cc) | (r8 << 16) | (g8 << 24);

  // --- tight cull from the packed (f16-rounded) conic ---
  const float a = gs_f16_bits_to_f32(p2 & 0xFFFFu);
  const float bq = gs_f16_bits_to_f32(p2 >> 16);
  const float c = gs_f16_bits_to_f32(p3 & 0xFFFFu);
  const float r_signed = valid ? radius : -1.0f;
  const float cdet = fmaxf(a * c - bq * bq, 1e-20f);
  const float half = 0.5f * (a + c);
  const float lam_min = fmaxf(half - sqrtf(fmaxf(half * half - cdet, 0.0f)), 1e-12f);
  const float r = fmaxf(r_signed, 0.0f);
  const float cut2 = r_signed > 0.0f ? r * r * lam_min : -1.0f;
  const float sc = sqrtf(fmaxf(cut2, 0.0f) / cdet);
  const float rx = fminf(sqrtf(fmaxf(c, 0.0f)) * sc, r);
  const float ry = fminf(sqrtf(fmaxf(a, 0.0f)) * sc, r);
  const float inv_a = 1.0f / fmaxf(a, 1e-12f);
  const float inv_c = 1.0f / fmaxf(c, 1e-12f);

  const float tile = (float)ip.tile;
  const float hx = (float)(ip.tiles_x - 1), hy = (float)(ip.tiles_y - 1);
  const int tx0 = (int)clampf(floorf((px - rx) / tile), 0.0f, hx);
  const int tx1 = (int)clampf(floorf((px + rx) / tile), 0.0f, hx);
  const int ty0 = (int)clampf(floorf((py - ry) / tile), 0.0f, hy);
  const int ty1 = (int)clampf(floorf((py + ry) / tile), 0.0f, hy);
  const int rw = tx1 - tx0 + 1, rh = ty1 - ty0 + 1;
  const int n_touched = rw * rh;

  uint4* dst = out + s * ip.max_dup;
  for (int dd = 0; dd < ip.max_dup; ++dd) {
    // Centre-out candidate cell dd of the tile rect.
    const int mm = dd % rw, kk = dd / rw;
    const int etx = tx0 + ((rw - 1) >> 1) + ((mm + 1) >> 1) * ((mm & 1) ? 1 : -1);
    const int ety = ty0 + ((rh - 1) >> 1) + ((kk + 1) >> 1) * ((kk & 1) ? 1 : -1);
    const float dx0 = (float)etx * tile - px, dx1 = dx0 + tile;
    const float dy0 = (float)ety * tile - py, dy1 = dy0 + tile;
    const bool inside = dx0 <= 0.0f && dx1 >= 0.0f && dy0 <= 0.0f && dy1 >= 0.0f;
    auto qf = [&](float ex, float ey) { return (a * ex + 2.0f * bq * ey) * ex + c * ey * ey; };
    const float yv0 = fminf(fmaxf((-bq) * dx0 * inv_c, dy0), dy1);
    const float yv1 = fminf(fmaxf((-bq) * dx1 * inv_c, dy0), dy1);
    const float xh0 = fminf(fmaxf((-bq) * dy0 * inv_a, dx0), dx1);
    const float xh1 = fminf(fmaxf((-bq) * dy1 * inv_a, dx0), dx1);
    float qmin = fminf(fminf(qf(dx0, yv0), qf(dx1, yv1)), fminf(qf(xh0, dy0), qf(xh1, dy1)));
    if (inside) qmin = 0.0f;
    const bool live = dd < n_touched && qmin <= cut2;
    uint4 e = make_uint4(GS_SENTINEL, 0u, 0u, 0u);
    if (live) {
      const uint32_t tile_id = (uint32_t)(ety * ip.tiles_x + etx);
      const uint32_t mxq = (uint32_t)(int)clampf((px - (float)etx * tile + 128.0f) * 16.0f + 0.5f, 0.0f, 4095.0f);
      const uint32_t myq = (uint32_t)(int)clampf((py - (float)ety * tile + 128.0f) * 16.0f + 0.5f, 0.0f, 4095.0f);
      e = make_uint4((tile_id << ip.tile_shift) | key_lo, mxq | (myq << 12) | (b8 << 24), p2, p3);
    }
    dst[dd] = e;
  }
}

template <int SH, int COV>
void launch(const FrameParams& fp, const IntParams& ip, const void* pos, const void* color0,
            const void* cov3d, const void* sh, const void* sh_mn, const void* sh_span, void* out,
            cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (ip.n + threads - 1) / threads;
  fused_frontend_kernel<SH, COV><<<blocks, threads, 0, stream>>>(
      fp, ip, static_cast<const float*>(pos), static_cast<const uint32_t*>(color0), cov3d, sh,
      static_cast<const float*>(sh_mn), static_cast<const float*>(sh_span),
      static_cast<uint4*>(out));
}

}  // namespace

extern "C" int gs_fused_frontend(const float* frame, const int* iparams, const void* pos,
                                 const void* color0, const void* cov3d, const void* sh,
                                 const void* sh_mn, const void* sh_span, void* out,
                                 void* stream) {
  FrameParams fp;
  IntParams ip;
  memcpy(&fp, frame, sizeof(fp));
  memcpy(&ip, iparams, sizeof(ip));
  if (ip.n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GS_CASE(S, C) \
  case S * 2 + C: launch<S, C>(fp, ip, pos, color0, cov3d, sh, sh_mn, sh_span, out, st); break;
  switch (ip.sh_comp * 2 + ip.cov_comp) {
    GS_CASE(SH_SINGLE, COV_SINGLE)
    GS_CASE(SH_SINGLE, COV_HALF)
    GS_CASE(SH_HALF, COV_SINGLE)
    GS_CASE(SH_HALF, COV_HALF)
    GS_CASE(SH_NORM8, COV_SINGLE)
    GS_CASE(SH_NORM8, COV_HALF)
    GS_CASE(SH_REMOVE, COV_SINGLE)
    GS_CASE(SH_REMOVE, COV_HALF)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GS_CASE
  return (int)cudaGetLastError();
}
