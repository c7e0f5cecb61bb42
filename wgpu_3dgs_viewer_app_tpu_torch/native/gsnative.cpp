// gsnative: native codec for the 3DGS data path (the port's copy of
// wgpu_3dgs_viewer_app_tpu/native/gsnative.cpp, same source and interface).
//
// One multithreaded pass over the raw 62-f32 PLY records:
//   records -> {pos f32x3, color0 u8x4, sh (f32|f16|u8norm), cov3d (f32|f16)}
// Loaded with ctypes (data/native.py); built at first use by native/build.py.
//
// Record layout (Inria PLY, 62 f32 per splat):
//   [0:3] pos  [3:6] normal  [6:9] f_dc  [9:54] f_rest(channel-major)
//   [54] opacity  [55:58] log-scale  [58:62] rot quat (w,x,y,z)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr float kShC0 = 0.28209479177387814f;

inline uint16_t f32_to_f16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  int32_t exp = (int32_t)((x >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = x & 0x7FFFFFu;
  if (exp <= 0) {
    if (exp < -10) return (uint16_t)sign;  // underflow -> signed zero
    mant |= 0x800000u;
    uint32_t shift = (uint32_t)(14 - exp);
    uint32_t half = (mant >> shift);
    // round to nearest even
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half & 1))) half++;
    return (uint16_t)(sign | half);
  }
  if (exp >= 31) return (uint16_t)(sign | 0x7C00u);  // overflow -> inf
  uint32_t half = ((uint32_t)exp << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) half++;
  return (uint16_t)(sign | half);
}

inline float sigmoidf_(float x) { return 1.0f / (1.0f + std::exp(-x)); }

inline uint8_t quant255(float v) {
  float q = nearbyintf(v * 255.0f);
  if (q < 0.0f) q = 0.0f;
  if (q > 255.0f) q = 255.0f;
  return (uint8_t)q;
}

void pack_range(const float* rec, int64_t lo, int64_t hi, int64_t n,
                float* pos, uint32_t* color0,
                int sh_mode,  // 0=f32, 1=f16, 2=u8norm, 3=remove
                void* sh_out, float* sh_mn, float* sh_span,
                int cov_mode,  // 0=f32, 1=f16
                void* cov_out) {
  // All per-splat outputs are splat-axis-LAST (transposed SoA): pos (3, N),
  // sh (45, N), cov (6, N); color0 is one packed u32 rgba per splat.
  for (int64_t i = lo; i < hi; ++i) {
    const float* r = rec + i * 62;
    // pos (3, N)
    pos[0 * n + i] = r[0];
    pos[1 * n + i] = r[1];
    pos[2 * n + i] = r[2];
    // color0: rgb = clamp(0.5 + C0*f_dc), a = sigmoid(opacity); packed u32.
    uint32_t cw = 0;
    for (int c = 0; c < 3; ++c) {
      float v = 0.5f + kShC0 * r[6 + c];
      if (v < 0.0f) v = 0.0f;
      if (v > 1.0f) v = 1.0f;
      cw |= ((uint32_t)quant255(v)) << (8 * c);
    }
    cw |= ((uint32_t)quant255(sigmoidf_(r[54]))) << 24;
    color0[i] = cw;
    // sh rest: PLY stores channel-major [R x15, G x15, B x15];
    // device layout is coeff-major [15][3].
    float sh[45];
    for (int k = 0; k < 15; ++k)
      for (int c = 0; c < 3; ++c) sh[k * 3 + c] = r[9 + c * 15 + k];
    switch (sh_mode) {
      case 0: {
        float* o = (float*)sh_out;
        for (int k = 0; k < 45; ++k) o[(int64_t)k * n + i] = sh[k];
        break;
      }
      case 1: {
        uint16_t* o = (uint16_t*)sh_out;
        for (int k = 0; k < 45; ++k) o[(int64_t)k * n + i] = f32_to_f16(sh[k]);
        break;
      }
      case 2: {
        float mn = sh[0], mx = sh[0];
        for (int k = 1; k < 45; ++k) {
          if (sh[k] < mn) mn = sh[k];
          if (sh[k] > mx) mx = sh[k];
        }
        float span = mx - mn;
        if (span < 1e-12f) span = 1e-12f;
        uint8_t* o = (uint8_t*)sh_out;
        for (int k = 0; k < 45; ++k) o[(int64_t)k * n + i] = quant255((sh[k] - mn) / span);
        sh_mn[i] = mn;
        sh_span[i] = span;
        break;
      }
      default:
        break;  // remove
    }
    // cov3d = R S S^T R^T uniques (xx, xy, xz, yy, yz, zz)
    float sx = std::exp(r[55]), sy = std::exp(r[56]), sz = std::exp(r[57]);
    float qw = r[58], qx = r[59], qy = r[60], qz = r[61];
    float qn = std::sqrt(qw * qw + qx * qx + qy * qy + qz * qz);
    if (qn > 0.0f) {
      qw /= qn; qx /= qn; qy /= qn; qz /= qn;
    } else {
      qw = 1.0f; qx = qy = qz = 0.0f;
    }
    float R[3][3] = {
        {1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)},
        {2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)},
        {2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)}};
    float M[3][3];  // R * diag(s)
    for (int a = 0; a < 3; ++a) {
      M[a][0] = R[a][0] * sx;
      M[a][1] = R[a][1] * sy;
      M[a][2] = R[a][2] * sz;
    }
    float cov[6];
    int idx = 0;
    for (int a = 0; a < 3; ++a)
      for (int b = a; b < 3; ++b) {
        cov[idx++] = M[a][0] * M[b][0] + M[a][1] * M[b][1] + M[a][2] * M[b][2];
      }
    // idx order produced: (0,0)(0,1)(0,2)(1,1)(1,2)(2,2) == xx,xy,xz,yy,yz,zz
    if (cov_mode == 0) {
      float* o = (float*)cov_out;
      for (int k = 0; k < 6; ++k) o[(int64_t)k * n + i] = cov[k];
    } else {
      uint16_t* o = (uint16_t*)cov_out;
      for (int k = 0; k < 6; ++k) o[(int64_t)k * n + i] = f32_to_f16(cov[k]);
    }
  }
}

}  // namespace

extern "C" {

// Fused pack of n 62-f32 records. sh_out/cov_out dtypes depend on modes.
void gs_pack(const float* records, int64_t n,
             float* pos, uint32_t* color0,
             int sh_mode, void* sh_out, float* sh_mn, float* sh_span,
             int cov_mode, void* cov_out, int n_threads) {
  if (n <= 0) return;
  int hw = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
  if (hw < 1) hw = 1;
  if (n < 4096 || hw == 1) {
    pack_range(records, 0, n, n, pos, color0, sh_mode, sh_out, sh_mn, sh_span,
               cov_mode, cov_out);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + hw - 1) / hw;
  for (int t = 0; t < hw; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(pack_range, records, lo, hi, n, pos, color0, sh_mode, sh_out,
                    sh_mn, sh_span, cov_mode, cov_out);
  }
  for (auto& th : ts) th.join();
}

// Convert arbitrary same-dtype property tables is handled in numpy; the
// binary little-endian all-float fast path needs no native decode (memcpy).

int gs_version() { return 2; }
}
