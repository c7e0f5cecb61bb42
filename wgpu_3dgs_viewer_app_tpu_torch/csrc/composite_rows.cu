// K7 - row-major v2 tile compositor with the reference's exact chunks.
//
// Replaces the Pallas kernel `wgpu_3dgs_viewer_app_tpu/ops/composite.py::
// _composite_kernel_v2`, the row-major kernel that `composite_tiles_pallas_v2`
// runs with transposed=False or mxu=True. It reads the same packed entries as
// K3 (key with the alpha byte, u12.u12 tile-relative means, f16 conic, u8
// colour), but walks a tile's run in the reference's chunks: chunk c is
// global entry row start / 128 + c, and entries of that row outside the
// tile's run [start, start + count) get opacity 0. Before each chunk the
// block stops if no pixel of the tile has T > 1/255 (__syncthreads_or), the
// reference's own test, so K7 meets its plain version to rounding where K3
// (256-entry batches of the run) meets it only within 1/255.
//
// One block per screen tile, one thread per pixel (tile * tile <= 1024).
// Per chunk, the first 128 threads decode one entry each into shared memory;
// then every pixel thread walks the chunk in order, forms w = excl * alpha
// and sums w * (r, g, b), and after the chunk adds T * sums and folds the
// chunk's product of (1 - alpha) into T, as the reference's chunk form does.
// The exponent is in log2 units, alpha = op * 2^min(power2, 0) (splat) or the
// flat opacity inside power2 >= -2 log2(e) (ellipse/point); alpha below
// 1/255 is dropped. Two forms of power2:
//   Horner (default): (a2 dx + b2 dy) dx + (c2 dy) dy on pre-scaled rows;
//   quadratic basis (mxu, splat mode only): F = [px^2, py^2, px py, px, py, 1]
//   in registers dotted with the entry's G row (shared memory). It cancels
//   terms up to ~1e4, so every rounding shows: the coefficients of the
//   reference's `_chunk_alpha_mxu` and the dot are evaluated with explicit
//   fmaf where the reference's CPU build fuses (a * b + c * d as
//   fma(a, b, c * d); the dot as an fma chain in term order), as the plain
//   version does, and nothing else is contracted (--fmad=false).
//
// What bounds it on an H100: operations (~22-24 flops and an exp2f per
// entry and pixel) and shared-memory broadcasts, as K3; it tests the exit
// every 128 entries, twice as often as K3, and a tile's first and last
// chunks carry entries of neighbouring tiles as dead lanes.
#include "common.cuh"

namespace {

constexpr int kRow = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kTEps = 1.0f / 255.0f;

__global__ void __launch_bounds__(1024)
composite_rows_kernel(const uint4* __restrict__ entries, const int* __restrict__ starts,
                      const int* __restrict__ counts, int tile, int tiles_x, int width,
                      int height, int flat_mode, int mxu, float* __restrict__ out) {
  // Horner: q = (mx, my, a2, b2, c2, -); quadratic basis: q = G0..G5.
  __shared__ float s_q[6][kRow];
  __shared__ float s_op[kRow], s_r[kRow], s_g[kRow], s_b[kRow];

  const int t = blockIdx.x;
  const int lx = (int)threadIdx.x % tile, ly = (int)threadIdx.x / tile;
  const float px = (float)lx + 0.5f, py = (float)ly + 0.5f;  // tile-local
  const float f0 = px * px, f1 = py * py, f2 = px * py;
  const int start = starts[t], count = counts[t];
  const long long row0 = start / kRow;
  const int n_chunks = count > 0 ? (int)((start + count + kRow - 1) / kRow - row0) : 0;
  const float l2 = kLog2e;
  const float h = -0.5f * kLog2e;
  const float cut = -2.0f * kLog2e;

  float T = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    if (!__syncthreads_or(T > kTEps)) break;
    for (int j = threadIdx.x; j < kRow; j += blockDim.x) {
      const long long g = (row0 + c) * kRow + j;
      float q[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float op = 0.0f, r = 0.0f, gr = 0.0f, b = 0.0f;
      if (g >= start && g < (long long)start + count) {
        const uint4 e = entries[g];
        op = gs_u8_unit(e.x, 0);
        const float mx = (float)(e.y & 0xFFFu) * (1.0f / 16.0f) - 128.0f;
        const float my = (float)((e.y >> 12) & 0xFFFu) * (1.0f / 16.0f) - 128.0f;
        const float ca = gs_f16_bits_to_f32(e.z & 0xFFFFu);
        const float cb = gs_f16_bits_to_f32(e.z >> 16);
        const float cc = gs_f16_bits_to_f32(e.w & 0xFFFFu);
        if (mxu) {
          q[0] = h * ca;
          q[1] = h * cc;
          q[2] = -l2 * cb;
          q[3] = l2 * fmaf(ca, mx, cb * my);
          q[4] = l2 * fmaf(cc, my, cb * mx);
          q[5] = -l2 * fmaf(cb * mx, my, 0.5f * fmaf(ca * mx, mx, (cc * my) * my));
        } else {
          q[0] = mx;
          q[1] = my;
          q[2] = ca * h;
          q[3] = cb * -l2;
          q[4] = cc * h;
        }
        r = gs_u8_unit(e.w, 16);
        gr = gs_u8_unit(e.w, 24);
        b = gs_u8_unit(e.y, 24);
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) s_q[i][j] = q[i];
      s_op[j] = op;
      s_r[j] = r;
      s_g[j] = gr;
      s_b[j] = b;
    }
    __syncthreads();
    float excl = 1.0f, sr = 0.0f, sg = 0.0f, sb = 0.0f;
    for (int k = 0; k < kRow; ++k) {
      float power2;
      if (mxu) {
        power2 = f0 * s_q[0][k];
        power2 = fmaf(f1, s_q[1][k], power2);
        power2 = fmaf(f2, s_q[2][k], power2);
        power2 = fmaf(px, s_q[3][k], power2);
        power2 = fmaf(py, s_q[4][k], power2);
        power2 = fmaf(1.0f, s_q[5][k], power2);
      } else {
        const float dx = px - s_q[0][k], dy = py - s_q[1][k];
        power2 = (s_q[2][k] * dx + s_q[3][k] * dy) * dx + (s_q[4][k] * dy) * dy;
      }
      float a;
      if (flat_mode)
        a = power2 >= cut ? s_op[k] : 0.0f;
      else
        a = s_op[k] * exp2f(fminf(power2, 0.0f));
      if (a < kAlphaEps) continue;
      const float w = excl * a;
      sr += w * s_r[k];
      sg += w * s_g[k];
      sb += w * s_b[k];
      excl *= 1.0f - a;
    }
    acc_r += T * sr;
    acc_g += T * sg;
    acc_b += T * sb;
    T *= excl;
  }

  const int x = (t % tiles_x) * tile + lx, y = (t / tiles_x) * tile + ly;
  if (x < width && y < height) {
    float4* o = reinterpret_cast<float4*>(out) + (long long)y * width + x;
    *o = make_float4(acc_r, acc_g, acc_b, 1.0f - T);
  }
}

}  // namespace

// entries: (E, 4) u32 sorted live entries; starts, counts: (n_tiles,) i32;
// out: (height, width, 4) f32. `mxu`: the quadratic-basis exponent (the
// caller passes 0 in flat mode, as the reference falls back to Horner there).
extern "C" int gs_composite_rows(const void* entries, const int* starts, const int* counts,
                                 int n_tiles, int tile, int tiles_x, int width, int height,
                                 int flat_mode, int mxu, void* out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile * tile > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  composite_rows_kernel<<<n_tiles, tile * tile, 0, st>>>(
      static_cast<const uint4*>(entries), starts, counts, tile, tiles_x, width, height, flat_mode,
      mxu, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
