// K3 - tile compositor: key-sorted packed entries -> premultiplied RGBA.
//
// Replaces the Pallas kernel `wgpu_3dgs_viewer_app_tpu/ops/composite.py::
// _composite_kernel_v2t` (and computes the function of its row-major twin
// `_composite_kernel_v2`). One block per screen tile, one thread per pixel
// (tile * tile <= 1024 threads). The tile's front-to-back entry run is
// staged through shared memory in batches of 256 entries: each entry is
// decoded once per block (alpha u8 from the key's low byte, u12.u12
// tile-relative means, f16 conic through the repo's integer decoder, u8
// colour) into log2-prescaled rows, then every pixel thread blends the batch
// in order. Alpha = op * 2^min(power2, 0) in splat mode, or the flat opacity
// inside the 2-sigma cut in ellipse/point mode; alpha < 1/255 is dropped.
// The block stops when no pixel of the tile has transmittance above 1/255
// (__syncthreads_count), checked per batch: the result differs from the
// reference's 128-entry-chunk exit by at most the remaining transmittance,
// 1/255 a channel.
//
// What bounds it on an H100: arithmetic and shared-memory bandwidth, not
// device memory. Each entry is read once per tile (16 bytes) but evaluated
// by all tile * tile pixel threads (~12 flops and one exp2 each), so the
// per-pixel loop over shared memory is the hot spot. The design decodes
// each entry once per block instead of once per pixel, broadcasts the
// decoded rows from shared memory (every thread of a warp reads the same
// address), and skips the blend for entries below the alpha floor.
#include "common.cuh"

namespace {

constexpr int kBatch = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kTEps = 1.0f / 255.0f;

__global__ void __launch_bounds__(1024)
composite_kernel(const uint4* __restrict__ entries, const int* __restrict__ starts,
                 const int* __restrict__ counts, int tile, int tiles_x, int width, int height,
                 int flat_mode, float* __restrict__ out) {
  __shared__ float s_op[kBatch], s_mx[kBatch], s_my[kBatch];
  __shared__ float s_a2[kBatch], s_b2[kBatch], s_c2[kBatch];
  __shared__ float s_r[kBatch], s_g[kBatch], s_b[kBatch];

  const int t = blockIdx.x;
  const int lx = threadIdx.x % tile, ly = threadIdx.x / tile;
  const float px = (float)lx + 0.5f, py = (float)ly + 0.5f;  // tile-local
  const int start = starts[t], count = counts[t];
  // -0.5 * log2(e) folded into the conic rows.
  const float s_half = -0.5f * kLog2e;
  const float cut = -2.0f * kLog2e;

  float T = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int b0 = 0; b0 < count; b0 += kBatch) {
    if (__syncthreads_count(T > kTEps) == 0) break;
    for (int j = threadIdx.x; j < kBatch; j += blockDim.x) {
      float op = 0.0f;
      if (b0 + j < count) {
        const uint4 e = entries[start + b0 + j];
        op = gs_u8_unit(e.x, 0);
        s_mx[j] = (float)(e.y & 0xFFFu) * (1.0f / 16.0f) - 128.0f;
        s_my[j] = (float)((e.y >> 12) & 0xFFFu) * (1.0f / 16.0f) - 128.0f;
        s_a2[j] = gs_f16_bits_to_f32(e.z & 0xFFFFu) * s_half;
        s_b2[j] = gs_f16_bits_to_f32(e.z >> 16) * (-kLog2e);
        s_c2[j] = gs_f16_bits_to_f32(e.w & 0xFFFFu) * s_half;
        s_r[j] = gs_u8_unit(e.w, 16);
        s_g[j] = gs_u8_unit(e.w, 24);
        s_b[j] = gs_u8_unit(e.y, 24);
      }
      s_op[j] = op;
    }
    __syncthreads();
    const int nb = min(kBatch, count - b0);
    for (int j = 0; j < nb; ++j) {
      const float dx = px - s_mx[j], dy = py - s_my[j];
      const float power2 = (s_a2[j] * dx + s_b2[j] * dy) * dx + (s_c2[j] * dy) * dy;
      float a;
      if (flat_mode)
        a = power2 >= cut ? s_op[j] : 0.0f;
      else
        a = s_op[j] * exp2f(fminf(power2, 0.0f));
      if (a < kAlphaEps) continue;
      const float w = T * a;
      acc_r += w * s_r[j];
      acc_g += w * s_g[j];
      acc_b += w * s_b[j];
      T *= 1.0f - a;
    }
  }

  const int x = (t % tiles_x) * tile + lx, y = (t / tiles_x) * tile + ly;
  if (x < width && y < height) {
    float4* o = reinterpret_cast<float4*>(out) + (int64_t)y * width + x;
    *o = make_float4(acc_r, acc_g, acc_b, 1.0f - T);
  }
}

}  // namespace

extern "C" int gs_composite(const void* entries, const int* starts, const int* counts,
                            int n_tiles, int tile, int tiles_x, int width, int height,
                            int flat_mode, void* out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile * tile > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  composite_kernel<<<n_tiles, tile * tile, 0, st>>>(static_cast<const uint4*>(entries), starts,
                                                    counts, tile, tiles_x, width, height,
                                                    flat_mode, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
