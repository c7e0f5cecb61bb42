// K6 - v1 tile compositor: unquantized f32 entry planes -> premultiplied RGBA.
//
// Replaces the Pallas kernel `wgpu_3dgs_viewer_app_tpu/ops/composite.py::
// _composite_kernel`, the compositor of the v1 chain (build_tile_lists ->
// build_entry_planes -> composite_tiles). Its input is nine f32 planes
// (mean x, mean y, conic A, B, C, alpha, r, g, b), 128 entries a row; every
// tile's run starts on a row (`row_starts`) and is padded to whole rows with
// zero-alpha entries. One block per screen tile, one thread per pixel (tile *
// tile <= 1024 threads). Per row of the run, the block stages the 9 x 128
// floats in shared memory (coalesced: consecutive threads, consecutive
// entries of a plane), then every pixel thread walks the row in order:
// power = -0.5 (A dx^2 + C dy^2) - B dx dy at the absolute pixel centre,
// alpha = op * exp(min(power, 0)) in splat mode or the flat opacity inside
// power >= -2 in ellipse/point mode, clamped to 0.99 per pixel and dropped
// below 1/255. As in the reference's chunk form, a pixel's weights inside a
// row are T(row start) * excl * alpha, summed per row and added to the pixel,
// and T takes the row's product of (1 - alpha) after it. Before each row the
// block stops if no pixel of the tile has T > 1/255 (__syncthreads_or): the
// reference's own test, because v1 runs are row-aligned per tile, so the
// kernel differs from its plain version by rounding only.
//
// What bounds it on an H100: operations, not memory. A row is 4.5 KB read
// once per tile, then evaluated by all tile * tile threads (~26 flops and an
// expf per entry and pixel). The design stages each row once per block and
// broadcasts it from shared memory (every thread of a warp reads the same
// address), and skips the blend of entries below the alpha floor. It reads
// 36 B an entry against K3's 16 and calls expf, not exp2f.
#include "common.cuh"

namespace {

constexpr int kRow = 128;
constexpr int kPlanes = 9;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kTEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kFlatCut = -2.0f;

__global__ void __launch_bounds__(1024)
composite_v1_kernel(const float* __restrict__ ent, long long plane_stride,
                    const int* __restrict__ row_starts, const int* __restrict__ counts, int tile,
                    int tiles_x, int width, int height, int flat_mode, float* __restrict__ out) {
  // Plane order of `ops/binning.py::PLANE_FIELDS`.
  __shared__ float s[kPlanes][kRow];
  enum { MX, MY, CA, CB, CC, OP, R, G, B };

  const int t = blockIdx.x;
  const int x = (t % tiles_x) * tile + (int)threadIdx.x % tile;
  const int y = (t / tiles_x) * tile + (int)threadIdx.x / tile;
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;  // absolute pixel centre
  const long long row0 = row_starts[t];
  const int n_rows = (counts[t] + kRow - 1) / kRow;

  float T = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int c = 0; c < n_rows; ++c) {
    if (!__syncthreads_or(T > kTEps)) break;
    const float* row = ent + (row0 + c) * kRow;
    for (int j = threadIdx.x; j < kPlanes * kRow; j += blockDim.x)
      s[j / kRow][j % kRow] = row[(long long)(j / kRow) * plane_stride + j % kRow];
    __syncthreads();
    float excl = 1.0f, sr = 0.0f, sg = 0.0f, sb = 0.0f;
    for (int k = 0; k < kRow; ++k) {
      const float dx = px - s[MX][k], dy = py - s[MY][k];
      const float power = -0.5f * (s[CA][k] * dx * dx + s[CC][k] * dy * dy) - s[CB][k] * dx * dy;
      float a;
      if (flat_mode)
        a = power >= kFlatCut ? s[OP][k] : 0.0f;
      else
        a = s[OP][k] * expf(fminf(power, 0.0f));
      a = fminf(a, kAlphaMax);
      if (a < kAlphaEps) continue;
      const float w = T * excl * a;
      sr += w * s[R][k];
      sg += w * s[G][k];
      sb += w * s[B][k];
      excl *= 1.0f - a;
    }
    acc_r += sr;
    acc_g += sg;
    acc_b += sb;
    T *= excl;
  }

  if (x < width && y < height) {
    float4* o = reinterpret_cast<float4*>(out) + (long long)y * width + x;
    *o = make_float4(acc_r, acc_g, acc_b, 1.0f - T);
  }
}

}  // namespace

// ent: (9, n_rows, 128) f32; row_starts, counts: (n_tiles,) i32; out: (height,
// width, 4) f32.
extern "C" int gs_composite_v1(const void* ent, long long n_rows, const int* row_starts,
                               const int* counts, int n_tiles, int tile, int tiles_x, int width,
                               int height, int flat_mode, void* out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile * tile > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  composite_v1_kernel<<<n_tiles, tile * tile, 0, st>>>(
      static_cast<const float*>(ent), n_rows * kRow, row_starts, counts, tile, tiles_x, width,
      height, flat_mode, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
