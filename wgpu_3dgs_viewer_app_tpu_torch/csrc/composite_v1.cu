// K6 - v1 tile compositor: unquantized f32 entry planes -> premultiplied RGBA.
//
// Replaces the Pallas kernel `wgpu_3dgs_viewer_app_tpu/ops/composite.py::
// _composite_kernel`, the compositor of the v1 chain (build_tile_lists ->
// build_entry_planes -> composite_tiles). Its input is nine f32 planes
// (mean x, mean y, conic A, B, C, alpha, r, g, b), 128 entries a row; every
// tile's run starts on a row (`row_starts`) and is padded to whole rows with
// zero-alpha entries. Up to 32 px a tile is one block of one thread per
// pixel (composite_v1_kernel); above, each thread takes 4 consecutive pixels
// of one tile row, as K3 does (composite_v1_bands_kernel; composite.cuh: one
// block up to 64 px, a cluster of row bands above). 4 pixels a thread at 32
// px was a little faster on the config-1 frame but much slower on the
// sparse flat config-0 shapes (PERF.md), so tiles up to 32 keep the
// one-pixel kernel. Per row of the run, the block stages the 9 x 128 floats
// in shared memory (coalesced: consecutive threads, consecutive entries of a
// plane), then every thread walks the row in order: power = -0.5 (A dx^2 +
// C dy^2) - B dx dy at the absolute pixel centre, alpha = op * exp(min(power,
// 0)) in splat mode or the flat opacity inside power >= -2 in ellipse/point
// mode, clamped to 0.99 per pixel and dropped below 1/255. With 4 pixels a
// thread the entry's shared loads, dy and C dy^2 are paid once per 4 pixels;
// each pixel's operations are the same, in the same order. As in the reference's chunk
// form, a pixel's weights inside a row are T(row start) * excl * alpha,
// summed per row and added to the pixel, and T takes the row's product of
// (1 - alpha) after it. Before each row the tile stops if none of its pixels
// has T > 1/255: the reference's own test, because v1 runs are row-aligned
// per tile, so the kernel differs from its plain version by rounding only.
//
// What bounds it on an H100: operations, not memory. A row is 4.5 KB read
// once per tile, then evaluated by every pixel (~26 flops and an expf per
// entry and pixel). The design stages each row once per block and
// broadcasts it from shared memory (every thread of a warp reads the same
// address), and skips the blend of entries below the alpha floor. It reads
// 36 B an entry against K3's 16 and calls expf, not exp2f.
#include "common.cuh"
#include "composite.cuh"

namespace {

constexpr int kRow = 128;
constexpr int kPlanes = 9;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kTEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kFlatCut = -2.0f;

// Tiles up to 32 px: one block a tile, one thread a pixel.
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

// Tiles over 32 px: kPx pixels of a row a thread; kCluster: the tile is a
// cluster of `bands` blocks of `band_rows` rows (composite.cuh). Each pixel's
// operations are the one-pixel kernel's, in the same order.
template <bool kCluster>
__global__ void __launch_bounds__(gs_tiles::kMaxBlockThreads, 1)
composite_v1_bands_kernel(const float* __restrict__ ent, long long plane_stride,
                    const int* __restrict__ row_starts, const int* __restrict__ counts, int tile,
                    int tiles_x, int width, int height, int flat_mode, int bands, int band_rows,
                    float* __restrict__ out) {
  // Plane order of `ops/binning.py::PLANE_FIELDS`.
  __shared__ float s[kPlanes][kRow];
  __shared__ int s_open[2];
  enum { MX, MY, CA, CB, CC, OP, R, G, B };

  using gs_tiles::kPx;
  const int t = kCluster ? (int)blockIdx.x / bands : (int)blockIdx.x;
  const int groups = (tile + kPx - 1) / kPx;
  const int lx0 = (int)threadIdx.x % groups * kPx;
  const int ly = (kCluster ? (int)blockIdx.x % bands * band_rows : 0) + (int)threadIdx.x / groups;
  const int x0 = (t % tiles_x) * tile + lx0;
  const int y = (t / tiles_x) * tile + ly;
  const float py = (float)y + 0.5f;  // absolute pixel centre
  float px[kPx], T[kPx], acc_r[kPx], acc_g[kPx], acc_b[kPx];
#pragma unroll
  for (int i = 0; i < kPx; ++i) {
    px[i] = (float)(x0 + i) + 0.5f;
    // Pixels past the tile's edge start at T = 0: they neither hold the tile
    // up nor get stored.
    T[i] = lx0 + i < tile && ly < tile ? 1.0f : 0.0f;
    acc_r[i] = acc_g[i] = acc_b[i] = 0.0f;
  }
  const long long row0 = row_starts[t];
  const int n_rows = (counts[t] + kRow - 1) / kRow;

  for (int c = 0; c < n_rows; ++c) {
    bool open = false;
#pragma unroll
    for (int i = 0; i < kPx; ++i) open = open || T[i] > kTEps;
    // Also the barrier before the staging overwrites the previous row.
    if (!gs_tiles::tile_open<kCluster>(open, s_open, c)) break;
    const float* row = ent + (row0 + c) * kRow;
    for (int j = threadIdx.x; j < kPlanes * kRow; j += blockDim.x)
      s[j / kRow][j % kRow] = row[(long long)(j / kRow) * plane_stride + j % kRow];
    __syncthreads();
    float excl[kPx], sr[kPx], sg[kPx], sb[kPx];
#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      excl[i] = 1.0f;
      sr[i] = sg[i] = sb[i] = 0.0f;
    }
    for (int k = 0; k < kRow; ++k) {
      const float dy = py - s[MY][k];
      const float ccdy2 = s[CC][k] * dy * dy;
      const float mx = s[MX][k], ca = s[CA][k], cb = s[CB][k], op = s[OP][k];
#pragma unroll
      for (int i = 0; i < kPx; ++i) {
        const float dx = px[i] - mx;
        const float power = -0.5f * (ca * dx * dx + ccdy2) - cb * dx * dy;
        float a;
        if (flat_mode)
          a = power >= kFlatCut ? op : 0.0f;
        else
          a = op * expf(fminf(power, 0.0f));
        a = fminf(a, kAlphaMax);
        if (a < kAlphaEps) continue;
        const float w = T[i] * excl[i] * a;
        sr[i] += w * s[R][k];
        sg[i] += w * s[G][k];
        sb[i] += w * s[B][k];
        excl[i] *= 1.0f - a;
      }
    }
#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      acc_r[i] += sr[i];
      acc_g[i] += sg[i];
      acc_b[i] += sb[i];
      T[i] *= excl[i];
    }
  }
  gs_tiles::tile_done<kCluster>();

  if (ly < tile && y < height) {
    float4* o = reinterpret_cast<float4*>(out) + (long long)y * width + x0;
#pragma unroll
    for (int i = 0; i < kPx; ++i)
      if (lx0 + i < tile && x0 + i < width)
        o[i] = make_float4(acc_r[i], acc_g[i], acc_b[i], 1.0f - T[i]);
  }
}

}  // namespace

// ent: (9, n_rows, 128) f32; row_starts, counts: (n_tiles,) i32; out: (height,
// width, 4) f32. Tiles of 1-256 px; returns gs_tiles::kErrNoCluster if a
// tile's cluster cannot be placed on the card.
extern "C" int gs_composite_v1(const void* ent, long long n_rows, const int* row_starts,
                               const int* counts, int n_tiles, int tile, int tiles_x, int width,
                               int height, int flat_mode, void* out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto e = static_cast<const float*>(ent);
  auto o = static_cast<float*>(out);
  const long long stride = n_rows * kRow;
  if (tile <= 32) {
    composite_v1_kernel<<<n_tiles, tile * tile, 0, st>>>(e, stride, row_starts, counts, tile,
                                                          tiles_x, width, height, flat_mode, o);
    return (int)cudaGetLastError();
  }
  const gs_tiles::Bands b = gs_tiles::bands_for(tile);
  if (b.bands > gs_tiles::kMaxBands) return (int)cudaErrorInvalidValue;
  if (b.bands == 1)
    return gs_tiles::launch(composite_v1_bands_kernel<false>, n_tiles, b, st, e, stride,
                            row_starts, counts, tile, tiles_x, width, height, flat_mode, b.bands,
                            b.rows, o);
  return gs_tiles::launch(composite_v1_bands_kernel<true>, n_tiles, b, st, e, stride, row_starts,
                          counts, tile, tiles_x, width, height, flat_mode, b.bands, b.rows, o);
}
