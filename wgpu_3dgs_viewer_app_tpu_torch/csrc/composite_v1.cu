// K6 - v1 tile compositor: unquantized f32 entry planes -> premultiplied RGBA.
//
// Replaces the Pallas kernel `wgpu_3dgs_viewer_app_tpu/ops/composite.py::
// _composite_kernel`, the compositor of the v1 chain (build_tile_lists ->
// build_entry_planes -> composite_tiles). Its input is nine f32 planes
// (mean x, mean y, conic A, B, C, alpha, r, g, b), 128 entries a row; every
// tile's run starts on a row (`row_starts`) and is padded to whole rows with
// zero-alpha entries. Per pixel and entry, as the plain version
// `composite_tiles_plain` does and in its order: power = -0.5 (A dx^2 + C
// dy^2) - B dx dy at the absolute pixel centre, alpha = op * exp(min(power,
// 0)) in splat mode or the flat opacity inside power >= -2 in ellipse/point
// mode, clamped to 0.99 and dropped below 1/255. As in the reference's chunk
// form, a pixel's weights inside a row are T(row start) * excl * alpha,
// summed per row and added to the pixel, and T takes the row's product of
// (1 - alpha) after it. Before each row the tile stops if none of its pixels
// (those past the image's edge included) has T > 1/255: the reference's own
// test, because v1 runs are row-aligned per tile, so the kernel differs
// from its plain version by rounding only.
//
// What bounds it on an H100: operations, not memory. A row is 4.5 KB read
// once per tile, then evaluated by the tile's pixels (26 operations and an
// expf a blend). A straight walk evaluates every (pixel, entry) pair of
// every row the tile reads, about twice the blends the data needs at config
// 1, at ~40 instructions each (the expf in full range, nine shared loads a
// pair at one pixel a thread): issue-bound on work it could skip. The design
// skips that work and leaves the image bit for bit as the straight walk
// makes it:
//   - each row is decoded once a block into packed shared rows, with each
//     entry's box: the pixels where power can reach the alpha floor's
//     ln(1/(255 op)) (splat) or -2 (flat), widened far beyond the rounding
//     (composite.cuh, box_radii). A thread whose pixels all lie outside
//     reads one 16-byte value and moves on; the others read two more;
//   - below a per-entry power threshold alpha is under the floor for
//     certain, and the expf is skipped; where it can matter it is the
//     parent's expf, so every alpha is the same float;
//   - the rows are copied in with cp.async two ahead of the blend into a
//     ring of two raw rows, and decoded one ahead into two packed rows, so a
//     row costs one barrier (the exit test's);
//   - only the live entries of the tile's last row are walked;
//   - kPx consecutive pixels of a row a thread (the entry's loads, dy and C
//     dy^2 once per kPx blends; each pixel's operations the same, in the
//     same order): 4 on tiles over 32 px (composite.cuh: one block up to 64,
//     a cluster of row bands up to 256, 32-px parts in two launches above),
//     and 4 or 1 on tiles up to 32, chosen per launch from the number of
//     tiles: below 4 blocks an SM, one pixel a thread keeps four times the
//     warps in flight on frames of few tiles.
#include <cmath>

#include "common.cuh"
#include "composite.cuh"

namespace {

using gs_tiles::cp_async16;
using gs_tiles::cp_async_commit;
using gs_tiles::cp_async_wait;

constexpr int kRow = 128;
constexpr int kPlanes = 9;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kTEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kFlatCut = -2.0f;
// Margins (natural-log units) of the box and of the expf skip below the
// alpha floor's power, far wider than the rounding of power and expf: the
// power's rounded operations err by at most ~3 * 2^-24 of the sum of its
// terms' magnitudes, under 1e-3 of |power| for the forms box_radii bounds
// (condition number under ~2000), so ~7e-3 where power is near the floor's
// level (>= -5.6): kBoxMargin is 18 times that.
constexpr float kBoxMargin = 1.0f / 8.0f;
constexpr float kSkipMargin = 1.0f / 64.0f;
// Blocks of 256 threads (4 pixels a thread on a 32-px tile) an SM below
// which a launch of tiles up to 32 px takes one pixel a thread.
constexpr int kFewBlocksPerSm = 4;

// Plane order of `ops/binning.py::PLANE_FIELDS`.
enum { MX, MY, CA, CB, CC, OP, R, G, B };

// kPxT pixels a thread; kFlat: ellipse/point mode; kPass, kCluster: the
// tile's mapping (composite.cuh); kThreads, kMinBlocks: the launch bounds.
template <int kPxT, bool kFlat, int kPass, bool kCluster, int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
composite_v1_kernel(const float* __restrict__ ent, long long plane_stride,
                    const int* __restrict__ row_starts, const int* __restrict__ counts, int tile,
                    int tiles_x, int width, int height, int bands, int band_rows, int side,
                    int* __restrict__ scratch, float* __restrict__ out) {
  __shared__ __align__(16) float s_raw[2][kPlanes * kRow];
  // box = (mx, my, rx, ry), a = (A, B, C, op), b = (r, g, b, thr).
  __shared__ float4 s_box[2][kRow], s_a[2][kRow], s_b[2][kRow];
  __shared__ int s_open[2];

  const gs_tiles::Place pl =
      gs_tiles::place<kPass, gs_tiles::kParts, kCluster, kPxT>(tile, bands, band_rows, side, 0);
  const int t = pl.t;
  const int ox = (t % tiles_x) * tile, oy = (t / tiles_x) * tile;
  const int x0 = ox + pl.lx0, y = oy + pl.ly;
  const float px0 = (float)x0 + 0.5f, py = (float)y + 0.5f;  // absolute pixel centres
  float T[kPxT], acc_r[kPxT], acc_g[kPxT], acc_b[kPxT];
#pragma unroll
  for (int i = 0; i < kPxT; ++i) {
    // Pixels past the tile's edge start at T = 0: they neither hold the
    // tile up nor get stored.
    T[i] = pl.lx0 + i < tile && pl.ly < tile ? 1.0f : 0.0f;
    acc_r[i] = acc_g[i] = acc_b[i] = 0.0f;
  }
  const long long row0 = row_starts[t];
  const int count = counts[t];
  const int n_rows = (count + kRow - 1) / kRow;
  int c = 0, c_end = n_rows;
  if (kPass == gs_tiles::kResume) {
    // Resume the in-image pixels from pass 1's state; the others are not stored.
    gs_tiles::resume_range(scratch, t, side, ox + pl.part_x < width && oy + pl.part_y < height,
                           &c, &c_end);
    const float4* o = reinterpret_cast<const float4*>(out) + (long long)y * width + x0;
#pragma unroll
    for (int i = 0; i < kPxT; ++i) {
      if (T[i] > 0.0f && x0 + i < width && y < height) {
        const float4 v = o[i];
        acc_r[i] = v.x, acc_g[i] = v.y, acc_b[i] = v.z, T[i] = v.w;
      } else {
        T[i] = 0.0f;
      }
    }
  }

  // Row r's nine plane rows -> s_raw[r & 1], 16 bytes a copy.
  auto stage = [&](int r) {
    const float* src = ent + (row0 + r) * kRow;
    for (int j = threadIdx.x; j < kPlanes * kRow / 4; j += blockDim.x) {
      const int plane = j / (kRow / 4), q = j % (kRow / 4) * 4;
      cp_async16(&s_raw[r & 1][plane * kRow + q], src + plane * plane_stride + q);
    }
  };
  // s_raw[r & 1] -> the packed row r & 1, with each entry's box and threshold.
  auto decode = [&](int r) {
    const float* s = s_raw[r & 1];
    for (int j = threadIdx.x; j < kRow; j += blockDim.x) {
      const float op = s[OP * kRow + j], ca = s[CA * kRow + j], cb = s[CB * kRow + j],
                  cc = s[CC * kRow + j];
      // power at which alpha reaches the floor, and the box around it.
      const float level = kFlat ? kFlatCut : logf(kAlphaEps / op);
      float rx = INFINITY, ry = INFINITY;
      if (!(op >= kAlphaEps)) rx = ry = -1.0f;  // never blends (padding: op 0)
      else gs_tiles::box_radii(-0.5f * ca, -cb, -0.5f * cc, level - kBoxMargin, &rx, &ry);
      s_box[r & 1][j] = make_float4(s[MX * kRow + j], s[MY * kRow + j], rx, ry);
      s_a[r & 1][j] = make_float4(ca, cb, cc, op);
      s_b[r & 1][j] = make_float4(s[R * kRow + j], s[G * kRow + j], s[B * kRow + j],
                                  level - kSkipMargin);
    }
  };

  if (c < c_end) stage(c);
  cp_async_commit();
  if (c + 1 < c_end) stage(c + 1);
  cp_async_commit();
  cp_async_wait<1>();  // row c's copies have landed (this thread's)
  __syncthreads();     // ... and every thread's
  if (c < c_end) decode(c);
  for (; c < c_end; ++c) {
    cp_async_wait<0>();  // row c + 1's copies (this thread's)
    // The one barrier of a row: row c decoded, row c + 1 copied, row c - 1
    // blended by every thread of the block.
    if (kPass == gs_tiles::kResume) {
      __syncthreads();  // pass 2 walks to the tile's exit row with no test
    } else {
      bool open = false;
#pragma unroll
      for (int i = 0; i < kPxT; ++i) open = open || T[i] > kTEps;
      if (!gs_tiles::tile_open<kCluster>(open, s_open, c)) break;
    }
    if (c + 2 < c_end) stage(c + 2);  // into the raw row that row c was decoded from
    cp_async_commit();
    if (c + 1 < c_end) decode(c + 1);

    const float4* box = s_box[c & 1];
    const float4* sa = s_a[c & 1];
    const float4* sb = s_b[c & 1];
    const int live = min(kRow, count - c * kRow);  // past it: zero-alpha padding
    float excl[kPxT], sr[kPxT], sg[kPxT], sbl[kPxT];
#pragma unroll
    for (int i = 0; i < kPxT; ++i) {
      excl[i] = 1.0f;
      sr[i] = sg[i] = sbl[i] = 0.0f;
    }
#pragma unroll 2
    for (int k = 0; k < live; ++k) {
      // Entries whose box misses all of the thread's pixels add nothing to them.
      const float4 bx = box[k];
      const float dy = py - bx.y;
      if (fabsf(dy) > bx.w || px0 - bx.x > bx.z || bx.x - (px0 + (float)(kPxT - 1)) > bx.z)
        continue;
      const float4 A = sa[k];
      const float4 Bv = sb[k];
      const float ccdy2 = A.z * dy * dy;
#pragma unroll
      for (int i = 0; i < kPxT; ++i) {
        const float dx = (px0 + (float)i) - bx.x;
        const float power = -0.5f * (A.x * dx * dx + ccdy2) - A.y * dx * dy;
        // Below thr, op * exp(power) < 1/255 for certain: expf is skipped.
        float a = 0.0f;
        if (kFlat)
          a = power >= kFlatCut ? A.w : 0.0f;
        else if (!(power < Bv.w))
          a = A.w * expf(fminf(power, 0.0f));
        a = fminf(a, kAlphaMax);
        if (!(a < kAlphaEps)) {
          const float w = T[i] * excl[i] * a;
          sr[i] += w * Bv.x;
          sg[i] += w * Bv.y;
          sbl[i] += w * Bv.z;
          excl[i] *= 1.0f - a;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPxT; ++i) {
      acc_r[i] += sr[i];
      acc_g[i] += sg[i];
      acc_b[i] += sbl[i];
      T[i] *= excl[i];
    }
  }
  cp_async_wait<0>();
  gs_tiles::tile_done<kCluster>();
  if (kPass == gs_tiles::kFirst) gs_tiles::record_exit(scratch, t, side, c);

  if (pl.ly < tile && y < height) {
    float4* o = reinterpret_cast<float4*>(out) + (long long)y * width + x0;
#pragma unroll
    for (int i = 0; i < kPxT; ++i)
      if (pl.lx0 + i < tile && x0 + i < width)
        o[i] = make_float4(acc_r[i], acc_g[i], acc_b[i],
                           kPass == gs_tiles::kFirst ? T[i] : 1.0f - T[i]);
  }
}

struct Args {
  const float* ent;
  long long stride;
  const int* row_starts;
  const int* counts;
  int n_tiles, tile, tiles_x, width, height, px;  // px: pixels a thread, tiles <= 32
  int* scratch;
  float* out;
  cudaStream_t st;
};

template <bool kFlat>
int launch_mode(const Args& a) {
  using gs_tiles::kFirst;
  using gs_tiles::kResume;
  using gs_tiles::kWhole;
  constexpr int kSmall = gs_tiles::kSmallThreads, kBig = gs_tiles::kMaxBlockThreads;
  if (a.tile > gs_tiles::kMaxClusterTile)
    return gs_tiles::launch_parts(
        composite_v1_kernel<gs_tiles::kPx, kFlat, kFirst, false, kSmall, 4>,
        composite_v1_kernel<gs_tiles::kPx, kFlat, kResume, false, kSmall, 4>, a.n_tiles, a.tile,
        gs_tiles::kPart * (gs_tiles::kPart / gs_tiles::kPx), a.st, a.ent, a.stride,
        a.row_starts, a.counts, a.tile, a.tiles_x, a.width, a.height, 1, 0,
        gs_tiles::part_side(a.tile), a.scratch, a.out);
  if (a.tile <= 32) {
    gs_tiles::Bands b = {a.tile, 1, a.tile, a.tile * a.tile};
    if (a.px == 1)
      return gs_tiles::launch(composite_v1_kernel<1, kFlat, kWhole, false, kBig, 1>, a.n_tiles,
                              b, a.st, a.ent, a.stride, a.row_starts, a.counts, a.tile,
                              a.tiles_x, a.width, a.height, 1, 0, 0, a.scratch, a.out);
    b = gs_tiles::bands_for(a.tile);
    return gs_tiles::launch(composite_v1_kernel<gs_tiles::kPx, kFlat, kWhole, false, kSmall, 4>,
                            a.n_tiles, b, a.st, a.ent, a.stride, a.row_starts, a.counts, a.tile,
                            a.tiles_x, a.width, a.height, 1, 0, 0, a.scratch, a.out);
  }
  const gs_tiles::Bands b = gs_tiles::bands_for(a.tile);
  if (b.bands == 1)
    return gs_tiles::launch(composite_v1_kernel<gs_tiles::kPx, kFlat, kWhole, false, kBig, 1>,
                            a.n_tiles, b, a.st, a.ent, a.stride, a.row_starts, a.counts, a.tile,
                            a.tiles_x, a.width, a.height, b.bands, b.rows, 0, a.scratch, a.out);
  return gs_tiles::launch(composite_v1_kernel<gs_tiles::kPx, kFlat, kWhole, true, kBig, 1>,
                          a.n_tiles, b, a.st, a.ent, a.stride, a.row_starts, a.counts, a.tile,
                          a.tiles_x, a.width, a.height, b.bands, b.rows, 0, a.scratch, a.out);
}

// The launch with `px` pixels a thread on tiles up to 32 px (1 or kPx).
int run(const void* ent, long long n_rows, const int* row_starts, const int* counts, int n_tiles,
        int tile, int tiles_x, int width, int height, int flat_mode, int px, int* scratch,
        void* out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile < 1 || (px != 1 && px != gs_tiles::kPx) ||
      (tile > gs_tiles::kMaxClusterTile && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a = {static_cast<const float*>(ent), n_rows * kRow, row_starts, counts, n_tiles,
                  tile, tiles_x, width, height, px, scratch, static_cast<float*>(out),
                  static_cast<cudaStream_t>(stream)};
  return flat_mode ? launch_mode<true>(a) : launch_mode<false>(a);
}

}  // namespace

// ent: (9, n_rows, 128) f32; row_starts, counts: (n_tiles,) i32; out: (height,
// width, 4) f32. Any tile >= 1 px; over 256 px two launches, with `scratch`
// n_tiles * (1 + part_side(tile)^2) zeroed ints (composite.cuh), else NULL.
// Tiles up to 32 px take one pixel a thread when there are fewer than
// kFewBlocksPerSm of them an SM, else kPx. Returns gs_tiles::kErrNoCluster if
// a tile's cluster cannot be placed on the card.
extern "C" int gs_composite_v1(const void* ent, long long n_rows, const int* row_starts,
                               const int* counts, int n_tiles, int tile, int tiles_x, int width,
                               int height, int flat_mode, int* scratch, void* out, void* stream) {
  int px = gs_tiles::kPx;
  if (tile <= 32 && n_tiles > 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (n_tiles < kFewBlocksPerSm * sms) px = 1;
  }
  return run(ent, n_rows, row_starts, counts, n_tiles, tile, tiles_x, width, height, flat_mode,
             px, scratch, out, stream);
}

// For measurement only (scripts/ab_port_kernels.py): gs_composite_v1 with
// `px` pixels a thread forced on tiles up to 32 px, 1 or 4.
extern "C" int gs_composite_v1_px(const void* ent, long long n_rows, const int* row_starts,
                                  const int* counts, int n_tiles, int tile, int tiles_x,
                                  int width, int height, int flat_mode, int px, int* scratch,
                                  void* out, void* stream) {
  return run(ent, n_rows, row_starts, counts, n_tiles, tile, tiles_x, width, height, flat_mode,
             px, scratch, out, stream);
}
