// K3 - the v2 tile compositor: key-sorted packed entries -> premultiplied
// RGBA, with the reference's exact 128-entry chunks.
//
// Replaces both Pallas kernels of `composite_tiles_pallas_v2`:
// `wgpu_3dgs_viewer_app_tpu/ops/composite.py::_composite_kernel_v2` (:489,
// row-major) and `_composite_kernel_v2t` (:639, transposed). They compute
// one function and differ only in a TPU lane layout, so every combination
// of `transposed` and `mxu` launches this kernel. A tile's run is walked in
// the reference's chunks: chunk c is global entry row start / 128 + c, and
// entries of that row outside the tile's run [start, start + count) are
// dead (opacity 0). Before each chunk the block stops if no pixel of the
// tile has T > 1/255 (__syncthreads_or), the reference's own test. Inside a
// chunk each pixel forms w = excl * alpha and sums w * (r, g, b); after it,
// acc += T * sums and T *= the chunk's product of (1 - alpha). The exponent
// is in log2 units, alpha = op * 2^min(power2, 0) (splat) or the flat
// opacity inside power2 >= -2 log2(e) (ellipse/point); alpha below 1/255 is
// dropped. Two forms of power2, as the plain version evaluates them:
//   Horner (default): (a2 dx + b2 dy) dx + (c2 dy) dy on pre-scaled rows;
//   quadratic basis (mxu, splat mode only): F = [px^2, py^2, px py, px, py, 1]
//   dotted with the entry's G row, with explicit fmaf where the reference's
//   CPU build fuses (it cancels terms of ~1e4, so each rounding shows);
//   nothing else is contracted (--fmad=false).
//
// What bounds it on an H100: operations, 22 a (pixel, entry) blend in the
// Horner form and 24 in the basis form, plus one exp2; bytes are small (16
// B an entry, read once per tile). In practice its span is the chunk walk
// of its slowest single tiles. On the benchmark's capture-like 1080p scenes
// (scripts/profile_port_frame.py --tiles --scene ...) most tiles exit after
// 1-3 chunks, 331-629 of 2040 walk more than 4, and the few whose pixels
// never saturate walk 21-137, one after another, at ~25-30 us a chunk on
// one SM: in one launch, one such tile alone took 65-94% of it. So a tile of
// 23 to 32 px takes two launches (composite.cuh): pass 1 walks every tile in
// one block for at most kChunkBudget chunks, and pass 2 resumes the tiles
// still open across a cluster of 4 bands at one pixel a thread, a warp to
// a block of 8 x 4 pixels, on 4 SMs (a resumed tile's chunk takes ~11-13
// us there). kChunkBudget = 4: over the budgets 2, 3, 4, 8 and 16 it took the
// least K3 time on those scenes within the runs' noise, with 2 and 3 (8 and
// 16 leave 4-16 chunks of the heavy tiles in pass 1's last wave); at 4 a
// frame lists 331-629 tiles. The
// design cuts the instructions of each chunk and leaves the image bit for
// bit as the straight loop makes it:
//   - tile * ceil(tile / 4) threads a tile, each on 4 consecutive pixels of
//     one row: the entry's shared loads, dy, b2 dy and (c2 dy) dy are paid
//     once per 4 blends (the same operations in the same order, so the
//     rounding is the plain version's). Tiles up to 32 px run one block of
//     <= 256 threads (and from 23 px pass 2), up to 64 one block of <= 1024,
//     up to 256 a thread block cluster of row bands that keeps the
//     whole-tile exit test, and larger ones 32-px parts in two launches that
//     keep it too (composite.cuh). A pixel's operations do not depend on
//     which thread, block or pass runs them;
//   - each chunk is decoded once into packed shared rows, with each entry's
//     box: the pixels where power2 can reach the alpha floor, widened far
//     beyond the rounding (box_radii). A thread whose 4 pixels lie outside
//     reads one 16-byte row and moves on; the others read two more (three
//     in the basis form);
//   - below a per-entry power2 threshold alpha is under the floor for
//     certain, and the exp2 is skipped; the exp2 itself is MUFU.EX2 alone;
//   - the Horner loop takes two entries a step (their exponents overlap);
//   - the next chunk's raw entries are copied in with cp.async into a
//     second buffer while the current chunk blends;
//   - only the live span of a chunk is walked (a tile's first and last
//     chunks hold entries of its neighbours);
//   - <= 64 registers a thread, so that four 256-thread blocks (or one of
//     1024) share an SM;
//   - each thread stores its 4 pixels as one 64-byte run.
#include <cmath>

#include "common.cuh"
#include "composite.cuh"

namespace {

// Entries per step of the Horner and flat blend loops (the basis form, at
// the register limit, takes one at a time).
constexpr int kUnroll = 2;
using gs_tiles::cp_async16;
using gs_tiles::cp_async_commit;
using gs_tiles::cp_async_wait;
using gs_tiles::box_radii;
using gs_tiles::kPx;
// Margins (log2 units) of the box and of the exp2f skip below the alpha
// floor's power2, far wider than the rounding of power2 and exp2f.
constexpr float kBoxMargin = 1.0f;
constexpr float kSkipMargin = 1.0f / 64.0f;
constexpr int kRow = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kTEps = 1.0f / 255.0f;
// Chunks a budgeted tile walks in pass 1 before it is handed to pass 2
// (composite.cuh; the reason is in the header note).
constexpr int kChunkBudget = 4;

enum Mode { kHorner = 0, kFlat = 1, kBasis = 2 };

// 2^x: exp2f's own MUFU.EX2 without its subnormal range handling. Where
// the result is normal (x >= -126) the two agree bit for bit; below, both
// are far under the alpha floor, so alpha is dropped either way.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// kThreads, kMinBlocks: 256, 4 (tile <= 32, and the parts of tiles over 256)
// or 1024, 1; kCluster: the tile is a cluster of `bands` blocks of
// `band_rows` rows; kPass, kSplit: the whole tile, or a pass 1 or 2 of parts
// (`side` parts a side, `scratch` their exit chunks) or of a chunk budget
// (`scratch` the list of tiles pass 1 hands on, `state` their pixels,
// `handed` what it hands on while the port traces, else NULL); kPxT pixels a
// thread (composite.cuh).
template <int kMode, int kThreads, int kMinBlocks, bool kCluster, int kPass, int kSplit,
          int kPxT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
composite_v2_kernel(const uint4* __restrict__ entries, const int* __restrict__ starts,
                    const int* __restrict__ counts, int tile, int tiles_x, int width,
                    int height, int bands, int band_rows, int side, int* __restrict__ scratch,
                    float4* __restrict__ state, unsigned long long* __restrict__ handed,
                    float* __restrict__ out) {
  using gs_tiles::kBudget;
  using gs_tiles::kFirst;
  using gs_tiles::kParts;
  using gs_tiles::kResume;
  constexpr bool kListed = kPass == kResume && kSplit == kBudget;
  __shared__ uint4 s_raw[2][kRow];
  // box = (mx, my, rx, ry); Horner and flat: a = (a2, b2, c2, op), b = (r, g,
  // b, thr); quadratic basis: a = (G0, G1, G2, G3), b = (G4, G5, op, thr),
  // c = (r, g, b, -).
  __shared__ float4 s_box[kRow], s_a[kRow], s_b[kRow], s_c[kMode == kBasis ? kRow : 1];
  __shared__ int s_open[2], s_listed;

  // A budgeted pass 2's cluster takes the listed tiles one at a time (after a
  // first cluster barrier: no block writes a peer's shared memory before the
  // peer has started); every other launch one tile a block or cluster.
  if (kListed) cooperative_groups::this_cluster().sync();
  for (;;) {
    const int listed = kListed ? gs_tiles::take_listed(scratch, &s_listed) : 0;
    if (listed < 0) break;
    const gs_tiles::Place pl =
        gs_tiles::place<kPass, kSplit, kCluster, kPxT>(tile, bands, band_rows, side, listed);
    const int t = pl.t, lx0 = pl.lx0, ly = pl.ly;
    const float py = (float)ly + 0.5f;  // tile-local
    const float f1 = py * py;
    float px[kPxT], T[kPxT], acc_r[kPxT], acc_g[kPxT], acc_b[kPxT];
#pragma unroll
    for (int i = 0; i < kPxT; ++i) {
      px[i] = (float)(lx0 + i) + 0.5f;
      // A group's pixels past the tile's edge (tile not a multiple of kPxT, or
      // the last band's spare rows) start at T = 0: they neither hold the tile
      // up nor get stored.
      T[i] = lx0 + i < tile && ly < tile ? 1.0f : 0.0f;
      acc_r[i] = acc_g[i] = acc_b[i] = 0.0f;
    }
    const int start = starts[t], count = counts[t];
    const long long end = (long long)start + count;
    const long long row0 = start / kRow;
    const int n_chunks = count > 0 ? (int)((end + kRow - 1) / kRow - row0) : 0;
    // The thread's first pixel in `state` (budgeted passes).
    float4* const saved =
        kSplit == kBudget ? state + ((long long)t * tile + ly) * tile + lx0 : nullptr;
    int c = 0, c_end = n_chunks;
    if (kPass == kResume && kSplit == kParts) {
      // Resume the in-image pixels from pass 1's state (T > 0 marks the
      // tile's pixels); the others are not stored.
      const int ox = (t % tiles_x) * tile, oy = (t / tiles_x) * tile;
      const int x0 = ox + lx0, y = oy + ly;
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
    } else if (kListed) {
      // Resume every pixel of the tile at the budget.
      c = kChunkBudget;
#pragma unroll
      for (int i = 0; i < kPxT; ++i) {
        if (T[i] > 0.0f) {
          const float4 v = saved[i];
          acc_r[i] = v.x, acc_g[i] = v.y, acc_b[i] = v.z, T[i] = v.w;
        }
      }
    }
    const float l2 = kLog2e;
    const float h = -0.5f * kLog2e;
    const float cut = -2.0f * kLog2e;

    // Copy the live entries of chunk c into s_raw[buf].
    auto prefetch = [&](int c, int buf) {
      const long long base = (row0 + c) * kRow;
      for (int j = threadIdx.x; j < kRow; j += blockDim.x) {
        const long long g = base + j;
        if (g >= start && g < end) cp_async16(&s_raw[buf][j], entries + g);
      }
    };

    bool handing = false;
    if (c < c_end) prefetch(c, c & 1);
    cp_async_commit();
    for (; c < c_end; ++c) {
      if (kPass == kResume && kSplit == kParts) {
        __syncthreads();  // pass 2 walks to the tile's exit chunk with no test
      } else {
        bool open = false;
#pragma unroll
        for (int i = 0; i < kPxT; ++i) open = open || T[i] > kTEps;
        if (!gs_tiles::tile_open<kCluster>(open, s_open, c)) break;
        if (kPass == kFirst && kSplit == kBudget && c == kChunkBudget) {
          handing = true;  // open, with chunks left: pass 2 goes on from here
          break;
        }
      }
      if (c + 1 < c_end) prefetch(c + 1, (c + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();  // chunk c's copies have landed (this thread's)
      __syncthreads();     // ... and every thread's

      const long long base = (row0 + c) * kRow;
      const int lo = (int)(start > base ? start - base : 0);
      const int hi = (int)(end - base < kRow ? end - base : kRow);
      for (int j = lo + (int)threadIdx.x; j < hi; j += blockDim.x) {
        const uint4 e = s_raw[c & 1][j];
        const float op = gs_u8_unit(e.x, 0);
        const float mx = (float)(e.y & 0xFFFu) * (1.0f / 16.0f) - 128.0f;
        const float my = (float)((e.y >> 12) & 0xFFFu) * (1.0f / 16.0f) - 128.0f;
        const float ca = gs_f16_bits_to_f32(e.z & 0xFFFFu);
        const float cb = gs_f16_bits_to_f32(e.z >> 16);
        const float cc = gs_f16_bits_to_f32(e.w & 0xFFFFu);
        const float r = gs_u8_unit(e.w, 16), g = gs_u8_unit(e.w, 24), b = gs_u8_unit(e.y, 24);
        const float a2 = ca * h, b2 = cb * -l2, c2 = cc * h;
        // power2 at which alpha reaches the floor, and the box around it.
        const float level = kMode == kFlat ? cut : log2f(kAlphaEps / op);
        float rx = INFINITY, ry = INFINITY;
        if (!(op >= kAlphaEps)) rx = ry = -1.0f;  // never blends
        else box_radii(a2, b2, c2, level - kBoxMargin, &rx, &ry);
        const float thr = level - kSkipMargin;
        s_box[j] = make_float4(mx, my, rx, ry);
        if (kMode == kBasis) {
          s_a[j] = make_float4(a2, c2, b2, l2 * fmaf(ca, mx, cb * my));
          s_b[j] = make_float4(l2 * fmaf(cc, my, cb * mx),
                               -l2 * fmaf(cb * mx, my, 0.5f * fmaf(ca * mx, mx, (cc * my) * my)),
                               op, thr);
          s_c[j] = make_float4(r, g, b, 0.0f);
        } else {
          s_a[j] = make_float4(a2, b2, c2, op);
          s_b[j] = make_float4(r, g, b, thr);
        }
      }
      __syncthreads();

      float excl[kPxT], sr[kPxT], sg[kPxT], sb[kPxT];
#pragma unroll
      for (int i = 0; i < kPxT; ++i) {
        excl[i] = 1.0f;
        sr[i] = sg[i] = sb[i] = 0.0f;
      }
#pragma unroll (kMode == kBasis ? 1 : kUnroll)
      for (int k = lo; k < hi; ++k) {
        // Entries whose box misses all of the thread's pixels add nothing to them.
        const float4 box = s_box[k];
        const float dy = py - box.y;
        if (fabsf(dy) > box.w || px[0] - box.x > box.z || box.x - px[kPxT - 1] > box.z) continue;
        const float4 A = s_a[k];
        const float4 B = s_b[k];
        float power2[kPxT], op, r, g, b, thr;
        if (kMode == kBasis) {
          const float4 C = s_c[k];
#pragma unroll
          for (int i = 0; i < kPxT; ++i) {
            float p = (px[i] * px[i]) * A.x;
            p = fmaf(f1, A.y, p);
            p = fmaf(px[i] * py, A.z, p);
            p = fmaf(px[i], A.w, p);
            p = fmaf(py, B.x, p);
            power2[i] = fmaf(1.0f, B.y, p);
          }
          op = B.z, thr = B.w, r = C.x, g = C.y, b = C.z;
        } else {
          const float b2dy = A.y * dy;
          const float c2dydy = (A.z * dy) * dy;
#pragma unroll
          for (int i = 0; i < kPxT; ++i) {
            const float dx = px[i] - box.x;
            power2[i] = (A.x * dx + b2dy) * dx + c2dydy;
          }
          op = A.w, r = B.x, g = B.y, b = B.z, thr = B.w;
        }
#pragma unroll
        for (int i = 0; i < kPxT; ++i) {
          // Below thr, op * 2^power2 < 1/255 for certain: exp2f is skipped.
          float a = 0.0f;
          if (kMode == kFlat)
            a = power2[i] >= cut ? op : 0.0f;
          else if (!(power2[i] < thr))
            a = op * exp2_ftz(fminf(power2[i], 0.0f));
          if (!(a < kAlphaEps)) {
            const float w = excl[i] * a;
            sr[i] += w * r;
            sg[i] += w * g;
            sb[i] += w * b;
            excl[i] *= 1.0f - a;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kPxT; ++i) {
        acc_r[i] += T[i] * sr[i];
        acc_g[i] += T[i] * sg[i];
        acc_b[i] += T[i] * sb[i];
        T[i] *= excl[i];
      }
    }
    cp_async_wait<0>();
    gs_tiles::tile_done<kCluster>();
    if (kPass == kFirst && kSplit == kParts) gs_tiles::record_exit(scratch, t, side, c);
    if (handing) {
      gs_tiles::hand_on(scratch, handed, t, n_chunks - kChunkBudget);
#pragma unroll
      for (int i = 0; i < kPxT; ++i)
        if (lx0 + i < tile && ly < tile)
          saved[i] = make_float4(acc_r[i], acc_g[i], acc_b[i], T[i]);
    } else {
      const int x0 = (t % tiles_x) * tile + lx0, y = (t / tiles_x) * tile + ly;
      if (ly < tile && y < height) {
        float4* o = reinterpret_cast<float4*>(out) + (long long)y * width + x0;
#pragma unroll
        for (int i = 0; i < kPxT; ++i)
          if (lx0 + i < tile && x0 + i < width)
            o[i] = make_float4(acc_r[i], acc_g[i], acc_b[i],
                               kPass == kFirst && kSplit == kParts ? T[i] : 1.0f - T[i]);
      }
    }
    if (!kListed) break;
  }
}

template <int kMode>
int launch_mode(const uint4* entries, const int* starts, const int* counts, int n_tiles,
                int tile, int tiles_x, int width, int height, int* scratch, float4* state,
                unsigned long long* handed, float* out, cudaStream_t st) {
  using gs_tiles::kBudget;
  using gs_tiles::kFirst;
  using gs_tiles::kParts;
  using gs_tiles::kResume;
  using gs_tiles::kWhole;
  constexpr int kSmall = gs_tiles::kSmallThreads, kBig = gs_tiles::kMaxBlockThreads;
  if (tile > gs_tiles::kMaxClusterTile) {
    const int side = gs_tiles::part_side(tile);
    return gs_tiles::launch_parts(
        composite_v2_kernel<kMode, kSmall, 4, false, kFirst, kParts, kPx>,
        composite_v2_kernel<kMode, kSmall, 4, false, kResume, kParts, kPx>, n_tiles, tile,
        gs_tiles::kPart * (gs_tiles::kPart / kPx), st, entries, starts, counts, tile, tiles_x,
        width, height, 1, 0, side, scratch, state, handed, out);
  }
  const gs_tiles::Bands b = gs_tiles::bands_for(tile);
  if (gs_tiles::budgeted(tile)) {
    // Pass 1 in one block of <= 256 threads a tile, then pass 2 over the tiles
    // it lists, across clusters of tb.bands blocks (composite.cuh).
    const gs_tiles::Bands tb = gs_tiles::tail_bands_for(tile);
    const cudaError_t err = cudaMemsetAsync(scratch, 0, 2 * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    const int rc =
        gs_tiles::launch(composite_v2_kernel<kMode, kSmall, 4, false, kFirst, kBudget, kPx>,
                         n_tiles, b, st, entries, starts, counts, tile, tiles_x, width, height,
                         b.bands, b.rows, 0, scratch, state, handed, out);
    if (rc != 0) return rc;
    return tb.threads <= kSmall
               ? gs_tiles::launch_clusters(
                     composite_v2_kernel<kMode, kSmall, 4, true, kResume, kBudget, 1>, n_tiles,
                     tb, true, st, entries, starts, counts, tile, tiles_x, width, height,
                     tb.bands, tb.rows, 0, scratch, state, handed, out)
               : gs_tiles::launch_clusters(
                     composite_v2_kernel<kMode, kBig, 1, true, kResume, kBudget, 1>, n_tiles,
                     tb, true, st, entries, starts, counts, tile, tiles_x, width, height,
                     tb.bands, tb.rows, 0, scratch, state, handed, out);
  }
  switch (gs_tiles::instance_for(b)) {
    case 0:
      return gs_tiles::launch(composite_v2_kernel<kMode, kSmall, 4, false, kWhole, kParts, kPx>,
                              n_tiles, b, st, entries, starts, counts, tile, tiles_x, width,
                              height, b.bands, b.rows, 0, scratch, state, handed, out);
    case 1:
      return gs_tiles::launch(composite_v2_kernel<kMode, kBig, 1, false, kWhole, kParts, kPx>,
                              n_tiles, b, st, entries, starts, counts, tile, tiles_x, width,
                              height, b.bands, b.rows, 0, scratch, state, handed, out);
    default:
      return gs_tiles::launch(composite_v2_kernel<kMode, kBig, 1, true, kWhole, kParts, kPx>,
                              n_tiles, b, st, entries, starts, counts, tile, tiles_x, width,
                              height, b.bands, b.rows, 0, scratch, state, handed, out);
  }
}

}  // namespace

// entries: (E, 4) u32 sorted live entries; starts, counts: (n_tiles,) i32;
// out: (height, width, 4) f32. `mxu`: the quadratic-basis exponent (ignored
// in flat mode, which keeps the Horner form as the reference does). Any tile
// >= 1 px; over 256 px two launches, with `scratch` n_tiles * (1 +
// part_side(tile)^2) zeroed ints (composite.cuh), else NULL. Returns
// gs_tiles::kErrNoCluster if a tile's cluster cannot be placed on the card.
// Tiles of 23 to 32 px (gs_tiles::budgeted) also take two launches, with
// `scratch` 2 + n_tiles ints (the list; its counts are zeroed here) and
// `state` n_tiles * tile * tile float4; `handed` (2 u64, NULL: not counted)
// gains the tiles pass 1 hands on and their chunks left.
extern "C" int gs_composite_v2(const void* entries, const int* starts, const int* counts,
                               int n_tiles, int tile, int tiles_x, int width, int height,
                               int flat_mode, int mxu, int* scratch, void* state,
                               void* handed, void* out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile < 1 || (tile > gs_tiles::kMaxClusterTile && scratch == nullptr) ||
      (gs_tiles::budgeted(tile) && (scratch == nullptr || state == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto e = static_cast<const uint4*>(entries);
  auto sv = static_cast<float4*>(state);
  auto hd = static_cast<unsigned long long*>(handed);
  auto o = static_cast<float*>(out);
  if (flat_mode)
    return launch_mode<kFlat>(e, starts, counts, n_tiles, tile, tiles_x, width, height, scratch,
                              sv, hd, o, st);
  if (mxu)
    return launch_mode<kBasis>(e, starts, counts, n_tiles, tile, tiles_x, width, height, scratch,
                               sv, hd, o, st);
  return launch_mode<kHorner>(e, starts, counts, n_tiles, tile, tiles_x, width, height, scratch,
                              sv, hd, o, st);
}

// K3's chunk budget (kChunkBudget), for the tests' count of the tiles pass 1
// hands on.
extern "C" int gs_composite_v2_budget() { return kChunkBudget; }
