// K9 - the app frame's screen-space overlays in one pass over the image:
// antialiased segments (mask gizmos, measurement lines), the selection
// texture's tint and the brush cursor ring, in the reference's paint order.
//
// Replaces no Pallas kernel. The reference draws these with jitted device
// programs: `wgpu_3dgs_viewer_app_tpu/core/lines.py::rasterize_lines` (a
// lax.scan of every segment over the whole frame) and `query/overlay.py::
// overlay_texture`, `overlay_cursor_ring` (fused image passes). Their plain
// versions in the port evaluate the segments' covers in numpy on the host
// (`core/lines.py::rasterize_lines_plain`) and draw the tint and the ring
// as torch image passes (`query/overlay.py`).
//
// Input: the (M, 16) f32 segment table of `core/lines.py::segment_table`:
// the kept segments in order, each with its constants rounded on the host
// and its pixel box, so the per-segment rounding is the plain version's by
// construction. Per pixel and in this order, each step rounded as the plain
// versions round it (built with --fmad=false; IEEE division and sqrt):
//   1. each segment whose box holds the pixel, in table order: t = clamp(
//      fma(xs - ax, abx, (ys - ay) * aby) / denom, 0, 1), the distance to
//      the closest point sqrt(fma(dx, dx, dy * dy)), cover = clamp(reach -
//      dist, 0, 1) * alpha; a pair whose cover is not > 0 is skipped; the
//      blend is f32(f64(img) * f64(1 - cover) + f64(cover * rgb)). Each fma
//      is the plain version's numpy `_fma`: the f32 product (exact in f64),
//      one f64 add, one rounding to f32. That is two roundings: fmaf rounds
//      once and differs in rare cases;
//   2. the tint: t = tex * a, then img * (1 - t) + t * rgb in f32 operations,
//      in torch's order;
//   3. the ring: d = sqrt(dx * dx + dy * dy) (torch's pow by 2 is x * x),
//      cover = clamp(thickness - |d - radius|, 0, 1) * a, blended as the tint.
// Clamps keep a NaN, as numpy's minimum/maximum and torch.clamp do.
//
// What bounds it on an H100: bytes. The image is read and written once
// (25 MB each at 1920x1088); the segments' work is small (config 4: 121
// segments over a few percent of the pixels). Design: one thread a pixel,
// one block of 256 threads a 16x16 tile. The block stages the table in
// shared memory in chunks of 256 rows (coalesced float4 loads), keeps the
// rows whose box meets its tile, in order (a warp ballot and a prefix count
// over the block's warps), and each thread walks that list, reading each
// row as a shared-memory broadcast. A pixel's rgb stays in registers from
// its one load to its one store.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kChunk = kThreads;  // table rows staged at a time
constexpr int kWarps = kThreads / 32;

// A table row is 4 float4s (core/lines.py, SEG_*): (ax, ay, abx, aby),
// (denom, reach, alpha, -), (r, g, b, -), (x0, y0, x1, y1).
constexpr int kRowF4 = 4;

struct OverlayParams {
  float tint[4];  // rgba
  float ring[4];  // rgba
  float cx, cy, radius, thickness;
  int has_ring;
};

// np.minimum(np.maximum(v, lo), hi) and torch.clamp: a NaN stays NaN.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// `core/lines.py::_fma`: the f32 product exact in f64, rounded once in the
// f64 add and once more to f32.
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// A segment's blend: f32(f64(v) * f64(keep) + f64(add)), the product exact.
__device__ __forceinline__ float blend_f64(float v, double keep, float add) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)v, keep), (double)add));
}

// The tint's and the ring's blend: v * (1 - c) + c * rgb, each step in f32.
__device__ __forceinline__ float blend_f32(float v, float cover, float c) {
  return __fadd_rn(__fmul_rn(v, __fsub_rn(1.0f, cover)), __fmul_rn(cover, c));
}

__global__ void __launch_bounds__(kThreads) overlay_kernel(
    const float* __restrict__ img, const float4* __restrict__ table, int n_segs,
    const uint8_t* __restrict__ texture, OverlayParams prm, int width, int height,
    float* __restrict__ out) {
  __shared__ float4 rows[kChunk * kRowF4];
  __shared__ int list[kChunk];
  __shared__ int warp_hits[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx0 = blockIdx.x * kTile, ty0 = blockIdx.y * kTile;
  const int ix = tx0 + tid % kTile, iy = ty0 + tid / kTile;
  const bool inside = ix < width && iy < height;
  const long long pix = (long long)iy * width + ix;
  float r = 0.0f, g = 0.0f, b = 0.0f;
  if (inside) {
    r = img[3 * pix];
    g = img[3 * pix + 1];
    b = img[3 * pix + 2];
  }
  // Pixel centres, as arange(n, f32) + 0.5.
  const float fx = (float)ix, fy = (float)iy;
  const float xs = __fadd_rn(fx, 0.5f), ys = __fadd_rn(fy, 0.5f);
  const float tile_x0 = (float)tx0, tile_x1 = (float)(tx0 + kTile);
  const float tile_y0 = (float)ty0, tile_y1 = (float)(ty0 + kTile);

  for (int base = 0; base < n_segs; base += kChunk) {
    const int cnt = min(kChunk, n_segs - base);
    for (int i = tid; i < cnt * kRowF4; i += kThreads)
      rows[i] = table[(long long)base * kRowF4 + i];
    __syncthreads();
    // The chunk's rows whose non-empty box meets this tile, in order.
    bool hit = false;
    if (tid < cnt) {
      const float4 box = rows[tid * kRowF4 + 3];
      hit = box.x < box.z && box.y < box.w && box.x < tile_x1 && box.z > tile_x0 &&
            box.y < tile_y1 && box.w > tile_y0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int c = warp_hits[k];
      before += k < warp ? c : 0;
      total += c;
    }
    if (hit) list[before + __popc(ballot & ((1u << lane) - 1u))] = tid;
    __syncthreads();
    if (inside) {
      for (int k = 0; k < total; ++k) {
        const float4* row = rows + list[k] * kRowF4;
        const float4 box = row[3];
        if (fx < box.x || fx >= box.z || fy < box.y || fy >= box.w) continue;
        const float4 seg = row[0];  // ax, ay, abx, aby
        const float4 cov = row[1];  // denom, reach, alpha
        float t = fma_f64(__fsub_rn(xs, seg.x), seg.z, __fmul_rn(__fsub_rn(ys, seg.y), seg.w));
        t = clamp_nan(__fdiv_rn(t, cov.x), 0.0f, 1.0f);
        const float dx = __fsub_rn(xs, fma_f64(t, seg.z, seg.x));
        const float dy = __fsub_rn(ys, fma_f64(t, seg.w, seg.y));
        const float dist = __fsqrt_rn(fma_f64(dx, dx, __fmul_rn(dy, dy)));
        const float cover = __fmul_rn(clamp_nan(__fsub_rn(cov.y, dist), 0.0f, 1.0f), cov.z);
        if (!(cover > 0.0f)) continue;
        const float4 rgb = row[2];
        const double keep = (double)__fsub_rn(1.0f, cover);
        r = blend_f64(r, keep, __fmul_rn(cover, rgb.x));
        g = blend_f64(g, keep, __fmul_rn(cover, rgb.y));
        b = blend_f64(b, keep, __fmul_rn(cover, rgb.z));
      }
    }
    __syncthreads();  // the next chunk overwrites rows and list
  }
  if (!inside) return;
  if (texture != nullptr) {
    const float t = __fmul_rn(texture[pix] ? 1.0f : 0.0f, prm.tint[3]);
    r = blend_f32(r, t, prm.tint[0]);
    g = blend_f32(g, t, prm.tint[1]);
    b = blend_f32(b, t, prm.tint[2]);
  }
  if (prm.has_ring) {
    const float dx = __fsub_rn(xs, prm.cx), dy = __fsub_rn(ys, prm.cy);
    const float d = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    const float cover = __fmul_rn(
        clamp_nan(__fsub_rn(prm.thickness, fabsf(__fsub_rn(d, prm.radius))), 0.0f, 1.0f),
        prm.ring[3]);
    r = blend_f32(r, cover, prm.ring[0]);
    g = blend_f32(g, cover, prm.ring[1]);
    b = blend_f32(b, cover, prm.ring[2]);
  }
  out[3 * pix] = r;
  out[3 * pix + 1] = g;
  out[3 * pix + 2] = b;
}

}  // namespace

// params (host): the tint's rgba, the ring's rgba, the ring's centre x, y,
// radius and thickness. table: n_segs rows of 16 f32 (NULL when 0);
// texture: (height, width) bytes, or NULL for no tint; has_ring: 0 or 1.
extern "C" int gs_overlay(const float* params, int height, int width, int n_segs, int has_ring,
                          const void* img, const void* table, const void* texture, void* out,
                          void* stream) {
  if (height <= 0 || width <= 0) return 0;
  OverlayParams prm;
  for (int i = 0; i < 4; ++i) {
    prm.tint[i] = params[i];
    prm.ring[i] = params[4 + i];
  }
  prm.cx = params[8];
  prm.cy = params[9];
  prm.radius = params[10];
  prm.thickness = params[11];
  prm.has_ring = has_ring;
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  overlay_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const float4*)table, n_segs, (const uint8_t*)texture, prm, width,
      height, (float*)out);
  return (int)cudaGetLastError();
}
