// The enumerate-and-pack section that kernels K1 (fused.cu) and K5
// (enum_pack.cu) share, so the two front-end routes cannot drift apart: one
// splat's screen-space quantities -> its max_dup entry slots.
//
// Per splat: the key's low bits (model rank | log-depth | alpha8), the
// colour bytes and the f16 conic words; the tight cull from the PACKED
// (f16-rounded) conic; then up to max_dup candidate tiles visited centre-out,
// each kept iff the exact ellipse-tile test passes, and written as one
// 16-byte store. Dead slots are (SENTINEL, 0, 0, 0).
//
// Every expression repeats, in order, the plain version
// (ops/binning.py::enumerate_entries_from_pre_plain); the library is built
// with --fmad=false and logf/sqrtf are the functions torch's CUDA ops call,
// so the kernels and the plain version agree to the bit on the card.
#pragma once

#include "common.cuh"

namespace gs {

// Tiling and key layout of one launch (ops/binning.py::TileConfig).
struct EnumParams {
  int tile, tiles_x, tiles_y, max_dup;
  int tile_shift;   // bits below the tile id
  int rank_shift;   // bits below the model rank: depth bits + 8
  int model_rank;   // 0 on a single-model frame
  float depth_scale, depth_qmax;
};

__device__ __forceinline__ uint32_t enum_u8(float c, float hi) {
  return (uint32_t)(int)clampf(c * 255.0f + 0.5f, 0.0f, hi);
}

// `radius` is the live extent, `alpha` is 0 where the splat is culled;
// `dst` points at the splat's first slot.
__device__ __forceinline__ void enumerate_pack(const EnumParams& ep, float px, float py,
                                               float depth, float radius, float ca, float cb,
                                               float cc, float col_r, float col_g, float col_b,
                                               float alpha, bool valid, uint4* __restrict__ dst) {
  // --- per-splat entry words ---
  const float ld = logf(fmaxf(depth, 1e-6f));
  const uint32_t dkey =
      (uint32_t)(int)clampf((ld - (-3.0f)) * ep.depth_scale, 0.0f, ep.depth_qmax);
  const uint32_t a8 = enum_u8(alpha, 252.0f);
  const uint32_t key_lo = ((uint32_t)ep.model_rank << ep.rank_shift) | (dkey << 8) | a8;
  const uint32_t r8 = enum_u8(col_r, 255.0f);
  const uint32_t g8 = enum_u8(col_g, 255.0f);
  const uint32_t b8 = enum_u8(col_b, 255.0f);
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

  const float tile = (float)ep.tile;
  const float hx = (float)(ep.tiles_x - 1), hy = (float)(ep.tiles_y - 1);
  const int tx0 = (int)clampf(floorf((px - rx) / tile), 0.0f, hx);
  const int tx1 = (int)clampf(floorf((px + rx) / tile), 0.0f, hx);
  const int ty0 = (int)clampf(floorf((py - ry) / tile), 0.0f, hy);
  const int ty1 = (int)clampf(floorf((py + ry) / tile), 0.0f, hy);
  const int rw = tx1 - tx0 + 1, rh = ty1 - ty0 + 1;
  const int n_touched = rw * rh;

  for (int dd = 0; dd < ep.max_dup; ++dd) {
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
      const uint32_t tile_id = (uint32_t)(ety * ep.tiles_x + etx);
      const uint32_t mxq = (uint32_t)(int)clampf(
          (px - (float)etx * tile + 128.0f) * 16.0f + 0.5f, 0.0f, 4095.0f);
      const uint32_t myq = (uint32_t)(int)clampf(
          (py - (float)ety * tile + 128.0f) * 16.0f + 0.5f, 0.0f, 4095.0f);
      e = make_uint4((tile_id << ep.tile_shift) | key_lo, mxq | (myq << 12) | (b8 << 24), p2, p3);
    }
    dst[dd] = e;
  }
}

}  // namespace gs
