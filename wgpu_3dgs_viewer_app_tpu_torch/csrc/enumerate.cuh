// The enumerate-and-pack section that kernels K1 (fused.cu) and K5
// (enum_pack.cu) share, so the two front-end routes cannot drift apart: one
// block's splats' screen-space quantities -> their max_dup entry slots.
//
// Per splat: the key's low bits (model rank | log-depth | alpha8), the
// colour bytes and the f16 conic words; the tight cull from the PACKED
// (f16-rounded) conic; then up to max_dup candidate tiles visited centre-out,
// each kept iff the exact ellipse-tile test passes. Dead slots are
// (SENTINEL, 0, 0, 0).
//
// How the entries are written: slot d of splat s belongs at entry s * D + d,
// so the block's splats own one contiguous range of entries. Each thread
// puts its slots into a staging buffer in shared memory; after a proxy
// fence and a barrier, one thread writes the whole range out with one bulk
// (TMA) store, `cp.async.bulk.global.shared::cta`, which fills whole
// sectors (a direct per-thread 16-byte store touches 32 half-filled sectors
// strided by 16 * D bytes) and needs only 16-byte alignment, which a row
// slice of a larger entry buffer keeps. Above kStageSlots slots a splat the
// block stages kStageSlots slots a round, and each splat's slots of the
// round are one bulk store. (Consecutive threads on consecutive 16-byte
// entries, from a stage padded against bank conflicts, measured slower on
// an H100 80GB.) A slot past the splat's tile rect is dead without its
// ellipse test, and the rect's cells are counted up, not divided out.
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

// Threads of a K1 or K5 block, and the most slots a thread stages a round.
constexpr int kEnumThreads = 128;
constexpr int kStageSlots = 16;

__host__ __device__ constexpr int stage_width(int max_dup) {
  return max_dup < kStageSlots ? max_dup : kStageSlots;
}

// Dynamic shared memory of a block of `threads` (the stage).
inline size_t stage_bytes(int threads, int max_dup) {
  return (size_t)threads * stage_width(max_dup) * sizeof(uint4);
}

// One bulk (TMA) store from shared to global memory; returns once the
// source has been read, so the stage may be rewritten.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(src));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(s),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t enum_u8(float c, float hi) {
  return (uint32_t)(int)clampf(c * 255.0f + 0.5f, 0.0f, hi);
}

// Called by every thread of the block. The block's splats are `first` ..
// `first + nb - 1`; a thread past them passes a copy of a splat's values
// and its slots are not stored. `radius` is the live extent, `alpha` is 0
// where the splat is culled; `out` is the whole (N * D) entry array.
__device__ __forceinline__ void enumerate_pack(const EnumParams& ep, float px, float py,
                                               float depth, float radius, float ca, float cb,
                                               float cc, float col_r, float col_g, float col_b,
                                               float alpha, bool valid, int64_t first, int nb,
                                               uint4* __restrict__ out) {
  extern __shared__ uint4 gs_stage[];
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

  const int t = threadIdx.x;
  const int D = ep.max_dup;
  const int G = stage_width(D);
  int mm = 0, kk = 0;  // slot dd is cell (mm, kk) of the rect: dd = kk * rw + mm
  for (int d0 = 0; d0 < D; d0 += G) {
    const int g = D - d0 < G ? D - d0 : G;  // slots of this round
    for (int j = 0; j < g; ++j) {
      uint4 e = make_uint4(GS_SENTINEL, 0u, 0u, 0u);
      if (d0 + j < n_touched) {  // a slot past the rect is dead whatever its test
        // Centre-out candidate cell of the tile rect.
        const int etx = tx0 + ((rw - 1) >> 1) + ((mm + 1) >> 1) * ((mm & 1) ? 1 : -1);
        const int ety = ty0 + ((rh - 1) >> 1) + ((kk + 1) >> 1) * ((kk & 1) ? 1 : -1);
        const float dx0 = (float)etx * tile - px, dx1 = dx0 + tile;
        const float dy0 = (float)ety * tile - py, dy1 = dy0 + tile;
        const bool inside = dx0 <= 0.0f && dx1 >= 0.0f && dy0 <= 0.0f && dy1 >= 0.0f;
        auto qf = [&](float ex, float ey) {
          return (a * ex + 2.0f * bq * ey) * ex + c * ey * ey;
        };
        const float yv0 = fminf(fmaxf((-bq) * dx0 * inv_c, dy0), dy1);
        const float yv1 = fminf(fmaxf((-bq) * dx1 * inv_c, dy0), dy1);
        const float xh0 = fminf(fmaxf((-bq) * dy0 * inv_a, dx0), dx1);
        const float xh1 = fminf(fmaxf((-bq) * dy1 * inv_a, dx0), dx1);
        float qmin =
            fminf(fminf(qf(dx0, yv0), qf(dx1, yv1)), fminf(qf(xh0, dy0), qf(xh1, dy1)));
        if (inside) qmin = 0.0f;
        if (qmin <= cut2) {
          const uint32_t tile_id = (uint32_t)(ety * ep.tiles_x + etx);
          const uint32_t mxq = (uint32_t)(int)clampf(
              (px - (float)etx * tile + 128.0f) * 16.0f + 0.5f, 0.0f, 4095.0f);
          const uint32_t myq = (uint32_t)(int)clampf(
              (py - (float)ety * tile + 128.0f) * 16.0f + 0.5f, 0.0f, 4095.0f);
          e = make_uint4((tile_id << ep.tile_shift) | key_lo, mxq | (myq << 12) | (b8 << 24),
                         p2, p3);
        }
      }
      gs_stage[t * G + j] = e;
      if (++mm == rw) {
        mm = 0;
        ++kk;
      }
    }

    // --- the block writes the round's slots out ---
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (g == D) {  // one round: the block's entries are one contiguous range
      if (t == 0) bulk_store(out + first * D, gs_stage, (uint32_t)(nb * D) * 16u);
    } else {  // D > kStageSlots: each splat's g slots of the round are one piece
      if (t < nb) bulk_store(out + (first + t) * D + d0, gs_stage + t * G, (uint32_t)g * 16u);
      __syncthreads();  // before the next round rewrites the stage
    }
  }
}

}  // namespace gs
