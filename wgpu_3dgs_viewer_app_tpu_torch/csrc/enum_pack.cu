// K5 - enumerate and pack: per-splat PreprocessOut planes -> (N * D) packed
// entries, the second stage of the staged front-end (preprocess -> K5 ->
// sort -> composite).
//
// Replaces the Pallas kernel `wgpu_3dgs_viewer_app_tpu/ops/binning.py::
// _enum_pack_kernel`, with the per-splat precursors that the reference
// computes in XLA before it (key low bits, colour bytes, f16 conic words,
// signed radius) folded in. One thread per splat: read the splat's eleven
// f32 planes and its valid byte, then run the same enumerate_pack
// (enumerate.cuh) that K1 runs after its own geometry: tight cull on the
// f16-rounded conic, up to D candidate tiles centre-out with the exact
// ellipse-tile test, key/p1/p2/p3 packed. Slot d of splat s is entry
// s * D + d; dead slots are (SENTINEL, 0, 0, 0): the layout K1 writes and
// K2 reads. The block stages its splats' entries in shared memory and
// writes them out as one contiguous range with one bulk (TMA) store
// (enumerate.cuh). Its plain version is
// ops/binning.py::enumerate_entries_from_pre_plain; the two agree to the bit
// on the card (same f32 expressions, --fmad=false, logf and sqrtf as torch's
// CUDA ops call them).
//
// Nothing of the TPU layout carries over: the reference pads to blocks of
// 128 * 256 splats, passes seven precursor planes and writes (rows, D, 128)
// planes so that its flatten is free on that machine; here the planes are
// read where the preprocess left them and the entries are interleaved.
//
// What bounds it on an H100: memory. Per splat it reads 45 B (11 f32 planes
// and 1 valid byte) and writes 16 * D bytes of entries: 109 B at D = 4, a
// bound of 0.033 ms at 1M splats and 0.195 ms at 6M at 3.35 TB/s. The
// arithmetic (~60 flops per splat and ~40 per slot) is far below the compute
// rate. Every intermediate stays in registers, the twelve plane reads are
// issued before any arithmetic and are coalesced across the warp, and the
// entries leave in whole sectors.
#include "enumerate.cuh"

using namespace gs;

namespace {

__global__ void __launch_bounds__(kEnumThreads)
enum_pack_kernel(const int64_t n, const EnumParams ep, const float* __restrict__ mean_x,
                 const float* __restrict__ mean_y, const float* __restrict__ depth,
                 const float* __restrict__ radius, const float* __restrict__ conic_a,
                 const float* __restrict__ conic_b, const float* __restrict__ conic_c,
                 const float* __restrict__ col_r, const float* __restrict__ col_g,
                 const float* __restrict__ col_b, const float* __restrict__ alpha,
                 const uint8_t* __restrict__ valid, uint4* __restrict__ out) {
  const int64_t first = (int64_t)blockIdx.x * blockDim.x;
  const int nb = (int)(n - first < (int64_t)blockDim.x ? n - first : (int64_t)blockDim.x);
  // A thread past the last splat repeats it; its slots are not stored.
  const int64_t s = first + ((int)threadIdx.x < nb ? (int)threadIdx.x : nb - 1);
  enumerate_pack(ep, mean_x[s], mean_y[s], depth[s], radius[s], conic_a[s], conic_b[s],
                 conic_c[s], col_r[s], col_g[s], col_b[s], alpha[s], valid[s] != 0, first, nb,
                 out);
}

}  // namespace

extern "C" int gs_enum_pack(int n, int tile, int tiles_x, int tiles_y, int max_dup,
                            int tile_shift, int rank_shift, int model_rank, float depth_scale,
                            float depth_qmax, const void* mean_x, const void* mean_y,
                            const void* depth, const void* radius, const void* conic_a,
                            const void* conic_b, const void* conic_c, const void* col_r,
                            const void* col_g, const void* col_b, const void* alpha,
                            const void* valid, void* out, void* stream) {
  if (n <= 0) return 0;
  if (tile <= 0 || tiles_x <= 0 || tiles_y <= 0 || max_dup <= 0 || tile_shift < 0 ||
      tile_shift > 31 || rank_shift < 0 || rank_shift > tile_shift)
    return (int)cudaErrorInvalidValue;
  const EnumParams ep{tile, tiles_x, tiles_y, max_dup, tile_shift, rank_shift, model_rank,
                      depth_scale, depth_qmax};
  const int blocks = (n + kEnumThreads - 1) / kEnumThreads;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  enum_pack_kernel<<<blocks, kEnumThreads, stage_bytes(kEnumThreads, max_dup),
                     static_cast<cudaStream_t>(stream)>>>(
      n, ep, f(mean_x), f(mean_y), f(depth), f(radius), f(conic_a), f(conic_b), f(conic_c),
      f(col_r), f(col_g), f(col_b), f(alpha), static_cast<const uint8_t*>(valid),
      static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}
