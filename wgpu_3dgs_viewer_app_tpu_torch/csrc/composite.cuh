// Shared by the tile compositors K3 (composite_v2.cu) and K6
// (composite_v1.cu): how a tile of any size maps onto blocks, the
// reference's whole-tile early-exit test across those blocks, the entry box,
// the cp.async staging and the launches.
//
// Each thread takes kPx consecutive pixels of one tile row (K6 may take one
// pixel a thread on tiles up to 32 px), so a tile needs tile * ceil(tile /
// kPx) threads:
//   - up to 256 (tile <= 32): one block, the 256-thread instance (4 blocks
//     an SM, <= 64 registers a thread);
//   - up to 1024 (tile <= 64): one block, the 1024-thread instance (1 block
//     an SM, <= 64 registers a thread);
//   - up to 256 px: a thread block cluster of `bands` blocks of whole rows,
//     at most 1024 threads each (4 at tile 128, 16 at tile 256, the most a
//     Hopper cluster may hold, and then only with the non-portable size
//     allowed);
//   - over 256 px: parts of kPart x kPart pixels, each one block of the
//     tile-32 instance, in two launches (below).
// The reference stops a tile before a chunk when no pixel of the WHOLE tile
// has T > 1/255, pixels past the image's edge included. A band that stopped
// on its own test would blend up to 1/255 less into its pixels than the
// reference does, so each block ORs its own pixels (__syncthreads_or) into a
// shared flag, the cluster synchronises, and every block reads all its
// peers' flags through distributed shared memory: all blocks of a tile take
// the same decision at every chunk.
//
// Over 256 px a tile fits no cluster, and its parts take the decision in two
// stream-ordered launches, with no grid-wide wait:
//   - pass 1 (kFirst): each part walks chunks until its own pixels are all
//     closed, records that chunk c_p and atomicMax-es it into the tile's c*,
//     and stores each in-image pixel's rgb sums and T itself (not 1 - T);
//   - pass 2 (kResume): every part resumes its in-image pixels from that
//     state over chunks [c_p, c*), with no exit test, and stores 1 - T.
// T never rises, so a closed part stays closed and the tile's exit chunk is
// max_p c_p = c*: every pixel walks the same chunks in the same order as in
// one whole-tile walk, so the image is that walk's bit for bit. Pixels past
// the image's edge need no saved state, since pass 2 has no exit test.
// `scratch` (zeros, n_tiles * (1 + parts a tile) ints) holds c* of tile t at
// [t] and c_p of part p of tile t at [n_tiles + t * parts + p].
//
// A tile of 23 to 32 px (the compositor K3 only) takes the same two passes
// split another way, by a budget of chunks instead of into parts, so that
// the few tiles whose walks outlast the rest are spread over several SMs:
//   - pass 1 (kFirst, kBudget): the whole tile in one block, as kWhole, for
//     at most `budget` chunks. A tile still open before chunk `budget` with
//     chunks left stores every pixel's rgb sums and T in `state` (the pixels
//     past the image's edge too: they hold up the exit test) and appends
//     itself to the list in `scratch`, one atomic a tile (hand_on);
//   - pass 2 (kResume, kBudget): as many clusters of 2-4 bands as the card
//     holds at once, at one pixel a thread (tail_bands_for, place), each
//     taking the listed tiles one at a time (take_listed): it resumes every
//     pixel from its state at chunk `budget`, with the whole-tile exit test
//     across the cluster, and stores 1 - T. The host never reads the list.
// `scratch` (2 + n_tiles ints): [0] the tiles listed, [1] the next one a
// pass-2 cluster takes (both zeroed before pass 1), then the tiles. The state
// moves between the passes in f32, unchanged, and the exit test is the same
// whole-tile test at the same chunk boundaries, so every pixel sees the same
// operations in the same order as in one whole-tile walk, and the image is
// that walk's bit for bit.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace gs_tiles {

namespace cg = cooperative_groups;

constexpr int kPx = 4;               // consecutive pixels of a row per thread
constexpr int kMaxBlockThreads = 1024;
constexpr int kSmallThreads = 256;   // tile <= 32
constexpr int kMaxClusterTile = 256;  // 16 bands, the most a cluster holds
constexpr int kPart = 32;            // side of a part of a tile over 256 px
// Returned by `launch` when cudaOccupancyMaxActiveClusters finds no place
// for one cluster of the tile's blocks.
constexpr int kErrNoCluster = -2;

// Pass 2 of a budgeted tile: one pixel a thread, each warp a block of
// kWarpCols x kWarpRows pixels, in at most kMaxTailBands bands, one to every
// whole kTailBandPixels pixels of the tile (so a block holds 8 warps or
// more); budgeted are the tiles up to kMaxBudgetTile px that this spreads
// over more than one block (from 23 px). Larger tiles run 4x the entries a
// tile, so most of their walk would outlast the budget and run at one pixel
// a thread, which costs more than it spreads (+27% at 64 px on a random
// scene): they keep one launch.
constexpr int kWarpCols = 8;
constexpr int kWarpRows = 4;
constexpr int kMaxTailBands = 4;
constexpr int kTailBandPixels = 256;
constexpr int kMaxBudgetTile = 32;

// A launch's pass: the whole tile in one block or cluster, or a first walk
// and its resumption (above).
enum Pass { kWhole = 0, kFirst = 1, kResume = 2 };
// How the two passes split a tile: into parts over 256 px, or by a budget of
// chunks (above).
enum Split { kParts = 0, kBudget = 1 };

// Rows of one tile split into `bands` blocks of `rows` rows (the last band may
// hold fewer), `threads` a block.
struct Bands {
  int groups, bands, rows, threads;
};

inline Bands bands_for(int tile) {
  Bands b;
  b.groups = (tile + kPx - 1) / kPx;
  b.bands = (tile * b.groups + kMaxBlockThreads - 1) / kMaxBlockThreads;
  b.rows = (tile + b.bands - 1) / b.bands;
  b.threads = b.rows * b.groups;
  return b;
}

// Instances: 0 one block of <= 256 threads, 1 one block of <= 1024, 2 a
// cluster of bands.
inline int instance_for(const Bands& b) {
  return b.bands > 1 ? 2 : b.threads > kSmallThreads ? 1 : 0;
}

// Parts a side of a tile over kMaxClusterTile.
inline int part_side(int tile) { return (tile + kPart - 1) / kPart; }

// Pass 2's bands of a budgeted tile: `groups` warp blocks across the tile,
// `rows` of them down each band (place).
inline Bands tail_bands_for(int tile) {
  Bands b;
  b.groups = (tile + kWarpCols - 1) / kWarpCols;
  b.bands = tile * tile / kTailBandPixels;
  if (b.bands < 1) b.bands = 1;
  if (b.bands > kMaxTailBands) b.bands = kMaxTailBands;
  b.rows = ((tile + kWarpRows - 1) / kWarpRows + b.bands - 1) / b.bands;
  b.threads = b.groups * 32 * b.rows;
  return b;
}

inline bool budgeted(int tile) { return tile <= kMaxBudgetTile && tail_bands_for(tile).bands > 1; }

// Where a block's thread works: tile t, the tile-local column of its first
// pixel and its row; and, for the part passes, the tile-local origin of the
// block's part. kPxT pixels a thread; `side`: parts a side (part passes);
// `listed`: the tile a budgeted pass 2 takes from the list. A budgeted pass 2
// (one pixel a thread) gives each warp a block of 8 x 4 pixels, since a warp
// walks every entry that reaches one of its pixels, and fewer reach some
// pixel of a compact block than of a row of 32; its bands take the tile's
// rows of blocks in turn (band r rows r, r + bands, ...), so that the rows
// thick with entries fall to every band alike.
struct Place {
  int t, lx0, ly, part_x, part_y;
};

template <int kPass, int kSplit, bool kCluster, int kPxT>
__device__ __forceinline__ Place place(int tile, int bands, int band_rows, int side, int listed) {
  Place p;
  const bool parts = kPass != kWhole && kSplit == kParts;
  const int unit = parts ? kPart : tile;
  const int groups = (unit + kPxT - 1) / kPxT;
  if (!parts) {
    p.t = kPass == kResume ? listed : kCluster ? (int)blockIdx.x / bands : (int)blockIdx.x;
    p.part_x = p.part_y = 0;
  } else {
    const int parts = side * side, part = (int)blockIdx.x % parts;
    p.t = (int)blockIdx.x / parts;
    p.part_x = part % side * kPart;
    p.part_y = part / side * kPart;
  }
  if (kPass == kResume && kSplit == kBudget) {
    const int blocks = (tile + kWarpCols - 1) / kWarpCols, warp = (int)threadIdx.x / 32;
    const int lane = (int)threadIdx.x % 32;
    p.lx0 = warp % blocks * kWarpCols + lane % kWarpCols;
    p.ly = (warp / blocks * bands + (int)blockIdx.x % bands) * kWarpRows + lane / kWarpCols;
    return p;
  }
  p.lx0 = p.part_x + (int)threadIdx.x % groups * kPxT;
  p.ly = p.part_y + (kCluster ? (int)blockIdx.x % bands * band_rows : 0) +
         (int)threadIdx.x / groups;
  return p;
}

// Pass 2's chunk range [c_p, c*) of this block's part (empty for a part that
// holds no pixel of the image).
__device__ __forceinline__ void resume_range(const int* scratch, int t, int side, bool in_image,
                                             int* c_begin, int* c_end) {
  const int n_tiles = (int)gridDim.x / (side * side);
  *c_begin = in_image ? scratch[n_tiles + blockIdx.x] : 0;
  *c_end = in_image ? scratch[t] : 0;
}

// Pass 1: the part stopped before chunk c.
__device__ __forceinline__ void record_exit(int* scratch, int t, int side, int c) {
  if (threadIdx.x == 0) {
    const int n_tiles = (int)gridDim.x / (side * side);
    scratch[n_tiles + blockIdx.x] = c;
    atomicMax(&scratch[t], c);
  }
}

// Budgeted pass 1: tile t outlasted the budget with `chunks` chunks left; it
// goes on the list, and into `handed` (tiles, chunks; NULL: not counted).
__device__ __forceinline__ void hand_on(int* list, unsigned long long* handed, int t,
                                        int chunks) {
  if (threadIdx.x == 0) {
    list[2 + atomicAdd(&list[0], 1)] = t;
    if (handed != nullptr) {
      atomicAdd(&handed[0], 1ull);
      atomicAdd(&handed[1], (unsigned long long)chunks);
    }
  }
}

// Budgeted pass 2: the next listed tile for this block's cluster (the same
// for each of its blocks), or -1 once the list is taken. The cluster's block
// 0 takes it and writes it into every block's `slot` before the cluster
// barrier, so no block reads a peer's shared memory after the barrier (a
// peer may have left).
__device__ __forceinline__ int take_listed(int* list, int* slot) {
  cg::cluster_group cluster = cg::this_cluster();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    const int k = atomicAdd(&list[1], 1);
    const int t = k < list[0] ? list[2 + k] : -1;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r) *cluster.map_shared_rank(slot, r) = t;
  }
  cluster.sync();
  return *slot;
}

// True while any pixel of the whole tile is open. `open`: this thread's
// pixels; `flags`: two shared ints of this block (chunk c writes flags[c & 1]:
// the cluster barrier of chunk c - 1 lies between any peer's read of chunk
// c - 2's flag and this write). Every thread of every block of the tile gets
// the same answer.
template <bool kCluster>
__device__ __forceinline__ bool tile_open(bool open, int* flags, int c) {
  const int mine = __syncthreads_or(open);
  if (!kCluster) return mine != 0;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) flags[c & 1] = mine;
  cluster.sync();
  int any = 0;
  for (unsigned r = 0; r < cluster.num_blocks(); ++r)
    any |= *cluster.map_shared_rank(&flags[c & 1], r);
  return any != 0;
}

// After the chunk loop: no block leaves while a peer may still read its flags.
template <bool kCluster>
__device__ __forceinline__ void tile_done() {
  if (kCluster) cg::this_cluster().sync();
}

// Half-widths (pixels) of the box around the region where the quadratic
// a2 dx^2 + b2 dx dy + c2 dy^2 reaches `level` (< 0), widened by 0.1% and
// 0.01 px; unbounded unless the form is negative definite with a condition
// number under ~2000, which keeps the rounding of the exponent far inside
// the margin. In double: the f32 products are exact there.
__device__ __forceinline__ void box_radii(float a2, float b2, float c2, float level, float* rx,
                                          float* ry) {
  const double a = a2, b = b2, c = c2, det = 4.0 * a * c - b * b;
  if (a < 0.0 && c < 0.0 && det > 4e-3 * (a + c) * (a + c) && level < 0.0f) {
    *rx = (float)(sqrt(level * 4.0 * c / det) * 1.001 + 0.01);
    *ry = (float)(sqrt(level * 4.0 * a / det) * 1.001 + 0.01);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Launch `kernel` as clusters of b.bands > 1 blocks of b.threads: one a tile,
// or (`resident`: a budgeted pass 2, whose clusters take their tiles from
// the list) no more than the card holds at once. Returns a cudaError_t, or
// kErrNoCluster.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int n_tiles, const Bands& b, bool resident,
                    cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_tiles * (unsigned)b.bands);
  cfg.blockDim = dim3((unsigned)b.threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)b.bands;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaSuccess;
  if (b.bands > 8) {  // over the portable cluster size
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters == 0) return kErrNoCluster;
  if (resident && clusters < n_tiles) cfg.gridDim = dim3((unsigned)clusters * (unsigned)b.bands);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launch `kernel` over n_tiles * b.bands blocks of b.threads, as clusters of
// b.bands blocks when b.bands > 1. Returns a cudaError_t, or kErrNoCluster.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int n_tiles, const Bands& b, cudaStream_t st,
           Args... args) {
  if (b.bands == 1) {
    kernel<<<n_tiles, b.threads, 0, st>>>(args...);
    return (int)cudaGetLastError();
  }
  return launch_clusters(kernel, n_tiles, b, false, st, args...);
}

// A tile over kMaxClusterTile: pass 1 (`first`), then pass 2 (`resume`), each
// over n_tiles * part_side(tile)^2 blocks of `threads`, on one stream.
template <typename... Params, typename... Args>
int launch_parts(void (*first)(Params...), void (*resume)(Params...), int n_tiles, int tile,
                 int threads, cudaStream_t st, Args... args) {
  const int side = part_side(tile);
  const unsigned blocks = (unsigned)n_tiles * (unsigned)(side * side);
  first<<<blocks, threads, 0, st>>>(args...);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  resume<<<blocks, threads, 0, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace gs_tiles
