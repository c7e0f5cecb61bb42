// Shared by the tile compositors K3 (composite_v2.cu) and K6
// (composite_v1.cu): how a tile of any size up to 256 px maps onto blocks,
// the reference's whole-tile early-exit test across those blocks, and the
// launch.
//
// Each thread takes kPx consecutive pixels of one tile row (K6 up to 32 px
// keeps its one-pixel kernel), so a tile needs tile * ceil(tile / kPx)
// threads:
//   - up to 256 (tile <= 32): one block, K3's 256-thread instance (4 blocks
//     an SM, <= 64 registers a thread);
//   - up to 1024 (tile <= 64): one block, the 1024-thread instance (1 block
//     an SM, <= 64 registers a thread);
//   - more: a thread block cluster of `bands` blocks of whole rows, at most
//     1024 threads each (4 at tile 128, 16 at tile 256, the most a Hopper
//     cluster may hold, and then only with the non-portable size allowed).
// The reference stops a tile before a chunk when no pixel of the WHOLE tile
// has T > 1/255. A band that stopped on its own test would blend up to 1/255
// less into its pixels than the reference does, so each block ORs its own
// pixels (__syncthreads_or) into a shared flag, the cluster synchronises,
// and every block reads all its peers' flags through distributed shared
// memory: all blocks of a tile take the same decision at every chunk.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace gs_tiles {

namespace cg = cooperative_groups;

constexpr int kPx = 4;               // consecutive pixels of a row per thread
constexpr int kMaxBlockThreads = 1024;
constexpr int kSmallThreads = 256;   // tile <= 32
constexpr int kMaxBands = 16;        // tile <= 256
// Returned by `launch` when cudaOccupancyMaxActiveClusters finds no place
// for one cluster of the tile's blocks.
constexpr int kErrNoCluster = -2;

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

// Launch `kernel` over n_tiles * b.bands blocks of b.threads, as clusters of
// b.bands blocks when b.bands > 1. Returns a cudaError_t, or kErrNoCluster.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int n_tiles, const Bands& b, cudaStream_t st,
           Args... args) {
  if (b.bands == 1) {
    kernel<<<n_tiles, b.threads, 0, st>>>(args...);
    return (int)cudaGetLastError();
  }
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
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace gs_tiles
