// K2 - entry sort: a one-sweep stable LSD radix sort of the live 16-byte
// entries on their 32-bit key, then the per-tile run edges.
//
// Replaces the Pallas chain `wgpu_3dgs_viewer_app_tpu/ops/compact.py::
// _compact_kernel` -> `ops/sort.py::_block_sort_kernel` -> `ops/sort.py::
// _merge_kernel` (and the searchsorted of `ops/binning.py::_tile_edges`).
// Those three exist only because Mosaic has no scatter; the function is one:
// sort the live entries (key != SENTINEL) ascending by u32 key with their
// three payload words attached, ties in slot order (the v1 chain's bit-equal
// binning rests on that stability).
//
//   1. upfront: one read of the slots counts the live entries and builds the
//      histograms of all four 8-bit digits of the live keys (block-private
//      shared-memory histograms, one global atomic per bin and block); a
//      second tiny kernel turns them into each digit's global start;
//   2. four passes, one kernel each (Adinets & Merrill, "Onesweep", 2022).
//      A block takes its tile of 2560 entries from an atomic ticket (so
//      the tiles before it are running and look-back always progresses;
//      passes 2-4 run a grid that fits the card at once, whose blocks take
//      tickets until the live entries' tiles run out),
//      loads them as 16-byte vectors, ranks them stably in the block (warp
//      multi-split with __match_any_sync and per-warp digit counters
//      combined in warp order), publishes its per-digit counts and then its
//      inclusive prefixes through decoupled look-back (flag and count in
//      one 32-bit word per (tile, digit)), reorders the tile into digit
//      order in shared memory and stores each digit run with consecutive
//      threads on consecutive addresses. Pass 1 reads the raw slots and
//      leaves sentinel slots out of its ranks, so it also compacts;
//   3. run edges: entry i writes edges[t] = i for every tile t in
//      (tile(i-1), tile(i)], and the last entry closes the tail.
//
// The live count stays on the device: passes 2-4 and the edges read it
// there, so the host issues the sort with no wait and the sort can be
// captured in a CUDA graph; the buffers are sized by the slots.
//
// What bounds it on an H100: memory traffic. E slots of which L are live
// move 16 E (upfront) + 16 E + 16 L (pass 1) + 3 x 32 L (passes 2-4) bytes.
// The design reads the slots twice instead of once per histogram and
// compaction step, keeps every rank in registers and shared memory, and
// writes whole digit runs so that the stores coalesce. 10 entries a thread
// at 3 blocks an SM (80 registers, no spills) came out fastest of the
// sizes tried (8-16 entries, 2-4 blocks).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;               // threads per block, all kernels
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 10;                  // entries per thread per tile
constexpr int kMinBlocks = 3;               // resident pass blocks an SM
constexpr int kTile = kThreads * kItems;    // entries per pass tile
constexpr int kRadix = 256;                 // 8-bit digits
constexpr int kPasses = 4;
constexpr int kMetaStarts = kPasses * kRadix + 1;  // meta layout, see gs_sort_upfront
constexpr int kMetaWords = kMetaStarts + kPasses * kRadix;
// Look-back status word: 2 flag bits over a 30-bit count.
constexpr unsigned kFlagAggregate = 1u << 30;
constexpr unsigned kFlagInclusive = 2u << 30;
constexpr unsigned kCountMask = kFlagAggregate - 1u;
// The pass kernel's reorder buffer, in dynamic shared memory: with the
// kernel's ~10 KB of static shared memory it passes the 48 KB a block may
// take without opting in (cudaFuncSetAttribute in gs_sort_onesweep).
constexpr size_t kPassSmem = sizeof(uint4) * kTile;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Exclusive scan of one value per thread over a block of kThreads threads;
// *total receives the block's sum. `warp_sums` holds kWarps words.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* warp_sums,
                                                         unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  unsigned before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned s = warp_sums[w];
    if (w < warp) before += s;
    sum += s;
  }
  *total = sum;
  return before + incl - v;
}

// ---- 1. upfront histograms ----------------------------------------------------

__device__ __forceinline__ void count_key(unsigned k, unsigned (*h)[kRadix], unsigned& live) {
  if (k == GS_SENTINEL) return;
  ++live;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) atomicAdd(&h[p][(k >> (8 * p)) & 0xFFu], 1u);
}

__global__ void __launch_bounds__(kThreads)
upfront_kernel(const uint4* __restrict__ in, long long n, unsigned* __restrict__ meta) {
  __shared__ unsigned h[kPasses][kRadix];
  __shared__ unsigned warp_live[kWarps];
  for (int i = threadIdx.x; i < kPasses * kRadix; i += kThreads) (&h[0][0])[i] = 0u;
  __syncthreads();
  unsigned live = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; i + 3 * stride < n; i += 4 * stride) {
    unsigned k[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) k[u] = __ldg(&in[i + u * stride].x);
#pragma unroll
    for (int u = 0; u < 4; ++u) count_key(k[u], h, live);
  }
  for (; i < n; i += stride) count_key(__ldg(&in[i].x), h, live);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) live += __shfl_down_sync(0xFFFFFFFFu, live, o);
  if ((threadIdx.x & 31) == 0) warp_live[threadIdx.x >> 5] = live;
  __syncthreads();
  for (int j = threadIdx.x; j < kPasses * kRadix; j += kThreads) {
    const unsigned c = (&h[0][0])[j];
    if (c) atomicAdd(&meta[j], c);
  }
  if (threadIdx.x == 0) {
    unsigned s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_live[w];
    atomicAdd(&meta[kPasses * kRadix], s);
  }
}

// Block p turns digit position p's histogram into each digit's global start.
__global__ void __launch_bounds__(kRadix) digit_start_kernel(unsigned* __restrict__ meta) {
  __shared__ unsigned warp_sums[kWarps];
  const int p = blockIdx.x, d = threadIdx.x;
  unsigned total;
  meta[kMetaStarts + p * kRadix + d] =
      block_exclusive_scan(meta[p * kRadix + d], warp_sums, &total);
}

// ---- 2. one-sweep digit pass ----------------------------------------------------

// One stable scatter pass on the digit at `shift`: in[0, n) -> out, live
// entries only (in[i].x != SENTINEL; every entry after pass 1). n is
// `n_fixed` where `live_count` is NULL (pass 1: every slot), else
// *live_count, the count
// the upfront pass left on the device, so that the host never reads it.
// `start`: each digit's global start; `status`: kRadix zeroed words per
// tile; `status_next` (NULL on the last pass): the next pass's status, whose
// rows of the tiles this pass takes it zeroes; `ticket`: a zeroed counter. A
// block takes tiles by ticket until they run out, so a grid smaller than the
// tiles walks them all (the blocks that took earlier tickets are running,
// so look-back always progresses).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
onesweep_pass_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, long long n_fixed,
                     const unsigned* __restrict__ live_count, int shift,
                     const unsigned* __restrict__ start, unsigned* status,
                     unsigned* __restrict__ status_next, unsigned* ticket) {
  extern __shared__ uint4 s_ent[];              // kTile entries in digit order
  __shared__ unsigned s_warp[kWarps][kRadix];   // per-warp digit counts -> offsets
  __shared__ unsigned s_excl[kRadix];           // digit's start in the block's order
  __shared__ int s_off[kRadix];                 // global position - block position
  __shared__ unsigned s_sums[kWarps];
  __shared__ unsigned s_tile;

  const long long n = live_count == nullptr ? n_fixed : (long long)*live_count;
  const unsigned tiles = (unsigned)((n + kTile - 1) / kTile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (;;) {
    __syncthreads();  // the last tile's reads of shared memory are done
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s_warp[w][tid] = 0u;
    if (tid == 0) s_tile = atomicAdd(ticket, 1u);
    __syncthreads();
    const unsigned tile = s_tile;
    if (tile >= tiles) return;
    if (status_next != nullptr) status_next[(size_t)tile * kRadix + tid] = 0u;

    // Warp w holds entries [w * 32 * kItems, (w + 1) * 32 * kItems) of the
    // tile; item r of lane l is entry r * 32 + l of that range, so (warp,
    // item, lane) is slot order.
    const long long base = (long long)tile * kTile + warp * (32 * kItems) + lane;
    uint4 e[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const long long i = base + r * 32;
      e[r] = i < n ? in[i] : make_uint4(GS_SENTINEL, 0u, 0u, 0u);
    }

    // Stable rank inside the warp: peers by __match_any_sync, earlier items
    // of the same digit counted in s_warp; the lowest peer advances it.
    const unsigned lt = lanemask_lt();
    unsigned rank[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const bool live = e[r].x != GS_SENTINEL;
      const unsigned d = live ? (e[r].x >> shift) & 0xFFu : 0x100u;
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
      const unsigned before = live ? s_warp[warp][d] : 0u;
      __syncwarp();
      const unsigned pre = __popc(peers & lt);
      rank[r] = before + pre;
      if (live && pre == 0) s_warp[warp][d] = before + __popc(peers);
      __syncwarp();
    }
    __syncthreads();

    // Thread d: the warps' counts of digit d -> exclusive offsets in warp
    // order; the block's count of d is published at once for look-back.
    const unsigned d = tid;
    unsigned count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned c = s_warp[w][d];
      s_warp[w][d] = count;
      count += c;
    }
    volatile unsigned* my_status = status + (size_t)tile * kRadix + d;
    *my_status = (tile == 0 ? kFlagInclusive : kFlagAggregate) | count;
    unsigned n_tile;
    const unsigned excl = block_exclusive_scan(count, s_sums, &n_tile);
    s_excl[d] = excl;
    __syncthreads();

    // Reorder into digit order in shared memory.
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      if (e[r].x == GS_SENTINEL) continue;
      const unsigned dr = (e[r].x >> shift) & 0xFFu;
      s_ent[s_excl[dr] + s_warp[warp][dr] + rank[r]] = e[r];
    }

    // Decoupled look-back over the earlier tiles for digit d.
    unsigned prefix = 0;
    if (tile > 0) {
      for (long long p = (long long)tile - 1;; --p) {
        const volatile unsigned* ps = status + (size_t)p * kRadix + d;
        unsigned s;
        do {
          s = *ps;
        } while ((s & ~kCountMask) == 0u);
        prefix += s & kCountMask;
        if (s & kFlagInclusive) break;
      }
      *my_status = kFlagInclusive | (prefix + count);
    }
    s_off[d] = (int)(start[d] + prefix) - (int)excl;
    __syncthreads();

    // Each digit run of the tile to its place: consecutive threads, consecutive addresses.
    for (int i = tid; i < (int)n_tile; i += kThreads) {
      const uint4 x = s_ent[i];
      out[s_off[(x.x >> shift) & 0xFFu] + i] = x;
    }
    if (gridDim.x >= tiles) return;  // one tile a block
  }
}

// ---- 3. tile edges -----------------------------------------------------------

// Over the *live sorted entries, a grid-stride loop: entry i writes
// edges[t] = i for every tile t in (tile(i-1), tile(i)], and the last one
// closes the tail.
__global__ void tile_edges_kernel(const uint4* __restrict__ sorted,
                                  const unsigned* __restrict__ live, int shift, int n_tiles,
                                  int* __restrict__ edges) {
  const int n = (int)*live;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int t = (int)(sorted[i].x >> shift);
    const int tp = i == 0 ? -1 : (int)(sorted[i - 1].x >> shift);
    for (int u = tp + 1; u <= t; ++u) edges[u] = i;
    if (i == n - 1)
      for (int u = t + 1; u <= n_tiles; ++u) edges[u] = n;
  }
}

}  // namespace

extern "C" {

// Tiles of a pass over n entries (the look-back status holds kRadix words per tile).
int gs_sort_num_tiles(long long n) { return (int)((n + kTile - 1) / kTile); }

// Words of the meta buffer: [0, 1024) the four digit histograms of the live
// keys, [1024] the live count, [1025, 2049) each digit's global start.
int gs_sort_meta_words() { return kMetaWords; }

// The whole sort, with no read by the host: entries[0, n) -> buf_a[0, L)
// sorted, where L, the live count, is counted on the device into meta[1024]
// (gs_sort_meta_words); then the run edges of the sorted keys' tile field
// at bit `shift` into edges[0, n_tiles]. buf_a and buf_b hold n entries
// each (buf_b is scratch), status 2 * gs_sort_num_tiles(n) * 256 words,
// tickets 4 words. Pass 1 runs a block a tile of the n slots; passes 2-4
// and the edges, whose work is L, run a grid that fits the card at once
// and walk L's tiles.
int gs_sort(const void* entries, long long n, unsigned* meta, void* buf_a, void* buf_b,
            unsigned* status, unsigned* tickets, int shift, int n_tiles, int* edges,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(edges, 0, sizeof(int) * (n_tiles + 1), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(meta, 0, sizeof(unsigned) * kMetaWords, st);
  if (err != cudaSuccess || n <= 0) return (int)err;
  if (n > (long long)kCountMask) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n + 8LL * kThreads - 1) / (8LL * kThreads);
  const int grid = (int)(want < 4LL * sms ? want : 4LL * sms);
  upfront_kernel<<<grid, kThreads, 0, st>>>(static_cast<const uint4*>(entries), n, meta);
  digit_start_kernel<<<kPasses, kRadix, 0, st>>>(meta);
  // Set on every call: the attribute belongs to the current device.
  err = cudaFuncSetAttribute(onesweep_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kPassSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = gs_sort_num_tiles(n);
  err = cudaMemsetAsync(tickets, 0, sizeof(unsigned) * kPasses, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(status, 0, sizeof(unsigned) * kRadix * tiles, st);
  if (err != cudaSuccess) return (int)err;
  const unsigned* live = meta + kPasses * kRadix;
  const int resident = kMinBlocks * sms < tiles ? kMinBlocks * sms : tiles;
  // entries -> b -> a -> b -> a; the status alternates between two regions.
  const uint4* src = static_cast<const uint4*>(entries);
  uint4* a = static_cast<uint4*>(buf_a);
  uint4* b = static_cast<uint4*>(buf_b);
  for (int p = 0; p < kPasses; ++p) {
    uint4* dst = (p & 1) ? a : b;
    unsigned* cur = status + (size_t)(p & 1) * kRadix * tiles;
    unsigned* next = p + 1 < kPasses ? status + (size_t)((p + 1) & 1) * kRadix * tiles : nullptr;
    onesweep_pass_kernel<<<p == 0 ? tiles : resident, kThreads, kPassSmem, st>>>(
        src, dst, n, p == 0 ? nullptr : live, 8 * p, meta + kMetaStarts + p * kRadix, cur, next,
        tickets + p);
    src = dst;
  }
  const long long edge_blocks = (n + kThreads - 1) / kThreads;
  tile_edges_kernel<<<(int)(edge_blocks < 8LL * sms ? edge_blocks : 8LL * sms), kThreads, 0, st>>>(
      a, live, shift, n_tiles, edges);
  return (int)cudaGetLastError();
}

}  // extern "C"
