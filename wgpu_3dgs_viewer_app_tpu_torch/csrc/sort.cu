// K2 - entry sort: live-entry compaction + stable LSD radix sort of 16-byte
// entries on their 32-bit key, then the per-tile run edges.
//
// Replaces the Pallas chain `wgpu_3dgs_viewer_app_tpu/ops/compact.py::
// _compact_kernel` -> `ops/sort.py::_block_sort_kernel` -> `ops/sort.py::
// _merge_kernel` (and the searchsorted of `ops/binning.py::_tile_edges`).
// Those three exist only because Mosaic has no scatter; the function is one:
// sort the live entries (key != SENTINEL) ascending by u32 key with their
// three payload words attached.
//
//   1. compaction: per-block live counts, one exclusive scan, then an
//      order-preserving scatter of the live entries into a dense prefix;
//   2. radix sort of that prefix, 4 passes of 8 bits. Each pass: per-block
//      digit histograms, an exclusive scan of every digit's column over the
//      blocks plus a scan of the digit totals, then a stable scatter in
//      which each block ranks its items round by round (one item per
//      thread, in index order) with warp ballots on the digit bits;
//   3. run edges: thread i writes edges[t] = i for every tile t in
//      (tile(i-1), tile(i)], and the last thread closes the tail.
//
// What bounds it on an H100: memory traffic. Each radix pass reads the
// 16-byte entries twice (histogram, scatter) and writes them once, so a
// frame of E live entries moves ~4 * 48 * E bytes plus the compaction's
// 32 * E; the scatter's writes land in up to 256 digit runs per block. The
// design keeps every rank computation in shared memory and registers, moves
// whole 16-byte entries with one vector load and store, and sorts only the
// live prefix (the sentinel slack of culled slots is dropped first). The
// live count is read back to the host by the wrapper to size the sort.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;              // threads per block, all kernels
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                  // items per thread per block tile
constexpr int kTile = kThreads * kItems;   // entries per block tile
constexpr int kScanThreads = 1024;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Exclusive scan over a block of kScanThreads threads; returns the thread's
// exclusive prefix and writes the block total to *total.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) warp_sums[lane] = w;  // inclusive warp prefix
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[(blockDim.x >> 5) - 1];
  __syncthreads();
  return before + incl - v;
}

// In-place exclusive scan of data[i * stride] for i < count, by one block;
// blockIdx.x selects the column (data + blockIdx.x), totals[blockIdx.x]
// receives the column total.
__global__ void __launch_bounds__(kScanThreads)
column_scan_kernel(int* data, int count, int stride, int* totals) {
  __shared__ int warp_sums[32];
  int* col = data + blockIdx.x;
  int carry = 0;
  for (int base = 0; base < count; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < count ? col[(int64_t)i * stride] : 0;
    int chunk_total;
    const int excl = block_exclusive_scan(v, warp_sums, &chunk_total);
    if (i < count) col[(int64_t)i * stride] = carry + excl;
    carry += chunk_total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// ---- 1. compaction ---------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
count_live_kernel(const uint4* __restrict__ in, int64_t n, int* __restrict__ counts) {
  __shared__ int warp_cnt[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int c = 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = base + r * kThreads + threadIdx.x;
    if (i < n && in[i].x != GS_SENTINEL) ++c;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, o);
  if ((threadIdx.x & 31) == 0) warp_cnt[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_cnt[w];
    counts[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint4* __restrict__ in, int64_t n, const int* __restrict__ offsets,
               uint4* __restrict__ out) {
  __shared__ int warp_cnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int running = offsets[blockIdx.x];
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = base + r * kThreads + threadIdx.x;
    uint4 e = make_uint4(GS_SENTINEL, 0u, 0u, 0u);
    if (i < n) e = in[i];
    const bool live = e.x != GS_SENTINEL;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, live);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int before = running, round_total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += warp_cnt[w];
      round_total += warp_cnt[w];
    }
    if (live) out[before + __popc(ballot & lanemask_lt())] = e;
    running += round_total;
    __syncthreads();
  }
}

// ---- 2. radix sort -----------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const uint4* __restrict__ in, int n, int shift, int* __restrict__ hist) {
  __shared__ int h[256];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kTile;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = base + r * kThreads + threadIdx.x;
    if (i < n) atomicAdd(&h[(in[i].x >> shift) & 0xFFu], 1);
  }
  __syncthreads();
  hist[(int64_t)blockIdx.x * 256 + threadIdx.x] = h[threadIdx.x];
}

// hist holds, per block, the exclusive offset of each digit among earlier
// blocks (after column_scan_kernel); digit_total the count of each digit.
__global__ void __launch_bounds__(kThreads)
radix_scatter_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, int n, int shift,
                     const int* __restrict__ hist, const int* __restrict__ digit_total) {
  __shared__ int base_off[256];
  __shared__ int wcnt[kWarps][256];
  __shared__ int warp_sums[32];
  const int tid = threadIdx.x, warp = tid >> 5;

  // Digit start = exclusive scan of the digit totals (256 = kThreads).
  int total;
  const int dstart = block_exclusive_scan(digit_total[tid], warp_sums, &total);
  base_off[tid] = dstart + hist[(int64_t)blockIdx.x * 256 + tid];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) wcnt[w][tid] = 0;
  __syncthreads();

  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = base + r * kThreads + tid;
    const bool valid = i < n;
    uint4 e = make_uint4(0u, 0u, 0u, 0u);
    if (valid) e = in[i];
    const unsigned digit = (e.x >> shift) & 0xFFu;
    // Lanes of this warp holding the same digit.
    unsigned peers = __ballot_sync(0xFFFFFFFFu, valid);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const unsigned bit = __ballot_sync(0xFFFFFFFFu, (digit >> b) & 1u);
      peers &= ((digit >> b) & 1u) ? bit : ~bit;
    }
    const int rank = __popc(peers & lanemask_lt());
    if (valid && rank == 0) wcnt[warp][digit] = __popc(peers);
    __syncthreads();
    if (valid) {
      int off = base_off[digit] + rank;
      for (int w = 0; w < warp; ++w) off += wcnt[w][digit];
      out[off] = e;
    }
    __syncthreads();
    int add = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      add += wcnt[w][tid];
      wcnt[w][tid] = 0;
    }
    base_off[tid] += add;
    __syncthreads();
  }
}

// ---- 3. tile edges -----------------------------------------------------------

__global__ void tile_edges_kernel(const uint4* __restrict__ sorted, int n, int shift,
                                  int n_tiles, int* __restrict__ edges) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = (int)(sorted[i].x >> shift);
  const int tp = i == 0 ? -1 : (int)(sorted[i - 1].x >> shift);
  for (int u = tp + 1; u <= t; ++u) edges[u] = i;
  if (i == n - 1)
    for (int u = t + 1; u <= n_tiles; ++u) edges[u] = n;
}

}  // namespace

extern "C" {

int gs_sort_num_blocks(long long n) { return (int)((n + kTile - 1) / kTile); }

// Live count: counts[gs_sort_num_blocks(n)] -> exclusive offsets, total[0].
int gs_sort_count_live(const void* entries, long long n, int* counts, int* total, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = gs_sort_num_blocks(n);
  if (nb == 0) return (int)cudaMemsetAsync(total, 0, sizeof(int), st);
  count_live_kernel<<<nb, kThreads, 0, st>>>(static_cast<const uint4*>(entries), n, counts);
  column_scan_kernel<<<1, kScanThreads, 0, st>>>(counts, nb, 1, total);
  return (int)cudaGetLastError();
}

// Compacts the live entries into buf_a[0, n_live) and radix-sorts them;
// buf_b is scratch of the same size, hist holds gs_sort_num_blocks(n_live)
// * 256 ints, digit_total 256 ints. The result ends in buf_a.
int gs_sort_compact_radix(const void* entries, long long n, const int* offsets, void* buf_a,
                          void* buf_b, int n_live, int* hist, int* digit_total, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = gs_sort_num_blocks(n);
  if (nb > 0)
    compact_kernel<<<nb, kThreads, 0, st>>>(static_cast<const uint4*>(entries), n, offsets,
                                            static_cast<uint4*>(buf_a));
  const int rb = gs_sort_num_blocks(n_live);
  uint4* src = static_cast<uint4*>(buf_a);
  uint4* dst = static_cast<uint4*>(buf_b);
  for (int shift = 0; rb > 0 && shift < 32; shift += 8) {
    radix_hist_kernel<<<rb, kThreads, 0, st>>>(src, n_live, shift, hist);
    column_scan_kernel<<<256, kScanThreads, 0, st>>>(hist, rb, 256, digit_total);
    radix_scatter_kernel<<<rb, kThreads, 0, st>>>(src, dst, n_live, shift, hist, digit_total);
    uint4* t = src;
    src = dst;
    dst = t;
  }
  return (int)cudaGetLastError();
}

// edges: n_tiles + 1 ints, pre-filled with 0 by the caller when n == 0.
int gs_sort_tile_edges(const void* sorted, int n, int shift, int n_tiles, int* edges,
                       void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tile_edges_kernel<<<(n + 255) / 256, 256, 0, st>>>(static_cast<const uint4*>(sorted), n, shift,
                                                     n_tiles, edges);
  return (int)cudaGetLastError();
}

}  // extern "C"
