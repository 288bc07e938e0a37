// Stable stream compaction of row columns on a kept mask (Hopper, sm_90a).
//
// Replaces the TPU kernel simka_tpu/ops/pallas_compact.py::_gapclose_call
// and the whole of simka_tpu/ops/compact.py::compact_rows around it
// (block-local stable sort on the 1-bit drop key + ordered gap-close
// copies). That design relied on a sequential grid: later blocks
// overwrote earlier blocks' fill tails in order. CUDA blocks run in no
// order, so here each tile writes ONLY its kept rows, at exact global
// positions, and the tail [n_kept, E) is filled by a separate kernel.
//
//   1. compact_tile_counts: kept rows per tile (__syncthreads_count).
//   2. compact_scan_tiles:  one CTA, exclusive scan of the tile counts
//                           into int64 offsets; offs[n_tiles] = n_kept.
//   3. compact_scatter:     each tile recomputes its local ranks (warp
//                           __ballot_sync + __popc, then a warp prefix
//                           in shared memory) and writes every column.
//                           Order within a tile follows lane order, so
//                           the compaction is stable.
//   4. compact_fill:        out[c][i] = fill[c] for i >= n_kept (read
//                           from the device: no host sync).
//
// What bounds it: memory bandwidth. Each kept row is read and written
// once per column, the mask is read twice, so the pass moves about
// 2 x payload bytes + 2 B/row; at the k=21 join (int64 key + int64
// count) that is ~34 B/row. No shared-memory staging and no vector
// loads yet: the design is the simple correct one.
//
// Plain C interface for ctypes. Nothing here allocates or synchronises:
// the caller passes scratch buffers and the stream, and each entry
// point returns cudaGetLastError() for the caller to raise on.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libsimka_kernels.so compact.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;             // rows per tile = 256 * 16
constexpr int64_t kTile = (int64_t)kThreads * kRounds;
constexpr int kMaxCols = 8;
constexpr int kScanThreads = 1024;

struct Cols {
  const void* in[kMaxCols];
  void* out[kMaxCols];
  int64_t fill[kMaxCols];
  int size[kMaxCols];  // 4 or 8 bytes
  int n;
};

__device__ __forceinline__ void copy_row(const Cols& c, int64_t src,
                                         int64_t dst) {
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    if (j >= c.n) break;
    if (c.size[j] == 8) {
      static_cast<int64_t*>(c.out[j])[dst] =
          static_cast<const int64_t*>(c.in[j])[src];
    } else {
      static_cast<int32_t*>(c.out[j])[dst] =
          static_cast<const int32_t*>(c.in[j])[src];
    }
  }
}

__global__ void compact_tile_counts(const uint8_t* __restrict__ kept,
                                    int64_t E, int32_t* __restrict__ counts) {
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int total = 0;
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + (int64_t)r * kThreads + threadIdx.x;
    const int pred = (i < E) ? (kept[i] != 0) : 0;
    total += __syncthreads_count(pred);
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// Exclusive scan of n tile counts by one CTA: each thread sums a
// contiguous chunk, the chunk sums are scanned in shared memory, and
// each thread then walks its chunk again writing offsets.
__global__ void compact_scan_tiles(const int32_t* __restrict__ counts,
                                   int64_t n, int64_t* __restrict__ offs) {
  __shared__ int64_t sums[kScanThreads];
  const int64_t per = (n + kScanThreads - 1) / kScanThreads;
  const int64_t lo = (int64_t)threadIdx.x * per;
  const int64_t hi = lo + per < n ? lo + per : n;
  int64_t s = 0;
  for (int64_t i = lo; i < hi; ++i) s += counts[i];
  sums[threadIdx.x] = s;
  __syncthreads();
  // Hillis-Steele inclusive scan over the chunk sums
  for (int d = 1; d < kScanThreads; d <<= 1) {
    int64_t v = threadIdx.x >= d ? sums[threadIdx.x - d] : 0;
    __syncthreads();
    sums[threadIdx.x] += v;
    __syncthreads();
  }
  int64_t run = sums[threadIdx.x] - s;  // exclusive prefix of this chunk
  for (int64_t i = lo; i < hi; ++i) {
    offs[i] = run;
    run += counts[i];
  }
  if (threadIdx.x == kScanThreads - 1) offs[n] = sums[kScanThreads - 1];
}

__global__ void compact_scatter(const uint8_t* __restrict__ kept, int64_t E,
                                const int64_t* __restrict__ offs, Cols cols) {
  __shared__ int warp_counts[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int64_t dst = offs[blockIdx.x];
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + (int64_t)r * kThreads + threadIdx.x;
    const bool pred = (i < E) && (kept[i] != 0);
    const unsigned ballot = __ballot_sync(0xffffffffu, pred);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, round_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_counts[w];
      before += (w < warp) ? c : 0;
      round_total += c;
    }
    if (pred) copy_row(cols, i, dst + before + __popc(ballot & lanes_below));
    dst += round_total;
    __syncthreads();  // warp_counts is rewritten by the next round
  }
}

__global__ void compact_fill(int64_t E, const int64_t* __restrict__ n_kept,
                             Cols cols) {
  const int64_t start = *n_kept;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = start + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < E; i += stride) {
    for (int j = 0; j < cols.n; ++j) {
      if (cols.size[j] == 8) {
        static_cast<int64_t*>(cols.out[j])[i] = cols.fill[j];
      } else {
        static_cast<int32_t*>(cols.out[j])[i] = (int32_t)cols.fill[j];
      }
    }
  }
}

}  // namespace

extern "C" {

int64_t simka_compact_tile_rows() { return kTile; }

// kept: [E] bool (one byte each). ins/outs: n_cols device pointers of
// [E] columns; sizes: element bytes (4 or 8); fills: per-column fill
// (low 32 bits for 4-byte columns). tile_counts: int32 scratch
// [n_tiles]; offs: int64 scratch [n_tiles + 1], with n_tiles =
// ceil(E / simka_compact_tile_rows()). offs[n_tiles] ends up holding
// the kept count. Returns a cudaError_t code (0 on success).
int simka_compact_rows(const uint8_t* kept, int64_t E, int n_cols,
                       void* const* ins, void* const* outs,
                       const int* sizes, const int64_t* fills,
                       int32_t* tile_counts, int64_t* offs,
                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_cols < 1 || n_cols > kMaxCols || E < 1) return (int)cudaErrorInvalidValue;
  Cols cols;
  cols.n = n_cols;
  for (int j = 0; j < kMaxCols; ++j) {
    const bool on = j < n_cols;
    cols.in[j] = on ? ins[j] : nullptr;
    cols.out[j] = on ? outs[j] : nullptr;
    cols.fill[j] = on ? fills[j] : 0;
    cols.size[j] = on ? sizes[j] : 4;
    if (on && sizes[j] != 4 && sizes[j] != 8) return (int)cudaErrorInvalidValue;
  }
  const int64_t n_tiles = (E + kTile - 1) / kTile;
  compact_tile_counts<<<(unsigned)n_tiles, kThreads, 0, stream>>>(
      kept, E, tile_counts);
  compact_scan_tiles<<<1, kScanThreads, 0, stream>>>(tile_counts, n_tiles,
                                                     offs);
  compact_scatter<<<(unsigned)n_tiles, kThreads, 0, stream>>>(kept, E, offs,
                                                              cols);
  int64_t fill_blocks = (E + kThreads - 1) / kThreads;
  if (fill_blocks > 132 * 16) fill_blocks = 132 * 16;
  compact_fill<<<(unsigned)fill_blocks, kThreads, 0, stream>>>(
      E, offs + n_tiles, cols);
  return (int)cudaGetLastError();
}

}  // extern "C"
