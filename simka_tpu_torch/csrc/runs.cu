// Run lengths of sorted key columns, and the join's segment pass
// (Hopper, sm_90a).
//
// Replaces the run-count and segment stages of the reference's join
// programs, which the port ran as torch ops:
//
//   run_counts    simka_tpu/ops/countjoin.py::_rows_from_instances (the
//                 run-length count and abundance filter after the sort);
//                 in the port ops/countjoin.py::_first_of_run (one
//                 comparison a key column), _run_counts (a .nonzero()
//                 host sync), the keep mask and int(kept.sum()).
//                 Row i of E sorted rows: first[i] = i == 0 or some key
//                 column differs from row i - 1; count[i] = the run
//                 length at a first row, 0 elsewhere (int32);
//                 keep[i] = first[i] && amin <= count[i] <= amax;
//                 total = kept rows.
//   segment_stats simka_tpu/ops/countjoin.py::_stats_from_rows' per-bank
//                 totals (binned_sum x 3) and _segment_rows; in the port
//                 three index_add_, _first_of_run, nonzero and two syncs.
//                 Over solid rows in (k-mer, sample) order: per bank s,
//                 distinct[s] = rows, solid[s] = sum count, chord[s] =
//                 sum count^2 (int64); newk[i] = first row of a k-mer
//                 (the word columns alone); scalars = (nb_distinct,
//                 nb_shared: segments of >= 2 rows, d_max: the longest
//                 segment, max_count).
//
// Both are two launches over tiles of 4096 rows:
//   1. run_bounds: first[i] from the key columns (each row and its
//      predecessor, coalesced), written as a byte a row, and each
//      tile's first boundary (a block min) into tile_first[t], or
//      kNone when the tile holds none (inside one long run).
//   2. The tile's flags go to shared memory. Thread t takes rows
//      [16 t, 16 t + 16) of the tile; the next boundary after its rows
//      is a block-wide exclusive suffix min of each thread's first
//      boundary (warp shuffles, then one entry a warp), and past the
//      tile's last boundary the first boundary of a later tile: warp 0
//      reads tile_first 32 tiles at a time with a ballot. So a run that
//      crosses tiles, or one longer than a tile (a k-mer seen millions
//      of times), costs a look-ahead of one 8-byte read a tile it spans,
//      made by the one tile that holds its first row. Each thread then
//      walks its rows backwards: run length = next boundary - row.
//      run_counts writes count and keep (over the flags), coalesced.
//      segment_stats, a persistent grid over the tiles, takes d_max,
//      nb_shared and nb_distinct from the lengths, and adds each row's
//      (1, count, count^2) into per-bank bins: in shared memory, one
//      flush of integer atomics a CTA, when 3 x 8 x N bytes fit in
//      kBinBytes, else straight into the outputs with device-memory
//      atomics. Every sum is an integer sum: exact, the same on every
//      run.
//
// What bounds them: device-memory bandwidth. run_counts reads the key
// columns once and writes 4 + 1 B a row: at phase 7's sorted packed key
// (313,342,848 int64 rows) 2.51 GB in, 1.57 GB out, 1.21 ms at 3.35
// TB/s. The flags take one more byte written and read a row, and the
// key's row i - 1 is read again from L1/L2. segment_stats reads the
// word columns, the sample id and the count once and writes a byte a
// row (21 B a row at k = 21 with the packed key's int64 sample id:
// 2.08 GB at phase 14's 99,009,246 solid rows, 0.62 ms). On an H100
// they take 2.7 ms and 1.6 ms there (chip_smoke.py phase 15b).
//
// Plain C interface for ctypes. Nothing here allocates or synchronises:
// the caller passes the outputs, the scratch and the stream; each entry
// point returns the first cudaError_t of its memsets and launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 16;
constexpr int kTile = kThreads * kRowsPerThread;  // 4096 rows
constexpr int kMaxCols = 8;
constexpr int64_t kNone = INT64_MAX;  // a tile without a boundary
constexpr int kBinBytes = 40 * 1024;  // shared per-bank bins, at most
constexpr int kSegmentBlocks = 1024;  // segment_stats' persistent grid

struct Cols {
  const void* p[kMaxCols];
  int size[kMaxCols];  // 4 or 8 bytes
  int n;
};

__device__ __forceinline__ int64_t load(const void* p, int size, int64_t i) {
  return size == 8 ? __ldg(static_cast<const long long*>(p) + i)
                   : (int64_t)__ldg(static_cast<const int*>(p) + i);
}

__device__ __forceinline__ bool first_of_run(const Cols& c, int64_t i) {
  if (i == 0) return true;
  bool d = false;
  for (int j = 0; j < c.n; ++j)
    d |= load(c.p[j], c.size[j], i) != load(c.p[j], c.size[j], i - 1);
  return d;
}

// pass 1: the flags, and each tile's first boundary
__global__ void __launch_bounds__(kThreads)
run_bounds(Cols cols, int64_t E, uint8_t* __restrict__ flags,
           int64_t* __restrict__ tile_first) {
  __shared__ long long s_min[kWarps];
  const int64_t tile0 = (int64_t)blockIdx.x * kTile;
  long long first = kNone;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int64_t i = tile0 + j;
    if (i >= E) break;
    const bool b = first_of_run(cols, i);
    flags[i] = b ? 1 : 0;
    if (b && first == kNone) first = i;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const long long other = __shfl_down_sync(0xffffffffu, first, o);
    first = other < first ? other : first;
  }
  if (threadIdx.x % 32 == 0) s_min[threadIdx.x / 32] = first;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long m = kNone;
    for (int w = 0; w < kWarps; ++w) m = s_min[w] < m ? s_min[w] : m;
    tile_first[blockIdx.x] = m;
  }
}

// warp 0: the first boundary at or after tile `from`, else E
__device__ __forceinline__ int64_t look_ahead(
    const int64_t* __restrict__ tile_first, int64_t from, int64_t n_tiles,
    int64_t E) {
  const int lane = threadIdx.x % 32;
  for (int64_t base = from; base < n_tiles; base += 32) {
    const int64_t t = base + lane;
    const long long v = t < n_tiles ? tile_first[t] : kNone;
    const unsigned m = __ballot_sync(0xffffffffu, v != kNone);
    if (m) return __shfl_sync(0xffffffffu, v, __ffs(m) - 1);
  }
  return E;
}

// Loads tile `tile`'s flags into s_flag (1 past E, so the run ending at
// E ends there) and gives each thread of the block, in `len`, the run
// length at each of its 16 rows (0 at rows that are no run's first, and
// at the rows past E).
// Starts and ends with __syncthreads.
__device__ __forceinline__ void tile_lengths(
    const uint8_t* __restrict__ flags, const int64_t* __restrict__ tile_first,
    int64_t tile, int64_t n_tiles, int64_t E, uint8_t* s_flag, int* s_warp,
    long long* s_after, int64_t (&len)[kRowsPerThread]) {
  const int64_t tile0 = tile * kTile;
  __syncthreads();
  for (int j = threadIdx.x; j < kTile; j += kThreads)
    s_flag[j] = tile0 + j < E ? flags[tile0 + j] : 1;
  if (threadIdx.x < 32) {
    const int64_t a = look_ahead(tile_first, tile + 1, n_tiles, E);
    if (threadIdx.x == 0) *s_after = a;
  }
  __syncthreads();
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const uint4 v = reinterpret_cast<const uint4*>(s_flag)[t];
  const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
  bool f[kRowsPerThread];
  int mine = kTile;  // this thread's first boundary (tile-local)
#pragma unroll
  for (int r = kRowsPerThread - 1; r >= 0; --r) {
    f[r] = (w4[r / 4] >> (8 * (r % 4))) & 0xffu;
    if (f[r]) mine = kRowsPerThread * t + r;
  }
  // exclusive suffix min over the threads after this one
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int other = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl = other < incl ? other : incl;
  }
  if (lane == 0) s_warp[warp] = incl;
  __syncthreads();
  int next = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) next = kTile;
  for (int w = warp + 1; w < kWarps; ++w)
    next = s_warp[w] < next ? s_warp[w] : next;
  int64_t nxt = next < kTile ? tile0 + next : (int64_t)*s_after;
#pragma unroll
  for (int r = kRowsPerThread - 1; r >= 0; --r) {
    const int64_t i = tile0 + kRowsPerThread * t + r;
    len[r] = f[r] && i < E ? nxt - i : 0;
    if (f[r]) nxt = i;
  }
  __syncthreads();
}

// pass 2 of run_counts: count and keep of one tile
__global__ void __launch_bounds__(kThreads)
run_lengths(const int64_t* __restrict__ tile_first, int64_t n_tiles,
            int64_t E, int64_t amin, int64_t amax, uint8_t* flags_keep,
            int32_t* __restrict__ count,
            unsigned long long* __restrict__ total) {
  __shared__ __align__(16) uint8_t s_flag[kTile];
  __shared__ int32_t s_cnt[kTile];
  __shared__ int s_warp[kWarps];
  __shared__ long long s_after;
  __shared__ unsigned long long s_kept[kWarps];
  const int64_t tile = blockIdx.x, tile0 = tile * kTile;
  int64_t len[kRowsPerThread];
  tile_lengths(flags_keep, tile_first, tile, n_tiles, E, s_flag, s_warp,
               &s_after, len);
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
    s_cnt[kRowsPerThread * threadIdx.x + r] = (int32_t)len[r];
  __syncthreads();
  unsigned long long kept = 0;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int64_t i = tile0 + j;
    if (i >= E) break;
    const int32_t c = s_cnt[j];
    const bool k = s_flag[j] && (int64_t)c >= amin && (int64_t)c <= amax;
    count[i] = c;
    flags_keep[i] = k ? 1 : 0;
    kept += k;
  }
  for (int o = 16; o > 0; o >>= 1)
    kept += __shfl_down_sync(0xffffffffu, kept, o);
  if (threadIdx.x % 32 == 0) s_kept[threadIdx.x / 32] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long b = 0;
    for (int w = 0; w < kWarps; ++w) b += s_kept[w];
    if (b) atomicAdd(total, b);
  }
}

// pass 2 of segment_stats over tiles blockIdx.x, + gridDim.x, ...;
// scalars: (nb_distinct, nb_shared, d_max, max_count)
__global__ void __launch_bounds__(kThreads)
segment_stats(const int64_t* __restrict__ tile_first, int64_t n_tiles,
              int64_t E, const uint8_t* __restrict__ newk, const void* sid,
              int sid_size, const void* cnt, int cnt_size, int64_t N,
              int shared_bins, unsigned long long* __restrict__ bins,
              unsigned long long* __restrict__ scalars) {
  extern __shared__ unsigned long long s_bins[];  // [3, N] when shared
  __shared__ __align__(16) uint8_t s_flag[kTile];
  __shared__ int s_warp[kWarps];
  __shared__ long long s_after;
  __shared__ unsigned long long s_red[4][kWarps];
  unsigned long long* out = shared_bins ? s_bins : bins;
  if (shared_bins)
    for (int64_t j = threadIdx.x; j < 3 * N; j += kThreads) s_bins[j] = 0;
  unsigned long long n_first = 0, n_shared = 0;
  long long d_max = 0, c_max = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int64_t len[kRowsPerThread];
    tile_lengths(newk, tile_first, tile, n_tiles, E, s_flag, s_warp,
                 &s_after, len);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      n_first += len[r] > 0;
      n_shared += len[r] >= 2;
      d_max = len[r] > d_max ? len[r] : d_max;
    }
    const int64_t tile0 = tile * kTile;
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const int64_t i = tile0 + j;
      if (i >= E) break;
      const int64_t s = load(sid, sid_size, i);
      const long long c = load(cnt, cnt_size, i);
      c_max = c > c_max ? c : c_max;
      atomicAdd(&out[s], 1ULL);
      atomicAdd(&out[N + s], (unsigned long long)c);
      atomicAdd(&out[2 * N + s], (unsigned long long)(c * c));
    }
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int o = 16; o > 0; o >>= 1) {
    n_first += __shfl_down_sync(0xffffffffu, n_first, o);
    n_shared += __shfl_down_sync(0xffffffffu, n_shared, o);
    const long long a = __shfl_down_sync(0xffffffffu, d_max, o);
    const long long b = __shfl_down_sync(0xffffffffu, c_max, o);
    d_max = a > d_max ? a : d_max;
    c_max = b > c_max ? b : c_max;
  }
  if (lane == 0) {
    s_red[0][warp] = n_first;
    s_red[1][warp] = n_shared;
    s_red[2][warp] = (unsigned long long)d_max;
    s_red[3][warp] = (unsigned long long)c_max;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long a = 0, b = 0;
    long long dm = 0, cm = 0;
    for (int w = 0; w < kWarps; ++w) {
      a += s_red[0][w];
      b += s_red[1][w];
      dm = (long long)s_red[2][w] > dm ? (long long)s_red[2][w] : dm;
      cm = (long long)s_red[3][w] > cm ? (long long)s_red[3][w] : cm;
    }
    if (a) atomicAdd(&scalars[0], a);
    if (b) atomicAdd(&scalars[1], b);
    atomicMax(reinterpret_cast<long long*>(&scalars[2]), dm);
    atomicMax(reinterpret_cast<long long*>(&scalars[3]), cm);
  }
  if (shared_bins)
    for (int64_t j = threadIdx.x; j < 3 * N; j += kThreads)
      if (s_bins[j]) atomicAdd(&bins[j], s_bins[j]);
}

bool make_cols(const void* const* ptrs, const int* sizes, int n, Cols& c) {
  if (n < 1 || n > kMaxCols) return false;
  c.n = n;
  for (int j = 0; j < kMaxCols; ++j) {
    c.p[j] = j < n ? ptrs[j] : nullptr;
    c.size[j] = j < n ? sizes[j] : 8;
    if (j < n && sizes[j] != 4 && sizes[j] != 8) return false;
  }
  return true;
}

int64_t n_tiles_of(int64_t E) { return (E + kTile - 1) / kTile; }

}  // namespace

extern "C" {

// rows a tile; tile_first needs one int64 a tile
int64_t simka_runs_tile_rows() { return kTile; }

// the largest N whose per-bank bins segment_stats keeps in shared memory
int64_t simka_segment_shared_banks() { return kBinBytes / (3 * 8); }

// cols: n_cols (1..8) pointers to [E] sorted key columns of int32 or
// int64 (sizes 4 or 8 bytes); count: [E] int32; keep: [E] bool; total:
// uint64 [1], zeroed here; tile_first: int64 [ceil(E / 4096)] scratch.
// E >= 1. Returns a cudaError_t code (0 on success).
int simka_run_counts(const void* const* cols, const int* sizes, int n_cols,
                     int64_t E, int64_t amin, int64_t amax, int32_t* count,
                     uint8_t* keep, uint64_t* total, int64_t* tile_first,
                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Cols c;
  if (E < 1 || !make_cols(cols, sizes, n_cols, c))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(total, 0, sizeof(uint64_t), stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = n_tiles_of(E);
  run_bounds<<<(unsigned)tiles, kThreads, 0, stream>>>(c, E, keep,
                                                       tile_first);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  run_lengths<<<(unsigned)tiles, kThreads, 0, stream>>>(
      tile_first, tiles, E, amin, amax, keep, count,
      reinterpret_cast<unsigned long long*>(total));
  return (int)cudaGetLastError();
}

// words: n_words (1..5) pointers to [E] int64 word columns, rows in
// (k-mer, sample) order; sid: [E] int32 or int64 in [0, N) (sid_size 4
// or 8); cnt: [E] int32 or int64 (cnt_size); newk: [E] bool; bins:
// int64 [3, N] (distinct, solid, chord n^2 a bank); scalars: int64 [4]
// (nb_distinct, nb_shared, d_max, max_count), both zeroed here;
// tile_first: int64 [ceil(E / 4096)] scratch. E >= 1. Returns a
// cudaError_t code (0 on success).
int simka_segment_stats(const void* const* words, int n_words, int64_t E,
                        const void* sid, int sid_size, const void* cnt,
                        int cnt_size, int64_t N, uint8_t* newk,
                        uint64_t* bins, uint64_t* scalars,
                        int64_t* tile_first, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Cols c;
  int sizes[kMaxCols];
  for (int j = 0; j < kMaxCols; ++j) sizes[j] = 8;
  if (E < 1 || N < 1 || !make_cols(words, sizes, n_words, c) ||
      (sid_size != 4 && sid_size != 8) || (cnt_size != 4 && cnt_size != 8))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(bins, 0, 3 * N * sizeof(uint64_t), stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scalars, 0, 4 * sizeof(uint64_t), stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = n_tiles_of(E);
  run_bounds<<<(unsigned)tiles, kThreads, 0, stream>>>(c, E, newk,
                                                       tile_first);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int shared_bins = 3 * N * 8 <= kBinBytes ? 1 : 0;
  const int64_t blocks = tiles < kSegmentBlocks ? tiles : kSegmentBlocks;
  segment_stats<<<(unsigned)blocks, kThreads,
                  shared_bins ? (size_t)(3 * N * 8) : 0, stream>>>(
      tile_first, tiles, E, newk, sid, sid_size, cnt, cnt_size, N,
      shared_bins, reinterpret_cast<unsigned long long*>(bins),
      reinterpret_cast<unsigned long long*>(scalars));
  return (int)cudaGetLastError();
}

}  // extern "C"
