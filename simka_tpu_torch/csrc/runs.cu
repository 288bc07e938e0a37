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
// Both work on tiles of 4096 rows, and a run's length is the next
// boundary after its first row, minus that row.
//
// run_counts is one launch, a persistent grid over the tiles. Warp w
// takes the tile's rows [512 w, 512 w + 512) in 16 steps of 32: lane l
// loads row 32 j + l of every key column (each step one coalesced 256-B
// row of the warp), compares it with row 32 j + l - 1 (the previous
// lane's by a shuffle; lane 31's of the step before; the previous
// warp's last row read once), and keeps its 16 boundary bits in a
// register. A ballot a step gives the warp every boundary of its 512
// rows: a row's next boundary is the first set bit after its lane in
// its step's ballot, else the warp's first at a later step, else the
// later warps' first (one shared entry a warp), else past the tile.
// There, the warp holding the tile's last boundary finds where that run
// ends (run_end): the 32 rows after the tile, then probes 32 << l rows
// on and a 32-ary search, testing only equality with the run's key (the
// rows are grouped, not necessarily ascending). A tile inside one long
// run has no boundary and searches nothing, so a run of any length
// costs O(log run) reads, made once. count (int32) and keep go out a
// step at a time, coalesced, straight from registers; the kept total
// is one atomic a CTA. No flags array, no scratch.
//
// segment_stats is two launches; its thread t takes rows [16 t, 16 t +
// 16) of a tile:
//   1. run_bounds: first[i] from the key columns (each row and its
//      predecessor, coalesced), written as a byte a row, and each
//      tile's first boundary (a block min) into tile_first[t], or
//      kNone when the tile holds none (inside one long run).
//   2. A persistent grid over the tiles: the tile's flags go to shared
//      memory (tile_lengths); a row's next boundary is in the thread's
//      own rows, else a block-wide exclusive suffix min of each
//      thread's first boundary, and past the tile's last boundary the
//      first boundary of a later tile: warp 0 reads tile_first 32 tiles
//      at a time with a ballot. It takes d_max, nb_shared and
//      nb_distinct from the lengths, and adds each row's (1, count,
//      count^2) into per-bank bins: in shared memory, one flush of
//      integer atomics a CTA, when 3 x 8 x N bytes fit in kBinBytes,
//      else straight into the outputs with device-memory atomics. Every
//      sum is an integer sum: exact, the same on every run.
//
// What bounds them: device-memory bandwidth. run_counts reads the key
// columns once and writes 4 + 1 B a row: at phase 7's sorted packed key
// (313,342,848 int64 rows) 2.51 GB in, 1.57 GB out, 1.22 ms at 3.35
// TB/s; it takes 1.46 ms there on the device (profiling/kernel_ab.py,
// NVIDIA H100 80GB HBM3, 700.00 W). segment_stats reads the word
// columns, the sample id and the count once and writes a byte a row
// (21 B a row at k = 21 with the packed key's int64 sample id: 2.08 GB
// at phase 14's 99,009,246 solid rows, 0.62 ms); it takes 1.6 ms there
// (chip_smoke.py phase 15b).
//
// Plain C interface for ctypes. Nothing here allocates or synchronises:
// the caller passes the outputs, segment_stats' scratch and the stream;
// each entry point returns the first cudaError_t of its memsets, queries
// and launches.

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

// segment_stats' pass 1: the flags, and each tile's first boundary
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

// ---- run_counts: one pass -------------------------------------------

// rows i, i + 32, ..., i + 32 (kRowsPerThread - 1) of a column; 0 past E
template <typename T>
__device__ __forceinline__ void load_steps(const void* c, int64_t i,
                                           int64_t E,
                                           int64_t (&v)[kRowsPerThread]) {
  const T* p = static_cast<const T*>(c);
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
    v[j] = i + 32 * j < E ? (int64_t)__ldg(p + i + 32 * j) : 0;
}

// whether row x's key differs from row `ref`'s (x >= E: a boundary)
__device__ __forceinline__ bool differs(const Cols& c, int64_t x,
                                        int64_t ref, int64_t E) {
  if (x >= E) return true;
  bool d = false;
  for (int j = 0; j < c.n; ++j)
    d |= load(c.p[j], c.size[j], x) != load(c.p[j], c.size[j], ref);
  return d;
}

// A whole warp: the end of the run holding row from - 1, the first row
// x >= from whose key differs from row from - 1's, else E. Equality
// only: the rows are grouped (equal rows contiguous), not necessarily
// ascending (SimkaMin sorts its int64 hashes in unsigned order), so
// inside the run every key equals from - 1's and past it none does.
// The 32 rows from `from`, then probes 32 << l rows on, l = 0..31, then
// a 32-ary search between the last equal and the first differing probe:
// O(log run) reads, mostly from L2, and one round for a run that ends
// within 32 rows of the tile.
__device__ int64_t run_end(const Cols& c, int64_t from, int64_t E) {
  const int lane = threadIdx.x % 32;
  const int64_t ref = from - 1;
  unsigned m = __ballot_sync(0xffffffffu, differs(c, from + lane, ref, E));
  if (m) return from + __ffs(m) - 1;
  int64_t lo = from + 31, hi;  // lo: a row of the run; hi: past it
  for (;;) {
    m = __ballot_sync(0xffffffffu,
                      differs(c, lo + ((int64_t)32 << lane), ref, E));
    if (m) {
      const int l = __ffs(m) - 1;
      hi = lo + ((int64_t)32 << l);
      if (l) lo += (int64_t)32 << (l - 1);
      break;
    }
    lo += (int64_t)32 << 31;
  }
  while (hi - lo > 1) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t x = lo + (int64_t)(lane + 1) * step;
    m = __ballot_sync(0xffffffffu, x >= hi || differs(c, x, ref, E));
    const int l = __ffs(m) - 1;  // lane 31's probe is at or past hi
    const int64_t x_l = lo + (int64_t)(l + 1) * step;
    hi = x_l < hi ? x_l : hi;
    lo += (int64_t)l * step;
  }
  return hi;
}

// run_counts over tiles blockIdx.x, + gridDim.x, ...: warp w takes the
// tile's rows [512 w, 512 w + 512), lane l the rows 32 j + l of them at
// step j = 0..15, so every load and store of a step is one coalesced
// row of the warp. Three CTAs an SM, so that ptxas keeps a thread's 16
// rows and 16 ballots in registers (under the default bound it capped
// them at 64 and spilled)
__global__ void __launch_bounds__(kThreads, 3)
run_counts(Cols cols, int64_t E, int64_t n_tiles, int64_t amin, int64_t amax,
           int32_t* __restrict__ count, uint8_t* __restrict__ keep,
           unsigned long long* __restrict__ total) {
  constexpr int kSteps = kRowsPerThread;
  constexpr int kWarpRows = 32 * kSteps;
  constexpr int kNone = kTile;  // no boundary (tile-local rows)
  __shared__ int s_warp[kWarps];
  __shared__ unsigned long long s_kept[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned above = ~((2u << lane) - 1);  // the lanes after this one
  unsigned long long kept = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t tile0 = tile * kTile;
    const int64_t w0 = tile0 + kWarpRows * warp;  // the warp's first row
    // f bit j: row w0 + 32 j + lane is a run's first row, or past E
    uint32_t f = 0;
    for (int c = 0; c < cols.n; ++c) {
      const void* p = cols.p[c];
      const int size = cols.size[c];
      int64_t v[kSteps];
      if (size == 8)
        load_steps<long long>(p, w0 + lane, E, v);
      else
        load_steps<int>(p, w0 + lane, E, v);
      // row i - 1: the previous lane's at this step, lane 31's at the
      // step before, the previous warp's last row at step 0
      int64_t last = lane == 0 && w0 > 0 && w0 <= E ? load(p, size, w0 - 1)
                                                     : 0;
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        int64_t prev = __shfl_up_sync(0xffffffffu, v[j], 1);
        if (lane == 0) prev = last;
        last = __shfl_sync(0xffffffffu, v[j], 31);
        f |= (uint32_t)(v[j] != prev) << j;
      }
    }
    unsigned ballot[kSteps];
    int first = kNone;  // the warp's first boundary (tile-local)
#pragma unroll
    for (int j = kSteps - 1; j >= 0; --j) {
      const int64_t i = w0 + 32 * j + lane;
      if (i >= E || i == 0) f |= 1u << j;
      ballot[j] = __ballot_sync(0xffffffffu, (f >> j) & 1);
      if (ballot[j])
        first = kWarpRows * warp + 32 * j + __ffs(ballot[j]) - 1;
    }
    __syncthreads();  // the last tile's s_warp is read
    if (lane == 0) s_warp[warp] = first;
    __syncthreads();
    int later = kNone;  // the later warps' first boundary
    for (int w = warp + 1; w < kWarps; ++w)
      later = s_warp[w] < later ? s_warp[w] : later;
    // The warp holding the tile's last boundary finds where that run
    // ends, past the tile; a tile inside one long run has no boundary
    // and no search.
    int64_t after = tile0 + later;
    if (later == kNone && first != kNone)
      after = run_end(cols, tile0 + kTile, E);
    // each step's next boundary: in the step's ballot after this lane,
    // else the warp's first at a later step, else `after`
    int next = kNone;
    unsigned kb = 0;
#pragma unroll
    for (int j = kSteps - 1; j >= 0; --j) {
      const int64_t i = w0 + 32 * j + lane;
      const unsigned m = ballot[j] & above;
      const int64_t nxt =
          m ? w0 + 32 * j + __ffs(m) - 1
            : next != kNone ? tile0 + next : after;
      const bool is_first = (f >> j) & 1 && i < E;
      const int32_t cnt = is_first ? (int32_t)(nxt - i) : 0;
      const bool k = is_first && (int64_t)cnt >= amin &&
                     (int64_t)cnt <= amax;
      kb |= (unsigned)k << j;
      if (i < E) {
        count[i] = cnt;
        keep[i] = k;
      }
      if (ballot[j])
        next = kWarpRows * warp + 32 * j + __ffs(ballot[j]) - 1;
    }
    kept += __popc(kb);
  }
  for (int o = 16; o > 0; o >>= 1)
    kept += __shfl_down_sync(0xffffffffu, kept, o);
  if (lane == 0) s_kept[warp] = kept;
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
// uint64 [1], zeroed here. E >= 1. Returns a cudaError_t code (0 on
// success).
int simka_run_counts(const void* const* cols, const int* sizes, int n_cols,
                     int64_t E, int64_t amin, int64_t amax, int32_t* count,
                     uint8_t* keep, uint64_t* total, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Cols c;
  if (E < 1 || !make_cols(cols, sizes, n_cols, c))
    return (int)cudaErrorInvalidValue;
  // the persistent grid, one full wave: asked once a device
  static int grid_dev = -1, grid_size = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != grid_dev) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, run_counts,
                                                          kThreads, 0);
    if (err == cudaSuccess) {
      grid_dev = dev;
      grid_size = sms * (per_sm > 0 ? per_sm : 1);
    }
  }
  if (err == cudaSuccess)
    err = cudaMemsetAsync(total, 0, sizeof(uint64_t), stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = n_tiles_of(E);
  const int64_t blocks = grid_size < tiles ? grid_size : tiles;
  run_counts<<<(unsigned)blocks, kThreads, 0, stream>>>(
      c, E, tiles, amin, amax, count, keep,
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
