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
//                 three index_add_, _first_of_run, nonzero and two syncs,
//                 and the compaction of the segment starts. Over solid
//                 rows in (k-mer, sample) order: per bank s, distinct[s]
//                 = rows, solid[s] = sum count, chord[s] = sum count^2
//                 (int64); starts[j] = the first row of the j-th k-mer
//                 (the word columns alone), starts[nb_distinct] = E;
//                 scalars = (nb_distinct, nb_shared: segments of >= 2
//                 rows, d_max: the longest segment, max_count).
//
// Both are one launch over tiles of 4096 rows, and a run's length is
// the next boundary after its first row, minus that row. Warp w takes
// the tile's rows [512 w, 512 w + 512) in 16 steps of 32: lane l loads
// row 32 j + l of every key column (each step one coalesced 256-B row
// of the warp), compares it with row 32 j + l - 1 (the previous lane's
// by a shuffle; lane 31's of the step before; the previous warp's last
// row read once), and keeps its 16 boundary bits in a register. A
// ballot a step gives the warp every boundary of its 512 rows: a row's
// next boundary is the first set bit after its lane in its step's
// ballot, else the warp's first at a later step, else the later warps'
// first (one shared entry a warp), else past the tile. There, the warp
// holding the tile's last boundary finds where that run ends (run_end):
// the 32 rows after the tile, then probes 32 << l rows on and a 32-ary
// search, testing only equality with the run's key (the rows are
// grouped, not necessarily ascending). A tile inside one long run has
// no boundary and searches nothing, so a run of any length costs
// O(log run) reads, made once. No flags array.
//
// run_counts is a persistent grid, tiles blockIdx.x, + gridDim.x, ...:
// count (int32) and keep go out a step at a time, coalesced, straight
// from registers; the kept total is one atomic a CTA. No scratch.
//
// segment_stats is a persistent grid whose CTAs claim tiles in order
// from a ticket counter, so that every tile a CTA waits on is held by a
// CTA already running (a strided grid can deadlock here: a tile's
// earlier tiles may sit on a CTA that is not resident). A tile:
//   1. its boundaries, from the word columns, as above; each warp's
//      count (the popcounts of its ballots) and first boundary go to
//      shared memory, so each warp has its exclusive offset in the tile;
//      the tile's count goes out at once in a 64-bit status word, flag and value together (csrc/compact.cu's
//      decoupled look-back);
//   2. the lengths give d_max, nb_shared and nb_distinct; each row adds
//      (1, count, count^2) into per-bank bins, the sample ids and counts
//      of eight steps in flight at a time (the ids held as int, the
//      counts in their column's type: wider, or more steps, spilled):
//      in shared memory, one flush of integer atomics a CTA, when 3 x 8
//      x N bytes fit in kBinBytes, else straight into the outputs with
//      device-memory atomics. Every sum is an integer sum: exact, the
//      same on every run;
//   3. warp 0 looks back for the tile's exclusive prefix last, after its
//      own bins: by then the tiles before it have mostly published
//      theirs, so one window of 32 status words usually ends the walk
//      (looking back first, while they had not, measured slower);
//   4. each boundary row i goes to starts[prefix + its rank], a step of
//      a warp at a time (the rank: the warp's offset, the boundaries of
//      its earlier steps and the set bits below the lane), so the slots
//      of a step are contiguous; the tile holding the last row writes
//      starts[nb_distinct] = E.
// Its only scratch is the ticket and a status word a tile.
//
// What bounds them: device-memory bandwidth. run_counts reads the key
// columns once and writes 4 + 1 B a row: at phase 7's sorted packed key
// (313,342,848 int64 rows) 2.51 GB in, 1.57 GB out, 1.22 ms at 3.35
// TB/s; it takes 1.46 ms there on the device (NVIDIA H100 80GB HBM3,
// 700.00 W, PERF.md section 6). segment_stats reads the word
// columns, the sample id and the count once and writes 8 B a segment
// (20 B a row at k = 21 with the packed key's int64 sample id and the
// int32 count): at phase 14's 99,009,246 solid rows and 3,999,316
// segments 2.01 GB, 0.6007 ms; at phase 7's 77,329,304 rows and
// 35,190,577 segments 1.83 GB, 0.5457 ms (chip_smoke.py phase 15b
// times it; PERF.md section 6 has the times).
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
constexpr int kSteps = 16;  // a lane's rows in a tile, 32 apart
constexpr int kGroup = 8;  // steps of sample ids and counts in flight
constexpr int kWarpRows = 32 * kSteps;
constexpr int kTile = kThreads * kSteps;  // 4096 rows
constexpr int kNoRow = kTile;  // no boundary (tile-local rows)
constexpr int kMaxCols = 8;
constexpr int kBinBytes = 40 * 1024;  // shared per-bank bins, at most

constexpr uint64_t kFlagA = 1ull << 62;  // tile count published
constexpr uint64_t kFlagP = 2ull << 62;  // inclusive prefix published
constexpr uint64_t kCountMask = (1ull << 62) - 1;

struct Cols {
  const void* p[kMaxCols];
  int size[kMaxCols];  // 4 or 8 bytes
  int n;
};

__device__ __forceinline__ int64_t load(const void* p, int size, int64_t i) {
  return size == 8 ? __ldg(static_cast<const long long*>(p) + i)
                   : (int64_t)__ldg(static_cast<const int*>(p) + i);
}

// The status word carries its flag and its count together, so it needs
// no ordering against any other access: relaxed stores and loads at gpu
// scope (as csrc/compact.cu).
__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// rows i, i + 32, ..., i + 32 (K - 1) of a column; 0 past E
template <typename T, int K>
__device__ __forceinline__ void load_steps(const void* c, int64_t i,
                                           int64_t E, int64_t (&v)[K]) {
  const T* p = static_cast<const T*>(c);
#pragma unroll
  for (int j = 0; j < K; ++j)
    v[j] = i + 32 * j < E ? (int64_t)__ldg(p + i + 32 * j) : 0;
}

// the same, of a column of `size` (4 or 8) bytes
template <int K>
__device__ __forceinline__ void load_steps(const void* c, int size,
                                           int64_t i, int64_t E,
                                           int64_t (&v)[K]) {
  if (size == 8)
    load_steps<long long>(c, i, E, v);
  else
    load_steps<int>(c, i, E, v);
}

// The lanes of a step whose row, row0 + lane, is below E.
__device__ __forceinline__ unsigned lanes_below_end(int64_t row0,
                                                    int64_t E) {
  const int64_t r = E - row0;
  return r >= 32 ? 0xffffffffu : r > 0 ? (1u << r) - 1 : 0u;
}

// A whole warp, over its rows w0 + 32 j + lane (j < kSteps) of a tile:
// ballot[j] holds the lanes whose row starts a run (row 0, or some key
// column differs from the row before) or lies past E. Returns the
// warp's first such row, tile-local (w0 = tile0 + kWarpRows * warp), or
// kNoRow.
__device__ __forceinline__ int warp_boundaries(const Cols& cols, int64_t w0,
                                               int64_t E, int warp,
                                               unsigned (&ballot)[kSteps]) {
  const int lane = threadIdx.x % 32;
  // f bit j: row w0 + 32 j + lane is a run's first row, or past E
  uint32_t f = 0;
  for (int c = 0; c < cols.n; ++c) {
    const void* p = cols.p[c];
    const int size = cols.size[c];
    int64_t v[kSteps];
    load_steps(p, size, w0 + lane, E, v);
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
  int first = kNoRow;
#pragma unroll
  for (int j = kSteps - 1; j >= 0; --j) {
    const int64_t i = w0 + 32 * j + lane;
    if (i >= E || i == 0) f |= 1u << j;
    ballot[j] = __ballot_sync(0xffffffffu, (f >> j) & 1);
    if (ballot[j]) first = kWarpRows * warp + 32 * j + __ffs(ballot[j]) - 1;
  }
  return first;
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

// The row past the run of the warp's last boundary when no later warp
// of the tile holds one: a later warp's first boundary (`later`, tile
// local) or, for the warp holding the tile's last boundary, run_end
// past the tile. A whole warp; `first` is the warp's first boundary.
__device__ __forceinline__ int64_t after_warp(const Cols& cols, int64_t tile0,
                                              int first, int later,
                                              int64_t E) {
  if (later == kNoRow && first != kNoRow)
    return run_end(cols, tile0 + kTile, E);
  return tile0 + later;
}

// run_counts over tiles blockIdx.x, + gridDim.x, ...: warp w takes the
// tile's rows [512 w, 512 w + 512), lane l the rows 32 j + l of them at
// step j = 0..15, so every load and store of a step is one coalesced
// row of the warp. Three CTAs an SM, so that ptxas keeps a thread's 16
// rows and 16 ballots in registers (under the default bound it capped
// them at 64 and spilled)
__global__ void __launch_bounds__(kThreads, 3)
run_counts(const __grid_constant__ Cols cols, int64_t E, int64_t n_tiles,
           int64_t amin, int64_t amax, int32_t* __restrict__ count,
           uint8_t* __restrict__ keep, unsigned long long* __restrict__ total) {
  __shared__ int s_warp[kWarps];
  __shared__ unsigned long long s_kept[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned above = ~((2u << lane) - 1);  // the lanes after this one
  unsigned long long kept = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t tile0 = tile * kTile;
    const int64_t w0 = tile0 + kWarpRows * warp;  // the warp's first row
    unsigned ballot[kSteps];
    const int first = warp_boundaries(cols, w0, E, warp, ballot);
    __syncthreads();  // the last tile's s_warp is read
    if (lane == 0) s_warp[warp] = first;
    __syncthreads();
    int later = kNoRow;  // the later warps' first boundary
    for (int w = warp + 1; w < kWarps; ++w)
      later = s_warp[w] < later ? s_warp[w] : later;
    const int64_t after = after_warp(cols, tile0, first, later, E);
    // each step's next boundary: in the step's ballot after this lane,
    // else the warp's first at a later step, else `after`
    int next = kNoRow;
    unsigned kb = 0;
#pragma unroll
    for (int j = kSteps - 1; j >= 0; --j) {
      const int64_t i = w0 + 32 * j + lane;
      const unsigned m = ballot[j] & above;
      const int64_t nxt =
          m ? w0 + 32 * j + __ffs(m) - 1
            : next != kNoRow ? tile0 + next : after;
      const bool is_first = (ballot[j] >> lane) & 1 && i < E;
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

// Warp 0: the count of boundaries before tile `tile` (tile > 0), by
// decoupled look-back over windows of 32 predecessors' status words,
// lane 31 the nearest; then publishes the tile's inclusive prefix.
__device__ __forceinline__ int64_t look_back(uint64_t* status, int64_t tile,
                                             int64_t tile_count) {
  const int lane = threadIdx.x % 32;
  int64_t prefix = 0;
  for (int64_t end = tile;; end -= 32) {
    const int64_t p = end - 32 + lane;
    uint64_t v = kFlagP;  // before tile 0: a prefix of 0
    if (p >= 0) {
      do {
        v = ld_relaxed(&status[p]);
      } while ((v & ~kCountMask) == 0);
    }
    const unsigned pm = __ballot_sync(0xffffffffu, (v & kFlagP) != 0);
    const int hi = pm ? 31 - __clz((int)pm) : 0;
    int64_t c = lane >= hi ? (int64_t)(v & kCountMask) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      c += __shfl_xor_sync(0xffffffffu, c, o);
    prefix += c;
    if (pm) break;
  }
  if (lane == 0)
    st_relaxed(&status[tile], kFlagP | (uint64_t)(prefix + tile_count));
  return prefix;
}

// segment_stats: tiles claimed in order from scratch[0]; status words
// scratch[1 + tile].
// C: the count column's type (int or long long); the sample ids, below
// N < 2^31, are held as int whatever their column's width.
// scalars: (nb_distinct, nb_shared, d_max, max_count)
template <typename C>
__global__ void __launch_bounds__(kThreads, 3)
segment_stats(const __grid_constant__ Cols words, int64_t E, int64_t n_tiles,
              const void* __restrict__ sid, int sid_size,
              const C* __restrict__ cnt, int64_t N, int shared_bins,
              unsigned long long* __restrict__ bins,
              unsigned long long* __restrict__ scalars,
              int64_t* __restrict__ starts,
              unsigned long long* __restrict__ scratch) {
  extern __shared__ unsigned long long s_bins[];  // [3, N] when shared
  __shared__ int s_first[kWarps], s_count[kWarps];
  __shared__ long long s_tile, s_prefix;
  __shared__ unsigned long long s_red[4][kWarps];
  uint64_t* status = reinterpret_cast<uint64_t*>(scratch) + 1;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned above = ~((2u << lane) - 1);  // the lanes after this one
  const unsigned below = (1u << lane) - 1;     // the lanes before it
  unsigned long long* out = shared_bins ? s_bins : bins;
  if (shared_bins)
    for (int64_t j = threadIdx.x; j < 3 * N; j += kThreads) s_bins[j] = 0;
  unsigned long long n_first = 0, n_shared = 0;
  long long d_max = 0, c_max = 0;
  for (;;) {
    // every read of the last tile's shared entries came before the
    // __syncthreads that precedes its starts
    if (threadIdx.x == 0) s_tile = (long long)atomicAdd(scratch, 1ull);
    __syncthreads();
    const int64_t tile = s_tile;
    if (tile >= n_tiles) break;
    const int64_t tile0 = tile * kTile;
    const int64_t w0 = tile0 + kWarpRows * warp;  // the warp's first row
    unsigned ballot[kSteps];
    const int first = warp_boundaries(words, w0, E, warp, ballot);
    int count = 0;  // the warp's boundaries (rows below E)
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      count += __popc(ballot[j] & lanes_below_end(w0 + 32 * j, E));
    if (lane == 0) {
      s_first[warp] = first;
      s_count[warp] = count;
    }
    __syncthreads();
    int later = kNoRow, offset = 0, tile_count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w > warp) later = s_first[w] < later ? s_first[w] : later;
      offset += w < warp ? s_count[w] : 0;
      tile_count += s_count[w];
    }
    // the tile's count goes out at once (tile 0: its inclusive prefix)
    if (threadIdx.x == 0)
      st_relaxed(&status[tile],
                 (tile == 0 ? kFlagP : kFlagA) | (uint64_t)tile_count);
    // lengths, at each boundary row below E
    const int64_t after = after_warp(words, tile0, first, later, E);
    int next = kNoRow;
#pragma unroll
    for (int j = kSteps - 1; j >= 0; --j) {
      const int64_t i = w0 + 32 * j + lane;
      const unsigned m = ballot[j] & above;
      const int64_t nxt =
          m ? w0 + 32 * j + __ffs(m) - 1
            : next != kNoRow ? tile0 + next : after;
      if ((ballot[j] >> lane) & 1 && i < E) {
        const int64_t len = nxt - i;
        n_first += 1;
        n_shared += len >= 2;
        d_max = len > d_max ? len : d_max;
      }
      if (ballot[j])
        next = kWarpRows * warp + 32 * j + __ffs(ballot[j]) - 1;
    }
    // per-bank bins, kGroup coalesced steps of the warp at a time
#pragma unroll 1
    for (int g = 0; g < kSteps; g += kGroup) {
      const int64_t i0 = w0 + lane + 32 * g;
      int64_t s64[kGroup];
      load_steps(sid, sid_size, i0, E, s64);
      int sv[kGroup];
      C cv[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        sv[j] = (int)s64[j];
        cv[j] = i0 + 32 * j < E ? __ldg(cnt + i0 + 32 * j) : 0;
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (i0 + 32 * j >= E) break;
        const long long c = cv[j];
        c_max = c > c_max ? c : c_max;
        atomicAdd(&out[sv[j]], 1ULL);
        atomicAdd(&out[N + sv[j]], (unsigned long long)c);
        atomicAdd(&out[2 * N + sv[j]], (unsigned long long)(c * c));
      }
    }
    // warp 0 looks back last: by now the tiles before this one have
    // mostly published their prefixes
    if (warp == 0) {
      const int64_t prefix =
          tile == 0 ? 0 : look_back(status, tile, tile_count);
      if (lane == 0) {
        s_prefix = prefix;
        if (tile == n_tiles - 1) starts[prefix + tile_count] = E;
      }
    }
    __syncthreads();  // s_prefix
    int64_t slot = s_prefix + offset;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const unsigned b = ballot[j] & lanes_below_end(w0 + 32 * j, E);
      if ((b >> lane) & 1)
        starts[slot + __popc(b & below)] = w0 + 32 * j + lane;
      slot += __popc(b);
    }
  }
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

// CTAs of `kernel` that one wave of the current device holds with `smem`
// dynamic shared bytes each
template <typename K>
cudaError_t one_wave(K kernel, size_t smem, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  blocks = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

}  // namespace

extern "C" {

// rows a tile; segment_stats' scratch needs one int64 a tile and one
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
  int grid = 0;
  cudaError_t err = one_wave(run_counts, 0, grid);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(total, 0, sizeof(uint64_t), stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = n_tiles_of(E);
  const int64_t blocks = grid < tiles ? grid : tiles;
  run_counts<<<(unsigned)blocks, kThreads, 0, stream>>>(
      c, E, tiles, amin, amax, count, keep,
      reinterpret_cast<unsigned long long*>(total));
  return (int)cudaGetLastError();
}

// words: n_words (1..5) pointers to [E] int64 word columns, rows in
// (k-mer, sample) order; sid: [E] int32 or int64 in [0, N) (sid_size 4
// or 8); cnt: [E] int32 or int64 (cnt_size); bins: int64 [3, N]
// (distinct, solid, chord n^2 a bank); scalars: int64 [4] (nb_distinct,
// nb_shared, d_max, max_count), both zeroed here; starts: int64 [E + 1]
// (starts[j] the first row of the j-th k-mer, starts[nb_distinct] = E,
// the rest not written); scratch: uint64 [ceil(E / 4096) + 1], zeroed
// here. E >= 1.
// Returns a cudaError_t code (0 on success).
int simka_segment_stats(const void* const* words, int n_words, int64_t E,
                        const void* sid, int sid_size, const void* cnt,
                        int cnt_size, int64_t N, uint64_t* bins,
                        uint64_t* scalars, int64_t* starts, uint64_t* scratch,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Cols c;
  int sizes[kMaxCols];
  for (int j = 0; j < kMaxCols; ++j) sizes[j] = 8;
  if (E < 1 || N < 1 || N > INT32_MAX || !starts ||
      !make_cols(words, sizes, n_words, c) ||
      (sid_size != 4 && sid_size != 8) || (cnt_size != 4 && cnt_size != 8))
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = n_tiles_of(E);
  const int shared_bins = 3 * N * 8 <= kBinBytes ? 1 : 0;
  const size_t smem = shared_bins ? (size_t)(3 * N * 8) : 0;
  int grid = 0;
  cudaError_t err = cnt_size == 8 ? one_wave(segment_stats<long long>, smem,
                                             grid)
                                  : one_wave(segment_stats<int>, smem, grid);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(bins, 0, 3 * N * sizeof(uint64_t), stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scalars, 0, 4 * sizeof(uint64_t), stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, (tiles + 1) * sizeof(uint64_t), stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(grid < tiles ? grid : tiles);
  auto* b = reinterpret_cast<unsigned long long*>(bins);
  auto* sc = reinterpret_cast<unsigned long long*>(scalars);
  auto* t = reinterpret_cast<unsigned long long*>(scratch);
  if (cnt_size == 8)
    segment_stats<<<blocks, kThreads, smem, stream>>>(
        c, E, tiles, sid, sid_size, static_cast<const long long*>(cnt), N,
        shared_bins, b, sc, starts, t);
  else
    segment_stats<<<blocks, kThreads, smem, stream>>>(
        c, E, tiles, sid, sid_size, static_cast<const int*>(cnt), N,
        shared_bins, b, sc, starts, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
