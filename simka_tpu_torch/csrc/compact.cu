// Stable stream compaction of row columns on a kept mask (Hopper, sm_90a).
//
// Replaces the TPU kernel simka_tpu/ops/pallas_compact.py::_gapclose_call
// and the whole of simka_tpu/ops/compact.py::compact_rows around it
// (block-local stable sort on the 1-bit drop key + ordered gap-close
// copies). That design relied on a sequential grid: later blocks
// overwrote earlier blocks' fill tails in order. CUDA blocks run in no
// order, so each tile here writes its kept rows at exact global
// positions and, when asked, its own share of the fill.
//
// What bounds it: device-memory bandwidth. The least traffic is the
// mask (1 B a row), each kept row read once and each output row written
// once: at the k=21 join (int64 key + int32 count, E = 313 M rows, kept
// 0.37) 5.46 GB with the fill, 3.10 GB without it (1.63 / 0.92 ms at
// 3.35 TB/s). A random 37% mask touches nearly every 32-byte sector,
// so in practice every input row is read.
//
// One pass, one launch (after a memset that zeroes its scratch):
//   1. Tile order: each CTA takes its tile index from a global ticket
//      counter, so every tile it waits on has already started.
//   2. Mask: read once, 16 bytes a thread (uint4); a block scan of the
//      per-thread counts gives each row its in-tile rank.
//   3. Global prefix by decoupled look-back (Merrill and Garland,
//      "Single-pass Parallel Prefix Scan with Decoupled Look-back"): a
//      64-bit status word per tile, flag in the top two bits and the
//      count below. The tile publishes its count (flag A) as soon as its
//      scan is done; warp 0 then looks back over windows of 32
//      predecessors and publishes the inclusive prefix (flag P). The
//      word carries flag and count together, so stores and polls are
//      relaxed: release/acquire would hold them behind the tile's own
//      column loads, and measured slower.
//   4. Columns, one at a time: 16-byte loads when the tile is whole and
//      aligned (column 0's issued before the look-back, column j + 1's
//      while column j is stored); each kept element is written at its
//      in-tile rank into a shared staging buffer, so the tile's kept
//      rows become one contiguous run. Warps 1-7 stage column 0 while
//      warp 0 looks back.
//   5. Stores: the run goes to out[prefix, prefix + kept) as 16-byte
//      stores. A 16-byte store needs a 16-byte aligned address, so the
//      elements before the destination's first 16-byte boundary and
//      after its last are peeled into plain stores (the answer of the
//      DMA probe, csrc/probes.cu); each body store packs its elements
//      from the staged run.
//   6. Fill, only when asked: tile t owns the slots
//      [E - D_incl(t), E - D_excl(t)), D the prefix of dropped rows
//      (rows before the tile minus kept rows before it). The union over
//      tiles is exactly [n_kept, E): no global total is needed.
//   7. The last tile stores the kept total on the device; nothing syncs.
//
// Tile: 4096 rows, 256 threads, 16 rows a thread. Columns are staged
// one at a time, so the staging buffer is 4096 x 8 B = 32 KB whatever
// the layout (5 x i64 + 2 x i32 included). 80 registers a thread allow
// 3 CTAs an SM (shared memory would allow 6); 64 registers (4 CTAs)
// spill and measured slower.
//
// What holds it back (per-tile globaltimer stamps of an instrumented
// build, PERF.md section 6): the look-back.
// A tile must wait until every tile after the nearest published prefix
// has published its count, and counts arrive with the spread of the
// mask loads' latency under load.
//
// Plain C interface for ctypes. Nothing here allocates or synchronises:
// the caller passes the scratch buffer and the stream; the entry point
// returns the first cudaError_t of its memset and launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libsimka_kernels.so compact.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kMinBlocks = 3;  // CTAs an SM: 80 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 16;  // one uint4 of mask bytes a thread
constexpr int kTile = kThreads * kRowsPerThread;
constexpr int kMaxCols = 8;
constexpr int kVecRounds = kRowsPerThread / 2;  // uint4 a thread, i64

constexpr uint64_t kFlagA = 1ull << 62;  // tile count published
constexpr uint64_t kFlagP = 2ull << 62;  // inclusive prefix published
constexpr uint64_t kCountMask = (1ull << 62) - 1;

struct Cols {
  const void* in[kMaxCols];
  void* out[kMaxCols];
  int64_t fill[kMaxCols];
  int size[kMaxCols];  // 4 or 8 bytes
  int n;
};

// The status word carries its flag and its count together, so it needs
// no ordering against any other access: relaxed stores and loads at
// gpu scope. (Release/acquire would hold the publish and the polls
// behind the tile's column loads, which are in flight by then.)
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

struct Smem {
  uint32_t bits[kThreads];  // kept bits of thread i's rows
  int excl[kThreads];       // kept rows before thread i's rows
  int warp_tot[kWarps];
  int64_t prefix;           // kept rows before this tile
  int tile;
  alignas(16) unsigned char stage[kTile * 8];  // kept elements at rank
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// In-tile rank of row e when it is kept (-1 when dropped).
__device__ __forceinline__ int rank_of(const Smem& s, int e) {
  const uint32_t b = s.bits[e >> 4];
  const int bit = e & 15;
  if (!((b >> bit) & 1u)) return -1;
  return s.excl[e >> 4] + __popc(b & ((1u << bit) - 1u));
}

// Stage column j's kept rows of this tile at s.stage[rank]. vec: the
// rows came as uint4s in regs, round r of thread i holding vector
// r * kThreads + i.
template <typename T>
__device__ __forceinline__ void stage_col(Smem& s, const T* __restrict__ in,
                                          int rows, bool vec,
                                          const uint4 (&regs)[kVecRounds]) {
  constexpr int kPer = 16 / sizeof(T);
  T* st = reinterpret_cast<T*>(s.stage);
  if (vec) {
#pragma unroll
    for (int r = 0; r < kTile * (int)sizeof(T) / 16 / kThreads; ++r) {
      const T* v = reinterpret_cast<const T*>(&regs[r]);
      const int e0 = (r * kThreads + (int)threadIdx.x) * kPer;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int k = rank_of(s, e0 + q);
        if (k >= 0) st[k] = v[q];
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows; e += kThreads) {
      const int k = rank_of(s, e);
      if (k >= 0) st[k] = in[e];
    }
  }
}

// out[0, len) = src[0, len) (the staged run): 16-byte stores on the
// aligned body, packed from the run's elements, plain stores on the
// peeled ends; out sits mis elements past a 16-byte boundary.
template <typename T>
__device__ __forceinline__ void store_run(T* __restrict__ out, const T* src,
                                          int64_t len, int mis) {
  constexpr int kPer = 16 / sizeof(T);
  const int64_t head = mis == 0 ? 0 : (kPer - mis < len ? kPer - mis : len);
  const int64_t body = (len - head) / kPer;
  const int64_t tail0 = head + body * kPer;
  for (int64_t i = threadIdx.x; i < body; i += kThreads) {
    uint4 v;
    T* vp = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int q = 0; q < kPer; ++q) vp[q] = src[head + i * kPer + q];
    *reinterpret_cast<uint4*>(out + head + i * kPer) = v;
  }
  if ((int)threadIdx.x < head) out[threadIdx.x] = src[threadIdx.x];
  if (tail0 + (int)threadIdx.x < len)
    out[tail0 + threadIdx.x] = src[tail0 + threadIdx.x];
}

// out[lo, hi) = fill, 16-byte stores on the aligned body.
template <typename T>
__device__ __forceinline__ void fill_run(T* __restrict__ out, int64_t lo,
                                         int64_t hi, T fill) {
  constexpr int kPer = 16 / sizeof(T);
  if (hi <= lo) return;
  const int mis = (int)(lo % kPer);
  const int64_t len = hi - lo;
  const int64_t head = mis == 0 ? 0 : (kPer - mis < len ? kPer - mis : len);
  const int64_t body = (len - head) / kPer;
  const int64_t tail0 = head + body * kPer;
  T* o = out + lo;
  uint4 v;
  T* vp = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int q = 0; q < kPer; ++q) vp[q] = fill;
  for (int64_t i = threadIdx.x; i < body; i += kThreads)
    *reinterpret_cast<uint4*>(o + head + i * kPer) = v;
  if ((int)threadIdx.x < head) o[threadIdx.x] = fill;
  if (tail0 + (int)threadIdx.x < len) o[tail0 + threadIdx.x] = fill;
}

__device__ __forceinline__ bool col_vec(const Cols& c, int j, int64_t base,
                                        int rows) {
  return rows == kTile &&
         aligned16(static_cast<const char*>(c.in[j]) + base * c.size[j]);
}

__device__ __forceinline__ void load_col(const Cols& c, int j, int64_t base,
                                         int rows, uint4 (&regs)[kVecRounds]) {
  if (!col_vec(c, j, base, rows)) return;
  const uint4* in = reinterpret_cast<const uint4*>(
      static_cast<const char*>(c.in[j]) + base * c.size[j]);
  const int rounds = kTile * c.size[j] / 16 / kThreads;
#pragma unroll
  for (int r = 0; r < kVecRounds; ++r)
    if (r < rounds) regs[r] = __ldg(in + r * kThreads + threadIdx.x);
}

// scratch: [0] ticket counter, [1] kept total, [2, 2 + n_tiles) status;
// zeroed before the launch.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    compact_onepass(const uint8_t* __restrict__ kept, int64_t E,
                    const __grid_constant__ Cols cols, int64_t out_rows,
                    int write_fill, uint64_t* __restrict__ scratch) {
  __shared__ Smem s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint64_t* status = scratch + 2;

  // 1. tile order
  if (tid == 0)
    s.tile = (int)atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u);
  __syncthreads();
  const int64_t t = s.tile;
  const int64_t base = t * kTile;
  const int rows = (int)(E - base < kTile ? E - base : kTile);

  // 2. mask bits of this thread's rows, then the block scan
  uint32_t bits = 0;
  const int64_t r0 = base + (int64_t)tid * kRowsPerThread;
  if (r0 + kRowsPerThread <= E && aligned16(kept + r0)) {
    const uint4 m = *reinterpret_cast<const uint4*>(kept + r0);
    const uint32_t w[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q)
      bits |= (uint32_t)(((w[q >> 2] >> ((q & 3) * 8)) & 0xffu) != 0) << q;
  } else {
    for (int q = 0; q < kRowsPerThread && r0 + q < E; ++q)
      bits |= (uint32_t)(kept[r0 + q] != 0) << q;
  }
  const int cnt = __popc(bits);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s.warp_tot[warp] = incl;
  s.bits[tid] = bits;
  __syncthreads();
  int before = 0, kept_t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s.warp_tot[w] : 0;
    kept_t += s.warp_tot[w];
  }
  s.excl[tid] = before + incl - cnt;

  // 3. publish this tile's count (tile 0: its inclusive prefix) at once
  if (tid == 0) {
    st_relaxed(&status[t], (t == 0 ? kFlagP : kFlagA) | (uint64_t)kept_t);
  }
  __syncthreads();  // s.excl

  // column 0's loads go out, then warp 0 looks back for the prefix
  // while warps 1-7 stage their share of column 0
  uint4 regs[kVecRounds];
  load_col(cols, 0, base, rows, regs);
  if (warp == 0) {
    int64_t prefix = 0;
    if (t > 0) {
      int64_t end = t;  // window [end - 32, end), lane 31 nearest
      while (true) {
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
        end -= 32;
      }
      if (lane == 0) {
        st_relaxed(&status[t], kFlagP | (uint64_t)(prefix + kept_t));
      }
    }
    if (lane == 0) {
      s.prefix = prefix;
      if (base + rows == E) scratch[1] = (uint64_t)(prefix + kept_t);
    }
  }
  if (cols.size[0] == 8)
    stage_col(s, static_cast<const int64_t*>(cols.in[0]) + base, rows,
              col_vec(cols, 0, base, rows), regs);
  else
    stage_col(s, static_cast<const int32_t*>(cols.in[0]) + base, rows,
              col_vec(cols, 0, base, rows), regs);
  __syncthreads();
  const int64_t prefix = s.prefix;
  // rows this tile may store: a caller's n below the true count clips
  // the run rather than writing past the outputs
  const int64_t run = out_rows - prefix < kept_t
                          ? (out_rows - prefix > 0 ? out_rows - prefix : 0)
                          : kept_t;

  // 6. this tile's fill slots
  if (write_fill) {
    const int64_t d_excl = base - prefix;
    const int64_t d_incl = d_excl + (rows - kept_t);
    for (int j = 0; j < cols.n; ++j) {
      if (cols.size[j] == 8)
        fill_run(static_cast<int64_t*>(cols.out[j]), E - d_incl, E - d_excl,
                 (int64_t)cols.fill[j]);
      else
        fill_run(static_cast<int32_t*>(cols.out[j]), E - d_incl, E - d_excl,
                 (int32_t)cols.fill[j]);
    }
  }

  // 4-5. each column: store the staged run while the next column's
  // loads are in flight, then stage the next column
  for (int j = 0; j < cols.n; ++j) {
    if (j + 1 < cols.n) load_col(cols, j + 1, base, rows, regs);
    const int mis = (int)(prefix % (16 / cols.size[j]));  // outputs aligned
    if (cols.size[j] == 8)
      store_run(static_cast<int64_t*>(cols.out[j]) + prefix,
                reinterpret_cast<const int64_t*>(s.stage), run, mis);
    else
      store_run(static_cast<int32_t*>(cols.out[j]) + prefix,
                reinterpret_cast<const int32_t*>(s.stage), run, mis);
    __syncthreads();
    if (j + 1 < cols.n) {
      const bool vec = col_vec(cols, j + 1, base, rows);
      if (cols.size[j + 1] == 8)
        stage_col(s, static_cast<const int64_t*>(cols.in[j + 1]) + base,
                  rows, vec, regs);
      else
        stage_col(s, static_cast<const int32_t*>(cols.in[j + 1]) + base,
                  rows, vec, regs);
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

int64_t simka_compact_tile_rows() { return kTile; }

// kept: [E] bool (one byte each). ins: n_cols device pointers of [E]
// columns; outs: n_cols 16-byte aligned device pointers of [out_rows]
// columns: E with write_fill != 0, the caller's kept count without
// (rows past out_rows are not stored); sizes:
// element bytes (4 or 8); fills: per-column fill (low 32 bits for
// 4-byte columns). scratch: uint64 [n_tiles + 2], n_tiles =
// ceil(E / simka_compact_tile_rows()); scratch[1] ends up holding the
// kept count. Returns a cudaError_t code (0 on success).
int simka_compact_rows(const uint8_t* kept, int64_t E, int n_cols,
                       void* const* ins, void* const* outs,
                       const int* sizes, const int64_t* fills,
                       int64_t out_rows, int write_fill, uint64_t* scratch,
                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_cols < 1 || n_cols > kMaxCols || E < 1 || out_rows < 0 ||
      out_rows > E || (write_fill && out_rows != E))
    return (int)cudaErrorInvalidValue;
  Cols cols;
  cols.n = n_cols;
  for (int j = 0; j < kMaxCols; ++j) {
    const bool on = j < n_cols;
    cols.in[j] = on ? ins[j] : nullptr;
    cols.out[j] = on ? outs[j] : nullptr;
    cols.fill[j] = on ? fills[j] : 0;
    cols.size[j] = on ? sizes[j] : 4;
    if (on && ((sizes[j] != 4 && sizes[j] != 8) ||
               ((uintptr_t)outs[j] & 15) != 0))
      return (int)cudaErrorInvalidValue;
  }
  const int64_t n_tiles = (E + kTile - 1) / kTile;
  if (n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)(n_tiles + 2) * sizeof(uint64_t), stream);
  if (err != cudaSuccess) return (int)err;
  compact_onepass<<<(unsigned)n_tiles, kThreads, 0, stream>>>(
      kept, E, cols, out_rows, write_fill, scratch);
  return (int)cudaGetLastError();
}

}  // extern "C"
