// SimkaMin's sketch-pair tallies (Hopper, sm_90a).
//
// Replaces the XLA program simka_tpu/minhash/device_distance.py::
// _pair_kernel with _bitonic_merge (:31-166; not Pallas). The reference
// walk (SimkaMinDistance.hpp:215-258) merges two ascending hash lists
// and stops after min(lA, lB) union elements or when a list runs out.
// Its result is the union-rank rule of device_distance.py's docstring:
//
//   t_exh     = min(A[lA - 1], B[lB - 1]), compared unsigned;
//   processed = min(min(lA, lB), rank(t_exh)),
//     rank(t) = #A<=t + #B<=t - #shared<=t;
//   an element x at index i of its own list X (other list Y) has union
//     rank i + 1 + #(Y < x) - #(shared elements of X before index i),
//   which holds on both sides and gives a shared element the same rank
//   on each; it is processed when its rank <= processed.
//
// Per pair the kernel stores four int64 tallies: processed (distinct),
// shared_distinct, nb_kmers (the counts of processed elements of both
// lists) and shared_kmers (min(cA, cB) over processed shared elements,
// counted on the A side). The caller turns them into Jaccard and
// Bray-Curtis once, so the kernel and its plain torch version
// (minhash/device_distance.py::pair_tallies_plain) agree bit for bit by
// construction. Integers only: the output is deterministic.
//
// Design: one CTA of 256 threads per pair on exact-length inputs (each
// sample's hashes and counts are rows [off, off + len) of one stream),
// two passes over chunks of 1,024 elements (4 consecutive a thread):
//   1. #A<=t and #B<=t by binary search (every thread, broadcast loads);
//      then the CTA walks A[0, #A<=t) counting the elements found in B.
//   2. The CTA walks A, then B, with a carried count of shared elements:
//      a warp scan of the threads' shared counts and the warps' totals
//      give each element its exclusive count. The walk stops after the
//      first chunk that holds an element ranked past `processed` (ranks
//      rise along a list).
// Each chunk stages its 1,024 elements of X and a window of the next
// 2,048 elements of Y, from where the previous chunk's last element fell
// in Y, in shared memory with coalesced loads; every element's search
// is then a binary search in shared memory. An element past the window
// (Y more than twice as dense there) searches the rest of Y in device
// memory. A first design searched device memory for every element and
// for two window bounds a chunk of 256 in sequence: on an H100 (700 W)
// 682.6 ms at N=100, 75.0 ms at min pipeline's 28 pairs of 1,000,000,
// slower there than its plain version (39.9 ms).
//
// What bounds it: device-memory bandwidth. Each pair reads each hash
// (8 B) and count (4 B) of both lists once: P x (lA + lB) x 12 B, at
// N=100 and s=1,000,000 (4,950 pairs) 119 GB, 35.5 ms at 3.35 TB/s.
// This design reads A's hashes twice and stages each Y element in about
// two windows (the repeats mostly from L2). One CTA a pair leaves most
// SMs idle at a few samples (28 pairs at N=8). A merge-path design (a
// diagonal split of the merged order across CTAs, one streaming pass)
// is the later redesign.
//
// Plain C interface for ctypes. Nothing here allocates or synchronises:
// the caller passes the output and the stream; the entry point returns
// the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                  // consecutive X elements a thread
constexpr int kChunk = kThreads * kPer;  // X elements a chunk
constexpr int kWindow = 2 * kChunk;      // Y elements staged a chunk
constexpr int64_t kMaxBlocks = 1 << 20;

template <class T>
__device__ __forceinline__ T mn(T a, T b) {
  return a < b ? a : b;
}

// first index in [lo, hi) with a[i] >= x (hi if none)
template <class I>
__device__ __forceinline__ I lower_bound(const uint64_t* a, I lo, I hi,
                                         uint64_t x) {
  while (lo < hi) {
    const I mid = lo + ((hi - lo) >> 1);
    if (a[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// first index in [lo, hi) with a[i] > x (hi if none)
__device__ __forceinline__ int64_t upper_bound(const uint64_t* __restrict__ a,
                                               int64_t lo, int64_t hi,
                                               uint64_t x) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (a[mid] <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct Shared {
  uint64_t x[kChunk];   // the chunk of X
  uint64_t y[kWindow];  // Y[base, base + kWindow)
  int64_t next_base;    // where the chunk's last element falls in Y
  int warp_shared[kWarps];
  unsigned long long red[3][kWarps];
};

// One thread's share of a chunk: its kPer elements of X, where each
// falls in Y (#(Y < x), an index of Y) and whether it is in Y.
struct Part {
  uint64_t x[kPer];
  int64_t l[kPer];
  bool sh[kPer];
  int n;  // its elements in the chunk (0..kPer)
};

// Stages X[c0, c0 + cn) and Y[base, base + kWindow) and searches the
// thread's elements; the thread holding the chunk's last element stores
// where it fell in sm.next_base. Ends after the staging barrier: the
// caller's next barrier protects shared memory and next_base.
__device__ __forceinline__ Part search_chunk(Shared& sm, const uint64_t* X,
                                             int64_t c0, int cn,
                                             const uint64_t* Y, int64_t ly,
                                             int64_t base) {
  const int wn = (int)mn<int64_t>(kWindow, ly - base);
  for (int e = threadIdx.x; e < cn; e += kThreads) sm.x[e] = X[c0 + e];
  for (int e = threadIdx.x; e < wn; e += kThreads) sm.y[e] = Y[base + e];
  __syncthreads();
  Part p;
  const int e0 = threadIdx.x * kPer;
  p.n = cn - e0 < 0 ? 0 : mn(cn - e0, kPer);
  int lo = 0;
  for (int r = 0; r < kPer; ++r) {
    p.sh[r] = false;
    p.l[r] = 0;
    if (r >= p.n) continue;
    const uint64_t x = sm.x[e0 + r];
    p.x[r] = x;
    lo = lower_bound<int>(sm.y, lo, wn, x);  // the thread's x ascend
    int64_t l = base + lo;
    bool sh;
    if (lo < wn) {
      sh = sm.y[lo] == x;
    } else {
      if (base + wn < ly) l = lower_bound<int64_t>(Y, base + wn, ly, x);
      sh = l < ly && Y[l] == x;
    }
    p.l[r] = l;
    p.sh[r] = sh;
    if (e0 + r == cn - 1) sm.next_base = l;
  }
  return p;
}

// Pass 2 over one list X against Y: adds the counts of X's processed
// elements to nb and, when `tally_shared`, the processed shared
// elements to sd and min(cX, cY) to sk.
__device__ void walk_ranked(Shared& sm, const uint64_t* X,
                            const uint32_t* CX, int64_t lx, const uint64_t* Y,
                            const uint32_t* CY, int64_t ly, int64_t processed,
                            bool tally_shared, unsigned long long& nb,
                            unsigned long long& sd, unsigned long long& sk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t carry = 0, base = 0;
  for (int64_t c0 = 0; c0 < lx; c0 += kChunk) {
    const int cn = (int)mn<int64_t>(kChunk, lx - c0);
    const Part p = search_chunk(sm, X, c0, cn, Y, ly, base);
    int cnt = 0;
    for (int r = 0; r < kPer; ++r) cnt += p.sh[r] ? 1 : 0;
    int v = cnt;  // inclusive scan of the threads' counts in the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) sm.warp_shared[warp] = v;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int s = sm.warp_shared[w];
      before += w < warp ? s : 0;
      total += s;
    }
    int64_t excl = carry + before + v - cnt;
    bool past = false;
    const int64_t k0 = c0 + threadIdx.x * kPer;
    for (int r = 0; r < p.n; ++r) {
      const int64_t rank = k0 + r + 1 + p.l[r] - excl;
      if (rank <= processed) {
        const uint32_t c = CX[k0 + r];
        nb += c;
        if (tally_shared && p.sh[r]) {
          sd += 1;
          sk += mn(c, CY[p.l[r]]);
        }
      } else {
        past = true;
      }
      excl += p.sh[r] ? 1 : 0;
    }
    carry += total;
    // every thread has read the staged chunk, the warp totals and, after
    // this barrier, can read next_base
    if (__syncthreads_or(past)) break;
    base = sm.next_base;
  }
}

__device__ __forceinline__ unsigned long long block_sum(
    Shared& sm, int slot, unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) sm.red[slot][threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long s = 0;
  for (int w = 0; w < kWarps; ++w) s += sm.red[slot][w];
  return s;
}

__global__ void __launch_bounds__(kThreads)
min_pair_tallies(const uint64_t* __restrict__ h1,
                 const uint32_t* __restrict__ c1,
                 const int64_t* __restrict__ off1,
                 const int64_t* __restrict__ len1,
                 const uint64_t* __restrict__ h2,
                 const uint32_t* __restrict__ c2,
                 const int64_t* __restrict__ off2,
                 const int64_t* __restrict__ len2,
                 const int32_t* __restrict__ ii,
                 const int32_t* __restrict__ jj, int64_t P,
                 int64_t* __restrict__ out) {
  __shared__ Shared sm;
  for (int64_t p = blockIdx.x; p < P; p += gridDim.x) {
    const int64_t i = ii[p], j = jj[p];
    const int64_t la = len1[i], lb = len2[j];
    int64_t* o = out + 4 * p;
    if (la == 0 || lb == 0) {
      if (threadIdx.x < 4) o[threadIdx.x] = 0;
      continue;
    }
    const uint64_t* A = h1 + off1[i];
    const uint32_t* CA = c1 + off1[i];
    const uint64_t* B = h2 + off2[j];
    const uint32_t* CB = c2 + off2[j];
    const uint64_t t = mn(A[la - 1], B[lb - 1]);
    const int64_t na = upper_bound(A, 0, la, t);
    const int64_t nbt = upper_bound(B, 0, lb, t);
    // pass 1: #shared <= t, over A[0, na)
    unsigned long long ns = 0;
    int64_t base = 0;
    for (int64_t c0 = 0; c0 < na; c0 += kChunk) {
      const int cn = (int)mn<int64_t>(kChunk, na - c0);
      const Part q = search_chunk(sm, A, c0, cn, B, lb, base);
      for (int r = 0; r < kPer; ++r) ns += q.sh[r] ? 1 : 0;
      __syncthreads();  // the chunk is read; next_base is written
      base = sm.next_base;
    }
    ns = block_sum(sm, 0, ns);
    const int64_t processed = mn(mn(la, lb), na + nbt - (int64_t)ns);
    // pass 2: the processed elements of A (with the shared tallies),
    // then of B
    unsigned long long nb = 0, sd = 0, sk = 0;
    walk_ranked(sm, A, CA, la, B, CB, lb, processed, true, nb, sd, sk);
    walk_ranked(sm, B, CB, lb, A, CA, la, processed, false, nb, sd, sk);
    nb = block_sum(sm, 0, nb);
    sd = block_sum(sm, 1, sd);
    sk = block_sum(sm, 2, sk);
    if (threadIdx.x == 0) {
      o[0] = processed;
      o[1] = (int64_t)sd;
      o[2] = (int64_t)nb;
      o[3] = (int64_t)sk;
    }
    __syncthreads();  // sm.red is read before the next pair writes it
  }
}

}  // namespace

extern "C" {

// h1/h2: the two sides' hash streams (uint64 bits); c1/c2: their counts
// (uint32 bits); off1/len1, off2/len2: [n1], [n2] int64 rows of each
// sample in its stream; ii/jj: [P] int32 sample indices of each pair;
// out: [P, 4] int64 (processed, shared_distinct, nb_kmers,
// shared_kmers). Returns a cudaError_t code (0 on success).
int simka_min_pair_tallies(const uint64_t* h1, const uint32_t* c1,
                           const int64_t* off1, const int64_t* len1,
                           const uint64_t* h2, const uint32_t* c2,
                           const int64_t* off2, const int64_t* len2,
                           const int32_t* ii, const int32_t* jj, int64_t P,
                           int64_t* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (P < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = P < kMaxBlocks ? P : kMaxBlocks;
  min_pair_tallies<<<(unsigned)blocks, kThreads, 0, stream>>>(
      h1, c1, off1, len1, h2, c2, off2, len2, ii, jj, P, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
