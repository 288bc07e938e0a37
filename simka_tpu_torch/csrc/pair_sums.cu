// Pair sums of the exact join (Hopper, sm_90a): every co-present pair of
// one k-mer's solid rows, added into the [N * N] pair channels.
//
// Replaces the XLA program simka_tpu/ops/countjoin.py::_pair_accumulate
// (:1112, its per-shift fori_loop :1304) with _pairbin_pass (:1357; not
// Pallas), and on the card the port's own per-offset loop
// (ops/countjoin.py::_pair_sums_plain: for each offset d < d_max a
// compare of the whole row stream with itself shifted, a host sync, and
// one index_add_ a channel). The reference prunes singleton rows first
// (its Prejoin, countjoin.py:574); here a singleton costs one read of its
// segment length and no pair work, so nothing is pruned.
//
// Input: the solid rows in (k-mer, sample) order -- sid and count, int64
// -- cut into segments of one k-mer (starts, lengths: int64); K, the
// per-bank solid totals as f64. For every pair of rows i < j of one
// segment (a = sid[i] < b = sid[j], ca, cb their counts) the channels
// are, as the plain version computes them:
//   0 ab += ca      1 ba += cb      2 distinct += 1    3 bray += min
//   4 hellinger += floor(sqrt(double(ca cb)))          5 chord += ca cb
//   6 whittaker += |int32 wrap of (xY mod 2^32 - yX mod 2^32)|,
//     xY = ca Kb, yX = cb Ka in f64           7 s12 += |w32(xY)| + |w32(yX)|
//   8-12 the five fixed-point limbs of the Kullback-Leibler term
//     (ca / max(Ka, 1)) log(2 xY / (xY + yX)) + (cb / max(Kb, 1))
//     log(2 yX / (xY + yX)) (ops/countjoin.py::_kl_limbs).
// Outputs are the callers' flat [N * N] int64 channels at a N + b (a KL
// limb: element 5 (a N + b) + l of the [N * N, 5] limbs); the kernel
// adds into them, so shards, ranges and ranks fold as before. Every
// channel is an integer sum added with integer atomics: the result does
// not depend on the order, and is deterministic. The f64 steps use the
// _rn intrinsics, which the compiler never contracts into an FMA, so
// each rounds as torch's separate ops do; log is libdevice's, as
// torch.log's is on the card: kernel and plain version agree bit for bit.
//
// What bounds it. The rows are read once (16 B a row, 16 B a segment);
// the work is the pairs, sum L (L - 1) / 2 over the segments, each a few
// integer instructions and one 64-bit add a channel. At wide N the pairs
// dominate: a k-mer present in most of N = 100 samples has ~5,000.
//
// Design (simple and right first):
//   - A CTA takes the segments whose first row lies in its equal share
//     of the rows (a binary search of the starts); its warps take that
//     run 32 segments at a time from a shared counter. A warp reads the
//     32 lengths at once, skips the singletons by a ballot and walks the
//     others one at a time, its lanes over the segment's pairs in a
//     rotation order: pair q is (i, i + d mod L) with i = q mod L,
//     d = 1 + q div L, over q < L (L - 1) / 2, which visits each
//     unordered pair once (for even L the last offset L / 2 stops at
//     i < L / 2). Neighbouring lanes read neighbouring rows.
//   - Shared form: each CTA keeps private partials in dynamic shared
//     memory over the upper triangle of N (N - 1) / 2 bins (the
//     reference's tri_idx, countjoin.py:1379), 64-bit shared atomics,
//     flushed once with 64-bit global atomics (zeros skipped). The
//     channels go in groups that fit the opt-in shared memory (227 KB on
//     an H100): one launch a group, the caller's loop
//     (simka_pair_sums_slots says how many channels a group holds).
//     N = 100: 4,950 bins, 39,600 B a channel, 5 channels a group.
//   - Global form, past the N where one channel's triangle no longer fits
//     (N >= 242 on an H100): every pair adds straight into the outputs
//     with 64-bit global atomics, every channel in one launch.
// Two's-complement wrap makes the unsigned atomics add signed values (the
// KL limbs of a negative term) exactly.
//
// Plain C interface for ctypes. Nothing here allocates or synchronises:
// the caller passes the outputs and the stream; the entry point returns
// the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kChannels = 13;  // 0-7 as above, 8-12 the KL limbs
constexpr int kKlFirst = 8;
constexpr int kKlLimbs = 5;
constexpr double kLimbScale = 268435456.0;  // 2^28, ops/countjoin.py
constexpr double kTwo31 = 2147483648.0;
constexpr double kTwo32 = 4294967296.0;
// rows a CTA at least: small joins take few CTAs (each zeroes and
// flushes its partials)
constexpr int64_t kRowsPerCta = 4096;
// shared memory the kernel declares statically, kept out of the groups
constexpr int kStaticSmem = 64;

struct Channels {
  // channel c's output (a KL limb's first element); null when off
  unsigned long long* out[kChannels];
  // channel c's slot among this launch's shared partials (the global
  // form: >= 0 for every channel on), -1 when not in this launch
  int slot[kChannels];
};

// torch.remainder(x, 2^32) on f64: fmod, then the sign fix (exact)
__device__ __forceinline__ double mod32(double x) {
  double m = fmod(x, kTwo32);
  if (m != 0.0 && m < 0.0) m = __dadd_rn(m, kTwo32);
  return m;
}

// ops/countjoin.py::_abs_wrap32 on one exact-integer f64
__device__ __forceinline__ long long abs_wrap32(double p) {
  double low = mod32(p);
  if (low >= kTwo31) low = __dsub_rn(low, kTwo32);
  return (long long)fabs(low);
}

// the five limbs of ops/countjoin.py::_kl_limbs(x), in v[8..12]
__device__ __forceinline__ void kl_limbs(double x, long long (&v)[kChannels]) {
  const double sgn = x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : 0.0);
  double r = fabs(x);
  double q = floor(r);
  r = __dsub_rn(r, q);
  v[kKlFirst] = (long long)__dmul_rn(q, sgn);
#pragma unroll
  for (int l = 1; l < kKlLimbs; ++l) {
    r = __dmul_rn(r, kLimbScale);
    q = floor(r);
    r = __dsub_rn(r, q);
    v[kKlFirst + l] = (long long)__dmul_rn(q, sgn);
  }
}

// one pair's channel values (those not asked for stay 0)
__device__ __forceinline__ void pair_terms(long long ca, long long cb,
                                           double Ka, double Kb, bool simple,
                                           bool wh, bool kl,
                                           long long (&v)[kChannels]) {
#pragma unroll
  for (int c = 0; c < kChannels; ++c) v[c] = 0;
  v[0] = ca;
  v[1] = cb;
  v[2] = 1;
  v[3] = ca < cb ? ca : cb;
  if (simple) {
    const long long prod = ca * cb;
    v[4] = (long long)floor(sqrt((double)prod));
    v[5] = prod;
  }
  if (wh || kl) {
    const double caf = (double)ca, cbf = (double)cb;
    const double xY = __dmul_rn(caf, Kb), yX = __dmul_rn(cbf, Ka);
    if (wh) {
      // SimkaAlgorithm.hpp:481: the difference of the two rounded
      // products wrapped to int32
      long long low = (long long)mod32(__dsub_rn(mod32(xY), mod32(yX)));
      if (low >= (1LL << 31)) low -= 1LL << 32;
      v[6] = low < 0 ? -low : low;
      v[7] = abs_wrap32(xY) + abs_wrap32(yX);
    }
    if (kl) {
      // SimkaAlgorithm.hpp:437-446
      const double den = __dadd_rn(xY, yX);
      const double d1 = __dmul_rn(__ddiv_rn(caf, Ka < 1.0 ? 1.0 : Ka),
                                  log(__ddiv_rn(__dmul_rn(2.0, xY), den)));
      const double d2 = __dmul_rn(__ddiv_rn(cbf, Kb < 1.0 ? 1.0 : Kb),
                                  log(__ddiv_rn(__dmul_rn(2.0, yX), den)));
      kl_limbs(__dadd_rn(d1, d2), v);
    }
  }
}

// upper-triangle bin of (a, b), a < b: the reference's tri_idx
__device__ __forceinline__ long long tri(long long a, long long b, long long n) {
  return a * (2 * n - a - 1) / 2 + (b - a - 1);
}

// first segment whose first row is >= row
__device__ long long first_segment_at(const long long* __restrict__ starts,
                                 long long n_segs, long long row) {
  long long lo = 0, hi = n_segs;
  while (lo < hi) {
    const long long mid = (lo + hi) / 2;
    if (starts[mid] < row) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
pair_sums_kernel(const long long* __restrict__ sid,
                 const long long* __restrict__ count,
                 const long long* __restrict__ starts,
                 const long long* __restrict__ seg_len, long long n_rows,
                 long long n_segs, const double* __restrict__ K,
                 long long n_banks, Channels ch) {
  extern __shared__ unsigned long long part[];  // [slots][tri]
  __shared__ long long seg_end;
  __shared__ unsigned long long next_seg;
  const long long n_tri = n_banks * (n_banks - 1) / 2;
  int n_slots = 0;
#pragma unroll
  for (int c = 0; c < kChannels; ++c)
    if (ch.slot[c] >= 0) n_slots = max(n_slots, ch.slot[c] + 1);
  const bool simple = ch.slot[4] >= 0 || ch.slot[5] >= 0;
  const bool wh = ch.slot[6] >= 0 || ch.slot[7] >= 0;
  bool kl = false;
#pragma unroll
  for (int l = 0; l < kKlLimbs; ++l) kl |= ch.slot[kKlFirst + l] >= 0;

  if (kShared)
    for (long long i = threadIdx.x; i < n_slots * n_tri; i += blockDim.x)
      part[i] = 0;
  if (threadIdx.x == 0) {
    const long long r0 = n_rows * blockIdx.x / gridDim.x;
    const long long r1 = n_rows * (blockIdx.x + 1) / gridDim.x;
    next_seg = (unsigned long long)first_segment_at(starts, n_segs, r0);
    seg_end = first_segment_at(starts, n_segs, r1);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long s_end = seg_end;
  for (;;) {
    unsigned long long base = 0;
    if (lane == 0) base = atomicAdd(&next_seg, 32ULL);
    const long long s0 = (long long)__shfl_sync(0xffffffffu, base, 0);
    if (s0 >= s_end) break;
    const long long s = s0 + lane;
    long long len = 0, first = 0;
    if (s < s_end) {
      len = seg_len[s];
      if (len >= 2) first = starts[s];
    }
    unsigned todo = __ballot_sync(0xffffffffu, len >= 2);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int L = (int)__shfl_sync(0xffffffffu, len, src);
      const long long at = __shfl_sync(0xffffffffu, first, src);
      const long long pairs = (long long)L * (L - 1) / 2;
      // pair q = (d - 1) L + i is rows (i, i + d mod L); q steps by 32
      const int step = 32 / L, rem = 32 % L;
      int i = lane % L, d = 1 + lane / L;
      for (long long q = lane; q < pairs; q += 32) {
        int j = i + d;
        if (j >= L) j -= L;
        const long long lo = at + (i < j ? i : j), hi = at + (i < j ? j : i);
        const long long a = sid[lo], b = sid[hi];
        long long v[kChannels];
        pair_terms(count[lo], count[hi], (wh || kl) ? K[a] : 0.0,
                   (wh || kl) ? K[b] : 0.0, simple, wh, kl, v);
        const long long bin = kShared ? tri(a, b, n_banks) : a * n_banks + b;
#pragma unroll
        for (int c = 0; c < kChannels; ++c) {
          const int slot = ch.slot[c];
          if (slot < 0) continue;
          const unsigned long long x = (unsigned long long)v[c];
          if (kShared)
            atomicAdd(part + slot * n_tri + bin, x);
          else
            atomicAdd(ch.out[c] + bin * (c >= kKlFirst ? kKlLimbs : 1), x);
        }
        i += rem;
        d += step;
        if (i >= L) {
          i -= L;
          d += 1;
        }
      }
    }
  }

  if (!kShared) return;
  __syncthreads();
  for (long long k = threadIdx.x; k < n_banks * n_banks; k += blockDim.x) {
    const long long a = k / n_banks, b = k - a * n_banks;
    if (a >= b) continue;
    const long long t = tri(a, b, n_banks);
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      const int slot = ch.slot[c];
      if (slot < 0) continue;
      const unsigned long long x = part[slot * n_tri + t];
      if (x) atomicAdd(ch.out[c] + k * (c >= kKlFirst ? kKlLimbs : 1), x);
    }
  }
}

template <bool kShared>
int launch(const long long* sid, const long long* count,
           const long long* starts, const long long* seg_len,
           long long n_rows, long long n_segs, const double* K,
           long long n_banks, const Channels& ch, size_t smem,
           cudaStream_t stream) {
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(pair_sums_kernel<kShared>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, pair_sums_kernel<kShared>, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long grid = (n_rows + kRowsPerCta - 1) / kRowsPerCta;
  if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
  if (grid < 1) grid = 1;
  pair_sums_kernel<kShared><<<(unsigned)grid, kThreads, smem, stream>>>(
      sid, count, starts, seg_len, n_rows, n_segs, K, n_banks, ch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The channels one shared-form launch holds at N = n_banks on the
// current device (at most 13); 0: one channel's triangle does not fit,
// so the caller takes the global form.
int simka_pair_sums_slots(int64_t n_banks) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  const long long bytes = n_banks * (n_banks - 1) / 2 * 8;
  if (bytes <= 0) return kChannels;
  const long long slots = (optin - kStaticSmem) / bytes;
  return (int)(slots < kChannels ? slots : kChannels);
}

// sid, count: [n_rows] int64 solid rows in (k-mer, sample) order; starts,
// seg_len: [n_segs] int64 segments (starts ascending, from 0); K:
// [n_banks] f64. outs: 13 device pointers (null where off): channels
// 0-7 [n_banks^2] int64, 8-12 the KL limbs' first elements of the
// [n_banks^2, 5] int64 limbs. slots: 13 ints, each channel's slot in
// this launch's shared partials (consecutive from 0), -1 when off; with
// shared == 0 (the global form) >= 0 marks a channel on. Returns a
// cudaError_t code (0 on success).
int simka_pair_sums(const int64_t* sid, const int64_t* count,
                    const int64_t* starts, const int64_t* seg_len,
                    int64_t n_rows, int64_t n_segs, const double* K,
                    int64_t n_banks, void* const* outs, const int* slots,
                    int shared, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_rows < 1 || n_segs < 1 || n_banks < 2)
    return (int)cudaErrorInvalidValue;
  Channels ch;
  int n_slots = 0;
  for (int c = 0; c < kChannels; ++c) {
    ch.out[c] = static_cast<unsigned long long*>(outs[c]);
    ch.slot[c] = slots[c];
    if (slots[c] >= kChannels || (slots[c] >= 0 && outs[c] == nullptr))
      return (int)cudaErrorInvalidValue;
    if (slots[c] >= 0) n_slots = n_slots > slots[c] + 1 ? n_slots : slots[c] + 1;
  }
  if (n_slots == 0) return (int)cudaErrorInvalidValue;
  const long long* s = reinterpret_cast<const long long*>(sid);
  const long long* c = reinterpret_cast<const long long*>(count);
  const long long* st = reinterpret_cast<const long long*>(starts);
  const long long* ln = reinterpret_cast<const long long*>(seg_len);
  if (!shared)
    return launch<false>(s, c, st, ln, n_rows, n_segs, K, n_banks, ch, 0,
                         stream);
  const size_t smem = (size_t)n_slots * (size_t)(n_banks * (n_banks - 1) / 2) * 8;
  return launch<true>(s, c, st, ln, n_rows, n_segs, K, n_banks, ch, smem,
                      stream);
}

}  // extern "C"
