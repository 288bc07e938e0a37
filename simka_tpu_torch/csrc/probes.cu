// Hopper counterparts of the TPU capability probes (sm_90a).
//
// The JAX package probed what Mosaic (the TPU kernel compiler) accepts
// with small Pallas kernels under scripts/profiling/:
//   test_pallas_basic.py   f1..f6  elementwise bodies and HBM<->VMEM DMAs
//                                  at static, dynamic and unaligned offsets
//   test_mosaic_reshape.py k1..k7  reshapes, one-hots, a bf16 one-hot
//                                  product, concat + slice
//   test_mosaic_features.py ka..ke a bf16 x^T x, per-lane shifts, sublane
//                                  slices, a product under a device-side
//                                  predicate, a max-reduce predicate
//   test_dma_align.py      run     the f6 copy at offsets {0, 128, 131, 777}
// Each entry point below computes what one or more of those kernels
// compute, at their shapes, with the Hopper feature that answers the
// same question:
//   - simka_probe_dma: the DMAs become 1-D bulk copies (cp.async.bulk,
//     the TMA's non-tensor form) global -> shared with an mbarrier and
//     shared -> global with a bulk group. A bulk copy needs 16-byte
//     aligned global and shared addresses and a size that is a multiple
//     of 16 bytes, so an int32 span at an arbitrary element offset is
//     split: the elements before the first 16-byte boundary and after
//     the last one go by plain loads and stores ("peeled"), the aligned
//     body by one bulk copy. The split is reported per copy in `info`.
//   - simka_probe_gram_bf16: the bf16 dot_generals contracting dim 0
//     (k6, ka, kd) become a tensor-core product, mma.sync m16n8k16
//     bf16 x bf16 -> f32, one warp per 16 x 8 output tile; kd's
//     lax.cond becomes a device-side flag read by the kernel (no host
//     sync), written by simka_probe_max_positive.
//   - the elementwise bodies are grid-stride loops.
// What bounds them: nothing at these sizes (<= 1 MB, one launch each);
// they are capability and correctness probes, timed for the record.
//
// Plain C interface for ctypes; nothing here allocates or
// synchronises. Each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;

// int32 ops of simka_probe_map_i32 (two's-complement wrap, as XLA's)
enum : int {
  kMul = 0,      // x * arg                       f2
  kAdd = 1,      // x + arg                       k1, k4 (arg = 1)
  kRollAdd1 = 2, // x[(i + arg) % n] + 1          k7 (concat + slice [5:])
  kRollSum = 3,  // x[(i + arg) % n] + x[i]       kc (w[3:] + w[:n])
  kLaneByte = 4, // (x >> (i % arg % 4 * 8)) & 255, arg = lanes   kb
  kSelect = 5,   // *flag ? x : 2 x               ke
};

int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

__global__ void probe_scale_f32(const float* __restrict__ x,
                                float* __restrict__ out, int64_t n,
                                float mul) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = x[i] * mul;
}

__global__ void probe_map_i32(int op, const int32_t* __restrict__ x,
                              int32_t* __restrict__ out, int64_t n,
                              int32_t arg, const int32_t* __restrict__ flag) {
  const bool take_x = op == kSelect && *flag != 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t v = x[i];
    int64_t j = i + arg;
    if (j >= n) j -= n;
    int32_t r;
    switch (op) {
      case kMul: r = wrap_mul(v, arg); break;
      case kAdd: r = wrap_add(v, arg); break;
      case kRollAdd1: r = wrap_add(x[j], 1); break;
      case kRollSum: r = wrap_add(x[j], v); break;
      case kLaneByte: r = (v >> ((int)(i % arg) % 4 * 8)) & 255; break;
      default: r = take_x ? v : wrap_mul(v, 2); break;
    }
    out[i] = r;
  }
}

// out[r, c] = (x[r] >= 0 && x[r] == c) ? 1 : 0 over [rows, cols]: k3
// (x == iota) and k5 (the same under the x >= 0 mask, which c >= 0
// already implies)
__global__ void probe_onehot_f32(const int32_t* __restrict__ x,
                                 float* __restrict__ out, int64_t rows,
                                 int cols) {
  const int64_t n = rows * cols;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t v = x[i / cols];
    out[i] = (v >= 0 && v == (int32_t)(i % cols)) ? 1.f : 0.f;
  }
}

// *flag = max(float(x)) > 0, one CTA (ke's and kd's predicate). NaN
// inputs are not expected (fmaxf drops them).
__global__ void probe_max_positive(int is_i32, const void* __restrict__ x,
                                   int64_t n, int32_t* __restrict__ flag) {
  __shared__ float warp_max[32];
  float m = -INFINITY;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = is_i32 ? (float)static_cast<const int32_t*>(x)[i]
                           : static_cast<const float*>(x)[i];
    m = fmaxf(m, v);
  }
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < (blockDim.x >> 5) ? warp_max[threadIdx.x] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) *flag = m > 0.f ? 1 : 0;
  }
}

// ---- tensor cores: out = A^T A, A [rows, cols] in bf16 ----

// A[r][c] as bf16 bits: mode 0 reads f32 x [rows, cols] and rounds to
// nearest even (ka, kd: x.astype(bf16)); mode 1 is the one-hot of the
// int32 x [rows], A[r][c] = (x[r] == c % mod) (k6).
__device__ __forceinline__ uint32_t gram_elem(int mode, const void* x,
                                              int64_t r, int c, int cols,
                                              int mod) {
  float v;
  if (mode == 0) {
    v = static_cast<const float*>(x)[r * cols + c];
  } else {
    v = static_cast<const int32_t*>(x)[r] == c % mod ? 1.f : 0.f;
  }
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t pack2(uint32_t lo, uint32_t hi) {
  return lo | (hi << 16);
}

// One warp per 16 x 8 tile of out [cols, cols]; the contraction over
// rows runs in steps of 16 through mma.sync.m16n8k16 with the MMA's A
// operand = A^T (row-major view) and B operand = A (column view),
// fragments gathered straight from global memory (L1/L2-resident at
// these sizes). flag (nullable): when *flag == 0 the product is skipped
// and out is 0 (kd's lax.cond false branch).
__global__ void probe_gram_bf16(int mode, const void* __restrict__ x,
                                float* __restrict__ out, int64_t rows,
                                int cols, int mod,
                                const int32_t* __restrict__ flag) {
  const int warp = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  const int tiles_n = cols / 8;
  const int m0 = warp / tiles_n * 16;
  const int n0 = warp % tiles_n * 8;
  if (m0 >= cols) return;  // whole warps only
  const int g = lane >> 2, t = lane & 3;
  float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
  if (flag == nullptr || *flag != 0) {
    for (int64_t k0 = 0; k0 < rows; k0 += 16) {
      const int64_t ka = k0 + 2 * t, kb = ka + 8;
      // A fragment (16 x 16, row): rows g / g + 8, columns 2t.. / 2t+8..
      const uint32_t a0 = pack2(gram_elem(mode, x, ka, m0 + g, cols, mod),
                                gram_elem(mode, x, ka + 1, m0 + g, cols, mod));
      const uint32_t a1 =
          pack2(gram_elem(mode, x, ka, m0 + g + 8, cols, mod),
                gram_elem(mode, x, ka + 1, m0 + g + 8, cols, mod));
      const uint32_t a2 = pack2(gram_elem(mode, x, kb, m0 + g, cols, mod),
                                gram_elem(mode, x, kb + 1, m0 + g, cols, mod));
      const uint32_t a3 =
          pack2(gram_elem(mode, x, kb, m0 + g + 8, cols, mod),
                gram_elem(mode, x, kb + 1, m0 + g + 8, cols, mod));
      // B fragment (16 x 8, col): rows 2t.. / 2t+8.., column g
      const uint32_t b0 = pack2(gram_elem(mode, x, ka, n0 + g, cols, mod),
                                gram_elem(mode, x, ka + 1, n0 + g, cols, mod));
      const uint32_t b1 = pack2(gram_elem(mode, x, kb, n0 + g, cols, mod),
                                gram_elem(mode, x, kb + 1, n0 + g, cols, mod));
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  // D fragment: rows g / g + 8, columns 2t, 2t + 1
  float* o = out + (int64_t)(m0 + g) * cols + n0 + 2 * t;
  o[0] = d0;
  o[1] = d1;
  o[8 * cols] = d2;
  o[8 * cols + 1] = d3;
}

// ---- bulk copies (TMA, 1-D) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// [head, body, tail] elements of an int32 span of len elements at
// address addr: head up to the first 16-byte boundary, body a multiple
// of 16 bytes, tail the rest.
struct Split {
  int64_t mis;  // elements past the 16-byte boundary below addr
  int64_t head, body, tail;
};

__device__ __forceinline__ Split split16(const void* addr, int64_t len) {
  Split s;
  s.mis = (int64_t)(((uintptr_t)addr >> 2) & 3);
  s.head = s.mis == 0 ? 0 : 4 - s.mis;
  if (s.head > len) s.head = len;
  s.body = (len - s.head) / 4 * 4;
  s.tail = len - s.head - s.body;
  return s;
}

// One CTA: out[dst, dst + len) = x[src, src + len) + 1 via shared
// memory, src = off * off_scale + src_add and dst = off * off_scale +
// dst_add, with off = *off_ptr read on the device (0 without one): f3
// (static span), f4 (row tile 0:8 -> 8:16), f5 (dynamic row tile), f6
// and test_dma_align.py (dynamic, unaligned). Each shared buffer starts
// at the same residue mod 16 as its global span, so the aligned bodies
// line up: the load buffer with the source, the store buffer with the
// destination; the +1 pass moves the data from one to the other.
// info[0..2]: load head/bulk/tail elements; info[3..5]: the store's;
// info[6]: 1 when the span was out of bounds (nothing copied).
__global__ void probe_dma_add1(const int32_t* __restrict__ x, int64_t x_len,
                               int32_t* __restrict__ out, int64_t out_len,
                               const int32_t* __restrict__ off_ptr,
                               int64_t off_scale, int64_t src_add,
                               int64_t dst_add, int64_t len,
                               int32_t* __restrict__ info) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  const int64_t off = off_ptr ? (int64_t)off_ptr[0] : 0;
  const int64_t src = off * off_scale + src_add;
  const int64_t dst = off * off_scale + dst_add;
  if (src < 0 || dst < 0 || src + len > x_len || dst + len > out_len) {
    if (threadIdx.x == 0) info[6] = 1;
    return;
  }
  const Split ld = split16(x + src, len);
  const Split st = split16(out + dst, len);
  const int64_t buf_elems = (len + 4 + 3) / 4 * 4;
  int32_t* in_s = reinterpret_cast<int32_t*>(smem_raw) + ld.mis;
  int32_t* out_s = reinterpret_cast<int32_t*>(smem_raw) + buf_elems + st.mis;
  const uint32_t bar_a = smem_u32(&bar);

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && ld.body > 0) {
    const uint32_t bytes = (uint32_t)(ld.body * 4);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar_a),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(in_s + ld.head)),
        "l"((uint64_t)(x + src + ld.head)), "r"(bytes), "r"(bar_a)
        : "memory");
  }
  for (int64_t i = threadIdx.x; i < ld.head + ld.tail; i += blockDim.x) {
    const int64_t e = i < ld.head ? i : ld.body + i;
    in_s[e] = x[src + e];
  }
  if (ld.body > 0) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar_a), "r"(0u)
          : "memory");
    }
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < len; i += blockDim.x)
    out_s[i] = wrap_add(in_s[i], 1);
  // generic-proxy writes to shared memory, visible to the bulk store
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0 && st.body > 0) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            (uint64_t)(out + dst + st.head)),
        "r"(smem_u32(out_s + st.head)), "r"((uint32_t)(st.body * 4))
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  for (int64_t i = threadIdx.x; i < st.head + st.tail; i += blockDim.x) {
    const int64_t e = i < st.head ? i : st.body + i;
    out[dst + e] = out_s[e];
  }
  if (threadIdx.x == 0) {
    info[0] = (int32_t)ld.head;
    info[1] = (int32_t)ld.body;
    info[2] = (int32_t)ld.tail;
    info[3] = (int32_t)st.head;
    info[4] = (int32_t)st.body;
    info[5] = (int32_t)st.tail;
    info[6] = 0;
  }
}

}  // namespace

extern "C" {

int simka_probe_scale_f32(const float* x, float* out, int64_t n, float mul,
                          void* stream) {
  probe_scale_f32<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      x, out, n, mul);
  return (int)cudaGetLastError();
}

int simka_probe_map_i32(int op, const int32_t* x, int32_t* out, int64_t n,
                        int32_t arg, const int32_t* flag, void* stream) {
  if (op < kMul || op > kSelect || (op == kSelect && flag == nullptr) ||
      (op == kLaneByte && arg < 1) ||
      ((op == kRollAdd1 || op == kRollSum) && (arg < 0 || arg > n)))
    return (int)cudaErrorInvalidValue;
  probe_map_i32<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      op, x, out, n, arg, flag);
  return (int)cudaGetLastError();
}

int simka_probe_onehot_f32(const int32_t* x, float* out, int64_t rows,
                           int cols, void* stream) {
  probe_onehot_f32<<<blocks_for(rows * cols), kThreads, 0,
                     (cudaStream_t)stream>>>(x, out, rows, cols);
  return (int)cudaGetLastError();
}

int simka_probe_max_positive(int is_i32, const void* x, int64_t n,
                             int32_t* flag, void* stream) {
  probe_max_positive<<<1, 1024, 0, (cudaStream_t)stream>>>(is_i32, x, n,
                                                           flag);
  return (int)cudaGetLastError();
}

// out [cols, cols] f32 = A^T A; rows and cols multiples of 16.
int simka_probe_gram_bf16(int mode, const void* x, float* out, int64_t rows,
                          int cols, int mod, const int32_t* flag,
                          void* stream) {
  if ((mode != 0 && mode != 1) || rows % 16 || cols % 16 || cols < 16 ||
      (mode == 1 && mod < 1))
    return (int)cudaErrorInvalidValue;
  const int warps = (cols / 16) * (cols / 8);
  const int threads = 128;
  const int blocks = (warps * 32 + threads - 1) / threads;
  probe_gram_bf16<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      mode, x, out, rows, cols, mod, flag);
  return (int)cudaGetLastError();
}

// Shared memory: two buffers of len + 4 int32 (len <= 4096).
int simka_probe_dma(const int32_t* x, int64_t x_len, int32_t* out,
                    int64_t out_len, const int32_t* off, int64_t off_scale,
                    int64_t src_add, int64_t dst_add, int64_t len,
                    int32_t* info, void* stream) {
  if (len < 1 || len > 4096) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * ((len + 4 + 3) / 4 * 4) * sizeof(int32_t);
  probe_dma_add1<<<1, 128, smem, (cudaStream_t)stream>>>(
      x, x_len, out, out_len, off, off_scale, src_add, dst_add, len, info);
  return (int)cudaGetLastError();
}

}  // extern "C"
