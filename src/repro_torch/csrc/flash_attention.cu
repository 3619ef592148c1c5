// Blocked online-softmax attention (forward), for Hopper.
//
//   out[b, i] = sum_j softmax_j(scale * q[b, i] . k[b, j]) v[b, j]
//
// over the keys j the mask allows: every j < Skv, and under `causal` the
// top-left mask j <= i. q, k, v are fp32 or bf16 (converted to fp32 as
// they are staged), scale = D^-0.5 multiplies q as the reference does,
// the running max m, denominator l and accumulator are fp32, the result
// is acc / max(l, 1e-30) in q's dtype.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_pallas (body _flash_kernel).
// That kernel runs a (BH, Sq/bq, Skv/bk) grid with the KV axis
// sequential, keeping (m, l, acc) in VMEM scratch across it; its caller
// pads K and V with zero rows, which the non-causal kernel then counts as
// logit-0 keys. Here one 256-thread block owns one (bh, q tile) and walks
// the KV tiles itself. Per KV tile:
//   1. the K tile is staged in shared memory (fp32, rows padded by one
//      word so that a warp reads 16 different rows without a bank clash)
//      and each thread computes up to an 8 x 8 register tile of the
//      (bq, bk) scores (rows ty + 16 i, keys tx + 16 j) against the q tile
//      staged once at the start;
//   2. one warp per row folds the tile into the row's (m, l) online: the
//      masked keys (beyond Skv, or after the row under `causal`) take no
//      part in the max and get weight exactly 0, so a ragged Skv needs no
//      padding and no padded key counts; the weights overwrite the scores
//      and the row's correction exp(m_old - m_new) is kept; meanwhile the
//      V tile replaces the K tile;
//   3. each thread rescales its up-to 8 x 8 register tile of the (bq, Dv)
//      accumulator by its rows' corrections and adds weights @ V.
// Under `causal` the KV tiles past the q tile's last row are skipped:
// they would add exactly 0. The q tiles are issued longest first.
//
// Bound on this card: operations (4 D flops per score at D = 64-128 over
// a few bytes per score), at the tensor-core rate for bf16 inputs. This
// kernel runs its products as fp32 FMAs on the SIMT cores, one block per
// SM (~195 KB of shared memory at bq = bk = D = 128), so it is far under
// that bound; mma/wgmma tiles, a TMA ring and more blocks per SM are
// later work.
//
// Arithmetic: expf (not __expf); the products are FMAs in another order
// than the plain version's, which agrees to fp32 rounding.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kSide = 16;                 // 16 x 16 threads
constexpr int kThreads = kSide * kSide;
constexpr int kMaxTile = 128;             // block_q, block_k, D, Dv
constexpr int kMicro = kMaxTile / kSide;  // register tile edge, 8
constexpr float kNegInf = -1e30f;         // the empty max (NEG_INF)
constexpr float kTiny = 1e-30f;           // the denominator floor

struct Shape {
  int bh, sq, skv, d, dv, bq, bk, causal;
  float scale;
};

__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || is_nan(b)) ? b : a;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ inline int round16(int v) {
  return (v + kSide - 1) / kSide * kSide;
}

// floats of shared memory a launch needs (tiles rounded up to 16 rows)
__host__ __device__ inline size_t smem_floats(int bq, int bk, int d, int dv) {
  const size_t q = round16(bq), k = round16(bk);
  return q * (d + 1) + k * ((d > dv ? d : dv) + 1) + q * (k + 1) + 3 * q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       Shape s) {
  extern __shared__ float smem[];
  const int bq = round16(s.bq), bk = round16(s.bk);
  const int ldq = s.d + 1, ldkv = max(s.d, s.dv) + 1, lds = bk + 1;
  float* qs = smem;                      // (bq, d) scaled q tile
  float* kvs = qs + bq * ldq;            // (bk, d) K tile, then (bk, dv) V
  float* ss = kvs + bk * ldkv;           // (bq, bk) scores, then weights
  float* m_s = ss + bq * lds;            // running max per row
  float* l_s = m_s + bq;                 // running denominator per row
  float* c_s = l_s + bq;                 // this tile's correction per row

  const int q_tiles = (s.sq + s.bq - 1) / s.bq;
  const int bh = blockIdx.x / q_tiles;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x % q_tiles);
  const int q0 = qt * s.bq;
  const int rows = min(s.bq, s.sq - q0);
  const T* qb = q + (static_cast<size_t>(bh) * s.sq + q0) * s.d;
  const T* kb = k + static_cast<size_t>(bh) * s.skv * s.d;
  const T* vb = v + static_cast<size_t>(bh) * s.skv * s.dv;
  T* ob = out + (static_cast<size_t>(bh) * s.sq + q0) * s.dv;

  const int tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;
  const int warp = tid >> 5, lane = tid & 31;
  const int mi = bq / kSide, nj = bk / kSide, dj = (s.dv + kSide - 1) / kSide;

  for (int e = tid; e < bq * s.d; e += kThreads) {
    const int r = e / s.d, c = e % s.d;
    qs[r * ldq + c] =
        r < rows ? __fmul_rn(to_float(qb[static_cast<size_t>(r) * s.d + c]),
                             s.scale)
                 : 0.0f;
  }
  for (int r = tid; r < bq; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }
  float o[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) o[i][j] = 0.0f;

  const int kv_end = s.causal ? min(s.skv, q0 + rows) : s.skv;
  for (int k0 = 0; k0 < kv_end; k0 += s.bk) {
    const int cols = min(s.bk, s.skv - k0);
    for (int e = tid; e < bk * s.d; e += kThreads) {
      const int r = e / s.d, c = e % s.d;
      kvs[r * ldkv + c] =
          r < cols ? to_float(kb[static_cast<size_t>(k0 + r) * s.d + c]) : 0.0f;
    }
    __syncthreads();
    {  // 1. scores
      float acc[kMicro][kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;
      for (int c = 0; c < s.d; ++c) {
        float a[kMicro], b[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
          a[i] = i < mi ? qs[(ty + kSide * i) * ldq + c] : 0.0f;
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          b[j] = j < nj ? kvs[(tx + kSide * j) * ldkv + c] : 0.0f;
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          if (i < mi && j < nj)
            ss[(ty + kSide * i) * lds + tx + kSide * j] = acc[i][j];
    }
    __syncthreads();
    // 2. the online softmax step, one warp per row
    for (int r = warp; r < rows; r += kThreads / 32) {
      // keys k0 + c with c < lim are unmasked
      const int lim = s.causal ? min(cols, q0 + r - k0 + 1) : cols;
      float* row = ss + r * lds;
      float mx = kNegInf;
      for (int c = lane; c < lim; c += 32) mx = max_nan(mx, row[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = max_nan(m_old, mx);
      float sum = 0.0f;
      for (int c = lane; c < bk; c += 32) {
        const float p = c < lim ? expf(__fsub_rn(row[c], m_new)) : 0.0f;
        row[c] = p;
        sum = __fadd_rn(sum, p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      if (lane == 0) {
        const float corr = expf(__fsub_rn(m_old, m_new));
        m_s[r] = m_new;
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], corr), sum);
        c_s[r] = corr;
      }
    }
    for (int e = tid; e < bk * s.dv; e += kThreads) {
      const int r = e / s.dv, c = e % s.dv;
      kvs[r * ldkv + c] =
          r < cols ? to_float(vb[static_cast<size_t>(k0 + r) * s.dv + c])
                   : 0.0f;
    }
    __syncthreads();
    // 3. acc = acc * corr + weights @ V (rows past `rows` stay unused)
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int r = ty + kSide * i;
      const float corr = (i < mi && r < rows) ? c_s[r] : 1.0f;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) o[i][j] = __fmul_rn(o[i][j], corr);
    }
    for (int c = 0; c < cols; ++c) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
        a[i] = i < mi ? ss[(ty + kSide * i) * lds + c] : 0.0f;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int col = tx + kSide * j;
        b[j] = (j < dj && col < s.dv) ? kvs[c * ldkv + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) o[i][j] = fmaf(a[i], b[j], o[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = ty + kSide * i;
    if (i >= mi || r >= rows) continue;
    const float l = l_s[r];
    const float denom = (l > kTiny || is_nan(l)) ? l : kTiny;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int col = tx + kSide * j;
      if (j < dj && col < s.dv)
        store(ob + static_cast<size_t>(r) * s.dv + col,
              __fdiv_rn(o[i][j], denom));
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, const Shape& s, size_t smem,
                         cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(s.bh) * ((s.sq + s.bq - 1) / s.bq);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// The bytes of shared memory a launch with these tiles and head sizes
// needs (under 2^31 for the sizes the launch takes, all at most 128).
extern "C" int repro_flash_attention_smem_bytes(int block_q, int block_k,
                                                int d, int dv) {
  return static_cast<int>(repro::smem_floats(block_q, block_k, d, dv) *
                          sizeof(float));
}

// The opt-in shared memory a block may use on the current device, or a
// negative CUDA error code.
extern "C" int repro_smem_optin_limit(void) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? limit : -static_cast<int>(err);
}

// q (bh, sq, d), k (bh, skv, d), v (bh, skv, dv), out (bh, sq, dv), all
// contiguous in the storage type `dtype` (fp32 or bf16); block_q/block_k
// are the tiles (at most 128, as are d and dv). Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for another dtype, a size out of range, more
// blocks than a grid holds, or tiles whose shared memory exceeds the
// device's opt-in limit.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, int dtype, int bh, int sq,
                                     int skv, int d, int dv, int block_q,
                                     int block_k, int causal, float scale,
                                     void* out, void* stream) {
  using namespace repro;
  if (bh < 1 || sq < 1 || skv < 1 || d < 1 || dv < 1 || d > kMaxTile ||
      dv > kMaxTile || block_q < 1 || block_k < 1 || block_q > kMaxTile ||
      block_k > kMaxTile ||
      static_cast<long long>(bh) * ((sq + block_q - 1) / block_q) >
          0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int limit = repro_smem_optin_limit();
  const size_t smem = smem_floats(block_q, block_k, d, dv) * sizeof(float);
  if (limit < 0) return -limit;
  if (smem > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{bh, sq, skv, d, dv, block_q, block_k, causal ? 1 : 0, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch_typed<float>(q, k, v, out, s, smem, st));
    case kBF16:
      return static_cast<int>(
          launch_typed<__nv_bfloat16>(q, k, v, out, s, smem, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
