// Blocked online-softmax attention (forward), for Hopper.
//
//   out[b, i] = sum_j softmax_j(scale * q[b, i] . k[b, j]) v[b, j]
//
// over the keys j the mask allows: every j < Skv, and under `causal` the
// top-left mask j <= i. q, k, v are fp32 or bf16, scale = D^-0.5, the
// running max m, denominator l and accumulator are fp32, the result is
// acc / max(l, 1e-30) in q's dtype.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_pallas (body _flash_kernel).
// That kernel runs a (BH, Sq/bq, Skv/bk) grid with the KV axis
// sequential, keeping (m, l, acc) in VMEM scratch across it; its caller
// pads K and V with zero rows, which the non-causal kernel then counts as
// logit-0 keys. Here one block owns one (bh, q tile) and walks the KV
// tiles itself. The masked keys (beyond Skv, or after the row under
// `causal`) take no part in the max and get weight exactly 0, so a
// ragged Skv needs no padding and no padded key counts. Under `causal`
// the KV tiles past the q tile's last row are skipped (they would add
// exactly 0) and the heaviest q tiles are issued first.
//
// Two bodies; the wrapper picks one by dtype and head sizes alone
// (kernels/flash_attention/kernel.py, body_for):
//
// "simt" (every fp32 call, and bf16 head sizes the tensor cores do not
// take): one 256-thread block per (bh, block_q rows), tiles of the
// caller's block_q x block_k. Per KV tile:
//   1. the K tile is staged in shared memory (fp32, rows padded by one
//      word so that a warp reads 16 different rows without a bank clash)
//      and each thread computes up to an 8 x 8 register tile of the
//      (bq, bk) scores (rows ty + 16 i, keys tx + 16 j) against the q
//      tile, scaled as the reference scales it (q * scale), staged once;
//   2. one warp per row folds the tile into the row's (m, l) online; the
//      weights overwrite the scores and the row's correction
//      exp(m_old - m_new) is kept; meanwhile the V tile replaces K;
//   3. each thread rescales its up-to 8 x 8 register tile of the (bq, Dv)
//      accumulator by its rows' corrections and adds weights @ V.
// Its products are fp32 FMAs on the SIMT cores (fp32 never runs as
// TF32), one block per SM (~195 KB of shared memory at 128-wide tiles);
// expf, not __expf.
//
// "wgmma" (bf16 with D and Dv multiples of 16, at most 128): one block
// per (bh, 128 q rows): two consumer warpgroups of 64 rows and a
// producer warpgroup (hopper.cuh); block_q and block_k are not used.
// TMA brings the q tile once and the (128-key) K and V tiles through a
// ring of 2 stages, 128-byte swizzled, through 3-D tensor maps over
// (BH, S, D): keys past Skv arrive as zeros of this head, never as the
// next head's rows (a non-finite row there times a weight of 0 would
// be NaN). D and Dv are padded to 64 or 128 by the same zero fill. Per
// KV tile, each consumer:
//   1. S = q K^T by wgmma m64n128k16 (K-major B) into 64 fp32 registers
//      a thread. The scale multiplies S in fp32 (with log2 e, for exp2f),
//      not q: the two differ only by fp32 rounding;
//   2. the online softmax runs in registers on the accumulator layout:
//      four threads share a row, so the row max is a quad shuffle; the
//      masked keys are -inf and weigh exactly 0; l sums the fp32 p;
//   3. O = O * exp2(m_old - m_new) + P V by wgmma m64nDvk16 with P as
//      the register A operand and V as the MN-major B operand (transpose
//      flag). P goes in as two bf16 terms, P_hi = bf16(p) and P_lo =
//      bf16(p - P_hi), both products into the same fp32 O: one bf16 term
//      alone leaves the weights 2^-9 of a relative error, which breaks
//      the bf16 tolerance held against the fp32 softmax on ~1 % of the
//      outputs at whisper's and qwen3's shapes; the split costs 1.5x the
//      tensor work (6 D instead of 4 D per score).
// The output, O / max(l, 1e-30), is rounded to bf16 once. The two
// consumers walk their tiles one after the other, independently.
// Counting the split, their tensor work runs at ~90 % of the rate of
// PyTorch's scaled_dot_product_attention; the variants below did not
// beat that at qwen3-8b's prefill (PERF.md, the wgmma design steps):
// issuing a tile's scores ahead of the previous tile's P V, so that the
// softmax runs under the tensor cores inside one warpgroup (at 128 keys
// S, P and O do not fit the registers together and ptxas serialises the
// wgmma, 1.7-1.9x slower; at 64 keys, no spills, 1.02x slower); named-
// barrier turns between the two consumers (1.15x slower); a third ring
// stage (no gain).
//
// Bound on this card: operations (4 D flops per score at D = 64-128 over
// a few bytes per score), at the tensor-core rate for bf16 inputs, at
// the SIMT fp32 rate for fp32. The split alone caps the wgmma body at
// 2/3 of that bound.

#include "common.cuh"
#include "hopper.cuh"

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


// ------------------------------------------------ the wgmma body --
namespace wg {

using namespace hopper;

constexpr int kBQ = 128;                   // q rows of a block
constexpr int kBKV = 128;                  // keys of a KV tile
constexpr int kStages = 2;
constexpr int kConsumers = 2;              // warpgroups of 64 q rows
constexpr int kThreads = (kConsumers + 1) * kWarpgroup;
constexpr float kLog2e = 1.4426950408889634f;

// a (rows x 64) swizzled box of one 64-column block
__host__ __device__ constexpr int box_bytes(int rows) {
  return rows * kSwizzleBytes;
}

template <int DP, int DVP>     // D and Dv padded to 64 or 128
struct Tile {
  static constexpr int kQBytes = (DP / kBoxCols) * box_bytes(kBQ);
  static constexpr int kKBytes = (DP / kBoxCols) * box_bytes(kBKV);
  static constexpr int kVBytes = (DVP / kBoxCols) * box_bytes(kBKV);
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr size_t kSmem = kAtomBytes + kQBytes +
                                  static_cast<size_t>(kStages) * kStageBytes +
                                  sizeof(Ring<kStages>) + sizeof(uint64_t);
};

struct WShape {
  int bh, sq, skv, dv, causal;
  float scale_log2;    // D^-0.5 log2(e)
};

__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, WShape s,
                       __nv_bfloat16* __restrict__ out) {
  using T = Tile<DP, DVP>;
  extern __shared__ uint8_t raw[];
  uint8_t* q_s = align_atom(raw);
  uint8_t* kv_s = q_s + T::kQBytes;
  auto* ring = reinterpret_cast<Ring<kStages>*>(kv_s + kStages *
                                                T::kStageBytes);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + 1);

  // the heaviest q tiles of every head first
  const int q_tiles = (s.sq + kBQ - 1) / kBQ;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x / s.bh);
  const int bh = static_cast<int>(blockIdx.x % s.bh);
  const int q0 = qt * kBQ;
  const int rows = min(kBQ, s.sq - q0);
  const int kv_end = s.causal ? min(s.skv, q0 + rows) : s.skv;
  const int kv_tiles = (kv_end + kBKV - 1) / kBKV;
  const int group = threadIdx.x / kWarpgroup;
  if (threadIdx.x == 0) {
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    mbar_init(q_full, 1);
    ring->init(kConsumers * 4);
  }
  __syncthreads();

  if (group == kConsumers) {
    // the producer: one thread loads q once, then keeps the ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers * kWarpgroup) {
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int c = 0; c < DP / kBoxCols; ++c)
        tma_load_3d(q_s + c * box_bytes(kBQ), &qmap, q_full, c * kBoxCols,
                    q0, bh);
      RingPos pos;
      for (int t = 0; t < kv_tiles; ++t, pos.advance<kStages>()) {
        mbar_wait(&ring->empty[pos.stage], pos.phase ^ 1);
        uint8_t* kt = kv_s + pos.stage * T::kStageBytes;
        uint64_t* full = &ring->full[pos.stage];
        mbar_expect_tx(full, T::kStageBytes);
#pragma unroll
        for (int c = 0; c < DP / kBoxCols; ++c)
          tma_load_3d(kt + c * box_bytes(kBKV), &kmap, full, c * kBoxCols,
                      t * kBKV, bh);
#pragma unroll
        for (int c = 0; c < DVP / kBoxCols; ++c)
          tma_load_3d(kt + T::kKBytes + c * box_bytes(kBKV), &vmap, full,
                      c * kBoxCols, t * kBKV, bh);
      }
    }
  } else {
    // a consumer: q rows q0 + 64 group .. + 63
    setmaxnreg_inc<240>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int row_lo = q0 + 64 * group;           // the warpgroup's first
    const int row0 = row_lo + acc_row(0, lane, warp);   // rows row0, +8
    float o[DVP / 2];
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) o[i] = 0.0f;
    float m_run[2] = {-1e30f, -1e30f};   // the empty max (NEG_INF), log2
    float l_run[2] = {0.0f, 0.0f};       // this thread's share of l
    mbar_wait(q_full, 0);
    const uint64_t dq = desc_sw128(q_s + group * 64 * kSwizzleBytes, 16,
                                   kAtomBytes);
    RingPos pos;
    for (int t = 0; t < kv_tiles; ++t, pos.advance<kStages>()) {
      const int k0 = t * kBKV;
      float sc[kBKV / 2];
#pragma unroll
      for (int i = 0; i < kBKV / 2; ++i) sc[i] = 0.0f;
      mbar_wait(&ring->full[pos.stage], pos.phase);
      const uint8_t* kt = kv_s + pos.stage * T::kStageBytes;
      // 1. S = q K^T: D / 16 steps of 32 bytes, 64 columns a box
      const uint64_t dk = desc_sw128(kt, 16, kAtomBytes);
      wgmma_fence();
      fence_regs(sc);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint64_t box = (kk / 4) * (box_bytes(kBQ) >> 4);
        const uint64_t kbox = (kk / 4) * (box_bytes(kBKV) >> 4);
        wgmma_m64n128k16_ss<0>(sc, dq + box + 2 * (kk % 4),
                               dk + kbox + 2 * (kk % 4));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      // 2. the online softmax step, in the log2 domain
      const bool masked = k0 + kBKV > s.skv ||
                          (s.causal && k0 + kBKV - 1 > row_lo);
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < kBKV / 2; ++i) {
        float x = sc[i] * s.scale_log2;
        if (masked) {
          const int key = k0 + acc_col(i, lane);
          const int row = row0 + 8 * ((i >> 1) & 1);
          if (key >= s.skv || (s.causal && key > row)) x = -pos_inf();
        }
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f(m_run[h] - mx[h]);
        m_run[h] = mx[h];
      }
      uint32_t p_hi[kBKV / 4], p_lo[kBKV / 4];
#pragma unroll
      for (int i = 0; i < kBKV / 2; i += 2) {
        const int h = (i >> 1) & 1;
        const float p0 = exp2f(sc[i] - mx[h]);
        const float p1 = exp2f(sc[i + 1] - mx[h]);
        sum[h] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 back = __bfloat1622float2(hi);
        p_hi[i / 2] = bf16_pair(hi);
        p_lo[i / 2] = bf16_pair(__floats2bfloat162_rn(p0 - back.x,
                                                      p1 - back.y));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + sum[h];
#pragma unroll
      for (int i = 0; i < DVP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      // 3. O += P_hi V + P_lo V: 16 keys (2048 bytes of V) a step
      const uint64_t dv = desc_sw128(kt + T::kKBytes, box_bytes(kBKV),
                                     kAtomBytes);
      wgmma_fence();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        const uint32_t hi[4] = {p_hi[4 * kk], p_hi[4 * kk + 1],
                                p_hi[4 * kk + 2], p_hi[4 * kk + 3]};
        const uint32_t lo[4] = {p_lo[4 * kk], p_lo[4 * kk + 1],
                                p_lo[4 * kk + 2], p_lo[4 * kk + 3]};
        if constexpr (DVP == 128) {
          wgmma_m64n128k16_rs<1>(o, hi, dv + 128 * kk);
          wgmma_m64n128k16_rs<1>(o, lo, dv + 128 * kk);
        } else {
          wgmma_m64n64k16_rs<1>(o, hi, dv + 128 * kk);
          wgmma_m64n64k16_rs<1>(o, lo, dv + 128 * kk);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&ring->empty[pos.stage]);
    }
    float denom[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      denom[h] = fmaxf(l, 1e-30f);
    }
    const size_t head = static_cast<size_t>(bh) * s.sq;
#pragma unroll
    for (int i = 0; i < DVP / 2; i += 2) {
      const int h = (i >> 1) & 1;
      const int row = row0 + 8 * h;
      const int col = acc_col(i, lane);
      // dv is a multiple of 16, so a pair is wholly inside or outside
      if (row < s.sq && col < s.dv)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (head + row) * s.dv + col) =
            __floats2bfloat162_rn(__fdiv_rn(o[i], denom[h]),
                                  __fdiv_rn(o[i + 1], denom[h]));
    }
  }
}

template <int DP, int DVP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int sq, int skv, int d, int dv, int causal,
                   float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  const uint32_t qbox[3] = {kBoxCols, kBQ, 1};
  const uint32_t kvbox[3] = {kBoxCols, kBKV, 1};
  const uint64_t qdims[3] = {static_cast<uint64_t>(d),
                             static_cast<uint64_t>(sq),
                             static_cast<uint64_t>(bh)};
  const uint64_t qpitch[2] = {static_cast<uint64_t>(d) * 2,
                              static_cast<uint64_t>(sq) * d * 2};
  const uint64_t kdims[3] = {static_cast<uint64_t>(d),
                             static_cast<uint64_t>(skv),
                             static_cast<uint64_t>(bh)};
  const uint64_t kpitch[2] = {static_cast<uint64_t>(d) * 2,
                              static_cast<uint64_t>(skv) * d * 2};
  const uint64_t vdims[3] = {static_cast<uint64_t>(dv),
                             static_cast<uint64_t>(skv),
                             static_cast<uint64_t>(bh)};
  const uint64_t vpitch[2] = {static_cast<uint64_t>(dv) * 2,
                              static_cast<uint64_t>(skv) * dv * 2};
  cudaError_t err = bf16_map(&qmap, q, 3, qdims, qpitch, qbox);
  if (err == cudaSuccess) err = bf16_map(&kmap, k, 3, kdims, kpitch, kvbox);
  if (err == cudaSuccess) err = bf16_map(&vmap, v, 3, vdims, vpitch, kvbox);
  if (err != cudaSuccess) return err;
  auto kernel = attention_wgmma_kernel<DP, DVP>;
  const size_t smem = Tile<DP, DVP>::kSmem;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(bh) * ((sq + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const WShape s{bh, sq, skv, dv, causal ? 1 : 0, scale * kLog2e};
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      qmap, kmap, vmap, s, static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}

size_t smem_bytes(int d, int dv) {
  const bool d64 = d <= 64, dv64 = dv <= 64;
  return d64 ? (dv64 ? Tile<64, 64>::kSmem : Tile<64, 128>::kSmem)
             : (dv64 ? Tile<128, 64>::kSmem : Tile<128, 128>::kSmem);
}

}  // namespace wg

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

// The tensor-core body: q (bh, sq, d), k (bh, skv, d), v (bh, skv, dv),
// out (bh, sq, dv), contiguous bf16, 16-byte aligned, d and dv
// multiples of 16 and at most 128. Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for what it does not
// take (a size or alignment, more blocks than a grid holds, or more
// shared memory than the device's opt-in limit).
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, int bh, int sq,
                                           int skv, int d, int dv,
                                           int causal, float scale,
                                           void* out, void* stream) {
  using namespace repro::wg;
  if (bh < 1 || sq < 1 || skv < 1 || d < 16 || dv < 16 || d > 128 ||
      dv > 128 || d % 16 != 0 || dv % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int limit = repro_smem_optin_limit();
  if (limit < 0) return -limit;
  if (smem_bytes(d, dv) > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d64 = d <= 64, dv64 = dv <= 64;
  cudaError_t err;
  if (d64 && dv64)
    err = launch<64, 64>(q, k, v, out, bh, sq, skv, d, dv, causal, scale, st);
  else if (d64)
    err = launch<64, 128>(q, k, v, out, bh, sq, skv, d, dv, causal, scale, st);
  else if (dv64)
    err = launch<128, 64>(q, k, v, out, bh, sq, skv, d, dv, causal, scale, st);
  else
    err = launch<128, 128>(q, k, v, out, bh, sq, skv, d, dv, causal, scale,
                           st);
  return static_cast<int>(err);
}
