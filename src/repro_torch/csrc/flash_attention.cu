// Blocked online-softmax attention (forward), for Hopper.
//
//   out[b, i] = sum_j softmax_j(scale * q[b, i] . k[b, j]) v[b, j]
//
// over the keys j the mask allows: every j < Skv, and under `causal` the
// top-left mask j <= i. q, k, v are fp32 or bf16, scale = D^-0.5, the
// running max m, denominator l and accumulator are fp32, the result is
// acc / max(l, 1e-30) in q's dtype. Asked for (a training forward), each
// body also writes the row log-sum-exp lse2 = m + log2(l), fp32, in its
// own log2 domain (the scores times D^-0.5 log2(e)): the backward
// (flash_attention_bwd.cu) recomputes P from it instead of walking the
// keys again. Not asked for, nothing else is written and the output's
// bits are the same.
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
// take): one 128-thread block per (bh, 64 q rows), KV tiles of 64 keys;
// block_q and block_k are not used. D and Dv are padded to one
// compile-time width E (32, 64 or 128; the padded columns staged as
// zeros), so every register-tile loop unrolls. q, K and V are staged
// row-major in fp32 (rows padded by 4 words: the 8 rows a quarter-warp
// reads sit in 8 different bank groups) by cp.async (simt.cuh), 16
// bytes a copy where D and Dv are multiples of 4 and the pointers
// 16-byte aligned, through two stages: K and V of the next tile arrive
// while this tile computes. Thread tid = 8 ty + tx owns rows
// 4 ty .. 4 ty + 3 and keys tx + 8 j (j < 8) of the (64, 64) scores, and
// the same rows and columns 4 tx + 32 c .. + 3 of the (64, E) output.
// Per KV tile (one __syncthreads, for the stages):
//   1. S = q K^T: each thread reads its rows 4 columns at a time
//      (16-byte shared loads along D), then one key's 4 columns at a
//      time, into a 4 x 8 register tile;
//   2. the online softmax in registers, in the log2 domain: the scores
//      times D^-0.5 log2(e) (one fp32 rounding more than the reference's
//      scale, then exp2f), masked keys -inf; a row's 8 threads are
//      neighbouring lanes, so its max is three xor shuffles (max_nan: a
//      NaN score propagates). m lives in registers, each thread keeps
//      its share of l (summed over the row's lanes at the end), and the
//      output tile is rescaled by exp2(m_old - m_new);
//   3. P goes to shared memory once, transposed (key-major, one 16-byte
//      store per key), and O += P V reads it and V 16 bytes at a time.
//      A warp's 16 rows of P are written and read by that warp alone,
//      so a __syncwarp orders them.
// Every product is a plain fp32 FMA on the SIMT cores (fp32 never runs
// as TF32). At E = 64 a block takes 104 KB of shared memory and up to
// 255 registers a thread, two blocks an SM, no spills; three blocks
// under 168 registers spilled 160 bytes and read 1.23x slower
// (PERF.md, the design steps). E = 128 takes 186 KB, one block.
//
// "wgmma" (bf16 with D and Dv multiples of 16, D at most 192 and Dv at
// most 128): one block per (bh, 128 q rows): two consumer warpgroups of
// 64 rows and a producer warpgroup (hopper.cuh); block_q and block_k are
// not used.
// TMA brings the q tile once and the (128-key) K and V tiles through a
// ring of 2 stages, 128-byte swizzled, through 3-D tensor maps over
// (BH, S, D): keys past Skv arrive as zeros of this head, never as the
// next head's rows (a non-finite row there times a weight of 0 would
// be NaN). D is padded to 64, 128 or 192 (one to three 64-column boxes)
// and Dv to 64 or 128 by the same zero fill. D = 192 with Dv = 128 is
// MLA's prefill (deepseek-v2: q = [q_nope ; q_rope] of 128 + 64, v of
// 128), whose scale (nope + rope)^-0.5 is D^-0.5: its tile takes 1 KB of
// alignment slack + q 48 KB + 2 stages x (K 48 KB + V 32 KB) = 209 KB,
// under the 227 KB opt-in limit (checked against the device's, as every
// instance is). Per KV tile, each consumer:
//   1. S = q K^T by wgmma m64n128k16 (K-major B) into 64 fp32 registers
//      a thread, D / 16 k16 steps, four a 64-column box (the registers
//      do not grow with D). The scale multiplies S in fp32 (with log2 e,
//      for exp2f), not q: the two differ only by fp32 rounding;
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
// Bound on this card: operations (4 D flops per score at D = 64-192 over
// a few bytes per score), at the tensor-core rate for bf16 inputs, at
// the SIMT fp32 rate for fp32. The split alone caps the wgmma body at
// 2/3 of that bound.

#include "common.cuh"
#include "hopper.cuh"
#include "simt.cuh"

namespace repro {
namespace {

constexpr float kNegInf = -1e30f;         // the empty max (NEG_INF)
constexpr float kTiny = 1e-30f;           // the denominator floor
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || is_nan(b)) ? b : a;
}

// ------------------------------------------------- the SIMT body --
namespace sm {

using namespace simt;

constexpr int kBQ = 64;             // q rows of a block
constexpr int kBK = 64;             // keys of a KV tile
constexpr int kTX = 8;              // threads sharing a row
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;    // 4 consecutive rows a thread
constexpr int kKeys = kBK / kTX;    // 8 keys a thread, tx + 8 j
constexpr int kPPitch = kBQ + 4;    // P^T, (key, row)

template <int E>                    // D and Dv padded to E
struct Tile {
  static constexpr int kPitch = E + 4;     // q (row, d), K (key, d), V
  static constexpr int kQ = kBQ * kPitch;
  static constexpr int kKV = kBK * kPitch;
  static constexpr size_t kSmem =
      sizeof(float) * (kQ + 4 * kKV + kBK * kPPitch);
  static constexpr int kBlocksPerSm = E <= 64 ? 2 : 1;
};

struct Shape {
  int bh, sq, skv, d, dv, causal, vec;
  float scale_log2;    // D^-0.5 log2(e)
};

template <typename T, int E>
__global__ void __launch_bounds__(kThreads, Tile<E>::kBlocksPerSm)
attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      float* __restrict__ lse2, Shape s) {
  using L = Tile<E>;
  constexpr int kCols = E / kTX;   // output columns a thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kv = qs + L::kQ;      // K then V of stage 0, of stage 1
  float* ps = kv + 4 * L::kKV;

  // the heaviest q tiles of every head first
  const int q_tiles = (s.sq + kBQ - 1) / kBQ;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x / s.bh);
  const int bh = static_cast<int>(blockIdx.x % s.bh);
  const int q0 = qt * kBQ;
  const int rows = min(kBQ, s.sq - q0);
  const int kv_end = s.causal ? min(s.skv, q0 + rows) : s.skv;
  const int tiles = (kv_end + kBK - 1) / kBK;
  const T* kb = k + static_cast<size_t>(bh) * s.skv * s.d;
  const T* vb = v + static_cast<size_t>(bh) * s.skv * s.dv;
  const int tid = threadIdx.x, tx = tid % kTX;
  const int r0 = tid / kTX * kRows;     // this thread's first row
  const bool vec = s.vec != 0;

  stage_tile<kBQ, E, kThreads>(
      qs, L::kPitch, q + (static_cast<size_t>(bh) * s.sq + q0) * s.d, s.d,
      rows, s.d, vec, tid);
  stage_tile<kBK, E, kThreads>(kv, L::kPitch, kb, s.d, s.skv, s.d, vec,
                               tid);
  stage_tile<kBK, E, kThreads>(kv + L::kKV, L::kPitch, vb, s.dv, s.skv,
                               s.dv, vec, tid);
  cp_async_commit();

  float o[kRows][kCols], m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.0f;
  }

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kBK;
    const float* ks = kv + (t % 2) * 2 * L::kKV;
    const float* vs = ks + L::kKV;
    cp_async_wait<0>();   // K and V of this tile (and q) have landed
    __syncthreads();      // ... for every thread; the other stage is free
    if (t + 1 < tiles) {
      float* next = kv + (t + 1) % 2 * 2 * L::kKV;
      const size_t row = static_cast<size_t>(k0 + kBK);
      stage_tile<kBK, E, kThreads>(next, L::kPitch, kb + row * s.d, s.d,
                                   s.skv - k0 - kBK, s.d, vec, tid);
      stage_tile<kBK, E, kThreads>(next + L::kKV, L::kPitch,
                                   vb + row * s.dv, s.dv, s.skv - k0 - kBK,
                                   s.dv, vec, tid);
      cp_async_commit();
    }

    // 1. S = q K^T
    float sc[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sc[i][j] = 0.0f;
#pragma unroll
    for (int c = 0; c < E; c += 4) {
      float4 a[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (r0 + i) * L::kPitch +
                                                c);
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(
            ks + (tx + kTX * j) * L::kPitch + c);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          sc[i][j] = fmaf(a[i].x, b.x, sc[i][j]);
          sc[i][j] = fmaf(a[i].y, b.y, sc[i][j]);
          sc[i][j] = fmaf(a[i].z, b.z, sc[i][j]);
          sc[i][j] = fmaf(a[i].w, b.w, sc[i][j]);
        }
      }
    }

    // 2. the online softmax step, in the log2 domain
    const bool edge =
        k0 + kBK > s.skv || (s.causal && k0 + kBK - 1 > q0 + r0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        float x = sc[i][j] * s.scale_log2;
        if (edge) {
          const int key = k0 + tx + kTX * j;
          if (key >= s.skv || (s.causal && key > q0 + r0 + i))
            x = -pos_inf();
        }
        sc[i][j] = x;
        mx = max_nan(mx, x);
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1)
        mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        sc[i][j] = exp2f(sc[i][j] - mx);
        sum += sc[i][j];
      }
      l[i] = fmaf(l[i], corr, sum);
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j)
      *reinterpret_cast<float4*>(ps + (tx + kTX * j) * kPPitch + r0) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncwarp();         // a warp's P^T rows are its own

    // 3. O += P V
#pragma unroll
    for (int key = 0; key < kBK; ++key) {
      const float4 p =
          *reinterpret_cast<const float4*>(ps + key * kPPitch + r0);
      const float pr[kRows] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < kCols; c += 4) {
        const float4 w = *reinterpret_cast<const float4*>(
            vs + key * L::kPitch + tx * 4 + kTX * c);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          o[i][c] = fmaf(pr[i], w.x, o[i][c]);
          o[i][c + 1] = fmaf(pr[i], w.y, o[i][c + 1]);
          o[i][c + 2] = fmaf(pr[i], w.z, o[i][c + 2]);
          o[i][c + 3] = fmaf(pr[i], w.w, o[i][c + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int off = 1; off < kTX; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    // the row log-sum-exp for the backward, in the log2 domain
    if (lse2 != nullptr && tx == 0 && r0 + i < rows)
      lse2[static_cast<size_t>(bh) * s.sq + q0 + r0 + i] =
          m[i] + log2f(l[i]);
  }
  T* ob = out + (static_cast<size_t>(bh) * s.sq + q0) * s.dv;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (r0 + i >= rows) continue;
    const float denom = (l[i] > kTiny || is_nan(l[i])) ? l[i] : kTiny;
#pragma unroll
    for (int c = 0; c < kCols; c += 4) {
      const int col = tx * 4 + kTX * c;
      if (col >= s.dv) continue;
      const float r[4] = {
          __fdiv_rn(o[i][c], denom), __fdiv_rn(o[i][c + 1], denom),
          __fdiv_rn(o[i][c + 2], denom), __fdiv_rn(o[i][c + 3], denom)};
      store4(ob + static_cast<size_t>(r0 + i) * s.dv + col, r,
             s.dv - col, vec);
    }
  }
}

template <typename T, int E>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse2, const Shape& s, cudaStream_t stream) {
  auto kernel = attention_simt_kernel<T, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile<E>::kSmem));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(s.bh) * ((s.sq + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, Tile<E>::kSmem,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<T*>(out), lse2,
                     s);
  return cudaGetLastError();
}

// the width E that D and Dv are padded to
inline int padded_width(int d, int dv) {
  const int w = d > dv ? d : dv;
  return w <= 32 ? 32 : w <= 64 ? 64 : 128;
}

size_t smem_bytes(int d, int dv) {
  const int e = padded_width(d, dv);
  return e == 32 ? Tile<32>::kSmem
                 : e == 64 ? Tile<64>::kSmem : Tile<128>::kSmem;
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, float* lse2, const Shape& s,
                         cudaStream_t stream) {
  switch (padded_width(s.d, s.dv)) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse2, s, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse2, s, stream);
    default:
      return launch<T, 128>(q, k, v, out, lse2, s, stream);
  }
}

}  // namespace sm


// ------------------------------------------------ the wgmma body --
namespace wg {

using namespace hopper;

constexpr int kBQ = 128;                   // q rows of a block
constexpr int kBKV = 128;                  // keys of a KV tile
constexpr int kStages = 2;
constexpr int kConsumers = 2;              // warpgroups of 64 q rows
constexpr int kThreads = (kConsumers + 1) * kWarpgroup;

// a (rows x 64) swizzled box of one 64-column block
__host__ __device__ constexpr int box_bytes(int rows) {
  return rows * kSwizzleBytes;
}

template <int DP, int DVP>     // D padded to 64/128/192, Dv to 64/128
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
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse2) {
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
    const size_t head = static_cast<size_t>(bh) * s.sq;
    float denom[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      denom[h] = fmaxf(l, 1e-30f);
      // the row log-sum-exp for the backward, in the log2 domain
      const int row = row0 + 8 * h;
      if (lse2 != nullptr && lane % 4 == 0 && row < s.sq)
        lse2[head + row] = m_run[h] + log2f(l);
    }
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
                   float* lse2, int bh, int sq, int skv, int d, int dv,
                   int causal, float scale, cudaStream_t stream) {
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
      qmap, kmap, vmap, s, static_cast<__nv_bfloat16*>(out), lse2);
  return cudaGetLastError();
}

constexpr int kMaxD = 192;                 // three 64-column boxes
constexpr int kMaxDv = 128;

// the widths D and Dv are padded to
inline int padded_d(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 192; }
inline int padded_dv(int dv) { return dv <= 64 ? 64 : 128; }

template <int DP>
size_t smem_for(int dvp) {
  return dvp == 64 ? Tile<DP, 64>::kSmem : Tile<DP, 128>::kSmem;
}

size_t smem_bytes(int d, int dv) {
  const int dp = padded_d(d), dvp = padded_dv(dv);
  return dp == 64 ? smem_for<64>(dvp)
                  : dp == 128 ? smem_for<128>(dvp) : smem_for<192>(dvp);
}

template <int DP>
cudaError_t launch_for(int dvp, const void* q, const void* k, const void* v,
                       void* out, float* lse2, int bh, int sq, int skv, int d,
                       int dv, int causal, float scale, cudaStream_t stream) {
  return dvp == 64
             ? launch<DP, 64>(q, k, v, out, lse2, bh, sq, skv, d, dv, causal,
                              scale, stream)
             : launch<DP, 128>(q, k, v, out, lse2, bh, sq, skv, d, dv, causal,
                               scale, stream);
}

}  // namespace wg

// The opt-in shared memory a block may use on the current device, or a
// negative CUDA error code.
int smem_optin_limit() {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? limit : -static_cast<int>(err);
}

}  // namespace
}  // namespace repro

// The SIMT body: q (bh, sq, d), k (bh, skv, d), v (bh, skv, dv), out
// (bh, sq, dv), all contiguous in the storage type `dtype` (fp32 or
// bf16), d and dv at most 128; block_q/block_k (1 to 128) are checked
// and do not change the launch. lse2, null or (bh, sq) fp32, takes each
// row's log-sum-exp m + log2(l) in the log2 domain of the scores times
// scale log2(e), for the backward; null writes nothing else and leaves
// the output's bits as they are. Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for another dtype, a
// size out of range, more blocks than a grid holds, or more shared
// memory than the device's opt-in limit.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, int dtype, int bh, int sq,
                                     int skv, int d, int dv, int block_q,
                                     int block_k, int causal, float scale,
                                     void* out, void* lse2, void* stream) {
  using namespace repro;
  if (bh < 1 || sq < 1 || skv < 1 || d < 1 || dv < 1 || d > 128 ||
      dv > 128 || block_q < 1 || block_k < 1 || block_q > 128 ||
      block_k > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int limit = smem_optin_limit();
  if (limit < 0) return -limit;
  if (sm::smem_bytes(d, dv) > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = d % 4 == 0 && dv % 4 == 0 && aligned(q) && aligned(k) &&
                  aligned(v) && aligned(out);
  const sm::Shape s{bh, sq, skv, d, dv, causal ? 1 : 0, vec,
                    scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse2);
  switch (dtype) {
    case kF32:
      return static_cast<int>(
          sm::launch_typed<float>(q, k, v, out, l, s, st));
    case kBF16:
      return static_cast<int>(
          sm::launch_typed<__nv_bfloat16>(q, k, v, out, l, s, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tensor-core body: q (bh, sq, d), k (bh, skv, d), v (bh, skv, dv),
// out (bh, sq, dv), contiguous bf16, 16-byte aligned, d and dv
// multiples of 16, d at most 192 and dv at most 128; lse2 as the SIMT
// body's. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for what it does not take (a size or alignment,
// more blocks than a grid holds, or more shared memory than the device's
// opt-in limit).
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, int bh, int sq,
                                           int skv, int d, int dv,
                                           int causal, float scale,
                                           void* out, void* lse2,
                                           void* stream) {
  using namespace repro::wg;
  if (bh < 1 || sq < 1 || skv < 1 || d < 16 || dv < 16 || d > kMaxD ||
      dv > kMaxDv || d % 16 != 0 || dv % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int limit = repro::smem_optin_limit();
  if (limit < 0) return -limit;
  if (smem_bytes(d, dv) > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse2);
  const int dp = padded_d(d), dvp = padded_dv(dv);
  cudaError_t err;
  if (dp == 64)
    err = launch_for<64>(dvp, q, k, v, out, l, bh, sq, skv, d, dv, causal,
                         scale, st);
  else if (dp == 128)
    err = launch_for<128>(dvp, q, k, v, out, l, bh, sq, skv, d, dv, causal,
                          scale, st);
  else
    err = launch_for<192>(dvp, q, k, v, out, l, bh, sq, skv, d, dv, causal,
                          scale, st);
  return static_cast<int>(err);
}
