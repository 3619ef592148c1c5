// Tensor-core body of the attention backward (flash_attention_bwd.cu),
// for Hopper: bf16 q, k, v and dO with D and Dv multiples of 16, D at
// most 192 and Dv at most 128.
//
// The gradients (flash_attention_bwd.cu gives the formulas) come from
// the row log-sum-exp lse2 (fp32, the log2 domain of the scores times
// D^-0.5 log2(e)), which the forward writes, and delta = dO . o, which
// the backward's first launch writes. Two launches here, each a block of
// two warpgroups (hopper.cuh: TMA 3-D tensor maps over (BH, S, D) with
// per-head zero fill, the mbarrier ring, wgmma). There is no producer
// warp: ptxas compiles a kernel within 65536 / (threads rounded up to
// 4 warps) registers a thread, whatever setmaxnreg hands a warpgroup at
// run time, so a producer warp or warpgroup (384 threads: 168) spilled
// the dK/dV accumulators and serialized their wgmma; 256 threads get
// 255. The first warpgroup fills the ring instead: a ring of 3 stages
// runs 2 tiles ahead, and at the end of tile t it refills the stage
// tile t - 1 left (both warpgroups released it by then) with tile t + 2.
//
//   dK/dV, one block a (bh, 128 keys), each warpgroup 64 of them: K and
//     V arrive once; the q and dO tiles of BQ rows (with their lse2 and
//     delta, which the first warpgroup's threads load a tile early and
//     copy beside them) stream through the ring. With the keys as the M
//     dimension, each tile:
//       S^T = K q^T and dP^T = V dO^T   (wgmma m64nBQk16, both operands
//                                        K-major from shared memory)
//       P^T = exp2(S^T D^-0.5 log2(e) - lse2),  dS^T = P^T (dP^T - delta)
//                                       (in registers, the accumulator
//                                        layout, masked pairs 0)
//       dV += P^T dO,  dK += dS^T q     (P^T and dS^T as the bf16
//                                        register A operand, dO and q as
//                                        MN-major B operands)
//     so neither P nor dS goes through shared memory.
//   dQ, one block a (bh, 128 q rows), each warpgroup 64 of them: q and
//     dO arrive once, the K and V tiles of 64 keys stream through the
//     ring (thread 0 fills it):
//       S = q K^T, dP = dO V^T, P and dS in registers as above,
//       dQ += dS K                      (K as the MN-major B operand).
//     It recomputes S and dP rather than adding dQ atomically across the
//     key tiles' blocks (as FlashAttention-2 and 3 do): every sum runs in
//     a fixed order in one thread's accumulator, with no float atomics,
//     so a second launch is bit for bit the first. The cost: 8 D + 6 Dv
//     flops a (row, key) pair against the 6 D + 4 Dv of the least work.
//
// BQ, the q rows of a dK/dV ring stage, keeps the fp32 accumulators
// (dK D/2, dV Dv/2, S^T and dP^T BQ/2 each a thread) at most 192 of the
// 255 registers: 64, and 32 at D = 192 with Dv = 128 (MLA). The larger
// N the better: S^T's A operand (K, V) is read from shared memory again
// for every q tile. D = 192
// runs its dK and dQ products as an n128 and an n64 wgmma (hopper.cuh
// has no n192 wrapper); the accumulator layout concatenates, so acc_col
// holds over all of it.
//
// Causal (top-left: key j <= row i): tiles wholly masked for a
// warpgroup are skipped (the warpgroup still passes through the ring),
// the diagonal tiles are masked in registers, and the heaviest tiles go
// first (the first key tiles, the last q tiles). Rows past Sq and keys
// past Skv arrive as zeros of this head, are masked to P = 0 and are
// never written.
//
// Precision: S and dP accumulate bf16 products in fp32; P and dS are
// computed in fp32 and rounded to bf16 once, as the A operands of the
// next products, which accumulate in fp32; each output is rounded to
// bf16 once (dK and dQ after the scale D^-0.5). Held to 2^-7 of each
// gradient's scale against the fp32 plain version (chip_smoke.BWD_TOL).
//
// Bound on this card: operations at the tensor-core rate
// (kernels/_cost.py, attention_bwd_work: 2 (3 D + 2 Dv) flops a pair).

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {
namespace bwg {

using namespace hopper;

constexpr int kStages = 3;
constexpr int kAhead = kStages - 1;            // tiles in flight ahead
constexpr int kConsumers = 2;                  // warpgroups of 64 rows
constexpr int kThreads = kConsumers * kWarpgroup;
constexpr int kBlockRows = kConsumers * 64;    // keys (dK/dV), rows (dQ)
constexpr int kBK = 64;                        // keys of a dQ ring stage
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int box_bytes(int rows) {
  return rows * kSwizzleBytes;
}

// the q rows of a dK/dV ring stage (see the note above)
__host__ __device__ constexpr int stage_rows(int dp, int dvp) {
  return dp + dvp <= 256 ? 64 : 32;
}

template <int DP, int DVP>
struct KVTile {
  static constexpr int kBQ = stage_rows(DP, DVP);
  static constexpr int kKBytes = (DP / kBoxCols) * box_bytes(kBlockRows);
  static constexpr int kVBytes = (DVP / kBoxCols) * box_bytes(kBlockRows);
  static constexpr int kQBytes = (DP / kBoxCols) * box_bytes(kBQ);
  static constexpr int kOBytes = (DVP / kBoxCols) * box_bytes(kBQ);
  static constexpr int kStageBytes = kQBytes + kOBytes;
  static constexpr size_t kSmem =
      kAtomBytes + kKBytes + kVBytes +
      static_cast<size_t>(kStages) * kStageBytes +
      sizeof(float) * kStages * 2 * kBQ + sizeof(Ring<kStages>) +
      sizeof(uint64_t);
};

template <int DP, int DVP>
struct QTile {
  static constexpr int kQBytes = (DP / kBoxCols) * box_bytes(kBlockRows);
  static constexpr int kOBytes = (DVP / kBoxCols) * box_bytes(kBlockRows);
  static constexpr int kKBytes = (DP / kBoxCols) * box_bytes(kBK);
  static constexpr int kVBytes = (DVP / kBoxCols) * box_bytes(kBK);
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr size_t kSmem =
      kAtomBytes + kQBytes + kOBytes +
      static_cast<size_t>(kStages) * kStageBytes + sizeof(Ring<kStages>) +
      sizeof(uint64_t);
};

struct Shape {
  int bh, sq, skv, d, dv, causal;
  float scale;         // D^-0.5
  float scale_log2;    // D^-0.5 log2(e)
};

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (m64 x nN) += A (smem) B (smem), both K-major
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b) {
  if constexpr (N == 32) {
    wgmma_m64n32k16_ss<0>(d, a, b);
  } else if constexpr (N == 64) {
    wgmma_m64n64k16_ss<0>(d, a, b);
  } else {
    static_assert(N == 128, "N is 32, 64 or 128");
    wgmma_m64n128k16_ss<0>(d, a, b);
  }
}

// D (m64 x nN) += A (registers) B (smem, MN-major); `box` is the
// descriptor distance of one 64-column box of B, for N = 192's n64 part
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       uint64_t box) {
  if constexpr (N == 64) {
    wgmma_m64n64k16_rs<1>(d, a, b);
  } else if constexpr (N == 128) {
    wgmma_m64n128k16_rs<1>(d, a, b);
  } else {
    static_assert(N == 192, "N is 64, 128 or 192");
    wgmma_m64n128k16_rs<1>(*reinterpret_cast<float(*)[64]>(d), a, b);
    wgmma_m64n64k16_rs<1>(*reinterpret_cast<float(*)[32]>(d + 64), a,
                          b + 2 * box);
  }
}

// acc (m64 x nN) = A B over W (padded) columns of two K-major tiles: A's
// 64 rows at `a` inside boxes of `a_rows` rows, B's N rows at `b` inside
// boxes of N rows; 64 columns a box, a k16 step 32 bytes
template <int N, int W>
__device__ __forceinline__ void scores(float (&acc)[N / 2], const uint8_t* a,
                                       int a_rows, const uint8_t* b) {
  const uint64_t da = desc_sw128(a, 16, kAtomBytes);
  const uint64_t db = desc_sw128(b, 16, kAtomBytes);
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const uint64_t abox = (kk / 4) * (box_bytes(a_rows) >> 4);
    const uint64_t bbox = (kk / 4) * (box_bytes(N) >> 4);
    mma_ss<N>(acc, da + abox + 2 * (kk % 4), db + bbox + 2 * (kk % 4));
  }
}

// acc (m64 x nN) += A (registers: a[4 kk .. 4 kk + 3], k16 step kk) B,
// B the MN-major tile at `b` of K rows in boxes of K rows; a k16 step
// advances 16 rows (2048 bytes)
template <int N, int K>
__device__ __forceinline__ void accumulate(float (&acc)[N / 2],
                                           const uint32_t (&a)[K / 4],
                                           const uint8_t* b) {
  const uint64_t db = desc_sw128(b, box_bytes(K), kAtomBytes);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
    mma_rs<N>(acc, ak, db + 128 * kk, box_bytes(K) >> 4);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

// rows (or keys) `first + acc_row` of a (bh, S, W) bf16 output from an
// m64 x nWP accumulator, times `scale`; rows past `rows` and columns
// past W are not written (W is a multiple of 16: a pair is wholly in or
// out)
template <int WP>
__device__ __forceinline__ void store(__nv_bfloat16* out, size_t head_row,
                                      int row0, int rows, int w,
                                      const float (&acc)[WP / 2],
                                      float scale, int lane) {
#pragma unroll
  for (int i = 0; i < WP / 2; i += 2) {
    const int row = row0 + 8 * ((i >> 1) & 1);
    const int col = acc_col(i, lane);
    if (row < rows && col < w)
      *reinterpret_cast<__nv_bfloat162*>(
          out + (head_row + row) * static_cast<size_t>(w) + col) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
  }
}

// The rows of tile t that a producing thread of the first warpgroup
// copies beside the stage's TMA tiles: thread i < BQ the lse2 of row
// q0 + i, thread BQ + i its delta (0 past Sq)
template <int BQ>
__device__ __forceinline__ float row_value(const float* __restrict__ lse2,
                                           const float* __restrict__ delta,
                                           size_t head, int sq, int t,
                                           int tid) {
  if (tid >= 2 * BQ) return 0.0f;
  const int row = t * BQ + (tid < BQ ? tid : tid - BQ);
  if (row >= sq) return 0.0f;
  return tid < BQ ? lse2[head + row] : delta[head + row];
}

// dK and dV of one (bh, 128 keys)
template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap omap,
                  const float* __restrict__ lse2,
                  const float* __restrict__ delta, Shape s,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv) {
  using T = KVTile<DP, DVP>;
  constexpr int BQ = T::kBQ;
  extern __shared__ uint8_t raw[];
  uint8_t* k_s = align_atom(raw);
  uint8_t* v_s = k_s + T::kKBytes;
  uint8_t* stages = v_s + T::kVBytes;          // q then dO, each stage
  float* rows_s = reinterpret_cast<float*>(stages + kStages * T::kStageBytes);
  auto* ring = reinterpret_cast<Ring<kStages>*>(rows_s + kStages * 2 * BQ);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ring + 1);

  // under `causal` the first key tiles see the most q tiles: issue them
  // first; q tiles before the key tile hold no allowed pair
  const int k0 = static_cast<int>(blockIdx.x / s.bh) * kBlockRows;
  const int bh = static_cast<int>(blockIdx.x % s.bh);
  const int q_tiles = (s.sq + BQ - 1) / BQ;
  const int t_begin = s.causal ? k0 / BQ : 0;
  const int tid = threadIdx.x;
  const int group = tid / kWarpgroup;
  const int lane = tid % 32, warp = (tid / 32) % 4;
  const size_t q_head = static_cast<size_t>(bh) * s.sq;
  if (tid == 0) {
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&omap);
    mbar_init(kv_full, 1);
    ring->init(kConsumers * 4, kWarpgroup);
  }
  __syncthreads();

  // the first warpgroup also fills the ring: tile t into the next stage
  // once both warpgroups have released it, its rows by every thread,
  // the q and dO tiles by TMA from thread 0
  RingPos fill_pos;
  const auto fill = [&](int t, float value) {
    mbar_wait(&ring->empty[fill_pos.stage], fill_pos.phase ^ 1);
    if (tid < 2 * BQ) rows_s[fill_pos.stage * 2 * BQ + tid] = value;
    uint64_t* full = &ring->full[fill_pos.stage];
    if (tid == 0) {
      uint8_t* st = stages + fill_pos.stage * T::kStageBytes;
      mbar_expect_tx(full, T::kStageBytes);
#pragma unroll
      for (int c = 0; c < DP / kBoxCols; ++c)
        tma_load_3d(st + c * box_bytes(BQ), &qmap, full, c * kBoxCols,
                    t * BQ, bh);
#pragma unroll
      for (int c = 0; c < DVP / kBoxCols; ++c)
        tma_load_3d(st + T::kQBytes + c * box_bytes(BQ), &omap, full,
                    c * kBoxCols, t * BQ, bh);
    } else {
      mbar_arrive(full);
    }
    fill_pos.advance<kStages>();
  };
  if (tid == 0) {
    mbar_expect_tx(kv_full, T::kKBytes + T::kVBytes);
#pragma unroll
    for (int c = 0; c < DP / kBoxCols; ++c)
      tma_load_3d(k_s + c * box_bytes(kBlockRows), &kmap, kv_full,
                  c * kBoxCols, k0, bh);
#pragma unroll
    for (int c = 0; c < DVP / kBoxCols; ++c)
      tma_load_3d(v_s + c * box_bytes(kBlockRows), &vmap, kv_full,
                  c * kBoxCols, k0, bh);
  }
  if (group == 0)
    for (int t = t_begin; t < min(t_begin + kAhead, q_tiles); ++t)
      fill(t, row_value<BQ>(lse2, delta, q_head, s.sq, t, tid));

  // each warpgroup: keys key_lo .. key_lo + 63
  const int key_lo = k0 + 64 * group;
  const int key0 = key_lo + acc_row(0, lane, warp);   // keys key0, key0 + 8
  float dk_acc[DP / 2], dv_acc[DVP / 2];
  zero(dk_acc);
  zero(dv_acc);
  const uint8_t* k_rows = k_s + group * 64 * kSwizzleBytes;
  const uint8_t* v_rows = v_s + group * 64 * kSwizzleBytes;
  mbar_wait(kv_full, 0);
  RingPos pos;
  for (int t = t_begin; t < q_tiles; ++t, pos.advance<kStages>()) {
    const int q0 = t * BQ;
    // the rows of the tile this warpgroup fills after this one, early
    const bool refill = group == 0 && t + kAhead < q_tiles;
    const float ahead = refill ? row_value<BQ>(lse2, delta, q_head, s.sq,
                                               t + kAhead, tid)
                               : 0.0f;
    mbar_wait(&ring->full[pos.stage], pos.phase);
    if (key_lo < s.skv && !(s.causal && key_lo > q0 + BQ - 1)) {
      const uint8_t* qt = stages + pos.stage * T::kStageBytes;
      const uint8_t* ot = qt + T::kQBytes;
      const float* rs = rows_s + pos.stage * 2 * BQ;
      // 1. S^T = K q^T, dP^T = V dO^T
      float st[BQ / 2], dpt[BQ / 2];
      zero(st);
      zero(dpt);
      wgmma_fence();
      fence_regs(st);
      fence_regs(dpt);
      scores<BQ, DP>(st, k_rows, kBlockRows, qt);
      scores<BQ, DVP>(dpt, v_rows, kBlockRows, ot);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      // 2. P^T and dS^T in registers, rounded to bf16 once
      const bool masked = q0 + BQ > s.sq || key_lo + 64 > s.skv ||
                          (s.causal && key_lo + 63 > q0);
      uint32_t p16[BQ / 4], ds16[BQ / 4];
#pragma unroll
      for (int i = 0; i < BQ / 2; i += 2) {
        const int col = acc_col(i, lane);      // q rows q0 + col, + 1
        const int key = key0 + 8 * ((i >> 1) & 1);
        const float2 l = *reinterpret_cast<const float2*>(rs + col);
        const float2 dl = *reinterpret_cast<const float2*>(rs + BQ + col);
        float p0 = exp2f(fmaf(st[i], s.scale_log2, -l.x));
        float p1 = exp2f(fmaf(st[i + 1], s.scale_log2, -l.y));
        if (masked) {
          const int row = q0 + col;
          if (row >= s.sq || key >= s.skv || (s.causal && key > row))
            p0 = 0.0f;
          if (row + 1 >= s.sq || key >= s.skv || (s.causal && key > row + 1))
            p1 = 0.0f;
        }
        p16[i / 2] = bf16_pair(p0, p1);
        ds16[i / 2] = bf16_pair(p0 * (dpt[i] - dl.x),
                                p1 * (dpt[i + 1] - dl.y));
      }
      // 3. dV += P^T dO, dK += dS^T q
      wgmma_fence();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      accumulate<DVP, BQ>(dv_acc, p16, ot);
      accumulate<DP, BQ>(dk_acc, ds16, qt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    if (lane == 0) mbar_arrive(&ring->empty[pos.stage]);
    if (refill) fill(t + kAhead, ahead);
  }
  const size_t head = static_cast<size_t>(bh) * s.skv;
  store<DP>(dk, head, key0, s.skv, s.d, dk_acc, s.scale, lane);
  store<DVP>(dv, head, key0, s.skv, s.dv, dv_acc, 1.0f, lane);
}

// dQ of one (bh, 128 q rows)
template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap omap,
                const float* __restrict__ lse2,
                const float* __restrict__ delta, Shape s,
                __nv_bfloat16* __restrict__ dq) {
  using T = QTile<DP, DVP>;
  extern __shared__ uint8_t raw[];
  uint8_t* q_s = align_atom(raw);
  uint8_t* o_s = q_s + T::kQBytes;
  uint8_t* stages = o_s + T::kOBytes;          // K then V, each stage
  auto* ring = reinterpret_cast<Ring<kStages>*>(stages + kStages *
                                                T::kStageBytes);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + 1);

  // the heaviest q tiles of every head first
  const int q_tiles = (s.sq + kBlockRows - 1) / kBlockRows;
  const int q0 = (q_tiles - 1 - static_cast<int>(blockIdx.x / s.bh)) *
                 kBlockRows;
  const int bh = static_cast<int>(blockIdx.x % s.bh);
  const int rows = min(kBlockRows, s.sq - q0);
  const int kv_end = s.causal ? min(s.skv, q0 + rows) : s.skv;
  const int kv_tiles = (kv_end + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  const int group = tid / kWarpgroup;
  const int lane = tid % 32, warp = (tid / 32) % 4;
  if (tid == 0) {
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&omap);
    mbar_init(q_full, 1);
    ring->init(kConsumers * 4);
  }
  __syncthreads();

  // thread 0 also fills the ring: K and V of tile t into the next stage
  // once both warpgroups have released it
  RingPos fill_pos;
  const auto fill = [&](int t) {
    mbar_wait(&ring->empty[fill_pos.stage], fill_pos.phase ^ 1);
    uint8_t* kt = stages + fill_pos.stage * T::kStageBytes;
    uint64_t* full = &ring->full[fill_pos.stage];
    mbar_expect_tx(full, T::kStageBytes);
#pragma unroll
    for (int c = 0; c < DP / kBoxCols; ++c)
      tma_load_3d(kt + c * box_bytes(kBK), &kmap, full, c * kBoxCols,
                  t * kBK, bh);
#pragma unroll
    for (int c = 0; c < DVP / kBoxCols; ++c)
      tma_load_3d(kt + T::kKBytes + c * box_bytes(kBK), &vmap, full,
                  c * kBoxCols, t * kBK, bh);
    fill_pos.advance<kStages>();
  };
  if (tid == 0) {
    mbar_expect_tx(q_full, T::kQBytes + T::kOBytes);
#pragma unroll
    for (int c = 0; c < DP / kBoxCols; ++c)
      tma_load_3d(q_s + c * box_bytes(kBlockRows), &qmap, q_full,
                  c * kBoxCols, q0, bh);
#pragma unroll
    for (int c = 0; c < DVP / kBoxCols; ++c)
      tma_load_3d(o_s + c * box_bytes(kBlockRows), &omap, q_full,
                  c * kBoxCols, q0, bh);
    for (int t = 0; t < min(kAhead, kv_tiles); ++t) fill(t);
  }

  // each warpgroup: q rows row_lo .. row_lo + 63
  const int row_lo = q0 + 64 * group;
  const int row0 = row_lo + acc_row(0, lane, warp);   // rows row0, row0 + 8
  const size_t head = static_cast<size_t>(bh) * s.sq;
  float l[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    l[h] = row < s.sq ? lse2[head + row] : 0.0f;
    dl[h] = row < s.sq ? delta[head + row] : 0.0f;
  }
  float dq_acc[DP / 2];
  zero(dq_acc);
  const uint8_t* q_rows = q_s + group * 64 * kSwizzleBytes;
  const uint8_t* o_rows = o_s + group * 64 * kSwizzleBytes;
  mbar_wait(q_full, 0);
  RingPos pos;
  for (int t = 0; t < kv_tiles; ++t, pos.advance<kStages>()) {
    const int k0 = t * kBK;
    mbar_wait(&ring->full[pos.stage], pos.phase);
    if (row_lo < s.sq && !(s.causal && k0 > row_lo + 63)) {
      const uint8_t* kt = stages + pos.stage * T::kStageBytes;
      const uint8_t* vt = kt + T::kKBytes;
      // 1. S = q K^T, dP = dO V^T
      float sc[kBK / 2], dp[kBK / 2];
      zero(sc);
      zero(dp);
      wgmma_fence();
      fence_regs(sc);
      fence_regs(dp);
      scores<kBK, DP>(sc, q_rows, kBlockRows, kt);
      scores<kBK, DVP>(dp, o_rows, kBlockRows, vt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // 2. dS in registers, rounded to bf16 once
      const bool masked = k0 + kBK > s.skv ||
                          (s.causal && k0 + kBK - 1 > row_lo);
      uint32_t ds16[kBK / 4];
#pragma unroll
      for (int i = 0; i < kBK / 2; i += 2) {
        const int h = (i >> 1) & 1;
        const int key = k0 + acc_col(i, lane);   // keys key, key + 1
        float p0 = exp2f(fmaf(sc[i], s.scale_log2, -l[h]));
        float p1 = exp2f(fmaf(sc[i + 1], s.scale_log2, -l[h]));
        if (masked) {
          const int row = row0 + 8 * h;
          if (key >= s.skv || (s.causal && key > row)) p0 = 0.0f;
          if (key + 1 >= s.skv || (s.causal && key + 1 > row)) p1 = 0.0f;
        }
        ds16[i / 2] = bf16_pair(p0 * (dp[i] - dl[h]),
                                p1 * (dp[i + 1] - dl[h]));
      }
      // 3. dQ += dS K
      wgmma_fence();
      fence_regs(dq_acc);
      accumulate<DP, kBK>(dq_acc, ds16, kt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
    }
    if (lane == 0) mbar_arrive(&ring->empty[pos.stage]);
    if (tid == 0 && t + kAhead < kv_tiles) fill(t + kAhead);
  }
  store<DP>(dq, head, row0, s.sq, s.d, dq_acc, s.scale, lane);
}

// the tensor maps of q, k, v and dO, with boxes of `q_rows` rows (q, dO)
// and `k_rows` rows (k, v)
cudaError_t maps(const void* q, const void* k, const void* v,
                 const void* dout, const Shape& s, uint32_t q_rows,
                 uint32_t k_rows, CUtensorMap* out) {
  const uint64_t bh = static_cast<uint64_t>(s.bh);
  const uint64_t sq = static_cast<uint64_t>(s.sq);
  const uint64_t skv = static_cast<uint64_t>(s.skv);
  const uint64_t d = static_cast<uint64_t>(s.d);
  const uint64_t dv = static_cast<uint64_t>(s.dv);
  const uint32_t qbox[3] = {kBoxCols, q_rows, 1};
  const uint32_t kbox[3] = {kBoxCols, k_rows, 1};
  const uint64_t qdims[3] = {d, sq, bh}, qpitch[2] = {d * 2, sq * d * 2};
  const uint64_t kdims[3] = {d, skv, bh}, kpitch[2] = {d * 2, skv * d * 2};
  const uint64_t vdims[3] = {dv, skv, bh}, vpitch[2] = {dv * 2, skv * dv * 2};
  const uint64_t odims[3] = {dv, sq, bh}, opitch[2] = {dv * 2, sq * dv * 2};
  cudaError_t err = bf16_map(&out[0], q, 3, qdims, qpitch, qbox);
  if (err == cudaSuccess) err = bf16_map(&out[1], k, 3, kdims, kpitch, kbox);
  if (err == cudaSuccess) err = bf16_map(&out[2], v, 3, vdims, vpitch, kbox);
  if (err == cudaSuccess)
    err = bf16_map(&out[3], dout, 3, odims, opitch, qbox);
  return err;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem, long long blocks) {
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int DP, int DVP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse2, const float* delta,
                   void* dq, void* dk, void* dv, const Shape& s,
                   cudaStream_t st) {
  CUtensorMap m[4];
  cudaError_t err;
  if (dq == nullptr) {
    using T = KVTile<DP, DVP>;
    auto kernel = dkdv_wgmma_kernel<DP, DVP>;
    const long long blocks = static_cast<long long>(s.bh) *
                             ((s.skv + kBlockRows - 1) / kBlockRows);
    err = maps(q, k, v, dout, s, T::kBQ, kBlockRows, m);
    if (err == cudaSuccess) err = prepare(kernel, T::kSmem, blocks);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(blocks), kThreads, T::kSmem, st>>>(
        m[0], m[1], m[2], m[3], lse2, delta, s,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv));
  } else {
    using T = QTile<DP, DVP>;
    auto kernel = dq_wgmma_kernel<DP, DVP>;
    const long long blocks = static_cast<long long>(s.bh) *
                             ((s.sq + kBlockRows - 1) / kBlockRows);
    err = maps(q, k, v, dout, s, kBlockRows, kBK, m);
    if (err == cudaSuccess) err = prepare(kernel, T::kSmem, blocks);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(blocks), kThreads, T::kSmem, st>>>(
        m[0], m[1], m[2], m[3], lse2, delta, s,
        static_cast<__nv_bfloat16*>(dq));
  }
  return cudaGetLastError();
}

inline int padded_d(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 192; }
inline int padded_dv(int dv) { return dv <= 64 ? 64 : 128; }

template <int DP>
size_t smem_for(int dvp) {
  return dvp == 64 ? std::max(KVTile<DP, 64>::kSmem, QTile<DP, 64>::kSmem)
                   : std::max(KVTile<DP, 128>::kSmem, QTile<DP, 128>::kSmem);
}

template <int DP>
cudaError_t launch_for(int dvp, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse2,
                       const float* delta, void* dq, void* dk, void* dv,
                       const Shape& s, cudaStream_t st) {
  return dvp == 64 ? launch<DP, 64>(q, k, v, dout, lse2, delta, dq, dk, dv,
                                    s, st)
                   : launch<DP, 128>(q, k, v, dout, lse2, delta, dq, dk, dv,
                                     s, st);
}

}  // namespace bwg
}  // namespace
}  // namespace repro

// The tensor-core backward's gradients: q (bh, sq, d), k (bh, skv, d), v
// (bh, skv, dv), dout (bh, sq, dv) contiguous bf16, 16-byte aligned, d
// and dv multiples of 16, d at most 192 and dv at most 128; lse2 (the
// forward's) and delta (bh, sq) fp32. With dq null, launches dK/dV into
// dk (bh, skv, d) and dv_out (bh, skv, dv); with dq given, launches dQ
// into dq (bh, sq, d); outputs bf16. Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for what it does not
// take (a size or alignment, more blocks than a grid holds, or more
// shared memory than the device's opt-in limit).
extern "C" int repro_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* delta, int bh, int sq, int skv, int d,
    int dv, int causal, float scale, void* dq, void* dk, void* dv_out,
    void* stream) {
  using namespace repro::bwg;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  void* outs[2] = {dq != nullptr ? dq : dk, dq != nullptr ? dq : dv_out};
  if (bh < 1 || sq < 1 || skv < 1 || d < 16 || dv < 16 || d > 192 ||
      dv > 128 || d % 16 != 0 || dv % 16 != 0 || !aligned(q) ||
      !aligned(k) || !aligned(v) || !aligned(dout) || lse2 == nullptr ||
      delta == nullptr || outs[0] == nullptr || outs[1] == nullptr ||
      !aligned(outs[0]) || !aligned(outs[1]))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dp = padded_d(d), dvp = padded_dv(dv);
  const size_t need = dp == 64    ? smem_for<64>(dvp)
                      : dp == 128 ? smem_for<128>(dvp)
                                  : smem_for<192>(dvp);
  if (need > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{bh, sq, skv, d, dv, causal ? 1 : 0, scale, scale * kLog2e};
  const float* l = static_cast<const float*>(lse2);
  const float* g = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dp == 64)
    err = launch_for<64>(dvp, q, k, v, dout, l, g, dq, dk, dv_out, s, st);
  else if (dp == 128)
    err = launch_for<128>(dvp, q, k, v, dout, l, g, dq, dk, dv_out, s, st);
  else
    err = launch_for<192>(dvp, q, k, v, dout, l, g, dq, dk, dv_out, s, st);
  return static_cast<int>(err);
}
