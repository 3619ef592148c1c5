// Tiled matrix product, for Hopper.
//
//   out (M, N) = x (M, K) @ w (K, N)
//
// with x and w both fp32 or both bf16, an fp32 accumulator and the
// result written in x's dtype, rounded once.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/tiled_linear/kernel.py,
//   tiled_matmul_pallas (body _matmul_kernel).
// That kernel runs an (M/bm, N/bn, K/bk) grid with K innermost and
// sequential, feeding (bm, bk) x (bk, bn) tiles to the MXU and keeping
// an fp32 (bm, bn) accumulator in VMEM across the K steps; the caller
// pads every dimension to a tile multiple. Here each block owns one
// output tile and walks K itself; the ragged M, N and K edges need no
// padded copies. The tiles are the kernel's own: the TPU's (block_m,
// block_n, block_k) would not fit a block's shared memory at the
// paper's parallel design, and the wrapper does not pass them.
//
// Two bodies; the wrapper picks one by dtype and shape alone
// (kernels/tiled_linear/kernel.py, body_for):
//
// "simt" (every fp32 call, and bf16 shapes TMA cannot describe): a
// register-tiled SIMT product with a tile chosen by shape on the host
// (kernel.py, simt_tile_for), so that a call fills the card: 112 x 64
// blocks of 256 threads with 7 x 4 register tiles for tall products
// (112 rows: the GCN transforms' 27656 rows make 247 blocks, at most two
// an SM, where 128 rows left 85 of 132 SMs two of 217), and 16 x 32
// blocks of 64 threads with 2 x 4 tiles where the tall tile would give
// fewer than ~100 blocks (the MLP head's 1024 rows: 128 blocks). 128 x
// 128 tiles at 8 x 8 read slower at both GCN transforms (PERF.md, the
// design steps). K is staged in chunks of 16 (32 for the small tile)
// through a ring of 4 shared-memory buffers by cp.async (simt.cuh):
// 16-byte copies where K (for x) or N (for w) is a multiple of 4 and
// the operand 16-byte aligned, 4-byte copies otherwise (K = 11); bf16
// operands are converted on the way.
// Both operands stay row-major: a thread reads each of its x rows 4 k
// at a time and its w columns 4 at a time, 16-byte shared loads (TM +
// TN of them per 4 TM TN FMAs). Every output is one fp32 FMA chain over
// k in ascending order, whatever the tile, so every tile gives the same
// bits; no split-K and no atomics. fp32 never runs as TF32, so the
// port's full-fp32 numerics hold. The ragged edges are zeros in the
// staged chunks and guarded at the stores (16 bytes where N % 4 == 0).
//
// "wgmma" (bf16 with K and N multiples of 8, 16-byte aligned operands:
// TMA needs 16-byte row pitches): one block per 128 x 256 output tile,
// two consumer warpgroups of 64 rows each and a producer warpgroup
// (hopper.cuh). One producer thread keeps a ring of 4 stages full by
// TMA: a (128 x 64) tile of x and four (64 x 64) boxes of w per stage,
// all 128-byte swizzled; out-of-bounds rows and columns arrive as
// zeros, so a ragged M, N or K adds nothing and only the stores are
// guarded. Each consumer issues, per stage, four wgmma m64n256k16 with
// bf16 operands from shared memory into 128 fp32 accumulators a thread:
// x is the K-major A operand; w is N-contiguous, so it is the MN-major
// B operand (transpose flag set, LBO = one box of 8 KB). A stage is
// handed back when the next stage's products are issued and its own
// have completed. The epilogue rounds each sum once with
// __float2bfloat16_rn, as the SIMT body does. No split-K and no
// atomics: a call gives the same bits on every run. The blocks walk M
// fastest, so one wave of 132 blocks shares all of x and a few column
// strips of w in L2. 128 x 128 tiles (4 or 6 stages) and 3 stages
// measured slower at qwen3-8b's up-projection (PERF.md, the design
// steps of the wgmma bodies).
//
// Bound on this card: operations for the shapes of interest (a large
// product), bytes for thin ones (the GCN transforms, K = 11). bf16 is
// bounded by the tensor cores' 989 TFLOP/s, which only wgmma reaches;
// fp32 by the SIMT cores' 67 TFLOP/s (the SIMT body issues 11 16-byte
// shared loads per 112 FMAs at its 7 x 4 tile).

#include "common.cuh"
#include "hopper.cuh"
#include "simt.cuh"

namespace repro {
namespace {

// ------------------------------------------------- the SIMT body --
namespace sm {

using namespace simt;

// A block's (BM x BN) output tile, a thread's (TM x TN) register tile,
// K chunks of BK in a ring of `Stages` buffers. Thread tid = kTX ty + tx
// owns rows ty + kTY i (i < TM) and columns 4 tx + 4 kTX c .. + 3 (c <
// TN / 4): a warp reads 32 / kTX neighbouring x rows, which the row
// pitch BK + 4 puts in different bank groups, and consecutive 16-byte
// pieces of a w row.
template <int BM, int BN, int TM, int TN, int BK, int Stages, int MinBlocks>
struct Tile {
  static constexpr int kTX = BN / TN;
  static constexpr int kTY = BM / TM;
  static constexpr int kThreads = kTX * kTY;
  static constexpr int kXPitch = BK + 4;   // x chunk (row, k)
  static constexpr int kX = BM * kXPitch;
  static constexpr int kStage = kX + BK * BN;
  static constexpr size_t kSmem = sizeof(float) * Stages * kStage;
  static constexpr int kBM = BM, kBN = BN, kTM = TM, kTN = TN, kBK = BK,
                       kStages = Stages, kMinBlocks = MinBlocks;
};

// by the code of the C interface (kernels/tiled_linear/kernel.py,
// SIMT_TILES and simt_tile_for): 0 tall, 1 small (enough blocks for the
// card at ~1000 rows)
using Tall = Tile<112, 64, 7, 4, 16, 4, 2>;
using Small = Tile<16, 32, 2, 4, 32, 4, 8>;

struct Shape {
  int m, n, k, vec_x, vec_w, vec_out;
};

template <typename T, typename L>
__global__ void __launch_bounds__(L::kThreads, L::kMinBlocks)
matmul_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, Shape s) {
  constexpr int TM = L::kTM, TN = L::kTN, BK = L::kBK, BN = L::kBN;
  constexpr int kTX = L::kTX, kTY = L::kTY, kStages = L::kStages;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m0 = blockIdx.x * L::kBM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int k_tiles = (s.k + BK - 1) / BK;
  const T* xb = x + static_cast<size_t>(m0) * s.k;

  const auto stage = [&](int t) {
    float* xs = smem + (t % kStages) * L::kStage;
    const int k0 = t * BK;
    stage_tile<L::kBM, BK, L::kThreads>(xs, L::kXPitch, xb + k0, s.k,
                                        s.m - m0, s.k - k0, s.vec_x, tid);
    stage_tile<BK, BN, L::kThreads>(
        xs + L::kX, BN, w + static_cast<size_t>(k0) * s.n + n0, s.n,
        s.k - k0, s.n - n0, s.vec_w, tid);
  };
  // one commit per step, empty or not, so that wait<kStages - 2> always
  // means "chunk t has landed"
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < k_tiles) stage(t);
    cp_async_commit();
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < k_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk t is whole; chunk t - 1's buffer is free
    if (t + kStages - 1 < k_tiles) stage(t + kStages - 1);
    cp_async_commit();
    const float* xs = smem + (t % kStages) * L::kStage;
    const float* ws = xs + L::kX;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            xs + (ty + kTY * i) * L::kXPitch + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float4 b[TN / 4];
#pragma unroll
        for (int c = 0; c < TN / 4; ++c)
          b[c] = *reinterpret_cast<const float4*>(
              ws + (kk + q) * BN + 4 * tx + 4 * kTX * c);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y
                         : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int c = 0; c < TN / 4; ++c) {
            acc[i][4 * c] = fmaf(av, b[c].x, acc[i][4 * c]);
            acc[i][4 * c + 1] = fmaf(av, b[c].y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(av, b[c].z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(av, b[c].w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long row = static_cast<long long>(m0) + ty + kTY * i;
    if (row >= s.m) continue;
#pragma unroll
    for (int c = 0; c < TN / 4; ++c) {
      const int col = n0 + 4 * tx + 4 * kTX * c;
      if (col < s.n)
        store4(out + static_cast<size_t>(row) * s.n + col, acc[i] + 4 * c,
               s.n - col, s.vec_out);
    }
  }
}

template <typename T, typename L>
cudaError_t launch(const void* x, const void* w, void* out, const Shape& s,
                   cudaStream_t stream) {
  const long long m_tiles = (static_cast<long long>(s.m) + L::kBM - 1) /
                            L::kBM;
  const long long n_tiles = (static_cast<long long>(s.n) + L::kBN - 1) /
                            L::kBN;
  if (m_tiles > 0x7fffffffLL || n_tiles > 65535)
    return cudaErrorInvalidValue;
  auto kernel = matmul_simt_kernel<T, L>;
  if (L::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kSmem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(static_cast<unsigned>(m_tiles),
                static_cast<unsigned>(n_tiles)),
           L::kThreads, L::kSmem, stream>>>(static_cast<const T*>(x),
                                           static_cast<const T*>(w),
                                           static_cast<T*>(out), s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* w, void* out,
                         const Shape& s, int tile, cudaStream_t stream) {
  switch (tile) {
    case 0:
      return launch<T, Tall>(x, w, out, s, stream);
    case 1:
      return launch<T, Small>(x, w, out, s, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace sm


// ------------------------------------------------ the wgmma body --
namespace wg {

using namespace hopper;

constexpr int kBM = 128;                  // rows of a block's tile
constexpr int kBN = 256;                  // columns of a block's tile
constexpr int kBK = 64;                   // K of a stage: one swizzled row
constexpr int kStages = 4;
constexpr int kConsumers = 2;             // warpgroups of 64 rows
constexpr int kThreads = (kConsumers + 1) * kWarpgroup;
constexpr int kABytes = kBM * kBK * 2;    // 16 KB
constexpr int kBoxBytes = kBK * kBoxCols * 2;   // one (64 x 64) w box
constexpr int kBBytes = kBN / kBoxCols * kBoxBytes;   // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr size_t kSmem = kAtomBytes +
                         static_cast<size_t>(kStages) * kStageBytes +
                         sizeof(Ring<kStages>);

__global__ void __launch_bounds__(kThreads, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, int m, int n,
                    int k, __nv_bfloat16* __restrict__ out) {
  extern __shared__ uint8_t raw[];
  uint8_t* tiles = align_atom(raw);
  auto* ring = reinterpret_cast<Ring<kStages>*>(tiles + kStages *
                                                kStageBytes);
  const int m_tiles = (m + kBM - 1) / kBM;
  const int m0 = static_cast<int>(blockIdx.x % m_tiles) * kBM;
  const int n0 = static_cast<int>(blockIdx.x / m_tiles) * kBN;
  const int k_tiles = (k + kBK - 1) / kBK;
  const int group = threadIdx.x / kWarpgroup;
  if (threadIdx.x == 0) {
    prefetch_map(&xmap);
    prefetch_map(&wmap);
    ring->init(kConsumers * 4);
  }
  __syncthreads();

  if (group == kConsumers) {
    // the producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers * kWarpgroup) {
      RingPos pos;
      for (int t = 0; t < k_tiles; ++t, pos.advance<kStages>()) {
        mbar_wait(&ring->empty[pos.stage], pos.phase ^ 1);
        uint8_t* a = tiles + pos.stage * kStageBytes;
        uint64_t* full = &ring->full[pos.stage];
        mbar_expect_tx(full, kStageBytes);
        tma_load_2d(a, &xmap, full, t * kBK, m0);
#pragma unroll
        for (int j = 0; j < kBN / kBoxCols; ++j)
          tma_load_2d(a + kABytes + j * kBoxBytes, &wmap, full,
                      n0 + j * kBoxCols, t * kBK);
      }
    }
  } else {
    // a consumer: rows m0 + 64 group .. + 63 of the tile
    setmaxnreg_inc<232>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
    RingPos pos;
    for (int t = 0; t < k_tiles; ++t, pos.advance<kStages>()) {
      mbar_wait(&ring->full[pos.stage], pos.phase);
      const uint8_t* a = tiles + pos.stage * kStageBytes;
      const uint64_t da = desc_sw128(a + group * 64 * kSwizzleBytes, 16,
                                     kAtomBytes);
      const uint64_t db = desc_sw128(a + kABytes, kBoxBytes, kAtomBytes);
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: 32 bytes along the swizzled row; B: 16 rows of 128 bytes
        wgmma_m64n256k16_ss<1>(acc, da + 2 * kk, db + 128 * kk);
      }
      wgmma_commit();
      fence_regs(acc);
      // the stage before this one is read: hand it back
      wgmma_wait<1>();
      if (t > 0 && lane == 0)
        mbar_arrive(&ring->empty[(pos.stage + kStages - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    const int row0 = m0 + group * 64;
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 2) {
      const int row = row0 + acc_row(i, lane, warp);
      const int col = n0 + acc_col(i, lane);
      // n is even, so a pair is wholly inside or wholly outside
      if (row < m && col < n)
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<size_t>(row) * n + col) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

cudaError_t launch(const void* x, const void* w, int m, int n, int k,
                   void* out, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(k),
                             static_cast<uint64_t>(m)};
  const uint64_t xpitch[1] = {static_cast<uint64_t>(k) * 2};
  const uint32_t xbox[2] = {kBK, kBM};
  const uint64_t wdims[2] = {static_cast<uint64_t>(n),
                             static_cast<uint64_t>(k)};
  const uint64_t wpitch[1] = {static_cast<uint64_t>(n) * 2};
  const uint32_t wbox[2] = {kBoxCols, kBK};
  cudaError_t err = bf16_map(&xmap, x, 2, xdims, xpitch, xbox);
  if (err == cudaSuccess) err = bf16_map(&wmap, w, 2, wdims, wpitch, wbox);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(matmul_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const long long blocks = ((static_cast<long long>(m) + kBM - 1) / kBM) *
                           ((static_cast<long long>(n) + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  matmul_wgmma_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem,
                        stream>>>(
      xmap, wmap, m, n, k, static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace
}  // namespace repro

// x (m, k), w (k, n) and out (m, n), row-major, all in the storage type
// `dtype` (fp32 or bf16); `tile` is the SIMT tile's code (0 112 x 64,
// 1 16 x 32). Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for another dtype or tile, m
// or n < 1, k < 0, or more than 65535 column tiles.
extern "C" int repro_tiled_matmul(const void* x, const void* w, int m, int n,
                                  int k, int dtype, void* out, void* stream,
                                  int tile) {
  using namespace repro;
  if (m < 1 || n < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool f32 = dtype == kF32;
  const sm::Shape s{m, n, k, f32 && k % 4 == 0 && aligned(x),
                    f32 && n % 4 == 0 && aligned(w),
                    f32 && n % 4 == 0 && aligned(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(sm::launch_typed<float>(x, w, out, s, tile, st));
    case kBF16:
      return static_cast<int>(
          sm::launch_typed<__nv_bfloat16>(x, w, out, s, tile, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tensor-core body: x (m, k), w (k, n) and out (m, n), row-major
// bf16, k and n multiples of 8 (k >= 8), x and w 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape or alignment it does not take.
extern "C" int repro_tiled_matmul_wgmma(const void* x, const void* w, int m,
                                        int n, int k, void* out,
                                        void* stream) {
  if (m < 1 || n < 1 || k < 8 || n % 8 != 0 || k % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(repro::wg::launch(
      x, w, m, n, k, out, static_cast<cudaStream_t>(stream)));
}
