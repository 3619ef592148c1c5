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
// "simt" (every fp32 call, and bf16 shapes TMA cannot describe): one
// 256-thread block per 64 x 64 output tile, K staged in chunks of 16
// (x k-major, w as is, both converted to fp32) in shared memory, a
// 4 x 4 register tile per thread (rows ty + 16 i, columns tx + 16 j, so
// a warp's reads of either staged tile are broadcasts or consecutive
// words), every product a plain fp32 FMA: fp32 never runs as TF32, so
// the port's full-fp32 numerics hold. The edges are guarded where the
// tiles are loaded (zeros) and stored.
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
// fp32 by the SIMT cores' 67 TFLOP/s, which the SIMT body stays well
// under (16 FMAs per 8 shared-memory reads a thread).

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kMicro = 4;           // 4 x 4 outputs per thread
constexpr int kSide = 16;           // 16 x 16 threads
constexpr int kThreads = kSide * kSide;
constexpr int kPad = 1;             // x tile row padding (bank spread)

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tiled_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, int m,
                    int n, int k, T* __restrict__ out) {
  __shared__ float xs[kTileK][kTileM + kPad];   // x chunk, k-major
  __shared__ float ws[kTileK][kTileN];          // w chunk
  const int tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTileM;
  const int n0 = blockIdx.y * kTileN;
  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kTileK) {
#pragma unroll
    for (int l = 0; l < kTileM * kTileK / kThreads; ++l) {
      const int e = tid + l * kThreads;
      // x: 64 rows x 16 columns, 16 consecutive columns per row
      const int xr = e / kTileK, xc = e % kTileK;
      const long long gr = m0 + xr;
      const int gc = k0 + xc;
      xs[xc][xr] = (gr < m && gc < k)
                       ? to_float(x[static_cast<size_t>(gr) * k + gc])
                       : 0.0f;
      // w: 16 rows x 64 columns, 64 consecutive columns per row
      const int wr = e / kTileN, wc = e % kTileN;
      const int gk = k0 + wr, gn = n0 + wc;
      ws[wr][wc] = (gk < k && gn < n)
                       ? to_float(w[static_cast<size_t>(gk) * n + gn])
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = xs[kk][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) b[j] = ws[kk][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const long long row = m0 + ty + kSide * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int col = n0 + tx + kSide * j;
      if (col < n) store(out + static_cast<size_t>(row) * n + col, acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* w, int m, int n, int k,
                         void* out, cudaStream_t stream) {
  const dim3 grid(
      static_cast<unsigned>((static_cast<long long>(m) + kTileM - 1) / kTileM),
      static_cast<unsigned>((static_cast<long long>(n) + kTileN - 1) / kTileN));
  tiled_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), m, n, k,
      static_cast<T*>(out));
  return cudaGetLastError();
}


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
// `dtype` (fp32 or bf16). Returns cudaGetLastError() after the launch (0
// = launched), or cudaErrorInvalidValue for another dtype, m or n < 1,
// k < 0, or more than 65535 column tiles (n > 4194240).
extern "C" int repro_tiled_matmul(const void* x, const void* w, int m, int n,
                                  int k, int dtype, void* out, void* stream) {
  using namespace repro;
  if (m < 1 || n < 1 || k < 0 ||
      (static_cast<long long>(n) + kTileN - 1) / kTileN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch_typed<float>(x, w, m, n, k, out, st));
    case kBF16:
      return static_cast<int>(
          launch_typed<__nv_bfloat16>(x, w, m, n, k, out, st));
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
