// Tiled matrix product, for Hopper.
//
//   out (M, N) = x (M, K) @ w (K, N)
//
// with x and w both fp32 or both bf16 (converted to fp32 as they are
// loaded), an fp32 accumulator and the result written in x's dtype.
// Every product is a plain fp32 FMA on the SIMT cores: fp32 never runs
// as TF32 here.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/tiled_linear/kernel.py,
//   tiled_matmul_pallas (body _matmul_kernel).
// That kernel runs an (M/bm, N/bn, K/bk) grid with K innermost and
// sequential, feeding (bm, bk) x (bk, bn) tiles to the MXU and keeping
// an fp32 (bm, bn) accumulator in VMEM across the K steps; the caller
// pads every dimension to a tile multiple. Here one 256-thread block
// owns a 64 x 64 output tile and walks K itself in chunks of 16: the
// chunk of x (64 x 16, stored k-major) and of w (16 x 64) is staged in
// shared memory, and each thread keeps a 4 x 4 register tile of the
// output (rows ty + 16 i, columns tx + 16 j, so a warp's reads of either
// staged tile are broadcasts or consecutive words). The ragged M, N and
// K edges are guarded where the tiles are loaded (zeros) and stored, so
// nothing is padded by copies. The tile is the kernel's own: the TPU's
// (block_m, block_n, block_k) would not fit a block's shared memory at
// the paper's parallel design, and the wrapper does not pass them.
//
// Bound on this card: operations for the shapes of interest (a large
// product), bytes for thin ones (the GCN transforms, K = 11). Each
// thread does 16 FMAs per 8 shared-memory reads, which caps the SIMT
// rate well under the card's 67 TFLOP/s fp32; a bf16 product is far
// under the tensor-core rate (989 TFLOP/s) that bounds it, since no
// mma/wgmma is used. Tensor-core tiles are later work.

#include "common.cuh"

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
