// Aggregation over a padded (N, K) neighbour table, for Hopper.
//
//   out[r, c] = agg over the valid slots k of nbr[r] of x[nbr[r, k], c]
//
// with agg in sum / mean / min / max / var / std, x stored as fp32 or
// bf16, every accumulator in fp32 and the result written in x's dtype. A
// slot is valid when its id lies in [0, N): -1 marks padding, and any
// other out-of-range id drops the slot too. The slots fold in table
// order: sum/mean add, min/max keep NaN, var/std take Welford's step.
// Empty rows give 0 (var the 1e-12 floor, std its square root); mean
// divides by max(count, 1), min/max zero every non-finite result, var is
// max(M2 / max(count, 1), 1e-12).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gnn_aggregate/kernel.py,
//   gnn_aggregate_pallas (body _agg_kernel).
// That kernel pins the whole (N, F) table in VMEM and walks (block_nodes,
// K) tiles of the neighbour table over a sequential grid, folding slot
// k of every row of the tile at once. Here the grid runs in parallel:
// one block per block_nodes rows (grid ceil(N / block_nodes)), warp w of
// the block owns the rows r = w (mod 8) of its tile, as the one-hot
// kernels own theirs, and the lanes own feature columns, so every
// accumulator has one writer and no atomics are needed. Each lane folds
// its row's slots in table order in registers. The table is not staged:
// x is read through L2 (each row is gathered as a coalesced run of
// columns), and a row's K slot ids are the same address for all lanes.
//
// Bound on this card: bytes. The neighbour table is read once (4 B per
// slot), each referenced x row once per referencing slot (from L2 after
// the first), and the (N, F) result written once, with one (Welford:
// four) fp32 operations per valid slot and column. With F < 32 some
// lanes idle; packing several rows per warp is later work.
//
// Arithmetic: the explicitly rounded intrinsics, which nvcc never
// contracts into an FMA, so each step rounds as the plain PyTorch
// version's separate elementwise operations do.

#include "common.cuh"

namespace repro {
namespace {

constexpr float kVarFloor = 1e-12f;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int AGG>
__global__ void __launch_bounds__(kThreadsPerBlock)
gnn_aggregate_kernel(const T* __restrict__ x, int n, int f,
                     const int32_t* __restrict__ nbr, int k_max,
                     int block_nodes, T* __restrict__ out) {
  const long long row0 = static_cast<long long>(blockIdx.x) * block_nodes;
  const int rows = static_cast<int>(min(static_cast<long long>(block_nodes),
                                        n - row0));
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarpsPerBlock) {
    const long long row = row0 + r;
    const int32_t* slots = nbr + row * k_max;
    for (int c = lane; c < f; c += 32) {
      float result;
      if constexpr (AGG == kVar || AGG == kStd) {
        float count = 0.0f, mean = 0.0f, m2 = 0.0f;
        for (int k = 0; k < k_max; ++k) {
          const int id = slots[k];
          if (id < 0 || id >= n) continue;
          const float v = to_float(x[static_cast<size_t>(id) * f + c]);
          count = __fadd_rn(count, 1.0f);
          const float delta = __fsub_rn(v, mean);
          mean = __fadd_rn(mean, __fdiv_rn(delta, fmaxf(count, 1.0f)));
          m2 = __fadd_rn(m2, __fmul_rn(delta, __fsub_rn(v, mean)));
        }
        float var = __fdiv_rn(m2, fmaxf(count, 1.0f));
        var = var < kVarFloor ? kVarFloor : var;  // NaN propagates
        result = AGG == kStd ? __fsqrt_rn(var) : var;
      } else {
        float acc = agg_init<AGG>();
        int count = 0;
        for (int k = 0; k < k_max; ++k) {
          const int id = slots[k];
          if (id < 0 || id >= n) continue;
          acc = agg_fold<AGG>(acc,
                              to_float(x[static_cast<size_t>(id) * f + c]));
          ++count;
        }
        result = agg_finalize<AGG>(acc, count);
      }
      store(out + row * f + c, result);
    }
  }
}

template <typename T>
cudaError_t launch_typed(int agg, const void* x, int n, int f,
                         const int32_t* nbr, int k_max, int block_nodes,
                         void* out, cudaStream_t stream) {
  const long long blocks =
      (n + static_cast<long long>(block_nodes) - 1) / block_nodes;
  const dim3 grid(static_cast<unsigned>(blocks));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
#define REPRO_LAUNCH(A)                                                \
  gnn_aggregate_kernel<T, A><<<grid, kThreadsPerBlock, 0, stream>>>(   \
      xt, n, f, nbr, k_max, block_nodes, ot);                          \
  return cudaGetLastError()
  switch (agg) {
    case kSum: REPRO_LAUNCH(kSum);
    case kMean: REPRO_LAUNCH(kMean);
    case kMin: REPRO_LAUNCH(kMin);
    case kMax: REPRO_LAUNCH(kMax);
    case kVar: REPRO_LAUNCH(kVar);
    case kStd: REPRO_LAUNCH(kStd);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
}

}  // namespace
}  // namespace repro

// x (n, f) and out (n, f) in the storage type `dtype` (fp32 or bf16);
// nbr (n, k_max) int32. Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for another dtype, an unknown agg
// code, n < 1 or block_nodes < 1.
extern "C" int repro_gnn_aggregate(const void* x, int dtype, int n, int f,
                                   const int32_t* nbr, int k_max,
                                   int block_nodes, int agg, void* out,
                                   void* stream) {
  using namespace repro;
  if (n < 1 || f < 0 || k_max < 0 || block_nodes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      err = launch_typed<float>(agg, x, n, f, nbr, k_max, block_nodes, out,
                                st);
      break;
    case kBF16:
      err = launch_typed<__nv_bfloat16>(agg, x, n, f, nbr, k_max,
                                        block_nodes, out, st);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}
