// Shared pieces of the port's segmented-reduction kernels.
//
// Both kernels walk a CSR over their edge (or row) stream: `perm` lists
// the element ids stably sorted by destination segment and
// `offsets[s]..offsets[s + 1]` is segment s's slice of `perm`. One warp
// owns one segment, its lanes own feature columns, and each lane folds
// the segment's elements in their original stream order into an fp32
// register. There are no atomics, so the result is deterministic and the
// fold order is that of the Pallas kernels' sequential edge loop.
//
// Arithmetic goes through the explicitly rounded intrinsics
// (__fadd_rn, __fmul_rn, ...), which nvcc never contracts into an FMA,
// so each step rounds exactly as the plain PyTorch version's separate
// elementwise operations do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

// agg codes shared with the Python wrappers (kernels/*/kernel.py)
enum Agg : int { kSum = 0, kMean = 1, kMin = 2, kMax = 3, kVar = 4, kStd = 5 };

// storage codes of the streamed table
enum Dtype : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

constexpr int kWarpsPerBlock = 8;
constexpr int kThreadsPerBlock = kWarpsPerBlock * 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ bool is_nan(float v) { return v != v; }
// false for +-inf and NaN
__device__ __forceinline__ bool is_finite(float v) {
  return fabsf(v) <= 3.402823466e38f;
}

template <int AGG>
__device__ __forceinline__ float agg_init() {
  if constexpr (AGG == kMin) return pos_inf();
  if constexpr (AGG == kMax) return -pos_inf();
  return 0.0f;
}

// min/max propagate NaN, as torch.minimum / jnp.minimum do
template <int AGG>
__device__ __forceinline__ float agg_fold(float acc, float v) {
  if constexpr (AGG == kMin) return (v < acc || is_nan(v)) ? v : acc;
  if constexpr (AGG == kMax) return (v > acc || is_nan(v)) ? v : acc;
  return __fadd_rn(acc, v);
}

// empty segments give 0: mean divides by max(count, 1) and min/max zero
// every non-finite result (a genuine +-inf included, as the reference)
template <int AGG>
__device__ __forceinline__ float agg_finalize(float acc, int count) {
  if constexpr (AGG == kMean)
    return __fdiv_rn(acc, static_cast<float>(count > 1 ? count : 1));
  if constexpr (AGG == kMin || AGG == kMax) return is_finite(acc) ? acc : 0.0f;
  return acc;
}

inline dim3 segment_grid(int num_segments) {
  return dim3((num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace repro
