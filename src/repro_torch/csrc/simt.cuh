// Staging for the fp32 SIMT bodies of tiled_matmul.cu and
// flash_attention.cu: cp.async copies of a row-major tile from device
// memory into a row-major fp32 tile in shared memory, zero-filled past
// the valid rows and columns, so that a ragged edge adds nothing and
// needs no padded copy.
//
// fp32 sources go by cp.async, 16 bytes at a time where the caller says
// the rows allow it (a column count that is a multiple of 4 and a
// 16-byte aligned base), 4 bytes otherwise; the copy lands while the
// block computes, and cp_async_wait<n>() waits for all but the newest n
// committed groups. bf16 sources are converted to fp32 on the way
// (plain loads and stores, so they have landed when stage_tile
// returns). Either way a __syncthreads() must follow the wait before
// another thread reads the tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro {
namespace simt {

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `src_bytes` of 16 (or 4) are copied, the rest of the destination is
// zero-filled: 0 copies nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the (R x C) tile at `src` (row pitch `ld` elements) into `dst`
// (row pitch `pitch` floats, 16-byte aligned rows): element (r, c) is
// src[r * ld + c] where r < rows and c < cols, else 0. C is a multiple
// of 4; `vec` (fp32 only) asks for 16-byte copies, which needs cols and
// ld multiples of 4 and `src` 16-byte aligned. NT threads share the
// copy, `tid` is this thread's index among them.
template <int R, int C, int NT, typename T>
__device__ __forceinline__ void stage_tile(float* dst, int pitch,
                                           const T* src, int ld, int rows,
                                           int cols, bool vec, int tid) {
  static_assert(C % 4 == 0, "a tile row is whole 16-byte chunks");
  constexpr int kChunks = R * C / 4;
#pragma unroll
  for (int l = 0; l < (kChunks + NT - 1) / NT; ++l) {
    const int e = tid + l * NT;
    if (kChunks % NT != 0 && e >= kChunks) break;
    const int r = e / (C / 4), c = e % (C / 4) * 4;
    float* d = dst + r * pitch + c;
    const T* s = src + static_cast<size_t>(r) * ld + c;
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {
        const bool ok = r < rows && c < cols;
        cp_async16(d, ok ? s : src, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = r < rows && c + q < cols;
          cp_async4(d + q, ok ? s + q : src, ok ? 4 : 0);
        }
      }
    } else {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = r < rows && c + q < cols ? to_float(s[q]) : 0.0f;
      *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four consecutive outputs p[0..3], of which the first `n` are in range;
// one 16-byte store where `vec` (fp32, all four in range, p aligned)
template <typename T>
__device__ __forceinline__ void store4(T* p, const float* v, int n,
                                       bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec && n >= 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < n) store(p + q, v[q]);
}

}  // namespace simt
}  // namespace repro
