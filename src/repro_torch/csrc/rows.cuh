// Pieces of the CSR kernels that give a lane CPL consecutive columns of
// a segment's output row (csrc/segment_aggregate.cu,
// csrc/fused_gather_aggregate.cu): the launch geometry, a row load of up
// to 16 bytes kept raw while it is in flight, and the store of CPL fp32
// results in one or two vector stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

// the launch (kernels/_geometry.py, lane_geometry): a segment takes
// `lanes` lanes of a warp, so a warp folds 32 / lanes segments at once
struct Geometry {
  int lanes;       // lanes per segment, a power of two <= 32
  int groups;      // column groups per segment (lanes * CPL columns each)
  int passes;      // segment groups a warp walks in series
  int warps;       // warps with work
};

// CPL elements of T (at most 16 bytes), kept raw while the load is in
// flight: 4 registers at most, whatever the storage type
template <typename T, int CPL>
struct Raw {
  static constexpr int kBytes = CPL * static_cast<int>(sizeof(T));
  static constexpr int kWords = kBytes < 4 ? 1 : kBytes / 4;
  static_assert(kBytes <= 16, "one load of at most 16 bytes");
  uint32_t w[kWords];

  // p is aligned to kBytes: the row width is a multiple of CPL and the
  // table's base is aligned to CPL elements (the geometry functions and
  // the wrappers' alignment cap, kernels/*/kernel.py)
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes == 16) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else if constexpr (kBytes == 8) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = q.x; w[1] = q.y;
    } else if constexpr (kBytes == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else if constexpr (kBytes == 2) {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned char*>(p));
    }
  }

  // element q as fp32, exactly as to_float (common.cuh)
  __device__ __forceinline__ float at(int q) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[q]);
    } else if constexpr (sizeof(T) == 2) {        // bf16: the high half
      return __uint_as_float(((w[q / 2] >> (16 * (q % 2))) & 0xffffu) << 16);
    } else {                                      // int8
      return static_cast<float>(
          static_cast<int8_t>((w[q / 4] >> (8 * (q % 4))) & 0xffu));
    }
  }
};

// rows a lane loads before it folds the first of them: kShallowBatch
// where segments are short (edge streams, ~1.3 rows a destination: few
// registers, many warps resident; each of a segment's lanes loads its
// ids itself), else deep_batch(): 32 registers of raw rows (pooling's ~27
// rows a graph at once, a hub; ids loaded once and shared by shuffle).
// kernels/_geometry.py, rows_in_flight, chooses from the mean segment
// length
constexpr int kShallowBatch = 4;
template <typename T, int CPL>
constexpr int deep_batch() {
  return 32 / Raw<T, CPL>::kWords;
}

// CPL fp32 results at p, aligned to CPL floats
template <int CPL>
__device__ __forceinline__ void store(float* p, const float (&v)[CPL]) {
  if constexpr (CPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < CPL / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (CPL == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

}  // namespace repro
