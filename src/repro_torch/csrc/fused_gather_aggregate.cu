// Fused gather -> scale -> aggregate over a destination CSR, for Hopper.
//
//   out[d, c] = agg over {e : dst[e] = d} of scale[e] * x[src[e], c]
//
// with agg in sum / mean / min / max, x stored as fp32, bf16 or int8 and
// every accumulator in fp32. The (E, F) message tensor is never written.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_gather_aggregate/kernel.py,
//   fused_gather_aggregate_v2_pallas (body _v2_kernel).
// That kernel keeps the whole node table and accumulator in VMEM and
// folds the edge stream into it with a sequential loop; here the grid
// runs in parallel, so the sequential order is kept per segment instead:
// the caller stable-sorts the edge stream by destination once per packed
// batch (`perm`, `offsets`; core/aggregations.py, gather_csr), and one
// warp walks one destination's edges in stream order, lanes over feature
// columns. Invalid edges (an id out of range on either stream, or a
// padding edge) are not in the CSR; the kernel still range-checks every
// id it reads before touching memory.
//
// Bound on this card: bytes. Each edge reads three 4-byte ids/scales and
// one F-wide source row, and does two fp32 operations per message
// element, far below the H100's ridge point. The design reads each
// source row once per (edge, column chunk) with consecutive lanes on
// consecutive addresses and keeps the fold in registers, so the only
// write is the (S, F) output. Hiding the dependent id -> row latency
// (perm -> src -> x) is left to later work: a warp has few edges to walk
// (about two per node on molecule graphs).

#include "common.cuh"

namespace repro {
namespace {

template <typename T, int AGG>
__global__ void __launch_bounds__(kThreadsPerBlock)
fused_gather_aggregate_kernel(const T* __restrict__ x, int n_src, int f,
                              const int32_t* __restrict__ src,
                              const float* __restrict__ scale, int num_edges,
                              const int32_t* __restrict__ perm,
                              const int32_t* __restrict__ offsets,
                              int num_segments, float* __restrict__ out) {
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= num_segments) return;
  const int beg = offsets[seg];
  const int end = offsets[seg + 1];
  for (int c = lane; c < f; c += 32) {
    float acc = agg_init<AGG>();
    int count = 0;
    for (int k = beg; k < end; ++k) {
      const int e = perm[k];
      if (e < 0 || e >= num_edges) continue;
      const int s = src[e];
      if (s < 0 || s >= n_src) continue;
      const float sc = scale != nullptr ? scale[e] : 1.0f;
      const float v = __fmul_rn(to_float(x[static_cast<size_t>(s) * f + c]), sc);
      acc = agg_fold<AGG>(acc, v);
      ++count;
    }
    out[static_cast<size_t>(seg) * f + c] = agg_finalize<AGG>(acc, count);
  }
}

template <typename T>
bool launch_typed(int agg, const void* x, int n_src, int f,
                  const int32_t* src, const float* scale, int num_edges,
                  const int32_t* perm, const int32_t* offsets,
                  int num_segments, float* out, cudaStream_t stream) {
  const dim3 grid = segment_grid(num_segments);
  const T* xt = static_cast<const T*>(x);
#define REPRO_LAUNCH(A)                                                     \
  fused_gather_aggregate_kernel<T, A><<<grid, kThreadsPerBlock, 0, stream>>>( \
      xt, n_src, f, src, scale, num_edges, perm, offsets, num_segments, out)
  switch (agg) {
    case kSum: REPRO_LAUNCH(kSum); return true;
    case kMean: REPRO_LAUNCH(kMean); return true;
    case kMin: REPRO_LAUNCH(kMin); return true;
    case kMax: REPRO_LAUNCH(kMax); return true;
    default: return false;
  }
#undef REPRO_LAUNCH
}

}  // namespace
}  // namespace repro

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an unknown dtype or agg code.
extern "C" int repro_fused_gather_aggregate(
    const void* x, int dtype, int n_src, int f, const int32_t* src,
    const float* scale, int num_edges, const int32_t* perm,
    const int32_t* offsets, int num_segments, int agg, float* out,
    void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (dtype) {
    case kF32:
      ok = launch_typed<float>(agg, x, n_src, f, src, scale, num_edges, perm,
                               offsets, num_segments, out, st);
      break;
    case kBF16:
      ok = launch_typed<__nv_bfloat16>(agg, x, n_src, f, src, scale,
                                       num_edges, perm, offsets, num_segments,
                                       out, st);
      break;
    case kI8:
      ok = launch_typed<int8_t>(agg, x, n_src, f, src, scale, num_edges, perm,
                                offsets, num_segments, out, st);
      break;
    default:
      break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
