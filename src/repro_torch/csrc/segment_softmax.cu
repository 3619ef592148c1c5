// Segment softmax over a CSR of the edge stream, for Hopper.
//
//   w[e] = exp(z[e] - m[s]) / max(l[s], 1e-30)   for each edge e of segment s
//   w[e] = 0                                     for every edge not in the CSR
//
// with m[s] the running max of segment s's logits (the empty max clamped
// at NEG_INF = -1e30) and l[s] their exp-sum, folded online in stream
// order: m' = max(m, z); l' = l * exp(m - m') + exp(z - m'). A -inf logit
// leaves m unchanged and adds exp(-inf) = 0, so it never meets
// -inf - -inf; an all -inf or empty segment gives l = 0 and weights 0.
// The arguments of exp are never positive, so +-1e4 logits stay finite.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/segment_softmax/kernel.py,
//   segment_softmax_stats_pallas (body _softmax_stats_kernel) and the
//   per-edge normalization of segment_softmax_pallas.
// The TPU kernel keeps the (S,) m and l tables resident in VMEM and
// folds the logit stream into them with a sequential loop, then leaves
// the per-edge normalization to XLA. Here the grid runs in parallel, so
// the sequential order is kept per segment instead: the caller's
// destination CSR (`perm`, `offsets`; core/aggregations.py, build_csr or
// gather_csr, stable-sorted) lists each segment's edges in stream order,
// and one thread owns one segment. It folds (m, l) in registers, then
// walks the segment again and writes the weights. The fold is a function
// of the segment's edge list alone, so a partitioned and a padded run of
// the same graph agree bitwise. The edges past offsets[S] (padding and
// other invalid edges, the CSR's tail) are written 0 by the same grid:
// thread t also zeroes the t-th tail edge, so no memset precedes the
// launch.
//
// Bound on this card: bytes. Per valid edge a 4-byte logit, a 4-byte
// perm entry and a 4-byte weight; per tail edge its perm entry and a
// zero weight; plus the offsets. About 0.7 MB at 1024 qm9 graphs per
// batch (0.2 us at 3.35 TB/s), so launch latency dominates. One thread
// per segment and not one warp: molecule graphs have ~1.3 in-edges per
// node, and a warp per segment would idle 31 lanes. A hub segment of
// thousands of edges then runs serially on one thread (two walks);
// splitting such segments across a warp is left to later work.
//
// Arithmetic: expf (not __expf) and the explicitly rounded intrinsics,
// which nvcc never contracts into an FMA, so each step rounds as the
// plain PyTorch version's separate elementwise operations do.

#include "common.cuh"

namespace repro {
namespace {

constexpr float kNegInf = -1e30f;  // the empty max (kernel.py NEG_INF)
constexpr float kTiny = 1e-30f;    // the denominator floor (TINY)

// torch.maximum / jnp.maximum: NaN in either argument propagates
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || is_nan(b)) ? b : a;
}

__global__ void __launch_bounds__(kThreadsPerBlock)
segment_softmax_kernel(const float* __restrict__ z, int num_edges,
                       const int32_t* __restrict__ perm,
                       const int32_t* __restrict__ offsets,
                       int num_segments, float* __restrict__ w) {
  const int t = blockIdx.x * kThreadsPerBlock + threadIdx.x;
  if (t < num_segments) {
    const int beg = offsets[t];
    const int end = offsets[t + 1];
    float m = kNegInf, l = 0.0f;
    for (int k = beg; k < end; ++k) {
      const int e = perm[k];
      if (e < 0 || e >= num_edges) continue;
      const float v = z[e];
      const float m_new = max_nan(m, v);
      const float corr = expf(__fsub_rn(m, m_new));
      const float p = expf(__fsub_rn(v, m_new));
      l = __fadd_rn(__fmul_rn(l, corr), p);
      m = m_new;
    }
    const float denom = max_nan(l, kTiny);
    for (int k = beg; k < end; ++k) {
      const int e = perm[k];
      if (e < 0 || e >= num_edges) continue;
      w[e] = __fdiv_rn(expf(__fsub_rn(z[e], m)), denom);
    }
  }
  // the CSR's tail: every edge left out of the segments gets weight 0
  const int tail_begin = offsets[num_segments];
  if (t < num_edges - tail_begin) {
    const int e = perm[tail_begin + t];
    if (e >= 0 && e < num_edges) w[e] = 0.0f;
  }
}

}  // namespace
}  // namespace repro

// `perm` lists all num_edges edge ids (the CSR of build_csr). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_segment_softmax(const float* z, int num_edges,
                                     const int32_t* perm,
                                     const int32_t* offsets,
                                     int num_segments, float* w,
                                     void* stream) {
  using namespace repro;
  const int threads = num_segments > num_edges ? num_segments : num_edges;
  if (threads <= 0) return 0;
  const dim3 grid((threads + kThreadsPerBlock - 1) / kThreadsPerBlock);
  segment_softmax_kernel<<<grid, kThreadsPerBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      z, num_edges, perm, offsets, num_segments, w);
  return static_cast<int>(cudaGetLastError());
}
