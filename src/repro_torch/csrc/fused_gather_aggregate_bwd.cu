// The per-edge scale's gradient of the CSR gather, for Hopper.
//
//   dscale[e] = w[e] * sum over c of dout[dst[e], c] * x[src[e], c]
//
// for an edge whose destination lies in [0, S) and whose source lies in
// [0, N); 0 for every other edge (padding, or an edge the gather's CSR
// left out: dst[e] = -1). w[e] is 1 for a sum gather (no weight stream)
// and 1 / max(cnt, 1) for a mean (kernels/fused_gather_aggregate/ref.py,
// backward_coefficients). GAT's attention weights ride the gather's
// scale slot, so this is their gradient.
//
// Replaces no Pallas kernel: the JAX package's Pallas gathers have no
// VJP, and it trains through XLA's gradient of jnp.take and segment_sum.
// This is the port's own kernel, the gradient of its forward kernel
// (csrc/fused_gather_aggregate.cu). The gather's other gradient, dx, is
// that forward kernel itself over the source CSR
// (kernels/fused_gather_aggregate/ops.py).
//
// Bound on this card: bytes. Per valid edge two rows of F fp32 values
// (the destination's output gradient, the source's row), its two ids
// and one output; no reuse worth staging at ~1.3 edges a destination.
// The design is the simple one: one warp an edge, lane l reading
// columns l, l + 32, ... of both rows (coalesced), a product and an add
// a column in registers, then a butterfly over the 32 lanes
// (__shfl_xor_sync, offsets 16, 8, 4, 2, 1). The warp's edge is
// uniform over its lanes, so every lane reaches the shuffles.
//
// Arithmetic: the explicitly rounded intrinsics, which nvcc never
// contracts into an FMA, so the sum rounds step for step as the plain
// version (ref.py, gather_scale_backward_ref) does; no atomics.

#include "common.cuh"

namespace repro {
namespace {

__global__ void __launch_bounds__(kThreadsPerBlock)
gather_scale_backward_kernel(const float* __restrict__ dout,
                             int num_segments, int f,
                             const float* __restrict__ x, int n_src,
                             const int32_t* __restrict__ src,
                             const int32_t* __restrict__ dst,
                             const float* __restrict__ weight,
                             int num_edges, float* __restrict__ out) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (warp >= num_edges) return;          // the whole warp
  const int e = static_cast<int>(warp);
  const int lane = threadIdx.x & 31;
  const int d = __ldg(dst + e);
  const int s = __ldg(src + e);
  const bool ok = d >= 0 && d < num_segments && s >= 0 && s < n_src;
  float acc = 0.0f;
  if (ok) {
    const float* drow = dout + static_cast<size_t>(d) * f;
    const float* xrow = x + static_cast<size_t>(s) * f;
    for (int c = lane; c < f; c += 32)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(drow + c), __ldg(xrow + c)));
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if (lane == 0) {
    float v = 0.0f;
    if (ok) v = weight != nullptr ? __fmul_rn(acc, __ldg(weight + e)) : acc;
    out[e] = v;
  }
}

}  // namespace
}  // namespace repro

// dout (num_segments, f) fp32; x (n_src, f) fp32; src / dst
// (num_edges,) int32, each edge's source and destination (-1 for an edge
// in no segment); weight (num_edges,) fp32 or null; out (num_edges,)
// fp32. Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a negative size.
extern "C" int repro_gather_scale_backward(const float* dout,
                                           int num_segments, int f,
                                           const float* x, int n_src,
                                           const int32_t* src,
                                           const int32_t* dst,
                                           const float* weight,
                                           int num_edges, float* out,
                                           void* stream) {
  using namespace repro;
  if (num_segments < 0 || f < 0 || n_src < 0 || num_edges < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_edges == 0) return 0;
  const long long blocks =
      (static_cast<long long>(num_edges) + kWarpsPerBlock - 1) /
      kWarpsPerBlock;
  gather_scale_backward_kernel<<<static_cast<unsigned>(blocks),
                                 kThreadsPerBlock, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      dout, num_segments, f, x, n_src, src, dst, weight, num_edges, out);
  return static_cast<int>(cudaGetLastError());
}
