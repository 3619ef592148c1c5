// The gradient of the segment softmax, for Hopper.
//
//   dz[e] = w[e] * (dw[e] - t[s])    for each edge e of segment s
//   dz[e] = 0                        for every edge not in the CSR
//
// with w the forward's weights, dw their gradient and t[s] the sum of
// w[e'] * dw[e'] over the segment's edges, folded in stream order; a
// segment of more than kLong edges (a hub) folds t in the forward's
// kParts parts (its i-th edge in part (i / kPartRun) % kParts, each part
// in stream order) merged in part order, as the forward folds its
// statistics (csrc/segment_softmax.cu). A -inf logit's weight is 0, so
// its dz is 0; an empty segment has no edge.
//
// Replaces no Pallas kernel: the JAX package's Pallas softmax has no VJP,
// and it trains through XLA's gradient of its segment_max / exp /
// segment_sum form, whose path through the segment max adds terms that
// cancel (the softmax does not depend on the shift): the two agree to
// fp32 rounding. This is the port's own kernel, the gradient of its
// forward kernel.
//
// Bound on this card: bytes (per valid edge its perm entry, w and dw
// read and dz written), and at the served sizes the latency of the
// dependent loads offsets -> perm -> w, dw. The design is the simple
// one: one warp a segment. A short segment's (at most kLong) products
// are loaded by its lanes at once (four a lane) and folded in stream
// order by shuffles, every lane holding the sum; a hub's lane j folds
// part j; then the warp writes the segment's dz, a lane an edge.
//
// Arithmetic: the explicitly rounded intrinsics, which nvcc never
// contracts into an FMA, so each step rounds as the plain version
// (kernels/segment_softmax/ref.py, segment_softmax_backward_ref) does;
// no atomics.

#include "common.cuh"

namespace repro {
namespace {

// a segment of more edges is folded in kParts parts of kPartRun
// consecutive edges (ref.py LONG, PARTS, RUN; csrc/segment_softmax.cu)
constexpr int kLong = 128;
constexpr int kParts = 32;
constexpr int kPartRun = 4;
constexpr int kShortLoads = kLong / 32;   // a short segment's loads a lane

__global__ void __launch_bounds__(kThreadsPerBlock)
segment_softmax_backward_kernel(const float* __restrict__ w,
                                const float* __restrict__ dw, int num_edges,
                                const int32_t* __restrict__ perm,
                                const int32_t* __restrict__ offsets,
                                int num_segments, float* __restrict__ dz) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  // the CSR's tail: edges in no segment get 0
  const int tail = __ldg(offsets + num_segments);
  for (long long k = tail + tid; k < num_edges; k += threads) {
    const int e = __ldg(perm + k);
    if (e >= 0 && e < num_edges) dz[e] = 0.0f;
  }
  const long long warp = tid >> 5;
  if (warp >= num_segments) return;      // the whole warp
  const int lane = threadIdx.x & 31;
  const int seg = static_cast<int>(warp);
  const int beg = __ldg(offsets + seg);
  const int len = __ldg(offsets + seg + 1) - beg;
  // w[e] * dw[e] of the segment's i-th edge, 0 for an id out of range
  auto product = [&](int i) -> float {
    const int e = __ldg(perm + beg + i);
    return e >= 0 && e < num_edges ? __fmul_rn(__ldg(w + e), __ldg(dw + e))
                                   : 0.0f;
  };
  float total = 0.0f;
  if (len <= kLong) {
    float p[kShortLoads];
#pragma unroll
    for (int t = 0; t < kShortLoads; ++t) {
      const int i = t * 32 + lane;
      p[t] = i < len ? product(i) : 0.0f;
    }
    // stream order: edge t * 32 + l is lane l's p[t]; len is uniform
#pragma unroll
    for (int t = 0; t < kShortLoads; ++t)
      for (int l = 0; l < 32 && t * 32 + l < len; ++l)
        total = __fadd_rn(total, __shfl_sync(0xffffffffu, p[t], l));
  } else {
    float part = 0.0f;        // part `lane`, in stream order
    for (int r0 = lane * kPartRun; r0 < len; r0 += kParts * kPartRun)
      for (int q = 0; q < kPartRun && r0 + q < len; ++q)
        part = __fadd_rn(part, product(r0 + q));
    for (int l = 0; l < kParts; ++l)
      total = __fadd_rn(total, __shfl_sync(0xffffffffu, part, l));
  }
  for (int i = lane; i < len; i += 32) {
    const int e = __ldg(perm + beg + i);
    if (e < 0 || e >= num_edges) continue;
    dz[e] = __fmul_rn(__ldg(w + e), __fsub_rn(__ldg(dw + e), total));
  }
}

}  // namespace
}  // namespace repro

// w / dw (num_edges,) fp32, the forward's weights and their gradient;
// perm (num_edges,) / offsets (num_segments + 1,) the segment CSR with
// every edge in perm (the tail past offsets[num_segments] gets 0); dz
// (num_edges,) fp32. Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for a size the kernel does not
// take.
extern "C" int repro_segment_softmax_backward(const float* w, const float* dw,
                                              int num_edges,
                                              const int32_t* perm,
                                              const int32_t* offsets,
                                              int num_segments, float* dz,
                                              void* stream) {
  using namespace repro;
  if (num_edges < 0 || num_segments < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      (static_cast<long long>(num_segments) + kWarpsPerBlock - 1) /
      kWarpsPerBlock;
  segment_softmax_backward_kernel<<<static_cast<unsigned>(blocks),
                                    kThreadsPerBlock, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      w, dw, num_edges, perm, offsets, num_segments, dz);
  return static_cast<int>(cudaGetLastError());
}
