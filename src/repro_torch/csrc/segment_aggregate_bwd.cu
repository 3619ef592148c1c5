// The gradient of the CSR segment aggregation, for Hopper.
//
// Given the forward's output out (S, A * F) of an agg set (A aggs, agg i
// in columns i * F ... (i + 1) * F) and its gradient dout, each row m of
// segment s (c valid rows) gets, column by column, the sum in the set's
// order of its aggs' terms:
//
//   sum   dout
//   mean  dout / max(c, 1)
//   min   dout / ties on a row equal to the output, 0 on the others, and
//   max   0 for every row where the fold's extreme was not finite
//   var   dout * (2 (m - mu) / max(c, 1))
//   std   dout * ((m - mu) / (max(c, 1) * std))
//
// with mu = sum / max(c, 1), ties the segment's rows equal to the output,
// and var and std 0 where the forward's floor max(var, 1e-12) binds (a
// one-row segment among them: 0, never inf or NaN). The min/max rule is
// JAX's: the gradient of segment_max splits equally among tied rows.
// Rows in no segment (the CSR's tail) get 0.
//
// Replaces no Pallas kernel: the JAX package's Pallas segment kernels
// have no VJP, and it trains through XLA's gradient of segment_sum /
// segment_min / segment_max. This is the port's own kernel, the gradient
// of its forward kernel (csrc/segment_aggregate.cu), one launch for a
// whole agg set (PNA's four towers, the pooling set), as the forward.
//
// Bound on this card: bytes (the rows read, the output and its gradient
// read, the (E, F) gradient written) and, at the served sizes, the
// latency of the dependent loads offsets -> perm -> row. The design is
// the simple one: one warp a segment, lane l owning columns l, l + 32,
// ...; for each column the warp walks the segment's rows twice in
// stream order, once for the sum and the ties, once to write each row's
// gradient. A segment's rows are read twice from L2 or memory; a later
// redesign can keep them in registers as the forward does.
//
// Arithmetic: the explicitly rounded intrinsics, which nvcc never
// contracts into an FMA, so each term rounds as the plain version
// (kernels/segment_aggregate/ref.py, segment_aggregate_backward_ref)
// does; no atomics (each row lies in one segment, one warp writes it).

#include "common.cuh"

namespace repro {
namespace {

constexpr float kVarFloor = 1e-12f;   // the forward's floor

__global__ void __launch_bounds__(kThreadsPerBlock)
segment_aggregate_backward_kernel(const float* __restrict__ m, int num_rows,
                                  int f, const int32_t* __restrict__ perm,
                                  const int32_t* __restrict__ offsets,
                                  int num_segments, int num_aggs, int codes,
                                  const float* __restrict__ out,
                                  const float* __restrict__ dout,
                                  float* __restrict__ dm) {
  const long long gwarp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const int lane = threadIdx.x & 31;
  // the CSR's tail: rows in no segment get 0
  const int tail = __ldg(offsets + num_segments);
  for (long long k = tail + gwarp; k < num_rows; k += warps) {
    const int r = __ldg(perm + k);
    if (r < 0 || r >= num_rows) continue;
    for (int c = lane; c < f; c += 32) dm[static_cast<size_t>(r) * f + c] = 0.0f;
  }
  if (gwarp >= num_segments) return;
  const int seg = static_cast<int>(gwarp);
  const int beg = __ldg(offsets + seg);
  const int len = __ldg(offsets + seg + 1) - beg;
  const size_t width = static_cast<size_t>(num_aggs) * f;
  const float* o_row = out + seg * width;
  const float* d_row = dout + seg * width;
  const float std_floor = sqrtf(kVarFloor);
  bool has_min = false, has_max = false;
  for (int i = 0; i < num_aggs; ++i) {
    const int code = (codes >> (4 * i)) & 0xF;
    has_min |= code == kMin;
    has_max |= code == kMax;
  }
  for (int c = lane; c < f; c += 32) {
    float o_min = 0.0f, o_max = 0.0f, o_var = 0.0f, o_std = 0.0f;
    for (int i = 0; i < num_aggs; ++i) {
      const int code = (codes >> (4 * i)) & 0xF;
      const float o = __ldg(o_row + i * f + c);
      if (code == kMin) o_min = o;
      if (code == kMax) o_max = o;
      if (code == kVar) o_var = o;
      if (code == kStd) o_std = o;
    }
    // pass 1: the sum, the count, the extremes and the ties
    float total = 0.0f;
    float ext_min = agg_init<kMin>(), ext_max = agg_init<kMax>();
    int count = 0, ties_min = 0, ties_max = 0;
    for (int k = 0; k < len; ++k) {
      const int r = __ldg(perm + beg + k);
      if (r < 0 || r >= num_rows) continue;
      const float v = __ldg(m + static_cast<size_t>(r) * f + c);
      total = __fadd_rn(total, v);
      ++count;
      if (has_min) {
        ext_min = agg_fold<kMin>(ext_min, v);
        ties_min += v == o_min;
      }
      if (has_max) {
        ext_max = agg_fold<kMax>(ext_max, v);
        ties_max += v == o_max;
      }
    }
    const float cnt = static_cast<float>(count > 1 ? count : 1);
    const float mu = __fdiv_rn(total, cnt);
    // the extreme's rows get a gradient only where the output is the
    // fold's (finite) extreme
    const bool live_min = ext_min == o_min, live_max = ext_max == o_max;
    const bool var_ok = o_var > kVarFloor, std_ok = o_std > std_floor;
    // pass 2: each row's gradient, its aggs' terms in the set's order
    for (int k = 0; k < len; ++k) {
      const int r = __ldg(perm + beg + k);
      if (r < 0 || r >= num_rows) continue;
      const size_t at = static_cast<size_t>(r) * f + c;
      const float v = __ldg(m + at);
      float g = 0.0f;
      for (int i = 0; i < num_aggs; ++i) {
        const int code = (codes >> (4 * i)) & 0xF;
        const float d = __ldg(d_row + i * f + c);
        float t = 0.0f;
        switch (code) {
          case kSum: t = d; break;
          case kMean: t = __fdiv_rn(d, cnt); break;
          case kMin:
            if (live_min && v == o_min)
              t = __fdiv_rn(d, static_cast<float>(ties_min));
            break;
          case kMax:
            if (live_max && v == o_max)
              t = __fdiv_rn(d, static_cast<float>(ties_max));
            break;
          case kVar:
            if (var_ok)
              t = __fmul_rn(d, __fdiv_rn(__fmul_rn(2.0f, __fsub_rn(v, mu)),
                                         cnt));
            break;
          case kStd:
            if (std_ok)
              t = __fmul_rn(d, __fdiv_rn(__fsub_rn(v, mu),
                                         __fmul_rn(cnt, o_std)));
            break;
          default: break;
        }
        g = __fadd_rn(g, t);
      }
      dm[at] = g;
    }
  }
}

}  // namespace
}  // namespace repro

// m (num_rows, f) fp32 rows; perm (num_rows,) / offsets (num_segments +
// 1,) the segment CSR with every row in perm (the tail past
// offsets[num_segments] gets 0); codes: 4 bits an output slot, slot i the
// agg code of the set's i-th agg (1 <= num_aggs <= 6, distinct); out /
// dout (num_segments, num_aggs * f) fp32; dm (num_rows, f) fp32. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a size or agg set the kernel does not take.
extern "C" int repro_segment_aggregate_backward(
    const float* m, int num_rows, int f, const int32_t* perm,
    const int32_t* offsets, int num_segments, int num_aggs, int codes,
    const float* out, const float* dout, float* dm, void* stream) {
  using namespace repro;
  if (num_rows < 0 || f < 0 || num_segments < 1 || num_aggs < 1 ||
      num_aggs > 6)
    return static_cast<int>(cudaErrorInvalidValue);
  int seen = 0;
  for (int i = 0; i < num_aggs; ++i) {
    const int code = (codes >> (4 * i)) & 0xF;
    if (code > kStd || (seen >> code) & 1)
      return static_cast<int>(cudaErrorInvalidValue);
    seen |= 1 << code;
  }
  const long long blocks =
      (static_cast<long long>(num_segments) + kWarpsPerBlock - 1) /
      kWarpsPerBlock;
  segment_aggregate_backward_kernel<<<static_cast<unsigned>(blocks),
                                      kThreadsPerBlock, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      m, num_rows, f, perm, offsets, num_segments, num_aggs, codes, out,
      dout, dm);
  return static_cast<int>(cudaGetLastError());
}
