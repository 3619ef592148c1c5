// Segment aggregation over a CSR of the row stream, for Hopper.
//
//   out[s, c] = agg over {e : seg[e] = s} of msg[e, c]
//
// with agg in sum / mean / min / max / var / std, msg stored as fp32,
// bf16 or int8 and every accumulator in fp32. var/std use Welford's
// update in stream order and the reference's finalize,
// max(M2 / max(count, 1), 1e-12) and its square root for std.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_aggregate/kernel.py,
//   segment_aggregate_v2_pallas (body _seg_v2_kernel).
// That kernel keeps the (S, F) accumulators (and the Welford mean/M2
// pair) resident in VMEM and folds the message stream into them with a
// sequential loop. Here one warp owns one segment and walks its rows in
// stream order through the CSR the caller built (`perm`, `offsets`;
// core/aggregations.py, build_csr), lanes over feature columns; the
// Welford state lives in registers. Rows with an out-of-range segment id
// are not in the CSR. Nothing assumes the segments are contiguous in the
// stream (pooling ids are, edge destinations are not).
//
// Bound on this card: bytes. Each row is read once at its storage width
// and the (S, F) result written once, with a handful of fp32 operations
// per element. Consecutive lanes read consecutive columns of one row, so
// each row read is a coalesced access.

#include "common.cuh"

namespace repro {
namespace {

template <typename T, int AGG>
__global__ void __launch_bounds__(kThreadsPerBlock)
segment_aggregate_kernel(const T* __restrict__ msg, int num_rows, int f,
                         const int32_t* __restrict__ perm,
                         const int32_t* __restrict__ offsets,
                         int num_segments, float* __restrict__ out) {
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= num_segments) return;
  const int beg = offsets[seg];
  const int end = offsets[seg + 1];
  for (int c = lane; c < f; c += 32) {
    float result;
    if constexpr (AGG == kVar || AGG == kStd) {
      float count = 0.0f, mean = 0.0f, m2 = 0.0f;
      for (int k = beg; k < end; ++k) {
        const int e = perm[k];
        if (e < 0 || e >= num_rows) continue;
        const float row = to_float(msg[static_cast<size_t>(e) * f + c]);
        count = __fadd_rn(count, 1.0f);
        const float delta = __fsub_rn(row, mean);
        mean = __fadd_rn(mean, __fdiv_rn(delta, fmaxf(count, 1.0f)));
        m2 = __fadd_rn(m2, __fmul_rn(delta, __fsub_rn(row, mean)));
      }
      float var = __fdiv_rn(m2, fmaxf(count, 1.0f));
      var = var < 1e-12f ? 1e-12f : var;  // clamp; NaN propagates
      result = AGG == kStd ? __fsqrt_rn(var) : var;
    } else {
      float acc = agg_init<AGG>();
      int count = 0;
      for (int k = beg; k < end; ++k) {
        const int e = perm[k];
        if (e < 0 || e >= num_rows) continue;
        acc = agg_fold<AGG>(acc, to_float(msg[static_cast<size_t>(e) * f + c]));
        ++count;
      }
      result = agg_finalize<AGG>(acc, count);
    }
    out[static_cast<size_t>(seg) * f + c] = result;
  }
}

template <typename T>
bool launch_typed(int agg, const void* msg, int num_rows, int f,
                  const int32_t* perm, const int32_t* offsets,
                  int num_segments, float* out, cudaStream_t stream) {
  const dim3 grid = segment_grid(num_segments);
  const T* mt = static_cast<const T*>(msg);
#define REPRO_LAUNCH(A)                                                 \
  segment_aggregate_kernel<T, A><<<grid, kThreadsPerBlock, 0, stream>>>( \
      mt, num_rows, f, perm, offsets, num_segments, out)
  switch (agg) {
    case kSum: REPRO_LAUNCH(kSum); return true;
    case kMean: REPRO_LAUNCH(kMean); return true;
    case kMin: REPRO_LAUNCH(kMin); return true;
    case kMax: REPRO_LAUNCH(kMax); return true;
    case kVar: REPRO_LAUNCH(kVar); return true;
    case kStd: REPRO_LAUNCH(kStd); return true;
    default: return false;
  }
#undef REPRO_LAUNCH
}

}  // namespace
}  // namespace repro

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an unknown dtype or agg code.
extern "C" int repro_segment_aggregate(const void* msg, int dtype,
                                       int num_rows, int f,
                                       const int32_t* perm,
                                       const int32_t* offsets,
                                       int num_segments, int agg, float* out,
                                       void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (dtype) {
    case kF32:
      ok = launch_typed<float>(agg, msg, num_rows, f, perm, offsets,
                               num_segments, out, st);
      break;
    case kBF16:
      ok = launch_typed<__nv_bfloat16>(agg, msg, num_rows, f, perm, offsets,
                                       num_segments, out, st);
      break;
    case kI8:
      ok = launch_typed<int8_t>(agg, msg, num_rows, f, perm, offsets,
                                num_segments, out, st);
      break;
    default:
      break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Message text of a code returned by the entry points above.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
