// Segment aggregation on the one-hot schedule, for Hopper.
//
//   out[s, c] = agg over {e : seg[e] = s} of msg[e, c]
//
// with agg in sum / mean / min / max / var / std, msg stored as fp32,
// bf16 or int8 and every accumulator in fp32: the function of
// segment_aggregate.cu, on the raw segment-id stream instead of a CSR.
// var/std use Welford's update in stream order and the finalize
// max(M2 / max(count, 1), 1e-12) and its square root for std.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_aggregate/kernel.py,
//   segment_aggregate_pallas (body _seg_kernel), gather_mode "onehot".
// That kernel runs a (node tile, edge tile) grid: each node tile sweeps
// the whole message stream in edge_block chunks and routes the chunk
// into its (NB, F) accumulator through an (NB, EB) destination one-hot
// (an MXU product for sum/mean, a masked reduce for min/max, a loop over
// the chunk for Welford). Carried over as it was, that schedule ran
// ceil(S / node_block) blocks, 8 of 132 SMs for the pooling at 1024
// graphs/batch, each walking all ceil(E / edge_block) chunks in series
// (0.45 ms a launch). Here the tiles set buckets, not sweeps:
// onehot_tile.cuh sorts the valid rows stably by segment in two counting
// passes (row in tile, then tile; chunks of edge_block rows), and the
// fold below runs one warp per segment (S / 8 blocks: 128 at S = 1024)
// over its rows in stream order, lanes over columns, four rows' loads in
// flight, the Welford state in registers, with the CSR kernel's
// separately rounded operations: bit for bit its output in fp32. A row
// whose id lies outside [0, S) is dropped. No float atomics; the
// scratch comes from the wrapper.
//
// Bound on this card: bytes, the same as segment_aggregate.cu's: each
// row once at its storage width, the ids once, the (S, F) output once.
// The bucketing adds ~12 B per row of list traffic in L2 and five small
// launches; a chain in a block is at most ceil(edge_block / 32) rounds
// (bucketing) or one segment's row count (fold).

#include "onehot_tile.cuh"

namespace repro {
namespace {

// columns a lane folds at once: one walk over a segment's rows serves
// 32 * kFoldCols columns
constexpr int kFoldCols = 4;

template <typename T, int AGG>
__global__ void __launch_bounds__(kThreadsPerBlock)
segment_aggregate_onehot_fold(const T* __restrict__ msg, int f,
                              OnehotLists lists, int num_segments,
                              float* __restrict__ out) {
  constexpr bool kWelford = AGG == kVar || AGG == kStd;
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  onehot::wait_for_predecessor();  // the bucketing's lists
  if (seg >= num_segments) return;
  const int2 range = onehot_range(lists, seg);
  for (int c0 = 0; c0 < f; c0 += 32 * kFoldCols) {
    // Welford: acc is the running mean; count steps by 1.0 as the CSR
    // kernel's does (exact below 2^24)
    float acc[kFoldCols], m2[kFoldCols];
#pragma unroll
    for (int j = 0; j < kFoldCols; ++j) {
      acc[j] = kWelford ? 0.0f : agg_init<AGG>();
      m2[j] = 0.0f;
    }
    float count = 0.0f;
#pragma unroll 4  // the loads of four edges in flight
    for (int k = range.x; k < range.y; ++k) {
      const T* mr = msg + static_cast<size_t>(lists.id[k]) * f;
      count = __fadd_rn(count, 1.0f);
#pragma unroll
      for (int j = 0; j < kFoldCols; ++j) {
        const int c = c0 + 32 * j + lane;
        if (c >= f) continue;
        const float row = to_float(mr[c]);
        if constexpr (kWelford) {
          const float delta = __fsub_rn(row, acc[j]);
          acc[j] = __fadd_rn(acc[j], __fdiv_rn(delta, fmaxf(count, 1.0f)));
          m2[j] = __fadd_rn(m2[j], __fmul_rn(delta, __fsub_rn(row, acc[j])));
        } else {
          acc[j] = agg_fold<AGG>(acc[j], row);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kFoldCols; ++j) {
      const int c = c0 + 32 * j + lane;
      if (c >= f) continue;
      float result;
      if constexpr (kWelford) {
        float var = __fdiv_rn(m2[j], fmaxf(count, 1.0f));
        var = var < 1e-12f ? 1e-12f : var;  // clamp; NaN propagates
        result = AGG == kStd ? __fsqrt_rn(var) : var;
      } else {
        result = agg_finalize<AGG>(acc[j], range.y - range.x);
      }
      out[static_cast<size_t>(seg) * f + c] = result;
    }
  }
}

template <typename T, int AGG>
cudaError_t launch_one(const void* msg, int num_rows, int f,
                       const int32_t* seg, int num_segments, int node_block,
                       int edge_block, int32_t* scratch, long long scratch_len,
                       float* out, cudaStream_t stream) {
  OnehotLists lists;
  cudaError_t err = onehot_bucket(seg, nullptr, 0, nullptr, num_rows,
                                  num_segments, node_block, edge_block,
                                  scratch, scratch_len, stream, &lists);
  if (err != cudaSuccess) return err;
  // the fold starts while the last bucketing pass drains
  return onehot::launch(segment_aggregate_onehot_fold<T, AGG>,
                        segment_grid(num_segments), stream,
                        static_cast<const T*>(msg), f, lists, num_segments,
                        out);
}

template <typename T>
cudaError_t launch_typed(int agg, const void* msg, int num_rows, int f,
                         const int32_t* seg, int num_segments, int node_block,
                         int edge_block, int32_t* scratch,
                         long long scratch_len, float* out,
                         cudaStream_t stream) {
#define REPRO_LAUNCH(A)                                                    \
  return launch_one<T, A>(msg, num_rows, f, seg, num_segments, node_block, \
                          edge_block, scratch, scratch_len, out, stream)
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

// Returns cudaGetLastError() after the last launch (0 = launched), the
// first launch error, or cudaErrorInvalidValue for an unknown dtype or
// agg code, a tile size below 1, or a scratch buffer of fewer int32
// entries than the layout needs (kernels/_onehot.py scratch_layout).
extern "C" int repro_segment_aggregate_onehot(
    const void* msg, int dtype, int num_rows, int f, const int32_t* seg,
    int num_segments, int node_block, int edge_block, int agg,
    int32_t* scratch, long long scratch_len, float* out, void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      err = launch_typed<float>(agg, msg, num_rows, f, seg, num_segments,
                                node_block, edge_block, scratch, scratch_len,
                                out, st);
      break;
    case kBF16:
      err = launch_typed<__nv_bfloat16>(agg, msg, num_rows, f, seg,
                                        num_segments, node_block, edge_block,
                                        scratch, scratch_len, out, st);
      break;
    case kI8:
      err = launch_typed<int8_t>(agg, msg, num_rows, f, seg, num_segments,
                                 node_block, edge_block, scratch, scratch_len,
                                 out, st);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}
