// Fused gather -> scale -> aggregate on the one-hot schedule, for Hopper.
//
//   out[d, c] = agg over {e : dst[e] = d} of scale[e] * x[src[e], c]
//
// with agg in sum / mean / min / max, x stored as fp32, bf16 or int8 and
// every accumulator in fp32: the function of fused_gather_aggregate.cu,
// on the raw src/dst/scale streams instead of a destination CSR.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_gather_aggregate/kernel.py,
//   fused_gather_aggregate_pallas (body _fused_kernel), gather_mode
//   "onehot".
// That kernel runs a (node tile, edge tile) grid: each node tile sweeps
// the whole edge stream in edge_block chunks and contracts an (N, EB)
// source one-hot and an (NB, EB) destination one-hot on the MXU. Carried
// over as it was, that schedule made every block of node_block
// destinations walk all ceil(E / edge_block) chunks in a serial chain of
// barrier-bound steps (0.24 ms a launch at 1024 graphs/batch, ~20x its
// bytes). Here the tiles set buckets, not sweeps: onehot_tile.cuh sorts
// the valid edges stably by destination in two counting passes (row in
// tile, then tile; chunks of edge_block edges), reading each id twice in
// all, and the fold below runs one warp per destination over its edges
// in stream order, lanes over columns, four edges' loads in flight, with
// separately rounded multiplies and adds: bit for bit the CSR kernel's
// output in fp32. An id out of
// range on either stream drops the edge (it is neither gathered nor
// counted). No float atomics; the scratch comes from the wrapper.
//
// Bound on this card: bytes, the same as fused_gather_aggregate.cu's:
// the ids and scales once, each gathered source row, the output once.
// The bucketing adds ~20 B per edge of list traffic in L2 and five
// small launches; a chain in a block is at most ceil(edge_block / 32)
// rounds (bucketing) or one destination's degree (fold).

#include "onehot_tile.cuh"

namespace repro {
namespace {

// columns a lane folds at once: one walk over a destination's edges
// serves 32 * kFoldCols columns
constexpr int kFoldCols = 4;

template <typename T, int AGG>
__global__ void __launch_bounds__(kThreadsPerBlock)
fused_gather_onehot_fold(const T* __restrict__ x, int f,
                         OnehotLists lists, int num_segments,
                         float* __restrict__ out) {
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  onehot::wait_for_predecessor();  // the bucketing's lists
  if (seg >= num_segments) return;
  const int2 range = onehot_range(lists, seg);
  for (int c0 = 0; c0 < f; c0 += 32 * kFoldCols) {
    float acc[kFoldCols];
#pragma unroll
    for (int j = 0; j < kFoldCols; ++j) acc[j] = agg_init<AGG>();
#pragma unroll 4  // the loads of four edges in flight
    for (int k = range.x; k < range.y; ++k) {
      const float sc = lists.scale != nullptr ? lists.scale[k] : 1.0f;
      const T* xr = x + static_cast<size_t>(lists.id[k]) * f;
#pragma unroll
      for (int j = 0; j < kFoldCols; ++j) {
        const int c = c0 + 32 * j + lane;
        if (c < f)
          acc[j] = agg_fold<AGG>(acc[j], __fmul_rn(to_float(xr[c]), sc));
      }
    }
#pragma unroll
    for (int j = 0; j < kFoldCols; ++j) {
      const int c = c0 + 32 * j + lane;
      if (c < f)
        out[static_cast<size_t>(seg) * f + c] =
            agg_finalize<AGG>(acc[j], range.y - range.x);
    }
  }
}

template <typename T, int AGG>
cudaError_t launch_one(const void* x, int n_src, int f, const int32_t* src,
                       const int32_t* dst, const float* scale, int num_edges,
                       int num_segments, int node_block, int edge_block,
                       int32_t* scratch, long long scratch_len, float* out,
                       cudaStream_t stream) {
  OnehotLists lists;
  cudaError_t err = onehot_bucket(dst, src, n_src, scale, num_edges,
                                  num_segments, node_block, edge_block,
                                  scratch, scratch_len, stream, &lists);
  if (err != cudaSuccess) return err;
  // the fold starts while the last bucketing pass drains
  return onehot::launch(fused_gather_onehot_fold<T, AGG>,
                        segment_grid(num_segments), stream,
                        static_cast<const T*>(x), f, lists, num_segments,
                        out);
}

template <typename T>
cudaError_t launch_typed(int agg, const void* x, int n_src, int f,
                         const int32_t* src, const int32_t* dst,
                         const float* scale, int num_edges, int num_segments,
                         int node_block, int edge_block, int32_t* scratch,
                         long long scratch_len, float* out,
                         cudaStream_t stream) {
#define REPRO_LAUNCH(A)                                                  \
  return launch_one<T, A>(x, n_src, f, src, dst, scale, num_edges,       \
                          num_segments, node_block, edge_block, scratch, \
                          scratch_len, out, stream)
  switch (agg) {
    case kSum: REPRO_LAUNCH(kSum);
    case kMean: REPRO_LAUNCH(kMean);
    case kMin: REPRO_LAUNCH(kMin);
    case kMax: REPRO_LAUNCH(kMax);
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
extern "C" int repro_fused_gather_onehot(
    const void* x, int dtype, int n_src, int f, const int32_t* src,
    const int32_t* dst, const float* scale, int num_edges, int num_segments,
    int node_block, int edge_block, int agg, int32_t* scratch,
    long long scratch_len, float* out, void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      err = launch_typed<float>(agg, x, n_src, f, src, dst, scale, num_edges,
                                num_segments, node_block, edge_block,
                                scratch, scratch_len, out, st);
      break;
    case kBF16:
      err = launch_typed<__nv_bfloat16>(agg, x, n_src, f, src, dst, scale,
                                        num_edges, num_segments, node_block,
                                        edge_block, scratch, scratch_len, out,
                                        st);
      break;
    case kI8:
      err = launch_typed<int8_t>(agg, x, n_src, f, src, dst, scale,
                                 num_edges, num_segments, node_block,
                                 edge_block, scratch, scratch_len, out, st);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}
