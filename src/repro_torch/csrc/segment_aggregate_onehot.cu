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
// the chunk for Welford). This kernel keeps the schedule
// (onehot_tile.cuh: one block per node tile, the id stream re-read once
// per tile in edge_block chunks, the chunk's rows into the tile compacted
// in stream order) and folds the kept rows directly, lanes over columns.
// Each segment folds its rows in stream order with separately rounded
// operations, as the CSR kernel does, so the two agree bit for bit in
// fp32. Welford's mean and M2 take two (nb, fc) tables: where they would
// not fit a block's shared memory (nb 128 at F 256 needs 256 KiB), the
// columns split over a second grid axis.
//
// Bound on this card: bytes, and the schedule itself. The function moves
// what segment_aggregate.cu moves; the schedule adds the re-read of the
// id stream (4 B per row) once per node tile and two block barriers per
// chunk of 256 rows.

#include "onehot_tile.cuh"

namespace repro {
namespace {

template <typename T, int AGG>
__global__ void __launch_bounds__(kThreadsPerBlock)
segment_aggregate_onehot_kernel(const T* __restrict__ msg, int num_rows,
                                int f, const int32_t* __restrict__ seg,
                                int num_segments, OnehotTile tile,
                                float* __restrict__ out) {
  constexpr bool kWelford = AGG == kVar || AGG == kStd;
  extern __shared__ float smem[];
  const int nb = tile.nb, fc = tile.fc;
  const size_t table = static_cast<size_t>(nb) * fc;
  float* acc = smem;                       // Welford: the running mean
  float* m2 = acc + table;                 // Welford only
  int* cnt = reinterpret_cast<int*>(acc + tile.tables * table);
  int* list_row = cnt + nb;
  int* list_id = list_row + tile.eb;
  float* list_scale = reinterpret_cast<float*>(list_id + tile.eb);

  const int row0 = blockIdx.x * nb;
  const int rows = min(nb, num_segments - row0);
  const int col0 = blockIdx.y * fc;
  const int cols = max(0, min(fc, f - col0));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (size_t i = threadIdx.x; i < table; i += kThreadsPerBlock) {
    acc[i] = kWelford ? 0.0f : agg_init<AGG>();
    if constexpr (kWelford) m2[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < nb; i += kThreadsPerBlock) cnt[i] = 0;
  __syncthreads();

  auto probe = [&](int e, int& row, int& id, float&) {
    const int d = seg[e];
    if (d < row0 || d >= row0 + rows) return false;
    row = d - row0;
    id = e;
    return true;
  };
  for (int e0 = 0; e0 < num_rows; e0 += tile.eb) {
    const int len = min(tile.eb, num_rows - e0);
    const int kept =
        compact_edge_chunk(e0, len, probe, list_row, list_id, list_scale);
    for (int k = 0; k < kept; ++k) {
      const int r = list_row[k];
      if (r % kWarpsPerBlock != warp) continue;  // warp-uniform
      const T* mr = msg + static_cast<size_t>(list_id[k]) * f + col0;
      float* a = acc + static_cast<size_t>(r) * fc;
      const int c_new = cnt[r] + 1;
      if constexpr (kWelford) {
        // the count as the CSR kernel keeps it, a float stepped by 1.0
        // (exact below 2^24)
        const float count = static_cast<float>(c_new);
        float* q = m2 + static_cast<size_t>(r) * fc;
        for (int c = lane; c < cols; c += 32) {
          const float v = to_float(mr[c]);
          const float delta = __fsub_rn(v, a[c]);
          const float mean = __fadd_rn(a[c], __fdiv_rn(delta, fmaxf(count, 1.0f)));
          q[c] = __fadd_rn(q[c], __fmul_rn(delta, __fsub_rn(v, mean)));
          a[c] = mean;
        }
      } else {
        for (int c = lane; c < cols; c += 32)
          a[c] = agg_fold<AGG>(a[c], to_float(mr[c]));
      }
      __syncwarp();  // every lane has read cnt[r]
      if (lane == 0) cnt[r] = c_new;
      __syncwarp();
    }
    __syncthreads();  // the next chunk rewrites the list
  }
  for (int r = warp; r < rows; r += kWarpsPerBlock) {
    float* o = out + static_cast<size_t>(row0 + r) * f + col0;
    const float* a = acc + static_cast<size_t>(r) * fc;
    for (int c = lane; c < cols; c += 32) {
      if constexpr (kWelford) {
        const float count = static_cast<float>(cnt[r]);
        float var = __fdiv_rn(m2[static_cast<size_t>(r) * fc + c],
                              fmaxf(count, 1.0f));
        var = var < 1e-12f ? 1e-12f : var;  // clamp; NaN propagates
        o[c] = AGG == kStd ? __fsqrt_rn(var) : var;
      } else {
        o[c] = agg_finalize<AGG>(a[c], cnt[r]);
      }
    }
  }
}

template <typename T, int AGG>
cudaError_t launch_one(const void* msg, int num_rows, int f,
                       const int32_t* seg, int num_segments, int node_block,
                       int edge_block, float* out, cudaStream_t stream) {
  constexpr int kTables = (AGG == kVar || AGG == kStd) ? 2 : 1;
  const size_t limit = onehot_smem_limit();
  OnehotTile tile;
  dim3 grid;
  cudaError_t err = onehot_plan(num_segments, num_rows, f, node_block,
                                edge_block, kTables, limit, &tile, &grid);
  if (err != cudaSuccess) return err;
  auto kernel = segment_aggregate_onehot_kernel<T, AGG>;
  const size_t smem = onehot_smem_bytes(tile);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(limit - kOnehotStaticSmem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreadsPerBlock, smem, stream>>>(
      static_cast<const T*>(msg), num_rows, f, seg, num_segments, tile, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(int agg, const void* msg, int num_rows, int f,
                         const int32_t* seg, int num_segments, int node_block,
                         int edge_block, float* out, cudaStream_t stream) {
#define REPRO_LAUNCH(A)                                                  \
  return launch_one<T, A>(msg, num_rows, f, seg, num_segments, node_block, \
                          edge_block, out, stream)
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

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an unknown dtype or agg code, a tile size
// below 1, or a tile that does not fit the block's shared memory.
extern "C" int repro_segment_aggregate_onehot(
    const void* msg, int dtype, int num_rows, int f, const int32_t* seg,
    int num_segments, int node_block, int edge_block, int agg, float* out,
    void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      err = launch_typed<float>(agg, msg, num_rows, f, seg, num_segments,
                                node_block, edge_block, out, st);
      break;
    case kBF16:
      err = launch_typed<__nv_bfloat16>(agg, msg, num_rows, f, seg,
                                        num_segments, node_block, edge_block,
                                        out, st);
      break;
    case kI8:
      err = launch_typed<int8_t>(agg, msg, num_rows, f, seg, num_segments,
                                 node_block, edge_block, out, st);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}
