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
// source one-hot and an (NB, EB) destination one-hot on the MXU. What the
// JAX package keeps it for is that schedule, which makes node_block and
// edge_block observable; this kernel keeps the schedule
// (onehot_tile.cuh: one block per node tile, the stream re-read once per
// tile in edge_block chunks, the chunk's edges into the tile compacted in
// stream order) and replaces the one-hot contractions by a direct fold:
// each kept edge reads its source row, lanes over columns. Each
// destination folds its edges in stream order with separately rounded
// multiplies and adds, as the CSR kernel does, so the two agree bit for
// bit in fp32. An id out of range on either stream drops the edge (it is
// neither gathered nor counted).
//
// Bound on this card: bytes, and the schedule itself. The function moves
// what fused_gather_aggregate.cu moves; the schedule adds the re-read of
// the two id streams (8 B per edge) once per node tile, from L2 at the
// path's sizes, and two block barriers per chunk of 256 edges.

#include "onehot_tile.cuh"

namespace repro {
namespace {

template <typename T, int AGG>
__global__ void __launch_bounds__(kThreadsPerBlock)
fused_gather_onehot_kernel(const T* __restrict__ x, int n_src, int f,
                           const int32_t* __restrict__ src,
                           const int32_t* __restrict__ dst,
                           const float* __restrict__ scale, int num_edges,
                           int num_segments, OnehotTile tile,
                           float* __restrict__ out) {
  extern __shared__ float smem[];
  const int nb = tile.nb, fc = tile.fc;
  float* acc = smem;
  int* cnt = reinterpret_cast<int*>(acc + static_cast<size_t>(nb) * fc);
  int* list_row = cnt + nb;
  int* list_id = list_row + tile.eb;
  float* list_scale = reinterpret_cast<float*>(list_id + tile.eb);

  const int row0 = blockIdx.x * nb;
  const int rows = min(nb, num_segments - row0);
  const int col0 = blockIdx.y * fc;
  const int cols = max(0, min(fc, f - col0));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < nb * fc; i += kThreadsPerBlock)
    acc[i] = agg_init<AGG>();
  for (int i = threadIdx.x; i < nb; i += kThreadsPerBlock) cnt[i] = 0;
  __syncthreads();

  auto probe = [&](int e, int& row, int& id, float& sc) {
    const int s = src[e];
    const int d = dst[e];
    if (s < 0 || s >= n_src || d < row0 || d >= row0 + rows) return false;
    row = d - row0;
    id = s;
    sc = scale != nullptr ? scale[e] : 1.0f;
    return true;
  };
  for (int e0 = 0; e0 < num_edges; e0 += tile.eb) {
    const int len = min(tile.eb, num_edges - e0);
    const int kept =
        compact_edge_chunk(e0, len, probe, list_row, list_id, list_scale);
    for (int k = 0; k < kept; ++k) {
      const int r = list_row[k];
      if (r % kWarpsPerBlock != warp) continue;  // warp-uniform
      const T* xr = x + static_cast<size_t>(list_id[k]) * f + col0;
      const float sc = list_scale[k];
      float* a = acc + static_cast<size_t>(r) * fc;
      for (int c = lane; c < cols; c += 32)
        a[c] = agg_fold<AGG>(a[c], __fmul_rn(to_float(xr[c]), sc));
      if (lane == 0) cnt[r] += 1;
    }
    __syncthreads();  // the next chunk rewrites the list
  }
  for (int r = warp; r < rows; r += kWarpsPerBlock) {
    float* o = out + static_cast<size_t>(row0 + r) * f + col0;
    for (int c = lane; c < cols; c += 32)
      o[c] = agg_finalize<AGG>(acc[static_cast<size_t>(r) * fc + c], cnt[r]);
  }
}

template <typename T, int AGG>
cudaError_t launch_one(const void* x, int n_src, int f, const int32_t* src,
                       const int32_t* dst, const float* scale, int num_edges,
                       int num_segments, int node_block, int edge_block,
                       float* out, cudaStream_t stream) {
  const size_t limit = onehot_smem_limit();
  OnehotTile tile;
  dim3 grid;
  cudaError_t err = onehot_plan(num_segments, num_edges, f, node_block,
                                edge_block, 1, limit, &tile, &grid);
  if (err != cudaSuccess) return err;
  auto kernel = fused_gather_onehot_kernel<T, AGG>;
  const size_t smem = onehot_smem_bytes(tile);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(limit - kOnehotStaticSmem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreadsPerBlock, smem, stream>>>(
      static_cast<const T*>(x), n_src, f, src, dst, scale, num_edges,
      num_segments, tile, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(int agg, const void* x, int n_src, int f,
                         const int32_t* src, const int32_t* dst,
                         const float* scale, int num_edges, int num_segments,
                         int node_block, int edge_block, float* out,
                         cudaStream_t stream) {
#define REPRO_LAUNCH(A)                                                  \
  return launch_one<T, A>(x, n_src, f, src, dst, scale, num_edges,       \
                          num_segments, node_block, edge_block, out, stream)
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

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an unknown dtype or agg code, a tile size
// below 1, or a tile that does not fit the block's shared memory.
extern "C" int repro_fused_gather_onehot(
    const void* x, int dtype, int n_src, int f, const int32_t* src,
    const int32_t* dst, const float* scale, int num_edges, int num_segments,
    int node_block, int edge_block, int agg, float* out, void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      err = launch_typed<float>(agg, x, n_src, f, src, dst, scale, num_edges,
                                num_segments, node_block, edge_block, out,
                                st);
      break;
    case kBF16:
      err = launch_typed<__nv_bfloat16>(agg, x, n_src, f, src, dst, scale,
                                        num_edges, num_segments, node_block,
                                        edge_block, out, st);
      break;
    case kI8:
      err = launch_typed<int8_t>(agg, x, n_src, f, src, dst, scale,
                                 num_edges, num_segments, node_block,
                                 edge_block, out, st);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}
