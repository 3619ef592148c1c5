// Shared pieces of the port's one-hot-schedule kernels
// (fused_gather_onehot.cu, segment_aggregate_onehot.cu).
//
// The schedule is the Pallas one-hot kernels': the grid runs over tiles
// of `nb` destination rows, and each tile sweeps the whole raw edge
// stream in chunks of `eb` edges, so the stream is re-read once per node
// tile. A block keeps its tile's (nb, fc) accumulator in shared memory
// (fc columns of the F-wide output; a second grid axis takes the other
// column chunks where the accumulator would not fit the shared memory a
// block can opt into). For each edge chunk it compacts the edges whose
// destination falls in the tile into a list in shared memory, keeping
// stream order (warp ballots plus a prefix over the warps), then folds
// the list: warp w owns the rows r with r % kWarpsPerBlock == w and
// walks the whole list in order, lanes over columns, so each
// destination's edges fold in stream order, as the CSR kernels fold
// them, and no two threads ever write one accumulator.
#pragma once

#include "common.cuh"

namespace repro {

// the block's tile: shared-memory layout and sizes, the same in every
// block of one launch
struct OnehotTile {
  int nb;      // destination rows per tile
  int eb;      // edges per chunk of the stream
  int fc;      // accumulator columns per block
  int tables;  // (nb, fc) float tables: 1, or 2 for Welford's mean and M2
};

// dynamic shared memory of a tile: the tables, the per-row counts and
// the compacted list (row, id, scale) of one edge chunk
inline size_t onehot_smem_bytes(const OnehotTile& t) {
  return static_cast<size_t>(t.tables) * t.nb * t.fc * sizeof(float) +
         static_cast<size_t>(t.nb) * sizeof(int) +
         static_cast<size_t>(t.eb) * (2 * sizeof(int) + sizeof(float));
}

// static shared memory the kernels use beside it (the warp counts of the
// compaction), with room to spare
constexpr size_t kOnehotStaticSmem = 1024;

// Picks the tile for S = num_segments, E = num_edges and F = f, and the
// grid: ceil(S / nb) node tiles by as many column chunks as the
// accumulator needs to fit `smem_limit` bytes (the block's opt-in
// maximum). nb = min(node_block, S) and eb = min(edge_block, E), as the
// Pallas kernels clamp them. Returns cudaErrorInvalidValue for a tile
// size below 1 or a tile whose fixed part alone does not fit.
inline cudaError_t onehot_plan(int num_segments, int num_edges, int f,
                               int node_block, int edge_block, int tables,
                               size_t smem_limit, OnehotTile* tile,
                               dim3* grid) {
  if (node_block < 1 || edge_block < 1 || num_segments < 1 ||
      num_edges < 1 || f < 0)
    return cudaErrorInvalidValue;
  OnehotTile t{node_block < num_segments ? node_block : num_segments,
               edge_block < num_edges ? edge_block : num_edges, 0, tables};
  const size_t fixed = onehot_smem_bytes(t) + kOnehotStaticSmem;
  const size_t per_col = static_cast<size_t>(tables) * t.nb * sizeof(float);
  if (smem_limit < fixed + per_col) return cudaErrorInvalidValue;
  const long long fc_max = static_cast<long long>((smem_limit - fixed) / per_col);
  long long chunks = (f + fc_max - 1) / fc_max;
  if (chunks < 1) chunks = 1;
  if (chunks > 65535) return cudaErrorInvalidValue;
  t.fc = static_cast<int>((f + chunks - 1) / chunks);
  if (t.fc < 1) t.fc = 1;
  *tile = t;
  *grid = dim3((num_segments + t.nb - 1) / t.nb, static_cast<unsigned>(chunks));
  return cudaSuccess;
}

// the opt-in shared memory limit of a block on the current device
inline size_t onehot_smem_limit() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return static_cast<size_t>(optin);
}

// Appends, in stream order, the edges e of [e0, e0 + len) for which
// `probe(e, row, id, scale)` holds to the list (list_row, list_id,
// list_scale) and returns how many it kept. Every thread of the block
// calls it; it ends with the block synchronised.
template <typename Probe>
__device__ __forceinline__ int compact_edge_chunk(int e0, int len,
                                                  Probe probe, int* list_row,
                                                  int* list_id,
                                                  float* list_scale) {
  __shared__ int warp_count[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int kept = 0;
  for (int c0 = 0; c0 < len; c0 += kThreadsPerBlock) {
    const int k = c0 + static_cast<int>(threadIdx.x);
    int row = 0, id = 0;
    float sc = 1.0f;
    const bool keep = k < len && probe(e0 + k, row, id, sc);
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_count[warp] = __popc(mask);
    __syncthreads();
    int base = kept, total = 0;
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      const int cw = warp_count[w];
      base += w < warp ? cw : 0;
      total += cw;
    }
    if (keep) {
      const int pos = base + __popc(mask & ((1u << lane) - 1u));
      list_row[pos] = row;
      list_id[pos] = id;
      list_scale[pos] = sc;
    }
    kept += total;
    __syncthreads();  // the list is complete; warp_count may be rewritten
  }
  return kept;
}

}  // namespace repro
