// The gradient of the CSR segment aggregation for fp32 messages, for
// Hopper: the fp32 entry point of csrc/segment_aggregate_bwd.cuh, which
// carries the design notes (its bf16 entry point is
// csrc/segment_aggregate_bwd_bf16.cu).

#include "segment_aggregate_bwd.cuh"

// m (num_rows, f) fp32 rows; perm (num_rows,) / offsets (num_segments +
// 1,) the segment CSR with every row in perm (the tail past
// offsets[num_segments] gets 0); codes: 4 bits an output slot, slot i the
// agg code of the set's i-th agg (1 <= num_aggs <= 6, distinct); out /
// dout (num_segments, num_aggs * f) fp32; dm (num_rows, f) fp32. The
// geometry (kernels/segment_aggregate/kernel.py,
// segment_backward_geometry): cols_per_lane columns a lane (1, 2 or 4,
// dividing f; m, out and dout aligned to them), lanes_per_row lanes a
// segment (a power of two <= 32), col_groups column groups a segment,
// passes segment groups a warp and `warps` warps with work; deep = 1
// keeps 32 registers of rows in flight a lane, 0 four rows
// (kernels/_geometry.py, rows_in_flight). Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for a size,
// agg set or geometry the kernel does not take.
extern "C" int repro_segment_aggregate_backward(
    const float* m, int num_rows, int f, const int32_t* perm,
    const int32_t* offsets, int num_segments, int num_aggs, int codes,
    int cols_per_lane, int lanes_per_row, int col_groups, int passes,
    long long warps, int deep, const float* out, const float* dout,
    float* dm, void* stream) {
  return repro::launch_typed(m, num_rows, f, perm, offsets, num_segments,
                             num_aggs, codes, cols_per_lane, lanes_per_row,
                             col_groups, passes, warps, deep, out, dout, dm,
                             stream);
}
