// The gradient of the CSR segment aggregation for bf16 messages, for
// Hopper: the bf16 entry point of csrc/segment_aggregate_bwd.cuh, which
// carries the design notes, in a translation unit of its own so that it
// compiles beside the fp32 one (csrc/segment_aggregate_bwd.cu).

#include "segment_aggregate_bwd.cuh"

// repro_segment_aggregate_backward (csrc/segment_aggregate_bwd.cu) for
// bf16 rows m (num_rows, f) and a bf16 gradient dm (num_rows, f), each
// element the fp32 gradient rounded once; out and dout fp32 as there;
// cols_per_lane 1, 2, 4 or 8 (m aligned to them, out and dout to
// min(cols_per_lane, 4) floats); deep = 1 keeps 32 / cols_per_lane rows
// in flight a lane, as the fp32 body does.
extern "C" int repro_segment_aggregate_backward_bf16(
    const __nv_bfloat16* m, int num_rows, int f, const int32_t* perm,
    const int32_t* offsets, int num_segments, int num_aggs, int codes,
    int cols_per_lane, int lanes_per_row, int col_groups, int passes,
    long long warps, int deep, const float* out, const float* dout,
    __nv_bfloat16* dm, void* stream) {
  return repro::launch_typed(m, num_rows, f, perm, offsets, num_segments,
                             num_aggs, codes, cols_per_lane, lanes_per_row,
                             col_groups, passes, warps, deep, out, dout, dm,
                             stream);
}
