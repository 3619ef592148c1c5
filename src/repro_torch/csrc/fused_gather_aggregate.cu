// Fused gather -> scale -> aggregate over a destination CSR, for Hopper.
//
//   out[d, c] = agg over {e : dst[e] = d} of scale[e] * x[src[e], c]
//
// with agg in sum / mean / min / max, x stored as fp32, bf16 or int8 and
// every accumulator in fp32. The (E, F) message tensor is never written.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_gather_aggregate/kernel.py,
//   fused_gather_aggregate_v2_pallas (body _v2_kernel).
// That kernel keeps the whole node table and accumulator in VMEM and
// folds the edge stream into it with a sequential loop; here the grid
// runs in parallel, so the sequential order is kept per destination
// instead: the caller stable-sorts the edge stream by destination once
// per packed batch (`perm`, `offsets`; core/aggregations.py, gather_csr)
// and each destination's edges are folded in stream order in registers.
// Invalid edges (an id out of range on either stream, or a padding edge)
// are not in the CSR; the kernel still range-checks every id it reads
// (perm, then src) before it touches the memory that id names.
//
// Bound on this card: bytes, and at the served sizes (a few MB, ~1.3
// edges a destination) the latency of the dependent loads offsets ->
// perm -> src / scale -> row. The design cuts that chain and fills the
// card, as csrc/segment_aggregate.cu does:
//
// - a lane owns CPL consecutive columns (up to 16 bytes of a row, one
//   load, csrc/rows.cuh) and a destination takes `lanes` lanes, so its
//   CSR slice is walked once, not once per 32 columns; a narrow row
//   (F = 11) packs several destinations into a warp, a wide one splits
//   into column groups, each its own warp (kernels/fused_gather_aggregate/
//   kernel.py, gather_geometry, from the shape and the card; the index
//   arithmetic is kernels/_geometry.py's);
// - BATCH edges are in flight at once, in three rounds of independent
//   loads: their perm ids, then their sources and scales together (both
//   need only the edge id), then their rows; the batch is folded in
//   order after the rows arrive. Where segments are short (the served
//   batches) each of a destination's lanes loads its edges' ids itself
//   (a broadcast a load) and 4 edges are in flight; where they are long
//   (a hub) lane j of a destination loads edge j0 + j's id, source and
//   scale once (coalesced) and they reach the other lanes by
//   __shfl_sync, 32 registers of rows in flight (kShallowBatch and
//   deep_batch, csrc/rows.cuh; kernels/_geometry.py, rows_in_flight).
//   Each wins its side: on a 4542-edge hub the deep batch takes 0.309 ms
//   against 0.408 for four edges a lane, on the qm9 batches 1.0-3.3x
//   longer than it (H100 80GB HBM3, tools/profile_gather.py).
//
// Every output is one fold chain over its destination's valid edges in
// stream order in one lane, with __fmul_rn(x, scale) (scale 1 without a
// scale stream) and agg_fold, whatever the geometry or the batch, so
// neither changes a bit of the result, and no atomics are needed. Where
// ids are shuffled, loop bounds are uniform across the warp (the longest
// of its destinations), so the shuffles never diverge.

#include "common.cuh"
#include "rows.cuh"

namespace repro {
namespace {

template <typename T, int CPL, int AGG, int BATCH>
__global__ void __launch_bounds__(kThreadsPerBlock)
fused_gather_aggregate_kernel(const T* __restrict__ x, int n_src, int f,
                              const int32_t* __restrict__ src,
                              const float* __restrict__ scale, int num_edges,
                              const int32_t* __restrict__ perm,
                              const int32_t* __restrict__ offsets,
                              int num_segments, Geometry g,
                              float* __restrict__ out) {
  using R = Raw<T, CPL>;
  // the entry point refuses a launch of 2^26 warps or more
  const int warp = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x)
                                    >> 5);
  if (warp >= g.warps) return;             // the whole warp
  const int lane = threadIdx.x & 31;
  const int shift = __ffs(g.lanes) - 1;    // lanes a segment = 1 << shift
  const int sub = lane & (g.lanes - 1);    // lane within its segment
  const int group = warp % g.groups;
  const int seg_block = warp / g.groups;
  const int c0 = (group * g.lanes + sub) * CPL;
  const bool has_cols = c0 < f;            // then all CPL columns are
  for (int p = 0; p < g.passes; ++p) {
    const int seg = ((seg_block * g.passes + p) << (5 - shift)) +
                    (lane >> shift);
    const bool seg_ok = seg < num_segments;
    const int beg = seg_ok ? __ldg(offsets + seg) : 0;
    const int len = seg_ok ? __ldg(offsets + seg + 1) - beg : 0;
    float acc[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) acc[q] = agg_init<AGG>();
    int count = 0;
    R raw[BATCH];
    float sc[BATCH];
    bool take[BATCH];
    // rows of the batch's edges with a source in range, loaded together
    auto load_rows = [&](const int (&s)[BATCH], int valid) {
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        take[b] = has_cols && b < valid && s[b] >= 0 && s[b] < n_src;
        if (take[b])
          raw[b].load(x + static_cast<size_t>(s[b]) * f + c0);
      }
    };
    // the batch folded in stream order
    auto fold_batch = [&]() {
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (!take[b]) continue;
        ++count;
#pragma unroll
        for (int q = 0; q < CPL; ++q)
          acc[q] = agg_fold<AGG>(acc[q], __fmul_rn(raw[b].at(q), sc[b]));
      }
    };
    if constexpr (BATCH == kShallowBatch) {
      // short segments: each of a segment's lanes loads its edges' ids
      for (int j0 = 0; j0 < len; j0 += BATCH) {
        int e[BATCH], s[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b)
          e[b] = j0 + b < len ? __ldg(perm + beg + j0 + b) : -1;
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const bool edge_ok = e[b] >= 0 && e[b] < num_edges;
          s[b] = edge_ok ? __ldg(src + e[b]) : -1;
          sc[b] = edge_ok && scale != nullptr ? __ldg(scale + e[b]) : 1.0f;
        }
        load_rows(s, BATCH);
        fold_batch();
      }
    } else {
      // long segments: lane `sub` loads edge j0 + sub of its segment (id,
      // source, scale) once and they reach the segment's lanes by
      // shuffle; the warp walks as far as its longest segment
      const int longest = __reduce_max_sync(0xffffffffu, len);
      for (int j0 = 0; j0 < longest; j0 += g.lanes) {
        const int e = j0 + sub < len ? __ldg(perm + beg + j0 + sub) : -1;
        const bool edge_ok = e >= 0 && e < num_edges;
        const int my_src = edge_ok ? __ldg(src + e) : -1;
        const float my_sc =
            edge_ok && scale != nullptr ? __ldg(scale + e) : 1.0f;
        const int chunk = min(g.lanes, longest - j0);
        for (int b0 = 0; b0 < chunk; b0 += BATCH) {
          int s[BATCH];
#pragma unroll
          for (int b = 0; b < BATCH; ++b) {
            s[b] = __shfl_sync(0xffffffffu, my_src, b0 + b, g.lanes);
            sc[b] = __shfl_sync(0xffffffffu, my_sc, b0 + b, g.lanes);
          }
          load_rows(s, chunk - b0);
          fold_batch();
        }
      }
    }
    if (!seg_ok || !has_cols) continue;
    float res[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) res[q] = agg_finalize<AGG>(acc[q], count);
    store<CPL>(out + static_cast<size_t>(seg) * f + c0, res);
  }
}

struct Args {
  const void* x;
  int n_src, f;
  const int32_t* src;
  const float* scale;
  int num_edges;
  const int32_t* perm;
  const int32_t* offsets;
  int num_segments;
  Geometry g;
  bool deep;            // deep_batch() edges in flight, else kShallowBatch
  float* out;
  cudaStream_t stream;
};

template <typename T, int CPL, int AGG, int BATCH>
cudaError_t launch_batch(const Args& a) {
  const long long blocks = (a.g.warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_gather_aggregate_kernel<T, CPL, AGG, BATCH>
      <<<static_cast<unsigned>(blocks), kThreadsPerBlock, 0, a.stream>>>(
          static_cast<const T*>(a.x), a.n_src, a.f, a.src, a.scale,
          a.num_edges, a.perm, a.offsets, a.num_segments, a.g, a.out);
  return cudaGetLastError();
}

template <typename T, int CPL, int AGG>
cudaError_t launch(const Args& a) {
  constexpr int kDeep = deep_batch<T, CPL>();
  return a.deep ? launch_batch<T, CPL, AGG, kDeep>(a)
                : launch_batch<T, CPL, AGG, kShallowBatch>(a);
}

template <typename T, int CPL>
cudaError_t launch_agg(int agg, const Args& a) {
  switch (agg) {
    case kSum: return launch<T, CPL, kSum>(a);
    case kMean: return launch<T, CPL, kMean>(a);
    case kMin: return launch<T, CPL, kMin>(a);
    case kMax: return launch<T, CPL, kMax>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_typed(int cpl, int agg, const Args& a) {
  switch (cpl) {
    case 1: return launch_agg<T, 1>(agg, a);
    case 2: return launch_agg<T, 2>(agg, a);
    case 4: return launch_agg<T, 4>(agg, a);
    case 8:
      // 16 bytes of bf16, 8 of int8; fp32 tops out at 4 columns a lane
      if constexpr (sizeof(T) <= 2) return launch_agg<T, 8>(agg, a);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// x (n_src, f) in the storage type `dtype`; src (num_edges,) source ids;
// scale (num_edges,) fp32 or null; perm / offsets the destination CSR
// over num_segments >= 1 destinations; out (num_segments, f) float32.
// The geometry (kernels/fused_gather_aggregate/kernel.py,
// gather_geometry): cols_per_lane columns a lane (dividing f, at most 16
// bytes; x aligned to them), lanes_per_row lanes a destination (a power
// of two <= 32), col_groups column groups a destination, passes
// destination groups a warp and `warps` warps with work, which must
// cover every output; deep = 1 keeps 32 registers of rows in flight a
// lane, 0 four edges (kernels/_geometry.py, rows_in_flight). Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an unknown dtype or agg, or a geometry the
// kernel does not take.
extern "C" int repro_fused_gather_aggregate(
    const void* x, int dtype, int n_src, int f, const int32_t* src,
    const float* scale, int num_edges, const int32_t* perm,
    const int32_t* offsets, int num_segments, int agg, int cols_per_lane,
    int lanes_per_row, int col_groups, int passes, long long warps,
    int deep, float* out, void* stream) {
  using namespace repro;
  constexpr long long kIntMax = 0x7fffffffLL;
  const bool pow2 = lanes_per_row >= 1 && lanes_per_row <= 32 &&
                    (lanes_per_row & (lanes_per_row - 1)) == 0;
  const long long elem = dtype == kF32 ? 4 : dtype == kBF16 ? 2 : 1;
  const bool cpl_ok = cols_per_lane >= 1 && cols_per_lane * elem <= 16 &&
                      f >= 0 && f % cols_per_lane == 0;
  if (num_segments < 1 || n_src < 0 || num_edges < 0 || !pow2 || !cpl_ok ||
      col_groups < 1 || passes < 1 || warps < 1 || warps >= (1LL << 26) ||
      warps % col_groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // every output covered, and the segment ids the launch reaches fit the
  // kernel's 32-bit arithmetic
  const long long segments_covered =
      warps / col_groups * passes * (32 / lanes_per_row);
  const long long cols_covered =
      static_cast<long long>(col_groups) * lanes_per_row * cols_per_lane;
  if (segments_covered < num_segments || segments_covered > kIntMax ||
      cols_covered < f || cols_covered > kIntMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, n_src, f, src, scale, num_edges, perm, offsets,
               num_segments,
               Geometry{lanes_per_row, col_groups, passes,
                        static_cast<int>(warps)},
               deep != 0, out, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: err = launch_typed<float>(cols_per_lane, agg, a); break;
    case kBF16:
      err = launch_typed<__nv_bfloat16>(cols_per_lane, agg, a);
      break;
    case kI8: err = launch_typed<int8_t>(cols_per_lane, agg, a); break;
    default: break;
  }
  return static_cast<int>(err);
}
