// The gradient of the CSR gather's min and max, for Hopper: the tie
// weights over the destination CSR, and dx over the source CSR.
//
// The forward (csrc/fused_gather_aggregate.cu) folds each destination's
// messages p_e = x[src_e, c] * scale_e (x upcast to fp32, one rounded
// multiply) into their min or max. Its gradient is JAX's, the gradient of
// segment_max / segment_min: an output's gradient is split equally among
// the edges whose message ties the extreme (kernels/fused_gather_aggregate/
// ref.py, the min/max formulas):
//
//   gather_tie_weights_kernel, a pass over the destination CSR: for each
//     (d, c) the raw extreme ext (the forward's fold, before it zeroes a
//     non-finite result) and cnt, the valid edges into d whose message
//     equals it; w = dout / cnt. Where ext is not finite (an empty
//     segment, a +-inf or NaN message) no edge wins: w = 0 and ext is
//     written as NaN, which equals no message;
//   gather_minmax_dx_kernel, a pass over the source CSR: dx[s, c] = the
//     sum, over the edges e out of s in stream order, of scale_e * w[dst_e,
//     c] where p_e == ext[dst_e, c].
//
// The third part, the scale's gradient, is the masked body of
// csrc/fused_gather_aggregate_bwd.cu.
//
// Replaces no Pallas kernel: the JAX package's Pallas gathers have no VJP,
// and it trains a min or max gather through XLA's gradient of jnp.take and
// segment_max / segment_min. These are the port's own kernels, the
// gradient of its forward kernel, on the path of a user's conv that
// aggregates by max or min (GraphSAGE with the max aggregator).
//
// Bound on this card: bytes (the tie weights: the forward's reads, dout
// read, w and ext written; dx: each out-edge's w and ext rows, x read and
// dx written once) and, at the served sizes (~2 edges a node), the latency
// of the dependent loads offsets -> perm -> ids -> rows. The design is the
// forward's shallow batch (csrc/rows.cuh, kShallowBatch):
//
// - the launch is the forward's lane geometry (kernels/_geometry.py,
//   lane_geometry, through kernels/fused_gather_aggregate/kernel.py,
//   minmax_geometry): a lane owns CPL consecutive columns of its row's
//   fp32 tables (CPL <= 4, one 16-byte load of w, ext or dout), a narrow
//   row (F = 11) packs several rows into a warp, a wide one splits into
//   column groups;
// - four edges are in flight a lane: their ids, then their sources (or
//   destinations) and scales, then their rows, each round of loads
//   independent; then they are folded in stream order. Each of a row's
//   lanes loads its edges' ids itself (a broadcast a load), so no lane
//   waits on another and no shuffle is needed;
// - the tie weights fold the extreme and its count in one pass: a message
//   equal to the running extreme adds one, a new extreme (or a NaN, which
//   the forward's fold propagates) restarts the count at one. The extreme
//   so folded is the forward's bit for bit, and where it is finite the
//   count is the plain version's two-pass count;
// - dx reads its source's x row once, before the edges, and writes its
//   row once, fp32 or rounded once to bf16 (the table's dtype).
//
// Every sum folds in stream order in one lane with the explicitly rounded
// intrinsics (never contracted into an FMA), so no geometry changes a
// bit, and no atomics are needed: each output has one writer. An id out
// of range drops its edge.

#include "common.cuh"
#include "rows.cuh"

namespace repro {
namespace {

// the extreme written where none is finite: a NaN equals no message
__device__ __forceinline__ float no_extreme() {
  return __int_as_float(0x7fc00000);
}

// one message into the running extreme and its count of ties; the
// extreme follows agg_fold (common.cuh) bit for bit
template <int AGG>
__device__ __forceinline__ void tie_fold(float& ext, int& cnt, float v) {
  if (v == ext) {
    ++cnt;
    return;
  }
  const bool wins = AGG == kMax ? v > ext : v < ext;
  if (wins || is_nan(v)) {
    ext = v;
    cnt = 1;
  }
}

// a lane's place in the launch (the forward's index arithmetic)
struct Lane {
  int warp, shift, group, seg_block, c0, lane;
  __device__ __forceinline__ Lane(const Geometry& g, int cpl) {
    warp = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
    lane = threadIdx.x & 31;
    shift = __ffs(g.lanes) - 1;
    group = warp % g.groups;
    seg_block = warp / g.groups;
    c0 = (group * g.lanes + (lane & (g.lanes - 1))) * cpl;
  }
  __device__ __forceinline__ int row(const Geometry& g, int p) const {
    return ((seg_block * g.passes + p) << (5 - shift)) + (lane >> shift);
  }
};

template <typename T, int CPL, int AGG>
__global__ void __launch_bounds__(kThreadsPerBlock)
gather_tie_weights_kernel(const T* __restrict__ x, int n_src, int f,
                          const int32_t* __restrict__ src,
                          const float* __restrict__ scale, int num_edges,
                          const int32_t* __restrict__ perm,
                          const int32_t* __restrict__ offsets,
                          int num_segments, Geometry g,
                          const float* __restrict__ dout,
                          float* __restrict__ w, float* __restrict__ ext) {
  constexpr int B = kShallowBatch;
  const Lane at(g, CPL);
  // no shuffles here: a lane with no columns or rows may leave
  if (at.warp >= g.warps || at.c0 >= f) return;
  for (int p = 0; p < g.passes; ++p) {
    const int seg = at.row(g, p);
    if (seg >= num_segments) return;       // later passes lie further on
    const int beg = __ldg(offsets + seg);
    const int len = __ldg(offsets + seg + 1) - beg;
    float acc[CPL];
    int cnt[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      acc[q] = agg_init<AGG>();
      cnt[q] = 0;
    }
    for (int j0 = 0; j0 < len; j0 += B) {
      int e[B], s[B];
      float sc[B];
      Raw<T, CPL> raw[B];
#pragma unroll
      for (int b = 0; b < B; ++b)
        e[b] = j0 + b < len ? __ldg(perm + beg + j0 + b) : -1;
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const bool edge_ok = e[b] >= 0 && e[b] < num_edges;
        s[b] = edge_ok ? __ldg(src + e[b]) : -1;
        sc[b] = edge_ok && scale != nullptr ? __ldg(scale + e[b]) : 1.0f;
      }
#pragma unroll
      for (int b = 0; b < B; ++b)
        if (s[b] >= 0 && s[b] < n_src)
          raw[b].load(x + static_cast<size_t>(s[b]) * f + at.c0);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (s[b] < 0 || s[b] >= n_src) continue;
#pragma unroll
        for (int q = 0; q < CPL; ++q)
          tie_fold<AGG>(acc[q], cnt[q], __fmul_rn(raw[b].at(q), sc[b]));
      }
    }
    const size_t off = static_cast<size_t>(seg) * f + at.c0;
    Floats<CPL> d;
    d.load(dout + off);
    float wv[CPL], ev[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const bool won = is_finite(acc[q]);
      wv[q] = won ? __fdiv_rn(d.at(q), static_cast<float>(cnt[q])) : 0.0f;
      ev[q] = won ? acc[q] : no_extreme();
    }
    store<CPL>(w + off, wv);
    store<CPL>(ext + off, ev);
  }
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kThreadsPerBlock)
gather_minmax_dx_kernel(const T* __restrict__ x, int n_src, int f,
                        const float* __restrict__ scale,
                        const float* __restrict__ w,
                        const float* __restrict__ ext, int num_segments,
                        const int32_t* __restrict__ dst, int num_edges,
                        const int32_t* __restrict__ s_perm,
                        const int32_t* __restrict__ s_offsets, Geometry g,
                        T* __restrict__ dx) {
  constexpr int B = kShallowBatch;
  const Lane at(g, CPL);
  if (at.warp >= g.warps || at.c0 >= f) return;
  for (int p = 0; p < g.passes; ++p) {
    const int s = at.row(g, p);
    if (s >= n_src) return;
    const int beg = __ldg(s_offsets + s);
    const int len = __ldg(s_offsets + s + 1) - beg;
    Raw<T, CPL> xr;
    xr.load(x + static_cast<size_t>(s) * f + at.c0);
    float acc[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) acc[q] = 0.0f;
    for (int j0 = 0; j0 < len; j0 += B) {
      int e[B], d[B];
      float sc[B];
      Floats<CPL> wr[B], er[B];
#pragma unroll
      for (int b = 0; b < B; ++b)
        e[b] = j0 + b < len ? __ldg(s_perm + beg + j0 + b) : -1;
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const bool edge_ok = e[b] >= 0 && e[b] < num_edges;
        const int dd = edge_ok ? __ldg(dst + e[b]) : -1;
        d[b] = dd >= 0 && dd < num_segments ? dd : -1;
        sc[b] = edge_ok && scale != nullptr ? __ldg(scale + e[b]) : 1.0f;
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (d[b] < 0) continue;
        const size_t off = static_cast<size_t>(d[b]) * f + at.c0;
        wr[b].load(w + off);
        er[b].load(ext + off);
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (d[b] < 0) continue;
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          if (__fmul_rn(xr.at(q), sc[b]) != er[b].at(q)) continue;
          const float c = scale != nullptr ? __fmul_rn(wr[b].at(q), sc[b])
                                           : wr[b].at(q);
          acc[q] = __fadd_rn(acc[q], c);
        }
      }
    }
    store<CPL>(dx + static_cast<size_t>(s) * f + at.c0, acc);
  }
}

// the geometry's checks, shared by both entry points: CPL columns a lane
// (1, 2 or 4, dividing f), a power-of-two lanes a row, and a launch that
// covers every row and column within the kernels' 32-bit arithmetic
bool geometry_ok(int rows, int f, int cpl, int lanes, int groups, int passes,
                 long long warps) {
  constexpr long long kIntMax = 0x7fffffffLL;
  const bool pow2 = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (rows < 1 || f < 0 || !pow2 || (cpl != 1 && cpl != 2 && cpl != 4) ||
      f % cpl != 0 || groups < 1 || passes < 1 || warps < 1 ||
      warps >= (1LL << 26) || warps % groups != 0)
    return false;
  const long long rows_covered = warps / groups * passes * (32 / lanes);
  const long long cols_covered = static_cast<long long>(groups) * lanes * cpl;
  return rows_covered >= rows && rows_covered <= kIntMax &&
         cols_covered >= f && cols_covered <= kIntMax;
}

unsigned blocks_of(long long warps) {
  return static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <typename T, int CPL, int AGG>
cudaError_t launch_ties(const void* x, int n_src, int f, const int32_t* src,
                        const float* scale, int num_edges,
                        const int32_t* perm, const int32_t* offsets,
                        int num_segments, const Geometry& g,
                        const float* dout, float* w, float* ext,
                        cudaStream_t st) {
  gather_tie_weights_kernel<T, CPL, AGG>
      <<<blocks_of(g.warps), kThreadsPerBlock, 0, st>>>(
          static_cast<const T*>(x), n_src, f, src, scale, num_edges, perm,
          offsets, num_segments, g, dout, w, ext);
  return cudaGetLastError();
}

template <typename T, int AGG>
cudaError_t ties_by_cpl(int cpl, const void* x, int n_src, int f,
                        const int32_t* src, const float* scale,
                        int num_edges, const int32_t* perm,
                        const int32_t* offsets, int num_segments,
                        const Geometry& g, const float* dout, float* w,
                        float* ext, cudaStream_t st) {
  switch (cpl) {
    case 1: return launch_ties<T, 1, AGG>(x, n_src, f, src, scale, num_edges,
                                          perm, offsets, num_segments, g,
                                          dout, w, ext, st);
    case 2: return launch_ties<T, 2, AGG>(x, n_src, f, src, scale, num_edges,
                                          perm, offsets, num_segments, g,
                                          dout, w, ext, st);
    case 4: return launch_ties<T, 4, AGG>(x, n_src, f, src, scale, num_edges,
                                          perm, offsets, num_segments, g,
                                          dout, w, ext, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t ties_by_agg(int agg, int cpl, const void* x, int n_src, int f,
                        const int32_t* src, const float* scale,
                        int num_edges, const int32_t* perm,
                        const int32_t* offsets, int num_segments,
                        const Geometry& g, const float* dout, float* w,
                        float* ext, cudaStream_t st) {
  if (agg == kMin)
    return ties_by_cpl<T, kMin>(cpl, x, n_src, f, src, scale, num_edges,
                                perm, offsets, num_segments, g, dout, w, ext,
                                st);
  if (agg == kMax)
    return ties_by_cpl<T, kMax>(cpl, x, n_src, f, src, scale, num_edges,
                                perm, offsets, num_segments, g, dout, w, ext,
                                st);
  return cudaErrorInvalidValue;
}

template <typename T, int CPL>
cudaError_t launch_dx(const void* x, int n_src, int f, const float* scale,
                      const float* w, const float* ext, int num_segments,
                      const int32_t* dst, int num_edges,
                      const int32_t* s_perm, const int32_t* s_offsets,
                      const Geometry& g, void* dx, cudaStream_t st) {
  gather_minmax_dx_kernel<T, CPL>
      <<<blocks_of(g.warps), kThreadsPerBlock, 0, st>>>(
          static_cast<const T*>(x), n_src, f, scale, w, ext, num_segments,
          dst, num_edges, s_perm, s_offsets, g, static_cast<T*>(dx));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dx_by_cpl(int cpl, const void* x, int n_src, int f,
                      const float* scale, const float* w, const float* ext,
                      int num_segments, const int32_t* dst, int num_edges,
                      const int32_t* s_perm, const int32_t* s_offsets,
                      const Geometry& g, void* dx, cudaStream_t st) {
  switch (cpl) {
    case 1: return launch_dx<T, 1>(x, n_src, f, scale, w, ext, num_segments,
                                   dst, num_edges, s_perm, s_offsets, g, dx,
                                   st);
    case 2: return launch_dx<T, 2>(x, n_src, f, scale, w, ext, num_segments,
                                   dst, num_edges, s_perm, s_offsets, g, dx,
                                   st);
    case 4: return launch_dx<T, 4>(x, n_src, f, scale, w, ext, num_segments,
                                   dst, num_edges, s_perm, s_offsets, g, dx,
                                   st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// The tie weights. x (n_src, f) fp32 or bf16 (`dtype`, csrc/common.cuh's
// codes), aligned to cols_per_lane elements; src (num_edges,) source ids;
// scale (num_edges,) fp32 or null; perm / offsets the destination CSR over
// num_segments >= 1 destinations; agg min or max; dout, w and ext
// (num_segments, f) fp32, aligned to cols_per_lane floats. The geometry
// (kernels/fused_gather_aggregate/kernel.py, minmax_geometry) over the
// num_segments rows: cols_per_lane 1, 2 or 4 dividing f, lanes_per_row a
// power of two <= 32, col_groups, passes and warps covering every output.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an unknown dtype or agg, or a geometry the
// kernel does not take.
extern "C" int repro_gather_tie_weights(
    const void* x, int dtype, int n_src, int f, const int32_t* src,
    const float* scale, int num_edges, const int32_t* perm,
    const int32_t* offsets, int num_segments, int agg, int cols_per_lane,
    int lanes_per_row, int col_groups, int passes, long long warps,
    const float* dout, float* w, float* ext, void* stream) {
  using namespace repro;
  if (n_src < 0 || num_edges < 0 ||
      !geometry_ok(num_segments, f, cols_per_lane, lanes_per_row, col_groups,
                   passes, warps))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{lanes_per_row, col_groups, passes,
                   static_cast<int>(warps)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kF32)
    err = ties_by_agg<float>(agg, cols_per_lane, x, n_src, f, src, scale,
                             num_edges, perm, offsets, num_segments, g, dout,
                             w, ext, st);
  else if (dtype == kBF16)
    err = ties_by_agg<__nv_bfloat16>(agg, cols_per_lane, x, n_src, f, src,
                                     scale, num_edges, perm, offsets,
                                     num_segments, g, dout, w, ext, st);
  return static_cast<int>(err);
}

// dx. x (n_src, f) fp32 or bf16 (`dtype`), aligned to cols_per_lane
// elements; scale (num_edges,) fp32 or null; w and ext (num_segments, f)
// fp32 from repro_gather_tie_weights, aligned to cols_per_lane floats; dst
// (num_edges,) each edge's destination (-1 for none); s_perm / s_offsets
// the source CSR over the n_src >= 1 rows of x; dx (n_src, f) of x's
// dtype. The geometry as above, over the n_src rows. Returns as above.
extern "C" int repro_gather_minmax_dx(
    const void* x, int dtype, int n_src, int f, const float* scale,
    const float* w, const float* ext, int num_segments, const int32_t* dst,
    int num_edges, const int32_t* s_perm, const int32_t* s_offsets,
    int cols_per_lane, int lanes_per_row, int col_groups, int passes,
    long long warps, void* dx, void* stream) {
  using namespace repro;
  if (num_segments < 0 || num_edges < 0 ||
      !geometry_ok(n_src, f, cols_per_lane, lanes_per_row, col_groups,
                   passes, warps))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{lanes_per_row, col_groups, passes,
                   static_cast<int>(warps)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kF32)
    err = dx_by_cpl<float>(cols_per_lane, x, n_src, f, scale, w, ext,
                           num_segments, dst, num_edges, s_perm, s_offsets, g,
                           dx, st);
  else if (dtype == kBF16)
    err = dx_by_cpl<__nv_bfloat16>(cols_per_lane, x, n_src, f, scale, w, ext,
                                   num_segments, dst, num_edges, s_perm,
                                   s_offsets, g, dx, st);
  return static_cast<int>(err);
}
