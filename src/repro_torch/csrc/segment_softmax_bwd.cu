// The gradient of the segment softmax, for Hopper.
//
//   dz[e] = w[e] * (dw[e] - t[s])    for each edge e of segment s
//   dz[e] = 0                        for every edge not in the CSR
//
// with w the forward's weights, dw their gradient and t[s] the sum of
// w[e'] * dw[e'] over the segment's edges, folded in stream order; a
// segment of more than kLong edges (a hub) folds t in the forward's
// kParts parts (its i-th edge in part (i / kPartRun) % kParts, each part
// in stream order) merged in part order, as the forward folds its
// statistics (csrc/segment_softmax.cu). A -inf logit's weight is 0, so
// its dz is 0; an empty segment has no edge.
//
// Replaces no Pallas kernel: the JAX package's Pallas softmax has no VJP,
// and it trains through XLA's gradient of its segment_max / exp /
// segment_sum form, whose path through the segment max adds terms that
// cancel (the softmax does not depend on the shift): the two agree to
// fp32 rounding. This is the port's own kernel, the gradient of its
// forward kernel.
//
// Bound on this card: bytes (per valid edge its perm entry, w and dw
// read and dz written), and at the served sizes the latency of the
// dependent loads offsets -> perm -> w, dw and the launch itself (GAT's
// destination segments hold ~2 edges: 0.9 MB at 1024 graphs). The
// design packs the short segments into lanes, so the launch is about one
// wave of warps and each chain is walked once:
//
// - a warp takes a run of kRun = 32 consecutive segments, lane i the
//   segment s0 + i (the forward's layout): the run's offsets are one
//   coalesced load, and its edges one contiguous slice of perm, which
//   the lanes read side by side;
// - a lane loads the ids of the first kEdges edges of its segment, then
//   their w and dw, every load in flight, and folds the products in
//   stream order in registers; it writes dz from the same registers,
//   with no second read of perm, w or dw. A segment of more than kEdges
//   edges (and at most kLong) is walked kEdges edges at a time: the last
//   ones stay in registers for the writes, the ones before them are read
//   again;
// - a hub is folded by the whole warp as before: lane j folds part j,
//   the parts merge in order by shuffles, then the warp writes its dz,
//   a lane an edge;
// - the edges past offsets[S] (the CSR's tail) are zeroed by the same
//   grid, thread t its tail edges t, t + threads, ..., its first tail id
//   loaded beside the run's offsets.
//
// The fold is a function of the segment's own edge list, so the split
// into runs and batches changes no bit. 2 or 8 edges in flight, and 1, 2
// or 8 warps a block, measured slower at GAT's call (PERF.md, the
// backward design steps).
//
// Arithmetic: the explicitly rounded intrinsics, which nvcc never
// contracts into an FMA, so each step rounds as the plain version
// (kernels/segment_softmax/ref.py, segment_softmax_backward_ref) does;
// no atomics.

#include "common.cuh"

namespace repro {
namespace {

// a segment of more edges is folded in kParts parts of kPartRun
// consecutive edges (ref.py LONG, PARTS, RUN; csrc/segment_softmax.cu)
constexpr int kLong = 128;
constexpr int kParts = 32;
constexpr int kPartRun = 4;
constexpr int kRun = 32;           // segments a warp, one a lane
constexpr int kWarps = 4;          // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kEdges = 4;          // edges a lane keeps in flight

__global__ void __launch_bounds__(kThreads)
segment_softmax_backward_kernel(const float* __restrict__ w,
                                const float* __restrict__ dw, int num_edges,
                                const int32_t* __restrict__ perm,
                                const int32_t* __restrict__ offsets,
                                int num_segments, float* __restrict__ dz) {
  const int lane = threadIdx.x & 31;
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int threads = gridDim.x * kThreads;
  const int run = gtid >> 5;
  const int s = min(run * kRun + lane, num_segments);
  // the offsets of the run and of the CSR's tail in one round trip
  const int beg = __ldg(offsets + s);
  const int end = __ldg(offsets + min(s + 1, num_segments));
  const int tail_begin = __ldg(offsets + num_segments);
  const int tail = num_edges - tail_begin;
  // this thread's first tail id, loaded beside the run's offsets
  const int first_tail = gtid < tail ? __ldg(perm + tail_begin + gtid) : -1;
  if (run * kRun < num_segments) {         // the whole warp
    const int len = end - beg;             // 0 past the last segment
    const bool is_long = len > kLong;
    if (!is_long) {
      int e[kEdges];
      float a[kEdges], b[kEdges];
      // the ids of edges j0 .. j0 + kEdges, then their w and dw, in flight
      auto load = [&](int j0) {
#pragma unroll
        for (int t = 0; t < kEdges; ++t)
          e[t] = j0 + t < len ? __ldg(perm + beg + j0 + t) : -1;
#pragma unroll
        for (int t = 0; t < kEdges; ++t) {
          e[t] = e[t] >= 0 && e[t] < num_edges ? e[t] : -1;
          a[t] = e[t] >= 0 ? __ldg(w + e[t]) : 0.0f;
          b[t] = e[t] >= 0 ? __ldg(dw + e[t]) : 0.0f;
        }
      };
      // the sum in stream order, an id out of range adding 0
      float total = 0.0f;
      int last = -1;
      for (int j0 = 0; j0 < len; j0 += kEdges) {
        load(j0);
#pragma unroll
        for (int t = 0; t < kEdges; ++t)
          if (j0 + t < len)
            total = __fadd_rn(total,
                              e[t] >= 0 ? __fmul_rn(a[t], b[t]) : 0.0f);
        last = j0;
      }
      auto write = [&]() {
#pragma unroll
        for (int t = 0; t < kEdges; ++t)
          if (e[t] >= 0) dz[e[t]] = __fmul_rn(a[t], __fsub_rn(b[t], total));
      };
      // the edges still in registers, then the ones before them
      if (last >= 0) write();
      for (int j0 = 0; j0 < last; j0 += kEdges) {
        load(j0);
        write();
      }
    }
    // the hubs, each by the whole warp
    for (unsigned hubs = __ballot_sync(0xffffffffu, is_long); hubs;
         hubs &= hubs - 1) {
      const int o = __ffs(hubs) - 1;
      const int hb = __shfl_sync(0xffffffffu, beg, o);
      const int hl = __shfl_sync(0xffffffffu, len, o);
      // w[e] * dw[e] of the hub's i-th edge, 0 for an id out of range
      auto product = [&](int i) -> float {
        const int e = __ldg(perm + hb + i);
        return e >= 0 && e < num_edges
                   ? __fmul_rn(__ldg(w + e), __ldg(dw + e)) : 0.0f;
      };
      float part = 0.0f;        // part `lane`, in stream order
      for (int r0 = lane * kPartRun; r0 < hl; r0 += kParts * kPartRun)
        for (int q = 0; q < kPartRun && r0 + q < hl; ++q)
          part = __fadd_rn(part, product(r0 + q));
      float total = 0.0f;
      for (int l = 0; l < kParts; ++l)
        total = __fadd_rn(total, __shfl_sync(0xffffffffu, part, l));
      for (int i = lane; i < hl; i += 32) {
        const int e = __ldg(perm + hb + i);
        if (e < 0 || e >= num_edges) continue;
        dz[e] = __fmul_rn(__ldg(w + e), __fsub_rn(__ldg(dw + e), total));
      }
    }
  }
  // every edge left out of the segments gets 0
  if (first_tail >= 0 && first_tail < num_edges) dz[first_tail] = 0.0f;
  for (int t = gtid + threads; t < tail; t += threads) {
    const int e = __ldg(perm + tail_begin + t);
    if (e >= 0 && e < num_edges) dz[e] = 0.0f;
  }
}

}  // namespace
}  // namespace repro

// w / dw (num_edges,) fp32, the forward's weights and their gradient;
// perm (num_edges,) / offsets (num_segments + 1,) the segment CSR with
// every edge in perm (the tail past offsets[num_segments] gets 0); dz
// (num_edges,) fp32. Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for a size the kernel does not
// take.
extern "C" int repro_segment_softmax_backward(const float* w, const float* dw,
                                              int num_edges,
                                              const int32_t* perm,
                                              const int32_t* offsets,
                                              int num_segments, float* dz,
                                              void* stream) {
  using namespace repro;
  if (num_edges < 0 || num_segments < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long runs = (static_cast<long long>(num_segments) + kRun - 1) /
                         kRun;
  const long long blocks = (runs + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL / kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  segment_softmax_backward_kernel<<<static_cast<unsigned>(blocks), kThreads,
                                    0, static_cast<cudaStream_t>(stream)>>>(
      w, dw, num_edges, perm, offsets, num_segments, dz);
  return static_cast<int>(cudaGetLastError());
}
