// Segment softmax over a CSR of the edge stream, for Hopper.
//
//   w[e] = exp(z[e] - m[s]) / max(l[s], 1e-30)   for each edge e of segment s
//   w[e] = 0                                     for every edge not in the CSR
//
// with m[s] the running max of segment s's logits (the empty max clamped
// at NEG_INF = -1e30) and l[s] their exp-sum, folded online in stream
// order: m' = max(m, z); l' = l * exp(m - m') + exp(z - m'). A -inf logit
// leaves m unchanged and adds exp(-inf) = 0, so it never meets
// -inf - -inf; an all -inf or empty segment gives l = 0 and weights 0.
// The arguments of exp are never positive, so +-1e4 logits stay finite.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/segment_softmax/kernel.py,
//   segment_softmax_stats_pallas (body _softmax_stats_kernel) and the
//   per-edge normalization of segment_softmax_pallas.
// The TPU kernel keeps the (S,) m and l tables resident in VMEM and
// folds the logit stream into them with a sequential loop, then leaves
// the per-edge normalization to XLA. Here the grid runs in parallel, so
// the sequential order is kept per segment instead: the caller's
// destination CSR (`perm`, `offsets`; core/aggregations.py, build_csr or
// gather_csr, stable-sorted) lists each segment's edges in stream order.
//
// Bound on this card: bytes. Per valid edge a 4-byte logit, a 4-byte
// perm entry and a 4-byte weight; per tail edge its perm entry and a
// zero weight; plus the offsets. About 0.7 MB at 1024 qm9 graphs per
// batch (0.2 us at 3.35 TB/s), so the latency of the dependent loads
// offsets -> perm -> logit dominates, and the design cuts that chain to
// one pass of each:
//
// - a warp takes a run of kRun = 32 consecutive segments, lane i the
//   segment s0 + i: the run's offsets are one coalesced load, and its
//   edges are one contiguous slice of perm;
// - the warp stages the slice kStage entries at a time in shared memory:
//   every lane loads its perm entries, then the logits of those ids, all
//   in flight at once (molecule graphs have ~1.3 in-edges a node, so a
//   run's ~40 edges are one chunk);
// - each lane folds its own segment's (m, l) from the staged logits, in
//   stream order, with the same operations as the plain version, and
//   marks its staged entries as its own; the warp then writes the run's
//   weights from the staged values, every lane an entry, each with its
//   owner's (m, l), without a second trip to global memory for perm and
//   z (a lane writing its own segment's weights in series, or finding an
//   entry's owner by a binary search of the run's offsets, took longer on
//   the H100: PERF.md, the softmax design steps);
// - a segment of more than kLong edges (a hub) is folded by the whole
//   warp: lane j folds part j of it (kPartRun consecutive edges in every
//   kParts * kPartRun, in stream order, their loads in flight), then the
//   32 parts' (m, l) merge in part order, m' = max(m, m_j), l' =
//   l * exp(m - m') + l_j * exp(m_j - m'), and the whole warp writes its
//   weights; the plain version (ref.py) folds such a segment in the same
//   parts and order. A run of more than kStage edges is staged again
//   chunk by chunk for the weights (a chunk inside long segments only is
//   never staged).
//
// The fold, split or not, is a function of the segment's edge list
// alone, so a partitioned and a padded run of the same graph agree
// bitwise. The
// edges past offsets[S] (padding and other invalid edges, the CSR's
// tail) are written 0 by the same grid: thread t zeroes the tail edges
// t, t + threads, ..., its first tail id loaded before the run's work,
// so no memset precedes the launch.
//
// Arithmetic: expf (not __expf) and the explicitly rounded intrinsics,
// which nvcc never contracts into an FMA, so each step rounds as the
// plain PyTorch version's separate elementwise operations do.

#include "common.cuh"

namespace repro {
namespace {

constexpr float kNegInf = -1e30f;  // the empty max (kernel.py NEG_INF)
constexpr float kTiny = 1e-30f;    // the denominator floor (TINY)
constexpr int kRun = 32;           // segments a warp, one a lane
constexpr int kStage = 128;        // CSR entries a warp stages at once
constexpr int kPerLane = kStage / 32;
constexpr int kWarps = 4;          // warps a block: 217 blocks at 1024 graphs
constexpr int kThreads = kWarps * 32;
// a segment of more than kLong edges (a hub) is folded by the whole warp
// in kParts parts: its i-th edge goes to part (i / kPartRun) % kParts
// (ref.py LONG, PARTS, RUN)
constexpr int kLong = 128;
constexpr int kParts = 32;
constexpr int kPartRun = 4;

// torch.maximum / jnp.maximum: NaN in either argument propagates
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || is_nan(b)) ? b : a;
}

struct Stage {
  int e[kStage];     // the edge id, -1 where the entry is out of range
  float z[kStage];   // its logit
  int owner[kStage]; // the lane of the short segment holding it, or -1
};

// entries k0 .. k0 + kStage of perm (those below `end`) and the logits
// of their ids into the warp's stage: every perm load, then every logit
// load, in flight at once
__device__ __forceinline__ void stage_chunk(Stage& st,
                                            const float* __restrict__ z,
                                            int num_edges,
                                            const int32_t* __restrict__ perm,
                                            int k0, int end, int lane) {
  int e[kPerLane];
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int k = k0 + t * 32 + lane;
    e[t] = k < end ? __ldg(perm + k) : -1;
  }
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const bool ok = e[t] >= 0 && e[t] < num_edges;
    st.e[t * 32 + lane] = ok ? e[t] : -1;
    st.z[t * 32 + lane] = ok ? __ldg(z + e[t]) : 0.0f;
    st.owner[t * 32 + lane] = -1;          // set by the short lanes
  }
  __syncwarp();
}

// the online update of (m, l) by one logit
__device__ __forceinline__ void fold(float& m, float& l, float v) {
  const float m_new = max_nan(m, v);
  const float corr = expf(__fsub_rn(m, m_new));
  const float p = expf(__fsub_rn(v, m_new));
  l = __fadd_rn(__fmul_rn(l, corr), p);
  m = m_new;
}

__device__ __forceinline__ float weight(float v, float m, float denom) {
  return __fdiv_rn(expf(__fsub_rn(v, m)), denom);
}

// a long segment [beg, end) folded by the whole warp: lane j folds part
// j (kPartRun consecutive edges in every kParts * kPartRun), every load
// of a step in flight; then the parts' (m, l) merge in part order, the
// same in every lane
__device__ __forceinline__ void fold_long(const float* __restrict__ z,
                                          int num_edges,
                                          const int32_t* __restrict__ perm,
                                          int beg, int end, int lane,
                                          float& m, float& l) {
  float pm = kNegInf, pl = 0.0f;
  for (int c0 = beg + kPartRun * lane; c0 < end;
       c0 += kParts * kPartRun) {
    int e[kPartRun];
    float v[kPartRun];
#pragma unroll
    for (int t = 0; t < kPartRun; ++t)
      e[t] = c0 + t < end ? __ldg(perm + c0 + t) : -1;
#pragma unroll
    for (int t = 0; t < kPartRun; ++t) {
      e[t] = e[t] >= 0 && e[t] < num_edges ? e[t] : -1;
      v[t] = e[t] >= 0 ? __ldg(z + e[t]) : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < kPartRun; ++t)
      if (e[t] >= 0) fold(pm, pl, v[t]);
  }
  m = __shfl_sync(0xffffffffu, pm, 0);
  l = __shfl_sync(0xffffffffu, pl, 0);
  for (int j = 1; j < kParts; ++j) {
    const float mj = __shfl_sync(0xffffffffu, pm, j);
    const float lj = __shfl_sync(0xffffffffu, pl, j);
    const float m_new = max_nan(m, mj);
    l = __fadd_rn(__fmul_rn(l, expf(__fsub_rn(m, m_new))),
                  __fmul_rn(lj, expf(__fsub_rn(mj, m_new))));
    m = m_new;
  }
}

__global__ void __launch_bounds__(kThreads)
segment_softmax_kernel(const float* __restrict__ z, int num_edges,
                       const int32_t* __restrict__ perm,
                       const int32_t* __restrict__ offsets,
                       int num_segments, float* __restrict__ w) {
  __shared__ Stage stages[kWarps];
  __shared__ float run_m[kWarps][kRun];
  __shared__ float run_denom[kWarps][kRun];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int threads = gridDim.x * kThreads;
  const int run = blockIdx.x * kWarps + wib;
  const int s = min(run * kRun + lane, num_segments);
  // the offsets of the run and of the CSR's tail in one round trip
  const int beg = __ldg(offsets + s);
  const int end = __ldg(offsets + min(s + 1, num_segments));
  const int tail_begin = __ldg(offsets + num_segments);
  const int tail = num_edges - tail_begin;
  // this thread's first tail id, loaded beside the run's first ids
  const int first_tail = gtid < tail ? __ldg(perm + tail_begin + gtid) : -1;
  if (run * kRun < num_segments) {         // the whole warp
    Stage& st = stages[wib];
    const int run_begin = __shfl_sync(0xffffffffu, beg, 0);
    const int run_end = __shfl_sync(0xffffffffu, end, kRun - 1);
    const bool is_long = end - beg > kLong;
    float m = kNegInf, l = 0.0f;
    // the short segments, each in its lane from the staged chunks (a
    // chunk inside long segments only is not staged)
    for (int k0 = run_begin; k0 < run_end; k0 += kStage) {
      const int lo = max(beg, k0);
      const int hi = min(end, k0 + kStage);
      if (!__any_sync(0xffffffffu, !is_long && lo < hi)) continue;
      stage_chunk(st, z, num_edges, perm, k0, run_end, lane);
      for (int k = lo; k < hi && !is_long; ++k) {
        st.owner[k - k0] = lane;
        if (st.e[k - k0] >= 0) fold(m, l, st.z[k - k0]);
      }
      __syncwarp();
    }
    // the long segments, each by the whole warp
    for (unsigned hubs = __ballot_sync(0xffffffffu, is_long); hubs;
         hubs &= hubs - 1) {
      const int owner = __ffs(hubs) - 1;
      float hm, hl;
      fold_long(z, num_edges, perm, __shfl_sync(0xffffffffu, beg, owner),
                __shfl_sync(0xffffffffu, end, owner), lane, hm, hl);
      if (lane == owner) {
        m = hm;
        l = hl;
      }
    }
    run_m[wib][lane] = m;
    run_denom[wib][lane] = max_nan(l, kTiny);
    __syncwarp();
    // the short segments' weights, the whole warp over the staged
    // entries, each with its segment's (m, l); one chunk: its entries are
    // still staged, with their owners
    const bool restage = run_end - run_begin > kStage;
    for (int k0 = run_begin; k0 < run_end; k0 += kStage) {
      const int lo = max(beg, k0);
      const int hi = min(end, k0 + kStage);
      if (!__any_sync(0xffffffffu, !is_long && lo < hi)) continue;
      if (restage) {
        stage_chunk(st, z, num_edges, perm, k0, run_end, lane);
        for (int k = lo; k < hi && !is_long; ++k) st.owner[k - k0] = lane;
        __syncwarp();
      }
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const int i = t * 32 + lane;
        const int e = st.e[i];
        const int o = st.owner[i];
        if (k0 + i >= run_end || e < 0 || o < 0) continue;
        w[e] = weight(st.z[i], run_m[wib][o], run_denom[wib][o]);
      }
      __syncwarp();
    }
    // the long segments' weights, the whole warp, kPartRun edges in
    // flight a lane
    for (unsigned hubs = __ballot_sync(0xffffffffu, is_long); hubs;
         hubs &= hubs - 1) {
      const int o = __ffs(hubs) - 1;
      const int hb = __shfl_sync(0xffffffffu, beg, o);
      const int he = __shfl_sync(0xffffffffu, end, o);
      for (int c0 = hb + lane; c0 < he; c0 += 32 * kPartRun) {
        int e[kPartRun];
        float v[kPartRun];
#pragma unroll
        for (int t = 0; t < kPartRun; ++t) {
          const int k = c0 + 32 * t;
          e[t] = k < he ? __ldg(perm + k) : -1;
        }
#pragma unroll
        for (int t = 0; t < kPartRun; ++t) {
          e[t] = e[t] >= 0 && e[t] < num_edges ? e[t] : -1;
          v[t] = e[t] >= 0 ? __ldg(z + e[t]) : 0.0f;
        }
#pragma unroll
        for (int t = 0; t < kPartRun; ++t)
          if (e[t] >= 0)
            w[e[t]] = weight(v[t], run_m[wib][o], run_denom[wib][o]);
      }
    }
  }
  // every edge left out of the segments gets weight 0
  if (first_tail >= 0 && first_tail < num_edges) w[first_tail] = 0.0f;
  for (int t = gtid + threads; t < tail; t += threads) {
    const int e = __ldg(perm + tail_begin + t);
    if (e >= 0 && e < num_edges) w[e] = 0.0f;
  }
}

}  // namespace
}  // namespace repro

// `perm` lists all num_edges edge ids (the CSR of build_csr). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_segment_softmax(const float* z, int num_edges,
                                     const int32_t* perm,
                                     const int32_t* offsets,
                                     int num_segments, float* w,
                                     void* stream) {
  using namespace repro;
  if (num_segments < 0 || (num_segments == 0 && num_edges <= 0)) return 0;
  const int runs = (num_segments + kRun - 1) / kRun;
  const int blocks = runs > 0 ? (runs + kWarps - 1) / kWarps : 1;
  segment_softmax_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      z, num_edges, perm, offsets, num_segments, w);
  return static_cast<int>(cudaGetLastError());
}
