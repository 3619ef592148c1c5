// The gradient of the CSR segment aggregation, for Hopper.
//
// Given the forward's output out (S, A * F) of an agg set (A aggs, agg i
// in columns i * F ... (i + 1) * F) and its gradient dout, each row m of
// segment s (c valid rows) gets, column by column, the sum in the set's
// order of its aggs' terms:
//
//   sum   dout
//   mean  dout / max(c, 1)
//   min   dout / ties on a row equal to the output, 0 on the others, and
//   max   0 for every row where the fold's extreme was not finite
//   var   dout * (2 (m - mu) / max(c, 1))
//   std   dout * ((m - mu) / (max(c, 1) * std))
//
// with mu = sum / max(c, 1), ties the segment's rows equal to the output,
// and var and std 0 where the forward's floor max(var, 1e-12) binds (a
// one-row segment among them: 0, never inf or NaN). The min/max rule is
// JAX's: the gradient of segment_max splits equally among tied rows.
// Rows in no segment (the CSR's tail) get 0.
//
// Replaces no Pallas kernel: the JAX package's Pallas segment kernels
// have no VJP, and it trains through XLA's gradient of segment_sum /
// segment_min / segment_max. This is the port's own kernel, the gradient
// of its forward kernel (csrc/segment_aggregate.cu), one launch for a
// whole agg set (PNA's four towers, the pooling set), as the forward.
//
// Two bodies, one template: fp32 messages (gradient fp32) and bf16
// messages (gradient bf16), chosen by the entry point the launcher calls
// for the messages' dtype: repro_segment_aggregate_backward
// (csrc/segment_aggregate_bwd.cu) and repro_segment_aggregate_backward_bf16
// (csrc/segment_aggregate_bwd_bf16.cu), each its own translation unit so
// that the two compile side by side. The bf16 body reads each row as bf16 and
// upcasts it exactly; out, dout and every fold stay fp32, and each
// element of the gradient is rounded to bf16 once, at its store, so its
// bits are the fp32 gradient's followed by .to(torch.bfloat16). Min/max
// ties compare the upcast bf16 values with the fp32 output, which the
// forward folded from those same values.
//
// Bound on this card: bytes (the rows read, the output and its gradient
// read, the (E, F) gradient written) and, at the served sizes, the
// latency of the dependent loads offsets -> perm -> row. The design
// follows the forward's:
//
// - the launch is the forward's geometry (kernels/segment_aggregate/
//   kernel.py, segment_backward_geometry; the index arithmetic of
//   kernels/_geometry.py): a lane owns CPL consecutive columns, one
//   16-byte load of a row at CPL = 4 fp32 or 8 bf16 (at most 8 columns
//   of the set's dout a lane: PNA's four towers take 2; the fp32 out and
//   dout of 8 columns are two 16-byte loads); a narrow row (F = 11) packs
//   several segments into a warp, a wide one splits into column groups;
//   columns a lane are halved until the launch fills the card and a
//   segment's rows fit in flight;
// - each lane walks its segment's CSR slice once: the ids and rows of a
//   batch (BATCH rows, 4 where segments are short, 32 / CPL rows where
//   they are long: 32 registers of fp32 rows, 16 of bf16; pooling's ~27
//   nodes a graph at one column a lane) are loaded with
//   every load in flight and folded; the second pass, each row's
//   gradient, starts from the batch still in registers and re-reads only
//   the batches before it, so a segment that fits one batch reads each
//   row once;
// - the first pass computes only what the set needs: the count (an
//   integer), the extremes and their ties (free of fold order) where min
//   or max is in the set, the stream-order sum only where var or std is
//   (the pooling set's sum, mean and max need none);
// - the row-independent work is hoisted: each agg's dout and out columns
//   are loaded once a segment, beside its ids, and its factor (dout /
//   cnt, dout / ties) is taken once; each row then adds its aggs' terms
//   in the set's order. The served sets (the pooling set, PNA's towers,
//   a sum) are template arguments, so a row's terms compile to a few
//   operations; any other set reads its codes at run time (a switch a
//   term, several times the time: PERF.md, the backward design steps);
// - the CSR's tail is zeroed by the whole grid once the segments are
//   done, 16 bytes a store where F allows it (4 fp32 or 8 bf16 columns).
//
// Every term rounds as the plain version's (kernels/segment_aggregate/
// ref.py, segment_aggregate_backward_ref) and every sum folds in stream
// order, the same operations whatever the geometry, so neither the
// geometry nor the batch changes a bit of the result, and no atomics are
// needed (each row lies in one segment, one lane writes each column).
//
// Arithmetic: the explicitly rounded intrinsics, which nvcc never
// contracts into an FMA.

#pragma once

#include "common.cuh"
#include "rows.cuh"

namespace repro {
namespace {

constexpr float kVarFloor = 1e-12f;   // the forward's floor

// what the first pass folds
enum Need : int {
  kNeedTotal = 1,   // var, std: the stream-order sum
  kNeedMin = 2,     // the extreme and its ties
  kNeedMax = 4,
  kNeedAll = 7,
};

// the agg set: slot i's agg code, in the set's order
struct Set {
  int code[6];
  int count;
};

// a set known at compile time: its count in bits 24 .., slot i's code in
// bits 4 i ..; kAnySet reads the set at run time
__host__ __device__ constexpr int pack_set(int count, int a, int b = 0,
                                          int c = 0, int d = 0) {
  return count << 24 | d << 12 | c << 8 | b << 4 | a;
}
constexpr int kAnySet = 0;
constexpr int kSumSet = pack_set(1, kSum);
constexpr int kPoolingSet = pack_set(3, kSum, kMean, kMax);
constexpr int kPnaSet = pack_set(4, kMean, kMin, kMax, kStd);

template <int SET>
__device__ __forceinline__ int set_count(const Set& s) {
  if constexpr (SET == kAnySet) return s.count;
  else return SET >> 24;
}

template <int SET>
__device__ __forceinline__ int set_code(const Set& s, int i) {
  if constexpr (SET == kAnySet) return s.code[i];
  else return (SET >> (4 * i)) & 0xF;
}

template <int SET>
__host__ __device__ constexpr int need_of() {
  if (SET == kAnySet) return kNeedAll;
  int need = 0;
  for (int i = 0; i < (SET >> 24); ++i) {
    const int code = (SET >> (4 * i)) & 0xF;
    if (code == kVar || code == kStd) need |= kNeedTotal;
    if (code == kMin) need |= kNeedMin;
    if (code == kMax) need |= kNeedMax;
  }
  return need;
}

// the CSR's tail (entries tail .. num_rows of perm) zeroed by every
// thread of the grid: item t of (tail rows) x (F / VEC) is row
// perm[tail + t / (F / VEC)], columns VEC * (t % (F / VEC)) ...
template <int VEC, typename T>
__device__ __forceinline__ void zero_tail(const int32_t* __restrict__ perm,
                                          int tail, int num_rows, int f,
                                          T* __restrict__ dm) {
  const long long vecs = f / VEC;
  const long long items = static_cast<long long>(num_rows - tail) * vecs;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  const float zero[VEC] = {};
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < items; t += threads) {
    const int r = __ldg(perm + tail + t / vecs);
    if (r < 0 || r >= num_rows) continue;
    store<VEC>(dm + static_cast<size_t>(r) * f + VEC * (t % vecs), zero);
  }
}

template <typename T, int CPL, int SET, int BATCH>
__device__ __forceinline__ void segment_backward(
    const T* __restrict__ m, int num_rows, int f,
    const int32_t* __restrict__ perm, const int32_t* __restrict__ offsets,
    int num_segments, const Geometry& g, const Set& set,
    const float* __restrict__ out, const float* __restrict__ dout,
    T* __restrict__ dm) {
  using R = Raw<T, CPL>;         // a row of the messages
  using W = Floats<CPL>;         // a row's columns of out and dout
  constexpr int kNeed = need_of<SET>();
  constexpr bool kTotal = (kNeed & kNeedTotal) != 0;
  constexpr bool kHasMin = (kNeed & kNeedMin) != 0;
  constexpr bool kHasMax = (kNeed & kNeedMax) != 0;
  // 32-bit index arithmetic: the entry point refuses a launch of 2^26
  // warps or more
  const int warp = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x)
                                    >> 5);
  if (warp >= g.warps) return;
  const int lane = threadIdx.x & 31;
  const int shift = __ffs(g.lanes) - 1;    // lanes a segment = 1 << shift
  const int sub = lane & (g.lanes - 1);    // lane within its segment
  const int group = warp % g.groups;
  const int seg_block = warp / g.groups;
  const int c0 = (group * g.lanes + sub) * CPL;
  if (c0 >= f) return;                     // no columns: nothing to write
  const int count_aggs = set_count<SET>(set);
  const size_t stride = static_cast<size_t>(count_aggs) * f;
  const float std_floor = sqrtf(kVarFloor);
  for (int p = 0; p < g.passes; ++p) {
    const int seg = ((seg_block * g.passes + p) << (5 - shift)) +
                    (lane >> shift);
    if (seg >= num_segments) return;       // later passes lie further on
    const int beg = __ldg(offsets + seg);
    const int len = __ldg(offsets + seg + 1) - beg;
    // each slot's dout columns and the outputs the terms compare with,
    // loaded beside the ids
    const float* o_row = out + static_cast<size_t>(seg) * stride + c0;
    const float* d_row = dout + static_cast<size_t>(seg) * stride + c0;
    W d[6];
    W o_min{}, o_max{}, o_var{}, o_std{};
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (i >= count_aggs) break;
      const int code = set_code<SET>(set, i);
      const size_t at = static_cast<size_t>(i) * f;
      d[i].load(d_row + at);
      if (code == kMin) o_min.load(o_row + at);
      if (code == kMax) o_max.load(o_row + at);
      if (code == kVar) o_var.load(o_row + at);
      if (code == kStd) o_std.load(o_row + at);
    }
    int id[BATCH];                          // -1: no row
    R raw[BATCH];
    // the ids and rows of the batch at j0, every load in flight
    auto load_batch = [&](int j0) {
#pragma unroll
      for (int b = 0; b < BATCH; ++b)
        id[b] = j0 + b < len ? __ldg(perm + beg + j0 + b) : -1;
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (id[b] >= num_rows) id[b] = -1;
        if (id[b] >= 0) raw[b].load(m + static_cast<size_t>(id[b]) * f + c0);
      }
    };
    // pass 1: the count, and what the set needs of the rows
    int count = 0;
    float total[CPL], ext_min[CPL], ext_max[CPL];
    int ties_min[CPL], ties_max[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      total[q] = 0.0f;
      ext_min[q] = agg_init<kMin>();
      ext_max[q] = agg_init<kMax>();
      ties_min[q] = ties_max[q] = 0;
    }
    int last = -1;
    for (int j0 = 0; j0 < len; j0 += BATCH) {
      load_batch(j0);
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (id[b] < 0) continue;
        ++count;
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const float v = raw[b].at(q);
          if constexpr (kTotal) total[q] = __fadd_rn(total[q], v);
          if constexpr (kHasMin) {
            ext_min[q] = agg_fold<kMin>(ext_min[q], v);
            ties_min[q] += v == o_min.at(q);
          }
          if constexpr (kHasMax) {
            ext_max[q] = agg_fold<kMax>(ext_max[q], v);
            ties_max[q] += v == o_max.at(q);
          }
        }
      }
      last = j0;
    }
    // the row-independent factors: a slot's term on a row is pre (sum,
    // mean; min / max where the row equals the output, 0 where the
    // output is not the fold's finite extreme), or a function of the
    // row (var, std)
    const float cnt = static_cast<float>(count > 1 ? count : 1);
    float mu[CPL], den[CPL], pre[6][CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      mu[q] = kTotal ? __fdiv_rn(total[q], cnt) : 0.0f;
      den[q] = __fmul_rn(cnt, o_std.at(q));
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (i >= count_aggs) break;
      const int code = set_code<SET>(set, i);
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const float di = d[i].at(q);
        float t = di;
        if (code == kMean) t = __fdiv_rn(di, cnt);
        if (code == kMin)
          t = ext_min[q] == o_min.at(q)
                  ? __fdiv_rn(di, static_cast<float>(ties_min[q])) : 0.0f;
        if (code == kMax)
          t = ext_max[q] == o_max.at(q)
                  ? __fdiv_rn(di, static_cast<float>(ties_max[q])) : 0.0f;
        pre[i][q] = t;
      }
    }
    // pass 2: each row's gradient, its aggs' terms in the set's order
    auto write_batch = [&]() {
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (id[b] < 0) continue;
        float grad[CPL];
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const float v = raw[b].at(q);
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            if (i >= count_aggs) break;
            float t = 0.0f;
            switch (set_code<SET>(set, i)) {
              case kSum:
              case kMean: t = pre[i][q]; break;
              case kMin: t = v == o_min.at(q) ? pre[i][q] : 0.0f; break;
              case kMax: t = v == o_max.at(q) ? pre[i][q] : 0.0f; break;
              case kVar:
                if (o_var.at(q) > kVarFloor)
                  t = __fmul_rn(pre[i][q],
                                __fdiv_rn(__fmul_rn(2.0f,
                                                    __fsub_rn(v, mu[q])),
                                          cnt));
                break;
              case kStd:
                if (o_std.at(q) > std_floor)
                  t = __fmul_rn(pre[i][q],
                                __fdiv_rn(__fsub_rn(v, mu[q]), den[q]));
                break;
              default: break;
            }
            acc = __fadd_rn(acc, t);
          }
          grad[q] = acc;
        }
        store<CPL>(dm + static_cast<size_t>(id[b]) * f + c0, grad);
      }
    };
    // the batch still in registers, then the ones before it, re-read
    if (last >= 0) write_batch();
    for (int j0 = 0; j0 < last; j0 += BATCH) {
      load_batch(j0);
      write_batch();
    }
  }
}

template <typename T, int CPL, int SET, int BATCH>
__global__ void __launch_bounds__(kThreadsPerBlock)
segment_aggregate_backward_kernel(const T* __restrict__ m, int num_rows,
                                  int f, const int32_t* __restrict__ perm,
                                  const int32_t* __restrict__ offsets,
                                  int num_segments, Geometry g, Set set,
                                  const float* __restrict__ out,
                                  const float* __restrict__ dout,
                                  T* __restrict__ dm) {
  // the tail's start, loaded beside the segment's offsets; the tail is
  // zeroed once the segments' loads are under way, 16 bytes a store where
  // F allows it
  const int tail = __ldg(offsets + num_segments);
  segment_backward<T, CPL, SET, BATCH>(m, num_rows, f, perm, offsets,
                                       num_segments, g, set, out, dout, dm);
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if (f % kVec == 0) zero_tail<kVec>(perm, tail, num_rows, f, dm);
  else if (f % 4 == 0) zero_tail<4>(perm, tail, num_rows, f, dm);
  else if (f % 2 == 0) zero_tail<2>(perm, tail, num_rows, f, dm);
  else zero_tail<1>(perm, tail, num_rows, f, dm);
}

template <typename T>
struct Args {
  const T* m;
  int num_rows, f;
  bool deep;            // deep_batch() rows in flight, else kShallowBatch
  const int32_t* perm;
  const int32_t* offsets;
  int num_segments;
  Geometry g;
  Set set;
  const float* out;
  const float* dout;
  T* dm;
  cudaStream_t stream;
};

template <typename T, int CPL, int SET, int BATCH>
cudaError_t launch_batch(const Args<T>& a) {
  const long long blocks = (a.g.warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  segment_aggregate_backward_kernel<T, CPL, SET, BATCH>
      <<<static_cast<unsigned>(blocks), kThreadsPerBlock, 0, a.stream>>>(
          a.m, a.num_rows, a.f, a.perm, a.offsets, a.num_segments, a.g,
          a.set, a.out, a.dout, a.dm);
  return cudaGetLastError();
}

// the deep batch holds 32 / CPL rows whatever the storage: 32 registers
// of fp32 rows, 16 of bf16 (kernels/segment_aggregate/kernel.py,
// backward_coverage); so a bf16 instance unrolls what its fp32
// counterpart does
template <typename T, int CPL, int SET>
cudaError_t launch(const Args<T>& a) {
  constexpr int kDeep = 32 / CPL;
  if (a.deep) return launch_batch<T, CPL, SET, kDeep>(a);
  return launch_batch<T, CPL, SET, kShallowBatch>(a);
}

// the most columns of a set's dout a lane keeps (BWD_TERMS_PER_LANE,
// kernels/segment_aggregate/kernel.py): the geometry never gives a set
// of n aggs more than 8 / n columns a lane
constexpr int kTermsPerLane = 8;

template <int SET, int CPL>
constexpr bool within_terms() {
  return (SET >> 24) * CPL <= kTermsPerLane;
}

// the served sets (fp32: the pooling set, PNA's towers, a sum; bf16: PNA's
// towers and GIN's edge sum, the pooling staying fp32 at every policy)
// have instances of their own at the columns a lane the geometry gives
// them, their terms resolved at compile time; any other set, or a served
// set at wider columns (a geometry forced past the terms a lane), runs
// the instance that reads the set at run time
template <typename T, int CPL>
cudaError_t launch_set(int packed, const Args<T>& a) {
  if (packed == kSumSet) return launch<T, CPL, kSumSet>(a);
  if constexpr (within_terms<kPnaSet, CPL>()) {
    if (packed == kPnaSet) return launch<T, CPL, kPnaSet>(a);
  }
  if constexpr (sizeof(T) == 4 && within_terms<kPoolingSet, CPL>()) {
    if (packed == kPoolingSet) return launch<T, CPL, kPoolingSet>(a);
  }
  return launch<T, CPL, kAnySet>(a);
}

// the entry points' checks and dispatch, for messages of T: columns a
// lane 1, 2 or 4, and 8 for bf16 (16 bytes of a row either way)
template <typename T>
int launch_typed(const T* m, int num_rows, int f, const int32_t* perm,
                 const int32_t* offsets, int num_segments, int num_aggs,
                 int codes, int cols_per_lane, int lanes_per_row,
                 int col_groups, int passes, long long warps, int deep,
                 const float* out, const float* dout, T* dm, void* stream) {
  constexpr int kMaxCols = 16 / static_cast<int>(sizeof(T));
  const bool pow2 = lanes_per_row >= 1 && lanes_per_row <= 32 &&
                    (lanes_per_row & (lanes_per_row - 1)) == 0;
  const bool cpl_ok = cols_per_lane >= 1 && cols_per_lane <= kMaxCols &&
                      (cols_per_lane & (cols_per_lane - 1)) == 0 &&
                      f >= 0 && f % cols_per_lane == 0;
  // the kernel's index arithmetic is 32-bit
  const long long segments_covered =
      (warps / (col_groups > 0 ? col_groups : 1) + 1) * passes *
      (32 / (pow2 ? lanes_per_row : 1));
  if (num_rows < 0 || num_segments < 1 || num_aggs < 1 || num_aggs > 6 ||
      !pow2 || !cpl_ok || col_groups < 1 || passes < 1 || warps < 1 ||
      warps >= (1LL << 26) || segments_covered > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Set set{};
  set.count = num_aggs;
  int seen = 0;
  for (int i = 0; i < num_aggs; ++i) {
    const int code = (codes >> (4 * i)) & 0xF;
    if (code > kStd || (seen >> code) & 1)
      return static_cast<int>(cudaErrorInvalidValue);
    seen |= 1 << code;
    set.code[i] = code;
  }
  const int packed =
      num_aggs << 24 | (codes & ((1 << (4 * num_aggs)) - 1));
  const Args<T> a{m, num_rows, f, deep != 0, perm, offsets, num_segments,
                  Geometry{lanes_per_row, col_groups, passes,
                           static_cast<int>(warps)},
                  set, out, dout, dm, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  switch (cols_per_lane) {
    case 1: err = launch_set<T, 1>(packed, a); break;
    case 2: err = launch_set<T, 2>(packed, a); break;
    case 4: err = launch_set<T, 4>(packed, a); break;
    case 8:
      if constexpr (kMaxCols >= 8) err = launch_set<T, 8>(packed, a);
      break;
    default: break;
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace repro
