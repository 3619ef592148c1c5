// Segment aggregation over a CSR of the row stream, for Hopper.
//
//   out[s, a * F + c] = agg_a over {e : seg[e] = s} of msg[e, c]
//
// for each agg a of the call (one, or a set of distinct aggs folded in
// one launch), agg in sum / mean / min / max / var / std, msg stored as
// fp32, bf16 or int8 and every accumulator in fp32. var/std use
// Welford's update in stream order and the reference's finalize,
// max(M2 / max(count, 1), 1e-12) and its square root for std.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_aggregate/kernel.py,
//   segment_aggregate_v2_pallas (body _seg_v2_kernel).
// That kernel keeps the (S, F) accumulators (and the Welford mean/M2
// pair) resident in VMEM and folds the message stream into them with a
// sequential loop. Here each segment's rows are folded in stream order
// through the CSR the caller built (`perm`, `offsets`; core/
// aggregations.py, build_csr), in registers. Rows with an out-of-range
// segment id are not in the CSR; a CSR entry outside [0, rows) is
// skipped. Nothing assumes the segments are contiguous in the stream
// (pooling ids are, edge destinations are not).
//
// Bound on this card: bytes, and at the served sizes (a few MB) the
// latency of the dependent loads offsets -> perm -> row. The design
// cuts that chain and fills the card:
//
// - a lane owns CPL consecutive columns (up to 16 bytes of a row, one
//   load) and a segment takes `lanes` lanes, so the segment's CSR slice
//   is walked once, not once per 32 columns; a narrow row (F = 11) packs
//   several segments into a warp, a wide one splits into column groups,
//   each its own warp (kernels/segment_aggregate/kernel.py,
//   segment_geometry, from the shape and the card; the index arithmetic
//   is that of csrc/gnn_aggregate.cu, kernels/_geometry.py);
// - the rows of up to BATCH ids are loaded before the first of them is
//   folded, in order, so that many loads are in flight instead of one
//   id -> row chain at a time: 32 registers of raw rows a lane for long
//   segments (pooling), 4 rows for short ones (edge messages), which
//   keeps the registers low and the warps resident many. A long
//   segment's ids are loaded once, lane j of its lanes loading id
//   j0 + j (one coalesced load), and reach the other lanes by
//   __shfl_sync; a short segment's lanes each load its ids (one
//   broadcast a load), which skips the shuffles and the warp-wide loop
//   bound they need (each way measured slower on the other's segments:
//   PERF.md, the segment design steps);
// - one launch carries the accumulators of every agg of the call (sum
//   and mean share the sum, var and std one Welford state), so a pooling
//   set or PNA's four towers read each row once, and the results land
//   side by side in one (S, A * F) output.
//
// Every output is one fold chain over its segment's rows in stream order
// in one lane, with the same operations whatever the geometry and the
// set of aggs carried beside it, so neither changes a bit of the result
// and no atomics are needed. Where ids are shuffled, loop bounds are
// uniform across the warp (the longest of its segments), so the shuffles
// never diverge.
//
// Arithmetic: the explicitly rounded intrinsics, which nvcc never
// contracts into an FMA, so each step rounds as the plain PyTorch
// version's separate elementwise operations do.

#include "common.cuh"

namespace repro {
namespace {

constexpr float kVarFloor = 1e-12f;

// accumulator sets an instance carries: an instance folds every set its
// call's aggs need, and may carry more (whose results it does not store)
enum Need : int {
  kNeedSum = 1,      // sum, mean
  kNeedMin = 2,
  kNeedMax = 4,
  kNeedWelford = 8,  // var, std
  kNeedAll = 15,
};

struct Geometry {
  int lanes;       // lanes per segment, a power of two <= 32
  int groups;      // column groups per segment (lanes * CPL columns each)
  int passes;      // segment groups a warp walks in series
  int warps;       // warps with work
};

// the output slot of each agg code (-1: not asked for): agg a's (S, F)
// result lands in columns at[a] * F ... of the (S, count * F) output
struct Slots {
  int at[6];
  int count;
};

// CPL elements of T (at most 16 bytes), kept raw while the load is in
// flight: 4 registers at most, whatever the storage type
template <typename T, int CPL>
struct Raw {
  static constexpr int kBytes = CPL * static_cast<int>(sizeof(T));
  static constexpr int kWords = kBytes < 4 ? 1 : kBytes / 4;
  uint32_t w[kWords];

  // p is aligned to kBytes: F is a multiple of CPL (segment_geometry)
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes == 16) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else if constexpr (kBytes == 8) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = q.x; w[1] = q.y;
    } else if constexpr (kBytes == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else if constexpr (kBytes == 2) {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned char*>(p));
    }
  }

  // element q as fp32, exactly as to_float (common.cuh)
  __device__ __forceinline__ float at(int q) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[q]);
    } else if constexpr (sizeof(T) == 2) {        // bf16: the high half
      return __uint_as_float(((w[q / 2] >> (16 * (q % 2))) & 0xffffu) << 16);
    } else {                                      // int8
      return static_cast<float>(
          static_cast<int8_t>((w[q / 4] >> (8 * (q % 4))) & 0xffu));
    }
  }
};

// CPL fp32 results at p, aligned to CPL floats
template <int CPL>
__device__ __forceinline__ void store(float* p, const float (&v)[CPL]) {
  if constexpr (CPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < CPL / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (CPL == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// rows loaded before the first of them is folded: kShallowBatch where
// segments are short (edge messages, ~1.3 rows a node: fewer registers,
// more warps resident), else 32 registers of raw rows a lane (pooling:
// a graph's ~27 nodes at once); kernel.py, rows_in_flight
constexpr int kShallowBatch = 4;
template <typename T, int CPL>
constexpr int deep_batch() {
  return 32 / Raw<T, CPL>::kWords;
}

template <typename T, int CPL, int NEED, int BATCH>
__global__ void __launch_bounds__(kThreadsPerBlock)
segment_aggregate_kernel(const T* __restrict__ msg, int num_rows, int f,
                         const int32_t* __restrict__ perm,
                         const int32_t* __restrict__ offsets,
                         int num_segments, Geometry g, Slots slots,
                         float* __restrict__ out) {
  using R = Raw<T, CPL>;
  constexpr bool kHasSum = (NEED & kNeedSum) != 0;
  constexpr bool kHasMin = (NEED & kNeedMin) != 0;
  constexpr bool kHasMax = (NEED & kNeedMax) != 0;
  constexpr bool kWelford = (NEED & kNeedWelford) != 0;
  // 32-bit index arithmetic: the entry point refuses a launch of 2^26
  // warps or more
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
  const size_t stride = static_cast<size_t>(slots.count) * f;
  for (int p = 0; p < g.passes; ++p) {
    const int seg = ((seg_block * g.passes + p) << (5 - shift)) +
                    (lane >> shift);
    const bool seg_ok = seg < num_segments;
    const int beg = seg_ok ? __ldg(offsets + seg) : 0;
    const int len = seg_ok ? __ldg(offsets + seg + 1) - beg : 0;
    float sum[CPL], mn[CPL], mx[CPL], mean[CPL], m2[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      sum[q] = 0.0f;
      mn[q] = agg_init<kMin>();
      mx[q] = agg_init<kMax>();
      mean[q] = 0.0f;
      m2[q] = 0.0f;
    }
    int count = 0;
    float fcount = 0.0f;
    R raw[BATCH];
    bool take[BATCH];
    // the rows of a batch whose loads are in flight, folded in order
    auto fold_batch = [&]() {
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (!take[b]) continue;
        ++count;
        if constexpr (kWelford) fcount = __fadd_rn(fcount, 1.0f);
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const float v = raw[b].at(q);
          if constexpr (kHasSum) sum[q] = agg_fold<kSum>(sum[q], v);
          if constexpr (kHasMin) mn[q] = agg_fold<kMin>(mn[q], v);
          if constexpr (kHasMax) mx[q] = agg_fold<kMax>(mx[q], v);
          if constexpr (kWelford) {
            const float delta = __fsub_rn(v, mean[q]);
            mean[q] = __fadd_rn(mean[q],
                                __fdiv_rn(delta, fmaxf(fcount, 1.0f)));
            m2[q] = __fadd_rn(m2[q],
                              __fmul_rn(delta, __fsub_rn(v, mean[q])));
          }
        }
      }
    };
    if constexpr (BATCH == kShallowBatch) {
      // short segments: each of a segment's lanes loads its ids (one
      // broadcast a load), then their rows, BATCH at a time
      for (int j0 = 0; j0 < len; j0 += BATCH) {
        int id[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b)
          id[b] = j0 + b < len ? __ldg(perm + beg + j0 + b) : -1;
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          take[b] = has_cols && id[b] >= 0 && id[b] < num_rows;
          if (take[b]) raw[b].load(msg + static_cast<size_t>(id[b]) * f + c0);
        }
        fold_batch();
      }
    } else {
      // long segments: lane `sub` loads id j0 + sub of its segment once
      // and the ids reach the segment's lanes by shuffle; the warp walks
      // as far as its longest segment
      const int longest = __reduce_max_sync(0xffffffffu, len);
      for (int j0 = 0; j0 < longest; j0 += g.lanes) {
        const int mine = j0 + sub < len ? __ldg(perm + beg + j0 + sub) : -1;
        const int chunk = min(g.lanes, longest - j0);
        for (int b0 = 0; b0 < chunk; b0 += BATCH) {
#pragma unroll
          for (int b = 0; b < BATCH; ++b) {
            const int id = __shfl_sync(0xffffffffu, mine, b0 + b, g.lanes);
            take[b] = has_cols && b0 + b < chunk && id >= 0 && id < num_rows;
            if (take[b]) raw[b].load(msg + static_cast<size_t>(id) * f + c0);
          }
          fold_batch();
        }
      }
    }
    if (!seg_ok || !has_cols) continue;
    float* o = out + static_cast<size_t>(seg) * stride + c0;
    // each agg asked for: its finalize, then its store
    float res[CPL];
    auto put = [&](int agg) {
      store<CPL>(o + static_cast<size_t>(slots.at[agg]) * f, res);
    };
    if constexpr (kHasSum) {
      if (slots.at[kSum] >= 0) {
#pragma unroll
        for (int q = 0; q < CPL; ++q) res[q] = sum[q];
        put(kSum);
      }
      if (slots.at[kMean] >= 0) {
#pragma unroll
        for (int q = 0; q < CPL; ++q)
          res[q] = agg_finalize<kMean>(sum[q], count);
        put(kMean);
      }
    }
    if constexpr (kHasMin) {
      if (slots.at[kMin] >= 0) {
#pragma unroll
        for (int q = 0; q < CPL; ++q) res[q] = agg_finalize<kMin>(mn[q], count);
        put(kMin);
      }
    }
    if constexpr (kHasMax) {
      if (slots.at[kMax] >= 0) {
#pragma unroll
        for (int q = 0; q < CPL; ++q) res[q] = agg_finalize<kMax>(mx[q], count);
        put(kMax);
      }
    }
    if constexpr (kWelford) {
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const float var = __fdiv_rn(m2[q], fmaxf(fcount, 1.0f));
        res[q] = var < kVarFloor ? kVarFloor : var;  // NaN propagates
      }
      if (slots.at[kVar] >= 0) put(kVar);
      if (slots.at[kStd] >= 0) {
#pragma unroll
        for (int q = 0; q < CPL; ++q) res[q] = __fsqrt_rn(res[q]);
        put(kStd);
      }
    }
  }
}

struct Args {
  const void* msg;
  int num_rows, f;
  bool deep;            // deep_batch() rows in flight, else kShallowBatch
  const int32_t* perm;
  const int32_t* offsets;
  int num_segments;
  Geometry g;
  Slots slots;
  float* out;
  cudaStream_t stream;
};

template <typename T, int CPL, int NEED, int BATCH>
cudaError_t launch_batch(const Args& a) {
  const long long blocks = (a.g.warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  segment_aggregate_kernel<T, CPL, NEED, BATCH>
      <<<static_cast<unsigned>(blocks), kThreadsPerBlock, 0, a.stream>>>(
          static_cast<const T*>(a.msg), a.num_rows, a.f, a.perm, a.offsets,
          a.num_segments, a.g, a.slots, a.out);
  return cudaGetLastError();
}

template <typename T, int CPL, int NEED>
cudaError_t launch(const Args& a) {
  constexpr int kDeep = deep_batch<T, CPL>();
  if (a.deep) return launch_batch<T, CPL, NEED, kDeep>(a);
  return launch_batch<T, CPL, NEED, kShallowBatch>(a);
}

// the accumulator sets of the served calls have instances of their own
// (one agg, the pooling's sum/mean + max); any other set runs the
// instance that carries all four
template <typename T, int CPL>
cudaError_t launch_need(int need, const Args& a) {
  switch (need) {
    case kNeedSum: return launch<T, CPL, kNeedSum>(a);
    case kNeedMin: return launch<T, CPL, kNeedMin>(a);
    case kNeedMax: return launch<T, CPL, kNeedMax>(a);
    case kNeedWelford: return launch<T, CPL, kNeedWelford>(a);
    case kNeedSum | kNeedMax: return launch<T, CPL, kNeedSum | kNeedMax>(a);
    default: return launch<T, CPL, kNeedAll>(a);
  }
}

template <typename T>
cudaError_t launch_typed(int cpl, int need, const Args& a) {
  switch (cpl) {
    case 1: return launch_need<T, 1>(need, a);
    case 2: return launch_need<T, 2>(need, a);
    case 4: return launch_need<T, 4>(need, a);
    case 8:
      // 16 bytes of bf16, 8 of int8; fp32 tops out at 4 columns a lane
      if constexpr (sizeof(T) <= 2) return launch_need<T, 8>(need, a);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// msg (num_rows, f) in the storage type `dtype`; perm / offsets the CSR
// over num_segments >= 1 segments; out (num_segments, A * f) float32 for
// the A aggs of `agg_slots` (4 bits per agg code: its output slot, 0xF
// when not asked for). The geometry (kernels/segment_aggregate/kernel.py,
// segment_geometry): cols_per_lane columns a lane (dividing f; msg
// aligned to them), lanes_per_row lanes a segment (a power of two <=
// 32), col_groups column groups a segment, passes segment groups a warp
// and `warps` warps with work; deep = 1 keeps 32 registers of rows in
// flight a lane, 0 four rows (kernel.py, rows_in_flight). Returns
// cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for an unknown dtype,
// an agg set or a geometry the kernel does not take.
extern "C" int repro_segment_aggregate(const void* msg, int dtype,
                                       int num_rows, int f,
                                       const int32_t* perm,
                                       const int32_t* offsets,
                                       int num_segments, int agg_slots,
                                       int cols_per_lane, int lanes_per_row,
                                       int col_groups, int passes,
                                       long long warps, int deep,
                                       float* out, void* stream) {
  using namespace repro;
  const bool pow2 = lanes_per_row >= 1 && lanes_per_row <= 32 &&
                    (lanes_per_row & (lanes_per_row - 1)) == 0;
  const bool cpl_ok = cols_per_lane >= 1 && f >= 0 && f % cols_per_lane == 0;
  // the kernel's index arithmetic is 32-bit
  const long long segments_covered =
      (warps / col_groups + 1) * passes * (32 / lanes_per_row);
  if (num_segments < 1 || num_rows < 0 || !pow2 || !cpl_ok ||
      col_groups < 1 || passes < 1 || warps < 1 || warps >= (1LL << 26) ||
      segments_covered > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Slots slots{};
  int need = 0, used = 0;
  constexpr int kNeedOf[6] = {kNeedSum, kNeedSum, kNeedMin, kNeedMax,
                              kNeedWelford, kNeedWelford};
  for (int a = 0; a < 6; ++a) {
    const int s = (agg_slots >> (4 * a)) & 0xf;
    slots.at[a] = s == 0xf ? -1 : s;
    if (s != 0xf) {
      need |= kNeedOf[a];
      used |= 1 << s;
      ++slots.count;
    }
  }
  // the slots are 0 .. count - 1, each once
  if (slots.count < 1 || used != (1 << slots.count) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{msg, num_rows, f, deep != 0, perm, offsets, num_segments,
               Geometry{lanes_per_row, col_groups, passes,
                        static_cast<int>(warps)},
               slots,
               out, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: err = launch_typed<float>(cols_per_lane, need, a); break;
    case kBF16:
      err = launch_typed<__nv_bfloat16>(cols_per_lane, need, a);
      break;
    case kI8: err = launch_typed<int8_t>(cols_per_lane, need, a); break;
    default: break;
  }
  return static_cast<int>(err);
}

// Message text of a code returned by the entry points above.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
