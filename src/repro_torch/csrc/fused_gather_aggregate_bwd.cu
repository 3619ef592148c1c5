// The per-edge scale's gradient of the CSR gather, for Hopper.
//
//   dscale[e] = w[e] * sum over c of dout[dst[e], c] * x[src[e], c]
//
// for an edge whose destination lies in [0, S) and whose source lies in
// [0, N); 0 for every other edge (padding, or an edge the gather's CSR
// left out: dst[e] = -1). w[e] is 1 for a sum gather (no weight stream)
// and 1 / max(cnt, 1) for a mean (kernels/fused_gather_aggregate/ref.py,
// backward_coefficients). GAT's attention weights ride the gather's
// scale slot, so this is their gradient.
//
// Replaces no Pallas kernel: the JAX package's Pallas gathers have no
// VJP, and it trains through XLA's gradient of jnp.take and segment_sum.
// This is the port's own kernel, the gradient of its forward kernel
// (csrc/fused_gather_aggregate.cu). The gather's other gradient, dx, is
// that forward kernel itself over the source CSR
// (kernels/fused_gather_aggregate/ops.py).
//
// The sum's order (the plain version's, ref.py gather_scale_backward_ref):
// 32 partials, partial l the products of columns l, l + 32, ... added in
// order to +0.0; then a butterfly over the partials at offsets 16, 8, 4,
// 2, 1. Both bodies below keep it, so both give the plain version's bits.
//
// x is the gather's table as it is stored: fp32, or bf16 (a bf16 layer's
// table, read without an fp32 copy), each value upcast exactly before its
// product, so a bf16 x gives the plain version's bits on the upcast
// table. dout and the sums are fp32 either way. Each body is a template
// on x's type; the entry point the launcher calls picks it by dtype.
//
// Bound on this card: bytes. Per valid edge two rows of F fp32 values
// (the destination's output gradient, the source's row), its ids and one
// output; GAT's 1024-graph batch holds ~55k edge slots over ~28k nodes,
// both tables (~7 MB each at F 64) in L2, so what limits a launch is
// the latency of a warp's dependent loads (ids, then rows) and the rate
// at which L2 feeds the SMs each edge's rows. Two bodies, chosen by shape
// (kernels/fused_gather_aggregate/kernel.py, scale_backward_geometry),
// never a fallback:
//
// - the vector body (F a multiple of 4, dout 16-byte aligned, x aligned
//   to 4 of its elements): a
//   warp takes a run of `run` consecutive edges (at most 32). Lane l
//   loads the ids (and weight) of edge e0 + l, so the run's ids are one
//   coalesced load each. The warp walks the run 4 edges a step, one edge
//   to each group of 8 lanes, which take their edge's ids by shuffle.
//   Lane j of a group loads float4s at columns 4j + 32t of both rows, so
//   it holds partials 4j .. 4j + 3 in 4 registers, each folded in t
//   order. A bf16 x row is read 4 columns a lane too, 8 bytes a load: the
//   order gives a lane 4 partials, so 8 bf16 columns in one 16-byte load
//   would reach 8 partials, half of them another lane's; the group's 8
//   lanes still read 64 contiguous bytes, the same two sectors. The
//   butterfly adds the same pairs, spread over the group's lanes
//   (group_sum: 6 shuffles a step where a full butterfly on each
//   register takes 12). Lane j of group g keeps the sum of step j; one
//   shuffle at the end brings edge e0 + l's sum to lane l, and the run's
//   outputs are one coalesced store. A lane loads CH float4s of each row
//   a step (CH = 2 at F 64, 4 at F 128); a row wider than 32 CH columns
//   is folded in blocks of 32 CH columns, in t order. A warp keeps one
//   step's rows in flight: the run (16, 8 or 4 edges) is the longest
//   that still gives each SM 16 warps for each column block, which hide
//   the loads' latency; loading the next steps' rows before folding this
//   one's (2 or 4 steps in flight) measured no faster at GAT's calls and
//   took 60-102 registers a thread (PERF.md, row 1c's design steps);
// - the generic body (any F, any alignment, and a stream too short to
//   give each SM 16 warps at 4 edges a warp): one warp an edge, lane l
//   reading columns l, l + 32, ... of both rows, then the butterfly over
//   the 32 lanes (__shfl_xor_sync, offsets 16, 8, 4, 2, 1).
//
// The masked body (MASK = true) is a min or max gather's scale gradient
// (csrc/gather_minmax_bwd.cu has the rest of that gradient): dout is the
// tie weights w (S, F), and each column's product w[dst_e, c] * x[src_e,
// c] is added only where the edge's message x[src_e, c] * scale_e (one
// rounded multiply, as the forward's) equals ext[dst_e, c], the extreme
// the tie weights wrote (NaN where none won); +0.0 elsewhere, which leaves
// a partial unchanged, as the plain version's masked zero does. The
// scale rides the weight's slot (each edge's lane loads it, the group's
// lanes take it by shuffle), and a lane loads each ext row beside the w
// row, 16 bytes a step; no weight multiplies the sum.
//
// A warp's edge or run is uniform over its lanes, so every lane reaches
// the shuffles. Arithmetic: the explicitly rounded intrinsics, which
// nvcc never contracts into an FMA, so the sum rounds step for step as
// the plain version does; no atomics.

#include "common.cuh"

namespace repro {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanesPerEdge = 8;
constexpr int kEdgesPerStep = 32 / kLanesPerEdge;
constexpr int kMaxRun = 32;          // a lane holds one edge's ids

// 4 columns of an x row at p (aligned to 4 elements) as fp32: one
// 16-byte load of fp32, one 8-byte load of bf16 upcast exactly
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(q.x << 16),
                     __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16),
                     __uint_as_float(q.y & 0xffff0000u));
}

// one x value as fp32
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(
                             reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

// one column's term: dout * x, or under MASK the same where the edge's
// message x * sc equals the extreme ext, else +0.0
template <bool MASK>
__device__ __forceinline__ float term(float d, float x, float ext,
                                      float sc) {
  if constexpr (MASK) {
    if (__fmul_rn(x, sc) != ext) return 0.0f;
  }
  return __fmul_rn(d, x);
}

// a step's rows: CH float4s of the destination's dout (and, under MASK,
// ext) and of the source's x row, columns col0 + 32 c (zeros past F or
// for an edge not read)
template <int CH, bool MASK>
struct Rows {
  float4 d[CH], x[CH], e[MASK ? CH : 1];

  template <typename T>
  __device__ __forceinline__ void load(const float* __restrict__ dout,
                                       const float* __restrict__ ext,
                                       const T* __restrict__ xt, int f,
                                       int dd, int ss, int col0) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int col = col0 + 32 * c;
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (dd >= 0 && col < f) {
        const size_t at = static_cast<size_t>(dd) * f + col;
        d[c] = __ldg(reinterpret_cast<const float4*>(dout + at));
        x[c] = load4(xt + static_cast<size_t>(ss) * f + col);
        if constexpr (MASK)
          e[c] = __ldg(reinterpret_cast<const float4*>(ext + at));
      } else {
        d[c] = x[c] = zero;
        if constexpr (MASK) e[c] = zero;
      }
    }
  }

  // a zero product adds +0.0, which leaves a partial unchanged: a partial
  // that starts at +0.0 is never -0.0 (the plain version adds the zero
  // padding past F the same way). Under MASK a zero row's ext is 0.0 and
  // its message 0.0 * sc: a tie or not, its term is a zero product
  __device__ __forceinline__ void fold(float (&a)[4], float sc) const {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float4 ec = MASK ? e[MASK ? c : 0] : d[c];
      a[0] = __fadd_rn(a[0], term<MASK>(d[c].x, x[c].x, ec.x, sc));
      a[1] = __fadd_rn(a[1], term<MASK>(d[c].y, x[c].y, ec.y, sc));
      a[2] = __fadd_rn(a[2], term<MASK>(d[c].z, x[c].z, ec.z, sc));
      a[3] = __fadd_rn(a[3], term<MASK>(d[c].w, x[c].w, ec.w, sc));
    }
  }
};

// the sum of an edge's 32 partials in every lane of its group, lane j
// holding partials 4j .. 4j + 3 in a[0 .. 3]. Every add is one of the
// plain version's butterfly pairs (offset o: partial l + partial l + o),
// spread over the group so that no lane adds what another adds too until
// offset 4: at offset 16 lane j keeps partials 4j, 4j + 1 (j < 4) or
// 4j - 14, 4j - 13 (j >= 4), at offset 8 one of them; offsets 4, 2 and 1
// exchange the rest. 6 shuffles and 6 adds a step
__device__ __forceinline__ float group_sum(const float (&a)[4], int j) {
  const bool hi4 = j & 4, hi2 = j & 2;
  // offset 16: lanes j and j ^ 4, each keeping two of the four sums
  const float r0 = __shfl_xor_sync(kFull, hi4 ? a[0] : a[2], 4);
  const float r1 = __shfl_xor_sync(kFull, hi4 ? a[1] : a[3], 4);
  const float b0 = __fadd_rn(hi4 ? a[2] : a[0], r0);
  const float b1 = __fadd_rn(hi4 ? a[3] : a[1], r1);
  // offset 8: lanes j and j ^ 2, each keeping one of the two sums
  const float c = __fadd_rn(hi2 ? b1 : b0,
                            __shfl_xor_sync(kFull, hi2 ? b0 : b1, 2));
  // offsets 4, 2, 1: lanes j ^ 1, j ^ 4, j ^ 2
  const float d = __fadd_rn(c, __shfl_xor_sync(kFull, c, 1));
  const float e = __fadd_rn(d, __shfl_xor_sync(kFull, d, 4));
  return __fadd_rn(e, __shfl_xor_sync(kFull, e, 2));
}

// the vector body (file comment): CH float4s a lane a row a step. Under
// MASK, `weight` is the edges' scale (null: 1) and multiplies no sum
template <typename T, int CH, bool MASK>
__global__ void __launch_bounds__(kThreadsPerBlock)
gather_scale_backward_kernel(const float* __restrict__ dout,
                             const float* __restrict__ ext,
                             int num_segments, int f,
                             const T* __restrict__ x, int n_src,
                             const int32_t* __restrict__ src,
                             const int32_t* __restrict__ dst,
                             const float* __restrict__ weight,
                             int num_edges, int run,
                             float* __restrict__ out) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long e0 = warp * run;
  if (e0 >= num_edges) return;           // the whole warp
  const int lane = threadIdx.x & 31;
  const int grp = lane / kLanesPerEdge;
  const int j = lane % kLanesPerEdge;
  const int n = static_cast<int>(
      min(static_cast<long long>(run), num_edges - e0));
  int d = -1, s = 0;
  float w = 1.0f;
  if (lane < n) {
    d = __ldg(dst + e0 + lane);
    s = __ldg(src + e0 + lane);
    if (weight != nullptr) w = __ldg(weight + e0 + lane);
  }
  const bool ok = d >= 0 && d < num_segments && s >= 0 && s < n_src;
  const int dd = ok ? d : -1;            // -1: the edge's rows not read
  const int steps = (n + kEdgesPerStep - 1) / kEdgesPerStep;
  float kept = 0.0f;                     // the sum of step j
  for (int step = 0; step < steps; ++step) {
    const int owner = step * kEdgesPerStep + grp;
    const int de = __shfl_sync(kFull, dd, owner);
    const int se = __shfl_sync(kFull, s, owner);
    const float sc = MASK ? __shfl_sync(kFull, w, owner) : 1.0f;
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int col0 = 4 * j; col0 < f; col0 += 32 * CH) {
      Rows<CH, MASK> r;
      r.load(dout, ext, x, f, de, se, col0);
      r.fold(a, sc);
    }
    const float sum = group_sum(a, j);
    if (j == step) kept = sum;
  }
  // edge e0 + l was step l / 4 of group l % 4: its lane (l % 4) * 8 +
  // l / 4 kept its sum
  const float mine = __shfl_sync(
      kFull, kept, (lane % kEdgesPerStep) * kLanesPerEdge +
                       lane / kEdgesPerStep);
  if (lane < n) {
    float v = 0.0f;
    if (ok) v = !MASK && weight != nullptr ? __fmul_rn(mine, w) : mine;
    out[e0 + lane] = v;
  }
}

// the generic body (file comment): one warp an edge; `weight` as the
// vector body's
template <typename T, bool MASK>
__global__ void __launch_bounds__(kThreadsPerBlock)
gather_scale_backward_generic_kernel(const float* __restrict__ dout,
                                     const float* __restrict__ ext,
                                     int num_segments, int f,
                                     const T* __restrict__ x, int n_src,
                                     const int32_t* __restrict__ src,
                                     const int32_t* __restrict__ dst,
                                     const float* __restrict__ weight,
                                     int num_edges, float* __restrict__ out) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (warp >= num_edges) return;          // the whole warp
  const int e = static_cast<int>(warp);
  const int lane = threadIdx.x & 31;
  const int d = __ldg(dst + e);
  const int s = __ldg(src + e);
  const bool ok = d >= 0 && d < num_segments && s >= 0 && s < n_src;
  float acc = 0.0f;
  if (ok) {
    const size_t row = static_cast<size_t>(d) * f;
    const T* xrow = x + static_cast<size_t>(s) * f;
    const float sc = MASK && weight != nullptr ? __ldg(weight + e) : 1.0f;
    for (int c = lane; c < f; c += 32)
      acc = __fadd_rn(acc, term<MASK>(__ldg(dout + row + c), load1(xrow + c),
                                      MASK ? __ldg(ext + row + c) : 0.0f,
                                      sc));
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, o));
  if (lane == 0) {
    float v = 0.0f;
    if (ok)
      v = !MASK && weight != nullptr ? __fmul_rn(acc, __ldg(weight + e))
                                     : acc;
    out[e] = v;
  }
}

// the vector body's instances: CH float4s a lane a row (1-4; a wider row
// is folded in column blocks of 32 CH, any CH giving the same bits)
template <typename T, int CH, bool MASK>
void launch_vector(unsigned blocks, cudaStream_t stream, const float* dout,
                   const float* ext, int num_segments, int f, const T* x,
                   int n_src, const int32_t* src, const int32_t* dst,
                   const float* weight, int num_edges, int run, float* out) {
  gather_scale_backward_kernel<T, CH, MASK>
      <<<blocks, kThreadsPerBlock, 0, stream>>>(
          dout, ext, num_segments, f, x, n_src, src, dst, weight, num_edges,
          run, out);
}

template <typename T>
using VectorLaunch = void (*)(unsigned, cudaStream_t, const float*,
                              const float*, int, int, const T*, int,
                              const int32_t*, const int32_t*, const float*,
                              int, int, float*);

template <typename T, bool MASK>
VectorLaunch<T> vector_instance(int chunks) {
  switch (chunks) {
    case 1: return launch_vector<T, 1, MASK>;
    case 2: return launch_vector<T, 2, MASK>;
    case 3: return launch_vector<T, 3, MASK>;
    case 4: return launch_vector<T, 4, MASK>;
    default: return nullptr;
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the entry points' checks and dispatch, for an x of T (MASK: ext given)
template <typename T, bool MASK>
int launch_typed(const float* dout, const float* ext, int num_segments,
                 int f, const T* x, int n_src, const int32_t* src,
                 const int32_t* dst, const float* weight, int num_edges,
                 int body, int run, int chunks, float* out, void* stream) {
  if (num_segments < 0 || f < 0 || n_src < 0 || num_edges < 0 ||
      (body != 0 && body != 1) || (MASK && ext == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_edges == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 0) {
    const long long blocks =
        (static_cast<long long>(num_edges) + kWarpsPerBlock - 1) /
        kWarpsPerBlock;
    gather_scale_backward_generic_kernel<T, MASK>
        <<<static_cast<unsigned>(blocks), kThreadsPerBlock, 0, st>>>(
            dout, ext, num_segments, f, x, n_src, src, dst, weight,
            num_edges, out);
    return static_cast<int>(cudaGetLastError());
  }
  const VectorLaunch<T> launch = vector_instance<T, MASK>(chunks);
  if (launch == nullptr || run < kEdgesPerStep || run > kMaxRun ||
      run % kEdgesPerStep != 0 || f == 0 || f % 4 != 0 ||
      !aligned(dout, 16) || (MASK && !aligned(ext, 16)) ||
      !aligned(x, 4 * sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = (static_cast<long long>(num_edges) + run - 1) / run;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  launch(static_cast<unsigned>(blocks), st, dout, ext, num_segments, f, x,
         n_src, src, dst, weight, num_edges, run, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// dout (num_segments, f) fp32; x (n_src, f) fp32; src / dst
// (num_edges,) int32, each edge's source and destination (-1 for an edge
// in no segment); weight (num_edges,) fp32 or null; out (num_edges,)
// fp32. body 0: the generic body, one warp an edge (run and chunks
// unread); body 1: the vector body, `run` edges a warp (a multiple of 4,
// at most 32), `chunks` float4s a lane a row (1-4), F a multiple of 4,
// dout 16-byte and x 4-element aligned. Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for a negative size
// or a vector launch it does not take.
extern "C" int repro_gather_scale_backward(const float* dout,
                                           int num_segments, int f,
                                           const float* x, int n_src,
                                           const int32_t* src,
                                           const int32_t* dst,
                                           const float* weight,
                                           int num_edges, int body, int run,
                                           int chunks, float* out,
                                           void* stream) {
  return repro::launch_typed<float, false>(dout, nullptr, num_segments, f, x,
                                          n_src, src, dst, weight, num_edges,
                                          body, run, chunks, out, stream);
}

// The same for a bf16 table x (n_src, f), 8-byte aligned for the vector
// body.
extern "C" int repro_gather_scale_backward_bf16(const float* dout,
                                                int num_segments, int f,
                                                const __nv_bfloat16* x,
                                                int n_src,
                                                const int32_t* src,
                                                const int32_t* dst,
                                                const float* weight,
                                                int num_edges, int body,
                                                int run, int chunks,
                                                float* out, void* stream) {
  return repro::launch_typed<__nv_bfloat16, false>(
      dout, nullptr, num_segments, f, x, n_src, src, dst, weight, num_edges,
      body, run, chunks, out, stream);
}

// The masked body, a min or max gather's scale gradient: w (num_segments,
// f) fp32, its tie weights, in dout's place; ext (num_segments, f) fp32,
// its extremes (16-byte aligned for the vector body); scale (num_edges,)
// fp32 or null (1), the forward's. x fp32 (`bf16` 0) or bf16 (`bf16` 1).
// Otherwise as repro_gather_scale_backward, with no weight.
extern "C" int repro_gather_minmax_scale_backward(
    const float* w, const float* ext, const float* scale, int num_segments,
    int f, const void* x, int bf16, int n_src, const int32_t* src,
    const int32_t* dst, int num_edges, int body, int run, int chunks,
    float* out, void* stream) {
  if (bf16)
    return repro::launch_typed<__nv_bfloat16, true>(
        w, ext, num_segments, f, static_cast<const __nv_bfloat16*>(x), n_src,
        src, dst, scale, num_edges, body, run, chunks, out, stream);
  return repro::launch_typed<float, true>(
      w, ext, num_segments, f, static_cast<const float*>(x), n_src, src, dst,
      scale, num_edges, body, run, chunks, out, stream);
}
