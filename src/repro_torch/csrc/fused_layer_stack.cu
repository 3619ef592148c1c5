// Multi-layer resident GCN / SAGE stack for Hopper: K conv layers in one
// cooperative launch.
//
// Each layer k reads the (N, F) fp32 node table T_k (F = fmax, the widest
// layer padded to a multiple of 32) and writes T_{k+1}. Layer k has real
// widths (in_k, out_k), in_{k+1} = out_k (default: (F, F) for every
// layer); weights and bias outside the real (in_k, out_k) block are the
// zero padding the caller built, and are never read:
//
//   xq    = cast_k(T_k[:, :in])         // qp row [mode, s, lo, hi]: fp32,
//                                       // bf16 rounding or int8 fake-quant
//   aggr  = sum over the CSR's edges e into d, in stream order,
//           of scale[e] * xq[src[e]]    (SAGE: / max(count, 1))
//   GCN:  h = round(aggr + xq * sv) @ Wn + b
//   SAGE: h = [round(xq) | round(aggr)] @ [Wa; Wn] + b
//   h     = round(h) [+ T_k[:, :in] @ Wskip]   // the skip reads fp32
//   T_{k+1}[:, :out] = act(h) * mask,  T_{k+1}[:, out:] = act(0) * mask
//
// where round() is bf16 rounding in bf16 mode and the identity otherwise.
// The padding columns get what the zero-padded weights give them, so the
// whole table is written and matches the plain version's.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_gather_aggregate/residency.py,
//   fused_layer_stack_pallas (body _stack_kernel).
// That kernel keeps the table, an (N, F) aggregate and a quantized shadow
// table in VMEM and sweeps the edge stream sequentially, one layer after
// the other. Here one cooperative grid (all blocks co-resident, one a SM
// at the paper's widths) runs every layer and meets at a grid barrier
// between layers; the table ping-pongs between two device buffers that
// stay in the 50 MB L2 at the paper's sizes (core/convs.py,
// residency_plan).
//
// Bound on this card: operations at the paper's widths (11 -> 128 -> 64:
// 2 N in out FMAs a product, GCN two products a layer with the skip,
// SAGE three), against two table reads and one write per row. What the
// time goes to instead is latency: a layer's gather is a chain of
// dependent loads (offsets -> perm -> source -> row), and the block has
// only 8 warps to hide it. The design:
//
// - Real widths. Every product runs over the layer's real input rows
//   (padded to 4) and output columns (padded to 64), not the table width:
//   layer 0 gathers and multiplies 12 columns, not 128.
// - Weights staged once per block per layer. At layer start each block
//   copies the layer's real matrices into shared memory by cp.async
//   (simt.cuh), under the first chunk's gather; at the paper's widths
//   that is 64 KB (GCN layer 1) or 96 KB (SAGE). Where they would leave
//   room only for chunks under half as tall (wide tables), a ring of
//   kStages slices of kSlice weight rows streams them through every
//   chunk instead.
// - Balanced rows. Block b owns rows [b R, b R + R), R = ceil(N / grid),
//   in chunks of at most 128 rows of equal height (rounded up to 16), so
//   no block waits on a tail wave of tiles.
// - Gather once per row, kBatch loads in flight. A chunk's CSR slice (its
//   offsets, each edge's source and scale found through perm, the GCN
//   self-loop scales) is staged into shared memory by the whole block at
//   once, and the chunk's own table rows by cp.async. The lanes of a row
//   own float4 column groups (several narrow rows share a warp); each
//   lane group walks a contiguous range of rows and their edges in CSR
//   order, loading kBatch neighbour rows before folding any, in stream
//   order with __fadd_rn / __fmul_rn and no FMA. The gather is compiled
//   per precision mode, so the fp32 fold carries no bf16/int8 branches.
// - Products: 256 threads in 16 x 16, each an M x 4 register tile (rows
//   ty + 16 i, columns 4 tx .. 4 tx + 3 of a 64-column pass), M = 1..8 by
//   the chunk's height, fp32 FMAs on the SIMT cores (never TF32). The
//   bias and mask loads are issued before the products, the activation's
//   switch taken once per tile.
//
// The table reads go through L2 (__ldcg, cp.async.cg), never the
// non-coherent L1: the buffers are rewritten by other blocks between the
// grid barriers.

#include <cooperative_groups.h>

#include "common.cuh"
#include "simt.cuh"

namespace repro {
namespace {

namespace cg = cooperative_groups;
using simt::cp_async16;
using simt::cp_async_commit;
using simt::cp_async_wait;

// activation codes shared with the Python wrapper
// (kernels/fused_layer_stack/kernel.py, ACT_CODES: nn.layers.ACTIVATIONS order)
enum Act : int {
  kRelu = 0, kGelu = 1, kSilu = 2, kTanh = 3, kSigmoid = 4, kIdentity = 5,
  kRelu2 = 6
};

constexpr int kThreads = 256;            // a block
constexpr int kWarps = kThreads / 32;
constexpr int kTX = 16;                  // thread columns of a product
constexpr int kTY = kThreads / kTX;      // thread rows of a product
constexpr int kTN = 4;                   // columns a thread
constexpr int kCols = kTX * kTN;         // 64 output columns a pass
constexpr int kMaxRows = 128;            // rows a chunk
constexpr int kMaxM = kMaxRows / kTY;    // rows a thread
constexpr int kSlice = 32;               // ring: weight rows a slice
constexpr int kStages = 3;               // ring: slices in flight
constexpr int kEdgeCap = 512;            // edges of a chunk in shared memory
constexpr int kBatch = 8;                // gather: edges loaded before folding
constexpr int kMaxF = 512;               // a 16-row chunk beside the ring
constexpr int kMaxLayers = 32;
// shared memory besides the weights and tiles: edge sources and scales,
// the chunk's row offsets and (GCN) self-loop scales
constexpr int kFixedWords = 2 * kEdgeCap + 2 * kMaxRows + 4;

struct StackArgs {
  const float* x0;        // (n, f) input table, read by layer 0 only
  float* out;             // (n, f) written by the last layer
  float* scratch;         // (n, f) the other ping-pong buffer (k > 1)
  int n, f, num_layers;
  const int32_t* src;     // (num_edges,) source ids
  const float* scale;     // (num_edges,) per-edge scale
  int num_edges;
  const int32_t* perm;    // destination CSR over the n rows
  const int32_t* offsets;
  const float* self_vec;  // (n,) GCN self-loop scale
  const float* mask;      // (n,) node validity
  const float* wa;        // (k, f, f) SAGE self weights
  const float* wn;        // (k, f, f) conv weights (GCN) / neighbour (SAGE)
  const float* wsk;       // (k, f, f) skip weights
  const float* bias;      // (k, f)
  const float* qp;        // (k, 4) [mode, s, lo, hi]
  int activation;
  int has_skip;
  int in_dim[kMaxLayers], out_dim[kMaxLayers];  // real widths
  int rows_per_block;     // R
  int max_rows;           // chunk height cap, a multiple of kTY
  int w_floats;           // the weight region (resident or ring)
  int a_floats;           // the tile region: max_rows (in_p + kmain),
                          // of the widest layer
};

// one layer's widths and operands
struct Layer {
  int in, out, in_p, kmain, cps;  // in_p = in padded to 4; kmain = the
                                  // main product's depth; cps = 64-column
                                  // passes
  const float *wa, *wn, *wsk, *bias;
  float mode, s, lo, hi;
};

template <bool SAGE>
__device__ __forceinline__ Layer layer_of(const StackArgs& a, int layer) {
  Layer L;
  L.in = a.in_dim[layer];
  L.out = a.out_dim[layer];
  L.in_p = (L.in + 3) & ~3;
  L.kmain = SAGE ? 2 * L.in_p : L.in_p;
  L.cps = (L.out + kCols - 1) / kCols;
  const size_t w = static_cast<size_t>(layer) * a.f * a.f;
  L.wa = a.wa + w;
  L.wn = a.wn + w;
  L.wsk = a.wsk + w;
  L.bias = a.bias + static_cast<size_t>(layer) * a.f;
  const float* q = a.qp + 4 * layer;
  L.mode = q[0];
  L.s = q[1];
  L.lo = q[2];
  L.hi = q[3];
  return L;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the precision modes of a qp row, and the code the gather is compiled
// for: 0 fp32, 1 bf16 rounding, 2 int8 fake-quant
constexpr int kModeF32 = 0, kModeBF16 = 1, kModeInt8 = 2;

__device__ __forceinline__ int mode_of(float mode) {
  return mode == 1.0f ? kModeBF16 : mode == 2.0f ? kModeInt8 : kModeF32;
}

// residency.py _cast_dyn: mode 1 rounds to bf16, mode 2 snaps to the int8
// grid clip(rint(x / s) * s, lo, hi), anything else passes x through
template <int MODE>
__device__ __forceinline__ float cast_in(float x, const Layer& L) {
  if constexpr (MODE == kModeBF16) return bf16_round(x);
  if constexpr (MODE == kModeInt8) {
    const float safe = L.s > 1e-30f ? L.s : 1e-30f;
    float v = __fmul_rn(rintf(__fdiv_rn(x, safe)), safe);
    v = v < L.lo ? L.lo : v;  // comparisons keep a NaN, as jnp.clip
    return v > L.hi ? L.hi : v;
  }
  return x;
}

// residency.py _round_in
__device__ __forceinline__ float round_in(float x, float mode) {
  return mode == 1.0f ? bf16_round(x) : x;
}

template <int MODE>
__device__ __forceinline__ float round_in(float x) {
  return MODE == kModeBF16 ? bf16_round(x) : x;
}

__device__ __forceinline__ float activate(int act, float x) {
  switch (act) {
    case kRelu: return x < 0.0f ? 0.0f : x;
    case kGelu: {  // the tanh form, as jax.nn.gelu's default
      const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return 0.5f * x * (1.0f + tanhf(inner));
    }
    case kSilu: return x / (1.0f + expf(-x));
    case kTanh: return tanhf(x);
    case kSigmoid: return 1.0f / (1.0f + expf(-x));
    case kRelu2: {
      const float r = x < 0.0f ? 0.0f : x;
      return r * r;
    }
    default: return x;
  }
}

// activate() over a register tile, the switch taken once
template <int M>
__device__ __forceinline__ void activate_tile(int act, float (&v)[M][kTN]) {
#define REPRO_TILE(A)                                  \
  _Pragma("unroll") for (int i = 0; i < M; ++i)         \
      _Pragma("unroll") for (int j = 0; j < kTN; ++j)   \
          v[i][j] = activate(A, v[i][j]);               \
  return
  switch (act) {
    case kRelu: REPRO_TILE(kRelu);
    case kGelu: REPRO_TILE(kGelu);
    case kSilu: REPRO_TILE(kSilu);
    case kTanh: REPRO_TILE(kTanh);
    case kSigmoid: REPRO_TILE(kSigmoid);
    case kRelu2: REPRO_TILE(kRelu2);
    default: return;
  }
#undef REPRO_TILE
}

// edge k of the CSR (perm index): its source row (-1 when the edge or
// its source is out of range) and scale
__device__ __forceinline__ void edge_of(const StackArgs& a, int k, int& sr,
                                        float& sc) {
  sr = -1;
  sc = 0.0f;
  const int e = __ldg(a.perm + k);
  if (e < 0 || e >= a.num_edges) return;
  const int s = __ldg(a.src + e);
  const float c = __ldg(a.scale + e);   // beside the source, not after it
  if (s < 0 || s >= a.n) return;
  sr = s;
  sc = c;
}

// Rows [k0, k0 + nk) of one product's weights (prod 0: the main product,
// [Wa; Wn] for SAGE; prod 1: the skip), output columns [64 cp, 64 cp + 64),
// into dst (nk x 64) by cp.async; rows past `in` (of each half) and
// columns past `out` are zero-filled.
template <bool SAGE>
__device__ __forceinline__ void stage_weights(float* dst, const Layer& L,
                                              int f, int prod, int cp,
                                              int k0, int nk) {
  const int col0 = cp * kCols;
  for (int idx = threadIdx.x; idx < nk * (kCols / 4);
       idx += kThreads) {
    const int r = idx / (kCols / 4);
    const int c = (idx % (kCols / 4)) * 4;
    int k = k0 + r;
    const float* w = prod ? L.wsk : L.wn;
    if (SAGE && !prod) {
      if (k < L.in_p) {
        w = L.wa;
      } else {
        k -= L.in_p;
      }
    }
    const int cols = L.out - (col0 + c);
    const bool ok = k < L.in && cols > 0;
    cp_async16(dst + r * kCols + c,
               ok ? w + static_cast<size_t>(k) * f + col0 + c : L.wn,
               ok ? 4 * (cols < 4 ? cols : 4) : 0);
  }
}

// acc[i][j] += sum_k A[(ty + 16 i) pitch + k] W[k 64 + 4 tx + j], k < K
// (a multiple of 4): both from shared memory, 16-byte loads
template <int M>
__device__ __forceinline__ void product(const float* A, int pitch,
                                        const float* W, int K,
                                        float (&acc)[M][kTN]) {
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const float* a0 = A + ty * pitch;
  const float* w0 = W + 4 * tx;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 av[M];
#pragma unroll
    for (int i = 0; i < M; ++i)
      av[i] = *reinterpret_cast<const float4*>(a0 + kTY * i * pitch + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b = *reinterpret_cast<const float4*>(w0 + (k + q) * kCols);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const float x = q == 0 ? av[i].x : q == 1 ? av[i].y
                      : q == 2 ? av[i].z : av[i].w;
        acc[i][0] = fmaf(x, b.x, acc[i][0]);
        acc[i][1] = fmaf(x, b.y, acc[i][1]);
        acc[i][2] = fmaf(x, b.z, acc[i][2]);
        acc[i][3] = fmaf(x, b.w, acc[i][3]);
      }
    }
  }
}

template <int M>
__device__ __forceinline__ void zero(float (&acc)[M][kTN]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
}

// The ring: the chunk's weight slices in the order the products take
// them, per 64-column pass the main product's then the skip's; slice t
// lands in buffer t % kStages.
struct Ring {
  int main_slices, per_pass, total;
};

template <bool SAGE>
__device__ __forceinline__ void stage_slice(float* W, const Layer& L, int f,
                                            const Ring& ring, int t) {
  const int cp = t / ring.per_pass, j = t % ring.per_pass;
  const int prod = j >= ring.main_slices;
  const int k0 = (prod ? j - ring.main_slices : j) * kSlice;
  const int depth = prod ? L.in_p : L.kmain;
  stage_weights<SAGE>(W + (t % kStages) * kSlice * kCols, L, f, prod, cp,
                      k0, min(kSlice, depth - k0));
}

// One product of depth K over the ring's next slices (slice counter t).
// Every thread of the block calls it: it holds block barriers.
template <bool SAGE, int M>
__device__ __forceinline__ void ring_product(float* W, const Layer& L, int f,
                                             const Ring& ring, int& t,
                                             const float* A, int pitch,
                                             int K, float (&acc)[M][kTN]) {
  for (int k0 = 0; k0 < K; k0 += kSlice, ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice t landed; slice t - 1's buffer is free
    if (t + kStages - 1 < ring.total)
      stage_slice<SAGE>(W, L, f, ring, t + kStages - 1);
    cp_async_commit();
    product<M>(A + k0, pitch, W + (t % kStages) * kSlice * kCols,
               min(kSlice, K - k0), acc);
  }
}

// The chunk's products and epilogue: rows [row0, row0 + h) of the next
// table, M = rows_p / 16 rows a thread. xs: the chunk's fp32 table rows
// (pitch in_p); t: the main product's input (pitch kmain). Every thread
// of the block calls it.
template <bool SAGE, bool RING, int M>
__device__ __forceinline__ void chunk_out(const StackArgs& a, const Layer& L,
                                          float* W, const float* xs,
                                          const float* t, int row0, int h,
                                          float* next) {
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  Ring ring{};
  int slice = 0;
  if constexpr (RING) {
    ring.main_slices = (L.kmain + kSlice - 1) / kSlice;
    ring.per_pass = ring.main_slices +
                    (a.has_skip ? (L.in_p + kSlice - 1) / kSlice : 0);
    ring.total = L.cps * ring.per_pass;
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < ring.total) stage_slice<SAGE>(W, L, a.f, ring, s);
      cp_async_commit();
    }
  }
  float m[M];      // the rows' masks, loaded under the first product
#pragma unroll
  for (int i = 0; i < M; ++i)
    m[i] = ty + kTY * i < h ? __ldg(a.mask + row0 + ty + kTY * i) : 0.0f;
  for (int cp = 0; cp < L.cps; ++cp) {
    float hv[M][kTN], acc[M][kTN];
    const int col = cp * kCols + 4 * tx;
    float bj[kTN];  // loaded under the product
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      bj[j] = col + j < L.out ? __ldg(L.bias + col + j) : 0.0f;
    zero(acc);
    if constexpr (RING)
      ring_product<SAGE, M>(W, L, a.f, ring, slice, t, L.kmain, L.kmain,
                            acc);
    else
      product<M>(t, L.kmain, W + cp * L.kmain * kCols, L.kmain, acc);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        hv[i][j] = round_in(__fadd_rn(acc[i][j], bj[j]), L.mode);
    if (a.has_skip) {
      zero(acc);
      if constexpr (RING)
        ring_product<SAGE, M>(W, L, a.f, ring, slice, xs, L.in_p,
                              L.in_p, acc);
      else
        product<M>(xs, L.in_p,
                   W + (L.cps * L.kmain + cp * L.in_p) * kCols, L.in_p, acc);
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) hv[i][j] = __fadd_rn(hv[i][j], acc[i][j]);
    }
    activate_tile(a.activation, hv);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int r = ty + kTY * i;
      if (r >= h || col >= L.out) continue;
      const int row = row0 + r;
      float v[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) v[j] = __fmul_rn(hv[i][j], m[i]);
      float* p = next + static_cast<size_t>(row) * a.f + col;
      if (col + kTN <= L.out) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          if (col + j < L.out) p[j] = v[j];
      }
    }
  }
}

// chunk_out with M = m rows a thread, 1 <= m <= kMaxM
template <bool SAGE, bool RING, int M>
__device__ __forceinline__ void chunk_out_m(int m, const StackArgs& a,
                                            const Layer& L, float* W,
                                            const float* xs, const float* t,
                                            int row0, int h, float* next) {
  if constexpr (M < kMaxM) {
    if (m > M) {
      chunk_out_m<SAGE, RING, M + 1>(m, a, L, W, xs, t, row0, h, next);
      return;
    }
  }
  chunk_out<SAGE, RING, M>(a, L, W, xs, t, row0, h, next);
}

// The chunk's rows of the products' inputs, for rows r < rows_p. The
// lanes of a row own float4 column groups of its first in_p columns
// (32 / lanes rows share a warp), and each lane group walks a contiguous
// range of rows and their edges in CSR order, kBatch edges at a time:
// the batch's neighbour rows are all loaded before any is folded, a row
// being finished when the walk passes its last edge. GCN: t =
// round(aggr + xq sv); SAGE: t = [round(xq) | round(aggr / max(count,
// 1))]. Rows past h are zero.
template <bool SAGE, int MODE>
__device__ __forceinline__ void gather(const StackArgs& a, const Layer& L,
                                       const float* cur, int h, int rows_p,
                                       int beg, int staged, const int* s_off,
                                       const int* s_src, const float* s_scale,
                                       const float* s_sv, const float* xs,
                                       float* t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int vecs = L.in_p / 4;
  int lanes = 1;
  while (lanes < vecs && lanes < 32) lanes <<= 1;
  const int at_once = 32 / lanes;
  const int col_groups = (vecs + lanes - 1) / lanes;
  const int sub = lane & (lanes - 1);
  const int group = warp * at_once + lane / lanes;
  const int per = (rows_p + kWarps * at_once - 1) / (kWarps * at_once);
  const int ra = min(rows_p, group * per), rb = min(rows_p, ra + per);
  const int live = min(rb, h);    // rows [ra, live) have edges to fold
  for (int g = 0; g < col_groups; ++g) {
    const int c = 4 * (g * lanes + sub);
    if (c >= L.in_p) continue;
    // row r's aggregate is done: its t entries from acc, count and xs
    const auto finish = [&](int r, const float (&acc)[4], int cnt) {
      const float4 x4 =
          *reinterpret_cast<const float4*>(xs + r * L.in_p + c);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
      const float div = static_cast<float>(cnt > 1 ? cnt : 1);
      float* tr = t + r * L.kmain + c;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float xq = cast_in<MODE>(xv[q], L);
        if constexpr (SAGE) {
          tr[q] = round_in<MODE>(xq);
          tr[L.in_p + q] = round_in<MODE>(__fdiv_rn(acc[q], div));
        } else {
          tr[q] = round_in<MODE>(__fadd_rn(acc[q], __fmul_rn(xq, s_sv[r])));
        }
      }
    };
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int cnt = 0;
    int r = ra;
    int k = ra < live ? s_off[ra] : 0;
    const int k_end = ra < live ? s_off[live] : 0;
    int r_end = ra < live ? s_off[ra + 1] : 0;   // one past row r's edges
    while (k < k_end) {
      const int nb = min(kBatch, k_end - k);
      float4 v[kBatch];
      float sc[kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {   // every load of the batch first
        ok[b] = false;
        sc[b] = 0.0f;
        v[b] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (b >= nb) continue;
        int sr;
        if (k + b < staged) {
          sr = s_src[k + b];
          sc[b] = s_scale[k + b];
        } else {
          edge_of(a, beg + k + b, sr, sc[b]);
        }
        if (sr < 0) continue;
        ok[b] = true;
        v[b] = __ldcg(reinterpret_cast<const float4*>(
            cur + static_cast<size_t>(sr) * a.f + c));
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {   // then the folds, in CSR order
        if (b >= nb) break;
        while (k + b >= r_end) {           // rows whose edges are done
          finish(r, acc, cnt);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = 0.0f;
          cnt = 0;
          r_end = s_off[++r + 1];
        }
        if (!ok[b]) continue;
        ++cnt;
        const float vv[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(cast_in<MODE>(vv[q], L), sc[b]));
      }
      k += nb;
    }
    for (; r < live; ++r) {                // the last row, and empty ones
      finish(r, acc, cnt);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = 0.0f;
      cnt = 0;
    }
    for (r = max(ra, h); r < rb; ++r) {    // padding rows
      float* tr = t + r * L.kmain + c;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        tr[q] = 0.0f;
        if constexpr (SAGE) tr[L.in_p + q] = 0.0f;
      }
    }
  }
}

template <bool SAGE, bool RING>
__global__ void __launch_bounds__(kThreads, 1)
fused_layer_stack_kernel(const __grid_constant__ StackArgs a) {
  extern __shared__ float4 smem4[];
  float* W = reinterpret_cast<float*>(smem4);
  float* A = W + a.w_floats;
  int* s_src = reinterpret_cast<int*>(A + a.a_floats);
  float* s_scale = reinterpret_cast<float*>(s_src + kEdgeCap);
  float* s_sv = s_scale + kEdgeCap;
  int* s_off = reinterpret_cast<int*>(s_sv + kMaxRows);
  cg::grid_group grid = cg::this_grid();
  const long long first = static_cast<long long>(blockIdx.x) *
                          a.rows_per_block;
  const int r_begin = static_cast<int>(first < a.n ? first : a.n);
  const int r_end = static_cast<int>(
      first + a.rows_per_block < a.n ? first + a.rows_per_block : a.n);
  const int rows = r_end - r_begin;
  const int chunks = (rows + a.max_rows - 1) / a.max_rows;
  const int height =
      chunks > 0 ? ((rows + chunks - 1) / chunks + kTY - 1) / kTY * kTY : 0;
  for (int layer = 0; layer < a.num_layers; ++layer) {
    // the last layer writes `out`; earlier ones alternate back from it
    const bool to_out = (a.num_layers - 1 - layer) % 2 == 0;
    const float* cur = layer == 0 ? a.x0 : (to_out ? a.scratch : a.out);
    float* next = to_out ? a.out : a.scratch;
    const Layer L = layer_of<SAGE>(a, layer);
    float* xs = A;
    float* t = A + a.max_rows * L.in_p;
    for (int ch = 0; ch < chunks; ++ch) {
      const int row0 = r_begin + ch * height;
      const int h = min(height, r_end - row0);
      const int rows_p = (h + kTY - 1) / kTY * kTY;
      __syncthreads();  // the previous chunk's tiles are consumed
      const int quads = L.in_p / 4;
      for (int idx = threadIdx.x; idx < rows_p * quads;
           idx += kThreads) {
        const int r = idx / quads, c = (idx % quads) * 4;
        const bool ok = r < h;
        cp_async16(xs + r * L.in_p + c,
                   ok ? cur + static_cast<size_t>(row0 + r) * a.f + c : cur,
                   ok ? 16 : 0);
      }
      cp_async_commit();
      const bool stage_w = !RING && ch == 0;
      if (stage_w) {  // the layer's weights, once, under the first gather
        for (int cp = 0; cp < L.cps; ++cp) {
          stage_weights<SAGE>(W + cp * L.kmain * kCols, L, a.f, 0, cp, 0,
                              L.kmain);
          if (a.has_skip)
            stage_weights<SAGE>(W + (L.cps * L.kmain + cp * L.in_p) * kCols,
                                L, a.f, 1, cp, 0, L.in_p);
        }
        cp_async_commit();
      }
      // the chunk's CSR slice: offsets, then each edge's source and scale
      const int beg = __ldg(a.offsets + row0);
      for (int i = threadIdx.x; i <= h; i += kThreads) {
        s_off[i] = __ldg(a.offsets + row0 + i) - beg;
        if (!SAGE && i < h) s_sv[i] = __ldg(a.self_vec + row0 + i);
      }
      const int edges = __ldg(a.offsets + row0 + h) - beg;
      const int staged = edges < kEdgeCap ? edges : kEdgeCap;
      for (int i = threadIdx.x; i < staged; i += kThreads) {
        int sr;
        float sc;
        edge_of(a, beg + i, sr, sc);
        s_src[i] = sr;
        s_scale[i] = sc;
      }
      if (stage_w)
        cp_async_wait<1>();   // the table rows; the weights may still fly
      else
        cp_async_wait<0>();
      __syncthreads();
      switch (mode_of(L.mode)) {   // the gather compiled for the mode
        case kModeBF16:
          gather<SAGE, kModeBF16>(a, L, cur, h, rows_p, beg, staged, s_off,
                                  s_src, s_scale, s_sv, xs, t);
          break;
        case kModeInt8:
          gather<SAGE, kModeInt8>(a, L, cur, h, rows_p, beg, staged, s_off,
                                  s_src, s_scale, s_sv, xs, t);
          break;
        default:
          gather<SAGE, kModeF32>(a, L, cur, h, rows_p, beg, staged, s_off,
                                 s_src, s_scale, s_sv, xs, t);
      }
      cp_async_wait<0>();
      __syncthreads();
      chunk_out_m<SAGE, RING, 1>(rows_p / kTY, a, L, W, xs, t, row0, h,
                                 next);
      if (L.out < a.f) {  // the padding columns: act(0) * mask
        const float z = activate(a.activation, 0.0f);
        const int pad = a.f - L.out;
        for (int idx = threadIdx.x; idx < h * pad; idx += kThreads) {
          const int r = idx / pad;
          next[static_cast<size_t>(row0 + r) * a.f + L.out + idx % pad] =
              __fmul_rn(z, __ldg(a.mask + row0 + r));
        }
      }
    }
    if (layer + 1 < a.num_layers) grid.sync();  // next table complete
  }
}

template <bool SAGE, bool RING>
int launch(StackArgs a, int rows, size_t smem, cudaStream_t stream) {
  const auto kernel = fused_layer_stack_kernel<SAGE, RING>;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, smem);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return static_cast<int>(err);
  // every co-resident block, but no block under kTY rows
  const long long want = (static_cast<long long>(a.n) + kTY - 1) / kTY;
  const int blocks = static_cast<int>(
      want < static_cast<long long>(per_sm) * sms ? want : per_sm * sms);
  a.rows_per_block = (a.n + blocks - 1) / blocks;
  a.max_rows = rows;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks),
                                    dim3(kThreads), params, smem,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Lays out shared memory for the layers' widths and launches: the
// weights resident with the tallest chunk (<= 128 rows) that fits beside
// them, or the ring where that chunk would be under half the ring's.
template <bool SAGE>
int plan_and_launch(StackArgs a, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long w_res = 0, a_row = 0;
  for (int l = 0; l < a.num_layers; ++l) {
    const long long in_p = (a.in_dim[l] + 3) & ~3;
    const long long kmain = SAGE ? 2 * in_p : in_p;
    const long long cps = (a.out_dim[l] + kCols - 1) / kCols;
    const long long w = (kmain + (a.has_skip ? in_p : 0)) * cps * kCols;
    w_res = w > w_res ? w : w_res;
    a_row = in_p + kmain > a_row ? in_p + kmain : a_row;
  }
  const long long words = optin / 4 - kFixedWords;
  const long long w_ring = kStages * kSlice * kCols;
  const auto fit = [&](long long w) {   // the tallest chunk beside w words
    const long long rows = (words - w) / a_row / kTY * kTY;
    return rows < kMaxRows ? rows : kMaxRows;
  };
  // resident weights are staged once a layer, the ring streams them
  // through every chunk: the ring only where resident chunks would be
  // under half as tall
  const long long resident = fit(w_res), streamed = fit(w_ring);
  const bool ring = resident < kTY || 2 * resident < streamed;
  const long long rows = ring ? streamed : resident;
  if (rows < kTY) return static_cast<int>(cudaErrorInvalidValue);
  a.w_floats = static_cast<int>(ring ? w_ring : w_res);
  a.a_floats = static_cast<int>(rows * a_row);
  const size_t smem =
      4 * (static_cast<size_t>(a.w_floats) + a.a_floats + kFixedWords);
  return ring ? launch<SAGE, true>(a, static_cast<int>(rows), smem, stream)
              : launch<SAGE, false>(a, static_cast<int>(rows), smem, stream);
}

}  // namespace
}  // namespace repro

// Runs the num_layers layers on the current table x0 (n, f) and writes the
// final table to out; scratch is a second (n, f) buffer when
// num_layers > 1. kind 0 = GCN, 1 = SAGE. widths: a host array of
// num_layers (in, out) pairs, each in [1, f], in_{k+1} = out_k. Every
// pointer but widths is device memory, x0, out, scratch and the weights
// 16-byte aligned. Returns 0 once launched, the CUDA error of a refused
// launch (never a fallback), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int repro_fused_layer_stack(
    const float* x0, int n, int f, int num_layers, const int32_t* src,
    const float* scale, int num_edges, const int32_t* perm,
    const int32_t* offsets, const float* self_vec, const float* mask,
    const float* wa, const float* wn, const float* wsk, const float* bias,
    const float* qp, int kind, int activation, int has_skip, float* out,
    float* scratch, const int32_t* widths, void* stream) {
  using namespace repro;
  if (n < 1 || f < 32 || f % 32 != 0 || f > kMaxF || num_layers < 1 ||
      num_layers > kMaxLayers || widths == nullptr ||
      (num_layers > 1 && scratch == nullptr) || activation < kRelu ||
      activation > kRelu2 || (kind != 0 && kind != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  StackArgs a{};
  a.x0 = x0;
  a.out = out;
  a.scratch = scratch;
  a.n = n;
  a.f = f;
  a.num_layers = num_layers;
  a.src = src;
  a.scale = scale;
  a.num_edges = num_edges;
  a.perm = perm;
  a.offsets = offsets;
  a.self_vec = self_vec;
  a.mask = mask;
  a.wa = wa;
  a.wn = wn;
  a.wsk = wsk;
  a.bias = bias;
  a.qp = qp;
  a.activation = activation;
  a.has_skip = has_skip;
  for (int l = 0; l < num_layers; ++l) {
    const int in = widths[2 * l], o = widths[2 * l + 1];
    if (in < 1 || in > f || o < 1 || o > f ||
        (l > 0 && in != widths[2 * l - 1]))
      return static_cast<int>(cudaErrorInvalidValue);
    a.in_dim[l] = in;
    a.out_dim[l] = o;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == 1 ? plan_and_launch<true>(a, st)
                   : plan_and_launch<false>(a, st);
}
