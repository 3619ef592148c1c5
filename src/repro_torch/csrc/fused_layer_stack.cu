// Multi-layer resident GCN / SAGE stack for Hopper: K conv layers in one
// cooperative launch.
//
// Each layer k reads the (N, F) fp32 node table T_k (F = fmax, the widest
// layer padded to a multiple of 32; zero-padded weights keep padding
// columns out of real ones) and writes T_{k+1}:
//
//   xq    = cast_k(T_k)                 // qp row [mode, s, lo, hi]: fp32,
//                                       // bf16 rounding or int8 fake-quant
//   aggr  = sum over the CSR's edges e into d, in stream order,
//           of scale[e] * xq[src[e]]    (SAGE: / max(count, 1))
//   GCN:  h = round(aggr + xq * sv) @ Wn + b
//   SAGE: h = round(xq) @ Wa + b + round(aggr) @ Wn
//   h     = round(h) [+ T_k @ Wskip]    // the skip reads the fp32 table
//   T_{k+1} = act(h) * mask
//
// where round() is bf16 rounding in bf16 mode and the identity otherwise.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_gather_aggregate/residency.py,
//   fused_layer_stack_pallas (body _stack_kernel).
// That kernel keeps the table, an (N, F) aggregate and a quantized shadow
// table in VMEM and sweeps the edge stream sequentially, one layer after
// the other. Here one cooperative grid (all blocks co-resident, grid-stride
// over tiles of 32 rows) runs every layer and meets at a grid barrier
// between layers; the table ping-pongs between two device buffers that
// stay in the 50 MB L2 at the paper's sizes (core/convs.py,
// residency_plan). Within a layer a block owns a row tile: its warps fold
// each row's in-edges in CSR order (stream order, __fadd_rn/__fmul_rn, no
// FMA, as fused_gather_aggregate.cu) into a shared-memory tile, casting
// the source rows as they are read, so neither the aggregate nor the
// shadow table exists in device memory. The block then multiplies the
// tile by the layer's weights, staged through shared memory in 32-row
// slices, with SIMT fp32 FMAs (a 4 x 4 register tile per thread), and the
// epilogue writes its rows of the next table.
//
// Bound on this card: operations at the paper's widths. Each layer does
// 2 N F^2 (GCN) or 3 x that (SAGE), plus 2 N F^2 for the skip, fp32
// multiply-adds against two table reads and one write per row. The SIMT
// product is the cost; moving it onto wgmma tiles, and overlapping the
// weight slices with TMA, is later work. The table reads go through
// __ldcg (L2, not the non-coherent L1): the buffers are rewritten by
// other blocks between the grid barriers.

#include <cooperative_groups.h>

#include "common.cuh"

namespace repro {
namespace {

namespace cg = cooperative_groups;

// activation codes shared with the Python wrapper
// (kernels/fused_layer_stack/kernel.py, ACT_CODES: nn.layers.ACTIVATIONS order)
enum Act : int {
  kRelu = 0, kGelu = 1, kSilu = 2, kTanh = 3, kSigmoid = 4, kIdentity = 5,
  kRelu2 = 6
};

constexpr int kRows = 32;                            // rows per tile
constexpr int kRowsPerWarp = kRows / kWarpsPerBlock;  // 4
constexpr int kColChunk = 128;                       // output columns per pass
constexpr int kColsPerLane = kColChunk / 32;         // 4
constexpr int kSlice = 32;                           // weight rows per stage
constexpr int kMaxF = 512;                           // shared memory < 227 KB

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
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// residency.py _cast_dyn: mode 1 rounds to bf16, mode 2 snaps to the int8
// grid clip(rint(x / s) * s, lo, hi), anything else passes x through
__device__ __forceinline__ float cast_in(float x, float mode, float s,
                                         float lo, float hi) {
  if (mode == 1.0f) return bf16_round(x);
  if (mode == 2.0f) {
    const float safe = s > 1e-30f ? s : 1e-30f;
    float v = __fmul_rn(rintf(__fdiv_rn(x, safe)), safe);
    v = v < lo ? lo : v;  // comparisons keep a NaN, as jnp.clip
    return v > hi ? hi : v;
  }
  return x;
}

// residency.py _round_in
__device__ __forceinline__ float round_in(float x, float mode) {
  return mode == 1.0f ? bf16_round(x) : x;
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

// The tile's inputs to the layer's products, for the rows this warp owns
// (warp + 8 i): xs = the fp32 table rows, t0 = GCN's round(aggr + xq sv)
// or SAGE's round(xq), t1 = SAGE's round(aggr / max(count, 1)). Rows past
// n are zero.
template <bool SAGE>
__device__ void prepare_tile(const StackArgs& a, const float* cur, int row0,
                             float mode, float s, float lo, float hi,
                             float* xs, float* t0, float* t1) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = a.f;
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarpsPerBlock * i;
    const int row = row0 + r;
    float* xr = xs + r * f;
    float* t0r = t0 + r * f;
    float* t1r = t1 + r * f;
    if (row >= a.n) {
      for (int c = lane; c < f; c += 32) {
        xr[c] = 0.0f;
        t0r[c] = 0.0f;
        if constexpr (SAGE) t1r[c] = 0.0f;
      }
      continue;
    }
    const int beg = a.offsets[row];
    const int end = a.offsets[row + 1];
    const float sv = SAGE ? 0.0f : a.self_vec[row];
    for (int c = lane; c < f; c += 32) {
      const float xv = __ldcg(cur + static_cast<size_t>(row) * f + c);
      float acc = 0.0f;
      int count = 0;
      for (int k = beg; k < end; ++k) {
        const int e = a.perm[k];
        if (e < 0 || e >= a.num_edges) continue;
        const int sr = a.src[e];
        if (sr < 0 || sr >= a.n) continue;
        const float v = cast_in(__ldcg(cur + static_cast<size_t>(sr) * f + c),
                                mode, s, lo, hi);
        acc = __fadd_rn(acc, __fmul_rn(v, a.scale[e]));
        ++count;
      }
      const float xq = cast_in(xv, mode, s, lo, hi);
      xr[c] = xv;
      if constexpr (SAGE) {
        t0r[c] = round_in(xq, mode);
        t1r[c] = round_in(
            __fdiv_rn(acc, static_cast<float>(count > 1 ? count : 1)), mode);
      } else {
        t0r[c] = round_in(__fadd_rn(acc, __fmul_rn(xq, sv)), mode);
      }
    }
  }
}

// acc[i][j] += sum_k as[warp + 8 i][k] * w[k][c0 + lane + 32 j]: the
// (kRows, f) shared-memory tile `as` times columns c0.. of the (f, f)
// weights, staged through `ws` one kSlice x kColChunk slice at a time.
// Every thread of the block calls it (it holds block barriers).
__device__ void tile_product(const float* as, const float* __restrict__ w,
                             int f, int c0, float* ws,
                             float (&acc)[kRowsPerWarp][kColsPerLane]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < f; k0 += kSlice) {
    __syncthreads();  // the previous slice is consumed
    for (int idx = threadIdx.x; idx < kSlice * kColChunk;
         idx += kThreadsPerBlock) {
      const int col = c0 + idx % kColChunk;
      ws[idx] = col < f
                    ? w[static_cast<size_t>(k0 + idx / kColChunk) * f + col]
                    : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kSlice; ++kk) {
      float av[kRowsPerWarp];
      float wv[kColsPerLane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        av[i] = as[(warp + kWarpsPerBlock * i) * f + k0 + kk];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j)
        wv[j] = ws[kk * kColChunk + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j)
          acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kRowsPerWarp][kColsPerLane]) {
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = 0.0f;
}

template <bool SAGE>
__global__ void __launch_bounds__(kThreadsPerBlock)
fused_layer_stack_kernel(StackArgs a) {
  extern __shared__ float smem[];
  const int f = a.f;
  float* ws = smem;                      // kSlice x kColChunk weight slice
  float* xs = ws + kSlice * kColChunk;   // kRows x f, each tile input below
  float* t0 = xs + kRows * f;
  float* t1 = t0 + kRows * f;            // SAGE only
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tiles = (a.n + kRows - 1) / kRows;
  cg::grid_group grid = cg::this_grid();
  for (int layer = 0; layer < a.num_layers; ++layer) {
    // the last layer writes `out`; earlier ones alternate back from it
    const bool to_out = (a.num_layers - 1 - layer) % 2 == 0;
    const float* cur = layer == 0 ? a.x0 : (to_out ? a.scratch : a.out);
    float* next = to_out ? a.out : a.scratch;
    const float* q = a.qp + 4 * layer;
    const float mode = q[0], s = q[1], lo = q[2], hi = q[3];
    const size_t wofs = static_cast<size_t>(layer) * f * f;
    const float* bias = a.bias + static_cast<size_t>(layer) * f;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = tile * kRows;
      __syncthreads();  // the previous tile's shared memory is consumed
      prepare_tile<SAGE>(a, cur, row0, mode, s, lo, hi, xs, t0, t1);
      __syncthreads();
      for (int c0 = 0; c0 < f; c0 += kColChunk) {
        float h[kRowsPerWarp][kColsPerLane];
        float acc[kRowsPerWarp][kColsPerLane];
        zero(acc);
        tile_product(t0, (SAGE ? a.wa : a.wn) + wofs, f, c0, ws, acc);
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const int col = c0 + lane + 32 * j;
          const float bj = col < f ? bias[col] : 0.0f;
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
            h[i][j] = __fadd_rn(acc[i][j], bj);
        }
        if constexpr (SAGE) {
          zero(acc);
          tile_product(t1, a.wn + wofs, f, c0, ws, acc);
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
            for (int j = 0; j < kColsPerLane; ++j)
              h[i][j] = __fadd_rn(h[i][j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
          for (int j = 0; j < kColsPerLane; ++j)
            h[i][j] = round_in(h[i][j], mode);
        if (a.has_skip) {
          zero(acc);
          tile_product(xs, a.wsk + wofs, f, c0, ws, acc);
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
            for (int j = 0; j < kColsPerLane; ++j)
              h[i][j] = __fadd_rn(h[i][j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int row = row0 + warp + kWarpsPerBlock * i;
          if (row >= a.n) continue;
          const float m = a.mask[row];
#pragma unroll
          for (int j = 0; j < kColsPerLane; ++j) {
            const int col = c0 + lane + 32 * j;
            if (col < f)
              next[static_cast<size_t>(row) * f + col] =
                  __fmul_rn(activate(a.activation, h[i][j]), m);
          }
        }
      }
    }
    if (layer + 1 < a.num_layers) grid.sync();  // next table complete
  }
}

template <bool SAGE>
int launch(const StackArgs& a, cudaStream_t stream) {
  const auto kernel = fused_layer_stack_kernel<SAGE>;
  const size_t smem =
      (kSlice * kColChunk + (SAGE ? 3 : 2) * kRows * static_cast<size_t>(a.f)) *
      sizeof(float);
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
        &per_sm, kernel, kThreadsPerBlock, smem);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.n + kRows - 1) / kRows;
  const int blocks = tiles < per_sm * sms ? tiles : per_sm * sms;
  StackArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks),
                                    dim3(kThreadsPerBlock), params, smem,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// Runs the num_layers layers on the current table x0 (n, f) and writes the
// final table to out; scratch is a second (n, f) buffer when
// num_layers > 1. kind 0 = GCN, 1 = SAGE. Returns 0 once launched, the
// CUDA error of a refused launch (never a fallback), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int repro_fused_layer_stack(
    const float* x0, int n, int f, int num_layers, const int32_t* src,
    const float* scale, int num_edges, const int32_t* perm,
    const int32_t* offsets, const float* self_vec, const float* mask,
    const float* wa, const float* wn, const float* wsk, const float* bias,
    const float* qp, int kind, int activation, int has_skip, float* out,
    float* scratch, void* stream) {
  using namespace repro;
  if (n < 1 || f < 32 || f % 32 != 0 || f > kMaxF || num_layers < 1 ||
      (num_layers > 1 && scratch == nullptr) || activation < kRelu ||
      activation > kRelu2 || (kind != 0 && kind != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const StackArgs a{x0,   out,      scratch, n,  f,   num_layers, src,
                    scale, num_edges, perm, offsets, self_vec, mask, wa,
                    wn,   wsk,      bias,    qp, activation, has_skip};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == 1 ? launch<true>(a, st) : launch<false>(a, st);
}
