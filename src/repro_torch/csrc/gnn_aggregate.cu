// Aggregation over a padded (N, K) neighbour table, for Hopper.
//
//   out[r, c] = agg over the valid slots k of nbr[r] of x[nbr[r, k], c]
//
// with agg in sum / mean / min / max / var / std, x stored as fp32 or
// bf16, every accumulator in fp32 and the result written in x's dtype. A
// slot is valid when its id lies in [0, N): -1 marks padding, and any
// other out-of-range id drops the slot too. The slots fold in table
// order: sum/mean add, min/max keep NaN, var/std take Welford's step.
// Empty rows give 0 (var the 1e-12 floor, std its square root); mean
// divides by max(count, 1), min/max zero every non-finite result, var is
// max(M2 / max(count, 1), 1e-12).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gnn_aggregate/kernel.py,
//   gnn_aggregate_pallas (body _agg_kernel).
// That kernel pins the whole (N, F) table in VMEM and walks (block_nodes,
// K) tiles of the neighbour table over a sequential grid, folding slot
// k of every row of the tile at once. Here the grid runs in parallel and
// its geometry is chosen from the shape and the card on the host
// (kernels/gnn_aggregate/kernel.py, launch_geometry), not from
// block_nodes:
//
// - a lane owns CPL consecutive columns (one 16-byte load where the row
//   allows it), a row takes `lanes` lanes (a power of two), so a warp
//   folds 32 / lanes rows at once and a narrow table (F = 11) packs
//   several rows into one warp instead of idling lanes;
// - a row wider than 32 lanes splits into column groups, each its own
//   warp, so a small N still gives the card enough warps (the 600-node
//   frame at F = 256: 1200 warps, where one block per 128 rows gave 5);
// - a warp walks `passes` row groups in series only where N would give
//   more than a few waves of warps.
//
// Each row's K slot ids are read once: lane j of the row's lanes loads
// slot j0 + j, and the ids reach the other lanes by __shfl_sync, chunk by
// chunk of `lanes` slots. The x rows of up to kBatch slots are loaded
// before any of them is folded, so that many loads are in flight, not
// one id -> row chain at a time. Every output is one fold chain over its
// row's slots in table order in one lane, so the geometry never changes
// a bit of the result, and no atomics are needed.
//
// Bound on this card: bytes. The neighbour table is read once (4 B per
// slot), each referenced x row once per referencing slot (from L2 after
// the first), and the (N, F) result written once, with one (Welford:
// four) fp32 operations per valid slot and column.
//
// Arithmetic: the explicitly rounded intrinsics, which nvcc never
// contracts into an FMA, so each step rounds as the plain PyTorch
// version's separate elementwise operations do.

#include "common.cuh"

namespace repro {
namespace {

constexpr float kVarFloor = 1e-12f;
constexpr int kBatch = 8;     // slots whose x rows are loaded before folding

struct Geometry {
  int lanes;       // lanes per row, a power of two <= 32
  int groups;      // column groups per row (lanes * CPL columns each)
  int passes;      // row groups a warp walks in series
  long long warps; // warps with work
  int vec;         // 1: CPL-element vector loads and stores
};

// CPL consecutive elements at p, as fp32; `vec` asks for one vector load
// (aligned to CPL elements), else element by element, the ones past
// `valid` zero
template <int CPL>
__device__ __forceinline__ void load(const float* p, bool vec, int valid,
                                     float (&v)[CPL]) {
  if constexpr (CPL == 4) {
    if (vec) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      return;
    }
  } else if constexpr (CPL == 2) {
    if (vec) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = q.x; v[1] = q.y;
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < CPL; ++q) v[q] = q < valid ? __ldg(p + q) : 0.0f;
}

__device__ __forceinline__ float bf16_bits(uint32_t bits) {
  return __uint_as_float(bits << 16);     // exact, as __bfloat162float
}

template <int CPL>
__device__ __forceinline__ void load(const __nv_bfloat16* p, bool vec,
                                     int valid, float (&v)[CPL]) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  if constexpr (CPL == 8) {
    if (vec) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(u));
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = bf16_bits(w[i] & 0xffffu);
        v[2 * i + 1] = bf16_bits(w[i] >> 16);
      }
      return;
    }
  } else if constexpr (CPL == 4) {
    if (vec) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(u));
      v[0] = bf16_bits(q.x & 0xffffu); v[1] = bf16_bits(q.x >> 16);
      v[2] = bf16_bits(q.y & 0xffffu); v[3] = bf16_bits(q.y >> 16);
      return;
    }
  } else if constexpr (CPL == 2) {
    if (vec) {
      const unsigned int q = __ldg(reinterpret_cast<const unsigned int*>(u));
      v[0] = bf16_bits(q & 0xffffu); v[1] = bf16_bits(q >> 16);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < CPL; ++q)
    v[q] = q < valid ? bf16_bits(__ldg(u + q)) : 0.0f;
}

template <int CPL>
__device__ __forceinline__ void store(float* p, bool vec, int valid,
                                      const float (&v)[CPL]) {
  if constexpr (CPL == 4) {
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  } else if constexpr (CPL == 2) {
    if (vec) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < CPL; ++q)
    if (q < valid) p[q] = v[q];
}

__device__ __forceinline__ uint32_t bf16_of(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int CPL>
__device__ __forceinline__ void store(__nv_bfloat16* p, bool vec, int valid,
                                      const float (&v)[CPL]) {
  unsigned short* u = reinterpret_cast<unsigned short*>(p);
  if constexpr (CPL == 8) {
    if (vec) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = bf16_of(v[2 * i]) | (bf16_of(v[2 * i + 1]) << 16);
      *reinterpret_cast<uint4*>(u) = make_uint4(w[0], w[1], w[2], w[3]);
      return;
    }
  } else if constexpr (CPL == 4) {
    if (vec) {
      *reinterpret_cast<uint2*>(u) =
          make_uint2(bf16_of(v[0]) | (bf16_of(v[1]) << 16),
                     bf16_of(v[2]) | (bf16_of(v[3]) << 16));
      return;
    }
  } else if constexpr (CPL == 2) {
    if (vec) {
      *reinterpret_cast<unsigned int*>(u) =
          bf16_of(v[0]) | (bf16_of(v[1]) << 16);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < CPL; ++q)
    if (q < valid) u[q] = static_cast<unsigned short>(bf16_of(v[q]));
}

template <typename T, int AGG, int CPL>
__global__ void __launch_bounds__(kThreadsPerBlock)
gnn_aggregate_kernel(const T* __restrict__ x, int n, int f,
                     const int32_t* __restrict__ nbr, int k_max,
                     Geometry g, T* __restrict__ out) {
  constexpr bool kWelford = AGG == kVar || AGG == kStd;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (warp >= g.warps) return;             // the whole warp
  const int lane = threadIdx.x & 31;
  const int at_once = 32 / g.lanes;        // rows a warp folds at once
  const int sub = lane & (g.lanes - 1);    // lane within its row
  const int group = static_cast<int>(warp % g.groups);
  const long long row_block = warp / g.groups;
  const int c0 = (group * g.lanes + sub) * CPL;
  const int valid = f - c0;                // columns of this lane in range
  const bool vec = g.vec != 0;
  for (int p = 0; p < g.passes; ++p) {
    const long long row =
        (row_block * g.passes + p) * at_once + lane / g.lanes;
    const bool row_ok = row < n;
    float acc[CPL], mean[CPL], m2[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      acc[q] = agg_init<AGG>();
      mean[q] = 0.0f;
      m2[q] = 0.0f;
    }
    int count = 0;
    float fcount = 0.0f;
    const int32_t* slots = nbr + (row_ok ? row : 0) * k_max;
    for (int j0 = 0; j0 < k_max; j0 += g.lanes) {
      // lane `sub` loads slot j0 + sub of its row once
      const int mine = row_ok && j0 + sub < k_max ? __ldg(slots + j0 + sub)
                                                  : -1;
      const int chunk = min(g.lanes, k_max - j0);
      for (int b0 = 0; b0 < chunk; b0 += kBatch) {
        float v[kBatch][CPL];
        bool ok[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int id = __shfl_sync(0xffffffffu, mine, b0 + b, g.lanes);
          ok[b] = b0 + b < chunk && id >= 0 && id < n;
          if (ok[b] && valid > 0) {
            load<CPL>(x + static_cast<size_t>(id) * f + c0, vec, valid,
                      v[b]);
          } else {
#pragma unroll
            for (int q = 0; q < CPL; ++q) v[b][q] = 0.0f;
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (!ok[b]) continue;
          if constexpr (kWelford) {
            fcount = __fadd_rn(fcount, 1.0f);
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
              const float delta = __fsub_rn(v[b][q], mean[q]);
              mean[q] = __fadd_rn(mean[q],
                                  __fdiv_rn(delta, fmaxf(fcount, 1.0f)));
              m2[q] = __fadd_rn(m2[q],
                                __fmul_rn(delta, __fsub_rn(v[b][q], mean[q])));
            }
          } else {
#pragma unroll
            for (int q = 0; q < CPL; ++q) acc[q] = agg_fold<AGG>(acc[q],
                                                                 v[b][q]);
            ++count;
          }
        }
      }
    }
    if (!row_ok || valid <= 0) continue;
    float res[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      if constexpr (kWelford) {
        float var = __fdiv_rn(m2[q], fmaxf(fcount, 1.0f));
        var = var < kVarFloor ? kVarFloor : var;  // NaN propagates
        res[q] = AGG == kStd ? __fsqrt_rn(var) : var;
      } else {
        res[q] = agg_finalize<AGG>(acc[q], count);
      }
    }
    store<CPL>(out + static_cast<size_t>(row) * f + c0, vec, valid, res);
  }
}

template <typename T, int CPL>
cudaError_t launch_cpl(int agg, const T* x, int n, int f, const int32_t* nbr,
                       int k_max, const Geometry& g, T* out,
                       cudaStream_t stream) {
  const long long blocks =
      (g.warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
#define REPRO_LAUNCH(A)                                                  \
  gnn_aggregate_kernel<T, A, CPL><<<grid, kThreadsPerBlock, 0, stream>>>( \
      x, n, f, nbr, k_max, g, out);                                      \
  return cudaGetLastError()
  switch (agg) {
    case kSum: REPRO_LAUNCH(kSum);
    case kMean: REPRO_LAUNCH(kMean);
    case kMin: REPRO_LAUNCH(kMin);
    case kMax: REPRO_LAUNCH(kMax);
    case kVar: REPRO_LAUNCH(kVar);
    case kStd: REPRO_LAUNCH(kStd);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
}

template <typename T>
cudaError_t launch_typed(int agg, int cpl, const void* x, int n, int f,
                         const int32_t* nbr, int k_max, const Geometry& g,
                         void* out, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  switch (cpl) {
    case 1: return launch_cpl<T, 1>(agg, xt, n, f, nbr, k_max, g, ot, stream);
    case 2: return launch_cpl<T, 2>(agg, xt, n, f, nbr, k_max, g, ot, stream);
    case 4: return launch_cpl<T, 4>(agg, xt, n, f, nbr, k_max, g, ot, stream);
    case 8:
      // 16 bytes of bf16; fp32 tops out at 4 columns a lane
      if constexpr (sizeof(T) == 2)
        return launch_cpl<T, 8>(agg, xt, n, f, nbr, k_max, g, ot, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// x (n, f) and out (n, f) in the storage type `dtype` (fp32 or bf16);
// nbr (n, k_max) int32. The geometry (kernel.py, launch_geometry):
// cols_per_lane columns a lane, lanes_per_row lanes a row (a power of
// two <= 32), col_groups column groups a row, passes row groups a warp
// and `warps` warps with work; vec = 1 asks for vector loads and stores
// (f a multiple of cols_per_lane, x aligned to them). Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for another dtype, an unknown agg code, n < 1 or
// a geometry the kernel does not take.
extern "C" int repro_gnn_aggregate(const void* x, int dtype, int n, int f,
                                   const int32_t* nbr, int k_max, int agg,
                                   int cols_per_lane, int lanes_per_row,
                                   int col_groups, int passes,
                                   long long warps, int vec, void* out,
                                   void* stream) {
  using namespace repro;
  const bool pow2 = lanes_per_row >= 1 && lanes_per_row <= 32 &&
                    (lanes_per_row & (lanes_per_row - 1)) == 0;
  if (n < 1 || f < 0 || k_max < 0 || !pow2 || col_groups < 1 ||
      passes < 1 || warps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{lanes_per_row, col_groups, passes, warps, vec ? 1 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      err = launch_typed<float>(agg, cols_per_lane, x, n, f, nbr, k_max, g,
                                out, st);
      break;
    case kBF16:
      err = launch_typed<__nv_bfloat16>(agg, cols_per_lane, x, n, f, nbr,
                                        k_max, g, out, st);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}
