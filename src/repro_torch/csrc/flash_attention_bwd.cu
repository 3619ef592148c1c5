// Backward of the blocked attention in flash_attention.cu, for Hopper.
//
// The forward computes, over the keys j the mask allows (every j < Skv,
// and under `causal` the top-left mask j <= i),
//   P[i, j] = softmax_j(scale * q[i] . k[j]),   o[i] = sum_j P[i, j] v[j]
// with scale = D^-0.5. Given dO = dL/do, the gradients are
//   dv[j] = sum_i P[i, j] dO[i]
//   dP[i, j] = dO[i] . v[j],   delta[i] = dO[i] . o[i]
//   dS[i, j] = P[i, j] (dP[i, j] - delta[i])
//   dq[i] = scale sum_j dS[i, j] k[j],   dk[j] = scale sum_i dS[i, j] q[i].
//
// The JAX package differentiates its jnp attention (online_attention, a
// scan over KV chunks) and has no Pallas backward: this is the port's own
// kernel, the gradient of its forward kernel. Three launches, each a
// 256-thread block per tile of 64 rows (q rows or keys), every tile
// staged in shared memory in fp32 by cp.async (simt.cuh; bf16 converted
// on the way) and every product a plain fp32 FMA on the SIMT cores:
//
//   1. stats, one block per (bh, q tile): the row log-sum-exp, walking
//      the key tiles with the forward's online max and sum, stored in
//      the log2 domain as lse2[i] = m2 + log2(l) with the scores taken as
//      x = (q . k) * scale log2(e), the forward's own definition; and
//      delta[i] = dO[i] . o[i] in fp32 from the saved output. The forward
//      kernel is unchanged, so it recomputes the statistics it does not
//      write.
//   2. dK and dV, one block per (bh, key tile): K and V stay in shared
//      memory, and the block walks the q tiles (under `causal` only those
//      at or after the key tile), recomputing P = exp2(x - lse2) and dP
//      from q, dO, lse2 and delta; dV += P^T dO and dK += dS^T q in
//      registers.
//   3. dQ, one block per (bh, q tile): q and dO stay, the block walks the
//      key tiles (under `causal` only those up to the tile's last row);
//      dQ += dS K.
//
// Every sum runs in a fixed order in one thread (or a fixed shuffle
// tree), with no atomics, so the gradients are deterministic: a resumed
// training run can be bit for bit an uninterrupted one. Masked pairs
// (a key past Skv, a row past Sq, a key after the row under `causal`)
// get P = 0 and add nothing, so a ragged Skv needs no padding; padded
// rows and columns are staged as zeros.
//
// Thread tid = 16 ty + tx of a block owns, in the (64 x 64) score tiles,
// rows 4 ty .. 4 ty + 3 and keys tx + 16 j (j < 4), read 16 bytes at a
// time along D from row-major tiles whose rows are padded by 4 words (the
// 8 keys a quarter-warp reads sit in 8 bank groups). For the
// accumulations it owns 4 consecutive keys (dK, dV) or rows (dQ) and the
// columns 4 tx + 64 c .. + 3, reading P and dS back from shared memory
// 16 bytes at a time. D is padded to 64, 128 or 192 and Dv to 64 or 128
// at compile time. At D = 192, Dv = 128 (MLA's prefill) the dK/dV block
// takes K, V, q, dO and the P and dS tiles, 203 KB of shared memory in
// fp32, under the 227 KB opt-in limit, which each entry checks against
// the device's own; at D = Dv = 128, 170 KB; at 64, 105 KB.
//
// Bound on this card: operations, 2 (3 D + 2 Dv) flops a (row, key)
// pair the mask allows for the gradients (kernels/_cost.py,
// attention_bwd_work), at the fp32 SIMT rate; the statistics pass adds
// 2 D a pair more, which the bound does not count.

#include "common.cuh"
#include "simt.cuh"

namespace repro {
namespace {

constexpr float kNegInf = -1e30f;         // the empty max (NEG_INF)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || is_nan(b)) ? b : a;
}

namespace bwd {

using namespace simt;

constexpr int kB = 64;              // rows of a q tile, keys of a key tile
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kB / kTY;     // 4 consecutive rows (or keys) a thread
constexpr int kKeys = kB / kTX;     // 4 keys a thread, tx + 16 j
constexpr int kSPitch = kB + 4;     // a (64 x 64) P or dS tile

template <int DP, int DVP>
struct Tile {
  static constexpr int kQPitch = DP + 4;     // q and K rows
  static constexpr int kVPitch = DVP + 4;    // dO and V rows
  static constexpr int kQ = kB * kQPitch;
  static constexpr int kV = kB * kVPitch;
  static constexpr int kS = kB * kSPitch;
  static constexpr size_t kSmemStats = sizeof(float) * 2 * kQ;
  // K, V, q, dO, P, dS, lse2, delta
  static constexpr size_t kSmemKV =
      sizeof(float) * (2 * kQ + 2 * kV + 2 * kS + 2 * kB);
  // q, dO, K, V, dS^T, lse2, delta
  static constexpr size_t kSmemQ =
      sizeof(float) * (2 * kQ + 2 * kV + kS + 2 * kB);
};

struct Shape {
  int bh, sq, skv, d, dv, causal, vec;
  float scale;         // D^-0.5
  float scale_log2;    // D^-0.5 log2(e)
};

// acc[i][j] = a[4 ty + i] . b[tx + 16 j] over the W (padded) columns of
// two row-major fp32 tiles of row pitch P
template <int W, int P>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx,
                                         float (&acc)[kRows][kKeys]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kKeys; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
  for (int c = 0; c < W; c += 4) {
    float4 x[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (4 * ty + i) * P + c);
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float4 y =
          *reinterpret_cast<const float4*>(b + (tx + kTX * j) * P + c);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        acc[i][j] = fmaf(x[i].x, y.x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y.y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y.z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y.w, acc[i][j]);
      }
    }
  }
}

// whether the pair (row, key) (global positions) takes part
__device__ __forceinline__ bool allowed(const Shape& s, int row, int key) {
  return row < s.sq && key < s.skv && !(s.causal && key > row);
}

// acc[i][4 c + e] += w[i] * src[4 tx + 64 c + e] for the N (padded)
// columns of one fp32 row
template <int N>
__device__ __forceinline__ void axpy_row(float (&acc)[kRows][N / 16],
                                         const float4 w, const float* src,
                                         int tx) {
  const float wr[kRows] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int c = 0; c < N / 64; ++c) {
    const float4 r = *reinterpret_cast<const float4*>(src + 4 * tx + 64 * c);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      acc[i][4 * c] = fmaf(wr[i], r.x, acc[i][4 * c]);
      acc[i][4 * c + 1] = fmaf(wr[i], r.y, acc[i][4 * c + 1]);
      acc[i][4 * c + 2] = fmaf(wr[i], r.z, acc[i][4 * c + 2]);
      acc[i][4 * c + 3] = fmaf(wr[i], r.w, acc[i][4 * c + 3]);
    }
  }
}

// rows first_row + 4 ty + i of a (rows, cols) output, times `scale`
template <int N, typename T>
__device__ __forceinline__ void store_rows(T* out, size_t first_row,
                                           int n_rows, int cols,
                                           const float (&acc)[kRows][N / 16],
                                           float scale, int ty, int tx,
                                           bool vec) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = 4 * ty + i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < N / 64; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col >= cols) continue;
      const float v[4] = {acc[i][4 * c] * scale, acc[i][4 * c + 1] * scale,
                          acc[i][4 * c + 2] * scale,
                          acc[i][4 * c + 3] * scale};
      store4(out + (first_row + r) * cols + col, v,
             cols - col, vec);
    }
  }
}

// 1. lse2 and delta of one (bh, q tile)
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ lse2, float* __restrict__ delta, Shape s) {
  constexpr int P = DP + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kB * P;

  const int q_tiles = (s.sq + kB - 1) / kB;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x / s.bh);
  const int bh = static_cast<int>(blockIdx.x % s.bh);
  const int q0 = qt * kB;
  const int rows = min(kB, s.sq - q0);
  const int kv_end = s.causal ? min(s.skv, q0 + rows) : s.skv;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const bool vec = s.vec != 0;
  const size_t row0 = static_cast<size_t>(bh) * s.sq + q0;

  stage_tile<kB, DP, kThreads>(qs, P, q + row0 * s.d, s.d, rows, s.d, vec,
                               tid);

  // delta: four neighbouring lanes a row, each a strided share of Dv
  {
    const int r = tid / 4, part = tid % 4;
    float acc = 0.0f;
    if (r < rows) {
      const T* a = o + (row0 + r) * s.dv;
      const T* b = dout + (row0 + r) * s.dv;
      for (int c = part; c < s.dv; c += 4)
        acc = fmaf(to_float(a[c]), to_float(b[c]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (r < rows && part == 0) delta[row0 + r] = acc;
  }

  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  const T* kb = k + static_cast<size_t>(bh) * s.skv * s.d;
  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    __syncthreads();    // every thread is done with the previous K tile
    stage_tile<kB, DP, kThreads>(ks, P, kb + static_cast<size_t>(k0) * s.d,
                                 s.d, s.skv - k0, s.d, vec, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float sc[kRows][kKeys];
    tile_dot<DP, P>(qs, ks, ty, tx, sc);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = k0 + tx + kTX * j;
        const float x = allowed(s, row, key) ? sc[i][j] * s.scale_log2
                                             : -pos_inf();
        sc[i][j] = x;
        mx = max_nan(mx, x);
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1)
        mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sum += exp2f(sc[i][j] - mx);
      l[i] = fmaf(l[i], corr, sum);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int off = 1; off < kTX; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int r = 4 * ty + i;
    if (tx == 0 && r < rows) lse2[row0 + r] = m[i] + log2f(l[i]);
  }
}

// P and dS of the pairs (4 ty + i, tx + 16 j) of a (q tile, key tile)
// from the scores, dP and the rows' lse2 and delta (in shared memory)
__device__ __forceinline__ void probabilities(
    const Shape& s, int q0, int k0, int ty, int tx,
    float (&sc)[kRows][kKeys], float (&dp)[kRows][kKeys],
    const float* ls, const float* ds) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = 4 * ty + i;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = allowed(s, q0 + r, k0 + tx + kTX * j)
                          ? exp2f(fmaf(sc[i][j], s.scale_log2, -ls[r]))
                          : 0.0f;
      sc[i][j] = p;
      dp[i][j] = p * (dp[i][j] - ds[r]);
    }
  }
}

// 2. dK and dV of one (bh, key tile)
template <typename T, int DP, int DVP>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse2, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, Shape s) {
  using L = Tile<DP, DVP>;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + L::kQ;
  float* qs = vs + L::kV;
  float* dos = qs + L::kQ;
  float* ps = dos + L::kV;      // P, (row, key)
  float* dss = ps + L::kS;      // dS, (row, key)
  float* ls = dss + L::kS;
  float* ds = ls + kB;

  // under `causal` the first key tiles see the most q tiles: issue them
  // first
  const int kt = static_cast<int>(blockIdx.x / s.bh);
  const int bh = static_cast<int>(blockIdx.x % s.bh);
  const int k0 = kt * kB;
  const int keys = min(kB, s.skv - k0);
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const bool vec = s.vec != 0;
  const size_t key0 = static_cast<size_t>(bh) * s.skv + k0;

  stage_tile<kB, DP, kThreads>(ks, L::kQPitch, k + key0 * s.d, s.d, keys,
                               s.d, vec, tid);
  stage_tile<kB, DVP, kThreads>(vs, L::kVPitch, v + key0 * s.dv, s.dv, keys,
                                s.dv, vec, tid);
  cp_async_commit();

  float ak[kRows][DP / 16], av[kRows][DVP / 16];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) ak[i][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < DVP / 16; ++c) av[i][c] = 0.0f;
  }

  const int q_tiles = (s.sq + kB - 1) / kB;
  for (int t = s.causal ? k0 / kB : 0; t < q_tiles; ++t) {
    const int q0 = t * kB;
    const int rows = min(kB, s.sq - q0);
    const size_t row0 = static_cast<size_t>(bh) * s.sq + q0;
    __syncthreads();    // every thread is done with the previous q tile
    stage_tile<kB, DP, kThreads>(qs, L::kQPitch, q + row0 * s.d, s.d, rows,
                                 s.d, vec, tid);
    stage_tile<kB, DVP, kThreads>(dos, L::kVPitch, dout + row0 * s.dv, s.dv,
                                  rows, s.dv, vec, tid);
    cp_async_commit();
    if (tid < kB) {
      ls[tid] = tid < rows ? lse2[row0 + tid] : 0.0f;
      ds[tid] = tid < rows ? delta[row0 + tid] : 0.0f;
    }
    cp_async_wait<0>();
    __syncthreads();

    float sc[kRows][kKeys], dp[kRows][kKeys];
    tile_dot<DP, L::kQPitch>(qs, ks, ty, tx, sc);
    tile_dot<DVP, L::kVPitch>(dos, vs, ty, tx, dp);
    probabilities(s, q0, k0, ty, tx, sc, dp, ls, ds);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int at = (4 * ty + i) * kSPitch + tx + kTX * j;
        ps[at] = sc[i][j];
        dss[at] = dp[i][j];
      }
    __syncthreads();

    // keys 4 ty .. 4 ty + 3: dV += P^T dO, dK += dS^T q, row by row
#pragma unroll 4
    for (int r = 0; r < kB; ++r) {
      const float4 p =
          *reinterpret_cast<const float4*>(ps + r * kSPitch + 4 * ty);
      const float4 g =
          *reinterpret_cast<const float4*>(dss + r * kSPitch + 4 * ty);
      axpy_row<DVP>(av, p, dos + r * L::kVPitch, tx);
      axpy_row<DP>(ak, g, qs + r * L::kQPitch, tx);
    }
  }
  cp_async_wait<0>();    // K and V, where no q tile was walked
  store_rows<DP>(dk, key0, keys, s.d, ak, s.scale, ty, tx, vec);
  store_rows<DVP>(dv, key0, keys, s.dv, av, 1.0f, ty, tx, vec);
}

// 3. dQ of one (bh, q tile)
template <typename T, int DP, int DVP>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse2, const float* __restrict__ delta,
          T* __restrict__ dq, Shape s) {
  using L = Tile<DP, DVP>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + L::kQ;
  float* ks = dos + L::kV;
  float* vs = ks + L::kQ;
  float* dst = vs + L::kV;      // dS^T, (key, row)
  float* ls = dst + L::kS;
  float* ds = ls + kB;

  const int q_tiles = (s.sq + kB - 1) / kB;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x / s.bh);
  const int bh = static_cast<int>(blockIdx.x % s.bh);
  const int q0 = qt * kB;
  const int rows = min(kB, s.sq - q0);
  const int kv_end = s.causal ? min(s.skv, q0 + rows) : s.skv;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const bool vec = s.vec != 0;
  const size_t row0 = static_cast<size_t>(bh) * s.sq + q0;

  stage_tile<kB, DP, kThreads>(qs, L::kQPitch, q + row0 * s.d, s.d, rows,
                               s.d, vec, tid);
  stage_tile<kB, DVP, kThreads>(dos, L::kVPitch, dout + row0 * s.dv, s.dv,
                                rows, s.dv, vec, tid);
  cp_async_commit();
  if (tid < kB) {
    ls[tid] = tid < rows ? lse2[row0 + tid] : 0.0f;
    ds[tid] = tid < rows ? delta[row0 + tid] : 0.0f;
  }

  float aq[kRows][DP / 16];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) aq[i][c] = 0.0f;

  const size_t kbase = static_cast<size_t>(bh) * s.skv;
  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    __syncthreads();    // every thread is done with the previous key tile
    stage_tile<kB, DP, kThreads>(ks, L::kQPitch, k + (kbase + k0) * s.d,
                                 s.d, s.skv - k0, s.d, vec, tid);
    stage_tile<kB, DVP, kThreads>(vs, L::kVPitch, v + (kbase + k0) * s.dv,
                                  s.dv, s.skv - k0, s.dv, vec, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float sc[kRows][kKeys], dp[kRows][kKeys];
    tile_dot<DP, L::kQPitch>(qs, ks, ty, tx, sc);
    tile_dot<DVP, L::kVPitch>(dos, vs, ty, tx, dp);
    probabilities(s, q0, k0, ty, tx, sc, dp, ls, ds);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        dst[(tx + kTX * j) * kSPitch + 4 * ty + i] = dp[i][j];
    __syncthreads();

    // rows 4 ty .. 4 ty + 3: dQ += dS K, key by key
#pragma unroll 4
    for (int key = 0; key < kB; ++key) {
      const float4 g =
          *reinterpret_cast<const float4*>(dst + key * kSPitch + 4 * ty);
      axpy_row<DP>(aq, g, ks + key * L::kQPitch, tx);
    }
  }
  store_rows<DP>(dq, row0, rows, s.d, aq, s.scale, ty, tx, vec);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem, long long blocks) {
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

inline int padded_d(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 192; }
inline int padded_dv(int dv) { return dv <= 64 ? 64 : 128; }

long long q_blocks(const Shape& s) {
  return static_cast<long long>(s.bh) * ((s.sq + kB - 1) / kB);
}

long long key_blocks(const Shape& s) {
  return static_cast<long long>(s.bh) * ((s.skv + kB - 1) / kB);
}

template <typename T, int DP>
cudaError_t launch_stats(const void* q, const void* k, const void* o,
                         const void* dout, void* lse2, void* delta,
                         const Shape& s, cudaStream_t st) {
  auto kernel = stats_kernel<T, DP>;
  const size_t smem = Tile<DP, 64>::kSmemStats;
  cudaError_t err = prepare(kernel, smem, q_blocks(s));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(q_blocks(s)), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(lse2), static_cast<float*>(delta), s);
  return cudaGetLastError();
}

template <typename T, int DP, int DVP>
cudaError_t launch_grads(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse2,
                         const void* delta, void* dq, void* dk, void* dv,
                         const Shape& s, cudaStream_t st) {
  using L = Tile<DP, DVP>;
  cudaError_t err;
  if (dq == nullptr) {
    auto kernel = dkdv_kernel<T, DP, DVP>;
    err = prepare(kernel, L::kSmemKV, key_blocks(s));
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(key_blocks(s)), kThreads, L::kSmemKV,
             st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<const T*>(dout),
                   static_cast<const float*>(lse2),
                   static_cast<const float*>(delta), static_cast<T*>(dk),
                   static_cast<T*>(dv), s);
  } else {
    auto kernel = dq_kernel<T, DP, DVP>;
    err = prepare(kernel, L::kSmemQ, q_blocks(s));
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(q_blocks(s)), kThreads, L::kSmemQ, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse2), static_cast<const float*>(delta),
        static_cast<T*>(dq), s);
  }
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t grads_for(int dvp, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse2, const void* delta,
                      void* dq, void* dk, void* dv, const Shape& s,
                      cudaStream_t st) {
  return dvp == 64 ? launch_grads<T, DP, 64>(q, k, v, dout, lse2, delta, dq,
                                             dk, dv, s, st)
                   : launch_grads<T, DP, 128>(q, k, v, dout, lse2, delta, dq,
                                              dk, dv, s, st);
}

template <typename T>
cudaError_t grads_typed(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse2, const void* delta,
                        void* dq, void* dk, void* dv, const Shape& s,
                        cudaStream_t st) {
  const int dvp = padded_dv(s.dv);
  switch (padded_d(s.d)) {
    case 64:
      return grads_for<T, 64>(dvp, q, k, v, dout, lse2, delta, dq, dk, dv, s,
                              st);
    case 128:
      return grads_for<T, 128>(dvp, q, k, v, dout, lse2, delta, dq, dk, dv,
                               s, st);
    default:
      return grads_for<T, 192>(dvp, q, k, v, dout, lse2, delta, dq, dk, dv,
                               s, st);
  }
}

template <typename T>
cudaError_t stats_typed(const void* q, const void* k, const void* o,
                        const void* dout, void* lse2, void* delta,
                        const Shape& s, cudaStream_t st) {
  switch (padded_d(s.d)) {
    case 64:
      return launch_stats<T, 64>(q, k, o, dout, lse2, delta, s, st);
    case 128:
      return launch_stats<T, 128>(q, k, o, dout, lse2, delta, s, st);
    default:
      return launch_stats<T, 192>(q, k, o, dout, lse2, delta, s, st);
  }
}

// The shape checks shared by the three entries, the device's opt-in
// shared-memory limit against the largest block (dK/dV's), and the
// launch parameters; 0 or a CUDA error code.
int shape_for(const void* const* ptrs, int n_ptrs, int dtype, int bh, int sq,
              int skv, int d, int dv, int causal, float scale, Shape* s) {
  if (bh < 1 || sq < 1 || skv < 1 || d < 1 || dv < 1 || d > 192 ||
      dv > 128 || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dp = padded_d(d), dvp = padded_dv(dv);
  const size_t need =
      sizeof(float) * (2 * kB * (dp + 4) + 2 * kB * (dvp + 4) +
                       2 * kB * kSPitch + 2 * kB);
  if (need > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  bool aligned = d % 4 == 0 && dv % 4 == 0;
  for (int i = 0; i < n_ptrs; ++i)
    aligned = aligned && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  *s = Shape{bh, sq, skv, d, dv, causal ? 1 : 0, aligned ? 1 : 0, scale,
             scale * kLog2e};
  return 0;
}

}  // namespace bwd
}  // namespace
}  // namespace repro

// 1. The row statistics: q (bh, sq, d), k (bh, skv, d), o and dout (bh,
// sq, dv), contiguous in the storage type `dtype` (fp32 or bf16), d at
// most 192 and dv at most 128 -> lse2 and delta (bh, sq) fp32 (lse2 in
// the log2 domain of the scores times scale log2(e)). Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for what it does not take.
extern "C" int repro_flash_attention_bwd_stats(
    const void* q, const void* k, const void* o, const void* dout, int dtype,
    int bh, int sq, int skv, int d, int dv, int causal, float scale,
    void* lse2, void* delta, void* stream) {
  using namespace repro;
  using namespace repro::bwd;
  const void* ptrs[] = {q, k, o, dout};
  Shape s;
  const int bad = shape_for(ptrs, 4, dtype, bh, sq, skv, d, dv, causal,
                            scale, &s);
  if (bad != 0) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kF32
          ? stats_typed<float>(q, k, o, dout, lse2, delta, s, st)
          : stats_typed<__nv_bfloat16>(q, k, o, dout, lse2, delta, s, st));
}

// 2. and 3. The gradients from the statistics: q (bh, sq, d), k (bh,
// skv, d), v (bh, skv, dv), dout (bh, sq, dv), lse2 and delta (bh, sq)
// fp32, all contiguous. With dq null, launches dK/dV into dk (bh, skv,
// d) and dv_out (bh, skv, dv); with dq given, launches dQ into dq (bh,
// sq, d); outputs in `dtype`. Returns as the statistics' entry.
extern "C" int repro_flash_attention_bwd_grads(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* delta, int dtype, int bh, int sq, int skv,
    int d, int dv, int causal, float scale, void* dq, void* dk, void* dv_out,
    void* stream) {
  using namespace repro;
  using namespace repro::bwd;
  const void* ptrs[] = {q, k, v, dout, dq != nullptr ? dq : dk,
                        dq != nullptr ? dq : dv_out};
  Shape s;
  const int bad = shape_for(ptrs, 6, dtype, bh, sq, skv, d, dv, causal,
                            scale, &s);
  if (bad != 0) return bad;
  if (dq == nullptr && (dk == nullptr || dv_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kF32
          ? grads_typed<float>(q, k, v, dout, lse2, delta, dq, dk, dv_out, s,
                               st)
          : grads_typed<__nv_bfloat16>(q, k, v, dout, lse2, delta, dq, dk,
                                       dv_out, s, st));
}
