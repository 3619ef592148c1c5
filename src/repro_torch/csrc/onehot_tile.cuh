// Shared pieces of the port's one-hot-schedule kernels
// (fused_gather_onehot.cu, segment_aggregate_onehot.cu): the bucketing
// that turns a raw id stream into a per-destination list in stream
// order, read once and not once per node tile.
//
// The Pallas one-hot kernels sweep the whole stream once per tile of
// `nb` destinations, in chunks of `eb` edges. On this card that schedule
// is a serial chain of ceil(E / eb) barrier-bound steps in every block.
// Here the tiles set the buckets instead: the stream is cut into
// C = ceil(E / eb) chunks, and the valid edges are sorted stably by
// destination d = tile * nb + row as a two-digit radix sort, low digit
// first, in five launches:
//
//   1. count:    one warp per chunk counts its edges per row in tile,
//                keeping each edge's rank among the chunk's edges of its
//                row, and writes its column of (row, chunk) cells;
//   2. scan:     the (row, chunk) cells, row-major, give each cell its
//                place in list A;
//   3. scatter:  one thread per edge writes it to A at its cell's place
//                plus its rank (A is sorted by row, stream order kept),
//                and counts A's entries per (tile, chunk of A) and per
//                destination;
//   4. scan:     the (tile, chunk) cells, tile-major, then the degrees:
//                each cell's place in list B and each destination's
//                range in B;
//   5. scatter:  one warp per chunk of A writes its entries to B by
//                tile, A's order kept.
//
// B is then sorted by (tile, row, stream position): each destination's
// edges are contiguous and in stream order, as in the CSR kernels' perm,
// and the fold (in each .cu) runs one warp per destination over them.
// A warp walks its chunk in rounds of 32 entries: __match_any_sync
// groups a round's lanes by bucket, the group's lowest lane reserves
// its places on a per-warp cursor of the bucket (in shared memory up to
// kSharedBuckets buckets, else on the chunk's own cell in global memory
// with an integer atomicAdd), and each lane takes its rank in the group.
// Only this warp touches its chunk's cells, and its rounds run in order,
// so the places follow stream order. No block runs a chain longer than
// ceil(eb / 32) rounds; the scans are one pass of 2048-entry tiles whose
// sums each block spreads to the later tiles with integer atomics (past
// 256 tiles, the last block to finish scans them). Every launch is a
// programmatic dependent launch (Hopper): it starts while its
// predecessor drains and waits for it before it touches memory. No
// float atomics anywhere, and nothing here allocates: the caller passes
// one int32 scratch buffer sized by `onehot_layout` (kernels/_onehot.py
// computes the same layout).
#pragma once

#include "common.cuh"

namespace repro {

// entries per tile of the scans; kernels/_onehot.py SCAN_TILE
constexpr int kScanTile = 2048;
constexpr int kScanItems = kScanTile / kThreadsPerBlock;  // per thread

// The scratch buffer, in int32 units, in this order: two scan tickets,
// scan 1 (nb * C row cells, then one cell for the total), scan 2
// (T * C tile cells, then S + 1 degree cells), the two scans' tile
// sums, the pass-1 ranks (E), list A (key, id, and scale when scaled)
// and list B (id, and scale when scaled). Pass 1's count clears the
// tickets, the total cell and scan 2, and writes every row cell.
struct OnehotLayout {
  int nb, eb;        // destinations per tile, edges per chunk (clamped)
  int chunks;        // C = ceil(E / eb)
  int tiles;         // T = ceil(S / nb)
  long long n1, n2;  // entries of the two scans
  long long nblk1, nblk2;
  long long tickets, cnt1, cnt2, part1, part2;  // offsets
  long long rank;    // pass 1: each entry's rank among its chunk's row
  long long a_key, a_id, a_scale, b_id, b_scale;
  long long total;
};

// nb = min(node_block, S) and eb = min(edge_block, E), as the Pallas
// kernels clamp them. Returns false for a size below 1 or a layout past
// int32 indexing.
inline bool onehot_layout(long long num_edges, long long num_segments,
                          long long node_block, long long edge_block,
                          bool scaled, OnehotLayout* l) {
  if (num_edges < 1 || num_segments < 1 || node_block < 1 || edge_block < 1)
    return false;
  const long long nb = node_block < num_segments ? node_block : num_segments;
  const long long eb = edge_block < num_edges ? edge_block : num_edges;
  const long long c = (num_edges + eb - 1) / eb;
  const long long t = (num_segments + nb - 1) / nb;
  l->nb = static_cast<int>(nb);
  l->eb = static_cast<int>(eb);
  l->chunks = static_cast<int>(c);
  l->tiles = static_cast<int>(t);
  l->n1 = nb * c + 1;
  l->n2 = t * c + num_segments + 1;
  l->nblk1 = (l->n1 + kScanTile - 1) / kScanTile;
  l->nblk2 = (l->n2 + kScanTile - 1) / kScanTile;
  l->tickets = 0;
  l->cnt1 = 2;
  l->cnt2 = l->cnt1 + l->n1;
  l->part1 = l->cnt2 + l->n2;
  l->part2 = l->part1 + l->nblk1;
  l->rank = l->part2 + l->nblk2;
  l->a_key = l->rank + num_edges;
  l->a_id = l->a_key + num_edges;
  l->a_scale = l->a_id + num_edges;
  l->b_id = l->a_scale + (scaled ? num_edges : 0);
  l->b_scale = l->b_id + num_edges;
  l->total = l->b_scale + (scaled ? num_edges : 0);
  return l->total <= 2147483647LL;
}

// where the fold finds destination d's edges in list B
struct OnehotLists {
  const int32_t* id;    // B: source ids (gather) or row ids (pooling)
  const float* scale;   // B: scales, or nullptr
  const int32_t* scan;  // scan 2's entries, locally scanned
  const int32_t* part;  // scan 2's scanned tile sums
  int deg_at;           // index of the first degree cell in scan 2
};

// the exclusive prefix of scan entry i
__device__ __forceinline__ int scanned(const int32_t* local,
                                       const int32_t* part, int i) {
  return local[i] + part[i / kScanTile];
}

// [begin, end) of destination d in list B: the degrees' exclusive scan,
// less the tile cells' total before them
__device__ __forceinline__ int2 onehot_range(const OnehotLists& l, int d) {
  const int v0 = scanned(l.scan, l.part, l.deg_at);
  return make_int2(scanned(l.scan, l.part, l.deg_at + d) - v0,
                   scanned(l.scan, l.part, l.deg_at + d + 1) - v0);
}

namespace onehot {
namespace {

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Programmatic dependent launch (Hopper): each launch after the first
// starts while its predecessor drains; `wait_for_predecessor` blocks
// until the predecessor grid has finished and its writes are visible
// (and so, transitively, every earlier launch of the call), and
// `release_dependents` lets the next launch be scheduled.
__device__ __forceinline__ void wait_for_predecessor() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Destination d and id of stream entry e, or false where either id is
// out of range: `src` (gather) must lie in [0, n_src); without `src`
// (pooling) the id is the row e itself.
__device__ __forceinline__ bool stream_entry(const int32_t* __restrict__ key,
                                             const int32_t* __restrict__ src,
                                             int n_src, int num_segments,
                                             int e, int& d, int& id) {
  d = key[e];
  id = src != nullptr ? src[e] : e;  // both loads in flight at once
  return d >= 0 && d < num_segments &&
         (src == nullptr || (id >= 0 && id < n_src));
}

// rounds of 32 entries whose loads one warp issues together
constexpr int kRoundsInFlight = 8;
// buckets up to which a warp keeps its cursors in shared memory
constexpr int kSharedBuckets = 1024;

// Warp-level place reservation for one round: every lane with `ok` has
// bucket `b`; the lowest lane of each bucket's group moves the bucket's
// cursor on by the group's size (`shared`: cur[b] in this warp's shared
// cursors; else an integer atomicAdd on cur[b] in global memory), and
// each lane gets the cursor's value before it plus its rank in the
// group. Rounds of one warp on one cursor array see each other's moves.
template <bool kShared>
__device__ __forceinline__ int reserve(bool ok, int b, int32_t* cur) {
  const unsigned active = __ballot_sync(0xffffffffu, ok);
  int at = 0;
  if (ok) {
    const unsigned group = __match_any_sync(active, b);
    const int leader = __ffs(group) - 1;
    if ((threadIdx.x & 31) == leader) {
      if constexpr (kShared) {
        at = cur[b];
        cur[b] = at + __popc(group);
      } else {
        at = atomicAdd(cur + b, __popc(group));
      }
    }
    at = __shfl_sync(group, at, leader) + __popc(group & lanes_below());
  }
  __syncwarp();  // the next round reads the cursors this one moved
  return at;
}

// Pass 1's count: one warp per chunk of the stream, in rounds of 32
// entries. Each valid entry keeps its rank among the chunk's entries of
// its row (stream order), and the warp writes its chunk's column of
// (row, chunk) cells, zeros included. The grid also clears the scan
// tickets, scan 1's total cell, scan 2 and the scans' tile sums, which
// later launches count into.
template <bool kShared>
__global__ void __launch_bounds__(kThreadsPerBlock)
count_rows(const int32_t* __restrict__ key, const int32_t* __restrict__ src,
           int n_src, int num_edges, int num_segments, OnehotLayout l,
           int32_t* __restrict__ scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + warp;
  release_dependents();
  wait_for_predecessor();  // the scratch may still be read by earlier work
  const long long t0 = blockIdx.x * static_cast<long long>(kThreadsPerBlock) +
                       threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) *
                           kThreadsPerBlock;
  for (long long i = t0; i < l.n2; i += stride) scratch[l.cnt2 + i] = 0;
  for (long long i = t0; i < l.nblk1 + l.nblk2; i += stride)
    scratch[l.part1 + i] = 0;
  if (t0 < 2) scratch[l.tickets + t0] = 0;
  if (t0 == 2) scratch[l.cnt1 + l.n1 - 1] = 0;
  if (c >= l.chunks) return;

  int32_t* column = scratch + l.cnt1 + c;  // cell (row, c) at row * C
  int32_t* rank = scratch + l.rank;
  int32_t* cur = column;  // global cursors: row r at column[r * C]
  int step = l.chunks;
  if constexpr (kShared) {
    __shared__ int32_t cursors[kWarpsPerBlock][kSharedBuckets];
    cur = cursors[warp];
    step = 1;
  }
  for (int r = lane; r < l.nb; r += 32) cur[r * step] = 0;
  __syncwarp();
  const int e1 = static_cast<int>(
      min(static_cast<long long>(num_edges), (c + 1LL) * l.eb));
  for (int g0 = c * l.eb; g0 < e1; g0 += 32 * kRoundsInFlight) {
    int d[kRoundsInFlight], id[kRoundsInFlight];
    bool ok[kRoundsInFlight];
#pragma unroll
    for (int r = 0; r < kRoundsInFlight; ++r) {
      const int e = g0 + 32 * r + lane;
      ok[r] = e < e1 &&
              stream_entry(key, src, n_src, num_segments, e, d[r], id[r]);
    }
#pragma unroll
    for (int r = 0; r < kRoundsInFlight; ++r) {
      if (g0 + 32 * r >= e1) break;  // warp-uniform
      const int row = ok[r] ? d[r] % l.nb : 0;
      int at;
      if constexpr (kShared)
        at = reserve<true>(ok[r], row, cur);
      else
        at = reserve<false>(ok[r], row * step, cur);
      if (ok[r]) rank[g0 + 32 * r + lane] = at;
    }
  }
  if constexpr (kShared) {
    for (int r = lane; r < l.nb; r += 32)
      column[static_cast<long long>(r) * l.chunks] = cur[r];
  }
}

// Block-wide exclusive scan of one value per thread (every thread of
// the block calls it): `excl` gets the sum over the threads before this
// one; returns the block's total. `warp_sum` is kWarpsPerBlock shared
// ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sum,
                                                    int& excl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < kWarpsPerBlock; ++w) {
    before += w < warp ? warp_sum[w] : 0;
    total += warp_sum[w];
  }
  excl = before + incl - v;
  __syncthreads();  // warp_sum may be rewritten
  return total;
}

// scans of at most this many tiles spread the tile sums by atomics
constexpr int kFanOutTiles = 256;

// Exclusive scan of `n` counts in place, tile by tile: each block scans
// its kScanTile entries locally; then `part` gets the tile sums'
// exclusive scan. With kFanOut (at most kFanOutTiles tiles, `part`
// zeroed beforehand) each block adds its sum to every later tile's
// entry with integer atomics, which no one waits on; otherwise each
// block writes its sum and the last block to finish scans `part` in
// place. Entry i's place is then local[i] + part[i / kScanTile]
// (`scanned`).
template <bool kFanOut>
__global__ void __launch_bounds__(kThreadsPerBlock)
scan_tiles(int32_t* __restrict__ cnt, long long n, int32_t* part,
           unsigned* ticket) {
  __shared__ int32_t tile[kScanTile];
  __shared__ int32_t warp_sum[kWarpsPerBlock];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kScanTile;
  release_dependents();
  wait_for_predecessor();
  for (int j = 0; j < kScanItems; ++j) {
    const int i = j * kThreadsPerBlock + tid;
    tile[i] = base + i < n ? cnt[base + i] : 0;
  }
  __syncthreads();
  int v[kScanItems];
  int sum = 0;
  for (int j = 0; j < kScanItems; ++j) {
    v[j] = tile[tid * kScanItems + j];
    sum += v[j];
  }
  int run = 0;
  const int total = block_exclusive_scan(sum, warp_sum, run);
  for (int j = 0; j < kScanItems; ++j) {
    tile[tid * kScanItems + j] = run;
    run += v[j];
  }
  __syncthreads();
  for (int j = 0; j < kScanItems; ++j) {
    const int i = j * kThreadsPerBlock + tid;
    if (base + i < n) cnt[base + i] = tile[i];
  }
  if constexpr (kFanOut) {
    for (unsigned j = blockIdx.x + 1 + tid; j < gridDim.x;
         j += kThreadsPerBlock)
      atomicAdd(part + j, total);
    return;
  }
  if (tid == 0) {
    part[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  volatile int32_t* vp = part;
  int carry = 0;
  for (unsigned r = 0; r < gridDim.x; r += kThreadsPerBlock) {
    const unsigned b = r + tid;
    const int s = b < gridDim.x ? vp[b] : 0;
    int excl = 0;
    const int round = block_exclusive_scan(s, warp_sum, excl);
    if (b < gridDim.x) vp[b] = carry + excl;
    carry += round;
  }
}

// Pass 1's scatter, one thread per stream entry: each valid entry goes
// to its cell's place in list A plus its rank, so A is sorted by row
// with stream order kept; A's entries are counted per (tile, chunk of
// A) and per destination for pass 2.
__global__ void __launch_bounds__(kThreadsPerBlock)
scatter_rows(const int32_t* __restrict__ key, const int32_t* __restrict__ src,
             int n_src, const float* __restrict__ scale, int num_edges,
             int num_segments, OnehotLayout l, int32_t* __restrict__ scratch) {
  const int e = blockIdx.x * kThreadsPerBlock + threadIdx.x;
  int d = 0, id = 0;
  const bool ok = e < num_edges &&
                  stream_entry(key, src, n_src, num_segments, e, d, id);
  const float sc = ok && scale != nullptr ? scale[e] : 1.0f;
  release_dependents();
  wait_for_predecessor();
  const unsigned active = __ballot_sync(0xffffffffu, ok);
  if (!ok) return;
  const int cell = (d % l.nb) * l.chunks + e / l.eb;
  const int at = scanned(scratch + l.cnt1, scratch + l.part1, cell) +
                 scratch[l.rank + e];
  scratch[l.a_key + at] = d;
  scratch[l.a_id + at] = id;
  if (scale != nullptr)
    reinterpret_cast<float*>(scratch + l.a_scale)[at] = sc;
  int32_t* cnt2 = scratch + l.cnt2;
  const int cell2 = (d / l.nb) * l.chunks + at / l.eb;
  const unsigned same_cell = __match_any_sync(active, cell2);
  if ((same_cell & lanes_below()) == 0)
    atomicAdd(cnt2 + cell2, __popc(same_cell));
  const int deg = l.tiles * l.chunks + d;
  const unsigned same_d = __match_any_sync(active, deg);
  if ((same_d & lanes_below()) == 0) atomicAdd(cnt2 + deg, __popc(same_d));
}

// Pass 2's scatter: one warp per chunk of list A, in rounds of 32
// entries, writes each entry to list B by tile, A's order kept. The
// cursor of tile t starts at cell (t, chunk)'s place.
template <bool kShared>
__global__ void __launch_bounds__(kThreadsPerBlock)
scatter_tiles(bool scaled, OnehotLayout l, int32_t* __restrict__ scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + warp;
  release_dependents();
  wait_for_predecessor();
  if (c >= l.chunks) return;
  // the valid edges: scan 1's total cell
  const int valid =
      scanned(scratch + l.cnt1, scratch + l.part1, static_cast<int>(l.n1 - 1));
  const int32_t* part = scratch + l.part2;
  const int32_t* a_key = scratch + l.a_key;
  const int32_t* a_id = scratch + l.a_id;
  const float* a_scale = reinterpret_cast<const float*>(scratch + l.a_scale);
  int32_t* b_id = scratch + l.b_id;
  float* b_scale = reinterpret_cast<float*>(scratch + l.b_scale);
  int32_t* column = scratch + l.cnt2 + c;  // cell (t, c) at t * C
  int32_t* cur = column;
  int step = l.chunks;
  if constexpr (kShared) {
    __shared__ int32_t cursors[kWarpsPerBlock][kSharedBuckets];
    cur = cursors[warp];
    step = 1;
    for (int t = lane; t < l.tiles; t += 32)
      cur[t] = scanned(scratch + l.cnt2, part, t * l.chunks + c);
    __syncwarp();
  }
  const int k1 = static_cast<int>(
      min(static_cast<long long>(valid), (c + 1LL) * l.eb));
  for (int g0 = c * l.eb; g0 < k1; g0 += 32 * kRoundsInFlight) {
    int tile[kRoundsInFlight], id[kRoundsInFlight];
    float sc[kRoundsInFlight];
#pragma unroll
    for (int r = 0; r < kRoundsInFlight; ++r) {
      const int k = g0 + 32 * r + lane;
      tile[r] = k < k1 ? a_key[k] / l.nb : 0;
      id[r] = k < k1 ? a_id[k] : 0;
      sc[r] = k < k1 && scaled ? a_scale[k] : 1.0f;
    }
#pragma unroll
    for (int r = 0; r < kRoundsInFlight; ++r) {
      if (g0 + 32 * r >= k1) break;  // warp-uniform
      const bool ok = g0 + 32 * r + lane < k1;
      int at;
      if constexpr (kShared) {
        at = reserve<true>(ok, tile[r], cur);
      } else {
        const int cell = tile[r] * l.chunks;
        at = reserve<false>(ok, cell, cur) + part[(cell + c) / kScanTile];
      }
      if (ok) {
        b_id[at] = id[r];
        if (scaled) b_scale[at] = sc[r];
      }
    }
  }
}

// One launch of a bucketing pass or of a fold: 256 threads a block, as
// a programmatic dependent launch of the stream's previous launch.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, cudaStream_t stream,
                   Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreadsPerBlock);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace onehot

// Runs passes 1-5 on `stream` over the key stream (destinations or
// segment ids) with, for the gather, the source stream and its optional
// scales; fills `lists` for the fold, which the caller launches with
// `onehot::launch` and which calls `onehot::wait_for_predecessor()`
// before it reads them. Returns the first launch error, or
// cudaErrorInvalidValue for a layout past int32 or a scratch buffer of
// fewer than its `total` entries.
inline cudaError_t onehot_bucket(const int32_t* key, const int32_t* src,
                                 int n_src, const float* scale,
                                 int num_edges, int num_segments,
                                 int node_block, int edge_block,
                                 int32_t* scratch, long long scratch_len,
                                 cudaStream_t stream, OnehotLists* lists) {
  OnehotLayout l;
  if (!onehot_layout(num_edges, num_segments, node_block, edge_block,
                     scale != nullptr, &l) ||
      scratch_len < l.total)
    return cudaErrorInvalidValue;
  using onehot::launch;
  const dim3 chunk_grid((l.chunks + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 edge_grid((num_edges + kThreadsPerBlock - 1) / kThreadsPerBlock);
  unsigned* tickets = reinterpret_cast<unsigned*>(scratch + l.tickets);
  const bool rows_shared = l.nb <= onehot::kSharedBuckets;
  const bool tiles_shared = l.tiles <= onehot::kSharedBuckets;
  auto scan = [&](long long blocks, int32_t* cnt, long long n,
                  int32_t* part, unsigned* ticket) {
    return blocks <= onehot::kFanOutTiles
               ? launch(onehot::scan_tiles<true>, dim3(blocks), stream, cnt,
                        n, part, ticket)
               : launch(onehot::scan_tiles<false>, dim3(blocks), stream, cnt,
                        n, part, ticket);
  };
  cudaError_t err;
  if ((err = rows_shared
                 ? launch(onehot::count_rows<true>, chunk_grid, stream, key,
                          src, n_src, num_edges, num_segments, l, scratch)
                 : launch(onehot::count_rows<false>, chunk_grid, stream, key,
                          src, n_src, num_edges, num_segments, l,
                          scratch)) != cudaSuccess ||
      (err = scan(l.nblk1, scratch + l.cnt1, l.n1, scratch + l.part1,
                  tickets)) != cudaSuccess ||
      (err = launch(onehot::scatter_rows, edge_grid, stream, key, src, n_src,
                    scale, num_edges, num_segments, l, scratch)) !=
          cudaSuccess ||
      (err = scan(l.nblk2, scratch + l.cnt2, l.n2, scratch + l.part2,
                  tickets + 1)) != cudaSuccess ||
      (err = tiles_shared
                 ? launch(onehot::scatter_tiles<true>, chunk_grid, stream,
                          scale != nullptr, l, scratch)
                 : launch(onehot::scatter_tiles<false>, chunk_grid, stream,
                          scale != nullptr, l, scratch)) != cudaSuccess)
    return err;
  lists->id = scratch + l.b_id;
  lists->scale = scale != nullptr
                     ? reinterpret_cast<const float*>(scratch + l.b_scale)
                     : nullptr;
  lists->scan = scratch + l.cnt2;
  lists->part = scratch + l.part2;
  lists->deg_at = l.tiles * l.chunks;
  return cudaSuccess;
}

}  // namespace repro
