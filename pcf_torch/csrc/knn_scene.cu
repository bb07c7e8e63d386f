// kNN within scenes: for every query row, its k nearest valid reference rows
// of the same scene (squared L2 distance), in ascending order.
//
// Replaces no TPU kernel. pcf_tpu/ops/knn.py is plain JAX (tiled distance
// rows and lax.top_k, no Pallas), and so is the port's plain version,
// pcf_torch/ops/knn.py::knn_plain, which the port keeps for CPU tensors. On
// the card that plain version writes a [q_tile, N] f32 score row per tile
// of queries against every row of the packed batch, masks the other scenes
// with torch.where and runs torch.topk over the whole row: at the 10 cm
// training caps (188416, 98304, 32768, 8192, 2048 rows, 16 scenes) the 13
// edge sets of a preparation make about 9.0e10 score entries, 15 of 16 of
// them another scene's or padding's, some ten passes of device memory over
// each, and some 1,560 tiles of about 25 kernels: 2.7 s a preparation.
//
// What bounds this kernel on the H100: f32 arithmetic. Restricted to each
// query's own scene, the same preparation has about 3.2e9 valid pairs, at
// about 8 operations a pair 2.6e10 operations, 0.4 ms at 67 TFLOP/s; the
// outputs (about 1.1M query rows x 16 x 4 bytes, 70 MB with the distances)
// take about 0.02 ms at 3.35 TB/s. No score reaches device memory:
//
//   group    (once per row set, shared by the edge sets that read it) a
//            stable counting sort of the rows by scene: bins 0..S-1 are the
//            scene ids, bin S holds every row left out (a masked reference
//            row, or a scene id outside [0, S)). One block counts a tile's
//            rows per bin (global atomics, one per warp and bin); a thread
//            per bin turns the counts into each tile's exclusive start; one
//            block scans the bins into offsets [S+2] and, for the search's
//            grid, the blocks each bin's queries take; one warp per tile
//            walks its rows in order and writes each as a float4 (x, y, z,
//            row index) to its place. Stable, so each scene keeps the rows'
//            order (Morton or voxel order within a scene, even where the
//            scene ids interleave, as in the device pyramid's levels >= 1).
//            Reads nothing back to the host: S is the caller's.
//   search   (one launch per edge set) a block takes up to 256 queries of
//            one scene and stages that scene's reference rows through
//            shared memory, 1024 at a time; each thread keeps the K best
//            (distance, row) pairs of its queries (two for K = 16, one for 32) as
//            sorted 64-bit keys in registers, tests each distance against
//            its K-th and inserts the few that pass.
//
// The result is the plain version's contract, bit for bit where that is
// defined: distances in difference form, (r - q)^2 summed over x, y, z in f32
// (the compiler may contract them into FMAs: within 1e-6 relative of the
// plain version's); ties broken by self first, then by the lower row index,
// so the order is total and two launches give the same bits whatever order
// the rows were scanned in; a query with fewer than k valid refs repeats its
// nearest; a query with none (its scene has no valid ref, or its scene id is
// outside [0, S)) gets row 0 at distance 1e10, which callers mask.
//
// C interface for ctypes: every pointer and the stream are void*; each
// function returns the first CUDA error of its launches, or 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQB = 256;          // queries per search block
constexpr int kChunk = 1024;      // reference rows staged per chunk (16 KB)
constexpr int kMinTile = 256;     // rows per grouping tile, doubled while
constexpr long long kHistBudget = 1LL << 22;  // tiles x bins ints exceed this
constexpr int kThreads = 256;
constexpr float kNoRef = 1e10f;   // the distance of a query without refs
constexpr unsigned kFull = 0xffffffffu;

long long up16(long long b) { return (b + 15) / 16 * 16; }

// A grouping's workspace, 16-byte aligned sections: the rows sorted by bin
// [n] float4; offsets [bins + 1] int32 (offsets[b] is bin b's first row,
// offsets[bins] = n); blocks [bins + 1] int32 (the search blocks of bins
// before b, kQB queries a block); totals [bins] int32; the tiles' counts,
// then exclusive starts, [tiles, bins] int32. bins = S + 1.
struct Layout {
  long long sorted, offsets, blocks, totals, hist, bytes;
  int tile, tiles, bins;
};

Layout layout(int n, int S) {
  Layout l;
  l.bins = S + 1;
  l.tile = kMinTile;
  while (((long long)n + l.tile - 1) / l.tile * l.bins > kHistBudget && l.tile < (1 << 30))
    l.tile *= 2;
  l.tiles = (int)(((long long)n + l.tile - 1) / l.tile);
  long long at = 0;
  l.sorted = at;
  at = up16(at + 16LL * n);
  l.offsets = at;
  at = up16(at + 4LL * (l.bins + 1));
  l.blocks = at;
  at = up16(at + 4LL * (l.bins + 1));
  l.totals = at;
  at = up16(at + 4LL * l.bins);
  l.hist = at;
  l.bytes = up16(at + 4LL * l.tiles * l.bins);
  return l;
}

template <typename P>
P* at(void* ws, long long off) {
  return reinterpret_cast<P*>(static_cast<char*>(ws) + off);
}
template <typename P>
const P* at(const void* ws, long long off) {
  return reinterpret_cast<const P*>(static_cast<const char*>(ws) + off);
}

__device__ __forceinline__ int bin_of(const int* __restrict__ bid,
                                      const unsigned char* __restrict__ mask, int i, int S) {
  if (mask != nullptr && !mask[i]) return S;
  const int b = bid != nullptr ? bid[i] : 0;
  return (b >= 0 && b < S) ? b : S;
}

// ------------------------------------------------------------------ group

__global__ void __launch_bounds__(kThreads)
group_count(const int* __restrict__ bid, const unsigned char* __restrict__ mask, int n,
            int S, int tile, int* __restrict__ hist) {
  const int bins = S + 1;
  const int lo = blockIdx.x * tile, hi = min(n, lo + tile);
  int* h = hist + (long long)blockIdx.x * bins;
  const int lane = threadIdx.x & 31;
  for (int base = lo; base < hi; base += kThreads) {  // uniform over the block
    const int i = base + threadIdx.x;
    const int b = i < hi ? bin_of(bid, mask, i, S) : -1;
    const unsigned peers = __match_any_sync(kFull, b);
    if (b >= 0 && lane == __ffs(peers) - 1) atomicAdd(&h[b], __popc(peers));
  }
}

// One thread per bin: the tiles' counts become their exclusive starts within
// the bin, and the bin's total is kept. Loads go 16 at a time so that their
// latencies overlap.
__global__ void __launch_bounds__(kThreads)
group_tile_starts(int* __restrict__ hist, int tiles, int bins, int* __restrict__ totals) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= bins) return;
  int run = 0;
  for (int t0 = 0; t0 < tiles; t0 += 16) {
    int c[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      c[j] = t0 + j < tiles ? hist[(long long)(t0 + j) * bins + b] : 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (t0 + j < tiles) hist[(long long)(t0 + j) * bins + b] = run;
      run += c[j];
    }
  }
  totals[b] = run;
}

// Exclusive scan of v over the block (blockDim.x == kThreads); *sum gets the
// block's total. `warp` is 32 ints of shared memory.
__device__ __forceinline__ int block_exclusive(int v, int* warp, int* sum) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = lane < kThreads / 32 ? warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t += y;
    }
    if (lane < kThreads / 32) warp[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  const int before = w > 0 ? warp[w - 1] : 0;
  *sum = warp[kThreads / 32 - 1];
  __syncthreads();  // warp[] is reused by the next call
  return before + x - v;
}

// One block: offsets[b] = rows of the bins before b, blocks[b] = search
// blocks of the bins before b (each bin's rows in blocks of kQB).
__global__ void __launch_bounds__(kThreads)
group_offsets(const int* __restrict__ totals, int bins, int* __restrict__ offsets,
              int* __restrict__ blocks) {
  __shared__ int warp[32];
  int carry_rows = 0, carry_blocks = 0;
  for (int base = 0; base < bins; base += kThreads) {
    const int b = base + threadIdx.x;
    const int c = b < bins ? totals[b] : 0;
    int rows_sum, blocks_sum;
    const int rows_ex = block_exclusive(c, warp, &rows_sum);
    const int blocks_ex = block_exclusive((c + kQB - 1) / kQB, warp, &blocks_sum);
    if (b < bins) {
      offsets[b] = carry_rows + rows_ex;
      blocks[b] = carry_blocks + blocks_ex;
    }
    carry_rows += rows_sum;
    carry_blocks += blocks_sum;
  }
  if (threadIdx.x == 0) {
    offsets[bins] = carry_rows;
    blocks[bins] = carry_blocks;
  }
}

// One warp per tile, its rows in order, 32 at a time: rows of one bin in a
// round take consecutive places in lane order after the bin's earlier rows
// in the tile (the tile's start, advanced by its leader).
__global__ void __launch_bounds__(kThreads)
group_scatter(const float* __restrict__ points, const int* __restrict__ bid,
              const unsigned char* __restrict__ mask, int n, int S, int tile, int tiles,
              int* __restrict__ hist, const int* __restrict__ offsets,
              float4* __restrict__ sorted) {
  const int t = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (t >= tiles) return;  // whole warps
  const int bins = S + 1;
  const int lane = threadIdx.x & 31;
  const int lo = t * tile, hi = min(n, lo + tile);
  int* h = hist + (long long)t * bins;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const int b = i < hi ? bin_of(bid, mask, i, S) : -1;
    const unsigned peers = __match_any_sync(kFull, b);
    const int leader = __ffs(peers) - 1;
    int start = 0;
    if (b >= 0 && lane == leader) {
      start = h[b];
      h[b] = start + __popc(peers);
    }
    start = __shfl_sync(kFull, start, leader);
    if (b >= 0) {
      const int pos = offsets[b] + start + __popc(peers & ((1u << lane) - 1u));
      sorted[pos] = make_float4(points[3LL * i], points[3LL * i + 1], points[3LL * i + 2],
                                __int_as_float(i));
    }
    __syncwarp();  // the leader's store to h before the next round's load
  }
}

// ----------------------------------------------------------------- search

// A key orders (distance, row) pairs: the distance's bits (non-negative, so
// they order as the floats do) above the row's tie rank (0 for the query's
// own row in a self search, else the row + 1).
constexpr uint64_t kEmpty = (uint64_t(0x7f800000u) << 32) | 0xffffffffu;  // +inf, last

__device__ __forceinline__ float key_dist(uint64_t key) {
  return __uint_as_float(unsigned(key >> 32));
}

template <int K>
__device__ __forceinline__ void insert(uint64_t (&list)[K], uint64_t key) {
  bool lt[K];
#pragma unroll
  for (int j = 0; j < K; ++j) lt[j] = key < list[j];
#pragma unroll
  for (int j = K - 1; j > 0; --j) list[j] = lt[j - 1] ? list[j - 1] : (lt[j] ? key : list[j]);
  list[0] = lt[0] ? key : list[0];
}

// QPT queries a thread, kQB / QPT threads a block: thread x takes the
// block's queries x, x + kQB / QPT, ... (neighbours in the scene's order
// share a warp, so their lists fill alike and the warp's inserts coincide).
template <int K, int QPT>
__global__ void __launch_bounds__(kQB / QPT)
knn_search(const float4* __restrict__ qs, const int* __restrict__ qoff,
           const int* __restrict__ qblocks, const float4* __restrict__ rs,
           const int* __restrict__ roff, int S, int k, int self_search,
           int* __restrict__ out_idx, float* __restrict__ out_dist) {
  constexpr int NT = kQB / QPT;
  __shared__ float4 tile[kChunk];
  const int bins = S + 1;
  const int blk = blockIdx.x;
  if (blk >= qblocks[bins]) return;  // the grid is a bound; whole blocks leave
  int lo = 0, hi = bins;             // the bin s with qblocks[s] <= blk < qblocks[s + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (qblocks[mid] <= blk) lo = mid; else hi = mid;
  }
  const int s = lo;
  const int qa = qoff[s] + (blk - qblocks[s]) * kQB;
  const int qe = min(qa + kQB, qoff[s + 1]);
  const int r0 = s < S ? roff[s] : 0;
  const int R = s < S ? roff[s + 1] - r0 : 0;

  float4 q[QPT];
  bool live[QPT];
  uint64_t list[QPT][K];
  float kth[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int j = qa + threadIdx.x + u * NT;
    live[u] = j < qe;
    q[u] = qs[live[u] ? j : qa];  // an idle slot follows the block's first query
    kth[u] = __uint_as_float(0x7f800000u);
#pragma unroll
    for (int e = 0; e < K; ++e) list[u][e] = kEmpty;
  }

  for (int c0 = 0; c0 < R; c0 += kChunk) {
    const int cnt = min(kChunk, R - c0);
    __syncthreads();  // the previous chunk is read
    for (int j = threadIdx.x; j < cnt; j += NT) tile[j] = rs[r0 + c0 + j];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float4 r = tile[j];
#pragma unroll
      for (int u = 0; u < QPT; ++u) {
        const float dx = r.x - q[u].x, dy = r.y - q[u].y, dz = r.z - q[u].z;
        const float d = dx * dx + dy * dy + dz * dz;
        if (d <= kth[u]) {
          const int row = __float_as_int(r.w);
          const unsigned rank =
              self_search && row == __float_as_int(q[u].w) ? 0u : unsigned(row) + 1u;
          insert<K>(list[u], (uint64_t(__float_as_uint(d)) << 32) | rank);
          kth[u] = key_dist(list[u][K - 1]);
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    if (!live[u]) continue;
    const int qrow = __float_as_int(q[u].w);
    int* oi = out_idx + (long long)qrow * k;
    float* od = out_dist != nullptr ? out_dist + (long long)qrow * k : nullptr;
#pragma unroll
    for (int e = 0; e < K; ++e) {
      if (e >= k) break;
      // an empty slot (fewer than k valid refs) repeats the nearest
      const uint64_t key = R == 0 ? 0 : (list[u][e] == kEmpty ? list[u][0] : list[u][e]);
      const unsigned rank = unsigned(key);
      oi[e] = R == 0 ? 0 : (rank == 0u ? qrow : int(rank - 1u));
      if (od != nullptr) od[e] = R == 0 ? kNoRef : key_dist(key);
    }
  }
}

template <int K, int QPT>
cudaError_t launch_search(int blocks, cudaStream_t s, const float4* qs, const int* qoff,
                          const int* qblocks, const float4* rs, const int* roff, int S, int k,
                          int self_search, int* idx, float* dist) {
  knn_search<K, QPT><<<blocks, kQB / QPT, 0, s>>>(qs, qoff, qblocks, rs, roff, S, k,
                                                  self_search, idx, dist);
  return cudaGetLastError();
}

}  // namespace

// Bytes of a grouping's workspace for n rows and S scenes.
extern "C" long long knn_scene_group_bytes(int n, int S) { return layout(n, S).bytes; }

// Group n rows (points [n, 3] f32) by scene: bid [n] int32 (nullptr: every
// row in scene 0), mask [n] bool as bytes (nullptr: every row valid). ws: at
// least knn_scene_group_bytes(n, S) bytes (ws_bytes), 16-byte aligned, its
// contents ignored. n >= 1, S >= 1.
extern "C" int knn_scene_group(const void* points, const void* bid, const void* mask, int n,
                               int S, void* ws, long long ws_bytes, void* stream) {
  if (n < 1 || S < 1 || S >= (1 << 30)) return (int)cudaErrorInvalidValue;
  const Layout l = layout(n, S);
  if (ws_bytes < l.bytes || reinterpret_cast<uintptr_t>(ws) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(points);
  const int* b = static_cast<const int*>(bid);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  int* hist = at<int>(ws, l.hist);
  cudaError_t err = cudaMemsetAsync(hist, 0, 4LL * l.tiles * l.bins, s);
  if (err != cudaSuccess) return (int)err;
  group_count<<<l.tiles, kThreads, 0, s>>>(b, m, n, S, l.tile, hist);
  group_tile_starts<<<(l.bins + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      hist, l.tiles, l.bins, at<int>(ws, l.totals));
  group_offsets<<<1, kThreads, 0, s>>>(at<int>(ws, l.totals), l.bins, at<int>(ws, l.offsets),
                                       at<int>(ws, l.blocks));
  const int warps = kThreads / 32;
  group_scatter<<<(l.tiles + warps - 1) / warps, kThreads, 0, s>>>(
      p, b, m, n, S, l.tile, l.tiles, hist, at<int>(ws, l.offsets), at<float4>(ws, l.sorted));
  return (int)cudaGetLastError();
}

// k nearest of each of m query rows among nr reference rows, scene by scene:
// qws and rws are knn_scene_group's workspaces of the queries (grouped
// without a mask) and the references (with theirs), both with S scenes.
// K (16 or 32) is the list kept per query, k <= K the columns written:
// idx [m, k] int32 and, unless nullptr, dist [m, k] f32. self_search != 0:
// the queries are the references' own rows, and a row ranks first among
// its ties.
extern "C" int knn_scene_search(int K, const void* qws, int m, const void* rws, int nr, int S,
                                int k, int self_search, void* idx, void* dist, void* stream) {
  if (m < 1 || nr < 1 || S < 1 || S >= (1 << 30) || k < 1 || k > K)
    return (int)cudaErrorInvalidValue;
  const Layout lq = layout(m, S), lr = layout(nr, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* qs = at<float4>(qws, lq.sorted);
  const int* qoff = at<int>(qws, lq.offsets);
  const int* qblocks = at<int>(qws, lq.blocks);
  const float4* rs = at<float4>(rws, lr.sorted);
  const int* roff = at<int>(rws, lr.offsets);
  int* oi = static_cast<int*>(idx);
  float* od = static_cast<float*>(dist);
  // the grid's bound: the blocks of each bin, rounded up, over the bins
  const int blocks = (m + kQB - 1) / kQB + S + 1;
  switch (K) {
    case 16:
      return (int)launch_search<16, 2>(blocks, s, qs, qoff, qblocks, rs, roff, S, k,
                                       self_search, oi, od);
    case 32:
      return (int)launch_search<32, 1>(blocks, s, qs, qoff, qblocks, rs, roff, S, k,
                                       self_search, oi, od);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
