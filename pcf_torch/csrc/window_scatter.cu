// Window scatter, the backward of the window resolve:
//
//   dtable[r, :] = sum over tiles t and edges e with
//                  window_rows[t, localT[t, 0, e]] == r  of  g[t, e, :]
//
// for every row r in [0, n_rows); window rows outside that range are dropped
// (jnp's scatter-add mode="drop"), although the forward clamps them. The sum
// runs in f32 and is stored once in the table's type.
//
// Replaces the Pallas kernel pcf_tpu/ops/window.py::_bwd_kernel (launched by
// _scatter_to_windows from _windowed_take_bwd with impl "pallas") together
// with the XLA scatter-add of the per-window sums into the table rows that
// follows it (window.py:462-464).
//
// Why no one-hot product here: the TPU has no scatter, so the Pallas kernel
// summed a tile's cotangents into its window slots with a transposed one-hot
// [Wsz, Mt*K] matrix product on the MXU. On the H100 the sum is a gather
// once the edge -> row map is inverted, so this kernel inverts it, per call,
// and reduces each row in registers.
//
// Deterministic: the same inputs give the same bits on every launch, as
// pcf_tpu's do. Every f32 sum runs in a fixed order, and no float is added
// with an atomic. The passes:
//
//   sort      a stable LSD radix sort of (row, edge id) pairs, 8 bits a
//             pass (2 passes below 65,536 rows, 3 below 2^24), each pass a
//             histogram per tile of 2048 edges, a scan per digit over the
//             tiles, and a scatter that ranks each tile's edges stably. The
//             first pass's histogram resolves each edge's row (slot clamped,
//             rows outside [0, n_rows) keyed n_rows: they sort last and
//             are never read) and writes the keys and ids
//             (__match_any_sync within a warp, counts per warp in shared
//             memory across the tile's 8 warps). The edges start in id
//             order, so each row's edges end in id order: a CSR of the
//             inverse map whose order does not depend on the run. Integer
//             atomics only count (shared-memory histograms), and counts do
//             not depend on the order of their adds.
//   offsets   each row's segment of the sorted edges, from the key changes.
//             Key, sort and offsets are the inverse: they read only the
//             window rows and slots, so calls on one edge set may share one
//             (have_inverse: the caller passes the inverse workspace of an
//             earlier call on the same edges and n_rows).
//   pieces    the sorted edges cut into pieces of cap positions (cap: 4x
//             the mean fan-in as a power of two, 32 to 256). A row with
//             more than cap edges (heavy: the padding row 0, which every
//             padded point names, 15k-45k edges at the flagship caps, and
//             rare hubs) cannot lie inside one piece, so each piece holds
//             at most two runs of heavy rows: the run its first position
//             belongs to (head) and the one its last belongs to (tail). One
//             thread per (piece, 16-byte chunk of channels) sums each in
//             position order into an f32 slot of its own.
//   rows      S threads (2, 4 or 8 by the mean fan-in, neighbouring lanes)
//             per (row, chunk): a light row's edges s, s + S, ... in f32
//             registers with 16-byte loads; a heavy row's pieces' slots
//             s, s + S, ... (head where the piece starts in the row, else
//             tail); the S partials meet by a fixed butterfly of warp
//             shuffles, and the row is stored once in the table's type,
//             zeros for a row that no edge names. No memset of the table.
//
// How the work per thread is bounded: a light row thread at most cap / S =
// 32 edges, a piece thread cap, a heavy row thread edges / (cap * S) piece
// slots (the padding row: under 100). No thread walks a heavy row's whole
// fan-in.
//
// What bounds it on the H100: device-memory bytes. It reads g once (plus
// localT, the window rows and its own index arrays of a few ints per edge
// and pass) and writes the table once. A call is 3 + 3 x passes launches,
// 2 with a shared inverse; the sort's passes cost a few microseconds each.
//
// C interface for ctypes: every pointer and the stream are void*; returns the
// first CUDA error of the launches, or 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                    // edges per thread in a sort tile
constexpr int kTile = kThreads * kItems;     // edges per sort tile
constexpr int kRadix = 256;                  // 8 bits a pass
constexpr int kMinCap = 32;       // piece length: 4x the mean fan-in,
constexpr int kMaxCap = 256;      // a power of two within these
constexpr int kBatch = 8;         // loads kept in flight per thread

// Two workspaces, in 16-byte aligned sections. The inverse: keys and edge
// ids, twice [edges] int32 each (the sort's two buffers); the histograms
// [256, tiles] and digit totals [256] int32; the row offsets [n_rows + 1]
// int32. The reduction: the pieces' head and tail slots [pieces, C] f32
// each.
struct Layout {
  long long key[2], val[2], hist, total, offsets, inverse_bytes;
  long long head, tail, reduce_bytes;
  int cap, tiles, passes;
  long long pieces;
};

long long up16(long long b) { return (b + 15) / 16 * 16; }

Layout layout(int n_rows, long long edges, int C) {
  Layout l;
  const long long fan_in = n_rows > 0 ? edges / n_rows : 0;
  l.cap = kMinCap;
  while (l.cap < kMaxCap && l.cap < 4 * fan_in) l.cap *= 2;
  l.tiles = (int)((edges + kTile - 1) / kTile);
  int bits = 1;
  while (bits < 31 && (1LL << bits) <= n_rows) ++bits;  // keys 0..n_rows
  l.passes = (bits + 7) / 8;
  l.pieces = (edges + l.cap - 1) / l.cap;
  long long at = 0;
  for (int i = 0; i < 2; ++i) {
    l.key[i] = at;
    at = up16(at + 4 * edges);
    l.val[i] = at;
    at = up16(at + 4 * edges);
  }
  l.hist = at;
  at = up16(at + 4LL * kRadix * l.tiles);
  l.total = at;
  at = up16(at + 4LL * kRadix);
  l.offsets = at;
  l.inverse_bytes = up16(at + 4LL * (n_rows + 1));
  l.head = 0;
  l.tail = up16(4 * l.pieces * C);
  l.reduce_bytes = up16(l.tail + 4 * l.pieces * C);
  return l;
}

template <typename P>
__host__ __device__ __forceinline__ P* at(void* ws, long long off) {
  return reinterpret_cast<P*>(static_cast<char*>(ws) + off);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// sort pass, 1: each tile's digit counts, hist[d, tile]. The first pass
// (window_rows set) resolves the row of every edge (n_rows: dropped) and
// writes it as the key, beside the edge's id.
__global__ void __launch_bounds__(kThreads)
hist_kernel(int* __restrict__ key, int* __restrict__ val, long long edges, int shift,
            int* __restrict__ hist, const int* __restrict__ window_rows,
            const int* __restrict__ localT, int mtk, int wsz, int n_rows) {
  __shared__ int h[kRadix];
  for (int d = threadIdx.x; d < kRadix; d += kThreads) h[d] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kTile;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long e = base + i * kThreads + threadIdx.x;
    if (e >= edges) continue;
    int k;
    if (window_rows) {
      const int slot = min(max(__ldg(localT + e), 0), wsz - 1);  // as the forward
      const int row = __ldg(window_rows + e / mtk * wsz + slot);
      k = row < 0 || row >= n_rows ? n_rows : row;
      key[e] = k;
      val[e] = (int)e;
    } else {
      k = key[e];
    }
    atomicAdd(h + ((k >> shift) & (kRadix - 1)), 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kRadix; d += kThreads)
    hist[(long long)d * gridDim.x + blockIdx.x] = h[d];
}

// sort pass, 2: one warp per digit turns its row of hist into exclusive
// prefixes over the tiles and writes the digit's total
__global__ void __launch_bounds__(kThreads)
scan_kernel(int* __restrict__ hist, int tiles, int* __restrict__ total) {
  const int d = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (d >= kRadix) return;
  int* h = hist + (long long)d * tiles;
  int carry = 0;
  for (int b0 = 0; b0 < tiles; b0 += 32) {
    const int b = b0 + lane;
    const int v = b < tiles ? h[b] : 0;
    int x = v;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (b < tiles) h[b] = carry + x - v;
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) total[d] = carry;
}

// sort pass, 3: move each edge of the tile to its place, stably: round i
// takes the tile's edges i * 256 + thread, in edge order; within a warp an
// edge's rank among equal digits is that of its lane, across warps the
// counts per warp add up in warp order, across rounds in round order
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ key_in, const int* __restrict__ val_in,
               long long edges, int shift, const int* __restrict__ hist,
               const int* __restrict__ total, int* __restrict__ key_out,
               int* __restrict__ val_out) {
  __shared__ int base[kRadix];              // this tile's first place per digit
  __shared__ int warp_at[kWarps][kRadix];   // a round's counts, then offsets
  __shared__ int wsum[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  {  // exclusive scan of the digit totals (kThreads == kRadix)
    const int v = total[tid];
    int x = v;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += wsum[w];
    base[tid] = before + x - v + hist[(long long)tid * gridDim.x + blockIdx.x];
  }
  int run = 0;  // thread tid: edges of digit tid placed by earlier rounds
  const long long tile0 = (long long)blockIdx.x * kTile;
  const unsigned below = (1u << lane) - 1;
  for (int i = 0; i < kItems; ++i) {
    for (int w = 0; w < kWarps; ++w) warp_at[w][tid] = 0;
    __syncthreads();
    const long long e = tile0 + i * kThreads + tid;
    const bool live = e < edges;
    const int k = live ? key_in[e] : 0;
    const int d = live ? (k >> shift) & (kRadix - 1) : kRadix;  // kRadix: none
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (live && lane == __ffs(peers) - 1) warp_at[warp][d] = __popc(peers);
    __syncthreads();
    int acc = run;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_at[w][tid];
      warp_at[w][tid] = acc;
      acc += c;
    }
    run = acc;
    __syncthreads();
    if (live) {
      const int p = base[d] + warp_at[warp][d] + __popc(peers & below);
      key_out[p] = k;
      val_out[p] = val_in[e];
    }
    __syncthreads();
  }
}

// offsets[r] = the first sorted position whose key is >= r, for r in
// [0, n_rows]: position i writes the rows in (key[i - 1], key[i]]
__global__ void __launch_bounds__(kThreads)
offsets_kernel(const int* __restrict__ key, long long edges, int n_rows,
               int* __restrict__ offsets) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i > edges) return;
  const int lo = i == 0 ? 0 : key[i - 1] + 1;
  const int hi = i == edges ? n_rows : min(key[i], n_rows);
  for (int r = lo; r <= hi; ++r) offsets[r] = (int)i;
}

// sum_{p in [lo, hi)} g[val[p], chunk q] into s, in position order
template <typename T, typename Chunk>
__device__ __forceinline__ void sum_positions(const T* __restrict__ g,
                                              const int* __restrict__ val, int lo, int hi,
                                              int step, int C, int q,
                                              float (&s)[sizeof(Chunk) / sizeof(T)]) {
  constexpr int kVec = sizeof(Chunk) / sizeof(T);
  for (int b0 = lo; b0 < hi; b0 += step * kBatch) {
    int idx[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) idx[i] = b0 + i * step < hi ? val[b0 + i * step] : -1;
    Chunk ch[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (idx[i] >= 0)
        ch[i] = __ldg(reinterpret_cast<const Chunk*>(g + (long long)idx[i] * C) + q);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (idx[i] >= 0) {
        const T* v = reinterpret_cast<const T*>(&ch[i]);
#pragma unroll
        for (int k = 0; k < kVec; ++k) s[k] += to_float(v[k]);
      }
    }
  }
}

// pieces: one thread per (piece, chunk) sums the piece's runs of heavy rows
// into head[piece] (the first position's row) and tail[piece] (the last
// position's, when another row)
template <typename T, typename Chunk>
__global__ void __launch_bounds__(kThreads)
pieces_kernel(const T* __restrict__ g, const int* __restrict__ key,
              const int* __restrict__ val, const int* __restrict__ offsets, int n_rows,
              int cap, int C, int V, long long pieces, float* __restrict__ head,
              float* __restrict__ tail) {
  constexpr int kVec = sizeof(Chunk) / sizeof(T);
  const long long it = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (it >= pieces * V) return;
  const long long p = it / V;
  const int q = (int)(it - p * V);
  const int valid = offsets[n_rows];
  const int p0 = (int)(p * cap);
  if (p0 >= valid) return;
  const int p1 = min(p0 + cap, valid);
  const int k0 = key[p0], k1 = key[p1 - 1];
  if (offsets[k0 + 1] - offsets[k0] > cap) {
    float s[kVec] = {};
    sum_positions<T, Chunk>(g, val, p0, min(offsets[k0 + 1], p1), 1, C, q, s);
    float* o = head + p * C + q * kVec;
#pragma unroll
    for (int k = 0; k < kVec; ++k) o[k] = s[k];
  }
  if (k1 != k0 && offsets[k1 + 1] - offsets[k1] > cap) {
    float s[kVec] = {};
    sum_positions<T, Chunk>(g, val, max(offsets[k1], p0), p1, 1, C, q, s);
    float* o = tail + p * C + q * kVec;
#pragma unroll
    for (int k = 0; k < kVec; ++k) o[k] = s[k];
  }
}

// rows: S threads per (row, chunk), neighbouring lanes; thread s sums the
// row's edges (or, for a heavy row, its pieces' slots) s, s + S, ...; the S
// partials meet by warp shuffles
template <typename T, typename OutT, typename Chunk, int S>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ g, const int* __restrict__ key,
            const int* __restrict__ val, const int* __restrict__ offsets,
            const float* __restrict__ head, const float* __restrict__ tail, int n_rows,
            int cap, int C, int V, OutT* __restrict__ out) {
  constexpr int kVec = sizeof(Chunk) / sizeof(T);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long item = tid / S;
  const int s = (int)(tid % S);
  const bool live = item < (long long)n_rows * V;  // every lane reaches the shuffles
  int r = 0, q = 0, lo = 0, hi = 0;
  if (live) {
    r = (int)(item / V);
    q = (int)(item - (long long)r * V);
    lo = offsets[r];
    hi = offsets[r + 1];
  }
  float sum[kVec] = {};
  if (hi - lo <= cap) {
    sum_positions<T, Chunk>(g, val, lo + s, hi, S, C, q, sum);
  } else {
    for (int p = lo / cap + s; p <= (hi - 1) / cap; p += S) {
      const float* slot = (key[(long long)p * cap] == r ? head : tail) + (long long)p * C +
                          q * kVec;
#pragma unroll
      for (int k = 0; k < kVec; ++k) sum[k] += slot[k];
    }
  }
#pragma unroll
  for (int off = S / 2; off > 0; off /= 2)
#pragma unroll
    for (int k = 0; k < kVec; ++k) sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], off);
  if (!live || s != 0) return;
  OutT* o = out + (long long)r * C + q * kVec;
  if constexpr (std::is_same<OutT, T>::value) {
    Chunk packed;
    OutT* pk = reinterpret_cast<OutT*>(&packed);
#pragma unroll
    for (int k = 0; k < kVec; ++k) pk[k] = from_float<OutT>(sum[k]);
    *reinterpret_cast<Chunk*>(o) = packed;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) o[k] = from_float<OutT>(sum[k]);
  }
}

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

// key, sort and offsets; the sorted keys and ids end in buffer l.passes % 2
int invert(const int* window_rows, const int* localT, void* ws, const Layout& l,
            long long edges, int mtk, int wsz, int n_rows, cudaStream_t s) {
  if (edges > 0) {
    for (int p = 0; p < l.passes; ++p) {
      const int in = p % 2, shift = 8 * p;
      hist_kernel<<<l.tiles, kThreads, 0, s>>>(
          at<int>(ws, l.key[in]), at<int>(ws, l.val[in]), edges, shift, at<int>(ws, l.hist),
          p == 0 ? window_rows : nullptr, localT, mtk, wsz, n_rows);
      scan_kernel<<<kRadix / kWarps, kThreads, 0, s>>>(at<int>(ws, l.hist), l.tiles,
                                                       at<int>(ws, l.total));
      scatter_kernel<<<l.tiles, kThreads, 0, s>>>(
          at<int>(ws, l.key[in]), at<int>(ws, l.val[in]), edges, shift, at<int>(ws, l.hist),
          at<int>(ws, l.total), at<int>(ws, l.key[1 - in]), at<int>(ws, l.val[1 - in]));
    }
  }
  offsets_kernel<<<blocks_for(edges + 1), kThreads, 0, s>>>(
      at<int>(ws, l.key[l.passes % 2]), edges, n_rows, at<int>(ws, l.offsets));
  return (int)cudaGetLastError();
}

template <typename T, typename OutT, typename Chunk, int S>
void launch_rows(const T* g, OutT* out, void* ws, void* rs, const Layout& l, int n_rows,
                 int C, int V, cudaStream_t s) {
  const int* key = at<int>(ws, l.key[l.passes % 2]);
  const int* val = at<int>(ws, l.val[l.passes % 2]);
  rows_kernel<T, OutT, Chunk, S><<<blocks_for((long long)n_rows * V * S), kThreads, 0, s>>>(
      g, key, val, at<int>(ws, l.offsets), at<float>(rs, l.head), at<float>(rs, l.tail),
      n_rows, l.cap, C, V, out);
}

// ws: the inverse, rs: the reduction's workspace
template <typename T, typename OutT, typename Chunk>
int reduce(const void* gv, void* outv, void* ws, void* rs, const Layout& l, long long edges,
           int n_rows, int C, cudaStream_t s) {
  constexpr int kVec = sizeof(Chunk) / sizeof(T);
  const int V = C / kVec;
  const T* g = static_cast<const T*>(gv);
  OutT* out = static_cast<OutT*>(outv);
  if (l.pieces > 0)
    pieces_kernel<T, Chunk><<<blocks_for(l.pieces * V), kThreads, 0, s>>>(
        g, at<int>(ws, l.key[l.passes % 2]), at<int>(ws, l.val[l.passes % 2]),
        at<int>(ws, l.offsets), n_rows, l.cap, C, V, l.pieces, at<float>(rs, l.head),
        at<float>(rs, l.tail));
  // threads per (row, chunk) from the mean fan-in, so that a thread sums at
  // most l.cap / S <= 32 edges of a light row
  const long long fan_in = edges / n_rows;
  if (fan_in <= 16)
    launch_rows<T, OutT, Chunk, 2>(g, out, ws, rs, l, n_rows, C, V, s);
  else if (fan_in <= 32)
    launch_rows<T, OutT, Chunk, 4>(g, out, ws, rs, l, n_rows, C, V, s);
  else
    launch_rows<T, OutT, Chunk, 8>(g, out, ws, rs, l, n_rows, C, V, s);
  return (int)cudaGetLastError();
}

template <typename T, typename OutT>
int reduce_for_chunk(int chunk_bytes, const void* g, void* out, void* ws, void* rs,
                     const Layout& l, long long edges, int n_rows, int C, cudaStream_t s) {
  switch (chunk_bytes) {
    case 16: return reduce<T, OutT, uint4>(g, out, ws, rs, l, edges, n_rows, C, s);
    case 8: return reduce<T, OutT, uint2>(g, out, ws, rs, l, edges, n_rows, C, s);
    case 4: return reduce<T, OutT, uint32_t>(g, out, ws, rs, l, edges, n_rows, C, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return reduce<T, OutT, uint16_t>(g, out, ws, rs, l, edges, n_rows, C, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Positions of a piece for these sizes: rows with more edges are heavy and
// summed piece by piece.
extern "C" int window_scatter_cap(int n_rows, long long edges) {
  return layout(n_rows, edges, 1).cap;
}

// Bytes of the two workspaces that window_scatter needs for these sizes:
// the inverse's (which calls on one edge set may share) and the
// reduction's.
extern "C" long long window_scatter_inverse_bytes(int n_rows, long long edges) {
  return layout(n_rows, edges, 1).inverse_bytes;
}

extern "C" long long window_scatter_reduce_bytes(int n_rows, long long edges, int C) {
  return layout(n_rows, edges, C).reduce_bytes;
}

// g [T, mtk, C] (bf16 if g_bf16, else f32), window_rows [T, wsz] int32,
// localT [T, 1, mtk] int32 -> out [n_rows, C] (bf16 if out_bf16, else f32),
// every row written. inverse: at least window_scatter_inverse_bytes(n_rows,
// T * mtk) bytes (inverse_bytes); have_inverse != 0: it holds the inverse
// that an earlier call on the same window_rows, localT and n_rows left
// there, and the key, sort and offsets passes are skipped. work: at least
// window_scatter_reduce_bytes(n_rows, T * mtk, C) bytes (work_bytes), its
// contents ignored. Both 16-byte aligned. chunk_bytes (16, 8, 4, or 2 for
// bf16) divides C * element size and the alignment of g; the wrapper picks
// the widest that does. inverse_only != 0 stops after the inverse (to time
// it alone; out is then not written).
extern "C" int window_scatter(int g_bf16, int out_bf16, const void* g,
                              const void* window_rows, const void* localT, void* out,
                              void* inverse, long long inverse_bytes, int have_inverse,
                              void* work, long long work_bytes, int T, int mtk, int wsz,
                              int n_rows, int C, int chunk_bytes, int inverse_only,
                              void* stream) {
  if (T < 0 || mtk < 0 || wsz <= 0 || n_rows < 0 || C < 0 || chunk_bytes <= 0 ||
      (C * (g_bf16 ? 2 : 4)) % chunk_bytes != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)n_rows * C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long edges = (long long)T * mtk;
  if (edges >= (1LL << 31) || n_rows >= (1 << 30)) return (int)cudaErrorInvalidValue;
  const Layout l = layout(n_rows, edges, C);
  if (inverse_bytes < l.inverse_bytes || (!inverse_only && work_bytes < l.reduce_bytes))
    return (int)cudaErrorInvalidValue;
  if (!have_inverse) {
    const int err = invert(static_cast<const int*>(window_rows),
                           static_cast<const int*>(localT), inverse, l, edges, mtk, wsz,
                           n_rows, s);
    if (err) return err;
  }
  if (inverse_only) return 0;
  if (g_bf16)
    return out_bf16 ? reduce_for_chunk<__nv_bfloat16, __nv_bfloat16>(
                          chunk_bytes, g, out, inverse, work, l, edges, n_rows, C, s)
                    : reduce_for_chunk<__nv_bfloat16, float>(chunk_bytes, g, out, inverse,
                                                             work, l, edges, n_rows, C, s);
  return out_bf16 ? reduce_for_chunk<float, __nv_bfloat16>(chunk_bytes, g, out, inverse, work,
                                                           l, edges, n_rows, C, s)
                  : reduce_for_chunk<float, float>(chunk_bytes, g, out, inverse, work, l,
                                                   edges, n_rows, C, s);
}
