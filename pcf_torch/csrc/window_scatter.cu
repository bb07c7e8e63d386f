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
// and reduces each row in registers:
//
//   place     one thread per edge resolves its row (slot clamped, rows
//             outside [0, n_rows) dropped) and takes a rank within the row
//             from an integer counter, one atomic per group of equal rows in
//             a warp (__match_any_sync), not one per element of g. An edge
//             of rank < cap goes into the row's bucket of cap edge ids (cap:
//             4x the mean fan-in edges / n_rows as a power of two, 32 to
//             256); the rest go onto one overflow list. Rows with more than
//             cap edges are few: the padding row 0, which every padded point
//             names (15k-45k edges at the flagship caps), and rare hubs.
//   reduce    one launch. Its first blocks give S threads (2, 4 or 8 by the
//             mean fan-in, neighbouring lanes) to each (row, 16-byte chunk
//             of channels): they sum the row's bucket in f32 registers with
//             16-byte loads, meet by warp shuffles, and store the row once
//             in the table's type, zeros for a row that no edge names. No
//             atomics and no memset of the table. Its last kOverBlocks
//             blocks take the overflow list in pieces of kPiece edges, one
//             thread per (piece, chunk), summed per run of equal rows; runs
//             that end on the row of their block's first edge (the padding
//             row, mostly) meet in shared memory, so the block adds each
//             element into the overflowed row's f32 accumulator once.
//             An overflowed row's bucket sum is added there too, and the
//             last block to finish casts those rows into the table.
//
// How the work per thread is bounded: place takes one edge, a row thread
// at most cap / S = 32 edges, an overflow thread kPiece = 16 per round; the
// finishing block casts one row per overflowed row (at most
// edges / (cap + 1)). No thread walks a row's whole fan-in.
//
// What bounds it on the H100: device-memory bytes. It reads g once (plus
// localT, the window rows, and its own index arrays of a few ints per edge)
// and writes the table once. A call is a memset of n_rows counters and two
// launches; the integer atomics of place and the dependent loads of the
// overflow pieces cost a few microseconds per call.
//
// Numerics: bucket ranks come from atomics, so the order of each f32 sum,
// and so its last bits, may change from run to run (and, after the cast, a
// bf16 value by one step).
//
// C interface for ctypes: every pointer and the stream are void*; returns the
// first CUDA error of the launches, or 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMinCap = 32;       // edges a row's bucket holds: 4x the mean
constexpr int kMaxCap = 256;      // fan-in, a power of two within these
constexpr int kPiece = 16;        // overflow edges per item of the overflow pass
constexpr int kBatch = 8;         // loads kept in flight per thread
constexpr int kOverBlocks = 264;  // blocks on the overflow list: 2 per SM
constexpr int kCounters = 3;      // n_over, n_heavy, blocks done

// The workspace, in int32 words: counters, counts [n_rows] (zeroed per
// call), bucket [n_rows, cap], heavy slot of each row [n_rows], overflow
// edge ids and rows [edges] each, heavy rows [max_heavy]; then, 16-byte
// aligned, the f32 accumulator [max_heavy, C].
struct Layout {
  long long counts, bucket, hslot, over_e, over_r, heavy_row, acc_bytes, bytes;
  int cap;  // bucket length
};

Layout layout(int n_rows, long long edges, int C) {
  Layout l;
  const long long fan_in = n_rows > 0 ? edges / n_rows : 0;
  l.cap = kMinCap;
  while (l.cap < kMaxCap && l.cap < 4 * fan_in) l.cap *= 2;
  const long long max_heavy = edges / (l.cap + 1) + 1;
  l.counts = kCounters;
  l.bucket = l.counts + n_rows;
  l.hslot = l.bucket + (long long)n_rows * l.cap;
  l.over_e = l.hslot + n_rows;
  l.over_r = l.over_e + edges;
  l.heavy_row = l.over_r + edges;
  const long long ints = l.heavy_row + max_heavy;
  l.acc_bytes = (ints * 4 + 15) / 16 * 16;
  l.bytes = l.acc_bytes + max_heavy * C * 4;
  return l;
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

// place: row, rank and bucket or overflow slot of every edge
__global__ void __launch_bounds__(kThreads)
place_kernel(const int* __restrict__ window_rows, const int* __restrict__ localT,
             long long edges, int mtk, int wsz, int n_rows, int C, int* __restrict__ ws,
             Layout l) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  int row = -1;
  if (e < edges) {
    const long long t = e / mtk;
    const int slot = min(max(__ldg(localT + e), 0), wsz - 1);  // as the forward
    row = __ldg(window_rows + t * wsz + slot);
    if (row < 0 || row >= n_rows) row = -1;  // dropped
  }
  const unsigned live = __ballot_sync(0xffffffffu, row >= 0);
  if (row < 0) return;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const unsigned peers = __match_any_sync(live, row);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(ws + l.counts + row, __popc(peers));
  const int rank = __shfl_sync(live, base, leader) + __popc(peers & below);
  const unsigned over = __ballot_sync(live, rank >= l.cap);
  if (rank < l.cap) {
    ws[l.bucket + (long long)row * l.cap + rank] = (int)e;
    return;
  }
  const int first = __ffs(over) - 1;
  int obase = 0;
  if (lane == first) obase = atomicAdd(ws, __popc(over));
  const int o = __shfl_sync(over, obase, first) + __popc(over & below);
  ws[l.over_e + o] = (int)e;
  ws[l.over_r + o] = row;
  if (rank == l.cap) {  // exactly one edge per overflowing row
    const int h = atomicAdd(ws + 1, 1);
    ws[l.heavy_row + h] = row;
    ws[l.hslot + row] = h;
    float* a = reinterpret_cast<float*>(reinterpret_cast<char*>(ws) + l.acc_bytes);
    for (int c = 0; c < C; ++c) a[(long long)h * C + c] = 0.f;  // summed into later
  }
}

// per row: S threads per (row, chunk of kVec channels), neighbouring lanes;
// thread s sums bucket entries s, s + S, ..., then the S partials meet by
// warp shuffles
template <typename T, typename OutT, typename Chunk, int S>
__device__ __forceinline__ void reduce_rows(const T* __restrict__ g, const int* __restrict__ ws,
                                            const Layout& l, OutT* __restrict__ out,
                                            float* __restrict__ acc, int n_rows, int C, int V) {
  constexpr int kVec = sizeof(Chunk) / sizeof(T);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long item = tid / S;
  const int s = (int)(tid % S);
  const bool live = item < (long long)n_rows * V;  // every lane reaches the shuffles
  int r = 0, q = 0, n = 0;
  if (live) {
    r = (int)(item / V);
    q = (int)(item - (long long)r * V);
    n = ws[l.counts + r];
  }
  const int m = min(n, l.cap);
  const int* __restrict__ bucket = ws + l.bucket + (long long)r * l.cap;
  float sum[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) sum[k] = 0.f;
  for (int b0 = s; b0 < m; b0 += S * kBatch) {
    int idx[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) idx[i] = b0 + i * S < m ? bucket[b0 + i * S] : -1;
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
        for (int k = 0; k < kVec; ++k) sum[k] += to_float(v[k]);
      }
    }
  }
#pragma unroll
  for (int off = S / 2; off > 0; off /= 2)
#pragma unroll
    for (int k = 0; k < kVec; ++k) sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], off);
  if (!live || s != 0) return;
  if (n > l.cap) {  // the overflow blocks add the rest; the last block casts
    float* a = acc + (long long)ws[l.hslot + r] * C + q * kVec;
#pragma unroll
    for (int k = 0; k < kVec; ++k) atomicAdd(a + k, sum[k]);
    return;
  }
  OutT* o = out + (long long)r * C + q * kVec;
  if constexpr (std::is_same<OutT, T>::value) {
    Chunk packed;
    OutT* p = reinterpret_cast<OutT*>(&packed);
#pragma unroll
    for (int k = 0; k < kVec; ++k) p[k] = from_float<OutT>(sum[k]);
    *reinterpret_cast<Chunk*>(o) = packed;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) o[k] = from_float<OutT>(sum[k]);
  }
}

// overflow: pieces of kPiece overflow edges, summed per run of equal rows.
// A block's items in one round cover a contiguous stretch of the overflow
// list, which mostly names one row (the padding row): runs that end on the
// row of the stretch's first edge meet in a shared-memory row of C floats,
// which the block then adds into the accumulator once per element; other
// runs add theirs directly. The last block casts the overflowed rows.
template <typename T, typename Chunk>
__device__ __forceinline__ void overflow_rows(const T* __restrict__ g,
                                              const int* __restrict__ ws, const Layout& l,
                                              float* __restrict__ acc, float* row_sum, int C,
                                              int V, int block) {
  constexpr int kVec = sizeof(Chunk) / sizeof(T);
  const int n_over = ws[0];
  const long long items = (long long)((n_over + kPiece - 1) / kPiece) * V;
  const long long stride = (long long)kOverBlocks * kThreads;
  // every thread of a block runs the same rounds: they share row_sum
  for (long long base = (long long)block * kThreads; base < items; base += stride) {
    const int dom = ws[l.over_r + (base / V) * kPiece];  // the stretch's first row
    for (int i = threadIdx.x; i < C; i += kThreads) row_sum[i] = 0.f;
    __syncthreads();
    const long long it = base + threadIdx.x;
    const bool live = it < items;
    const int p = live ? (int)(it / V) : 0, q = live ? (int)(it - (long long)p * V) : 0;
    const int lo = p * kPiece, hi = live ? min(lo + kPiece, n_over) : lo;
    float s[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) s[k] = 0.f;
    int cur = -1;
    for (int b0 = lo; b0 < hi; b0 += kBatch) {
      int idx[kBatch], rows[kBatch];
      Chunk ch[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        idx[i] = b0 + i < hi ? ws[l.over_e + b0 + i] : 0;
        rows[i] = b0 + i < hi ? ws[l.over_r + b0 + i] : -1;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (rows[i] >= 0)
          ch[i] = __ldg(reinterpret_cast<const Chunk*>(g + (long long)idx[i] * C) + q);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (rows[i] < 0) continue;
        if (rows[i] != cur) {
          if (cur >= 0) {
            float* a = acc + (long long)ws[l.hslot + cur] * C + q * kVec;
#pragma unroll
            for (int k = 0; k < kVec; ++k) atomicAdd(a + k, s[k]);
          }
          cur = rows[i];
#pragma unroll
          for (int k = 0; k < kVec; ++k) s[k] = 0.f;
        }
        const T* v = reinterpret_cast<const T*>(&ch[i]);
#pragma unroll
        for (int k = 0; k < kVec; ++k) s[k] += to_float(v[k]);
      }
    }
    if (cur >= 0) {
      float* a = cur == dom ? row_sum + q * kVec
                            : acc + (long long)ws[l.hslot + cur] * C + q * kVec;
#pragma unroll
      for (int k = 0; k < kVec; ++k) atomicAdd(a + k, s[k]);
    }
    __syncthreads();
    float* a = acc + (long long)ws[l.hslot + dom] * C;
    for (int i = threadIdx.x; i < C; i += kThreads)
      if (row_sum[i] != 0.f) atomicAdd(a + i, row_sum[i]);  // adding zero changes nothing
    __syncthreads();
  }
}

// The reduction, one launch: blocks [0, row_blocks) sum the rows' buckets,
// the kOverBlocks after them the overflow list, and the last block to finish
// casts the overflowed rows (their accumulator was zeroed by place).
template <typename T, typename OutT, typename Chunk, int S>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const T* __restrict__ g, int* __restrict__ ws, Layout l,
              OutT* __restrict__ out, float* __restrict__ acc, int n_rows, int C, int V,
              int row_blocks) {
  extern __shared__ float row_sum[];  // [C], the overflow blocks'
  if ((int)blockIdx.x < row_blocks)
    reduce_rows<T, OutT, Chunk, S>(g, ws, l, out, acc, n_rows, C, V);
  else
    overflow_rows<T, Chunk>(g, ws, l, acc, row_sum, C, V, blockIdx.x - row_blocks);
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ws + 2, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n_heavy = ws[1];
  for (long long i = threadIdx.x; i < (long long)n_heavy * C; i += kThreads) {
    const int h = (int)(i / C), c = (int)(i - (long long)h * C);
    out[(long long)ws[l.heavy_row + h] * C + c] = from_float<OutT>(__ldcg(acc + i));
  }
}

template <typename T, typename OutT, typename Chunk, int S>
void launch_reduce(const void* g, void* out, int* ws, const Layout& l, float* acc,
                   int n_rows, int C, int V, cudaStream_t s) {
  const long long threads = (long long)n_rows * V * S;
  const int row_blocks = (int)((threads + kThreads - 1) / kThreads);
  reduce_kernel<T, OutT, Chunk, S><<<(unsigned)(row_blocks + kOverBlocks), kThreads,
                                      C * sizeof(float), s>>>(
      static_cast<const T*>(g), ws, l, static_cast<OutT*>(out), acc, n_rows, C, V,
      row_blocks);
}

template <typename T, typename OutT, typename Chunk>
int launch(const void* g, void* out, int* ws, const Layout& l, long long edges,
           int n_rows, int C, cudaStream_t s) {
  constexpr int kVec = sizeof(Chunk) / sizeof(T);
  const int V = C / kVec;
  float* acc = reinterpret_cast<float*>(reinterpret_cast<char*>(ws) + l.acc_bytes);
  // threads per (row, chunk) from the mean fan-in, so that a thread sums at
  // most l.cap / S <= 32 edges
  const long long fan_in = edges / n_rows;
  if (fan_in <= 16)
    launch_reduce<T, OutT, Chunk, 2>(g, out, ws, l, acc, n_rows, C, V, s);
  else if (fan_in <= 32)
    launch_reduce<T, OutT, Chunk, 4>(g, out, ws, l, acc, n_rows, C, V, s);
  else
    launch_reduce<T, OutT, Chunk, 8>(g, out, ws, l, acc, n_rows, C, V, s);
  return (int)cudaGetLastError();
}

template <typename T, typename OutT>
int launch_for_chunk(int chunk_bytes, const void* g, void* out, int* ws, const Layout& l,
                     long long edges, int n_rows, int C, cudaStream_t s) {
  switch (chunk_bytes) {
    case 16: return launch<T, OutT, uint4>(g, out, ws, l, edges, n_rows, C, s);
    case 8: return launch<T, OutT, uint2>(g, out, ws, l, edges, n_rows, C, s);
    case 4: return launch<T, OutT, uint32_t>(g, out, ws, l, edges, n_rows, C, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch<T, OutT, uint16_t>(g, out, ws, l, edges, n_rows, C, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Edges a row's bucket holds for these sizes; rows with more overflow.
extern "C" int window_scatter_cap(int n_rows, long long edges) {
  return layout(n_rows, edges, 1).cap;
}

// Bytes of the workspace that window_scatter needs for these sizes.
extern "C" long long window_scatter_workspace(int n_rows, long long edges, int C) {
  return layout(n_rows, edges, C).bytes;
}

// g [T, mtk, C] (bf16 if g_bf16, else f32), window_rows [T, wsz] int32,
// localT [T, 1, mtk] int32 -> out [n_rows, C] (bf16 if out_bf16, else f32),
// every row written. workspace: window_scatter_workspace(n_rows, T * mtk, C)
// bytes, 16-byte aligned, contents ignored. chunk_bytes (16, 8, 4, or 2 for
// bf16) divides C * element size and the alignment of g; the wrapper picks
// the widest that does. inverse_only != 0 stops after the place pass (to
// time the inverse alone; out is then not written).
extern "C" int window_scatter(int g_bf16, int out_bf16, const void* g,
                              const void* window_rows, const void* localT, void* out,
                              void* workspace, int T, int mtk, int wsz, int n_rows,
                              int C, int chunk_bytes, int inverse_only, void* stream) {
  if (T < 0 || mtk < 0 || wsz <= 0 || n_rows < 0 || C < 0 || chunk_bytes <= 0 ||
      (C * (g_bf16 ? 2 : 4)) % chunk_bytes != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)n_rows * C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long edges = (long long)T * mtk;
  if (edges >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const Layout l = layout(n_rows, edges, C);
  int* ws = static_cast<int*>(workspace);
  cudaError_t err = cudaMemsetAsync(ws, 0, (kCounters + (size_t)n_rows) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (edges > 0) {
    place_kernel<<<(unsigned)((edges + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        static_cast<const int*>(window_rows), static_cast<const int*>(localT), edges, mtk,
        wsz, n_rows, C, ws, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (inverse_only) return 0;
  if (g_bf16)
    return out_bf16 ? launch_for_chunk<__nv_bfloat16, __nv_bfloat16>(
                          chunk_bytes, g, out, ws, l, edges, n_rows, C, s)
                    : launch_for_chunk<__nv_bfloat16, float>(chunk_bytes, g, out, ws, l,
                                                             edges, n_rows, C, s);
  return out_bf16 ? launch_for_chunk<float, __nv_bfloat16>(chunk_bytes, g, out, ws, l, edges,
                                                           n_rows, C, s)
                  : launch_for_chunk<float, float>(chunk_bytes, g, out, ws, l, edges, n_rows,
                                                   C, s);
}
