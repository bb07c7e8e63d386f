// Window resolve: out[t, e, :] = table[window_rows[t, localT[t, 0, e]], :].
//
// Replaces the Pallas kernel pcf_tpu/ops/window.py::_fwd_kernel (launched by
// _resolve, reached through _windowed_take with impl "pallas"), and, through
// the same launch, _fwd_kernel_flat (windowed_take_flat): the row-major
// [T, Mt*K, C] output is, byte for byte, the k-major flat [M, K*C] array.
// The result equals table[nei] bit for bit: it is a row copy.
//
// Why no one-hot product here: the TPU has no fine-grained gather, so the
// Pallas kernel gathered a tile's dedup window into VMEM and resolved the
// edges with a one-hot [Wsz, Mt*K] matrix product on the MXU
// (window.py:274-288). The H100 loads any address at 32-byte sector
// granularity, so each edge simply reads its row.
//
// What bounds it on the H100: bytes. It does no arithmetic; the least time
// is the output written once plus the table, window rows and slots read
// once, over the memory rate. So the design is about bytes in flight and
// about paying the index chain (slot, then window row) once per edge:
//
// - Tile-major grid: block (t, y) takes edges [y*epb, (y+1)*epb) of window
//   tile t; grid.y splits a tile only where T tiles alone would leave SMs
//   idle (the host's launch plan, ops/kernels/window_resolve.py). The tile
//   base is the only 64-bit product; every in-tile index is 32-bit, and
//   nothing divides in 64 bits.
// - Stage: the block loads its slots with 16-byte loads where they are
//   aligned, resolves each through window_rows[t, :] and keeps the clamped
//   table row of every edge in shared memory (4 bytes an edge).
// - Copy, by row width. The block's output is one contiguous byte range.
//   Wide rows (a multiple of 16 bytes, from a 16-byte-aligned table): a
//   group of `lanes` threads per edge copies its row in 16-byte vectors,
//   several a thread when the row is wider than 32 vectors. Narrow rows
//   (12 and 24 bytes of f32 geometry, 6 and 12 of bf16, the f32
//   transposes' 8-byte-aligned rows, and any table view whose address
//   allows less than 16 bytes): consecutive threads store consecutive
//   16-byte chunks of the block's output; a chunk gathers its units (the
//   row's own alignment: 8, 4 or 2 bytes) from the one to eight rows it
//   spans. Unaligned bytes at either end of the range go unit by unit.
//   Either way a thread issues the loads of kUnroll copies before their
//   stores, so that enough bytes are in flight to cover the memory latency.
//   The 16-byte stores stream (st.global.cs, evict-first): the output is
//   not read again here, and it would push the table's rows, read some 16
//   times each, out of L2.
//
// Indices are clamped to the table like jnp.take(mode="clip"); valid
// windows never need the slot clamp, which only keeps a bad slot in bounds.
//
// C interface for ctypes: every pointer and the stream are void*; returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // copies a thread has in flight

__device__ __forceinline__ int resolve(const int* __restrict__ wr, int slot, int wsz,
                                       int n_rows) {
  slot = min(max(slot, 0), wsz - 1);
  return min(max(__ldg(wr + slot), 0), n_rows - 1);
}

// rows[i] = the clamped table row of edge i of the block, i < n. `wr` is
// the tile's window, `lt` the block's first slot.
__device__ __forceinline__ void stage_rows(const int* __restrict__ wr,
                                           const int* __restrict__ lt, int* rows, int n,
                                           int wsz, int n_rows) {
  if ((reinterpret_cast<uintptr_t>(lt) & 15) == 0 && (n & 3) == 0) {
    const int4* lt4 = reinterpret_cast<const int4*>(lt);
    int4* rows4 = reinterpret_cast<int4*>(rows);
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      const int4 s = __ldg(lt4 + i);
      rows4[i] = make_int4(resolve(wr, s.x, wsz, n_rows), resolve(wr, s.y, wsz, n_rows),
                           resolve(wr, s.z, wsz, n_rows), resolve(wr, s.w, wsz, n_rows));
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      rows[i] = resolve(wr, __ldg(lt + i), wsz, n_rows);
  }
}

__global__ void __launch_bounds__(kThreads)
resolve_wide(const uint4* __restrict__ table, const int* __restrict__ window_rows,
             const int* __restrict__ localT, uint4* __restrict__ out, int mtk, int wsz,
             int n_rows, int chunks, int lanes, int epb) {
  extern __shared__ int4 smem[];
  int* rows = reinterpret_cast<int*>(smem);
  const int e0 = blockIdx.y * epb;
  const int n = min(epb, mtk - e0);
  const long long base = (long long)blockIdx.x * mtk + e0;  // the block's first edge
  stage_rows(window_rows + (long long)blockIdx.x * wsz, localT + base, rows, n, wsz,
             n_rows);
  __syncthreads();
  const int tid = threadIdx.x;
  const int per_pass = kThreads / lanes;  // edges copied side by side
  const int slot = tid / lanes;
  const int lane = tid - slot * lanes;
  if (slot >= per_pass) return;
  uint4* o = out + base * chunks;
  for (int e = slot; e < n; e += kUnroll * per_pass) {
    for (int j = lane; j < chunks; j += lanes) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int eu = e + u * per_pass;
        if (eu < n) v[u] = __ldg(table + (long long)rows[eu] * chunks + j);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int eu = e + u * per_pass;
        if (eu < n) __stcs(o + eu * chunks + j, v[u]);
      }
    }
  }
}

// One unit of the block's output at byte `off`.
template <typename Unit>
__device__ __forceinline__ Unit load_unit(const char* __restrict__ table, const int* rows,
                                          int row_bytes, int off) {
  const int e = off / row_bytes;
  return __ldg(reinterpret_cast<const Unit*>(table + (long long)rows[e] * row_bytes +
                                             (off - e * row_bytes)));
}

// The 16-byte chunk of the block's output at byte `off`, unit by unit from
// the rows it spans.
template <typename Unit>
__device__ __forceinline__ uint4 load_chunk(const char* __restrict__ table, const int* rows,
                                            int row_bytes, int off) {
  constexpr int kPer = 16 / sizeof(Unit);
  union {
    uint4 v;
    Unit u[kPer];
  } c;
  int e = off / row_bytes;
  int inner = off - e * row_bytes;
  const char* src = table + (long long)rows[e] * row_bytes;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    c.u[k] = __ldg(reinterpret_cast<const Unit*>(src + inner));
    inner += sizeof(Unit);
    if (k + 1 < kPer && inner == row_bytes) {
      inner = 0;
      src = table + (long long)rows[++e] * row_bytes;
    }
  }
  return c.v;
}

template <typename Unit>
__global__ void __launch_bounds__(kThreads)
resolve_narrow(const char* __restrict__ table, const int* __restrict__ window_rows,
               const int* __restrict__ localT, char* __restrict__ out, int mtk, int wsz,
               int n_rows, int row_bytes, int epb) {
  constexpr int kUnit = sizeof(Unit);
  extern __shared__ int4 smem[];
  int* rows = reinterpret_cast<int*>(smem);
  const int e0 = blockIdx.y * epb;
  const int n = min(epb, mtk - e0);
  const long long base = (long long)blockIdx.x * mtk + e0;
  stage_rows(window_rows + (long long)blockIdx.x * wsz, localT + base, rows, n, wsz,
             n_rows);
  __syncthreads();
  char* o = out + base * row_bytes;
  const int nbytes = n * row_bytes;
  // [0, head) and [tail, nbytes) lie outside the 16-byte-aligned chunks
  const int head = min((int)((16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15), nbytes);
  const int n_chunks = (nbytes - head) / 16;
  const int tail = head + n_chunks * 16;
  const int tid = threadIdx.x;
  if (tid < head / kUnit) {
    const int off = tid * kUnit;
    *reinterpret_cast<Unit*>(o + off) = load_unit<Unit>(table, rows, row_bytes, off);
  } else if (tid >= 32 && tid - 32 < (nbytes - tail) / kUnit) {
    const int off = tail + (tid - 32) * kUnit;
    *reinterpret_cast<Unit*>(o + off) = load_unit<Unit>(table, rows, row_bytes, off);
  }
  uint4* o16 = reinterpret_cast<uint4*>(o + head);
  for (int q = tid; q < n_chunks; q += kUnroll * kThreads) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int qu = q + u * kThreads;
      if (qu < n_chunks) v[u] = load_chunk<Unit>(table, rows, row_bytes, head + qu * 16);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int qu = q + u * kThreads;
      if (qu < n_chunks) __stcs(o16 + qu, v[u]);
    }
  }
}

template <typename Unit>
void launch_narrow(dim3 grid, size_t smem, cudaStream_t s, const void* table,
                   const int* wr, const int* lt, void* out, int mtk, int wsz, int n_rows,
                   int row_bytes, int epb) {
  resolve_narrow<Unit><<<grid, kThreads, smem, s>>>(
      static_cast<const char*>(table), wr, lt, static_cast<char*>(out), mtk, wsz, n_rows,
      row_bytes, epb);
}

}  // namespace

// table [n_rows, row_bytes] (any element type), window_rows [T, wsz] int32,
// localT [T, 1, mtk] int32 -> out [T * mtk, row_bytes], out 16-byte aligned.
// The launch plan comes from the wrapper's launch_plan: wide (nonzero,
// unit 16) or narrow route (unit 8, 4 or 2), the unit dividing row_bytes
// and the table's alignment, lanes per edge (wide route), edges per block
// (epb) and the number of blocks per tile (splits = ceil(mtk / epb)).
extern "C" int window_resolve(const void* table, const void* window_rows,
                              const void* localT, void* out, int T, int mtk, int wsz,
                              int n_rows, int row_bytes, int wide, int unit, int lanes,
                              int epb, int splits, void* stream) {
  if (T == 0 || mtk == 0 || row_bytes == 0) return 0;
  if (T < 0 || mtk < 0 || wsz <= 0 || n_rows <= 0 || row_bytes < 0 || epb <= 0 ||
      splits != (mtk + epb - 1) / epb || splits > 65535 ||
      (long long)epb * row_bytes >= (1LL << 31) || (size_t)epb * 4 > 48 * 1024 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(T, splits);
  const size_t smem = (size_t)epb * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* wr = static_cast<const int*>(window_rows);
  const int* lt = static_cast<const int*>(localT);
  if (unit <= 0 || row_bytes % unit != 0 ||
      (reinterpret_cast<uintptr_t>(table) & (unit - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (wide) {
    if (unit != 16 || lanes <= 0 || lanes > 32) return (int)cudaErrorInvalidValue;
    resolve_wide<<<grid, kThreads, smem, s>>>(static_cast<const uint4*>(table), wr, lt,
                                              static_cast<uint4*>(out), mtk, wsz, n_rows,
                                              row_bytes / 16, lanes, epb);
    return (int)cudaGetLastError();
  }
  switch (unit) {
    case 8:
      launch_narrow<uint2>(grid, smem, s, table, wr, lt, out, mtk, wsz, n_rows, row_bytes,
                           epb);
      break;
    case 4:
      launch_narrow<uint32_t>(grid, smem, s, table, wr, lt, out, mtk, wsz, n_rows,
                              row_bytes, epb);
      break;
    case 2:
      launch_narrow<uint16_t>(grid, smem, s, table, wr, lt, out, mtk, wsz, n_rows,
                              row_bytes, epb);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
