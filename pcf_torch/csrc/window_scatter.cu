// Window scatter, the backward of the window resolve:
//
//   dtable[r, :] = sum over tiles t and edges e with
//                  window_rows[t, localT[t, 0, e]] == r  of  g[t, e, :]
//
// for every row r in [0, n_rows); window rows outside that range are dropped
// (jnp's scatter-add mode="drop"), although the forward clamps them. The sum
// runs in f32 and is cast once to the table's type at the end.
//
// Replaces the Pallas kernel pcf_tpu/ops/window.py::_bwd_kernel (launched by
// _scatter_to_windows from _windowed_take_bwd with impl "pallas") together
// with the XLA scatter-add of the per-window sums into the table rows that
// follows it (window.py:462-464).
//
// Why no one-hot product here: the TPU has no scatter, so the Pallas kernel
// summed a tile's cotangents into its window slots with a transposed one-hot
// [Wsz, Mt*K] matrix product on the MXU. The H100 adds into any shared-memory
// word atomically, so this kernel keeps only the two-level sum: per window
// slot in shared memory, then per table row in device memory.
//
// Design: one block per (tile, channel slab). The block zeroes an f32
// accumulator [Wsz, Cb] in shared memory, adds every edge's slice of g into
// its slot with shared-memory atomicAdd (neighbouring threads on neighbouring
// 16-byte chunks of the same cotangent row, so the loads are contiguous),
// then adds each slot whose window row is in range into an f32 table in
// device memory with atomicAdd. A slab keeps the accumulator within a shared
// memory budget that leaves room for two blocks per SM; windows of up to 1280
// slots need more than 48 KB for slabs of 16 channels or more, so the opt-in
// is made on every launch that needs it.
//
// What bounds it on the H100: its shared-memory atomics, one per element of
// g. It reads g once (and the slots and window rows) and writes the f32
// table, but measured at the flagship shapes it runs at about 14x that bytes
// bound, slower in bf16 than in f32 and slower than index_add_ (PERF.md).
// Sorting a tile's edges by slot first, so that a thread sums a run of equal
// slots in registers before one atomic, is the queued fix (PERF.md, open
// questions). Slots whose sum is exactly zero (padding slots, which no edge
// names) skip their device-memory atomic: adding zero changes nothing.
//
// Numerics: the f32 atomics make the order of the sums, in shared memory and
// in device memory, vary from run to run, so two runs may differ in the last
// bits of an f32 sum (and, after the cast, by one bf16 step).
//
// C interface for ctypes: every pointer and the stream are void*; returns the
// first CUDA error of the launches, or 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 96 * 1024;         // two blocks per SM
constexpr int kMaxSmem = 227 * 1024;           // a block's dynamic maximum
constexpr long long kMaxCastBlocks = 132LL * 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// T: cotangent element type; Chunk: the load unit (16, 8, 4 or 2 bytes)
template <typename T, typename Chunk>
__global__ void __launch_bounds__(kThreads)
window_scatter_kernel(const T* __restrict__ g, const int* __restrict__ window_rows,
                      const int* __restrict__ localT, float* __restrict__ dtable,
                      int mtk, int wsz, int n_rows, int C, int cb) {
  constexpr int kVec = sizeof(Chunk) / sizeof(T);
  extern __shared__ float acc[];  // [wsz, cb]
  const int t = blockIdx.x;
  const int c0 = blockIdx.y * cb;
  const int cw = min(cb, C - c0);  // this slab's channels, a multiple of kVec
  const int vecs = cw / kVec;

  for (int i = threadIdx.x; i < wsz * cb; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  // 1. per-slot sums: edge e of tile t adds g[t, e, c0:c0+cw] into its slot
  const T* gt = g + (long long)t * mtk * C + c0;
  const int* lt = localT + (long long)t * mtk;
  for (int i = threadIdx.x; i < mtk * vecs; i += kThreads) {
    const int e = i / vecs, j = i - e * vecs;
    int slot = __ldg(lt + e);
    slot = min(max(slot, 0), wsz - 1);  // as the forward's clamp
    const Chunk chunk = *reinterpret_cast<const Chunk*>(gt + (long long)e * C + j * kVec);
    const T* v = reinterpret_cast<const T*>(&chunk);
    float* a = acc + slot * cb + j * kVec;
#pragma unroll
    for (int k = 0; k < kVec; ++k) atomicAdd(a + k, to_float(v[k]));
  }
  __syncthreads();

  // 2. per-row sums: each in-range slot into its table row
  const int* wr = window_rows + (long long)t * wsz;
  for (int i = threadIdx.x; i < wsz * cw; i += kThreads) {
    const int w = i / cw, c = i - w * cw;
    const float v = acc[w * cb + c];
    const int row = __ldg(wr + w);
    if (v != 0.f && row >= 0 && row < n_rows)
      atomicAdd(dtable + (long long)row * C + c0 + c, v);
  }
}

__global__ void __launch_bounds__(kThreads)
cast_to_bf16_kernel(const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
                    long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = __float2bfloat16(in[i]);
}

// Channels per slab: the widest multiple of vec within the shared-memory
// budget, balanced over the slabs that C needs; 0 if no slab fits.
int slab_channels(int C, int wsz, int vec) {
  int max_cb = kSmemBudget / (wsz * 4) / vec * vec;
  if (max_cb < vec) max_cb = kMaxSmem / (wsz * 4) / vec * vec;
  if (max_cb < vec) return 0;
  const int slabs = (C + max_cb - 1) / max_cb;
  const int per = (C + slabs - 1) / slabs;
  return (per + vec - 1) / vec * vec;
}

template <typename T, typename Chunk>
int launch(const void* g, const void* window_rows, const void* localT,
           float* dtable, int T_, int mtk, int wsz, int n_rows, int C,
           cudaStream_t stream) {
  constexpr int kVec = sizeof(Chunk) / sizeof(T);
  const int cb = slab_channels(C, wsz, kVec);
  if (cb == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)wsz * cb * sizeof(float);
  auto kernel = window_scatter_kernel<T, Chunk>;
  // the opt-in holds for the current device only: made on every launch
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)T_, (unsigned)((C + cb - 1) / cb));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const int*>(window_rows),
      static_cast<const int*>(localT), dtable, mtk, wsz, n_rows, C, cb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_for_chunk(int chunk_bytes, const void* g, const void* window_rows,
                     const void* localT, float* dtable, int T_, int mtk, int wsz,
                     int n_rows, int C, cudaStream_t s) {
  switch (chunk_bytes) {
    case 16:
      return launch<T, uint4>(g, window_rows, localT, dtable, T_, mtk, wsz, n_rows, C, s);
    case 8:
      return launch<T, uint2>(g, window_rows, localT, dtable, T_, mtk, wsz, n_rows, C, s);
    case 4:
      return launch<T, uint32_t>(g, window_rows, localT, dtable, T_, mtk, wsz, n_rows, C, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch<T, uint16_t>(g, window_rows, localT, dtable, T_, mtk, wsz, n_rows, C, s);
      else
        return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// g [T, mtk, C] (bf16 if g_bf16, else f32), window_rows [T, wsz] int32,
// localT [T, 1, mtk] int32 -> dtable_f32 [n_rows, C] (zeroed here, then
// summed into). out_bf16 [n_rows, C] receives the cast when not null.
// chunk_bytes (16, 8, 4, or 2 for bf16) divides C * element size and the
// alignment of g; the wrapper picks the widest that does.
extern "C" int window_scatter(int g_bf16, const void* g, const void* window_rows,
                              const void* localT, void* dtable_f32, void* out_bf16,
                              int T, int mtk, int wsz, int n_rows, int C,
                              int chunk_bytes, void* stream) {
  if (T < 0 || mtk < 0 || wsz <= 0 || n_rows < 0 || C < 0 || chunk_bytes <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_out = (long long)n_rows * C;
  if (n_out == 0) return 0;
  cudaError_t err = cudaMemsetAsync(dtable_f32, 0, n_out * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  float* dtable = static_cast<float*>(dtable_f32);
  if (T > 0 && mtk > 0) {
    const int e = g_bf16 ? launch_for_chunk<__nv_bfloat16>(
                               chunk_bytes, g, window_rows, localT, dtable, T, mtk,
                               wsz, n_rows, C, s)
                         : launch_for_chunk<float>(chunk_bytes, g, window_rows, localT,
                                                   dtable, T, mtk, wsz, n_rows, C, s);
    if (e) return e;
  }
  if (out_bf16 != nullptr) {
    long long blocks = (n_out + kThreads - 1) / kThreads;
    if (blocks > kMaxCastBlocks) blocks = kMaxCastBlocks;
    cast_to_bf16_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        dtable, static_cast<__nv_bfloat16*>(out_bf16), n_out);
    return (int)cudaGetLastError();
  }
  return 0;
}
