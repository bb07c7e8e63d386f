// Kernel C, the fused neighbourhood conv + output linear in its PE form:
//
//   x[m,k,:]  = feats[row(m,k), :] ++ add[m,k,:]  (P >= 0)
//   out[m, o] = b[o] + sum_{c,w} (sum_k x[m,k,c] * v[m,k,w]) * L[c*W + w, o]
//
// Replaces the Pallas kernels of pcf_tpu/ops/pallas/pconv_kernel.py in their
// PE form: _pconv_kernel (launched by _run_fused, plain edges) and
// _make_windowed_kernel (launched by _run_fused_windowed via
// _pconv_pe_linear_win, WindowedEdges). The guided form, kernel B, has its
// own design in pcf_conv_linear.cu. Both index modes are taken here:
//   nei [M, K]                       row(m,k) = nei[m, k]
//   window_rows [T, Wsz], localT     row(m,k) = window_rows[t, localT[t, 0, e]]
//                [T, 1, Mt*K]        with t = m / Mt, e = (m % Mt) * K + k
// Rows are clamped to the table like jnp.take(mode="clip").
//
// What the TPU kernel exists for, and this one keeps: the [M, Ct*W]
// contraction output (Ct = C + P) never reaches device memory. A block
// takes a tile of mt points, gathers their K neighbour rows straight from the
// table (the H100 needs no staged window for that: it loads any row at
// sector granularity), forms the [mt, Ct*W] tile in shared memory, and
// multiplies it by L itself.
//
// What bounds it on the H100: at the flagship shapes, fp32 arithmetic. The
// projection is 2*M*Ct*W*O operations on the CUDA cores (this first version
// uses no tensor cores), and the neighbourhood gather and v/PE tiles
// are read once. The design keeps the gathered rows and the tile out of
// device memory, reuses each L element loaded from L2 for 4 output rows in
// registers, and reads each tile element from shared memory as a warp-wide
// broadcast. Moving the projection onto wgmma is later work.
//
// Numerics follow _contract_and_project (pconv_kernel.py:43-69): the
// K-reduction runs in f32; with bf16 inputs the per-(c, w) partial and L are
// rounded to bf16 before their product, which accumulates in f32. Output f32.
//
// C interface for ctypes: every pointer and the stream are void*; returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;         // output rows per thread, step 4
constexpr int kTile = 16;                 // points per block, halved if needed
constexpr size_t kMaxSmem = 227 * 1024;   // dynamic shared memory per block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Projection multiplicands: bf16 inputs round them to bf16 (exact products).
template <typename T>
__device__ __forceinline__ float mm_round(float x) { return x; }
template <>
__device__ __forceinline__ float mm_round<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

struct Args {
  const void* feats;        // [n_rows, C] T
  const int* nei;           // [M, K] or null (window mode)
  const int* window_rows;   // [T, wsz]
  const int* localT;        // [T, 1, mtk]
  const void* extra;        // add [M, K, E=P]
  const void* v;            // [M, K, W] T
  const float* L;           // [Ct*W, O]
  const float* bias;        // [O]
  float* out;               // [M, O]
  int n_rows, C, wsz, mtk, E, W, O, M, K, mt;
};

template <typename T, int WMAX>
__global__ void __launch_bounds__(kThreads)
fused_conv_linear_kernel(const Args a) {
  extern __shared__ float smem[];
  const T* __restrict__ feats = static_cast<const T*>(a.feats);
  const T* __restrict__ extra = static_cast<const T*>(a.extra);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const int K = a.K, W = a.W, E = a.E, C = a.C, O = a.O;
  const int Ct = C + E;
  const int CtW = Ct * W;
  const int m0 = blockIdx.x * a.mt;
  const int mt = min(a.mt, a.M - m0);
  int* rows = reinterpret_cast<int*>(smem);   // [a.mt, K]
  float* vs = smem + a.mt * K;                // [a.mt, K, W]
  float* es = vs + a.mt * K * W;              // [a.mt, K, E]
  float* S = es + a.mt * K * E;               // [a.mt, Ct*W]
  const int tid = threadIdx.x;

  // 1. the tile's neighbour rows, in either index mode
  const int mtw = a.nei ? 1 : a.mtk / K;  // points per window tile
  for (int i = tid; i < mt * K; i += kThreads) {
    const int m = m0 + i / K, k = i % K;
    int r;
    if (a.nei) {
      r = a.nei[(long long)m * K + k];
    } else {
      const int t = m / mtw;
      int slot = a.localT[(long long)t * a.mtk + (m - t * mtw) * K + k];
      slot = min(max(slot, 0), a.wsz - 1);
      r = a.window_rows[(long long)t * a.wsz + slot];
    }
    rows[i] = min(max(r, 0), a.n_rows - 1);
  }
  // 2. the tile's v and PE rows: contiguous in device memory
  const long long base = (long long)m0 * K;
  for (int i = tid; i < mt * K * W; i += kThreads)
    vs[i] = to_float(v[base * W + i]);
  for (int i = tid; i < mt * K * E; i += kThreads)
    es[i] = to_float(extra[base * E + i]);
  __syncthreads();

  // 3. S[m, c*W + w] = sum_k x[m,k,c] * v[m,k,w]; one (m, c) per thread,
  //    neighbouring threads on neighbouring channels of the same row
  for (int p = tid; p < mt * Ct; p += kThreads) {
    const int m = p / Ct, c = p - m * Ct;
    float acc[WMAX];
#pragma unroll
    for (int w = 0; w < WMAX; ++w) acc[w] = 0.f;
    for (int k = 0; k < K; ++k) {
      const int i = m * K + k;
      const float x = c < C ? to_float(feats[(long long)rows[i] * C + c])
                            : es[i * E + (c - C)];
      const float* vr = vs + i * W;
#pragma unroll
      for (int w = 0; w < WMAX; ++w)
        if (w < W) acc[w] = fmaf(x, vr[w], acc[w]);
    }
    float* s = S + m * CtW + c * W;
#pragma unroll
    for (int w = 0; w < WMAX; ++w)
      if (w < W) s[w] = mm_round<T>(acc[w]);
  }
  __syncthreads();

  // 4. out[m, o] = b[o] + sum_j S[m, j] * L[j, o]; one o and kRowsPerThread
  //    rows per thread, neighbouring threads on neighbouring o. Rows past mt
  //    read allocated shared memory and are never stored.
  const int groups = (mt + kRowsPerThread - 1) / kRowsPerThread;
  for (int q = tid; q < groups * O; q += kThreads) {
    const int g = q / O, o = q - g * O;
    const float* s = S + g * kRowsPerThread * CtW;
    float acc[kRowsPerThread];
    const float b = a.bias[o];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = b;
    for (int j = 0; j < CtW; ++j) {
      const float l = mm_round<T>(__ldg(a.L + (long long)j * O + o));
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        acc[r] = fmaf(s[r * CtW + j], l, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int m = g * kRowsPerThread + r;
      if (m < mt) a.out[(long long)(m0 + m) * O + o] = acc[r];
    }
  }
}

// Dynamic shared memory of a block of mt points: rows, v, PE, tile.
size_t smem_bytes(int mt, int K, int W, int E, int Ct) {
  return sizeof(float) * (size_t)mt * (K * (1 + W + E) + Ct * W);
}

// Points per block: kTile, halved until the block fits; 0 if none fits.
int tile_points(int K, int W, int E, int Ct) {
  int mt = kTile;
  while (mt > kRowsPerThread && smem_bytes(mt, K, W, E, Ct) > kMaxSmem) mt /= 2;
  return smem_bytes(mt, K, W, E, Ct) > kMaxSmem ? 0 : mt;
}

template <typename T, int WMAX>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = fused_conv_linear_kernel<T, WMAX>;
  // The opt-in holds for the current device only, so it is made on every
  // launch above the default 48 KB; it costs far less than the launch.
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (a.M + a.mt - 1) / a.mt;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_for_w(Args a, cudaStream_t stream) {
  const int Ct = a.C + a.E;
  a.mt = tile_points(a.K, a.W, a.E, Ct);
  if (a.mt == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.mt, a.K, a.W, a.E, Ct);
  if (a.W <= 1) return launch<T, 1>(a, smem, stream);
  if (a.W <= 2) return launch<T, 2>(a, smem, stream);
  if (a.W <= 4) return launch<T, 4>(a, smem, stream);
  if (a.W <= 8) return launch<T, 8>(a, smem, stream);
  if (a.W <= 16) return launch<T, 16>(a, smem, stream);
  return (int)cudaErrorInvalidValue;
}

int run(int bf16, const void* feats, int n_rows, int C, const void* nei,
        const void* window_rows, const void* localT, int wsz, int mtk,
        const void* extra, int E, const void* v, int W, const void* L,
        const void* bias, int O, void* out, int M, int K, void* stream) {
  if (M == 0 || O == 0) return 0;
  if (M < 0 || K <= 0 || C <= 0 || W <= 0 || n_rows <= 0 || E < 0 ||
      (nei == nullptr && (wsz <= 0 || mtk <= 0 || mtk % K != 0)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.feats = feats;
  a.nei = static_cast<const int*>(nei);
  a.window_rows = static_cast<const int*>(window_rows);
  a.localT = static_cast<const int*>(localT);
  a.extra = extra;
  a.v = v;
  a.L = static_cast<const float*>(L);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.n_rows = n_rows;
  a.C = C;
  a.wsz = wsz;
  a.mtk = mtk;
  a.E = E;
  a.W = W;
  a.O = O;
  a.M = M;
  a.K = K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_for_w<__nv_bfloat16>(a, s) : launch_for_w<float>(a, s);
}

}  // namespace

// feats, add [M, K, P] (P may be 0) and v share one type: bf16 if bf16 != 0,
// else f32. L [(C+P)*W, O] and bias [O] are f32; out [M, O] f32. nei may be
// null, and then window_rows / localT / wsz / mtk give the rows.
extern "C" int pconv_pe_conv_linear(int bf16, const void* feats, int n_rows,
                                    int C, const void* nei,
                                    const void* window_rows,
                                    const void* localT, int wsz, int mtk,
                                    const void* add, int P, const void* v,
                                    int W, const void* L, const void* bias,
                                    int O, void* out, int M, int K,
                                    void* stream) {
  return run(bf16, feats, n_rows, C, nei, window_rows, localT, wsz, mtk, add, P, v, W,
             L, bias, O, out, M, K, stream);
}

// The launch shape pconv_pe_conv_linear picks for these widths: returns the
// points per block (0: no tile fits) and stores the block's dynamic shared
// memory in *smem.
extern "C" int pconv_fused_tile(int C, int P, int W, int K, long long* smem) {
  const int mt = tile_points(K, W, P, C + P);
  *smem = mt ? (long long)smem_bytes(mt, K, W, P, C + P) : 0;
  return mt;
}
