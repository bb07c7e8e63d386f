// Kernels B and C, the fused neighbourhood conv + output linear:
//
//   B (guided)  x[m,k,c] = feats[row(m,k), c] * guid[m,k,c % H]        c < C
//   C (PE)      x[m,k,:] = feats[row(m,k), :] ++ add[m,k,:]            c < Ct = C + P
//   out[m, o] = b[o] + sum_{c,w} (sum_k x[m,k,c] * v[m,k,w]) * L[c*W + w, o]
//
// Replace the Pallas kernels of pcf_tpu/ops/pallas/pconv_kernel.py:
// _make_pcf_kernel and _pconv_kernel (launched by _run_fused, plain edges)
// and _make_windowed_kernel (launched by _run_fused_windowed via
// _pcf_linear_win and _pconv_pe_linear_win, WindowedEdges). C is a template
// mode of B's kernel: the same tile, staging and projection, with the
// channel chunks running over Ct and the PE columns read from `add` in
// place of the guidance modulation. Both index modes are taken here:
//   nei [M, K]                       row(m,k) = nei[m, k]
//   window_rows [T, Wsz], localT     row(m,k) = window_rows[t, localT[t, 0, e]]
//                [T, 1, Mt*K]        with t = m / Mt, e = (m % Mt) * K + k
// Rows are clamped to the table like jnp.take(mode="clip").
//
// What the TPU kernel exists for, and this one keeps: the [M, Ct*W]
// contraction output never reaches device memory.
//
// What bounds it on the H100. In f32, the projection's 2*M*Ct*W*O
// operations on the CUDA cores (F32_TOL excludes TF32); in bf16, the bytes
// it reads (the gathered rows, guidance or PE rows and v). The first designs
// (16 points a block, L streamed from L2 for every block, 4 FMAs per L
// load, bf16 on the CUDA cores) ran B at 14x (f32) and 85x (bf16) that
// bound and C at 12x and 22x. This one (the loop in conv_tile.cuh):
//
//   - takes a tile of 64 points (the mma row count times four warps), an O
//     slice and a range of channel chunks; the grid is (tiles, O slices,
//     chunk ranges), split at the small levels (see split_grid);
//   - loads each point's v rows once into registers (thread (m, w-quad)
//     holds v[m, k, 4q..4q+3] for 16 k);
//   - loops over chunks of CC channels (8 in bf16, 4 in f32): gathers the
//     tile's neighbour rows for the chunk, times the guidance or with the PE
//     columns appended, into shared memory (x, f32); contracts them over K
//     on the CUDA cores in f32; projects the chunk's slice of S against L
//     staged by double-buffered cp.async: bf16 on mma.sync m16n8k16 (S
//     rounded to bf16 as it is stored, L from a bf16 copy the wrapper
//     keeps: exactly the plain version's rounding), f32 on the CUDA cores,
//     register-blocked (16 FMAs per L element read from shared memory).
// The contraction runs on the CUDA cores in f32 in both dtypes: in B,
// x = feats * guid is a product of two bf16 values and not itself a bf16
// value; C's contraction could run on mma (its x is bf16), which is not
// built: the chunk of 8 channels is half an m16 tile.
//
// Deterministic: when several chunk ranges share a tile (blockIdx.z), each
// stores its partial tile in its own f32 slot of a workspace, and a second
// launch (sum_ranges_kernel, one thread per output element) adds the slots
// in range order and then the bias. No float is added with an atomic, so
// two launches on the same inputs give the same bits. (Kernel E's tile's
// last block adds its slots itself; here that serial tail made the split
// calls of B 30% slower at the flagship's coarse levels.)
//
// Numerics follow _contract_and_project (pconv_kernel.py:43-69): the
// K-reduction runs in f32; with bf16 inputs the per-(c, w) partial and L are
// rounded to bf16 before their product, which accumulates in f32. Output f32.
//
// C interface for ctypes: every pointer and the stream are void*; returns
// cudaGetLastError() after the launch.

#include "conv_tile.cuh"

#include <type_traits>

namespace {

using namespace conv_tile;

struct Args {
  const void* feats;        // [n_rows, C] T
  const int* nei;           // [M, K] or null (window mode)
  const int* window_rows;   // [T, wsz]
  const int* localT;        // [T, 1, mtk]
  const void* extra;        // guid [M, K, H] (B) or add [M, K, P] (C), T
  const void* v;            // [M, K, W] T
  const float* bias;        // [O]
  float* out;               // [M, O]
  float* work;              // split ranges: [csplits, M, O] f32 slots
  LView lv;                 // L [Ct*W, O] f32, or [Ct*W, OP] bf16 (OP = O rounded up to 8)
  int n_rows, C, Ct, wsz, mtk, E, W, O, M, K;  // E: H (B) or P (C)
  int ob;                   // O slice width (a multiple of 8 in bf16, of 4 in f32)
  int cpb;                  // channel chunks per block (blockIdx.z: chunk range)
  int vec;                  // feats and extra rows allow 16-byte chunk loads
  int vvec;                 // v rows allow 4-element loads
};

// One output element: stored with the bias, or, when several channel-chunk
// ranges (blockIdx.z) share the tile, into this range's workspace slot.
__device__ __forceinline__ void store_out(const Args& a, long long at, float v, int o) {
  if (gridDim.z > 1)
    __stcg(a.work + blockIdx.z * (long long)a.M * a.O + at, v);
  else
    a.out[at] = v + a.bias[o];
}

// Split chunk ranges: out = bias + the ranges' slots, added in range order.
__global__ void __launch_bounds__(kThreads)
sum_ranges_kernel(const float* __restrict__ work, const float* __restrict__ bias,
                  float* __restrict__ out, long long MO, int O, int Z) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= MO) return;
  float v = 0.f;
  for (int z = 0; z < Z; ++z) v += __ldcg(work + z * MO + i);
  out[i] = v + bias[i % O];
}

// x[m, k, c..c+CC) of edge i = m*K + k of the tile (row: its clamped row),
// zero past Ct:
//   B: feats[row, c] * guid[m, k, c % H]
//   C: feats[row, c] (c < C), add[m, k, c - C] (c < Ct)
// `fast`: 16-byte loads (CC channels of T) on whole chunks.
template <typename T, int CC, bool PE>
__device__ __forceinline__ void load_x(const Args& a, int row, long long edge, int c0, bool fast,
                                       float (&x)[CC]) {
  const T* __restrict__ feats = static_cast<const T*>(a.feats);
  const T* __restrict__ extra = static_cast<const T*>(a.extra);
  const int C = a.C, E = a.E;
  if (fast) {
    const bool from_add = PE && c0 >= C;
    const uint4 f = __ldg(reinterpret_cast<const uint4*>(
        from_add ? extra + edge * E + (c0 - C) : feats + (long long)row * C + c0));
    const T* fv = reinterpret_cast<const T*>(&f);
    if (PE) {
#pragma unroll
      for (int j = 0; j < CC; ++j) x[j] = to_float(fv[j]);
    } else {
      const uint4 gd = __ldg(reinterpret_cast<const uint4*>(extra + edge * E + c0 % E));
      const T* gv = reinterpret_cast<const T*>(&gd);
#pragma unroll
      for (int j = 0; j < CC; ++j) x[j] = to_float(fv[j]) * to_float(gv[j]);
    }
    return;
  }
  const T* fr = feats + (long long)row * C;
  const T* er = extra + edge * E;
#pragma unroll
  for (int j = 0; j < CC; ++j) {
    const int c = c0 + j;
    if (PE)
      x[j] = c < C ? to_float(fr[c]) : c < a.Ct ? to_float(er[c - C]) : 0.f;
    else
      x[j] = c < C ? to_float(fr[c]) * to_float(er[c % E]) : 0.f;
  }
}

// Whether the CC channels from c0 allow load_x's 16-byte loads: B, feats
// and guidance rows; C, a chunk wholly in feats, or wholly in add (with
// C % CC == 0 a chunk past C starts at or after it).
template <int CC, bool PE>
__device__ __forceinline__ bool fast_chunk(const Args& a, int c0) {
  return a.vec && a.C % CC == 0 &&
         (PE ? c0 + CC <= a.C || (a.E % CC == 0 && c0 + CC <= a.Ct) : a.E % CC == 0);
}

// The tile's x for channels [c0, c0 + CC) into xs[m, k*CC + j], zero past mt.
template <typename T, int CC, bool PE>
__device__ __forceinline__ void gather_x(const Args& a, const int* rows, float* xs,
                                         int xs_stride, int m0, int mt, int c0) {
  const int K = a.K;
  const bool fast = fast_chunk<CC, PE>(a, c0);
  for (int i = threadIdx.x; i < kPoints * K; i += kThreads) {
    const int m = i / K, k = i - m * K;
    float x[CC];
    if (m < mt) {
      load_x<T, CC, PE>(a, rows[i], (long long)m0 * K + i, c0, fast, x);
    } else {
#pragma unroll
      for (int j = 0; j < CC; ++j) x[j] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(xs + m * xs_stride + k * CC);
#pragma unroll
    for (int j = 0; j < CC / 4; ++j)
      d[j] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
  }
}

// v[m, kb + k, 4q + i] of thread (m, q) into registers, zero past K, W, mt;
// with W = 1 (the direct mode) every q holds v[m, kb + k, 0].
template <typename T>
__device__ __forceinline__ void load_v(const Args& a, float (&vr)[kKReg][4], int m0, int m,
                                       int mt, int q, int kb) {
  const T* __restrict__ v = static_cast<const T*>(a.v);
  if (a.W == 1) q = 0;
  if (a.vvec) {  // 4 consecutive w: one 16-byte (f32) or 8-byte (bf16) load
    using Quad = typename std::conditional<sizeof(T) == 4, uint4, uint2>::type;
#pragma unroll
    for (int k = 0; k < kKReg; ++k) {
      const bool ok = m < mt && kb + k < a.K && 4 * q < a.W;
      Quad qv = {};
      if (ok)
        qv = __ldg(reinterpret_cast<const Quad*>(
            v + ((long long)(m0 + m) * a.K + kb + k) * a.W + 4 * q));
      const T* e = reinterpret_cast<const T*>(&qv);
#pragma unroll
      for (int i = 0; i < 4; ++i) vr[k][i] = ok ? to_float(e[i]) : 0.f;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kKReg; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int w = 4 * q + i;
      vr[k][i] = (m < mt && kb + k < a.K && w < a.W)
                     ? to_float(v[((long long)(m0 + m) * a.K + kb + k) * a.W + w])
                     : 0.f;
    }
}

// Resolve the tile's neighbour rows, in either index mode, clamped.
__device__ __forceinline__ void tile_rows(const Args& a, int* rows, int m0, int mt) {
  const int K = a.K;
  const int mtw = a.nei ? 1 : a.mtk / K;  // points per window tile
  for (int i = threadIdx.x; i < mt * K; i += kThreads) {
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
}

// NB: n8 tiles per warp (bf16) or the padded O slice (f32)
template <bool BF16, int NB, bool PE>
__global__ void __launch_bounds__(kThreads, 1) conv_linear_kernel(const Args a) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int CC = BF16 ? 8 : 4;
  extern __shared__ __align__(16) char smem[];
  const Smem sm = chunk_layout(BF16, a.K, a.W, BF16 ? 16 * NB : NB, sizeof(int) * kPoints * a.K);
  int* rows = reinterpret_cast<int*>(smem);
  const int m0 = blockIdx.x * kPoints, mt = min(kPoints, a.M - m0);
  const int o0 = blockIdx.y * a.ob, o_end = min(o0 + a.ob, a.O);
  const int m = threadIdx.x % kPoints, q = threadIdx.x / kPoints;
  const int c_lo = blockIdx.z * a.cpb;
  const int CH = chunk_width(BF16, a.W);
  const int c_hi = min(c_lo + a.cpb, (a.Ct + CH - 1) / CH);

  tile_rows(a, rows, m0, mt);
  float vr[kKReg][4];
  if (a.K <= kKReg) load_v<T>(a, vr, m0, m, mt, q, 0);
  __syncthreads();
  auto gather = [&](float* xs, int c0) {
    gather_x<T, CC, PE>(a, rows, xs, sm.xs_stride, m0, mt, c0);
  };
  // the direct mode (W = 1): x from one 16-byte piece of a feature row
  // (C: CC channels wholly in feats), or through load_x
  auto xok = [&](int c0) { return PE && a.vec && a.C % CC == 0 && c0 + CC <= a.C; };
  auto xfast = [&](int mm, int k, int c0, float (&x)[CC]) {
    const uint4 f = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const T*>(a.feats) + (long long)rows[mm * a.K + k] * a.C + c0));
    const T* fv = reinterpret_cast<const T*>(&f);
#pragma unroll
    for (int j = 0; j < CC; ++j) x[j] = to_float(fv[j]);
  };
  auto xload = [&](int mm, int k, int c0, float (&x)[CC]) {
    load_x<T, CC, PE>(a, rows[mm * a.K + k], (long long)(m0 + mm) * a.K + k, c0,
                      fast_chunk<CC, PE>(a, c0), x);
  };
  auto vload = [&](float (&v)[kKReg][4], int kb) { load_v<T>(a, v, m0, m, mt, q, kb); };
  auto store = [&](int r, int o, float v) {
    store_out(a, (long long)(m0 + r) * a.O + o, v, o);
  };
  if constexpr (BF16)
    chunk_loop_bf16<NB>(a.lv, sm, smem, a.K, a.W, mt, o0, o_end, c_lo, c_hi, vr,
                               gather, xok, xfast, xload, vload, store);
  else
    chunk_loop_f32<NB>(a.lv, sm, smem, a.K, a.W, mt, o0, o_end, c_lo, c_hi, vr, gather,
                       xok, xfast, xload, vload, store);
}

// ---- launch shape ---------------------------------------------------------

struct Shape {
  Grid g;
  size_t smem;
  long long work;  // workspace bytes: 0 without split ranges
};

Shape launch_shape(bool bf16, int Ct, int K, int W, int O, int M) {
  Shape s;
  s.g = split_grid(bf16, Ct, W, O, M, bf16 ? kMaxOBf16 : kMaxOF32, 2);
  s.smem = chunk_layout(bf16, K, W, s.g.obp, sizeof(int) * kPoints * K).end;
  s.work = s.g.csplits > 1 ? (long long)sizeof(float) * s.g.csplits * M * O : 0;
  return s;
}

template <typename KernelT>
int launch_kernel(KernelT kernel, const Args& a, const Shape& sh, cudaStream_t stream) {
  // The opt-in holds for the current device only, so it is made on every
  // launch; it costs far less than the launch.
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return (int)err;
  // every block writes the whole of its partial tile: no memset
  kernel<<<dim3(sh.g.tiles, sh.g.splits, sh.g.csplits), kThreads, sh.smem, stream>>>(a);
  if (sh.g.csplits > 1) {
    const long long MO = (long long)a.M * a.O;
    sum_ranges_kernel<<<(unsigned)((MO + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        a.work, a.bias, a.out, MO, a.O, sh.g.csplits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#ifndef PCF_PARTS
#define PCF_PARTS 1
#define PCF_PART 0
#endif

// The kernel's instantiations, (i, BF16, NB), each in both modes (B, and C:
// PE). launch() reaches pair i through conv_linear_launch_<i>, defined in
// translation unit i % PCF_PARTS: build.py compiles this file once per
// part, the parts at once (as one unit it was the longest build); without
// PCF_PARTS the file is one unit holding all of them.
#define CONV_LINEAR_DECLARE(i)                                                          \
  extern "C" int conv_linear_launch_##i(bool pe, const void* args, const void* shape, \
                                        void* stream);
CONV_LINEAR_DECLARE(0) CONV_LINEAR_DECLARE(1) CONV_LINEAR_DECLARE(2) CONV_LINEAR_DECLARE(3)
CONV_LINEAR_DECLARE(4) CONV_LINEAR_DECLARE(5) CONV_LINEAR_DECLARE(6) CONV_LINEAR_DECLARE(7)
CONV_LINEAR_DECLARE(8)
#undef CONV_LINEAR_DECLARE

#define CONV_LINEAR_DEFINE(i, BF16, NB)                                                    \
  extern "C" int conv_linear_launch_##i(bool pe, const void* args, const void* shape,    \
                                        void* stream) {                                  \
    const Args& a = *static_cast<const Args*>(args);                                     \
    const Shape& sh = *static_cast<const Shape*>(shape);                                 \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                  \
    return pe ? launch_kernel(conv_linear_kernel<BF16, NB, true>, a, sh, s)              \
              : launch_kernel(conv_linear_kernel<BF16, NB, false>, a, sh, s);            \
  }
#if 0 % PCF_PARTS == PCF_PART
CONV_LINEAR_DEFINE(0, true, 2)
#endif
#if 1 % PCF_PARTS == PCF_PART
CONV_LINEAR_DEFINE(1, true, 4)
#endif
#if 2 % PCF_PARTS == PCF_PART
CONV_LINEAR_DEFINE(2, true, 6)
#endif
#if 3 % PCF_PARTS == PCF_PART
CONV_LINEAR_DEFINE(3, true, 8)
#endif
#if 4 % PCF_PARTS == PCF_PART
CONV_LINEAR_DEFINE(4, true, 10)
#endif
#if 5 % PCF_PARTS == PCF_PART
CONV_LINEAR_DEFINE(5, false, 32)
#endif
#if 6 % PCF_PARTS == PCF_PART
CONV_LINEAR_DEFINE(6, false, 64)
#endif
#if 7 % PCF_PARTS == PCF_PART
CONV_LINEAR_DEFINE(7, false, 128)
#endif
#if 8 % PCF_PARTS == PCF_PART
CONV_LINEAR_DEFINE(8, false, 256)
#endif
#undef CONV_LINEAR_DEFINE

// the host side: the checks and the entry points (part 0's unit)
#if PCF_PART == 0
namespace {

int launch(bool pe, bool bf16, const Args& a, const Shape& sh, cudaStream_t s) {
  if (bf16) {
    switch (sh.g.nt) {
      case 2: return conv_linear_launch_0(pe, &a, &sh, s);
      case 4: return conv_linear_launch_1(pe, &a, &sh, s);
      case 6: return conv_linear_launch_2(pe, &a, &sh, s);
      case 8: return conv_linear_launch_3(pe, &a, &sh, s);
      case 10: return conv_linear_launch_4(pe, &a, &sh, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (sh.g.obp) {
    case 32: return conv_linear_launch_5(pe, &a, &sh, s);
    case 64: return conv_linear_launch_6(pe, &a, &sh, s);
    case 128: return conv_linear_launch_7(pe, &a, &sh, s);
    case 256: return conv_linear_launch_8(pe, &a, &sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(bool pe, int bf16, const void* feats, int n_rows, int C, const void* nei,
        const void* window_rows, const void* localT, int wsz, int mtk, const void* extra,
        int E, const void* v, int W, const void* L, const void* bias, int O, void* out,
        void* work, long long work_bytes, int M, int K, void* stream) {
  if (M == 0 || O == 0) return 0;
  if (M < 0 || K <= 0 || C <= 0 || W <= 0 || W > 16 || n_rows <= 0 || E < 0 ||
      (!pe && (E <= 0 || C % E != 0)) ||
      (nei == nullptr && (wsz <= 0 || mtk <= 0 || mtk % K != 0)))
    return (int)cudaErrorInvalidValue;
  const int Ct = pe ? C + E : C;
  const Shape sh = launch_shape(bf16 != 0, Ct, K, W, O, M);
  if (sh.smem > kMaxSmem || work_bytes < sh.work || (sh.work > 0 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.feats = feats;
  a.nei = static_cast<const int*>(nei);
  a.window_rows = static_cast<const int*>(window_rows);
  a.localT = static_cast<const int*>(localT);
  a.extra = extra;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.work = static_cast<float*>(work);
  a.lv.L = L;
  a.lv.CW = Ct * W;
  a.lv.W = W;
  a.lv.O = O;
  a.lv.OP = (O + 7) / 8 * 8;
  a.lv.lvec = O % 4 == 0 && reinterpret_cast<uintptr_t>(L) % 16 == 0;
  a.n_rows = n_rows;
  a.C = C;
  a.Ct = Ct;
  a.wsz = wsz;
  a.mtk = mtk;
  a.E = E;
  a.W = W;
  a.O = O;
  a.M = M;
  a.K = K;
  a.ob = sh.g.ob;
  a.cpb = sh.g.cpb;
  a.vec = reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
          (E == 0 || reinterpret_cast<uintptr_t>(extra) % 16 == 0);
  a.vvec = W % 4 == 0 && reinterpret_cast<uintptr_t>(v) % (bf16 ? 8 : 16) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch(pe, bf16 != 0, a, sh, s);
}

}  // namespace

// Kernel B. feats, guidance and v share one type: bf16 if bf16 != 0, else
// f32. L is [C*W, O] f32 for f32 operands and, for bf16 ones, [C*W, OP]
// bf16 (L rounded, columns zero-padded to OP = O rounded up to 8); bias [O]
// f32; out [M, O] f32. nei may be null, and then window_rows / localT / wsz
// / mtk give the rows. W <= 16. work: at least the workspace bytes of
// pcf_conv_linear_shape (work_bytes), may be null when that is 0.
extern "C" int pcf_conv_linear(int bf16, const void* feats, int n_rows, int C,
                               const void* nei, const void* window_rows,
                               const void* localT, int wsz, int mtk,
                               const void* guidance, int H, const void* v, int W,
                               const void* L, const void* bias, int O, void* out,
                               void* work, long long work_bytes, int M, int K,
                               void* stream) {
  return run(false, bf16, feats, n_rows, C, nei, window_rows, localT, wsz, mtk, guidance, H,
             v, W, L, bias, O, out, work, work_bytes, M, K, stream);
}

// Kernel C: as kernel B with add [M, K, P] (P >= 0; may be null if P == 0)
// appended to the gathered rows in place of the guidance; L is
// [(C+P)*W, O] f32 or [(C+P)*W, OP] bf16.
extern "C" int pconv_pe_conv_linear(int bf16, const void* feats, int n_rows, int C,
                                    const void* nei, const void* window_rows,
                                    const void* localT, int wsz, int mtk, const void* add,
                                    int P, const void* v, int W, const void* L,
                                    const void* bias, int O, void* out, void* work,
                                    long long work_bytes, int M, int K, void* stream) {
  return run(true, bf16, feats, n_rows, C, nei, window_rows, localT, wsz, mtk, add, P, v, W,
             L, bias, O, out, work, work_bytes, M, K, stream);
}

// The launch shape of kernel B (Ct = C) or C (Ct = C + P): shape[0..8] =
// points per block, O slices, columns per slice, channel-chunk ranges,
// blocks, dynamic shared memory bytes, threads per block, tensor cores (1:
// the projection on mma.sync m16n8k16 bf16, 0: CUDA cores), workspace
// bytes. The contraction runs on the CUDA cores in both.
extern "C" void pcf_conv_linear_shape(int bf16, int Ct, int K, int W, int O, int M,
                                      long long* shape) {
  const Shape sh = launch_shape(bf16 != 0, Ct, K, W, O, M);
  shape[0] = kPoints;
  shape[1] = sh.g.splits;
  shape[2] = sh.g.ob;
  shape[3] = sh.g.csplits;
  shape[4] = (long long)sh.g.tiles * sh.g.splits * sh.g.csplits;
  shape[5] = (long long)sh.smem;
  shape[6] = kThreads;
  shape[7] = bf16 != 0;
  shape[8] = sh.work;
}
#endif  // PCF_PART == 0
