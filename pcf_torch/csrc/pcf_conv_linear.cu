// Kernel B, the fused guided conv + output linear:
//
//   x[m,k,c]  = feats[row(m,k), c] * guid[m,k,c % H]
//   out[m, o] = b[o] + sum_{c,w} (sum_k x[m,k,c] * v[m,k,w]) * L[c*W + w, o]
//
// Replaces the Pallas kernels of pcf_tpu/ops/pallas/pconv_kernel.py in their
// guided form: _make_pcf_kernel (launched by _run_fused, plain edges) and
// _make_windowed_kernel (launched by _run_fused_windowed via _pcf_linear_win,
// WindowedEdges). Both index modes are taken here:
//   nei [M, K]                       row(m,k) = nei[m, k]
//   window_rows [T, Wsz], localT     row(m,k) = window_rows[t, localT[t, 0, e]]
//                [T, 1, Mt*K]        with t = m / Mt, e = (m % Mt) * K + k
// Rows are clamped to the table like jnp.take(mode="clip").
//
// What the TPU kernel exists for, and this one keeps: the [M, C*W]
// contraction output never reaches device memory.
//
// What bounds it on the H100. In f32, the projection's 2*M*C*W*O operations
// on the CUDA cores (F32_TOL excludes TF32); in bf16, the bytes it reads
// (the gathered rows, guidance and v). The first design (16 points a block,
// L streamed from L2 for every block, 4 FMAs per L load, bf16 on the CUDA
// cores) ran at 14x (f32) and 85x (bf16) that bound. This one:
//
//   - takes a tile of 64 points (the mma row count times four warps), an O
//     slice and a range of channel chunks; the grid is (tiles, O slices,
//     chunk ranges). Small levels (M = 2048 or 512 gives 32 or 8 tiles on
//     132 SMs) split the chunks (at least 2 a block; the ranges add their
//     partial outputs into a zeroed output with f32 atomics), then O (down
//     to 32 columns, which repeats the contraction), up to a block per SM;
//   - loads each point's v rows once into registers (thread (m, w-quad)
//     holds v[m, k, 4q..4q+3] for 16 k);
//   - loops over chunks of CC channels (8 in bf16, 4 in f32): gathers the
//     tile's neighbour rows for the chunk, times the guidance, into shared
//     memory (x, f32); contracts them over K on the CUDA cores in f32 into
//     the chunk's slice of S [64, CC*W]; multiplies that slice by the
//     matching CC*W rows of L and accumulates out [64, O slice] in
//     registers across chunks;
//   - stages L once per tile: the next chunk's rows of L come into shared
//     memory by cp.async, double-buffered, while this chunk is gathered,
//     contracted and multiplied;
//   - bf16: the projection runs on the tensor cores, mma.sync m16n8k16 with
//     bf16 operands and f32 accumulation (S rounded to bf16 as it is stored,
//     L from a bf16 copy the wrapper keeps): exactly the plain version's
//     rounding. Each of the 8 warps owns 16 points x half the O slice;
//   - f32: the projection stays on the CUDA cores, register-blocked: a
//     thread owns 16 points x 4 adjacent columns, so each L element read
//     from shared memory feeds 16 FMAs and each S element 4 (5 16-byte
//     loads per 64 FMAs). A block's 64 x O-slice tile needs O-slice such
//     threads; the rest split the chunk's rows and add up at the end.
// The contraction runs on the CUDA cores in f32 in both dtypes: x = feats *
// guid is a product of two bf16 values and not itself a bf16 value.
//
// Numerics follow _contract_and_project (pconv_kernel.py:43-69): the
// K-reduction runs in f32; with bf16 inputs the per-(c, w) partial and L are
// rounded to bf16 before their product, which accumulates in f32. Output f32.
//
// C interface for ctypes: every pointer and the stream are void*; returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 64;               // points per block
constexpr int kKReg = 16;                 // neighbours whose v a thread holds
constexpr int kSMs = 132;                 // the grid aims at a block per SM
constexpr int kMinSlice = 32;             // narrowest O slice
constexpr int kMaxOBf16 = 160;            // widest O slice: 2 halves x 10 n8 tiles
constexpr int kMaxOF32 = 256;             // 64 projection tiles of 4 columns
constexpr size_t kMaxSmem = 227 * 1024;   // dynamic shared memory per block

struct Args {
  const void* feats;        // [n_rows, C] T
  const int* nei;           // [M, K] or null (window mode)
  const int* window_rows;   // [T, wsz]
  const int* localT;        // [T, 1, mtk]
  const void* guid;         // [M, K, H] T
  const void* v;            // [M, K, W] T
  const void* L;            // [C*W, O] f32, or [C*W, OP] bf16 (OP = O rounded up to 8)
  const float* bias;        // [O]
  float* out;               // [M, O]
  int n_rows, C, wsz, mtk, H, W, O, OP, M, K;
  int ob;                   // O slice width (a multiple of 8 in bf16, of 4 in f32)
  int cpb;                  // channel chunks per block (blockIdx.z: chunk range)
  int vec;                  // feats and guid rows allow 16-byte chunk loads
  int lvec;                 // f32 L rows allow 16-byte cp.async
  int vvec;                 // v rows allow 4-element loads
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Layout of a block's dynamic shared memory (bytes), for CC channels a chunk
// and J = CC*W chunk columns (JP: J rounded up to the mma depth in bf16).
struct Smem {
  int xs_stride;     // floats per point of the x tile: K*CC + 4 (bank offset)
  int jp;            // S / L rows per chunk
  int s_stride;      // bf16: elements per S row (jp + 8); f32: points (64)
  int l_stride;      // elements per staged L row
  size_t rows, xs, s, l, total;
};

__host__ __device__ Smem smem_layout(bool bf16, int K, int W, int obp) {
  Smem s;
  const int cc = bf16 ? 8 : 4;
  s.xs_stride = K * cc + 4;
  const int j = cc * W;
  s.jp = bf16 ? (j + 15) / 16 * 16 : j;
  s.s_stride = bf16 ? s.jp + 8 : kPoints;
  s.l_stride = bf16 ? obp + 8 : obp;
  s.rows = 0;
  s.xs = s.rows + sizeof(int) * kPoints * K;
  s.s = s.xs + sizeof(float) * kPoints * s.xs_stride;
  s.l = s.s + (bf16 ? 2 * (size_t)kPoints * s.s_stride : 4 * (size_t)s.jp * kPoints);
  s.total = s.l + 2 * (size_t)(bf16 ? 2 : 4) * s.jp * s.l_stride;
  // f32: the partial tiles of the 256 projection threads, 64 floats each,
  // reuse the space from xs on
  if (!bf16) s.total = s.total > s.xs + 65536 ? s.total : s.xs + 65536;
  return s;
}

// Stage rows [c0*W, c0*W + jp) x columns [o0, o0 + width) of L into `dst`
// (jp x l_stride), zero-filling rows past C*W and columns past the slice.
template <bool BF16>
__device__ __forceinline__ void stage_L(const Args& a, const Smem& sm, char* dst, int c0,
                                        int o0, int o_end, int width) {
  const int CW = a.C * a.W;
  const int cc = BF16 ? 8 : 4;
  const int j_end = min(cc * a.W, CW - c0 * a.W);  // valid rows of this chunk
  if (BF16) {
    const __nv_bfloat16* L = static_cast<const __nv_bfloat16*>(a.L);
    __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
    const int segs = width / 8;  // 16-byte segments per row
    const int op_end = min(o_end + 7, a.OP) / 8 * 8;  // padded copy: whole segments
    for (int i = threadIdx.x; i < sm.jp * segs; i += kThreads) {
      const int j = i / segs, sg = i - j * segs;
      const int col = o0 + sg * 8;
      const bool ok = j < j_end && col < op_end;
      const __nv_bfloat16* src = ok ? L + (long long)(c0 * a.W + j) * a.OP + col : L;
      cp_async16(d + j * sm.l_stride + sg * 8, src, ok ? 16 : 0);
    }
  } else {
    const float* L = static_cast<const float*>(a.L);
    float* d = reinterpret_cast<float*>(dst);
    if (a.lvec) {
      const int segs = width / 4;
      for (int i = threadIdx.x; i < sm.jp * segs; i += kThreads) {
        const int j = i / segs, sg = i - j * segs;
        const int col = o0 + sg * 4;
        const bool ok = j < j_end && col < o_end;
        const float* src = ok ? L + (long long)(c0 * a.W + j) * a.O + col : L;
        cp_async16(d + j * sm.l_stride + sg * 4, src, ok ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < sm.jp * width; i += kThreads) {
        const int j = i / width, c = i - j * width;
        const bool ok = j < j_end && o0 + c < o_end;
        const float* src = ok ? L + (long long)(c0 * a.W + j) * a.O + o0 + c : L;
        cp_async4(d + j * sm.l_stride + c, src, ok ? 4 : 0);
      }
    }
  }
  cp_async_commit();
}

// One output element: stored, or added when several channel-chunk ranges
// (blockIdx.z) share the tile; the first range adds the bias.
__device__ __forceinline__ void store_out(const Args& a, long long at, float v, int o) {
  if (blockIdx.z == 0) v += a.bias[o];
  if (gridDim.z > 1)
    atomicAdd(a.out + at, v);
  else
    a.out[at] = v;
}

// 16-byte loads of feats and guidance rows: CC channels of T are 16 bytes
// (4 f32, 8 bf16), and the rows and heads fall on whole chunks
template <int CC>
__device__ __forceinline__ bool fast_rows(const Args& a) {
  return a.vec && a.C % CC == 0 && a.H % CC == 0;
}

// The tile's x for channels [c0, c0 + CC): xs[m, k*CC + j] =
// feats[row(m,k), c0+j] * guid[m, k, (c0+j) % H], zero past C and past mt.
template <typename T, int CC>
__device__ __forceinline__ void gather_x(const Args& a, const int* rows, float* xs,
                                         int xs_stride, int m0, int mt, int c0) {
  const T* __restrict__ feats = static_cast<const T*>(a.feats);
  const T* __restrict__ guid = static_cast<const T*>(a.guid);
  const int K = a.K, C = a.C, H = a.H;
  const bool fast = fast_rows<CC>(a);
  for (int i = threadIdx.x; i < kPoints * K; i += kThreads) {
    const int m = i / K, k = i - m * K;
    float x[CC];
    if (m >= mt) {
#pragma unroll
      for (int j = 0; j < CC; ++j) x[j] = 0.f;
    } else if (fast) {
      const uint4 f = __ldg(reinterpret_cast<const uint4*>(feats + (long long)rows[i] * C + c0));
      const uint4 gd = __ldg(reinterpret_cast<const uint4*>(
          guid + ((long long)(m0 + m) * K + k) * H + c0 % H));
      const T* fv = reinterpret_cast<const T*>(&f);
      const T* gv = reinterpret_cast<const T*>(&gd);
#pragma unroll
      for (int j = 0; j < CC; ++j) x[j] = to_float(fv[j]) * to_float(gv[j]);
    } else {
      const T* fr = feats + (long long)rows[i] * C;
      const T* gr = guid + ((long long)(m0 + m) * K + k) * H;
#pragma unroll
      for (int j = 0; j < CC; ++j) {
        const int c = c0 + j;
        x[j] = c < C ? to_float(fr[c]) * to_float(gr[c % H]) : 0.f;
      }
    }
    float4* d = reinterpret_cast<float4*>(xs + m * xs_stride + k * CC);
#pragma unroll
    for (int j = 0; j < CC / 4; ++j)
      d[j] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
  }
}

// v[m, kb + k, 4q + i] of thread (m, q) into registers, zero past K, W, mt
template <typename T>
__device__ __forceinline__ void load_v(const Args& a, float (&vr)[kKReg][4], int m0, int m,
                                       int mt, int q, int kb) {
  const T* __restrict__ v = static_cast<const T*>(a.v);
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

// S chunk columns of thread (m, q) for CC channels: s[j][i] = sum_k x * v
template <typename T, int CC>
__device__ __forceinline__ void contract(const Args& a, const float* xs, int xs_stride,
                                         float (&vr)[kKReg][4], float (&s)[CC][4], int m,
                                         int q, int m0, int mt) {
#pragma unroll
  for (int j = 0; j < CC; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
  for (int kb = 0; kb < a.K; kb += kKReg) {
    if (a.K > kKReg) load_v<T>(a, vr, m0, m, mt, q, kb);  // never on the flagship
#pragma unroll
    for (int k = 0; k < kKReg; ++k) {
      if (kb + k >= a.K) break;
      const float4* xr = reinterpret_cast<const float4*>(xs + m * xs_stride + (kb + k) * CC);
#pragma unroll
      for (int j4 = 0; j4 < CC / 4; ++j4) {
        const float4 x4 = xr[j4];
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[4 * j4 + jj][i] = fmaf(xv[jj], vr[k][i], s[4 * j4 + jj][i]);
      }
    }
  }
}

// ---- bf16: the projection on the tensor cores ------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT: n8 tiles per warp; the O slice is 2 * NT * 8 columns wide (padded)
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
pcf_conv_linear_bf16_kernel(const Args a) {
  constexpr int CC = 8;
  constexpr int OBP = 16 * NT;
  extern __shared__ __align__(16) char smem[];
  const Smem sm = smem_layout(true, a.K, a.W, OBP);
  int* rows = reinterpret_cast<int*>(smem + sm.rows);
  float* xs = reinterpret_cast<float*>(smem + sm.xs);
  __nv_bfloat16* S = reinterpret_cast<__nv_bfloat16*>(smem + sm.s);
  char* Lbuf = smem + sm.l;
  const size_t lbytes = (size_t)2 * sm.jp * sm.l_stride;
  const int m0 = blockIdx.x * kPoints, mt = min(kPoints, a.M - m0);
  const int o0 = blockIdx.y * a.ob, o_end = min(o0 + a.ob, a.O);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = tid % kPoints, q = tid / kPoints;  // contraction: point, w-quad
  const int c_lo = blockIdx.z * a.cpb;
  const int c_hi = min(c_lo + a.cpb, (a.C + CC - 1) / CC);

  stage_L<true>(a, sm, Lbuf, c_lo * CC, o0, o_end, OBP);
  tile_rows(a, rows, m0, mt);
  // S columns past J are never written: zero them once
  for (int i = tid; i < kPoints * (sm.jp - CC * a.W); i += kThreads) {
    const int r = i / (sm.jp - CC * a.W), c = CC * a.W + i % (sm.jp - CC * a.W);
    S[r * sm.s_stride + c] = __float2bfloat16(0.f);
  }
  float vr[kKReg][4];
  if (a.K <= kKReg) load_v<__nv_bfloat16>(a, vr, m0, m, mt, q, 0);
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
  const int mrow = (warp & 3) * 16, nbase = (warp >> 2) * NT * 8;
  __syncthreads();

  gather_x<__nv_bfloat16, CC>(a, rows, xs, sm.xs_stride, m0, mt, c_lo * CC);
  for (int ci = c_lo; ci < c_hi; ++ci) {
    const bool next = ci + 1 < c_hi;
    __syncthreads();  // xs holds chunk ci; the last projection is done
    if (next)  // buffers alternate from the range's first chunk, in buffer 0
      stage_L<true>(a, sm, Lbuf + ((ci + 1 - c_lo) & 1) * lbytes, (ci + 1) * CC, o0, o_end,
                    OBP);
    float s[CC][4];
    contract<__nv_bfloat16, CC>(a, xs, sm.xs_stride, vr, s, m, q, m0, mt);
#pragma unroll
    for (int j = 0; j < CC; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w = 4 * q + i;
        if (w < a.W) S[m * sm.s_stride + j * a.W + w] = __float2bfloat16(s[j][i]);
      }
    if (next) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const __nv_bfloat16* Lc =
        reinterpret_cast<const __nv_bfloat16*>(Lbuf + ((ci - c_lo) & 1) * lbytes);
    for (int kk = 0; kk < sm.jp; kk += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, S + (mrow + (lane & 15)) * sm.s_stride + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, Lc + (kk + (lane & 15)) * sm.l_stride + nbase + np * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    // xs was last read by this chunk's contraction, before the sync
    if (next) gather_x<__nv_bfloat16, CC>(a, rows, xs, sm.xs_stride, m0, mt, (ci + 1) * CC);
  }

  // accumulator (t, i): row mrow + lane/4 (+8 for i >= 2), column
  // nbase + 8t + 2*(lane%4) + (i & 1)
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = mrow + (lane >> 2) + (i >> 1) * 8;
      const int o = o0 + nbase + t * 8 + (lane & 3) * 2 + (i & 1);
      if (r < mt && o < o_end) store_out(a, (long long)(m0 + r) * a.O + o, acc[t][i], o);
    }
}

// ---- f32: the projection on the CUDA cores, register-blocked ----------------

// OBP: the O slice padded to a power of two (32 to 256). A projection thread
// owns 16 points x 4 adjacent columns; the 4 * OBP / 4 = OBP such tiles of a
// block take OBP threads, so the 256 threads split the chunk's rows j of S
// and L SK = 256 / OBP ways and add their partial tiles at the end.
template <int OBP>
__global__ void __launch_bounds__(kThreads, 1)
pcf_conv_linear_f32_kernel(const Args a) {
  constexpr int CC = 4;
  constexpr int PM = 16;              // points per projection thread
  constexpr int SK = kThreads / OBP;  // ways the rows of a chunk are split
  extern __shared__ __align__(16) char smem[];
  const Smem sm = smem_layout(false, a.K, a.W, OBP);
  int* rows = reinterpret_cast<int*>(smem + sm.rows);
  float* xs = reinterpret_cast<float*>(smem + sm.xs);
  float* S = reinterpret_cast<float*>(smem + sm.s);  // [J, 64], transposed
  char* Lbuf = smem + sm.l;
  const size_t lbytes = (size_t)4 * sm.jp * sm.l_stride;
  const int m0 = blockIdx.x * kPoints, mt = min(kPoints, a.M - m0);
  const int o0 = blockIdx.y * a.ob, o_end = min(o0 + a.ob, a.O);
  const int tid = threadIdx.x;
  const int m = tid % kPoints, q = tid / kPoints;  // contraction: point, w-quad
  const int sk = tid / OBP, tile = tid % OBP;      // projection: row split, tile
  const int mg = tile / (OBP / 4), cq = tile % (OBP / 4);
  const int c_lo = blockIdx.z * a.cpb;
  const int c_hi = min(c_lo + a.cpb, (a.C + CC - 1) / CC);
  const int J = CC * a.W;

  stage_L<false>(a, sm, Lbuf, c_lo * CC, o0, o_end, OBP);
  tile_rows(a, rows, m0, mt);
  float vr[kKReg][4];
  if (a.K <= kKReg) load_v<float>(a, vr, m0, m, mt, q, 0);
  float acc[PM][4];
#pragma unroll
  for (int p = 0; p < PM; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[p][i] = 0.f;
  __syncthreads();

  gather_x<float, CC>(a, rows, xs, sm.xs_stride, m0, mt, c_lo * CC);
  for (int ci = c_lo; ci < c_hi; ++ci) {
    const bool next = ci + 1 < c_hi;
    __syncthreads();  // xs holds chunk ci; the last projection is done
    if (next)  // buffers alternate from the range's first chunk, in buffer 0
      stage_L<false>(a, sm, Lbuf + ((ci + 1 - c_lo) & 1) * lbytes, (ci + 1) * CC, o0, o_end,
                    OBP);
    float s[CC][4];
    contract<float, CC>(a, xs, sm.xs_stride, vr, s, m, q, m0, mt);
#pragma unroll
    for (int j = 0; j < CC; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w = 4 * q + i;
        if (w < a.W) S[(j * a.W + w) * kPoints + m] = s[j][i];
      }
    if (next) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const float* Lc = reinterpret_cast<const float*>(Lbuf + ((ci - c_lo) & 1) * lbytes);
    for (int j = sk; j < J; j += SK) {
      const float4* sr = reinterpret_cast<const float4*>(S + j * kPoints + mg * PM);
      const float4 l4 = *reinterpret_cast<const float4*>(Lc + j * sm.l_stride + cq * 4);
      const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int p4 = 0; p4 < PM / 4; ++p4) {
        const float4 s4 = sr[p4];
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int pp = 0; pp < 4; ++pp)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[4 * p4 + pp][i] = fmaf(sv[pp], lv[i], acc[4 * p4 + pp][i]);
      }
    }
    // xs was last read by this chunk's contraction, before the sync
    if (next) gather_x<float, CC>(a, rows, xs, sm.xs_stride, m0, mt, (ci + 1) * CC);
  }

  // the SK partial tiles meet in shared memory (xs, S and L are free now)
  __syncthreads();
  float* red = xs;  // [SK, 64, OBP]
#pragma unroll
  for (int p = 0; p < PM; ++p)
    *reinterpret_cast<float4*>(red + ((size_t)sk * kPoints + mg * PM + p) * OBP + cq * 4) =
        make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
  __syncthreads();
  for (int i = tid; i < kPoints * OBP; i += kThreads) {
    const int r = i / OBP, c = i % OBP, o = o0 + c;
    if (r >= mt || o >= o_end) continue;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < SK; ++k) v += red[(size_t)k * kPoints * OBP + i];
    store_out(a, (long long)(m0 + r) * a.O + o, v, o);
  }
}

// ---- launch shape ---------------------------------------------------------

struct Shape {
  int tiles, splits, ob, obp, n_groups;  // n_groups: NT (bf16)
  int csplits, cpb;                      // channel-chunk ranges, chunks per range
  size_t smem;
};

Shape launch_shape(bool bf16, int C, int K, int W, int O, int M) {
  Shape s;
  s.tiles = (M + kPoints - 1) / kPoints;
  const int max_ob = bf16 ? kMaxOBf16 : kMaxOF32;
  const int align = bf16 ? 8 : 4;
  const int chunks = (C + (bf16 ? 8 : 4) - 1) / (bf16 ? 8 : 4);
  int splits = (O + max_ob - 1) / max_ob, csplits = 1;
  // Small levels: more blocks, up to one per SM. Splitting the channel
  // chunks first shortens each block's chain of chunks and repeats nothing
  // (the blocks add their partial outputs); splitting O repeats the
  // contraction. At least 2 chunks a block, at least kMinSlice columns.
  for (;;) {
    const long long blocks = (long long)s.tiles * splits;
    if (blocks * (csplits + 1) <= kSMs && chunks / (csplits + 1) >= 2)
      ++csplits;
    else if (s.tiles * (long long)(splits + 1) * csplits <= kSMs &&
             (O + splits) / (splits + 1) >= kMinSlice)
      ++splits;
    else
      break;
  }
  s.cpb = (chunks + csplits - 1) / csplits;
  s.csplits = (chunks + s.cpb - 1) / s.cpb;
  s.ob = ((O + splits - 1) / splits + align - 1) / align * align;
  s.splits = (O + s.ob - 1) / s.ob;
  if (bf16) {
    s.obp = (s.ob + 31) / 32 * 32;
    s.n_groups = s.obp / 16;
  } else {
    s.obp = kMinSlice;
    while (s.obp < s.ob) s.obp *= 2;
    s.n_groups = 0;
  }
  s.smem = smem_layout(bf16, K, W, s.obp).total;
  return s;
}

template <typename KernelT>
int launch_kernel(KernelT kernel, const Args& a, const Shape& sh, cudaStream_t stream) {
  // The opt-in holds for the current device only, so it is made on every
  // launch; it costs far less than the launch.
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return (int)err;
  if (sh.csplits > 1) {  // the chunk ranges add into a zeroed output
    const cudaError_t e = cudaMemsetAsync(a.out, 0, sizeof(float) * (size_t)a.M * a.O, stream);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(sh.tiles, sh.splits, sh.csplits), kThreads, sh.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch(bool bf16, const Args& a, const Shape& sh, cudaStream_t s) {
  if (bf16) {
    switch (sh.n_groups) {
      case 2: return launch_kernel(pcf_conv_linear_bf16_kernel<2>, a, sh, s);
      case 4: return launch_kernel(pcf_conv_linear_bf16_kernel<4>, a, sh, s);
      case 6: return launch_kernel(pcf_conv_linear_bf16_kernel<6>, a, sh, s);
      case 8: return launch_kernel(pcf_conv_linear_bf16_kernel<8>, a, sh, s);
      case 10: return launch_kernel(pcf_conv_linear_bf16_kernel<10>, a, sh, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (sh.obp) {
    case 32: return launch_kernel(pcf_conv_linear_f32_kernel<32>, a, sh, s);
    case 64: return launch_kernel(pcf_conv_linear_f32_kernel<64>, a, sh, s);
    case 128: return launch_kernel(pcf_conv_linear_f32_kernel<128>, a, sh, s);
    case 256: return launch_kernel(pcf_conv_linear_f32_kernel<256>, a, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// feats, guidance and v share one type: bf16 if bf16 != 0, else f32. L is
// [C*W, O] f32 for f32 operands and, for bf16 ones, [C*W, OP] bf16 (L
// rounded, columns zero-padded to OP = O rounded up to 8); bias [O] f32;
// out [M, O] f32. nei may be null, and then window_rows / localT / wsz /
// mtk give the rows. W <= 16.
extern "C" int pcf_conv_linear(int bf16, const void* feats, int n_rows, int C,
                               const void* nei, const void* window_rows,
                               const void* localT, int wsz, int mtk,
                               const void* guidance, int H, const void* v, int W,
                               const void* L, const void* bias, int O, void* out,
                               int M, int K, void* stream) {
  if (M == 0 || O == 0) return 0;
  if (M < 0 || K <= 0 || C <= 0 || W <= 0 || W > 16 || n_rows <= 0 || H <= 0 ||
      C % H != 0 || (nei == nullptr && (wsz <= 0 || mtk <= 0 || mtk % K != 0)))
    return (int)cudaErrorInvalidValue;
  const Shape sh = launch_shape(bf16 != 0, C, K, W, O, M);
  if (sh.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  Args a;
  a.feats = feats;
  a.nei = static_cast<const int*>(nei);
  a.window_rows = static_cast<const int*>(window_rows);
  a.localT = static_cast<const int*>(localT);
  a.guid = guidance;
  a.v = v;
  a.L = L;
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.n_rows = n_rows;
  a.C = C;
  a.wsz = wsz;
  a.mtk = mtk;
  a.H = H;
  a.W = W;
  a.O = O;
  a.OP = (O + 7) / 8 * 8;
  a.M = M;
  a.K = K;
  a.ob = sh.ob;
  a.cpb = sh.cpb;
  a.vec = reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(guidance) % 16 == 0;
  a.lvec = O % 4 == 0 && reinterpret_cast<uintptr_t>(L) % 16 == 0;
  a.vvec = W % 4 == 0 && reinterpret_cast<uintptr_t>(v) % (bf16 ? 8 : 16) == 0;
  return launch(bf16 != 0, a, sh, static_cast<cudaStream_t>(stream));
}

// The launch shape pcf_conv_linear picks: shape[0..7] = points per block,
// O slices, columns per slice, channel-chunk ranges, blocks, dynamic shared
// memory bytes, threads per block, tensor cores (1: mma.sync m16n8k16 bf16,
// 0: CUDA cores).
extern "C" void pcf_conv_linear_shape(int bf16, int C, int K, int W, int O, int M,
                                      long long* shape) {
  const Shape sh = launch_shape(bf16 != 0, C, K, W, O, M);
  shape[0] = kPoints;
  shape[1] = sh.splits;
  shape[2] = sh.ob;
  shape[3] = sh.csplits;
  shape[4] = (long long)sh.tiles * sh.splits * sh.csplits;
  shape[5] = (long long)sh.smem;
  shape[6] = kThreads;
  shape[7] = bf16 != 0;
}
