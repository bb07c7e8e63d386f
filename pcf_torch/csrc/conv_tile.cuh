// The channel-chunk loop of the fused conv + output linear, shared by
// kernels B and C (pcf_conv_linear.cu) and kernel E (layer_eval.cu).
//
// A block of kThreads threads takes a tile of kPoints points, an O slice
// [o0, o_end) and a range [c_lo, c_hi) of chunks of CC channels. Before the
// loop, thread (m, q) = (tid % 64, tid / 64) holds v[m, k, 4q..4q+3] of its
// point for kKReg neighbours in registers. For each chunk the caller's
// gather writes the tile's x [64, K, CC] (f32) to shared memory; the loop
// contracts it over K on the CUDA cores into the chunk's slice of
// S [64, CC*W] and multiplies that slice by the matching CC*W rows of L,
// accumulating out [64, O slice] in registers. The next chunk's rows of L
// come into shared memory by cp.async, double-buffered, while this chunk is
// gathered, contracted and multiplied.
//
//   bf16: CC = 8; the projection on the tensor cores, mma.sync m16n8k16
//         with bf16 operands and f32 accumulation (S rounded to bf16 as it
//         is stored, L from a bf16 copy [Ct*W, OP]); each of the 8 warps
//         owns 16 points x half the O slice.
//   f32:  CC = 4; the projection on the CUDA cores, register-blocked: a
//         thread owns 16 points x 4 adjacent columns, so each L element
//         read from shared memory feeds 16 FMAs. The 64 x O-slice tile
//         needs O-slice such threads; the rest split the chunk's rows and
//         add their partial tiles at the end.
//
// W = 1 layers (the decoder's transposes) take the direct mode: a chunk
// holds 4*CC channels, thread (m, q) contracts channels q*CC.. of it,
// reading x through the caller's xload (see contract_direct) straight from
// device or shared memory, with no x tile and no gather pass (a chunk of CC channels
// at W = 1 would give the projection 4 or 8 rows a chunk).
//
// The caller stores each output element through its own store(r, o, v).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace conv_tile {

constexpr int kThreads = 256;
constexpr int kPoints = 64;               // points per block
constexpr int kKReg = 16;                 // neighbours whose v a thread holds
constexpr int kSMs = 132;                 // the grid aims at a block per SM
constexpr int kMinSlice = 32;             // narrowest O slice
constexpr int kMaxOBf16 = 160;            // widest O slice: 2 halves x 10 n8 tiles
constexpr int kMaxOF32 = 256;             // 64 projection tiles of 4 columns
constexpr size_t kMaxSmem = 227 * 1024;   // dynamic shared memory per block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
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
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

// L as the loop stages it: rows [CW = Ct*W], f32 [CW, O] or bf16 [CW, OP]
struct LView {
  const void* L;
  int CW, W, O, OP;
  int lvec;  // f32 rows allow 16-byte cp.async
};

// The loop's shared memory from byte `base` on, for K neighbours, W weight
// columns and an O slice padded to obp: the x tile (none in the direct
// mode), the S slice and two buffers of L rows (jp: a chunk's rows, rounded
// up to the mma depth in bf16). In f32 the partial tiles of the 256
// projection threads (64 floats each) take the space from xs on at the end.
struct Smem {
  int xs_stride;  // floats per point of the x tile: K*CC + 4 (bank offset)
  int jp;         // S / L rows per chunk
  int s_stride;   // bf16: elements per S row (jp + 8); f32: points (64)
  int l_stride;   // elements per staged L row
  size_t xs, s, l, end;
};

// Channels per chunk: CC (8 in bf16, 4 in f32), or 4*CC in the direct mode
// (W = 1).
__host__ __device__ inline int chunk_width(bool bf16, int W) {
  return (bf16 ? 8 : 4) * (W == 1 ? 4 : 1);
}

__host__ __device__ inline Smem chunk_layout(bool bf16, int K, int W, int obp, size_t base) {
  Smem s;
  const int cc = bf16 ? 8 : 4;
  s.xs_stride = K * cc + 4;
  const int j = chunk_width(bf16, W) * W;
  s.jp = bf16 ? (j + 15) / 16 * 16 : j;
  s.s_stride = bf16 ? s.jp + 8 : kPoints;
  s.l_stride = bf16 ? obp + 8 : obp;
  s.xs = base;
  s.s = s.xs + (W == 1 ? 0 : sizeof(float) * kPoints * s.xs_stride);
  s.l = s.s + (bf16 ? 2 * (size_t)kPoints * s.s_stride : 4 * (size_t)s.jp * kPoints);
  s.end = s.l + 2 * (size_t)(bf16 ? 2 : 4) * s.jp * s.l_stride;
  if (!bf16 && s.end < s.xs + 65536) s.end = s.xs + 65536;
  return s;
}

// Stage rows [c0*W, c0*W + jp) x columns [o0, o0 + width) of L into `dst`
// (jp x l_stride), zero-filling rows past CW and columns past the slice.
template <bool BF16>
__device__ __forceinline__ void stage_L(const LView& lv, const Smem& sm, char* dst, int c0,
                                        int o0, int o_end, int width) {
  const int j_end = min(chunk_width(BF16, lv.W) * lv.W, lv.CW - c0 * lv.W);  // valid rows
  if (BF16) {
    const __nv_bfloat16* L = static_cast<const __nv_bfloat16*>(lv.L);
    __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
    const int segs = width / 8;                          // 16-byte segments per row
    const int op_end = min(o_end + 7, lv.OP) / 8 * 8;    // padded copy: whole segments
    for (int i = threadIdx.x; i < sm.jp * segs; i += kThreads) {
      const int j = i / segs, sg = i - j * segs;
      const int col = o0 + sg * 8;
      const bool ok = j < j_end && col < op_end;
      const __nv_bfloat16* src = ok ? L + (long long)(c0 * lv.W + j) * lv.OP + col : L;
      cp_async16(d + j * sm.l_stride + sg * 8, src, ok ? 16 : 0);
    }
  } else {
    const float* L = static_cast<const float*>(lv.L);
    float* d = reinterpret_cast<float*>(dst);
    if (lv.lvec) {
      const int segs = width / 4;
      for (int i = threadIdx.x; i < sm.jp * segs; i += kThreads) {
        const int j = i / segs, sg = i - j * segs;
        const int col = o0 + sg * 4;
        const bool ok = j < j_end && col < o_end;
        const float* src = ok ? L + (long long)(c0 * lv.W + j) * lv.O + col : L;
        cp_async16(d + j * sm.l_stride + sg * 4, src, ok ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < sm.jp * width; i += kThreads) {
        const int j = i / width, c = i - j * width;
        const bool ok = j < j_end && o0 + c < o_end;
        const float* src = ok ? L + (long long)(c0 * lv.W + j) * lv.O + o0 + c : L;
        cp_async4(d + j * sm.l_stride + c, src, ok ? 4 : 0);
      }
    }
  }
  cp_async_commit();
}

// x[m, k, :CC] * v[m, k, 4q..4q+3] added into s, for NK neighbours from
// kb (the x tile's rows kb.., v's registers from 0): NK a compile-time
// count, so the x loads of later neighbours go out before the products of
// earlier ones.
template <int CC, int NK>
__device__ __forceinline__ void contract_k(const float* xr, float (&vr)[kKReg][4],
                                           float (&s)[CC][4]) {
#pragma unroll
  for (int k = 0; k < NK; ++k) {
#pragma unroll
    for (int j4 = 0; j4 < CC / 4; ++j4) {
      const float4 x4 = reinterpret_cast<const float4*>(xr + k * CC)[j4];
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float& acc = s[4 * j4 + jj][i];
          acc = fmaf(xv[jj], vr[k][i], acc);
        }
    }
  }
}

// S chunk columns of thread (m, q) for CC channels: s[j][i] = sum_k x * v.
// vload(vr, kb) reloads v for neighbours kb.. when K > kKReg.
template <int CC, typename VLoad>
__device__ __forceinline__ void contract(const float* xs, int xs_stride, int K,
                                         float (&vr)[kKReg][4], float (&s)[CC][4], int m,
                                         VLoad vload) {
#pragma unroll
  for (int j = 0; j < CC; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
  const float* xr = xs + m * xs_stride;
  if (K == kKReg) {  // the flagship's 16
    contract_k<CC, kKReg>(xr, vr, s);
    return;
  }
  for (int kb = 0; kb < K; kb += kKReg) {
    if (K > kKReg) vload(vr, kb);  // never on the flagship
#pragma unroll
    for (int k = 0; k < kKReg; ++k) {
      if (kb + k >= K) break;
#pragma unroll
      for (int j4 = 0; j4 < CC / 4; ++j4) {
        const float4 x4 = reinterpret_cast<const float4*>(xr + (kb + k) * CC)[j4];
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float& acc = s[4 * j4 + jj][i];
            acc = fmaf(xv[jj], vr[k][i], acc);
          }
      }
    }
  }
}

// The direct mode's S columns of thread (m, q): s[j][0] = sum_k x[m,k,c+j] *
// v[m,k,0] for the CC channels from c, for a point of the tile (live: m <
// mt; else s = 0). x comes from xfast(m, k, c, x) where the caller's xok(c)
// holds (the CC channels are one 16-byte piece of a feature row: no branch
// between the loads), else from xload(m, k, c, x). The loads of a batch of
// 32 / CC neighbours go out before their products.
template <int CC, int NB, bool FAST, typename XFast, typename XLoad>
__device__ __forceinline__ void direct_batch(float (&vr)[kKReg][4], float (&s)[CC][4], int m,
                                             int c, int kb, int k0, int K, XFast xfast,
                                             XLoad xload) {
  float x[NB][CC];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if (K != kKReg && kb + k0 + k >= K) continue;
    if (FAST)
      xfast(m, kb + k0 + k, c, x[k]);
    else
      xload(m, kb + k0 + k, c, x[k]);
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if (K != kKReg && kb + k0 + k >= K) continue;
#pragma unroll
    for (int j = 0; j < CC; ++j) s[j][0] = fmaf(x[k][j], vr[k0 + k][0], s[j][0]);
  }
}

template <int CC, typename XFast, typename XLoad, typename VLoad>
__device__ __forceinline__ void contract_direct(int K, float (&vr)[kKReg][4],
                                                float (&s)[CC][4], int m, int c, bool live,
                                                bool fast, XFast xfast, XLoad xload,
                                                VLoad vload) {
  constexpr int kB = 32 / CC;
#pragma unroll
  for (int j = 0; j < CC; ++j) s[j][0] = 0.f;
  if (!live) return;
  for (int kb = 0; kb < K; kb += kKReg) {
    if (K > kKReg) vload(vr, kb);  // never on the flagship
#pragma unroll
    for (int k0 = 0; k0 < kKReg; k0 += kB) {
      if (fast)
        direct_batch<CC, kB, true>(vr, s, m, c, kb, k0, K, xfast, xload);
      else
        direct_batch<CC, kB, false>(vr, s, m, c, kb, k0, K, xfast, xload);
    }
  }
}

// The bf16 loop. NT: n8 tiles per warp; the O slice is 2 * NT * 8 columns
// wide (padded). gather(xs, c0) writes the x tile of chunk c0; store(r, o, v)
// takes each output element of the tile (r < mt, o < o_end). The caller
// has synchronised the block after its last write to the loop's space.
template <int NT, typename Gather, typename XOk, typename XFast, typename XLoad,
          typename VLoad, typename Store>
__device__ __forceinline__ void chunk_loop_bf16(const LView& lv, const Smem& sm, char* smem,
                                                int K, int W, int mt, int o0, int o_end,
                                                int c_lo, int c_hi, float (&vr)[kKReg][4],
                                                Gather gather, XOk xok, XFast xfast,
                                                XLoad xload, VLoad vload, Store store) {
  constexpr int CC = 8;
  constexpr int OBP = 16 * NT;
  const bool direct = W == 1;
  const int CH = chunk_width(true, W);  // channels per chunk
  float* xs = reinterpret_cast<float*>(smem + sm.xs);
  __nv_bfloat16* S = reinterpret_cast<__nv_bfloat16*>(smem + sm.s);
  char* Lbuf = smem + sm.l;
  const size_t lbytes = (size_t)2 * sm.jp * sm.l_stride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = tid % kPoints, q = tid / kPoints;  // contraction: point, w-quad

  stage_L<true>(lv, sm, Lbuf, c_lo * CH, o0, o_end, OBP);
  // S columns past J are never written: zero them once
  const int J = CH * W;
  for (int i = tid; i < kPoints * (sm.jp - J); i += kThreads) {
    const int r = i / (sm.jp - J), c = J + i % (sm.jp - J);
    S[r * sm.s_stride + c] = __float2bfloat16(0.f);
  }
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
  const int mrow = (warp & 3) * 16, nbase = (warp >> 2) * NT * 8;

  if (!direct) gather(xs, c_lo * CH);
  for (int ci = c_lo; ci < c_hi; ++ci) {
    const bool next = ci + 1 < c_hi;
    __syncthreads();  // xs holds chunk ci; the last projection is done
    if (next)  // buffers alternate from the range's first chunk, in buffer 0
      stage_L<true>(lv, sm, Lbuf + ((ci + 1 - c_lo) & 1) * lbytes, (ci + 1) * CH, o0, o_end,
                    OBP);
    float s[CC][4];
    if (direct) {
      const int c = ci * CH + q * CC;
      contract_direct<CC>(K, vr, s, m, c, m < mt, xok(c), xfast, xload, vload);
#pragma unroll
      for (int j = 0; j < CC; ++j) S[m * sm.s_stride + q * CC + j] = __float2bfloat16(s[j][0]);
    } else {
      contract<CC>(xs, sm.xs_stride, K, vr, s, m, vload);
#pragma unroll
      for (int j = 0; j < CC; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int w = 4 * q + i;
          if (w < W) S[m * sm.s_stride + j * W + w] = __float2bfloat16(s[j][i]);
        }
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
    if (next && !direct) gather(xs, (ci + 1) * CH);
  }

  // accumulator (t, i): row mrow + lane/4 (+8 for i >= 2), column
  // nbase + 8t + 2*(lane%4) + (i & 1)
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = mrow + (lane >> 2) + (i >> 1) * 8;
      const int o = o0 + nbase + t * 8 + (lane & 3) * 2 + (i & 1);
      if (r < mt && o < o_end) store(r, o, acc[t][i]);
    }
}

// The f32 loop. OBP: the O slice padded to a power of two (32 to 256). A
// projection thread owns 16 points x 4 adjacent columns; the OBP such tiles
// take OBP threads, so the 256 threads split the chunk's rows of S and L
// SK = 256 / OBP ways and add their partial tiles at the end.
template <int OBP, typename Gather, typename XOk, typename XFast, typename XLoad,
          typename VLoad, typename Store>
__device__ __forceinline__ void chunk_loop_f32(const LView& lv, const Smem& sm, char* smem,
                                               int K, int W, int mt, int o0, int o_end,
                                               int c_lo, int c_hi, float (&vr)[kKReg][4],
                                               Gather gather, XOk xok, XFast xfast,
                                               XLoad xload, VLoad vload, Store store) {
  constexpr int CC = 4;
  const bool direct = W == 1;
  const int CH = chunk_width(false, W);  // channels per chunk
  constexpr int PM = 16;              // points per projection thread
  constexpr int SK = kThreads / OBP;  // ways the rows of a chunk are split
  float* xs = reinterpret_cast<float*>(smem + sm.xs);
  float* S = reinterpret_cast<float*>(smem + sm.s);  // [J, 64], transposed
  char* Lbuf = smem + sm.l;
  const size_t lbytes = (size_t)4 * sm.jp * sm.l_stride;
  const int tid = threadIdx.x;
  const int m = tid % kPoints, q = tid / kPoints;  // contraction: point, w-quad
  const int sk = tid / OBP, tile = tid % OBP;      // projection: row split, tile
  const int mg = tile / (OBP / 4), cq = tile % (OBP / 4);
  const int J = CH * W;

  stage_L<false>(lv, sm, Lbuf, c_lo * CH, o0, o_end, OBP);
  float acc[PM][4];
#pragma unroll
  for (int p = 0; p < PM; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[p][i] = 0.f;

  if (!direct) gather(xs, c_lo * CH);
  for (int ci = c_lo; ci < c_hi; ++ci) {
    const bool next = ci + 1 < c_hi;
    __syncthreads();  // xs holds chunk ci; the last projection is done
    if (next)  // buffers alternate from the range's first chunk, in buffer 0
      stage_L<false>(lv, sm, Lbuf + ((ci + 1 - c_lo) & 1) * lbytes, (ci + 1) * CH, o0, o_end,
                     OBP);
    float s[CC][4];
    if (direct) {
      const int c = ci * CH + q * CC;
      contract_direct<CC>(K, vr, s, m, c, m < mt, xok(c), xfast, xload, vload);
#pragma unroll
      for (int j = 0; j < CC; ++j) S[(q * CC + j) * kPoints + m] = s[j][0];
    } else {
      contract<CC>(xs, sm.xs_stride, K, vr, s, m, vload);
#pragma unroll
      for (int j = 0; j < CC; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int w = 4 * q + i;
          if (w < W) S[(j * W + w) * kPoints + m] = s[j][i];
        }
    }
    if (next) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const float* Lc = reinterpret_cast<const float*>(Lbuf + ((ci - c_lo) & 1) * lbytes);
    for (int j = sk; j < J; j += SK) {
      const float4* sr = reinterpret_cast<const float4*>(S + j * kPoints + mg * PM);
      const float4 l4 = *reinterpret_cast<const float4*>(Lc + j * sm.l_stride + cq * 4);
      const float lv4[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int p4 = 0; p4 < PM / 4; ++p4) {
        const float4 s4 = sr[p4];
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int pp = 0; pp < 4; ++pp)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[4 * p4 + pp][i] = fmaf(sv[pp], lv4[i], acc[4 * p4 + pp][i]);
      }
    }
    // xs was last read by this chunk's contraction, before the sync
    if (next && !direct) gather(xs, (ci + 1) * CH);
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
    store(r, o, v);
  }
}

// ---- launch shape (host) ---------------------------------------------------

struct Grid {
  int tiles, splits, ob, obp, nt;  // nt: n8 tiles per warp (bf16)
  int csplits, cpb;                // channel-chunk ranges, chunks per range
};

// Blocks for M points, Ct channels and O outputs with O slices of at most
// max_ob columns. Small levels (M = 2048 or 512 gives 32 or 8 tiles on 132
// SMs) split the channel chunks first (at least min_chunks a block; the
// ranges add their partial outputs with f32 atomics), which repeats
// nothing of the loop, then O (down to kMinSlice columns), which repeats the
// contraction, up to a block per SM.
inline Grid split_grid(bool bf16, int Ct, int W, int O, int M, int max_ob, int min_chunks) {
  Grid g;
  g.tiles = (M + kPoints - 1) / kPoints;
  const int align = bf16 ? 8 : 4;
  const int chunks = (Ct + chunk_width(bf16, W) - 1) / chunk_width(bf16, W);
  int splits = (O + max_ob - 1) / max_ob, csplits = 1;
  for (;;) {
    const long long blocks = (long long)g.tiles * splits;
    if (blocks * (csplits + 1) <= kSMs && chunks / (csplits + 1) >= min_chunks)
      ++csplits;
    else if (g.tiles * (long long)(splits + 1) * csplits <= kSMs &&
             (O + splits) / (splits + 1) >= kMinSlice)
      ++splits;
    else
      break;
  }
  g.cpb = (chunks + csplits - 1) / csplits;
  g.csplits = (chunks + g.cpb - 1) / g.cpb;
  g.ob = ((O + splits - 1) / splits + align - 1) / align * align;
  g.splits = (O + g.ob - 1) / g.ob;
  if (bf16) {
    g.obp = (g.ob + 31) / 32 * 32;
    g.nt = g.obp / 16;
  } else {
    g.obp = kMinSlice;
    while (g.obp < g.ob) g.obp *= 2;
    g.nt = 0;
  }
  return g;
}

}  // namespace conv_tile
