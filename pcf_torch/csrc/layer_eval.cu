// Kernel E, the whole-layer inference kernel: one conv layer's middle in one
// launch.
//
// Replaces the Pallas kernel of pcf_tpu/attic/eval_kernel.py (_make_kernel,
// launched by fused_layer_eval). Per output point m and neighbour k, with
// row = window_rows[t, localT[t, 0, e]] (t = m / Mt, e = (m % Mt)*K + k):
//   loc = xyz[row] - centre[m];  VI (12-d) with use_vi, else loc
//   v  = WeightNet MLP(VI)                      ReLU after every layer
//   pe = PE MLP(VI | loc), or VI itself (concat_wni), or none
//   guided: q = [guid[row] | pe], key = q[k=0] (or max over K if strided),
//           s = sigmoid(MLP(q - key)) [H],  x[c] = feats[row, c] * s[c % H]
//   else:   x = [feats[row, :Cx] | pe]
//   S[m, c*W + w] = sum_k x[m,k,c] * v[m,k,w];  out[m] = ReLU(S[m] @ L + b)
//   strided: short[m, c] = max_k feats[row, Cx+Cg+c]
// Every BatchNorm is folded into its Linear by the caller
// (pcf_torch/nn/fused_eval.py); the MLP weights arrive packed in one f32
// buffer (pcf_torch/ops/kernels/layer_eval.py, _pack), the linear as L and
// b. Outputs take the feature table's type.
//
// What the TPU kernel exists for, and this one keeps: no per-edge tensor
// ([M, K, c] features, VI, MLP activations, guidance scores) and no
// [M, Ct*W] contraction tile reaches device memory. What this one does not
// copy: the TPU resolves edges with a one-hot MXU product from a VMEM window
// because it has no fine-grained gather; here each edge reads its rows
// through the two-level index, as the window resolve kernel does.
//
// What bounds it on the H100: in f32 the projection, contraction and MLP
// operations on the CUDA cores (F32_TOL excludes TF32); in bf16 the bytes
// (the feature table, indices and outputs). The first design (4-16 points a
// block, every per-edge buffer of the block in shared memory, L streamed
// from L2 with 4 FMAs per load, one (edge, output) per thread in the MLPs
// with both operands re-read and rounded at every FMA) ran at 16x (f32) and
// 286x (bf16) that bound, bf16 slower than f32. This one takes B's tile:
//
//   - a block of 256 threads takes 64 points, an O slice and a range of
//     channel chunks (grid and splits as kernel B's, conv_tile.cuh; O
//     slices up to 256 columns in both dtypes, since each block repeats the
//     per-edge stage);
//   - the per-edge stage runs once per block, over chunks of pc points
//     (pc*K <= 256 edges; pc from shared memory): resolve and clamp the
//     rows, localize, VI; the WeightNet, PE and guidance MLPs with one edge
//     a thread and all of a layer's outputs in its registers, activations
//     feature-major in shared memory (each weight load a broadcast feeding
//     up to 64 FMAs); the guidance query minus its key read in the first
//     guidance layer, the sigmoid scores. Each point's v goes to the
//     registers of thread (m, w-quad) as in B; the scores (guided) or the
//     PE columns (otherwise) stay in shared memory at their width for the
//     whole tile;
//   - then B's channel-chunk loop: gather the tile's rows for the chunk,
//     times the scores or with the PE columns appended; contract over K on
//     the CUDA cores; project against L staged by double-buffered cp.async
//     (bf16: mma.sync m16n8k16 on a bf16 copy of L; f32: register-blocked);
//     W = 1 layers (the transposes) in the loop's direct mode;
//   - ReLU and the cast to the table's type as the tile is stored. Where
//     the chunk ranges of a tile are split over blocks (small levels), each
//     block stores its partial tile in its own f32 slot of a workspace
//     [ranges, M, O], and the last block of each tile and O slice to finish
//     (a counter per tile) adds the slots in range order and applies the
//     bias, ReLU and cast in the same launch. The sum's order is fixed, so
//     two launches on the same inputs give the same bits (f32 atomics would
//     add in the order the blocks finish; in bf16 a rounding flips on those
//     last bits);
//   - the strided max-pool shortcut, exact, from the first block of a tile.
//
// Rounding: with f32 features every product and sum is f32. With bf16
// features everything between the reads and the projection stays f32, as in
// kernel B: the geometry, the MLPs (f32 weights and activations), the
// guidance scores, feature times score, the contraction over K; its sum S is
// rounded to bf16 and the projection multiplies it by a bf16 copy of L into
// f32 on the tensor cores; the output is rounded to bf16 as it is stored.
// (eval_kernel.py rounds the MLPs' multiplicands and activations, feature
// times score and each contraction product to bf16 as well: four roundings
// a layer more, which left the bf16 layer up to 2.5 times as far from the
// f32 model as the standard bf16 layers on trained weights.) The MLPs and
// the contraction run on the CUDA cores in both modes.
//
// C interface for ctypes: layer_eval(args, work, stream) returns
// cudaGetLastError() after the launch; layer_eval_shape reports the launch
// shape and the f32 workspace the split tiles need.

#include "conv_tile.cuh"

#include <initializer_list>
#include <type_traits>

constexpr int kMaxLayers = 4;

// The call's arguments, passed by pointer from ctypes and by value to the
// kernel (outside the unnamed namespace: the extern "C" entry points take it).
struct Mlp {
  int n;                 // layers; 0: no such MLP
  int din[kMaxLayers];   // w [din, dp] row-major at params + w, b [dp] at + b
  int dout[kMaxLayers];  // (dp = padded_width(dout), zero-padded)
  int w[kMaxLayers];
  int b[kMaxLayers];
};

struct LayerEvalArgs {
  const void* feats;        // [n_rows, Cf] T: conv | guidance | shortcut
  const float* geo;         // [n_rows, Gd] xyz | normals
  const int* window_rows;   // [T, wsz]
  const int* localT;        // [T, 1, mtk]
  const float* cxyz;        // [M, 3]
  const float* cnorm;       // [M, 3] (use_vi)
  const float* params;      // the MLPs' packed pairs, lin floats
  const void* L;            // [Ct*W, O] f32, or [Ct*W, OP] bf16 (bf16 features)
  const float* bias;        // [O]
  void* out;                // [M, O] T
  void* shortcut;           // [M, Cs] T (strided)
  int n_rows, Cf, Gd, wsz, mtk, M, K, Cx, Cg, Cs, W, O, H, Cpe, Ct, lin, use_vi,
      pe_on_vi, concat_wni, strided, bf16;
  Mlp wn, pe, gd;
};

namespace {

using namespace conv_tile;

constexpr float kEps = 1e-12f;
// widest O slice, both dtypes: each slice repeats the per-edge stage, so
// the bf16 projection takes up to 16 n8 tiles a warp (B stops at 10)
constexpr int kMaxO = 256;
constexpr int kMaxChunkEdges = 256;  // edges of a per-edge-stage chunk, at most

// Launch plan: the grid, the per-edge stage's chunk and the shared memory
// layout (bytes): MLP weights at 0, rows, the kept per-edge values (scores
// [64*K, H] or PE [64*K, Cpe]), then from `base` the per-edge stage's
// scratch, whose space the channel-chunk loop takes after it.
struct Plan {
  Grid g;
  int pc;      // points per per-edge-stage chunk
  int ld;      // floats per activation row: pc*K + 1 (odd: no bank conflicts)
  int hmax;    // widest hidden activation
  int rows, keep, base;
  int smem;
  int vec;     // feature rows allow 16-byte chunk loads
  int qvec;    // and 16-byte loads of the guidance columns
};

__device__ __forceinline__ void put(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// VI features of one edge (eval_kernel.py _vi_chunk): theta1..9, then loc.
__device__ void vi_transform(const float* l, const float* gn, const float* cn, float* o) {
  const float nrm = sqrtf(dot3(l, l));
  const float inv = 1.f / fmaxf(nrm, kEps);
  const float r[3] = {l[0] * inv, l[1] * inv, l[2] * inv};
  const float nsr = dot3(cn, r);
  float v[3] = {cn[0] - nsr * r[0], cn[1] - nsr * r[1], cn[2] - nsr * r[2]};
  const float vinv = 1.f / fmaxf(sqrtf(dot3(v, v)), kEps);
  v[0] *= vinv, v[1] *= vinv, v[2] *= vinv;
  float w[3];
  cross3(r, v, w);
  const float winv = 1.f / fmaxf(sqrtf(dot3(w, w)), kEps);
  w[0] *= winv, w[1] *= winv, w[2] *= winv;
  float gxc[3];
  cross3(gn, cn, gxc);
  o[0] = dot3(gn, cn);
  o[1] = nsr;
  o[2] = dot3(r, gn);
  o[3] = dot3(l, cn);
  o[4] = dot3(gn, r);
  o[5] = dot3(gn, v);
  o[6] = dot3(gn, w);
  o[7] = dot3(l, gxc);
  o[8] = nrm;
  o[9] = l[0], o[10] = l[1], o[11] = l[2];
}

// Columns of a packed MLP layer: dout rounded up to a power of two, at
// least 4 (the weights and biases are zero-padded to it).
__host__ __device__ inline int padded_width(int dout) {
  int d = 4;
  while (d < dout) d *= 2;
  return d;
}

// Optional subtrahend of a layer's input: x[i, e] - key[(e / K)*pk + i*ik]
// (the guidance query minus its key).
struct Key {
  const float* at;  // null: none
  int pk, ik, K;
};

// y = act(x @ w + b) for edge e = threadIdx.x < ne, outputs [j0, j0 + NO) of
// a layer of dp padded columns: x feature-major in shared memory (x[i*ld +
// e]), all NO outputs in registers, each weight load a broadcast feeding NO
// FMAs. Output j at y[e*y_e + j*y_j], j < dout.
template <bool KEYED, int NO>
__device__ __forceinline__ void dense(const float* x, int ld, const float* w, const float* b,
                                      int din, int dout, int dp, int j0, float* y, int y_e,
                                      int y_j, int ne, bool sigmoid, Key key) {
  const int e = threadIdx.x;
  if (e >= ne) return;
  float acc[NO];
#pragma unroll
  for (int j = 0; j < NO; j += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(b + j0 + j);
    acc[j] = bv.x, acc[j + 1] = bv.y, acc[j + 2] = bv.z, acc[j + 3] = bv.w;
  }
  const float* kp = KEYED ? key.at + (e / key.K) * key.pk : nullptr;
#pragma unroll 4
  for (int i = 0; i < din; ++i) {
    float xv = x[i * ld + e];
    if (KEYED) xv -= kp[i * key.ik];
    const float* wr = w + i * dp + j0;
#pragma unroll
    for (int j = 0; j < NO; j += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(wr + j);
      acc[j] = fmaf(xv, wv.x, acc[j]);
      acc[j + 1] = fmaf(xv, wv.y, acc[j + 1]);
      acc[j + 2] = fmaf(xv, wv.z, acc[j + 2]);
      acc[j + 3] = fmaf(xv, wv.w, acc[j + 3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (j0 + j >= dout) break;
    const float v = sigmoid ? 1.f / (1.f + expf(-acc[j])) : fmaxf(acc[j], 0.f);
    y[e * y_e + (j0 + j) * y_j] = v;
  }
}

// One layer over ne edges, in blocks of at most 64 outputs.
template <bool KEYED>
__device__ void layer(const float* x, int ld, const float* w, const float* b, int din, int dout,
                      float* y, int y_e, int y_j, int ne, bool sigmoid, Key key) {
  const int dp = padded_width(dout);
  if (dp <= 4)
    dense<KEYED, 4>(x, ld, w, b, din, dout, dp, 0, y, y_e, y_j, ne, sigmoid, key);
  else if (dp == 8)
    dense<KEYED, 8>(x, ld, w, b, din, dout, dp, 0, y, y_e, y_j, ne, sigmoid, key);
  else if (dp == 16)
    dense<KEYED, 16>(x, ld, w, b, din, dout, dp, 0, y, y_e, y_j, ne, sigmoid, key);
  else if (dp == 32)
    dense<KEYED, 32>(x, ld, w, b, din, dout, dp, 0, y, y_e, y_j, ne, sigmoid, key);
  else
    for (int j0 = 0; j0 < dout; j0 += 64)
      dense<KEYED, 64>(x, ld, w, b, din, dout, dp, j0, y, y_e, y_j, ne, sigmoid, key);
}

// A whole MLP over ne edges: hidden layers alternate between h0 and h1
// (feature-major, ld), the last writes dest at (d_e, d_j); `key` applies to
// the first layer's input. Ends with the block synchronised.
__device__ void mlp(const Mlp& mp, const float* params, const float* x, int ld, float* h0,
                    float* h1, float* dest, int d_e, int d_j, int ne, bool sigmoid_last,
                    Key key = Key{nullptr, 0, 0, 1}) {
  for (int l = 0; l < mp.n; ++l) {
    const bool last = l == mp.n - 1;
    float* y = last ? dest : (l % 2 ? h1 : h0);
    if (l == 0 && key.at)  // the guidance MLP's first layer: q - key
      layer<true>(x, ld, params + mp.w[l], params + mp.b[l], mp.din[l], mp.dout[l], y,
                  last ? d_e : 1, last ? d_j : ld, ne, last && sigmoid_last, key);
    else
      layer<false>(x, ld, params + mp.w[l], params + mp.b[l], mp.din[l], mp.dout[l], y,
                   last ? d_e : 1, last ? d_j : ld, ne, last && sigmoid_last, key);
    __syncthreads();
    x = y;
  }
}

// The per-edge stage over the tile's mt points, pc at a time: v into the
// registers of thread (m, w-quad), the scores (guided) or PE columns into
// keep [64*K, H or Cpe]. Ends with the block synchronised.
template <typename T>
__device__ void per_edge_stage(const LayerEvalArgs& a, const Plan& p, const float* params,
                               const int* rows, float* keep, float* scratch, int m0, int mt,
                               float (&vr)[kKReg][4]) {
  const T* __restrict__ feats = static_cast<const T*>(a.feats);
  const int K = a.K, W = a.W, D = a.use_vi ? 12 : 3, ld = p.ld;
  const bool guided = a.gd.n > 0;
  const int Cq = a.Cg + a.Cpe;
  float* vi = scratch;                               // [D][ld]
  float* qb = vi + D * ld;                           // [Cq][ld] guided
  float* h0 = qb + (guided ? Cq * ld : 0);           // [hmax][ld]
  float* h1 = h0 + p.hmax * ld;                      // [hmax][ld]
  float* vb = h1 + p.hmax * ld;                      // [W][ld]
  float* kbuf = vb + W * ld;                         // [pc][Cq] guided
  const int tid = threadIdx.x, m = tid % kPoints, qd = tid / kPoints;

  for (int p0 = 0; p0 < mt; p0 += p.pc) {
    const int np = min(p.pc, mt - p0), ne = np * K, e0 = p0 * K;
    // geometry: localize, VI; the query's guidance columns
    for (int e = tid; e < ne; e += kThreads) {
      const int pm = m0 + p0 + e / K;
      const int r = rows[e0 + e];
      const float* g = a.geo + (long long)r * a.Gd;
      const float* c = a.cxyz + (long long)pm * 3;
      const float l[3] = {g[0] - c[0], g[1] - c[1], g[2] - c[2]};
      float o[12];
      if (a.use_vi) {
        vi_transform(l, g + 3, a.cnorm + (long long)pm * 3, o);
      } else {
        o[0] = l[0], o[1] = l[1], o[2] = l[2];
      }
#pragma unroll
      for (int d = 0; d < 12; ++d) {
        if (d >= D) break;
        vi[d * ld + e] = o[d];
        if (a.concat_wni) keep[(e0 + e) * a.Cpe + d] = o[d];
      }
    }
    // the query's guidance columns: 16-byte pieces of the rows, 4 in flight
    if (guided) {
      constexpr int V = 16 / sizeof(T);
      if (p.qvec) {
        const int pieces = a.Cg / V;
#pragma unroll 4
        for (int t = tid; t < ne * pieces; t += kThreads) {
          const int e = t % ne, pc = t / ne;
          const uint4 f = __ldg(reinterpret_cast<const uint4*>(
              feats + (long long)rows[e0 + e] * a.Cf + a.Cx + pc * V));
          const T* fv = reinterpret_cast<const T*>(&f);
#pragma unroll
          for (int j = 0; j < V; ++j) qb[(pc * V + j) * ld + e] = to_float(fv[j]);
        }
      } else {
#pragma unroll 4
        for (int t = tid; t < ne * a.Cg; t += kThreads) {
          const int e = t % ne, c2 = t / ne;
          qb[c2 * ld + e] = to_float(feats[(long long)rows[e0 + e] * a.Cf + a.Cx + c2]);
        }
      }
    }
    __syncthreads();
    // WeightNet; v of this chunk's points into registers
    mlp(a.wn, params, vi, ld, h0, h1, vb, 1, ld, ne, false);
    if (m >= p0 && m < p0 + np) {  // W = 1 (the direct mode): every quad holds w = 0
#pragma unroll
      for (int k = 0; k < kKReg; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int w = (W == 1 ? 0 : 4 * qd) + i;
          vr[k][i] = (k < K && w < W) ? vb[w * ld + (m - p0) * K + k] : 0.f;
        }
    }
    // PE: into the query (guided) or kept for the contraction
    if (a.pe.n) {
      const float* x = a.pe_on_vi || !a.use_vi ? vi : vi + 9 * ld;
      if (guided)
        mlp(a.pe, params, x, ld, h0, h1, qb + a.Cg * ld, 1, ld, ne, false);
      else
        mlp(a.pe, params, x, ld, h0, h1, keep + e0 * a.Cpe, a.Cpe, 1, ne, false);
    }
    if (!guided) continue;
    // guidance: sigmoid(MLP(q - key)) -> keep, the key q at the point's
    // first edge, or (strided) its max over the point's edges
    Key key{qb, K, ld, K};
    if (a.strided) {
      for (int t = tid; t < np * Cq; t += kThreads) {
        const int pp = t / Cq, c = t - pp * Cq;
        const float* qr = qb + c * ld + pp * K;
        float kv = qr[0];
        for (int k = 1; k < K; ++k) kv = fmaxf(kv, qr[k]);
        kbuf[t] = kv;
      }
      __syncthreads();
      key = Key{kbuf, Cq, 1, K};
    }
    mlp(a.gd, params, qb, ld, h0, h1, keep + e0 * a.H, a.H, 1, ne, true, key);
  }
  __syncthreads();  // the last v loads are done before the loop takes the space
}

// x[m, k, c0..c0+CC) of tile edge i (row: its clamped row), zero past Ct:
// guided, feats[row, c] * score[i, c % H]; else feats[row, c] for c < Cx and
// the kept PE column after.
// `fast`: one 16-byte load of the feature row (CC channels of T).
template <typename T, int CC>
__device__ __forceinline__ void load_x(const LayerEvalArgs& a, const float* keep, int i,
                                       int row, int c0, bool fast, float (&x)[CC]) {
  const T* fr = static_cast<const T*>(a.feats) + (long long)row * a.Cf;
  const int Cx = a.Cx;
  if (fast) {
    const uint4 f = __ldg(reinterpret_cast<const uint4*>(fr + c0));
    const T* fv = reinterpret_cast<const T*>(&f);
#pragma unroll
    for (int j = 0; j < CC; ++j) x[j] = to_float(fv[j]);
  } else {
#pragma unroll
    for (int j = 0; j < CC; ++j) x[j] = c0 + j < Cx ? to_float(fr[c0 + j]) : 0.f;
  }
  if (a.gd.n > 0) {
    const float* sc = keep + (size_t)i * a.H;
#pragma unroll
    for (int j = 0; j < CC; ++j) x[j] *= sc[(c0 + j) % a.H];
  } else {
    const float* pe = keep + (size_t)i * a.Cpe;
#pragma unroll
    for (int j = 0; j < CC; ++j) {
      const int c = c0 + j;
      if (c >= Cx) x[j] = c < a.Ct ? pe[c - Cx] : 0.f;
    }
  }
}

// The tile's x for channels [c0, c0 + CC) into xs[m, k*CC + j], zero past mt.
template <typename T, int CC>
__device__ __forceinline__ void gather_x(const LayerEvalArgs& a, const Plan& p,
                                         const int* rows, const float* keep, float* xs,
                                         int xs_stride, int mt, int c0) {
  const int K = a.K;
  const bool fast = p.vec && c0 + CC <= a.Cx;
  for (int i = threadIdx.x; i < kPoints * K; i += kThreads) {
    const int m = i / K, k = i - m * K;
    float x[CC];
    if (m < mt) {
      load_x<T, CC>(a, keep, i, rows[i], c0, fast, x);
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

// NB: n8 tiles per warp (bf16) or the padded O slice (f32)
template <bool BF16, int NB>
__global__ void __launch_bounds__(kThreads, 1)
layer_eval_kernel(const LayerEvalArgs a, const Plan p, float* work) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int CC = BF16 ? 8 : 4;
  extern __shared__ __align__(16) char smem[];
  float* params = reinterpret_cast<float*>(smem);
  int* rows = reinterpret_cast<int*>(smem + p.rows);
  float* keep = reinterpret_cast<float*>(smem + p.keep);
  const Smem sm = chunk_layout(BF16, a.K, a.W, BF16 ? 16 * NB : NB, p.base);
  const T* __restrict__ feats = static_cast<const T*>(a.feats);
  T* out = static_cast<T*>(a.out);
  const int K = a.K, tid = threadIdx.x;
  const int m0 = blockIdx.x * kPoints, mt = min(kPoints, a.M - m0);
  const int o0 = blockIdx.y * p.g.ob, o_end = min(o0 + p.g.ob, a.O);
  const int c_lo = blockIdx.z * p.g.cpb;
  const int CH = chunk_width(BF16, a.W);
  const int c_hi = min(c_lo + p.g.cpb, (a.Ct + CH - 1) / CH);

  // weights and the tile's rows (localT [T, 1, mtk] holds edge (m, k) at
  // t*mtk + (m % Mt)*K + k = m*K + k), clamped
  for (int i = tid; i < a.lin / 4; i += kThreads)
    reinterpret_cast<float4*>(params)[i] = __ldg(reinterpret_cast<const float4*>(a.params) + i);
  const int mtw = a.mtk / K;  // points per window tile
  for (int i = tid; i < mt * K; i += kThreads) {
    const int m = m0 + i / K;
    int slot = a.localT[(long long)m * K + i % K];
    slot = min(max(slot, 0), a.wsz - 1);
    const int r = a.window_rows[(long long)(m / mtw) * a.wsz + slot];
    rows[i] = min(max(r, 0), a.n_rows - 1);
  }
  __syncthreads();

  float vr[kKReg][4];
#pragma unroll
  for (int k = 0; k < kKReg; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) vr[k][i] = 0.f;
  per_edge_stage<T>(a, p, params, rows, keep, reinterpret_cast<float*>(smem + p.base), m0, mt,
                    vr);

  // the strided max-pool shortcut, once per tile
  if (a.strided && blockIdx.y == 0 && blockIdx.z == 0) {
    T* shortcut = static_cast<T*>(a.shortcut);
    const int off = a.Cx + a.Cg, Cs = a.Cs;
    for (int t = tid; t < mt * Cs; t += kThreads) {
      const int m = t / Cs, c = t - m * Cs;
      float v = to_float(feats[(long long)rows[m * K] * a.Cf + off + c]);
#pragma unroll
      for (int k = 1; k < kKReg; ++k)  // K <= kKReg: the loads go out together
        if (k < K) v = fmaxf(v, to_float(feats[(long long)rows[m * K + k] * a.Cf + off + c]));
      put(shortcut, (long long)(m0 + m) * Cs + c, v);
    }
  }

  const bool split = gridDim.z > 1;
  auto gather = [&](float* xs, int c0) {
    gather_x<T, CC>(a, p, rows, keep, xs, sm.xs_stride, mt, c0);
  };
  // the direct mode (W = 1): x from one 16-byte piece of a feature row (not
  // guided: CC channels wholly in the conv columns), or through load_x
  auto xok = [&](int c0) { return a.gd.n == 0 && p.vec && c0 + CC <= a.Cx; };
  auto xfast = [&](int mm, int k, int c0, float (&x)[CC]) {
    const uint4 f = __ldg(
        reinterpret_cast<const uint4*>(feats + (long long)rows[mm * K + k] * a.Cf + c0));
    const T* fv = reinterpret_cast<const T*>(&f);
#pragma unroll
    for (int j = 0; j < CC; ++j) x[j] = to_float(fv[j]);
  };
  auto xload = [&](int mm, int k, int c0, float (&x)[CC]) {
    load_x<T, CC>(a, keep, mm * K + k, rows[mm * K + k], c0, p.vec && c0 + CC <= a.Cx, x);
  };
  auto vload = [](float (&)[kKReg][4], int) {};  // K <= kKReg: v is in registers
  const size_t slot = (size_t)a.M * a.O;  // one partial tile per chunk range
  auto store = [&](int r, int o, float v) {
    const long long at = (long long)(m0 + r) * a.O + o;
    if (split)
      __stcg(work + blockIdx.z * slot + at, v);
    else
      put(out, at, fmaxf(v + a.bias[o], 0.f));
  };
  if constexpr (BF16)
    chunk_loop_bf16<NB>(LView{a.L, a.Ct * a.W, a.W, a.O, (a.O + 7) / 8 * 8, 0}, sm,
                              smem, K, a.W, mt, o0, o_end, c_lo, c_hi, vr, gather, xok,
                              xfast, xload, vload, store);
  else
    chunk_loop_f32<NB>(LView{a.L, a.Ct * a.W, a.W, a.O, a.O,
                             a.O % 4 == 0 && reinterpret_cast<uintptr_t>(a.L) % 16 == 0},
                       sm, smem, K, a.W, mt, o0, o_end, c_lo, c_hi, vr, gather, xok, xfast,
                       xload, vload, store);
  if (!split) return;

  // split chunk ranges: the last block of this tile and O slice to finish
  // adds the ranges' partial tiles in range order and applies the bias,
  // ReLU and cast
  __threadfence();
  __syncthreads();
  int* last = rows;  // the rows are read no more
  if (tid == 0) {
    int* counters = reinterpret_cast<int*>(work + gridDim.z * slot);
    last[0] = atomicAdd(counters + blockIdx.x * gridDim.y + blockIdx.y, 1) ==
              (int)gridDim.z - 1;
  }
  __syncthreads();
  if (!last[0]) return;
  __threadfence();
  const int w = o_end - o0;
  for (int i = tid; i < mt * w; i += kThreads) {
    const int r = i / w, o = o0 + i - r * w;
    const long long at = (long long)(m0 + r) * a.O + o;
    float v = 0.f;
    for (int z = 0; z < (int)gridDim.z; ++z) v += __ldcg(work + z * slot + at);
    put(out, at, fmaxf(v + a.bias[o], 0.f));
  }
}

template <typename KernelT>
int launch_kernel(KernelT kernel, const LayerEvalArgs& a, const Plan& p, float* work,
                  cudaStream_t stream) {
  // The opt-in holds for the current device only, so it is made on every
  // launch; it costs far less than the launch.
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  if (p.g.csplits > 1) {  // the tile counters start at zero; every block
                         // writes the whole of its partial tile
    const size_t slots = (size_t)p.g.csplits * a.M * a.O;
    const cudaError_t e = cudaMemsetAsync(reinterpret_cast<float*>(work) + slots, 0,
                                          sizeof(int) * (size_t)p.g.tiles * p.g.splits, stream);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(p.g.tiles, p.g.splits, p.g.csplits), kThreads, p.smem, stream>>>(a, p, work);
  return (int)cudaGetLastError();
}

}  // namespace

#ifndef PCF_PARTS
#define PCF_PARTS 1
#define PCF_PART 0
#endif

// The kernel's instantiations, (i, BF16, NB). launch() reaches instantiation
// i through layer_eval_launch_<i>, defined in translation unit i % PCF_PARTS:
// build.py compiles this file once per part, the parts at once (as one unit
// it took nvcc over twice as long as any other source); without PCF_PARTS
// the file is one unit holding all of them.
#define LAYER_EVAL_INSTANCES(X) \
  X(0, true, 4) X(1, true, 8) X(2, true, 12) X(3, true, 16) \
  X(4, false, 32) X(5, false, 64) X(6, false, 128) X(7, false, 256)

// extern "C": one name in every unit; the arguments by pointer, as the
// entry points take them
#define LAYER_EVAL_DECLARE(i, BF16, NB) \
  extern "C" int layer_eval_launch_##i(const void* args, const void* plan, float* work, \
                                       void* stream);
LAYER_EVAL_INSTANCES(LAYER_EVAL_DECLARE)
#undef LAYER_EVAL_DECLARE

#define LAYER_EVAL_DEFINE(i, BF16, NB)                                                      \
  extern "C" int layer_eval_launch_##i(const void* args, const void* plan, float* work,    \
                                       void* stream) {                                     \
    return launch_kernel(layer_eval_kernel<BF16, NB>, *static_cast<const LayerEvalArgs*>(args), \
                         *static_cast<const Plan*>(plan), work,                            \
                         static_cast<cudaStream_t>(stream));                               \
  }
#if 0 % PCF_PARTS == PCF_PART
LAYER_EVAL_DEFINE(0, true, 4)
#endif
#if 1 % PCF_PARTS == PCF_PART
LAYER_EVAL_DEFINE(1, true, 8)
#endif
#if 2 % PCF_PARTS == PCF_PART
LAYER_EVAL_DEFINE(2, true, 12)
#endif
#if 3 % PCF_PARTS == PCF_PART
LAYER_EVAL_DEFINE(3, true, 16)
#endif
#if 4 % PCF_PARTS == PCF_PART
LAYER_EVAL_DEFINE(4, false, 32)
#endif
#if 5 % PCF_PARTS == PCF_PART
LAYER_EVAL_DEFINE(5, false, 64)
#endif
#if 6 % PCF_PARTS == PCF_PART
LAYER_EVAL_DEFINE(6, false, 128)
#endif
#if 7 % PCF_PARTS == PCF_PART
LAYER_EVAL_DEFINE(7, false, 256)
#endif
#undef LAYER_EVAL_DEFINE

// the host side: the plan, the checks, the entry points (part 0's unit)
#if PCF_PART == 0
namespace {

// The widest hidden activation (every MLP layer's output but the last).
int hidden_max(const LayerEvalArgs& a) {
  int h = 1;
  for (const Mlp* m : {&a.wn, &a.pe, &a.gd})
    for (int l = 0; l + 1 < m->n; ++l) h = m->dout[l] > h ? m->dout[l] : h;
  return h;
}

size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// The plan: kernel B's grid (O slices of at most max_ob, chunk ranges of at
// least 2 chunks; each block repeats the per-edge stage), and the largest
// per-edge chunk of pc points that fits beside it; narrower O slices where
// nothing fits. smem 0: no plan fits.
Plan make_plan(const LayerEvalArgs& a) {
  const bool bf16 = a.bf16 != 0, guided = a.gd.n > 0;
  const int K = a.K, D = a.use_vi ? 12 : 3, Cq = a.Cg + a.Cpe;
  Plan p;
  p.hmax = hidden_max(a);
  p.rows = 4 * a.lin;
  p.keep = (int)align16(p.rows + sizeof(int) * kPoints * K);
  p.base = (int)align16(p.keep + sizeof(float) * kPoints * K * (guided ? a.H : a.Cpe));
  p.smem = 0;
  p.vec = a.Cf % (bf16 ? 8 : 4) == 0 && reinterpret_cast<uintptr_t>(a.feats) % 16 == 0;
  p.qvec = p.vec && a.Cx % (bf16 ? 8 : 4) == 0 && a.Cg % (bf16 ? 8 : 4) == 0;
  for (int max_ob = kMaxO; max_ob >= kMinSlice; max_ob /= 2) {
    p.g = split_grid(bf16, a.Ct, a.W, a.O, a.M, max_ob, 2);
    if (bf16) {  // slices padded to 64 columns: 4 kernels, not 8
      p.g.obp = (p.g.ob + 63) / 64 * 64;
      p.g.nt = p.g.obp / 16;
    }
    const size_t loop_end = chunk_layout(bf16, K, a.W, p.g.obp, p.base).end;
    for (int pc = kPoints; pc >= 1; pc /= 2) {
      if (pc * K > kMaxChunkEdges) continue;
      const int ld = pc * K + 1;
      const size_t scratch = sizeof(float) * ((size_t)(D + (guided ? Cq : 0) + 2 * p.hmax + a.W) * ld +
                                              (guided ? (size_t)pc * Cq : 0));
      const size_t end = p.base + scratch > loop_end ? p.base + scratch : loop_end;
      if (end <= kMaxSmem) {
        p.pc = pc;
        p.ld = ld;
        p.smem = (int)end;
        return p;
      }
    }
  }
  return p;
}

int launch(const LayerEvalArgs& a, const Plan& p, float* work, cudaStream_t s) {
  if (a.bf16) {
    switch (p.g.nt) {
      case 4: return layer_eval_launch_0(&a, &p, work, s);
      case 8: return layer_eval_launch_1(&a, &p, work, s);
      case 12: return layer_eval_launch_2(&a, &p, work, s);
      case 16: return layer_eval_launch_3(&a, &p, work, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (p.g.obp) {
    case 32: return layer_eval_launch_4(&a, &p, work, s);
    case 64: return layer_eval_launch_5(&a, &p, work, s);
    case 128: return layer_eval_launch_6(&a, &p, work, s);
    case 256: return layer_eval_launch_7(&a, &p, work, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool valid_mlp(const Mlp& m) {
  if (m.n < 0 || m.n > kMaxLayers) return false;
  for (int l = 0; l < m.n; ++l)
    if (m.din[l] <= 0 || m.dout[l] <= 0 || (l && m.din[l] != m.dout[l - 1]) || m.w[l] % 4 ||
        m.b[l] % 4)
      return false;
  return true;
}

bool valid(const LayerEvalArgs& a) {
  const int D = a.use_vi ? 12 : 3;
  const bool guided = a.gd.n > 0;
  return a.M > 0 && a.K > 0 && a.K <= kKReg && a.n_rows > 0 && a.wsz > 0 && a.mtk > 0 &&
         a.mtk % a.K == 0 && a.Cx > 0 && a.Cf == a.Cx + a.Cg + a.Cs &&
         a.Gd == (a.use_vi ? 6 : 3) && a.W >= 1 && a.W <= 16 && a.O > 0 &&
         valid_mlp(a.wn) && valid_mlp(a.pe) && valid_mlp(a.gd) && a.wn.n >= 1 &&
         a.wn.din[0] == D && a.wn.dout[a.wn.n - 1] == a.W &&
         (a.pe.n == 0 || (a.pe.din[0] == (a.pe_on_vi ? D : 3) &&
                          a.pe.dout[a.pe.n - 1] == a.Cpe)) &&
         (a.pe.n > 0 || !a.concat_wni || a.Cpe == D) &&
         (a.pe.n > 0 || a.concat_wni || a.Cpe == 0) &&
         a.Ct == (guided ? a.Cx : a.Cx + a.Cpe) &&
         (!guided || (a.H > 0 && a.Cx % a.H == 0 && a.gd.din[0] == a.Cg + a.Cpe &&
                      a.gd.dout[a.gd.n - 1] == a.H)) &&
         (a.strided || a.Cs == 0) && a.lin >= 0 && a.lin % 4 == 0;
}

}  // namespace

// Run kernel E on one layer. work: the f32 workspace of layer_eval_shape's
// size (may be null when that is 0). Returns a CUDA error code, 0 on a
// successful launch.
extern "C" int layer_eval(const LayerEvalArgs* args, void* work, void* stream) {
  const LayerEvalArgs& a = *args;
  if (a.M == 0) return 0;
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(a);
  if (p.smem == 0 || (p.g.csplits > 1 && work == nullptr)) return (int)cudaErrorInvalidValue;
  return launch(a, p, static_cast<float*>(work), static_cast<cudaStream_t>(stream));
}

// The launch shape layer_eval picks for these arguments: shape[0..9] =
// points per block, O slices, columns per slice, channel-chunk ranges,
// blocks, dynamic shared memory bytes (0: no plan fits), threads per block,
// tensor cores for the projection (1: mma.sync m16n8k16 bf16, 0: CUDA
// cores), points per chunk of the per-edge stage, workspace bytes.
extern "C" void layer_eval_shape(const LayerEvalArgs* args, long long* shape) {
  const LayerEvalArgs& a = *args;
  const Plan p = make_plan(a);
  shape[0] = kPoints;
  shape[1] = p.g.splits;
  shape[2] = p.g.ob;
  shape[3] = p.g.csplits;
  shape[4] = (long long)p.g.tiles * p.g.splits * p.g.csplits;
  shape[5] = p.smem;
  shape[6] = kThreads;
  shape[7] = a.bf16 != 0;
  shape[8] = p.pc;
  shape[9] = p.g.csplits > 1 ? (long long)sizeof(float) * ((long long)p.g.csplits * a.M * a.O +
                                                            (long long)p.g.tiles * p.g.splits)
                             : 0;
}
#endif  // PCF_PART == 0
