// Whole-layer inference kernel: one conv layer's middle in one launch.
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
// (pcf_torch/nn/fused_eval.py); the MLP weights, then the linear, arrive
// packed in one f32 buffer. Outputs take the feature table's type.
//
// What the TPU kernel exists for, and this one keeps: no per-edge tensor
// ([M, K, c] features, VI, MLP activations, guidance scores) and no
// [M, Ct*W] contraction tile reaches device memory. What this one does not
// copy: the TPU resolves edges with a one-hot MXU product from a VMEM window
// because it has no fine-grained gather; here each edge reads its rows
// through the two-level index, as the window resolve kernel does, and no
// window is materialised.
//
// Design (a first, simple version on the CUDA cores: no wgmma, no TMA). One
// block of 256 threads takes mt points (mt*K edges). The MLP weights are
// copied to shared memory; each edge's geometry, VI, MLP activations,
// guidance scores and convolution weights live in shared memory; the
// gathered feature rows are read from device memory (L2) where they are
// used. The [mt, Ct*W] contraction tile takes the space of the MLP
// buffers, and one thread per (output channel, 4 points) projects it
// against L, read through the read-only cache. mt is 16, halved while the
// block's shared memory exceeds 113 KB (two blocks per SM) or the grid has
// fewer than two blocks per SM, down to 4.
//
// What bounds it on the H100: at the flagship shapes the f32 projection
// and contraction operations on the CUDA cores, with the feature table,
// indices and outputs read or written once as the byte term.
//
// Rounding follows eval_kernel.py: with f32 features every product and sum
// is f32. With bf16 features the MLP multiplicands are rounded to bf16 (f32
// sums, f32 biases) and every MLP output to bf16; the VI features stay f32
// until an MLP reads them; feature times guidance score is rounded to bf16;
// each contraction product is rounded to bf16 before the f32 sum over K,
// and the sum to bf16; the projection multiplies bf16 by bf16 into f32.
// Geometry is read in f32 in both modes.
//
// C interface for ctypes: layer_eval(args, stream) returns
// cudaGetLastError() after the launch; layer_eval_tile reports the launch
// shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <initializer_list>
#include <type_traits>

constexpr int kMaxLayers = 4;

// The call's arguments, passed by pointer from ctypes and by value to the
// kernel (outside the unnamed namespace: the extern "C" entry points take it).
struct Mlp {
  int n;                 // layers; 0: no such MLP
  int din[kMaxLayers];   // w [din, dout] row-major at params + w, b at + b
  int dout[kMaxLayers];
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
  const float* params;      // MLP pairs (lin floats), then linear [Ct*W, O], [O]
  void* out;                // [M, O] T
  void* shortcut;           // [M, Cs] T (strided)
  int n_rows, Cf, Gd, wsz, mtk, M, K, Cx, Cg, Cs, W, O, H, Cpe, Ct, lin, use_vi,
      pe_on_vi, concat_wni, strided, bf16;
  int hmax, mt;             // set by layer_eval: MLP buffer width, points per block
  Mlp wn, pe, gd;
};

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;        // projection rows per thread
constexpr int kTile = 16;                // points per block, at most
constexpr size_t kTargetSmem = 113 * 1024;  // two blocks per SM
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMinBlocks = 2 * 132;      // two blocks per SM of an H100
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round to the multiplicand type: bf16 in bf16 mode, else unchanged
template <bool BF>
__device__ __forceinline__ float rnd(float x) {
  return BF ? __bfloat162float(__float2bfloat16(x)) : x;
}

__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
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
__device__ void vi_transform(const float* l, const float* gn, const float* cn,
                             float* o) {
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

// y[e, j] = act(sum_i x[e, i] * w[i, j] + b[j]) for every edge of the block;
// one (edge, output) per thread and step.
template <bool BF>
__device__ void dense(const float* x, int xs, const float* w, const float* b,
                      int ci, int co, float* y, int ys, int n_edges,
                      bool sigmoid) {
  for (int p = threadIdx.x; p < n_edges * co; p += kThreads) {
    const int e = p / co, j = p - e * co;
    const float* xr = x + e * xs;
    float acc = 0.f;
    for (int i = 0; i < ci; ++i)
      acc = fmaf(rnd<BF>(xr[i]), rnd<BF>(w[i * co + j]), acc);
    acc += b[j];
    acc = sigmoid ? 1.f / (1.f + expf(-acc)) : fmaxf(acc, 0.f);
    y[e * ys + j] = rnd<BF>(acc);
  }
}

// A whole MLP: hidden layers alternate between buffers p0 and p1, the last
// writes dest. Ends with the block synchronised.
template <bool BF>
__device__ void mlp(const Mlp& m, const float* params, const float* x, int xs,
                    float* dest, int ds, float* p0, float* p1, int n_edges,
                    bool sigmoid_last) {
  for (int l = 0; l < m.n; ++l) {
    const bool last = l == m.n - 1;
    float* y = last ? dest : (l % 2 ? p1 : p0);
    const int ys = last ? ds : m.dout[l];
    dense<BF>(x, xs, params + m.w[l], params + m.b[l], m.din[l], m.dout[l], y,
              ys, n_edges, last && sigmoid_last);
    __syncthreads();
    x = y;
    xs = ys;
  }
}

// Shared memory of a block of mt points, in floats, in the kernel's order.
size_t smem_floats(const LayerEvalArgs& a, int mt) {
  const size_t E = (size_t)mt * a.K;
  const bool guided = a.gd.n > 0;
  const size_t D = a.use_vi ? 12 : 3;
  const size_t u = 2 * E * a.hmax > (size_t)mt * a.Ct * a.W
                       ? 2 * E * a.hmax
                       : (size_t)mt * a.Ct * a.W;
  return a.lin /* MLP weights */ + E /* rows */ + E * D + E * a.W +
         (a.pe.n ? E * a.Cpe : 0) +
         (guided ? E * a.H + (size_t)mt * (a.Cg + a.Cpe) : 0) + u;
}

template <typename T, int WMAX>
__global__ void __launch_bounds__(kThreads)
layer_eval_kernel(const LayerEvalArgs a) {
  extern __shared__ float smem[];
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  const T* __restrict__ feats = static_cast<const T*>(a.feats);
  T* out = static_cast<T*>(a.out);
  T* shortcut = static_cast<T*>(a.shortcut);
  const int K = a.K, W = a.W, Cf = a.Cf, Cx = a.Cx, H = a.H, Cpe = a.Cpe;
  const int Ct = a.Ct, Cq = a.Cg + a.Cpe, D = a.use_vi ? 12 : 3;
  const bool guided = a.gd.n > 0;
  const int m0 = blockIdx.x * a.mt;
  const int mt = min(a.mt, a.M - m0);
  const int E = mt * K, Emax = a.mt * K;
  const int tid = threadIdx.x;

  float* params = smem;
  int* rows = reinterpret_cast<int*>(params + a.lin);           // [E]
  float* wni = reinterpret_cast<float*>(rows + Emax);           // [E, D]
  float* wgt = wni + Emax * D;                                  // [E, W]
  float* pe = wgt + Emax * W;                                   // [E, Cpe]
  float* sc = pe + (a.pe.n ? Emax * Cpe : 0);                   // [E, H]
  float* key = sc + (guided ? Emax * H : 0);                    // [mt, Cq]
  float* buf0 = key + (guided ? a.mt * Cq : 0);                 // MLP buffers,
  float* buf1 = buf0 + Emax * a.hmax;                           // then the tile
  float* S = buf0;                                              // [mt, Ct*W]

  // 1. weights, rows and per-edge geometry: localize, VI
  for (int i = tid; i < a.lin; i += kThreads) params[i] = a.params[i];
  const int mtw = a.mtk / K;  // points per window tile
  for (int i = tid; i < E; i += kThreads) {
    const int m = m0 + i / K;
    const int t = m / mtw;
    // localT [T, 1, mtk] holds edge (m, k) at t*mtk + (m % mtw)*K + k = m*K + k
    int slot = a.localT[(long long)m * K + i % K];
    slot = min(max(slot, 0), a.wsz - 1);
    int r = a.window_rows[(long long)t * a.wsz + slot];
    r = min(max(r, 0), a.n_rows - 1);
    rows[i] = r;
    const float* g = a.geo + (long long)r * a.Gd;
    const float* c = a.cxyz + (long long)m * 3;
    const float l[3] = {g[0] - c[0], g[1] - c[1], g[2] - c[2]};
    float* o = wni + i * D;
    if (a.use_vi) {
      vi_transform(l, g + 3, a.cnorm + (long long)m * 3, o);
    } else {
      o[0] = l[0], o[1] = l[1], o[2] = l[2];
    }
  }
  __syncthreads();

  // 2. WeightNet; 3. PE
  mlp<BF>(a.wn, params, wni, D, wgt, W, buf0, buf1, E, false);
  if (a.pe.n) {
    const float* x = a.pe_on_vi || !a.use_vi ? wni : wni + 9;
    mlp<BF>(a.pe, params, x, D, pe, Cpe, buf0, buf1, E, false);
  }
  // the PE value j of edge e: the PE MLP's, or the WeightNet input itself
  auto pe_at = [&](int e, int j) {
    return a.pe.n ? pe[e * Cpe + j] : rnd<BF>(wni[e * D + j]);
  };

  // 4. guidance: query [guid | pe], key, sigmoid(MLP(q - key)) -> sc
  if (guided) {
    auto q_at = [&](int e, int c) {
      return c < a.Cg ? to_float(feats[(long long)rows[e] * Cf + Cx + c])
                      : pe_at(e, c - a.Cg);
    };
    for (int p = tid; p < mt * Cq; p += kThreads) {
      const int m = p / Cq, c = p - m * Cq;
      float k0 = q_at(m * K, c);
      if (a.strided)
        for (int k = 1; k < K; ++k) k0 = fmaxf(k0, q_at(m * K + k, c));
      key[p] = k0;
    }
    __syncthreads();
    for (int p = tid; p < E * Cq; p += kThreads) {
      const int e = p / Cq, c = p - e * Cq;
      buf0[p] = rnd<BF>(q_at(e, c) - key[(e / K) * Cq + c]);
    }
    __syncthreads();
    mlp<BF>(a.gd, params, buf0, Cq, sc, H, buf1, buf0, E, true);
  }

  // 5. S[m, c*W + w] = sum_k x[m,k,c] * v[m,k,w]; one (m, c) per thread
  for (int p = tid; p < mt * Ct; p += kThreads) {
    const int m = p / Ct, c = p - m * Ct;
    float acc[WMAX];
#pragma unroll
    for (int w = 0; w < WMAX; ++w) acc[w] = 0.f;
    for (int k = 0; k < K; ++k) {
      const int e = m * K + k;
      float x;
      if (guided) {
        x = rnd<BF>(to_float(feats[(long long)rows[e] * Cf + c]) * sc[e * H + c % H]);
      } else {
        x = c < Cx ? to_float(feats[(long long)rows[e] * Cf + c]) : pe_at(e, c - Cx);
      }
      const float* vr = wgt + e * W;
#pragma unroll
      for (int w = 0; w < WMAX; ++w)
        if (w < W) acc[w] = BF ? acc[w] + rnd<BF>(x * vr[w]) : fmaf(x, vr[w], acc[w]);
    }
    float* s = S + m * Ct * W + c * W;
#pragma unroll
    for (int w = 0; w < WMAX; ++w)
      if (w < W) s[w] = rnd<BF>(acc[w]);
  }
  __syncthreads();

  // 6. out[m, o] = ReLU(sum_j S[m, j] * L[j, o] + b[o]); one o and
  //    kRowsPerThread points per thread. Rows past mt read allocated shared
  //    memory (a.mt is a multiple of kRowsPerThread) and are never stored.
  const int CtW = Ct * W, O = a.O;
  const float* L = a.params + a.lin;
  const int groups = (mt + kRowsPerThread - 1) / kRowsPerThread;
  for (int q = tid; q < groups * O; q += kThreads) {
    const int g = q / O, o = q - g * O;
    const float* s = S + g * kRowsPerThread * CtW;
    float acc[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
    for (int j = 0; j < CtW; ++j) {
      const float l = rnd<BF>(__ldg(L + (long long)j * O + o));
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r] = fmaf(s[r * CtW + j], l, acc[r]);
    }
    const float b = __ldg(L + (long long)CtW * O + o);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int m = g * kRowsPerThread + r;
      if (m >= mt) break;
      store(out, (long long)(m0 + m) * O + o, fmaxf(acc[r] + b, 0.f));
    }
  }

  // 7. strided: the max-pool shortcut over the Cs slab
  if (a.strided) {
    const int off = Cx + a.Cg, Cs = a.Cs;
    for (int p = tid; p < mt * Cs; p += kThreads) {
      const int m = p / Cs, c = p - m * Cs;
      float v = to_float(feats[(long long)rows[m * K] * Cf + off + c]);
      for (int k = 1; k < K; ++k)
        v = fmaxf(v, to_float(feats[(long long)rows[m * K + k] * Cf + off + c]));
      store(shortcut, (long long)(m0 + m) * Cs + c, v);
    }
  }
}

// The widest MLP activation the ping-pong buffers hold: every hidden layer's
// output and, guided, the query [guid | pe].
int hidden_max(const LayerEvalArgs& a) {
  int h = a.gd.n > 0 ? a.Cg + a.Cpe : 1;
  for (const Mlp* m : {&a.wn, &a.pe, &a.gd})
    for (int l = 0; l + 1 < m->n; ++l) h = m->dout[l] > h ? m->dout[l] : h;
  return h;
}

// Points per block (see the design note); 0 if not even kRowsPerThread fit.
int tile_points(const LayerEvalArgs& a) {
  int mt = kTile;
  while (mt > kRowsPerThread &&
         (4 * smem_floats(a, mt) > kTargetSmem || (a.M + mt - 1) / mt < kMinBlocks))
    mt /= 2;
  return 4 * smem_floats(a, mt) > kMaxSmem ? 0 : mt;
}

template <typename T, int WMAX>
int launch(const LayerEvalArgs& a, size_t smem, cudaStream_t stream) {
  auto kernel = layer_eval_kernel<T, WMAX>;
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
int launch_for_w(const LayerEvalArgs& a, size_t smem, cudaStream_t s) {
  if (a.W <= 1) return launch<T, 1>(a, smem, s);
  if (a.W <= 2) return launch<T, 2>(a, smem, s);
  if (a.W <= 4) return launch<T, 4>(a, smem, s);
  if (a.W <= 8) return launch<T, 8>(a, smem, s);
  return launch<T, 16>(a, smem, s);
}

bool valid_mlp(const Mlp& m) {
  if (m.n < 0 || m.n > kMaxLayers) return false;
  for (int l = 0; l < m.n; ++l)
    if (m.din[l] <= 0 || m.dout[l] <= 0 || (l && m.din[l] != m.dout[l - 1]))
      return false;
  return true;
}

bool valid(const LayerEvalArgs& a) {
  const int D = a.use_vi ? 12 : 3;
  const bool guided = a.gd.n > 0;
  return a.M > 0 && a.K > 0 && a.n_rows > 0 && a.wsz > 0 && a.mtk > 0 &&
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
         (a.strided || a.Cs == 0) && a.lin >= 0;
}

}  // namespace

// Run kernel E on one layer (hmax and mt are set here). Returns a CUDA error
// code, 0 on a successful launch.
extern "C" int layer_eval(const LayerEvalArgs* args, void* stream) {
  LayerEvalArgs a = *args;
  if (a.M == 0) return 0;
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  a.hmax = hidden_max(a);
  a.mt = tile_points(a);
  if (a.mt == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * smem_floats(a, a.mt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.bf16 ? launch_for_w<__nv_bfloat16>(a, smem, s)
                : launch_for_w<float>(a, smem, s);
}

// The launch shape layer_eval picks for these widths: returns the points
// per block (0: no tile fits) and stores the dynamic shared memory in *smem.
extern "C" int layer_eval_tile(const LayerEvalArgs* args, long long* smem) {
  LayerEvalArgs a = *args;
  a.hmax = hidden_max(a);
  const int mt = tile_points(a);
  *smem = mt ? (long long)(4 * smem_floats(a, mt)) : 0;
  return mt;
}
