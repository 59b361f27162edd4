// K3: the NeRF shading MLP's fused forward and backward for the train step,
// for Hopper (sm_90a).
//
// Replaces adanerf_tpu/ops/pallas/train_kernel.py::make_nerf_train_apply,
// the Pallas kernel pair (forward, recomputing backward) behind a
// jax.custom_vjp. The plain PyTorch version it is held against is
// NeRFDef.forward(x, dtype=torch.bfloat16) under autograd
// (adanerf_tpu_torch/ops/kernels/nerf_train.py wraps both).
//
// What it computes, with the TPU kernel's arithmetic: every product rounds
// both operands to bf16 and accumulates in fp32 (in the weight gradients
// too, where the activation AND the cotangent are rounded); biases and bias
// gradients are fp32 sums of unrounded values. x (N, 63+27) -> [rgb, alpha]
// (N, 4); the backward returns dW and db for every NeRF leaf and dX.
//
// What bounds it: arithmetic. One row costs 593,408 multiply-adds forward
// and about three times that backward (recompute, the dX chain, dW); the
// dense train step has N = 524,288 rows against ~1.2 MB of weights. The
// design keeps the per-row chain on chip, as the TPU kernel keeps it in VMEM:
//
//   k3_fwd        one block per 64-row tile: the 8x256 trunk, the heads and
//                 the views branch in shared memory (mlp_tile.cuh), weights
//                 streamed in bf16 through L2.
//   k3_bwd        one block per 64-row tile: recomputes the forward, writes
//                 each layer's bf16 input activation to scratch, walks the
//                 chain back (cotangent @ W^T with pre-transposed weights),
//                 writes each layer's bf16 pre-activation cotangent to
//                 scratch, per-tile fp32 bias partial sums, and dX.
//   k3_dw_partial split-K weight gradients dW = A^T G over 4096-row slices
//                 of the scratch, one fp32 partial per slice ...
//   k3_dw_reduce  ... summed over the slices in a fixed order (deterministic;
//                 the TPU kernel summed per-tile partials along its
//                 sequential grid, which a CUDA grid does not have).
//   k3_bias_reduce the bias partials summed over the tiles in order.
//
// The scratch (~10 GB-rows of bf16: 2 x (depth + 1) x N x 256 + 2 x N x 128)
// trades device memory for not holding a 256x256 fp32 partial per block.
// CUDA-core fp32 FMAs only; tensor cores are later work.

#include "mlp_tile.cuh"

namespace {

constexpr int XS = 128;    // row stride of the input / dX buffer
constexpr int MAXL = 16;   // most trunk layers
constexpr int DW_T = 64;   // dW output tile (DW_T x DW_T) per block
constexpr int DW_RC = 32;  // rows per staged chunk in the dW kernel

constexpr size_t SMEM_BYTES = sizeof(float) * (R * XS + 2 * R * W + KC * W);

}  // namespace

extern "C" {

// Mirrored field for field by the ctypes Structures in nerf_train.py.
// Weight offsets index the bf16 weight buffer, bias offsets the fp32 bias
// buffer, s_* the bf16 scratch, bp_* a row of the bias partials.
struct K3Params {
  long long w[MAXL], wx[MAXL], wT[MAXL], wxT[MAXL], b[MAXL];
  long long wf, wa, wvf, wvd, wrgb;   // forward: [K][N] row-major, K padded
  long long wfT, waT, wvfT, wvdT, wrgbT;  // backward: transposed, padded
  long long bf, ba, bv, brgb, zero;   // biases; `zero` is 256 zeros
  long long s_h[MAXL], s_g[MAXL];     // scratch: trunk activations, cotangents
  long long s_feat, s_hv, s_gfeat, s_ghv;
  long long bp[MAXL];                 // bias-partial columns of trunk layer i
  long long bp_f, bp_a, bp_v, bp_rgb, bp_width;
  int N, n_in, in_ch, in_pad, depth, skip_mask;  // skip bit i: layer i+1 takes [x, h]
};

// One weight gradient: out[k * ldo + m] = sum_n bf16(A[n, a_col + k]) *
// bf16(G[n, g_col + m]), k < K, m < M, over rows n < N.
struct DwJob {
  const void* a;
  const void* g;
  float* out;
  int a_f32, g_f32;   // operand stored as fp32 (rounded on load) or bf16
  int lda, a_col, ldg, g_col;
  int K, M, ldo, N, splits, rows_per_split;
};

}  // extern "C"

namespace {

typedef __nv_bfloat16 bf16;

// x rows row0.. into X (row stride XS), rounded to bf16, zero beyond N and
// beyond n_in up to in_pad.
__device__ void load_x(const K3Params& P, const float* __restrict__ x, float* X, int row0) {
  for (int e = threadIdx.x; e < R * P.in_pad; e += NT) {
    const int r = e / P.in_pad, c = e % P.in_pad, row = row0 + r;
    const float v = (row < P.N && c < P.n_in) ? x[(size_t)row * P.n_in + c] : 0.f;
    X[r * XS + c] = round_bf16(v);
  }
}

// Shared-memory rows (values already bf16-exact) to a bf16 [N][width] array.
__device__ void store_rows(const float* src, int stride, int width, bf16* dst, int row0, int N) {
  const int half = width / 2;
  for (int e = threadIdx.x; e < R * half; e += NT) {
    const int r = e / half, c = 2 * (e % half), row = row0 + r;
    if (row < N)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * width + c) =
          __floats2bfloat162_rn(src[r * stride + c], src[r * stride + c + 1]);
  }
}

// Recomputes the forward of one tile. With TRAIN, stores every trunk
// activation, the feature and the views activation to the scratch; without,
// computes the heads into out (N, 4). Leaves the feature in *feat and the
// views activation (row stride 128) in *hv.
template <bool TRAIN>
__device__ void forward_tile(const K3Params& P, const bf16* __restrict__ wts,
                             const float* __restrict__ bias, float* X, float* hA, float* hB,
                             float* wt, bf16* scr, float* alpha_s, float* out, int row0,
                             float** feat, float** hv) {
  const int lane = threadIdx.x & 31, wy = threadIdx.x >> 5;
  mlp_layer<bf16, W>({X, XS, P.in_pad, wts + P.w[0]}, {}, 1, bias + P.b[0], hA, W, true, true, wt);
  float* cur = hA;
  float* nxt = hB;
  if (TRAIN) { __syncthreads(); store_rows(cur, W, W, scr + P.s_h[0], row0, P.N); }
  for (int l = 1; l < P.depth; ++l) {
    const Seg<bf16> sh{cur, W, W, wts + P.w[l]};
    if ((P.skip_mask >> (l - 1)) & 1)
      mlp_layer<bf16, W>(sh, {X, XS, P.in_pad, wts + P.wx[l]}, 2, bias + P.b[l], nxt, W, true, true, wt);
    else
      mlp_layer<bf16, W>(sh, {}, 1, bias + P.b[l], nxt, W, true, true, wt);
    float* tmp = cur; cur = nxt; nxt = tmp;
    if (TRAIN) { __syncthreads(); store_rows(cur, W, W, scr + P.s_h[l], row0, P.N); }
  }
  // feature = h @ wf + bf (no activation) into the other buffer
  mlp_layer<bf16, W>({cur, W, W, wts + P.wf}, {}, 1, bias + P.bf, nxt, W, false, true, wt);
  __syncthreads();
  if (!TRAIN) {  // alpha head: one warp per row, lanes split K
    for (int i = 0; i < 8; ++i) {
      const int row = wy * 8 + i;
      float s = 0.f;
      for (int k = lane; k < W; k += 32) s = fmaf(cur[row * W + k], __bfloat162float(wts[P.wa + k]), s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) alpha_s[row] = s + bias[P.ba];
    }
  }
  // views = relu([feature, input_views] @ wv + bv), 128 wide, over the trunk
  mlp_layer<bf16, 128>({nxt, W, W, wts + P.wvf}, {X, XS, P.in_pad, wts + P.wvd}, 2,
                       bias + P.bv, cur, 128, true, true, wt);
  __syncthreads();
  *feat = nxt;
  *hv = cur;
  if (TRAIN) {
    store_rows(nxt, W, W, scr + P.s_feat, row0, P.N);
    store_rows(cur, 128, 128, scr + P.s_hv, row0, P.N);
    return;
  }
  // rgb head and the (N, 4) row: rgb in columns 0..2, alpha in column 3
  for (int i = 0; i < 8; ++i) {
    const int row = wy * 8 + i;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < 128; k += 32) {
      const float h = cur[row * 128 + k];
      s0 = fmaf(h, __bfloat162float(wts[P.wrgb + k * 3 + 0]), s0);
      s1 = fmaf(h, __bfloat162float(wts[P.wrgb + k * 3 + 1]), s1);
      s2 = fmaf(h, __bfloat162float(wts[P.wrgb + k * 3 + 2]), s2);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const int n = row0 + row;
    if (lane == 0 && n < P.N)
      *reinterpret_cast<float4*>(out + (size_t)n * 4) =
          make_float4(s0 + bias[P.brgb], s1 + bias[P.brgb + 1], s2 + bias[P.brgb + 2], alpha_s[row]);
  }
}

__global__ void __launch_bounds__(NT, 1)
k3_fwd(const K3Params P, const float* __restrict__ x, const bf16* __restrict__ wts,
       const float* __restrict__ bias, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);
  float* hA = X + R * XS;
  float* hB = hA + R * W;
  float* wt = hB + R * W;
  __shared__ float alpha_s[R];
  const int row0 = blockIdx.x * R;
  load_x(P, x, X, row0);
  float *feat, *hv;
  forward_tile<false>(P, wts, bias, X, hA, hB, wt, nullptr, alpha_s, out, row0, &feat, &hv);
}

// A finished cotangent block g (R x width, in shared memory, fp32): masks it
// with the relu of its layer's output (h from the scratch, when given),
// writes its column sums (the tile's bias-gradient partial), rounds it to
// bf16 in place and stores it to the scratch.
__device__ void finish_cotangent(const K3Params& P, float* g, int stride, int width,
                                 const bf16* h, float* bpart, bf16* gstore, int row0) {
  __syncthreads();
  if (h != nullptr) {
    for (int e = threadIdx.x; e < R * width; e += NT) {
      const int r = e / width, c = e % width, row = row0 + r;
      const bool live = row < P.N && __bfloat162float(h[(size_t)row * width + c]) > 0.f;
      if (!live) g[r * stride + c] = 0.f;
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < width; c += NT) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += g[r * stride + c];
    bpart[c] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * width; e += NT) {
    const int r = e / width, c = e % width;
    g[r * stride + c] = round_bf16(g[r * stride + c]);
  }
  __syncthreads();
  store_rows(g, stride, width, gstore, row0, P.N);
}

__global__ void __launch_bounds__(NT, 1)
k3_bwd(const K3Params P, const float* __restrict__ x, const float* __restrict__ gout,
       const bf16* __restrict__ wts, const float* __restrict__ bias, bf16* scr,
       float* __restrict__ bpart_all, float* __restrict__ dx) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);
  float* hA = X + R * XS;
  float* hB = hA + R * W;
  float* wt = hB + R * W;
  __shared__ __align__(16) float gs[R][32];  // the heads' cotangents, one chunk wide
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * R;
  float* bpart = bpart_all + (size_t)blockIdx.x * P.bp_width;
  const float* zero = bias + P.zero;

  load_x(P, x, X, row0);
  float *F, *V;  // feature and views activation left by the forward
  forward_tile<true>(P, wts, bias, X, hA, hB, wt, scr, nullptr, nullptr, row0, &F, &V);

  // heads: g_rgb = g[:, 0:3], g_alpha = g[:, 3]; fp32 bias partials first
  for (int e = t; e < R * 32; e += NT) {
    const int r = e / 32, c = e % 32, row = row0 + r;
    gs[r][c] = (row < P.N && c < 3) ? gout[(size_t)row * 4 + c] : 0.f;
  }
  if (t < 4) {
    float s = 0.f;
    for (int r = 0; r < R && row0 + r < P.N; ++r) s += gout[(size_t)(row0 + r) * 4 + t];
    bpart[t < 3 ? P.bp_rgb + t : P.bp_a] = s;
  }
  __syncthreads();
  for (int e = t; e < R * 32; e += NT) gs[e / 32][e % 32] = round_bf16(gs[e / 32][e % 32]);
  // g_hv = (g_rgb @ wrgb^T) * (hv > 0) into the upper half of V
  float* Ghv = V + R * 128;
  mlp_layer<bf16, 128>({&gs[0][0], 32, 32, wts + P.wrgbT}, {}, 1, zero, Ghv, 128, false, false, wt);
  finish_cotangent(P, Ghv, 128, 128, scr + P.s_hv, bpart + P.bp_v, scr + P.s_ghv, row0);
  // g_feat = g_hv @ wv_f^T into F (the feature is in the scratch)
  mlp_layer<bf16, W>({Ghv, 128, 128, wts + P.wvfT}, {}, 1, zero, F, W, false, false, wt);
  finish_cotangent(P, F, W, W, nullptr, bpart + P.bp_f, scr + P.s_gfeat, row0);
  // dX = g_hv @ wv_d^T into X (x is no longer needed here)
  mlp_layer<bf16, 128>({Ghv, 128, 128, wts + P.wvdT}, {}, 1, zero, X, XS, false, false, wt);
  __syncthreads();  // every reader of gs (g_rgb) is done
  for (int e = t; e < R * 32; e += NT) {
    const int r = e / 32, c = e % 32, row = row0 + r;
    gs[r][c] = (row < P.N && c == 0) ? round_bf16(gout[(size_t)row * 4 + 3]) : 0.f;
  }
  // g_h = g_feat @ wf^T + g_alpha @ wa^T into V (hv and g_hv are done)
  mlp_layer<bf16, W>({F, W, W, wts + P.wfT}, {&gs[0][0], 32, 32, wts + P.waT}, 2, zero, V, W,
                     false, false, wt);
  float* G = V;
  float* Gn = F;
  for (int i = P.depth - 1; i >= 0; --i) {
    // g_pre = g_h * (h_i > 0): bias partial, bf16, scratch
    finish_cotangent(P, G, W, W, scr + P.s_h[i], bpart + P.bp[i], scr + P.s_g[i], row0);
    if (i == 0) {
      mlp_layer<bf16, 128, true>({G, W, W, wts + P.wT[0]}, {}, 1, zero, X, XS, false, false, wt);
      break;
    }
    if ((P.skip_mask >> (i - 1)) & 1)  // layer i also took x: dX += g_pre @ wx_i^T
      mlp_layer<bf16, 128, true>({G, W, W, wts + P.wxT[i]}, {}, 1, zero, X, XS, false, false, wt);
    mlp_layer<bf16, W>({G, W, W, wts + P.wT[i]}, {}, 1, zero, Gn, W, false, false, wt);
    float* tmp = G; G = Gn; Gn = tmp;
  }
  __syncthreads();
  for (int e = t; e < R * P.n_in; e += NT) {
    const int r = e / P.n_in, c = e % P.n_in, row = row0 + r;
    if (row < P.N) dx[(size_t)row * P.n_in + c] = X[r * XS + c];
  }
}

__device__ __forceinline__ float load_rounded(const void* p, int is_f32, size_t i) {
  return is_f32 ? round_bf16(static_cast<const float*>(p)[i])
                : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// Block (tile_k, tile_m, split): a DW_T x DW_T tile of one slice's partial
// A^T G; each thread owns a 4 x 4 register tile.
__global__ void __launch_bounds__(NT)
k3_dw_partial(const DwJob J, float* __restrict__ part) {
  __shared__ __align__(16) float As[DW_RC][DW_T];
  __shared__ __align__(16) float Gs[DW_RC][DW_T];
  const int tiles_k = (J.K + DW_T - 1) / DW_T, tiles_m = (J.M + DW_T - 1) / DW_T;
  const int tk = blockIdx.x % tiles_k, tm = (blockIdx.x / tiles_k) % tiles_m;
  const int split = blockIdx.x / (tiles_k * tiles_m);
  const int n0 = split * J.rows_per_split;
  const int n1 = min(J.N, n0 + J.rows_per_split);
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int k0 = tk * DW_T, m0 = tm * DW_T;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int nc = n0; nc < n1; nc += DW_RC) {
    __syncthreads();
    for (int e = t; e < DW_RC * DW_T; e += NT) {
      const int r = e / DW_T, c = e % DW_T, n = nc + r;
      As[r][c] = (n < n1 && k0 + c < J.K)
                     ? load_rounded(J.a, J.a_f32, (size_t)n * J.lda + J.a_col + k0 + c) : 0.f;
      Gs[r][c] = (n < n1 && m0 + c < J.M)
                     ? load_rounded(J.g, J.g_f32, (size_t)n * J.ldg + J.g_col + m0 + c) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < DW_RC; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&As[r][ty * 4]);
      const float4 g = *reinterpret_cast<const float4*>(&Gs[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ty * 4 + i, m = m0 + tx * 4 + j;
      if (k < J.K && m < J.M) part[((size_t)split * J.K + k) * J.M + m] = acc[i][j];
    }
}

__global__ void k3_dw_reduce(const DwJob J, const float* __restrict__ part) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= J.K * J.M) return;
  float s = 0.f;
  for (int sp = 0; sp < J.splits; ++sp) s += part[(size_t)sp * J.K * J.M + e];
  J.out[(size_t)(e / J.M) * J.ldo + e % J.M] = s;
}

__global__ void k3_bias_reduce(const float* __restrict__ bpart, int tiles, int width,
                               float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  float s = 0.f;
  for (int i = 0; i < tiles; ++i) s += bpart[(size_t)i * width + c];
  out[c] = s;
}

cudaError_t set_smem() {
  cudaError_t e = cudaFuncSetAttribute(k3_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(k3_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM_BYTES);
}

}  // namespace

extern "C" int k3_forward(int device, const K3Params* P, const float* x, const void* wts,
                          const float* bias, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = set_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  k3_fwd<<<(P->N + R - 1) / R, NT, SMEM_BYTES, s>>>(*P, x, static_cast<const bf16*>(wts), bias,
                                                    out);
  return static_cast<int>(cudaGetLastError());
}

// The whole backward: the chain kernel, then every weight gradient of
// `jobs` (partials into `part`, then reduced into the job's output), then
// the bias gradients into bias_grad (bp_width columns).
extern "C" int k3_backward(int device, const K3Params* P, const float* x, const float* gout,
                           const void* wts, const float* bias, void* scratch, float* bpart,
                           float* dx, const DwJob* jobs, int n_jobs, float* part,
                           float* bias_grad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = set_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (P->N + R - 1) / R;
  k3_bwd<<<tiles, NT, SMEM_BYTES, s>>>(*P, x, gout, static_cast<const bf16*>(wts), bias,
                                       static_cast<bf16*>(scratch), bpart, dx);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  for (int j = 0; j < n_jobs; ++j) {
    const DwJob& J = jobs[j];
    const int blocks = ((J.K + DW_T - 1) / DW_T) * ((J.M + DW_T - 1) / DW_T) * J.splits;
    k3_dw_partial<<<blocks, NT, 0, s>>>(J, part);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    k3_dw_reduce<<<(J.K * J.M + 255) / 256, 256, 0, s>>>(J, part);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  k3_bias_reduce<<<(int)((P->bp_width + 255) / 256), 256, 0, s>>>(bpart, tiles, (int)P->bp_width,
                                                                  bias_grad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k3_struct_size(int which) {
  return which == 0 ? static_cast<int>(sizeof(K3Params)) : static_cast<int>(sizeof(DwJob));
}
