// Shared building blocks of the port's hand-written MLP kernels for Hopper
// (sm_90a): a block owns an R-row tile whose activations live in shared
// memory, and each layer streams its weights through shared memory in
// KC-row chunks while every thread accumulates an RW-row x 4 NV-column
// register tile with fp32 FMAs. Included by megakernel.cuh: the fp32
// kernels of K1 and K2. The MLPs' hidden width W is the macro MLP_WIDTH
// (128 or 256; one library per width).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

#ifndef MLP_WIDTH
#define MLP_WIDTH 256
#endif
constexpr int W = MLP_WIDTH;         // hidden width of the MLPs
static_assert(W == 128 || W == 256, "MLP widths of the fused libraries: 128 and 256");
constexpr int R = 64;      // rows (rays or samples) per block tile
constexpr int NT = 256;    // threads per block: 8 warps x RW rows each
constexpr int RW = R / 8;  // rows per warp
constexpr int KC = 32;     // weight rows staged in shared memory per chunk

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load4(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void load4(const __nv_bfloat16* src, float* dst) {
  uint2 u = *reinterpret_cast<const uint2*>(src);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// One input segment of a layer: a shared-memory activation block (R rows,
// row stride `stride`, K columns, K a multiple of KC) and its K x N weights
// in global memory, row-major.
template <typename T>
struct Seg {
  const float* act;
  int stride;
  int K;
  const T* w;
};

// out[R, N] = act_0 @ w_0 (+ act_1 @ w_1) + bias, optional relu, optional
// bf16 rounding of the stored result; with ACC the sum is added to what
// `out` holds (out += act @ w + bias) before the activation. Warp `wy` owns
// rows wy*RW..wy*RW+RW-1; lane owns columns v*128 + lane*4 + {0..3} below N
// (N a multiple of 64). Callers must not alias `out` with an input. Starts
// with a barrier, so the previous layer's output is complete.
template <typename T, int N, bool ACC = false>
__device__ void mlp_layer(Seg<T> s0, Seg<T> s1, int nseg, const float* bias,
                          float* out, int out_stride, bool relu, bool round_out,
                          float* wt) {
  constexpr int NV = (N + 127) / 128;
  const int lane = threadIdx.x & 31, wy = threadIdx.x >> 5;
  float acc[RW][NV * 4];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int c = 0; c < NV * 4; ++c) acc[i][c] = 0.f;

  for (int si = 0; si < nseg; ++si) {
    const Seg<T> sg = si == 0 ? s0 : s1;
    for (int k0 = 0; k0 < sg.K; k0 += KC) {
      __syncthreads();
      for (int e = threadIdx.x * 4; e < KC * N; e += NT * 4)
        load4(sg.w + (size_t)k0 * N + e, wt + e);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 4) {
        float4 a[RW];
#pragma unroll
        for (int i = 0; i < RW; ++i)
          a[i] = *reinterpret_cast<const float4*>(sg.act + (wy * RW + i) * sg.stride + k0 + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float4 wv[NV];
#pragma unroll
          for (int v = 0; v < NV; ++v)  // past N (a 64- or 192-column layer): unused
            wv[v] = *reinterpret_cast<const float4*>(wt + (kk + q) * N + v * 128 + lane * 4);
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            const float av = comp(a[i], q);
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              acc[i][v * 4 + 0] = fmaf(av, wv[v].x, acc[i][v * 4 + 0]);
              acc[i][v * 4 + 1] = fmaf(av, wv[v].y, acc[i][v * 4 + 1]);
              acc[i][v * 4 + 2] = fmaf(av, wv[v].z, acc[i][v * 4 + 2]);
              acc[i][v * 4 + 3] = fmaf(av, wv[v].w, acc[i][v * 4 + 3]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (N % 128 != 0 && v * 128 + lane * 4 >= N) continue;
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float val = acc[i][v * 4 + c] + bias[v * 128 + lane * 4 + c];
        if (ACC) val += out[(wy * RW + i) * out_stride + v * 128 + lane * 4 + c];
        if (relu) val = fmaxf(val, 0.f);
        if (round_out) val = round_bf16(val);
        o[c] = val;
      }
      *reinterpret_cast<float4*>(out + (wy * RW + i) * out_stride + v * 128 + lane * 4) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
}

}  // namespace
