// Compacted adaptive frame renderer for Hopper (sm_90a).
//
// Replaces adanerf_tpu/ops/pallas/megakernel3.py::make_megakernel_compact,
// the fused Pallas kernel of the real-time renderer: ray setup -> oracle MLP
// -> adaptive select -> compacted NeRF shading of the live samples only ->
// front-to-back composite. The plain PyTorch version it is held against is
// adanerf_tpu_torch/realtime.py (through ops/kernels/megakernel_compact.py).
//
// What bounds it: arithmetic. One ray costs 449,024 multiply-adds in the
// 8x256 oracle and each live sample 593,408 in the 8x256 NeRF; an 800x800
// frame at ~1.3 samples per pixel is ~1.6 TFLOP against ~4 MB of weights
// and under 20 MB of frame input and output. Its design therefore keeps
// every activation on chip: a block owns a 64-row tile, holds the encoded
// input and two 64x256 fp32 activation buffers in shared memory, and streams
// each layer's weights through shared memory in 32-row chunks (the weights
// stay resident in the 50 MB L2 across blocks). Each thread accumulates an
// 8-row x 8-column register tile with fp32 FMAs. Tensor cores (wgmma/TMA)
// are the next step and not used here.
//
// Three launches on the caller's stream, no host synchronisation:
//   (a) mk_front:     one block per 64 rays: ray setup, oracle encode + MLP,
//                     select, per-ray (count, z, p); reserves compact row
//                     offsets with one atomicAdd per block.
//   (b) mk_shade:     persistent blocks walk the compact rows (the live count
//                     is read on the device): normalize, encode, NeRF MLP,
//                     raw rgba written back by (ray, slot).
//   (c) mk_composite: one thread per ray.
//
// Precision: geometry and the positional encode stay in full fp32 (sinf /
// cosf, no fast-math); the top encode band multiplies coordinates by 512.
// Weights come in fp32 or bf16; accumulation is fp32 either way, and in
// bf16 mode every matmul's activation input is rounded to bf16 (round to
// nearest even), matching the plain version's bf16 emulation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int R = 64;      // rows (rays or samples) per block tile
constexpr int NT = 256;    // threads per block: 8 warps x 8 rows each
constexpr int KC = 32;     // weight rows staged in shared memory per chunk
constexpr int W = 256;     // hidden width of both MLPs
constexpr int XS = 128;    // row stride of the encoded-input buffer
constexpr int MAXL = 16;   // most layers per MLP

constexpr size_t SMEM_BYTES = sizeof(float) * (R * XS + 2 * R * W + KC * W);

}  // namespace

extern "C" {

// Mirrored field for field by the ctypes Structure in megakernel_compact.py.
struct MkParams {
  long long o_w[MAXL], o_b[MAXL];     // oracle layer weight / bias offsets
  long long n_w[MAXL], n_wx[MAXL], n_b[MAXL];  // NeRF trunk (+ skip input)
  long long n_wa, n_ba, n_wf, n_bf, n_wvf, n_wvd, n_bv, n_wrgb, n_brgb;
  int B, S, D;          // rays, sample slots, oracle bins
  int in0, in1;         // padded encoded input widths (multiples of 32)
  int fd0, fp0, fp1, fd1;  // encode frequencies: oracle dir/pos, NeRF pos/dir
  int depth0, depth1, skip_mask;  // layers; bit i: NeRF layer i+1 takes [x, h]
  int z_mode;           // 0 raw [0,1] z, 1 log, 2 linear depth transform
  int ndc;              // shading rays in NDC space
  int norm_none;        // 1: "None" normalization, 0: InverseSqrtDistCentered
  int acc_mode;         // 0 none, 1 alpha premultiply, 2 weights premultiply
  int bf16;             // weights are bf16, activations rounded to bf16
  int stages;           // 1 front only, 2 + shade, 3 + composite
  int shade_blocks;     // persistent grid of the shade kernel
  float threshold, radius2, sqrt_max_depth;
  float center[3];
  float z_a, z_b;       // log: a^z - 1 + b; linear: z * a + b
  float ndc_wf, ndc_hf; // -2 focal / w, -2 focal / h
};

}  // extern "C"

namespace {

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
// bf16 rounding of the stored result. Warp `wy` owns rows wy*8..wy*8+7; lane
// owns columns v*128 + lane*4 + {0..3}. Callers must not alias `out` with an
// input. Starts with a barrier, so the previous layer's output is complete.
template <typename T, int N>
__device__ void mlp_layer(Seg<T> s0, Seg<T> s1, int nseg, const float* bias,
                          float* out, int out_stride, bool relu, bool round_out,
                          float* wt) {
  constexpr int NV = N / 128;
  const int lane = threadIdx.x & 31, wy = threadIdx.x >> 5;
  float acc[8][NV * 4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
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
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = *reinterpret_cast<const float4*>(sg.act + (wy * 8 + i) * sg.stride + k0 + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float4 wv[NV];
#pragma unroll
          for (int v = 0; v < NV; ++v)
            wv[v] = *reinterpret_cast<const float4*>(wt + (kk + q) * N + v * 128 + lane * 4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
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
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float val = acc[i][v * 4 + c] + bias[v * 128 + lane * 4 + c];
        if (relu) val = fmaxf(val, 0.f);
        if (round_out) val = round_bf16(val);
        o[c] = val;
      }
      *reinterpret_cast<float4*>(out + (wy * 8 + i) * out_stride + v * 128 + lane * 4) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
}

// Column `col` of the encoding [enc(c[0:3], fa) | enc(c[3:6], fb) | 0...],
// each block laid out [x(3), sin f0 x(3), cos f0 x(3), sin f1 x(3), ...].
__device__ float encode_col(const float* c, int col, int fa, int fb) {
  const int wa = 3 * (2 * fa + 1), wb = 3 * (2 * fb + 1);
  const float* cc = c;
  if (col >= wa) {
    col -= wa;
    cc = c + 3;
    if (col >= wb) return 0.f;
  }
  if (col < 3) return cc[col];
  col -= 3;
  const int f = col / 6, r = col % 6;
  const float arg = cc[r % 3] * ldexpf(1.f, f);
  return r < 3 ? sinf(arg) : cosf(arg);
}

// Encode the R rows of `coords` into x (row stride XS, `width` columns).
__device__ void encode_tile(const float (*coords)[6], float* x, int width, int fa,
                            int fb, bool round_out) {
  for (int e = threadIdx.x; e < R * width; e += NT) {
    const int row = e / width, col = e % width;
    float v = encode_col(coords[row], col, fa, fb);
    x[row * XS + col] = round_out ? round_bf16(v) : v;
  }
}

// Warp-wide argmax of (value, bin), ties to the lower bin.
__device__ __forceinline__ void warp_argmax(float& v, int& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int ob = __shfl_xor_sync(0xffffffffu, b, off);
    if (ov > v || (ov == v && ob < b)) { v = ov; b = ob; }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
mk_front(const MkParams P, const float* __restrict__ dirs, const float* __restrict__ pose,
         const float* __restrict__ rot, const T* __restrict__ wts,
         const float* __restrict__ bias, float* __restrict__ o_sh, float* __restrict__ d_sh,
         float* __restrict__ zbuf, float* __restrict__ pbuf, int* __restrict__ counts,
         int* __restrict__ rows, int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  float* x = reinterpret_cast<float*>(smem4);
  float* hA = x + R * XS;
  float* hB = hA + R * W;
  float* wt = hB + R * W;
  __shared__ float coords[R][6];
  __shared__ int cnt_s[R], off_s[R];
  __shared__ int base_s;

  const int t = threadIdx.x;
  const int ray0 = blockIdx.x * R;
  if (t < R) {
    const int ray = ray0 + t;
    float dx = 0.f, dy = 0.f, dz = 0.f;
    if (ray < P.B) { dx = dirs[ray * 3]; dy = dirs[ray * 3 + 1]; dz = dirs[ray * 3 + 2]; }
    // world dirs = rot @ dir
    const float nx = rot[0] * dx + rot[1] * dy + rot[2] * dz;
    const float ny = rot[3] * dx + rot[4] * dy + rot[5] * dz;
    const float nz = rot[6] * dx + rot[7] * dy + rot[8] * dz;
    const float ox = pose[0], oy = pose[1], oz = pose[2];
    // exit point on the view-cell sphere
    const float mx = ox - P.center[0], my = oy - P.center[1], mz = oz - P.center[2];
    const float u = mx * nx + my * ny + mz * nz;
    const float delta = u * u - ((mx * mx + my * my + mz * mz) - P.radius2);
    const float dist = -u + sqrtf(fmaxf(delta, 0.f));
    const float px = ox + nx * dist, py = oy + ny * dist, pz = oz + nz * dist;
    coords[t][0] = nx; coords[t][1] = ny; coords[t][2] = nz;
    coords[t][3] = px; coords[t][4] = py; coords[t][5] = pz;
    if (ray < P.B) {
      float so[3] = {px, py, pz}, sd[3] = {nx, ny, nz};
      if (P.ndc) {  // ndc_rays with near = 1, from the un-projected origin
        const float ts = -(1.f + oz) / nz;
        const float qx = ox + ts * nx, qy = oy + ts * ny, qz = oz + ts * nz;
        so[0] = P.ndc_wf * qx / qz;
        so[1] = P.ndc_hf * qy / qz;
        so[2] = 1.f + 2.f / qz;
        sd[0] = P.ndc_wf * (nx / nz - qx / qz);
        sd[1] = P.ndc_hf * (ny / nz - qy / qz);
        sd[2] = -2.f / qz;
        if (!(nx * nx + ny * ny + nz * nz > 0.5f)) {  // zero-padded ray
          so[0] = so[1] = so[2] = sd[0] = sd[1] = sd[2] = 0.f;
        }
      }
      for (int c = 0; c < 3; ++c) { o_sh[ray * 3 + c] = so[c]; d_sh[ray * 3 + c] = sd[c]; }
    }
  }
  __syncthreads();
  encode_tile(coords, x, P.in0, P.fd0, P.fp0, P.bf16);

  // oracle MLP: relu trunk, raw logits out (padded to 128 columns)
  const bool rb = P.bf16;
  mlp_layer<T, W>({x, XS, P.in0, wts + P.o_w[0]}, {}, 1, bias + P.o_b[0], hA, W, true, rb, wt);
  float* cur = hA;
  float* nxt = hB;
  for (int l = 1; l < P.depth0 - 1; ++l) {
    mlp_layer<T, W>({cur, W, W, wts + P.o_w[l]}, {}, 1, bias + P.o_b[l], nxt, W, true, rb, wt);
    float* tmp = cur; cur = nxt; nxt = tmp;
  }
  const int L = P.depth0 - 1;
  mlp_layer<T, 128>({cur, W, W, wts + P.o_w[L]}, {}, 1, bias + P.o_b[L], nxt, 128, false, false, wt);
  __syncthreads();
  const float* logits = nxt;

  // adaptive select: one warp per ray, bin = j*32 + lane
  const int lane = t & 31, wy = t >> 5;
  const int DJ = P.D / 32, S = P.S;
  for (int i = 0; i < 8; ++i) {
    const int row = wy * 8 + i, ray = ray0 + row;
    float d[4];
    bool keep[4];
    int n_pass = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      d[j] = j < DJ ? logits[row * 128 + j * 32 + lane] : neg_inf();
      keep[j] = j < DJ && d[j] >= P.threshold;
      n_pass += __popc(__ballot_sync(0xffffffffu, keep[j]));
    }
    if (n_pass > S) {  // keep the S largest, ties to the lower bin
#pragma unroll
      for (int j = 0; j < 4; ++j) keep[j] = false;
      for (int it = 0; it < S; ++it) {
        float bv = neg_inf();
        int bb = 1 << 30;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < DJ && !keep[j] && (d[j] > bv || bb == (1 << 30))) { bv = d[j]; bb = j * 32 + lane; }
        warp_argmax(bv, bb);
#pragma unroll
        for (int j = 0; j < 4; ++j) keep[j] = keep[j] || bb == j * 32 + lane;
      }
    } else if (n_pass == 0) {  // nothing passes: the argmax bin
      float bv = neg_inf();
      int bb = 1 << 30;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < DJ && (d[j] > bv || bb == (1 << 30))) { bv = d[j]; bb = j * 32 + lane; }
      warp_argmax(bv, bb);
#pragma unroll
      for (int j = 0; j < 4; ++j) keep[j] = bb == j * 32 + lane;
    }
    // slots in ascending bin order
    int n = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned m = __ballot_sync(0xffffffffu, keep[j]);
      if (keep[j] && ray < P.B) {
        const int s = n + __popc(m & ((1u << lane) - 1u));
        const float zu = ((float)(j * 32 + lane) + 0.5f) * (1.f / (float)P.D);
        float z = zu;
        if (P.z_mode == 1) z = powf(P.z_a, zu) - 1.f + P.z_b;
        else if (P.z_mode == 2) z = zu * P.z_a + P.z_b;
        zbuf[ray * S + s] = z;
        pbuf[ray * S + s] = d[j];
      }
      n += __popc(m);
    }
    if (ray < P.B) {
      if (lane >= n && lane < S) { zbuf[ray * S + lane] = 0.f; pbuf[ray * S + lane] = 0.f; }
      if (lane == 0) counts[ray] = n;
    }
    if (lane == 0) cnt_s[row] = ray < P.B ? n : 0;
  }
  __syncthreads();
  if (t == 0) {
    int tot = 0;
    for (int r = 0; r < R; ++r) { off_s[r] = tot; tot += cnt_s[r]; }
    base_s = atomicAdd(counter, tot);
  }
  __syncthreads();
  if (t < R) {
    const int ray = ray0 + t;
    for (int s = 0; s < cnt_s[t]; ++s) rows[base_s + off_s[t] + s] = ray * S + s;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
mk_shade(const MkParams P, const T* __restrict__ wts, const float* __restrict__ bias,
         const float* __restrict__ o_sh, const float* __restrict__ d_sh,
         const float* __restrict__ zbuf, const int* __restrict__ rows,
         const int* __restrict__ counter, float* __restrict__ raw) {
  extern __shared__ float4 smem4[];
  float* x = reinterpret_cast<float*>(smem4);
  float* hA = x + R * XS;
  float* hB = hA + R * W;
  float* wt = hB + R * W;
  __shared__ float coords[R][6];
  __shared__ float alpha_s[R];

  const int t = threadIdx.x, lane = t & 31, wy = t >> 5;
  const int total = *counter;
  const bool rb = P.bf16;
  for (int tile = blockIdx.x; tile * R < total; tile += gridDim.x) {
    __syncthreads();  // the previous tile's readers of coords / x are done
    if (t < R) {
      const int j = tile * R + t;
      float c[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j < total) {
        const int id = rows[j], r = id / P.S;
        const float z = zbuf[id];
        const float ox = o_sh[r * 3], oy = o_sh[r * 3 + 1], oz = o_sh[r * 3 + 2];
        const float dx = d_sh[r * 3], dy = d_sh[r * 3 + 1], dz = d_sh[r * 3 + 2];
        const float px = ox + dx * z, py = oy + dy * z, pz = oz + dz * z;
        if (P.norm_none) {
          c[0] = px; c[1] = py; c[2] = pz;
          float ex = dx, ey = dy, ez = dz;
          if (P.ndc) {  // encode the unit NDC direction
            const float nrm = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-24f));
            ex = dx / nrm; ey = dy / nrm; ez = dz / nrm;
          }
          c[3] = ex; c[4] = ey; c[5] = ez;
        } else {  // InverseSqrtDistCentered
          const float lx = px - P.center[0], ly = py - P.center[1], lz = pz - P.center[2];
          const float nrm = sqrtf(sqrtf(lx * lx + ly * ly + lz * lz));
          const float den = P.sqrt_max_depth * fmaxf(nrm, 1e-12f);
          c[0] = lx / den; c[1] = ly / den; c[2] = lz / den;
          c[3] = dx; c[4] = dy; c[5] = dz;
        }
      }
      for (int k = 0; k < 6; ++k) coords[t][k] = c[k];
    }
    __syncthreads();
    encode_tile(coords, x, P.in1, P.fp1, P.fd1, rb);

    // NeRF trunk; layer i takes [x, h] when bit i-1 of skip_mask is set
    mlp_layer<T, W>({x, XS, P.in1, wts + P.n_w[0]}, {}, 1, bias + P.n_b[0], hA, W, true, rb, wt);
    float* cur = hA;
    float* nxt = hB;
    for (int l = 1; l < P.depth1; ++l) {
      const Seg<T> sh{cur, W, W, wts + P.n_w[l]};
      if ((P.skip_mask >> (l - 1)) & 1)
        mlp_layer<T, W>(sh, {x, XS, P.in1, wts + P.n_wx[l]}, 2, bias + P.n_b[l], nxt, W, true, rb, wt);
      else
        mlp_layer<T, W>(sh, {}, 1, bias + P.n_b[l], nxt, W, true, rb, wt);
      float* tmp = cur; cur = nxt; nxt = tmp;
    }
    // feature = h @ wf + bf (no activation) into the other buffer
    mlp_layer<T, W>({cur, W, W, wts + P.n_wf}, {}, 1, bias + P.n_bf, nxt, W, false, rb, wt);
    __syncthreads();
    // alpha head: one warp per row, lanes split K
    for (int i = 0; i < 8; ++i) {
      const int row = wy * 8 + i;
      float s = 0.f;
      for (int k = lane; k < W; k += 32) s = fmaf(cur[row * W + k], to_f(wts[P.n_wa + k]), s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) alpha_s[row] = s + bias[P.n_ba];
    }
    // views = relu([feature, dirs] @ wv + bv), 128 wide, written over the trunk
    mlp_layer<T, 128>({nxt, W, W, wts + P.n_wvf}, {x, XS, P.in1, wts + P.n_wvd}, 2,
                      bias + P.n_bv, cur, 128, true, rb, wt);
    __syncthreads();
    // rgb head and the write-back by (ray, slot)
    for (int i = 0; i < 8; ++i) {
      const int row = wy * 8 + i;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int k = lane; k < 128; k += 32) {
        const float h = cur[row * 128 + k];
        s0 = fmaf(h, to_f(wts[P.n_wrgb + k * 3 + 0]), s0);
        s1 = fmaf(h, to_f(wts[P.n_wrgb + k * 3 + 1]), s1);
        s2 = fmaf(h, to_f(wts[P.n_wrgb + k * 3 + 2]), s2);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      const int j = tile * R + row;
      if (lane == 0 && j < total) {
        const int id = rows[j];
        *reinterpret_cast<float4*>(raw + (size_t)id * 4) =
            make_float4(s0 + bias[P.n_brgb], s1 + bias[P.n_brgb + 1],
                        s2 + bias[P.n_brgb + 2], alpha_s[row]);
      }
    }
  }
}

__global__ void mk_composite(const MkParams P, const float* __restrict__ raw,
                             const float* __restrict__ pbuf, const int* __restrict__ counts,
                             float* __restrict__ rgb) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= P.B) return;
  const int c = counts[r];
  float tr = 1.f, cr = 0.f, cg = 0.f, cb = 0.f;
  for (int s = 0; s < c; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(raw + ((size_t)r * P.S + s) * 4);
    const float p = pbuf[r * P.S + s];
    float a = 1.f / (1.f + expf(-v.w));
    if (P.acc_mode == 1) a *= p;
    float w = a * tr;
    if (P.acc_mode == 2) w *= p;
    tr *= (1.f - a + 1e-10f);
    cr += w * (1.f / (1.f + expf(-v.x)));
    cg += w * (1.f / (1.f + expf(-v.y)));
    cb += w * (1.f / (1.f + expf(-v.z)));
  }
  rgb[r * 3] = cr;
  rgb[r * 3 + 1] = cg;
  rgb[r * 3 + 2] = cb;
}

template <typename T>
cudaError_t launch_all(const MkParams& P, const float* dirs, const float* pose,
                       const float* rot, const void* wts, const float* bias, float* o_sh,
                       float* d_sh, float* zbuf, float* pbuf, int* counts, int* rows,
                       int* counter, float* raw, float* rgb, cudaStream_t stream) {
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(mk_front<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)SMEM_BYTES)) != cudaSuccess) return e;
  if ((e = cudaFuncSetAttribute(mk_shade<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)SMEM_BYTES)) != cudaSuccess) return e;
  if ((e = cudaMemsetAsync(counter, 0, sizeof(int), stream)) != cudaSuccess) return e;
  const T* w = static_cast<const T*>(wts);
  mk_front<T><<<(P.B + R - 1) / R, NT, SMEM_BYTES, stream>>>(
      P, dirs, pose, rot, w, bias, o_sh, d_sh, zbuf, pbuf, counts, rows, counter);
  if ((e = cudaGetLastError()) != cudaSuccess || P.stages < 2) return e;
  mk_shade<T><<<P.shade_blocks, NT, SMEM_BYTES, stream>>>(P, w, bias, o_sh, d_sh, zbuf,
                                                          rows, counter, raw);
  if ((e = cudaGetLastError()) != cudaSuccess || P.stages < 3) return e;
  mk_composite<<<(P.B + 255) / 256, 256, 0, stream>>>(P, raw, pbuf, counts, rgb);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mk_compact_launch(int device, const MkParams* P, const float* dirs, const float* pose,
                                 const float* rot, const void* wts, const float* bias,
                                 float* o_sh, float* d_sh, float* zbuf, float* pbuf,
                                 int* counts, int* rows, int* counter, float* raw,
                                 float* rgb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = P->bf16
      ? launch_all<__nv_bfloat16>(*P, dirs, pose, rot, wts, bias, o_sh, d_sh, zbuf, pbuf,
                                  counts, rows, counter, raw, rgb, s)
      : launch_all<float>(*P, dirs, pose, rot, wts, bias, o_sh, d_sh, zbuf, pbuf, counts,
                          rows, counter, raw, rgb, s);
  return static_cast<int>(e);
}

extern "C" int mk_struct_size() { return static_cast<int>(sizeof(MkParams)); }
