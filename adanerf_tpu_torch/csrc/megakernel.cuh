// The kernels shared by the two frame renderers for Hopper (sm_90a): K1,
// the compacted renderer (megakernel_compact.cu), and K2, the dense-slot
// renderer (megakernel_dense.cu). The DENSE template flag is K2: it shades
// every slot of every ray and masks the dead ones in the composite, where
// K1 shades only the live samples. Three launches on the caller's stream:
// a front (ray setup, oracle, select), a shade (the NeRF) and mk_composite
// (see megakernel_compact.cu).
//
// Two precisions. fp32 weights run mk_front / mk_shade, whose MLPs are
// mlp_tile.cuh's fp32 FMA layer: the exact reference. bf16 weights run
// mk_front_tc / mk_shade_tc, whose MLPs run on the tensor cores through
// mlp_wgmma.cuh. Ray setup, the encode, the select, the sample coordinates
// and the alpha and rgb heads are device functions that both share.
//
// Both MLPs are W wide (mlp_tile.cuh's MLP_WIDTH: 128, 256, 384 or 512, one
// library per width), the views layer W / 2.

#pragma once

#include "mlp_tile.cuh"
#include "mlp_wgmma.cuh"

namespace {

constexpr int XS = 128;    // row stride of the encoded-input buffer
constexpr int MAXL = 16;   // most layers per MLP
constexpr int VW = W / 2;  // the views layer's width

constexpr size_t SMEM_BYTES = sizeof(float) * (R * XS + 2 * R * W + KC * W);

}  // namespace

extern "C" {

// Mirrored field for field by the ctypes Structure in megakernel_compact.py.
// rows and counter are K1's only; K2 passes null for both.
struct MkParams {
  long long o_w[MAXL], o_b[MAXL];     // oracle layer weight / bias offsets
  long long n_w[MAXL], n_wx[MAXL], n_b[MAXL];  // NeRF trunk (+ skip input)
  long long n_wa, n_ba, n_wf, n_bf, n_wvf, n_wvd, n_bv, n_wrgb, n_brgb;
  int B, S, D;          // rays, sample slots, oracle bins
  int in0, in1;         // padded encoded input widths (multiples of 32; of 64 for bf16)
  int fd0, fp0, fp1, fd1;  // encode frequencies: oracle dir/pos, NeRF pos/dir
  int depth0, depth1, skip_mask;  // layers; bit i: NeRF layer i+1 takes [x, h]
  int z_mode;           // 0 raw [0,1] z, 1 log, 2 linear depth transform
  int ndc;              // shading rays in NDC space
  int norm_none;        // 1: "None" normalization, 0: InverseSqrtDistCentered
  int acc_mode;         // 0 none, 1 alpha premultiply, 2 weights premultiply
  int bf16;             // weights are bf16, activations rounded to bf16
  int stages;           // 1 front only, 2 + shade, 3 + composite
  int shade_blocks;     // persistent grid (SMs): the shade; the bf16 front too
  float threshold, radius2, sqrt_max_depth;
  float center[3];
  float z_a, z_b;       // log: a^z - 1 + b; linear: z * a + b
  float ndc_wf, ndc_hf; // -2 focal / w, -2 focal / h
};

}  // extern "C"

namespace {

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

__device__ __forceinline__ void put_bf16(uint8_t* x, int row, int col, float v) {
  *reinterpret_cast<__nv_bfloat16*>(x + sw128(row, col)) = __float2bfloat16_rn(v);
}

// Element i (< 6) of c, without indexing a register array at run time.
__device__ __forceinline__ float pick6(const float (&c)[6], int i) {
  float v = c[0];
#pragma unroll
  for (int q = 1; q < 6; ++q) v = i == q ? c[q] : v;
  return v;
}

// Encode one row into the bf16 tile x (`width` columns, a multiple of 64,
// in mlp_wgmma.cuh's layout): encode_col's columns, but one sincosf (one
// argument reduction) gives a coordinate's sin and cos at a frequency. The
// coordinates are in registers; thread `half` of the row's pair takes every
// other item, and part `part` of `nparts` a contiguous share of them.
__device__ __forceinline__ void encode_row_bf16(const float (&c)[6], uint8_t* x, int row, int width,
                                                int fa, int fb, int half, int part, int nparts) {
  const int wa = 3 * (2 * fa + 1), wb = 3 * (2 * fb + 1);
  const int np = 6 + width - wa - wb, nt = 3 * (fa + fb);
  const int mine = (np + nt + 1 - half) / 2;
  for (int m = mine * part / nparts; m < mine * (part + 1) / nparts; ++m) {
    int k = 2 * m + half;
    if (k < np) {
      const int col = k < 3 ? k : (k < 6 ? wa + k - 3 : wa + wb + k - 6);
      put_bf16(x, row, col, k < 6 ? pick6(c, k) : 0.f);
    } else {
      k -= np;
      int base = 3, d0 = 0;
      if (k >= 3 * fa) { k -= 3 * fa; base = wa + 3; d0 = 3; }
      const int f = k / 3, d = k % 3;
      float sv, cv;
      sincosf(pick6(c, d0 + d) * ldexpf(1.f, f), &sv, &cv);
      put_bf16(x, row, base + 6 * f + d, sv);
      put_bf16(x, row, base + 6 * f + 3 + d, cv);
    }
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

// Ray `ray` (a padding ray past P.B has a zero direction): its world
// direction and exit point on the view-cell sphere into c[0:6], and for a
// real ray the shading ray (o_sh, d_sh), in NDC space when P.ndc.
__device__ __forceinline__ void ray_setup(const MkParams& P, const float* __restrict__ dirs,
                                          const float* __restrict__ pose,
                                          const float* __restrict__ rot, int ray, float* c,
                                          float* __restrict__ o_sh, float* __restrict__ d_sh) {
  float dx = 0.f, dy = 0.f, dz = 0.f;
  if (ray < P.B) { dx = dirs[ray * 3]; dy = dirs[ray * 3 + 1]; dz = dirs[ray * 3 + 2]; }
  // world dirs = rot @ dir, each product and sum rounded as the plain
  // version's (realtime.py::world_dirs): no fused multiply-add, so both
  // shade the same rays bit for bit (NDC shading is sensitive to an ulp)
  const float nx = __fadd_rn(__fadd_rn(__fmul_rn(dx, rot[0]), __fmul_rn(dy, rot[1])),
                             __fmul_rn(dz, rot[2]));
  const float ny = __fadd_rn(__fadd_rn(__fmul_rn(dx, rot[3]), __fmul_rn(dy, rot[4])),
                             __fmul_rn(dz, rot[5]));
  const float nz = __fadd_rn(__fadd_rn(__fmul_rn(dx, rot[6]), __fmul_rn(dy, rot[7])),
                             __fmul_rn(dz, rot[8]));
  const float ox = pose[0], oy = pose[1], oz = pose[2];
  // exit point on the view-cell sphere
  const float mx = ox - P.center[0], my = oy - P.center[1], mz = oz - P.center[2];
  const float u = mx * nx + my * ny + mz * nz;
  const float delta = u * u - ((mx * mx + my * my + mz * mz) - P.radius2);
  const float dist = -u + sqrtf(fmaxf(delta, 0.f));
  const float px = ox + nx * dist, py = oy + ny * dist, pz = oz + nz * dist;
  c[0] = nx; c[1] = ny; c[2] = nz;
  c[3] = px; c[4] = py; c[5] = pz;
  if (ray < P.B) {
    float so[3] = {px, py, pz}, sd[3] = {nx, ny, nz};
    if (P.ndc) {  // ndc_rays with near = 1, from the un-projected origin,
      // rounded as ops/raymarch.py::ndc_rays rounds (2 / q = 2 x (1 / q) exactly)
      const float ts = -(1.f + oz) / nz;
      const float qx = __fadd_rn(ox, __fmul_rn(ts, nx)), qy = __fadd_rn(oy, __fmul_rn(ts, ny)),
                  qz = __fadd_rn(oz, __fmul_rn(ts, nz));
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

// Adaptive select of one ray's bins from its raw logits (D values), by a
// whole warp, bin = j*32 + lane: the bins at or above the threshold, the S
// largest of them if more pass (ties to the lower bin), the argmax bin if
// none does. Writes the ray's slots in ascending bin order and its count.
// DENSE (K2): dead slots get bin 0's depth and p 0; otherwise (K1) z 0 and
// p 0. Returns the count, 0 for a padding ray.
template <bool DENSE>
__device__ __forceinline__ int select_row(const MkParams& P, const float* logits, int ray,
                                          float* __restrict__ zbuf, float* __restrict__ pbuf,
                                          int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int DJ = P.D / 32, S = P.S;
  float d[4];
  bool keep[4];
  int n_pass = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d[j] = j < DJ ? logits[j * 32 + lane] : neg_inf();
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
    if (lane >= n && lane < S) {
      float z = 0.f;
      if constexpr (DENSE) {  // bin 0's depth, shaded and masked in the composite
        z = 0.5f * (1.f / (float)P.D);
        if (P.z_mode == 1) z = powf(P.z_a, z) - 1.f + P.z_b;
        else if (P.z_mode == 2) z = z * P.z_a + P.z_b;
      }
      zbuf[ray * S + lane] = z;
      pbuf[ray * S + lane] = 0.f;
    }
    if (lane == 0) counts[ray] = n;
  }
  return ray < P.B ? n : 0;
}

// Sample `id` = ray * S + slot: its normalized position and the direction
// to encode, into c[0:6].
__device__ __forceinline__ void sample_coords(const MkParams& P, const float* __restrict__ o_sh,
                                              const float* __restrict__ d_sh,
                                              const float* __restrict__ zbuf, int id, float* c) {
  const int r = id / P.S;
  const float z = zbuf[id];
  const float ox = o_sh[r * 3], oy = o_sh[r * 3 + 1], oz = o_sh[r * 3 + 2];
  const float dx = d_sh[r * 3], dy = d_sh[r * 3 + 1], dz = d_sh[r * 3 + 2];
  // o + d z and the unit direction rounded as the plain version's
  // (realtime.py::_shade_stage, unit): the position encode's top frequency
  // turns an ulp of the position into a visible change of an NDC sample
  const float px = __fadd_rn(ox, __fmul_rn(dx, z)), py = __fadd_rn(oy, __fmul_rn(dy, z)),
              pz = __fadd_rn(oz, __fmul_rn(dz, z));
  if (P.norm_none) {
    c[0] = px; c[1] = py; c[2] = pz;
    float ex = dx, ey = dy, ez = dz;
    if (P.ndc) {  // encode the unit NDC direction
      const float nrm = sqrtf(fmaxf(
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)), 1e-24f));
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

// The alpha head of one row, by a whole warp, lanes split K: the trunk
// output act(k), k < W, dotted with the head's weight column.
template <typename T, class Act>
__device__ __forceinline__ float alpha_dot(Act act, const T* __restrict__ w) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int k = lane; k < W; k += 32) s = fmaf(act(k), to_f(w[k]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The rgb head of one row, likewise: the views output act(k), k < VW,
// times the VW x 3 weights.
template <typename T, class Act>
__device__ __forceinline__ float3 rgb_dot(Act act, const T* __restrict__ w) {
  const int lane = threadIdx.x & 31;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int k = lane; k < VW; k += 32) {
    const float h = act(k);
    s0 = fmaf(h, to_f(w[k * 3 + 0]), s0);
    s1 = fmaf(h, to_f(w[k * 3 + 1]), s1);
    s2 = fmaf(h, to_f(w[k * 3 + 2]), s2);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  return make_float3(s0, s1, s2);
}

// ---- fp32: the FMA kernels (mlp_tile.cuh), a 64-row tile per block ----

// DENSE (K2) reserves no compact rows; K1 reserves the block's live rows
// with one atomicAdd.
template <typename T, bool DENSE>
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
  if (t < R) ray_setup(P, dirs, pose, rot, ray0 + t, coords[t], o_sh, d_sh);
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

  // adaptive select: one warp per ray
  const int lane = t & 31, wy = t >> 5;
  for (int i = 0; i < RW; ++i) {
    const int row = wy * RW + i;
    const int n = select_row<DENSE>(P, logits + row * 128, ray0 + row, zbuf, pbuf, counts);
    if (lane == 0) cnt_s[row] = n;
  }
  if constexpr (DENSE) return;
  __syncthreads();
  if (t == 0) {
    int tot = 0;
    for (int r = 0; r < R; ++r) { off_s[r] = tot; tot += cnt_s[r]; }
    base_s = atomicAdd(counter, tot);
  }
  __syncthreads();
  if (t < R) {
    const int ray = ray0 + t;
    for (int s = 0; s < cnt_s[t]; ++s) rows[base_s + off_s[t] + s] = ray * P.S + s;
  }
}

// Rows are (ray, slot) samples: the compact rows of K1, or all B*S slots in
// order for DENSE (K2).
template <typename T, bool DENSE>
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
  const int total = DENSE ? P.B * P.S : *counter;
  const bool rb = P.bf16;
  for (int tile = blockIdx.x; tile * R < total; tile += gridDim.x) {
    __syncthreads();  // the previous tile's readers of coords / x are done
    if (t < R) {
      const int j = tile * R + t;
      float c[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j < total) sample_coords(P, o_sh, d_sh, zbuf, DENSE ? j : rows[j], c);
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
    // alpha head: one warp per row
    for (int i = 0; i < RW; ++i) {
      const int row = wy * RW + i;
      const float s = alpha_dot([&](int k) { return cur[row * W + k]; }, wts + P.n_wa);
      if (lane == 0) alpha_s[row] = s + bias[P.n_ba];
    }
    // views = relu([feature, dirs] @ wv + bv), VW wide, written over the trunk
    mlp_layer<T, VW>({nxt, W, W, wts + P.n_wvf}, {x, XS, P.in1, wts + P.n_wvd}, 2,
                     bias + P.n_bv, cur, VW, true, rb, wt);
    __syncthreads();
    // rgb head and the write-back by (ray, slot)
    for (int i = 0; i < RW; ++i) {
      const int row = wy * RW + i;
      const float3 s = rgb_dot([&](int k) { return cur[row * VW + k]; }, wts + P.n_wrgb);
      const int j = tile * R + row;
      if (lane == 0 && j < total) {
        const int id = DENSE ? j : rows[j];
        *reinterpret_cast<float4*>(raw + (size_t)id * 4) =
            make_float4(s.x + bias[P.n_brgb], s.y + bias[P.n_brgb + 1],
                        s.z + bias[P.n_brgb + 2], alpha_s[row]);
      }
    }
  }
}

// ---- bf16: the tensor-core kernels (mlp_wgmma.cuh) ----
//
// A persistent block of three warpgroups walks 128-row tiles: warpgroup 0
// is the producer, 1 and 2 the consumers. Each consumer owns 64 rows of the
// tile and does all the per-row work of its rows (ray setup or sample
// coordinates, encode, select or heads) between its layers, under barriers
// of its own. A layer's output is written over the tile's activations h
// once every wgmma of the layer has completed (a 384- or 512-column layer,
// two wgmma passes, parks its first pass in registers until then:
// mlp_wgmma.cuh's tc_passes); the oracle's 64 x 128 fp32 logits reuse h
// too. Shared memory, from its 1024-byte aligned base: the stage ring,
// MK_XB x buffers and h of each consumer, then TcSmall, at most 232,448
// bytes at every width: a 3-stage ring and two x buffers up to W = 256,
// one x buffer at 384 and also a 2-stage ring at 512. With two x buffers
// the shade encodes the next tile into its other x buffer while the
// current tile's layers run, each thread pair holding its row's
// coordinates in registers; with one it encodes a tile before its layers.
// The front, whose x is free once layer 0 is done, encodes the next tile
// into its one x buffer under layers 1.. at every width.

constexpr int TC_THREADS = 384;
constexpr int TC_TILE = 2 * TC_ROWS;           // rows per block tile
constexpr int MK_STAGES = W <= 384 ? TC_STAGES : 2;
constexpr int MK_XB = W <= 256 ? 2 : 1;
using MkRing = RingN<MK_STAGES>;
constexpr int TC_X_BYTES = TC_ROWS * 128 * 2;  // encoded input, at most 128 columns
// activations; or 64 x 128 fp32 logits
constexpr int TC_H_BYTES = W * 2 > 128 * 4 ? TC_ROWS * W * 2 : TC_ROWS * 128 * 4;
constexpr int TC_OFF_X = MK_STAGES * TC_STAGE_BYTES;
constexpr int TC_OFF_H = TC_OFF_X + 2 * MK_XB * TC_X_BYTES;
constexpr int TC_OFF_SMALL = TC_OFF_H + 2 * TC_H_BYTES;

struct TcSmall {
  unsigned long long full[MK_STAGES], empty[MK_STAGES];
  float alpha[TC_TILE];
  int cnt[TC_TILE], off[TC_TILE], base[2];
};

constexpr size_t TC_SMEM_BYTES = TC_OFF_SMALL + sizeof(TcSmall);
static_assert(TC_SMEM_BYTES <= 232448 && SMEM_BYTES <= 232448, "a block's shared memory");

// h = round_bf16(relu?(A @ W + bias)) for an N-column layer over the ring's
// next chunks (A = [a0 | a1], kc0 + kc1 chunks a pass). IN_PLACE: A reads
// h, so h is written once every warp's wgmmas of the layer are done, and a
// 384- or 512-column layer parks its first pass's output in registers
// until then.
template <int N, bool IN_PLACE, class Side>
__device__ __forceinline__ void tc_hidden(MkRing& ring, uint32_t a0, int kc0, uint32_t a1,
                                          int kc1, Side side, const float* bias, bool relu,
                                          uint8_t* h, int bar) {
  uint32_t park[64];  // used where N > 256
  tc_passes<N>(ring, a0, kc0, a1, kc1, side, [&](auto c0, auto& acc) {
    constexpr int C0 = decltype(c0)::value, NP = acc_cols<decltype(acc)>;
    if constexpr (IN_PLACE && C0 + NP < N) {
      tc_pack_bf16<NP>(acc, bias + C0, relu, park);
    } else {
      if constexpr (IN_PLACE) wg_sync(bar);  // every warp's wgmma has read h
      tc_store_bf16<NP>(acc, bias + C0, relu, h + (C0 / 64) * TC_BLOCK_BYTES);
      if constexpr (IN_PLACE && C0 > 0) tc_put_packed<256>(park, h);
    }
  });
}

// Weight layer l of a kernel's stream: kc0 chunks multiply the first input
// (the encoded x for layer 0, else the tile's activations h), kc1 chunks the
// encoded input x (a NeRF skip layer, the views layer), and n output
// columns (a layer wider than 256 comes pass by pass: tc_passes). The front
// walks the oracle (depth0 layers, the last 128 wide); the shade walks the
// NeRF trunk (depth1 layers), the feature layer and the views layer (VW
// wide). megakernel_compact.py packs the stream in this order (stream_plan
// mirrors this function).
__device__ __forceinline__ void tc_plan(const MkParams& P, bool front, int l, int& kc0, int& kc1,
                                        int& n) {
  if (front) {
    kc0 = l == 0 ? P.in0 / TC_KC : W / TC_KC;
    kc1 = 0;
    n = l == P.depth0 - 1 ? 128 : W;
    return;
  }
  kc0 = l == 0 ? P.in1 / TC_KC : W / TC_KC;
  const bool skip = l > 0 && l < P.depth1 && ((P.skip_mask >> (l - 1)) & 1);
  kc1 = skip || l == P.depth1 + 1 ? P.in1 / TC_KC : 0;
  n = l == P.depth1 + 1 ? VW : W;
}

__device__ __forceinline__ int tc_layers(const MkParams& P, bool front) {
  return front ? P.depth0 : P.depth1 + 2;
}

// The producer: one thread walks the stream once per tile the block owns,
// keeping up to MK_STAGES chunks in flight.
__device__ void tc_produce(const MkParams& P, bool front, const __nv_bfloat16* stream,
                           int ntiles, uint32_t full, uint32_t empty, uint32_t buf) {
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const char* src = reinterpret_cast<const char*>(stream);
    for (int l = 0; l < tc_layers(P, front); ++l) {
      int kc0, kc1, n;
      tc_plan(P, front, l, kc0, kc1, n);
      for (int c0 = 0; c0 < n; c0 += 256) {
        const uint32_t bytes = (n - c0 < 256 ? n - c0 : 256) * TC_KC * 2;
        for (int c = 0; c < kc0 + kc1; ++c) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          bulk_load(buf + stage * TC_STAGE_BYTES, src, bytes, full + 8 * stage);
          src += bytes;
          if (++stage == MK_STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  }
}

// The shared-memory carve-up and barrier set-up of both tensor-core
// kernels; the producer warpgroup walks `stream` and returns false, a
// consumer returns true with its ring.
struct TcBlock {
  uint8_t* sm;
  TcSmall* small;
  MkRing ring;

  __device__ __forceinline__ bool start(float4* smem4, const MkParams& P, bool front,
                                        const __nv_bfloat16* stream, int ntiles) {
    sm = reinterpret_cast<uint8_t*>(smem4);
    if (smem_u32(sm) & 1023) __trap();  // the swizzle needs 1024-byte aligned tiles
    small = reinterpret_cast<TcSmall*>(sm + TC_OFF_SMALL);
    ring = MkRing{smem_u32(small->full), smem_u32(small->empty), smem_u32(sm), 0, 0};
    if (threadIdx.x == 0) {
      for (int i = 0; i < MK_STAGES; ++i) {
        mbar_init(ring.full + 8 * i, 1);
        mbar_init(ring.empty + 8 * i, TC_CONSUMER_WARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < 128) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
      if (threadIdx.x == 0) tc_produce(P, front, stream, ntiles, ring.full, ring.empty, ring.buf);
      return false;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    return true;
  }
  __device__ __forceinline__ int g() const { return (threadIdx.x >> 7) - 1; }
  __device__ __forceinline__ uint8_t* x(int b) const {
    return sm + TC_OFF_X + (MK_XB * g() + (MK_XB == 2 ? b : 0)) * TC_X_BYTES;
  }
  __device__ __forceinline__ uint8_t* h() const { return sm + TC_OFF_H + g() * TC_H_BYTES; }
};

template <bool DENSE>
__global__ void __launch_bounds__(TC_THREADS, 1)
mk_front_tc(const MkParams P, const float* __restrict__ dirs, const float* __restrict__ pose,
            const float* __restrict__ rot, const __nv_bfloat16* __restrict__ wts,
            const float* __restrict__ bias, float* __restrict__ o_sh, float* __restrict__ d_sh,
            float* __restrict__ zbuf, float* __restrict__ pbuf, int* __restrict__ counts,
            int* __restrict__ rows, int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  TcBlock blk;
  const int ntiles = (P.B + TC_TILE - 1) / TC_TILE;
  if (!blk.start(smem4, P, true, wts + P.o_w[0], ntiles)) return;
  const int g = blk.g(), bar = 1 + g, tl = threadIdx.x & 127, lane = tl & 31, wq = tl >> 5;
  uint8_t* x = blk.x(0);
  uint8_t* h = blk.h();
  const uint32_t xa = smem_u32(x), ha = smem_u32(h);
  TcSmall& s = *blk.small;
  float* logits = reinterpret_cast<float*>(h);

  // A tile's rays are set up and encoded while the previous tile's layers
  // 1.. run (x is free once layer 0 is done): threads 2r and 2r + 1 own
  // row r, slot 0 sets up its ray (both write the same shading ray), slots
  // 1.. encode, one part each.
  constexpr int PARTS = 8;
  float cr[6];
  auto prep = [&](int tile, int slot) {
    if (slot == 0)
      ray_setup(P, dirs, pose, rot, tile * TC_TILE + g * TC_ROWS + tl / 2, cr, o_sh, d_sh);
    else if (slot <= PARTS)
      encode_row_bf16(cr, x, tl / 2, P.in0, P.fd0, P.fp0, tl & 1, slot - 1, PARTS);
  };
  if (blockIdx.x < ntiles)
    for (int slot = 0; slot <= PARTS; ++slot) prep(blockIdx.x, slot);

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int ray0 = tile * TC_TILE + g * TC_ROWS, next = tile + gridDim.x;
    int slot = 0;
    auto side = [&](int) {
      if (next < ntiles) prep(next, slot);
      ++slot;
    };
    fence_async_smem();
    wg_sync(bar);  // x is encoded; the previous tile's select is done with h

    // oracle MLP: relu trunk, raw logits out (padded to 128 columns)
    tc_hidden<W, false>(blk.ring, xa, P.in0 / TC_KC, 0, 0, [](int) {}, bias + P.o_b[0], true, h,
                        bar);
    for (int l = 1; l < P.depth0 - 1; ++l) {
      fence_async_smem();
      wg_sync(bar);
      tc_hidden<W, true>(blk.ring, ha, W / TC_KC, 0, 0, side, bias + P.o_b[l], true, h, bar);
    }
    fence_async_smem();
    wg_sync(bar);
    float lg[64];
    tc_layer<128>(blk.ring, lg, ha, W / TC_KC, 0, 0, side);
    while (slot <= PARTS) side(0);  // a shallow oracle leaves parts over
    wg_sync(bar);
    tc_store_f32(lg, bias + P.o_b[P.depth0 - 1], logits);
    wg_sync(bar);

    // adaptive select: one warp per ray
    for (int i = 0; i < TC_ROWS / 4; ++i) {
      const int row = wq * (TC_ROWS / 4) + i;
      const int n = select_row<DENSE>(P, logits + row * 128, ray0 + row, zbuf, pbuf, counts);
      if (lane == 0) s.cnt[g * TC_ROWS + row] = n;
    }
    if constexpr (!DENSE) {  // reserve this warpgroup's live rows
      wg_sync(bar);
      int* cnt = s.cnt + g * TC_ROWS;
      int* off = s.off + g * TC_ROWS;
      if (tl == 0) {
        int tot = 0;
        for (int r = 0; r < TC_ROWS; ++r) { off[r] = tot; tot += cnt[r]; }
        s.base[g] = atomicAdd(counter, tot);
      }
      wg_sync(bar);
      if (tl < TC_ROWS)
        for (int k = 0; k < cnt[tl]; ++k) rows[s.base[g] + off[tl] + k] = (ray0 + tl) * P.S + k;
    }
  }
}

template <bool DENSE>
__global__ void __launch_bounds__(TC_THREADS, 1)
mk_shade_tc(const MkParams P, const __nv_bfloat16* __restrict__ wts,
            const float* __restrict__ bias, const float* __restrict__ o_sh,
            const float* __restrict__ d_sh, const float* __restrict__ zbuf,
            const int* __restrict__ rows, const int* __restrict__ counter,
            float* __restrict__ raw) {
  extern __shared__ float4 smem4[];
  TcBlock blk;
  const int total = DENSE ? P.B * P.S : *counter;
  const int ntiles = (total + TC_TILE - 1) / TC_TILE;
  if (!blk.start(smem4, P, false, wts + P.n_w[0], ntiles)) return;
  const int g = blk.g(), bar = 1 + g, tl = threadIdx.x & 127, lane = tl & 31, wq = tl >> 5;
  uint8_t* h = blk.h();
  const uint32_t ha = smem_u32(h);
  TcSmall& s = *blk.small;
  float* alpha_s = s.alpha + g * TC_ROWS;
  const int kx = P.in1 / TC_KC;

  // A tile's sample coordinates and encode are made while the previous
  // tile's layers run, into the x buffer it does not read: threads 2r and
  // 2r + 1 own row r, slot 0 takes its coordinates into registers, slots
  // 1.. encode, one part each.
  constexpr int PARTS = 8;
  float cr[6];
  auto prep = [&](int tile, uint8_t* xn, int slot) {
    if (slot == 0) {
      const int j = tile * TC_TILE + g * TC_ROWS + tl / 2;
#pragma unroll
      for (int k = 0; k < 6; ++k) cr[k] = 0.f;
      if (j < total) sample_coords(P, o_sh, d_sh, zbuf, DENSE ? j : rows[j], cr);
    } else if (slot <= PARTS) {
      encode_row_bf16(cr, xn, tl / 2, P.in1, P.fp1, P.fd1, tl & 1, slot - 1, PARTS);
    }
  };
  if (MK_XB == 2 && blockIdx.x < ntiles)
    for (int slot = 0; slot <= PARTS; ++slot) prep(blockIdx.x, blk.x(0), slot);

  int b = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, b ^= 1) {
    const int j0 = tile * TC_TILE + g * TC_ROWS, next = tile + gridDim.x;
    const uint32_t xa = smem_u32(blk.x(b));
    if constexpr (MK_XB == 1)  // the previous tile's views layer is done with x
      for (int slot = 0; slot <= PARTS; ++slot) prep(tile, blk.x(0), slot);
    int slot = 0;
    auto side = [&](int) {
      if constexpr (MK_XB == 2) {
        if (next < ntiles) prep(next, blk.x(b ^ 1), slot);
        ++slot;
      }
    };
    fence_async_smem();
    wg_sync(bar);  // x(b) is encoded; the previous tile's readers of h are done

    // NeRF trunk; layer i takes [h, x] when bit i-1 of skip_mask is set
    tc_hidden<W, false>(blk.ring, xa, kx, 0, 0, [](int) {}, bias + P.n_b[0], true, h, bar);
    for (int l = 1; l < P.depth1; ++l) {
      fence_async_smem();
      wg_sync(bar);
      tc_hidden<W, true>(blk.ring, ha, W / TC_KC, xa, ((P.skip_mask >> (l - 1)) & 1) ? kx : 0,
                         side, bias + P.n_b[l], true, h, bar);
    }
    if constexpr (MK_XB == 2)
      while (slot <= PARTS) side(0);  // a shallow NeRF leaves parts over
    fence_async_smem();
    wg_sync(bar);
    // feature = h @ wf + bf (no activation); the alpha head reads the trunk
    // output while the feature layer's wgmmas run, its share of a warp's
    // rows under each of the layer's CF chunks, before the epilogue
    // overwrites h
    constexpr int CF = (W / TC_KC) * ((W + 255) / 256), RQ = TC_ROWS / 4;
    tc_hidden<W, true>(blk.ring, ha, W / TC_KC, 0, 0, [&](int c) {
      for (int r = RQ * c / CF; r < RQ * (c + 1) / CF; ++r) {
        const int row = wq * RQ + r;
        const float a = alpha_dot([&](int k) { return ld_bf16(h, row, k); }, wts + P.n_wa);
        if (lane == 0) alpha_s[row] = a + bias[P.n_ba];
      }
    }, bias + P.n_bf, false, h, bar);
    fence_async_smem();
    wg_sync(bar);
    // views = relu([feature, dirs] @ wv + bv), VW wide
    tc_hidden<VW, true>(blk.ring, ha, W / TC_KC, xa, kx, [](int) {}, bias + P.n_bv, true, h, bar);
    wg_sync(bar);
    // rgb head and the write-back by (ray, slot)
    for (int i = 0; i < TC_ROWS / 4; ++i) {
      const int row = wq * (TC_ROWS / 4) + i;
      const float3 o = rgb_dot([&](int k) { return ld_bf16(h, row, k); }, wts + P.n_wrgb);
      const int j = j0 + row;
      if (lane == 0 && j < total) {
        const int id = DENSE ? j : rows[j];
        *reinterpret_cast<float4*>(raw + (size_t)id * 4) =
            make_float4(o.x + bias[P.n_brgb], o.y + bias[P.n_brgb + 1],
                        o.z + bias[P.n_brgb + 2], alpha_s[row]);
      }
    }
  }
}

// K1 walks the live slots; DENSE (K2) walks all S, alpha times live.
template <bool DENSE>
__global__ void mk_composite(const MkParams P, const float* __restrict__ raw,
                             const float* __restrict__ pbuf, const int* __restrict__ counts,
                             float* __restrict__ rgb) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= P.B) return;
  const int c = counts[r];
  float tr = 1.f, cr = 0.f, cg = 0.f, cb = 0.f;
  for (int s = 0; s < (DENSE ? P.S : c); ++s) {
    const float4 v = *reinterpret_cast<const float4*>(raw + ((size_t)r * P.S + s) * 4);
    const float p = pbuf[r * P.S + s];
    float a = 1.f / (1.f + expf(-v.w));
    if constexpr (DENSE) a *= s < c ? 1.f : 0.f;
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

// fp32 weights (T = float) run the FMA kernels, bf16 weights the
// tensor-core kernels; the composite is the same.
template <typename T, bool DENSE>
cudaError_t launch_all(const MkParams& P, const float* dirs, const float* pose,
                       const float* rot, const void* wts, const float* bias, float* o_sh,
                       float* d_sh, float* zbuf, float* pbuf, int* counts, int* rows,
                       int* counter, float* raw, float* rgb, cudaStream_t stream) {
  cudaError_t e;
  const T* w = static_cast<const T*>(wts);
  if constexpr (sizeof(T) == sizeof(float)) {
    if ((e = cudaFuncSetAttribute(mk_front<T, DENSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)SMEM_BYTES)) != cudaSuccess) return e;
    if ((e = cudaFuncSetAttribute(mk_shade<T, DENSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)SMEM_BYTES)) != cudaSuccess) return e;
    if (!DENSE && (e = cudaMemsetAsync(counter, 0, sizeof(int), stream)) != cudaSuccess) return e;
    mk_front<T, DENSE><<<(P.B + R - 1) / R, NT, SMEM_BYTES, stream>>>(
        P, dirs, pose, rot, w, bias, o_sh, d_sh, zbuf, pbuf, counts, rows, counter);
    if ((e = cudaGetLastError()) != cudaSuccess || P.stages < 2) return e;
    mk_shade<T, DENSE><<<P.shade_blocks, NT, SMEM_BYTES, stream>>>(P, w, bias, o_sh, d_sh, zbuf,
                                                                   rows, counter, raw);
  } else {
    if ((e = cudaFuncSetAttribute(mk_front_tc<DENSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)TC_SMEM_BYTES)) != cudaSuccess) return e;
    if ((e = cudaFuncSetAttribute(mk_shade_tc<DENSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)TC_SMEM_BYTES)) != cudaSuccess) return e;
    if (!DENSE && (e = cudaMemsetAsync(counter, 0, sizeof(int), stream)) != cudaSuccess) return e;
    const int tiles = (P.B + TC_TILE - 1) / TC_TILE;
    mk_front_tc<DENSE><<<tiles < P.shade_blocks ? tiles : P.shade_blocks, TC_THREADS,
                         TC_SMEM_BYTES, stream>>>(P, dirs, pose, rot, w, bias, o_sh, d_sh, zbuf,
                                                  pbuf, counts, rows, counter);
    if ((e = cudaGetLastError()) != cudaSuccess || P.stages < 2) return e;
    mk_shade_tc<DENSE><<<P.shade_blocks, TC_THREADS, TC_SMEM_BYTES, stream>>>(
        P, w, bias, o_sh, d_sh, zbuf, rows, counter, raw);
  }
  if ((e = cudaGetLastError()) != cudaSuccess || P.stages < 3) return e;
  mk_composite<DENSE><<<(P.B + 255) / 256, 256, 0, stream>>>(P, raw, pbuf, counts, rgb);
  return cudaGetLastError();
}

}  // namespace
