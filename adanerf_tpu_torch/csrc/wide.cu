// The wide path of K1, K2 and K3 for Hopper (sm_90a): the MLP layers one at
// a time, each a hand-written GEMM with a fused epilogue, the activations
// between layers in device memory. It takes the network shapes that the
// fused kernels (megakernel.cuh, nerf_train.cu) do not hold on chip: an MLP
// wider than 512 (any multiple of 128; the width is a run-time argument, so
// this one library serves every width), and K3's NeRF with more than 128
// encoded input columns. Depth has no cap here either.
//
// Replaces, at those shapes, what the fused kernels replace:
// adanerf_tpu/ops/pallas/megakernel3.py::make_megakernel_compact (K1),
// adanerf_tpu/ops/pallas/megakernel.py::make_megakernel (K2) and
// adanerf_tpu/ops/pallas/train_kernel.py::make_nerf_train_apply (K3). The
// wrappers (ops/kernels/megakernel_compact.py, nerf_train.py) launch the
// kernels below layer by layer; their plain versions are the same as the
// fused kernels'.
//
// Why the fused design cannot hold these shapes: each consumer warpgroup of
// the fused kernels keeps its 64 rows of activations (64 x W bf16) in
// shared memory, 80 KB at W = 640, and two consumers plus the weight ring
// exceed the 232,448 bytes of a block. What bounds the wide path: a W x W
// layer over R rows does 2 R W^2 operations and moves 4 R W bytes of bf16
// activations in and out, W / 2 operations a byte, above the H100's ridge
// of ~295 from W = 640 up. So the layers stay bound by arithmetic with
// their activations off chip, and each runs as one GEMM.
//
// wd_gemm, the GEMM of the bf16 layers: C = epi([A0 | A1] @ B) for 128 rows
// x at most 256 columns a block (grid: row tiles x passes of 256 columns).
// One producer thread brings, chunk after chunk of K = 64, both consumers'
// 64 x 64 A blocks and the B chunk (the packed weight stream's chunk of the
// pass, <= 256 x 64) by bulk async copies into a 4-stage ring; two consumer
// warpgroups run m64nNk16 wgmma on them (bf16 operands, fp32 sums). The
// activations in device memory are in the tile layout of mlp_wgmma.cuh (a
// 64-row tile of F columns = F / 64 swizzled 64 x 64 blocks), so that a
// block lands ready for wgmma by one linear copy. The epilogue adds, in this
// order, K3's rank-1 alpha term, the bias, the relu and K3's relu mask, sums
// columns for K3's bias partials (deterministic: a fixed butterfly and a
// fixed order over the warps, one partial row per 128-row tile), then
// stores fp32 (logits, dX), bf16 in the tile layout (the next layer's A) and
// bf16 transposed into K3's scratch (movmatrix, as nerf_train.cu's put_act).
// The arithmetic is the fused kernels': bf16 operands, fp32 sums and
// biases, each stored activation rounded to bf16.
//
// wd_gemm_f32, the fp32 layers of K1 and K2 (the exact reference): a plain
// FMA GEMM, 64 x 64 outputs a block, each row's sums in the fused fp32
// kernels' order (the first input, then the second, k ascending).
//
// The per-row work runs on the CUDA cores in small kernels, with the fused
// kernels' device functions: wd_front_prep (ray_setup, the oracle's
// encode), wd_select (select_row; K1's compaction reserves rows per 64
// rays with one atomicAdd), wd_shade_prep (sample_coords, the NeRF's
// encode), wd_alpha and wd_rgb (the heads, in alpha_dot's and rgb_dot's
// order), mk_composite; and K3's wd_load_x, wd_head_grads (the heads'
// weight and bias gradients) and wd_ghv (the views layer's cotangent, K = 3).

#include "megakernel.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WD_THREADS = 384;                               // two consumers, the producer
constexpr int WD_STAGES = 4;
constexpr int WD_A_BYTES = TC_ROWS * TC_KC * 2;               // one 64 x 64 A block
constexpr int WD_STAGE_BYTES = 2 * WD_A_BYTES + 256 * TC_KC * 2;
constexpr int WD_OFF_CS = WD_STAGES * WD_STAGE_BYTES;         // column sums: 8 warps x 256
constexpr int WD_OFF_BAR = WD_OFF_CS + 8 * 256 * 4;
constexpr size_t WD_SMEM = WD_OFF_BAR + 2 * WD_STAGES * 8;
static_assert(WD_SMEM <= 232448, "a block's shared memory");

__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16);
}

// The 8 x 8 b16 matrix a warp holds in the accumulator's fragment layout
// (lane l: row l / 4, columns 2 (l % 4) and + 1), transposed.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(d) : "r"(a));
  return d;
}

// Element offset of (feature f, row s) in a 64-row tile of a K3 scratch
// matrix (nerf_train.cu's tile_off).
__device__ __forceinline__ int tile_off(int f, int s) {
  return (f >> 6) * 4096 + (f & 63) * 64 + ((((s >> 3) ^ f) & 7) << 3) + (s & 7);
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Rows a launch covers: rows, or where count is given (K1's live count on
// the device) the count past base, at most rows.
__device__ __forceinline__ int rows_of(const int* count, int base, int rows) {
  if (count == nullptr) return rows;
  const int n = *count - base;
  return n < 0 ? 0 : (n < rows ? n : rows);
}

// Element (row r, column k) of an activation matrix of F columns: bf16 in
// the tile layout (BF) or fp32 row-major.
template <bool BF>
__device__ __forceinline__ float act_at(const void* a, int F, int r, int k) {
  if constexpr (BF)
    return ld_bf16(static_cast<const uint8_t*>(a) + (size_t)(r >> 6) * F * 128, r & 63, k);
  else
    return static_cast<const float*>(a)[(size_t)r * F + k];
}

template <bool BF>
__device__ __forceinline__ void act_put(void* a, int F, int r, int k, float v) {
  if constexpr (BF)
    *reinterpret_cast<bf16*>(static_cast<uint8_t*>(a) + (size_t)(r >> 6) * F * 128 +
                             sw128(r & 63, k)) = __float2bfloat16_rn(v);
  else
    static_cast<float*>(a)[(size_t)r * F + k] = v;
}

}  // namespace

extern "C" {

// Mirrored field for field by ops/kernels/wide.py. A operands, out and mask
// in the tile layout or K3's scratch layout (st, mask): the 64-row tile t of
// an F-column matrix at t * 64 * F elements. w: the product's weight stream,
// pass by pass (each pass 256 columns but the last), a pass's kc0 + kc1
// chunks of 64 rows. Null pointers switch their part of the epilogue off.
struct WdGemm {
  const bf16* a0;     // kc0 blocks a tile
  const bf16* a1;     // kc1 blocks a tile (a skip layer's or the views layer's x)
  const bf16* w;
  const float* bias;  // fp32, n
  bf16* out;          // bf16, tile layout, n columns
  bf16* st;           // bf16, K3's scratch layout, n features
  float* f32;         // fp32 row-major, ldf a row, columns < f32_cols
  const bf16* mask;   // K3's scratch layout, n features: zero marks a dead relu
  float* bp;          // bias partials: one row of ldbp per 128-row tile
  const float* ga;    // (rows, 4) output cotangents: + bf16(ga[r][3]) * wa[c]
  const float* wa;
  const int* count;   // see rows_of
  int kc0, kc1, n, rows, base, relu, ldf, f32_cols, f32_add, ldbp;
};

// fp32 row-major: out (rows x n) = act(a0 (k0 columns) @ w0 + a1 (k1) @ w1
// + bias); w row-major (k x n).
struct WdF32 {
  const float* a0;
  const float* a1;
  const float* w0;
  const float* w1;
  const float* bias;
  float* out;
  const int* count;
  int k0, k1, n, rows, base, relu;
};

}  // extern "C"

namespace {

template <int NP>
__device__ __forceinline__ void wd_consume(const WdGemm& G, int M, int bt, int c0, uint32_t buf,
                                           uint32_t fb, uint32_t eb, float* cs) {
  const int g = threadIdx.x >> 7, tl = threadIdx.x & 127, lane = tl & 31, w = tl >> 5;
  const int q = lane >> 2, p = lane & 3;
  const int kc = G.kc0 + G.kc1;
  float acc[NP / 2];
  int stage = 0, prev = -1;
  uint32_t phase = 0;
  wgmma_fence();
  for (int c = 0; c < kc; ++c) {
    mbar_wait(fb + 8 * stage, phase);
    const uint32_t st = buf + stage * WD_STAGE_BYTES;
    const uint64_t da = sw128_desc(st + g * WD_A_BYTES), db = sw128_desc(st + 2 * WD_A_BYTES);
#pragma unroll
    for (int kk = 0; kk < TC_KC / 16; ++kk)
      wgmma_k16<NP>(acc, da + 2 * kk, db + 2 * kk, c > 0 || kk > 0);
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(eb + 8 * prev);
    }
    prev = stage;
    if (++stage == WD_STAGES) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (lane == 0) mbar_arrive(eb + 8 * prev);

  // accumulator element j * 4 + 2 i + e: row rt + 8 i of the 64-row tile
  // ti, column c0 + 8 j + 2 p + e
  const int ti = 2 * bt + g, rt = w * 16 + q;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = rt + 8 * i, col = c0 + 8 * j + 2 * p + e, row = ti * TC_ROWS + r;
        float v = acc[j * 4 + 2 * i + e];
        if (G.ga != nullptr && row < M) v = fmaf(bfr(G.ga[(size_t)row * 4 + 3]), G.wa[col], v);
        if (G.bias != nullptr) v += G.bias[col];
        if (G.relu) v = fmaxf(v, 0.f);
        if (G.mask != nullptr &&
            __bfloat16_as_ushort(G.mask[(size_t)ti * G.n * 64 + tile_off(col, r)]) == 0)
          v = 0.f;
        acc[j * 4 + 2 * i + e] = v;
      }
  if (G.bp != nullptr) {  // column sums of the block's 128 rows
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = acc[j * 4 + e] + acc[j * 4 + 2 + e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (q == 0) cs[(4 * g + w) * 256 + 8 * j + 2 * p + e] = s;
      }
    asm volatile("bar.sync 3, 256;" ::: "memory");  // both consumers' sums are in
    for (int c = threadIdx.x; c < NP; c += 256) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) s += cs[k * 256 + c];
      G.bp[(size_t)bt * G.ldbp + c0 + c] = s;
    }
  }
  if (G.f32 != nullptr) {
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = ti * TC_ROWS + rt + 8 * i, col = c0 + 8 * j + 2 * p + e;
          if (row < M && col < G.f32_cols) {
            float* d = G.f32 + (size_t)row * G.ldf + col;
            const float v = acc[j * 4 + 2 * i + e];
            *d = G.f32_add ? *d + v : v;
          }
        }
  }
  if (G.out != nullptr || G.st != nullptr) {
    uint8_t* ob = reinterpret_cast<uint8_t*>(G.out) + (size_t)ti * G.n * 128;
    const size_t so = (size_t)ti * G.n * 64 + (size_t)c0 * 64;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t u =
            as_u32(__floats2bfloat162_rn(acc[j * 4 + 2 * i], acc[j * 4 + 2 * i + 1]));
        if (G.out != nullptr)
          *reinterpret_cast<uint32_t*>(ob + sw128(rt + 8 * i, c0 + 8 * j + 2 * p)) = u;
        if (G.st != nullptr)  // (feature 8 j + q, rows 16 w + 8 i + 2 p, + 1): tile_off
          *reinterpret_cast<uint32_t*>(G.st + so + j * 512 + q * 64 +
                                       ((((2 * w + i) ^ q) & 7) << 3) + 2 * p) = transpose8x8(u);
      }
  }
}

__global__ void __launch_bounds__(WD_THREADS, 1) wd_gemm(const WdGemm G) {
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  const int M = rows_of(G.count, G.base, G.rows), bt = blockIdx.x;
  if (bt * 2 * TC_ROWS >= M) return;  // past the rows: the whole block
  const int c0 = blockIdx.y * 256, np = G.n - c0 < 256 ? G.n - c0 : 256;
  const int kc = G.kc0 + G.kc1;
  float* cs = reinterpret_cast<float*>(sm + WD_OFF_CS);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(sm + WD_OFF_BAR);
  unsigned long long* empty = full + WD_STAGES;
  const uint32_t buf = smem_u32(sm), fb = smem_u32(full), eb = smem_u32(empty);
  if (buf & 1023) __trap();  // the swizzle needs 1024-byte aligned stages
  if (threadIdx.x == 0) {
    for (int i = 0; i < WD_STAGES; ++i) {
      mbar_init(fb + 8 * i, 1);
      mbar_init(eb + 8 * i, TC_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 2 * 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 2 * 128) {
      // earlier passes are 256 wide: pass c0 / 256 starts c0 kc 64 elements in
      const bf16* wp = G.w + (size_t)c0 * kc * TC_KC;
      int stage = 0;
      uint32_t phase = 0;
      for (int c = 0; c < kc; ++c) {
        mbar_wait(eb + 8 * stage, phase ^ 1);
        const uint32_t dst = buf + stage * WD_STAGE_BYTES, bar = fb + 8 * stage;
        const bool first = c < G.kc0;
        const int kb = first ? G.kc0 : G.kc1;  // blocks a tile of this operand
        const bf16* a = (first ? G.a0 : G.a1) + ((size_t)(2 * bt) * kb + (first ? c : c - G.kc0)) * 4096;
        mbar_expect(bar, 2 * WD_A_BYTES + np * TC_KC * 2);
        bulk_copy(dst, a, WD_A_BYTES, bar);
        bulk_copy(dst + WD_A_BYTES, a + (size_t)kb * 4096, WD_A_BYTES, bar);
        bulk_copy(dst + 2 * WD_A_BYTES, wp + (size_t)c * np * TC_KC, np * TC_KC * 2, bar);
        if (++stage == WD_STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  switch (np) {
    case 256: wd_consume<256>(G, M, bt, c0, buf, fb, eb, cs); break;
    case 192: wd_consume<192>(G, M, bt, c0, buf, fb, eb, cs); break;
    case 128: wd_consume<128>(G, M, bt, c0, buf, fb, eb, cs); break;
    default: wd_consume<64>(G, M, bt, c0, buf, fb, eb, cs); break;
  }
}

__global__ void __launch_bounds__(256) wd_gemm_f32(const WdF32 G) {
  __shared__ float as[16][64 + 4];  // [k][row]
  __shared__ float bs[16][64];      // [k][column]
  const int M = rows_of(G.count, G.base, G.rows), r0 = blockIdx.x * 64, n0 = blockIdx.y * 64;
  if (r0 >= M) return;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // rows 4 ty.., columns 4 tx..
  float acc[4][4] = {};
  for (int seg = 0; seg < 2; ++seg) {
    const float* a = seg ? G.a1 : G.a0;
    const float* w = seg ? G.w1 : G.w0;
    const int K = seg ? G.k1 : G.k0;
    for (int k0 = 0; k0 < K; k0 += 16) {
      __syncthreads();
      {
        const int e = threadIdx.x * 4, r = e >> 4, kk = e & 15;
        const float4 v = *reinterpret_cast<const float4*>(a + (size_t)(r0 + r) * K + k0 + kk);
        as[kk][r] = v.x; as[kk + 1][r] = v.y; as[kk + 2][r] = v.z; as[kk + 3][r] = v.w;
        const int kb = e >> 6, cb = e & 63;
        *reinterpret_cast<float4*>(&bs[kb][cb]) =
            *reinterpret_cast<const float4*>(w + (size_t)(k0 + kb) * G.n + n0 + cb);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) { av[i] = as[kk][4 * ty + i]; bv[i] = bs[kk][4 * tx + i]; }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= M) continue;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = acc[i][j] + G.bias[n0 + 4 * tx + j];
      o[j] = G.relu ? fmaxf(v, 0.f) : v;
    }
    *reinterpret_cast<float4*>(G.out + (size_t)row * G.n + n0 + 4 * tx) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

// ---- K1 and K2: the per-row work ----

// 64 rays a block: ray setup (the shading rays to o_sh, d_sh) and the
// oracle's encoded input x (in0 columns).
template <bool BF>
__global__ void __launch_bounds__(256)
wd_front_prep(const MkParams P, const float* __restrict__ dirs, const float* __restrict__ pose,
              const float* __restrict__ rot, float* __restrict__ o_sh, float* __restrict__ d_sh,
              void* x) {
  __shared__ float coords[64][6];
  const int t = threadIdx.x, r0 = blockIdx.x * 64;
  if (t < 64) ray_setup(P, dirs, pose, rot, r0 + t, coords[t], o_sh, d_sh);
  __syncthreads();
  for (int e = t; e < 64 * P.in0; e += 256) {
    const int r = e / P.in0, col = e % P.in0;
    act_put<BF>(x, P.in0, r0 + r, col, encode_col(coords[r], col, P.fd0, P.fp0));
  }
}

// One warp a ray over the logits (128 a row): the adaptive select; K1
// reserves each block's live rows with one atomicAdd.
template <bool DENSE>
__global__ void __launch_bounds__(256)
wd_select(const MkParams P, const float* __restrict__ logits, float* __restrict__ zbuf,
          float* __restrict__ pbuf, int* __restrict__ counts, int* __restrict__ rows,
          int* __restrict__ counter) {
  __shared__ int cnt_s[64], off_s[64];
  __shared__ int base_s;
  const int t = threadIdx.x, lane = t & 31, wy = t >> 5, ray0 = blockIdx.x * 64;
  for (int i = 0; i < 8; ++i) {
    const int row = wy * 8 + i;
    const int n = select_row<DENSE>(P, logits + (size_t)(ray0 + row) * 128, ray0 + row, zbuf, pbuf,
                                    counts);
    if (lane == 0) cnt_s[row] = n;
  }
  if constexpr (DENSE) return;
  __syncthreads();
  if (t == 0) {
    int tot = 0;
    for (int r = 0; r < 64; ++r) { off_s[r] = tot; tot += cnt_s[r]; }
    base_s = atomicAdd(counter, tot);
  }
  __syncthreads();
  if (t < 64)
    for (int s = 0; s < cnt_s[t]; ++s) rows[base_s + off_s[t] + s] = (ray0 + t) * P.S + s;
}

// 64 sample rows a block, rows base.. of the live rows (K1) or of all B*S
// slots (K2): the NeRF's encoded input x (in1 columns). A 128-row tile past
// the rows is skipped, as the GEMMs skip it.
template <bool BF, bool DENSE>
__global__ void __launch_bounds__(256)
wd_shade_prep(const MkParams P, const float* __restrict__ o_sh, const float* __restrict__ d_sh,
              const float* __restrict__ zbuf, const int* __restrict__ rows,
              const int* __restrict__ counter, int base, void* x) {
  __shared__ float coords[64][6];
  const int total = DENSE ? P.B * P.S : *counter;
  const int t = threadIdx.x, r0 = blockIdx.x * 64;
  if (base + (r0 & ~127) >= total) return;
  if (t < 64) {
    const int j = base + r0 + t;
    float c[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (j < total) sample_coords(P, o_sh, d_sh, zbuf, DENSE ? j : rows[j], c);
    for (int k = 0; k < 6; ++k) coords[t][k] = c[k];
  }
  __syncthreads();
  for (int e = t; e < 64 * P.in1; e += 256) {
    const int r = e / P.in1, col = e % P.in1;
    act_put<BF>(x, P.in1, r0 + r, col, encode_col(coords[r], col, P.fp1, P.fd1));
  }
}

// One warp a row (alpha_dot's order): alpha[r] = h[r] . w + b[0].
template <bool BF, typename T>
__global__ void __launch_bounds__(256)
wd_alpha(const void* h, int F, const T* __restrict__ w, const float* __restrict__ b,
         float* __restrict__ alpha, const int* count, int base, int rows) {
  const int M = rows_of(count, base, rows);
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= M) return;
  float s = 0.f;
  for (int k = lane; k < F; k += 32) s = fmaf(act_at<BF>(h, F, r, k), to_f(w[k]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) alpha[r] = s + b[0];
}

// One warp a row (rgb_dot's order): out[id] = [hv[r] @ w + b, alpha[r]],
// id = ids[base + r] (K1's live rows), or base + r.
template <bool BF, typename T>
__global__ void __launch_bounds__(256)
wd_rgb(const void* hv, int F, const T* __restrict__ w, const float* __restrict__ b,
       const float* __restrict__ alpha, const int* __restrict__ ids, const int* count, int base,
       int rows, float* __restrict__ out) {
  const int M = rows_of(count, base, rows);
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= M) return;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int k = lane; k < F; k += 32) {
    const float v = act_at<BF>(hv, F, r, k);
    s0 = fmaf(v, to_f(w[k * 3 + 0]), s0);
    s1 = fmaf(v, to_f(w[k * 3 + 1]), s1);
    s2 = fmaf(v, to_f(w[k * 3 + 2]), s2);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  if (lane == 0) {
    const int j = base + r, id = ids != nullptr ? ids[j] : j;
    *reinterpret_cast<float4*>(out + (size_t)id * 4) =
        make_float4(s0 + b[0], s1 + b[1], s2 + b[2], alpha[r]);
  }
}

// ---- K3: the per-row work ----

// x (N, n_in) fp32 -> bf16, xw columns (zero past n_in and N): into the
// tile layout xt and, where st is given, the scratch matrix. A block per
// 64-row tile.
__global__ void __launch_bounds__(256)
wd_load_x(const float* __restrict__ x, int N, int n_in, int xw, bf16* __restrict__ xt,
          bf16* __restrict__ st) {
  const int ti = blockIdx.x;
  for (int e = threadIdx.x; e < TC_ROWS * xw; e += 256) {
    const int r = e / xw, f = e % xw, row = ti * TC_ROWS + r;
    const bf16 v = __float2bfloat16_rn(f < n_in && row < N ? x[(size_t)row * n_in + f] : 0.f);
    *reinterpret_cast<bf16*>(reinterpret_cast<uint8_t*>(xt) + (size_t)ti * xw * 128 +
                             sw128(r, f)) = v;
    if (st != nullptr) st[(size_t)ti * xw * 64 + tile_off(f, r)] = v;
  }
}

// The output cotangents of a 128-row tile (zero past N).
__device__ __forceinline__ void load_gout(const float* gout, int N, float4* g) {
  if (threadIdx.x < 128) {
    const int row = blockIdx.x * 128 + threadIdx.x;
    g[threadIdx.x] = row < N ? *reinterpret_cast<const float4*>(gout + (size_t)row * 4)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
}

// Element (row r of the 128-row tile bt, feature c) of a scratch matrix of
// F features.
__device__ __forceinline__ float scr_at(const bf16* m, int F, int bt, int r, int c) {
  return __bfloat162float(m[(size_t)(2 * bt + (r >> 6)) * F * 64 + tile_off(c, r & 63)]);
}

// The heads' gradients over one 128-row tile, into its bias-partial row:
// alpha.w from the trunk output h (W features) and the rounded alpha
// cotangent, rgb.w from the views output hv (W / 2) and the rounded rgb
// cotangents, rgb.b and alpha.b from the unrounded cotangents.
__global__ void __launch_bounds__(256)
wd_head_grads(const bf16* __restrict__ h, const bf16* __restrict__ hv, int W, int N,
              const float* __restrict__ gout, float* __restrict__ bpart, int ldbp, int bp_wa,
              int bp_wrgb, int bp_rgb, int bp_a) {
  __shared__ float4 g[128];
  load_gout(gout, N, g);
  float* bp = bpart + (size_t)blockIdx.x * ldbp;
  for (int c = threadIdx.x; c < W; c += 256) {
    float s = 0.f;
    for (int r = 0; r < 128; ++r) s = fmaf(scr_at(h, W, blockIdx.x, r, c), bfr(g[r].w), s);
    bp[bp_wa + c] = s;
  }
  for (int c = threadIdx.x; c < W / 2; c += 256) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < 128; ++r) {
      const float v = scr_at(hv, W / 2, blockIdx.x, r, c);
      s0 = fmaf(v, bfr(g[r].x), s0);
      s1 = fmaf(v, bfr(g[r].y), s1);
      s2 = fmaf(v, bfr(g[r].z), s2);
    }
    bp[bp_wrgb + 3 * c] = s0;
    bp[bp_wrgb + 3 * c + 1] = s1;
    bp[bp_wrgb + 3 * c + 2] = s2;
  }
  if (threadIdx.x < 4) {
    float s = 0.f;
    for (int r = 0; r < 128; ++r) {
      const float4 v = g[r];
      s += threadIdx.x == 0 ? v.x : threadIdx.x == 1 ? v.y : threadIdx.x == 2 ? v.z : v.w;
    }
    bp[threadIdx.x < 3 ? bp_rgb + threadIdx.x : bp_a] = s;
  }
}

// The views layer's cotangent over one 128-row tile: g_hv = (bf16(g_rgb) @
// wrgb^T) where hv > 0 (V = W / 2 columns), summed over the rows into the
// bias-partial row, rounded to bf16 into the tile layout gt (the chain's
// first A operand) and the scratch matrix st.
__global__ void __launch_bounds__(256)
wd_ghv(const bf16* __restrict__ hv, bf16* __restrict__ st, int V, int N,
       const float* __restrict__ gout, const float* __restrict__ wrgb, float* __restrict__ bpart,
       int ldbp, int bp_v, bf16* __restrict__ gt) {
  __shared__ float4 g[128];
  load_gout(gout, N, g);
  for (int c = threadIdx.x; c < V; c += 256) {
    const float w0 = wrgb[3 * c], w1 = wrgb[3 * c + 1], w2 = wrgb[3 * c + 2];
    float s = 0.f;
    for (int r = 0; r < 128; ++r) {
      const int ti = 2 * blockIdx.x + (r >> 6), rr = r & 63;
      const size_t at = (size_t)ti * V * 64 + tile_off(c, rr);
      const float4 gv = g[r];
      float v = fmaf(bfr(gv.z), w2, fmaf(bfr(gv.y), w1, bfr(gv.x) * w0));
      if (__bfloat16_as_ushort(hv[at]) == 0) v = 0.f;
      s += v;
      const bf16 b = __float2bfloat16_rn(v);
      st[at] = b;
      *reinterpret_cast<bf16*>(reinterpret_cast<uint8_t*>(gt) + (size_t)ti * V * 128 +
                               sw128(rr, c)) = b;
    }
    bpart[(size_t)blockIdx.x * ldbp + bp_v + c] = s;
  }
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

int wd_gemm_launch(int device, const WdGemm* G, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wd_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WD_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((G->rows + 2 * TC_ROWS - 1) / (2 * TC_ROWS), (G->n + 255) / 256);
  wd_gemm<<<grid, WD_THREADS, WD_SMEM, as_stream(stream)>>>(*G);
  return static_cast<int>(cudaGetLastError());
}

int wd_gemm_f32_launch(int device, const WdF32* G, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  wd_gemm_f32<<<dim3((G->rows + 63) / 64, G->n / 64), 256, 0, as_stream(stream)>>>(*G);
  return static_cast<int>(cudaGetLastError());
}

// rows: the frame's rays padded to 128 (x has that many rows).
int wd_front_prep_launch(int device, const MkParams* P, const float* dirs, const float* pose,
                         const float* rot, float* o_sh, float* d_sh, void* x, int rows,
                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (P->bf16)
    wd_front_prep<true><<<rows / 64, 256, 0, as_stream(stream)>>>(*P, dirs, pose, rot, o_sh, d_sh, x);
  else
    wd_front_prep<false><<<rows / 64, 256, 0, as_stream(stream)>>>(*P, dirs, pose, rot, o_sh, d_sh, x);
  return static_cast<int>(cudaGetLastError());
}

int wd_select_launch(int device, const MkParams* P, int dense, const float* logits, float* zbuf,
                     float* pbuf, int* counts, int* rows, int* counter, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (P->B + 63) / 64;
  if (dense) {
    wd_select<true><<<blocks, 256, 0, as_stream(stream)>>>(*P, logits, zbuf, pbuf, counts, rows,
                                                           counter);
  } else {
    if ((e = cudaMemsetAsync(counter, 0, sizeof(int), as_stream(stream))) != cudaSuccess)
      return static_cast<int>(e);
    wd_select<false><<<blocks, 256, 0, as_stream(stream)>>>(*P, logits, zbuf, pbuf, counts, rows,
                                                            counter);
  }
  return static_cast<int>(cudaGetLastError());
}

// rows: the chunk's rows (a multiple of 128), from sample row base.
int wd_shade_prep_launch(int device, const MkParams* P, int dense, const float* o_sh,
                         const float* d_sh, const float* zbuf, const int* ids, const int* counter,
                         int base, int rows, void* x, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = as_stream(stream);
  const int blocks = rows / 64;
  if (P->bf16 && dense)
    wd_shade_prep<true, true><<<blocks, 256, 0, s>>>(*P, o_sh, d_sh, zbuf, ids, counter, base, x);
  else if (P->bf16)
    wd_shade_prep<true, false><<<blocks, 256, 0, s>>>(*P, o_sh, d_sh, zbuf, ids, counter, base, x);
  else if (dense)
    wd_shade_prep<false, true><<<blocks, 256, 0, s>>>(*P, o_sh, d_sh, zbuf, ids, counter, base, x);
  else
    wd_shade_prep<false, false><<<blocks, 256, 0, s>>>(*P, o_sh, d_sh, zbuf, ids, counter, base, x);
  return static_cast<int>(cudaGetLastError());
}

// which 0: wd_alpha into alpha; 1: wd_rgb into out. bf16: h is bf16 in the
// tile layout (else fp32 row-major); wbf16: w is bf16 (else fp32).
int wd_head_launch(int device, int which, int bf16, int wbf16, const void* h, int F,
                   const void* w, const float* b, float* alpha, const int* ids, const int* count,
                   int base, int rows, float* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = as_stream(stream);
  const int blocks = (rows + 7) / 8;
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  const float* wf = static_cast<const float*>(w);
#define WD_HEAD(BF, T, WP)                                                                    \
  if (which == 0)                                                                             \
    wd_alpha<BF, T><<<blocks, 256, 0, s>>>(h, F, WP, b, alpha, count, base, rows);            \
  else                                                                                        \
    wd_rgb<BF, T><<<blocks, 256, 0, s>>>(h, F, WP, b, alpha, ids, count, base, rows, out);
  if (bf16 && wbf16) {
    WD_HEAD(true, __nv_bfloat16, wb)
  } else if (bf16) {
    WD_HEAD(true, float, wf)
  } else {
    WD_HEAD(false, float, wf)
  }
#undef WD_HEAD
  return static_cast<int>(cudaGetLastError());
}

int wd_composite_launch(int device, const MkParams* P, int dense, const float* raw,
                        const float* pbuf, const int* counts, float* rgb, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (P->B + 255) / 256;
  if (dense)
    mk_composite<true><<<blocks, 256, 0, as_stream(stream)>>>(*P, raw, pbuf, counts, rgb);
  else
    mk_composite<false><<<blocks, 256, 0, as_stream(stream)>>>(*P, raw, pbuf, counts, rgb);
  return static_cast<int>(cudaGetLastError());
}

// tiles: 64-row tiles of xt (and st).
int wd_load_x_launch(int device, const float* x, int N, int n_in, int xw, int tiles, void* xt,
                     void* st, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  wd_load_x<<<tiles, 256, 0, as_stream(stream)>>>(x, N, n_in, xw, static_cast<bf16*>(xt),
                                                   static_cast<bf16*>(st));
  return static_cast<int>(cudaGetLastError());
}

// tiles: 64-row tiles (even); a block per 128 rows.
int wd_head_grads_launch(int device, const void* h, const void* hv, int W, int N, int tiles,
                         const float* gout, float* bpart, int ldbp, int bp_wa, int bp_wrgb,
                         int bp_rgb, int bp_a, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  wd_head_grads<<<tiles / 2, 256, 0, as_stream(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(hv), W, N, gout, bpart, ldbp, bp_wa,
      bp_wrgb, bp_rgb, bp_a);
  return static_cast<int>(cudaGetLastError());
}

int wd_ghv_launch(int device, const void* hv, void* st, int V, int N, int tiles,
                  const float* gout, const float* wrgb, float* bpart, int ldbp, int bp_v,
                  void* gt, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  wd_ghv<<<tiles / 2, 256, 0, as_stream(stream)>>>(static_cast<const bf16*>(hv),
                                                   static_cast<bf16*>(st), V, N, gout, wrgb,
                                                   bpart, ldbp, bp_v, static_cast<bf16*>(gt));
  return static_cast<int>(cudaGetLastError());
}

// which 0: sizeof(MkParams), 1: sizeof(WdGemm), 2: sizeof(WdF32).
int wd_struct_size(int which) {
  return static_cast<int>(which == 0 ? sizeof(MkParams)
                                     : which == 1 ? sizeof(WdGemm) : sizeof(WdF32));
}

}  // extern "C"
