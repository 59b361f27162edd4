// K3: the NeRF shading MLP's fused forward and backward for the train step,
// on Hopper's tensor cores (sm_90a).
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
// gradients are fp32 sums of unrounded values, and a cotangent is masked by
// its layer's relu, summed for the bias, then rounded. x (N, n_in) ->
// [rgb, alpha] (N, 4); the backward gives dW and db for every NeRF leaf and
// dX. The hidden width HW is the macro K3_WIDTH, 128 or 256 (one library
// per width; the views layer is HW / 2 wide, as NeRFDef's), with at most
// 128 input columns and 65 trunk layers (a layer's offsets are strides
// from the first layer's, its skip input a bit of a kernel parameter). A
// NeRF of another width, deeper, or with more input columns takes the wide
// path (wide.cu), which ends in this library's k3_dw and k3_reduce
// (k3_weight_grads); at 384 and 512 the wide path measured faster than
// these kernels did there.
//
// What bounds it: arithmetic (at 256, 593,408 multiply-adds a row forward,
// about three times that backward), and in the backward the bf16 scratch
// that carries each row's activations and cotangents from the chain to the
// weight gradients (~10 KB a row at 256, written once and read once). The
// forward is one launch, the backward four:
//
//   k3_fwd       persistent blocks of two consumer warpgroups and a
//                producer warpgroup (mlp_wgmma.cuh's core). Each consumer
//                walks 64-row tiles through the trunk, the feature and the
//                views layers on wgmma, the weights streaming in by bulk
//                copies; the alpha head runs under the feature layer's
//                wgmmas, the rgb head after the views layer; the next
//                tile's x loads under the trunk's layers.
//   k3_recompute the same blocks and the same device functions
//                (forward_pass), so the relu signs the backward masks with
//                are those of the values the forward's output came from.
//                Each layer's bf16 output and x go to the scratch, the relu
//                signs to a bit buffer (per 64-row tile), and the heads'
//                gradients (alpha.w, rgb.w: N = 1 and 3; their biases) are
//                summed on the CUDA cores from the tile in shared memory.
//   k3_chain     the same blocks on the transposed weights (a second
//                stream): g_hv on the CUDA cores (K = 3), dX's terms, g_feat
//                and the trunk from its last layer down, each cotangent
//                masked, column-summed into the consumer's bias partial,
//                rounded, written in place as the next product's A operand
//                and stored to the scratch. Recompute and chain are two
//                kernels because one consumer holding both, with its
//                128-float accumulator, spilled it around every wgmma.
//   k3_dw        every other weight gradient dW = A^T G in one launch: a
//                table of output tiles (<= 128 rows of dW x at most 256
//                columns) times row slices, each block one wgmma GEMM over
//                its slice, its fp32 partial to its own slot.
//   k3_reduce    the dW partials summed over the slices and the bias
//                partials over the consumers, in a fixed order: no float
//                atomics, so two backward calls give the same bits.
//
// Shared memory, of the 232,448 bytes a block may take (a stage is 32 KB,
// an x buffer 16 KB, h 64 x HW bf16 per consumer):
//   width   k3_fwd / k3_recompute                    k3_chain
//   128     3 stages + 4 x + 2 h (16 KB) = 196,608   3 stages + 2 h = 131,072
//   256     3 stages + 4 x + 2 h (32 KB) = 229,376   3 stages + 2 h = 163,840
// plus the small part (barriers, the alpha outputs and cotangents, and in
// the chain the column sums, 32 x HW bytes). The weight-gradient GEMMs
// take output tiles of at most 256 columns (a wider gradient, the wide
// path's, is two tiles).
//
// The scratch layout (mirrored by nerf_train.py's tile_rows): a matrix of N
// rows and F features is stored per 64-row tile as F / 64 blocks of 64
// features x 64 rows, each feature's 64 rows in 128 bytes with the 128-byte
// swizzle of mlp_wgmma.cuh (its 16-byte group g at g ^ (feature % 8)). The
// chain writes it from its accumulators, transposed by movmatrix; in k3_dw
// one bulk copy lands a block as a K-major wgmma operand (K = rows), the
// 64 x 64 A block and the F x 64 B tile alike, read by sw128_desc.

#include "mlp_wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

#ifndef K3_WIDTH
#define K3_WIDTH 256
#endif
constexpr int HW = K3_WIDTH;          // hidden width: one library per width
static_assert(HW == 128 || HW == 256, "K3 widths of the fused libraries: 128 and 256");
constexpr int VW = HW / 2;            // views layer width
constexpr int XW = 128;               // x columns, padded: two 64-column blocks
constexpr int KH = HW / TC_KC, KV = VW / TC_KC, KX = XW / TC_KC;  // chunks per A operand
constexpr int THREADS = 3 * 128;      // two consumer warpgroups, then the producer's
constexpr int TILE = 2 * TC_ROWS;     // rows per block tile
constexpr int BLK = 64 * 64;          // elements of one 64-feature x 64-row scratch block
constexpr int WPT = HW / 64;          // relu-sign words of a thread per layer of a tile
constexpr int MASK_WORDS = 128 * WPT; // relu-sign words of one layer of one 64-row tile
constexpr int NA = (HW + 255) / 256;  // alpha.w gradient column pairs per thread

constexpr int X_BYTES = TC_ROWS * XW * 2;
constexpr int H_BYTES = TC_ROWS * HW * 2;

// k3_fwd and k3_recompute: stages, two x buffers and h per consumer, then
// the small part
constexpr int F_OFF_X = TC_STAGES * TC_STAGE_BYTES;
constexpr int F_OFF_H = F_OFF_X + 2 * 2 * X_BYTES;
constexpr int F_OFF_SMALL = F_OFF_H + 2 * H_BYTES;
struct FwdSmall {
  unsigned long long full[TC_STAGES], empty[TC_STAGES];
  float alpha[TILE];            // k3_fwd: the alpha head's output
  float4 gout[2][TC_ROWS];      // k3_recompute: each consumer's output cotangents
};
constexpr size_t F_SMEM = F_OFF_SMALL + sizeof(FwdSmall);

// k3_chain: stages and h per consumer, then the small part
constexpr int C_OFF_H = TC_STAGES * TC_STAGE_BYTES;
constexpr int C_OFF_SMALL = C_OFF_H + 2 * H_BYTES;
struct ChainSmall {
  unsigned long long full[TC_STAGES], empty[TC_STAGES];
  float cs[2][4][HW];           // per consumer: each warp's column sums
  float4 gout[2][TC_ROWS];      // per consumer: the tile's output cotangents
};
constexpr size_t C_SMEM = C_OFF_SMALL + sizeof(ChainSmall);

// k3_dw: stages of two A blocks and one B tile (<= 256 x 64)
constexpr int DW_N = 256;                  // widest output tile (wgmma's N)
constexpr int DW_STAGES = 4;
constexpr int DW_A_BYTES = BLK * 2;
constexpr int DW_STAGE_BYTES = 2 * DW_A_BYTES + DW_N * TC_KC * 2;
constexpr int DW_PART = 2 * TC_ROWS * DW_N;  // floats of one partial slot
constexpr size_t DW_SMEM = DW_STAGES * DW_STAGE_BYTES + 2 * DW_STAGES * 8;

static_assert(F_SMEM <= 232448 && C_SMEM <= 232448 && DW_SMEM <= 232448,
              "a block's shared memory");

}  // namespace

extern "C" {

// Mirrored field for field by the ctypes Structures in nerf_train.py. vec
// offsets index the fp32 vector buffer (biases; the heads' weights, bf16
// values), s_* the bf16 scratch (each a matrix region, tile t at s + t * F *
// 64), bp* the columns of a consumer's row of the bias partials. Per
// layer l: the trunk bias at l x HW in the vector buffer, the bias-partial
// columns at l x HW, the scratch regions of the layer's output and of its
// cotangent at s_h and s_g plus l x s_step; layer l takes [h, x] where bit
// l - 1 of skip_bits is set.
struct K3Params {
  unsigned long long skip_bits;
  long long bf, ba, bv, brgb, wa, wrgb;
  long long s_x, s_h, s_g, s_step, s_feat, s_hv, s_gfeat, s_ghv;
  long long bp_f, bp_v, bp_rgb, bp_a, bp_wa, bp_wrgb, bp_width;
  int N, n_in, depth;
  int tiles, blocks;              // 64-row tiles (even); the persistent grid
};

// One output tile of k3_dw: dW rows k0 + 64 g + r (g < nslab slabs of A's
// features) by n columns, summed over rows. A's block of row tile t is at
// a + t * a_stride (+ BLK for the second slab), B's tile at b + t *
// b_stride; rows k in [k_lo, k_hi) and columns < m_valid go to the grads
// buffer at dst + (k - k_lo) * ldo + column.
struct DwTile {
  long long a, b, dst;
  int a_stride, b_stride, n, nslab, k0, k_lo, k_hi, ldo, m_valid, pad;
};

}  // extern "C"

namespace {

// Layer l's offsets, computed from kernel parameters where they are used,
// so that none holds a register across the layer's products.
__device__ __forceinline__ long long lt_b(const K3Params&, int l) { return (long long)l * HW; }
__device__ __forceinline__ long long lt_sh(const K3Params& P, int l) { return P.s_h + l * P.s_step; }
__device__ __forceinline__ long long lt_sg(const K3Params& P, int l) { return P.s_g + l * P.s_step; }
__device__ __forceinline__ long long lt_bp(const K3Params&, int l) { return (long long)l * HW; }
__device__ __forceinline__ bool takes_x(const K3Params& P, int l) {
  return l > 0 && ((P.skip_bits >> (l - 1)) & 1ull);
}

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

// Element offset of (feature f, row s) in a tile of a scratch matrix.
__device__ __forceinline__ int tile_off(int f, int s) {
  return (f >> 6) * BLK + (f & 63) * 64 + ((((s >> 3) ^ f) & 7) << 3) + (s & 7);
}

// One bulk async copy counted against a barrier whose expected bytes were
// set for the whole stage (mbar_expect).
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Barrier set-up of the warp-specialised kernels: the producer warpgroup
// (threads 256.., after the two consumers) runs `produce` on its first
// thread and returns false; a consumer returns true. setmaxnreg moves the
// producer's registers to the consumers: a 384-thread block launches with
// 168 a thread, and the consumers grow to 232.
template <class Produce>
__device__ __forceinline__ bool split_roles(uint8_t* sm, unsigned long long* full,
                                            unsigned long long* empty, int stages,
                                            Produce produce) {
  if (smem_u32(sm) & 1023) __trap();  // the swizzle needs 1024-byte aligned tiles
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(smem_u32(full + i), 1);
      mbar_init(smem_u32(empty + i), TC_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 2 * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 2 * 128) produce();
    return false;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  return true;
}

// The producer of k3_fwd, k3_recompute and k3_chain: per block tile, a
// weight stream in the order the consumers' layers take it. The
// forward stream: trunk layer 0 on x, layer l on [h, x] where takes_x,
// feature, views on [feature, x]. The backward stream: wv_d^T, wv_f^T,
// wf^T, then from the trunk's last layer down wx_i^T where layer i takes x
// and w_i^T, then w_0^T's x columns. nerf_train.py::stream_plan mirrors
// this walk.
__device__ void k3_produce(const K3Params& P, const bf16* stream, bool backward, int ntiles,
                           uint32_t full, uint32_t empty, uint32_t buf) {
  int stage = 0;
  uint32_t phase = 0;
  const char* src = nullptr;
  auto layer = [&](int chunks, int n) {
    const uint32_t bytes = n * TC_KC * 2;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(empty + 8 * stage, phase ^ 1);
      bulk_load(buf + stage * TC_STAGE_BYTES, src, bytes, full + 8 * stage);
      src += bytes;
      if (++stage == TC_STAGES) { stage = 0; phase ^= 1; }
    }
  };
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    src = reinterpret_cast<const char*>(stream);
    if (!backward) {
      for (int l = 0; l < P.depth; ++l) layer(l == 0 ? KX : KH + (takes_x(P, l) ? KX : 0), HW);
      layer(KH, HW);
      layer(KH + KX, VW);
      continue;
    }
    layer(KV, XW);
    layer(KV, HW);
    layer(KH, HW);
    for (int i = P.depth - 1; i >= 1; --i) {
      if (takes_x(P, i)) layer(KH, XW);
      layer(KH, HW);
    }
    layer(KH, XW);
  }
}

// Rows [8 q0, 8 q1) of the 64-row tile at row0: x (N, n_in) fp32 into xs,
// the tile's bf16 A operand (128 columns, zero beyond n_in and N); with xt
// (the tile's block of the x scratch matrix), there too. Thread t of the
// consumer takes column t.
__device__ __forceinline__ void load_x(const K3Params& P, const float* __restrict__ x,
                                       uint8_t* xs, bf16* xt, int row0, int q0, int q1) {
  const int f = threadIdx.x & 127;
  const bool col = f < P.n_in;
  for (int q = q0; q < q1; ++q) {
    uint32_t pk[4];
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const int r = 8 * q + i, row = row0 + r;
      const float v0 = (col && row < P.N) ? x[(size_t)row * P.n_in + f] : 0.f;
      const float v1 = (col && row + 1 < P.N) ? x[(size_t)(row + 1) * P.n_in + f] : 0.f;
      const __nv_bfloat162 b = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<bf16*>(xs + sw128(r, f)) = b.x;
      *reinterpret_cast<bf16*>(xs + sw128(r + 1, f)) = b.y;
      pk[i / 2] = as_u32(b);
    }
    if (xt != nullptr)
      *reinterpret_cast<uint4*>(xt + tile_off(f, 8 * q)) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
  }
}

// A forward layer's epilogue, shared by k3_fwd and the recompute:
// h (64-row bf16 tile) = round_bf16(relu?(acc + bias)) (no bias where
// bias is null: a cotangent's store). With TRAIN, also the rounded values
// into the layer's scratch block st (transposed), and with BITS, bit e of
// bits[e / 32] set where accumulator element e came out > 0 after
// rounding: the relu signs the backward masks with.
template <int N, bool TRAIN, bool BITS>
__device__ __forceinline__ void put_act(const float (&acc)[N / 2], const float* bias, bool relu,
                                        uint8_t* h, bf16* st, uint32_t (&bits)[N / 64]) {
  const int t = threadIdx.x & 127, l = t & 31, w = t >> 5, q = l >> 2, p = l & 3;
  // element (row r0 + 8 i, column 8 j + 2 p) of h: sw128 with r0 % 8 == q
  const uint32_t hb = opaque(smem_u32(h)) + (w * 16 + q) * 128 + 4 * p;
  // its transpose (feature 8 j + q, rows 16 w + 8 i + 2 p, + 1) in st:
  // tile_off, which is j * 512 past the element of j = 0
  bf16* sb[2];
  if constexpr (TRAIN)
#pragma unroll
    for (int i = 0; i < 2; ++i) sb[i] = opaque(st) + q * 64 + ((((2 * w + i) ^ q) & 7) << 3) + 2 * p;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = j * 8 + 2 * p;
    const float2 b = bias != nullptr ? *reinterpret_cast<const float2*>(bias + c)
                                     : make_float2(0.f, 0.f);
    const uint32_t col = (j >> 3) * TC_BLOCK_BYTES + (((j & 7) ^ q) << 4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v0 = acc[j * 4 + 2 * i], v1 = acc[j * 4 + 2 * i + 1];
      if (bias != nullptr) { v0 += b.x; v1 += b.y; }
      if (relu) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
      const __nv_bfloat162 pk = __floats2bfloat162_rn(v0, v1);
      const uint32_t u = as_u32(pk), lo = u & 0xffffu, hi = u >> 16;
      st_shared(hb + i * 8 * 128 + col, u);
      if constexpr (TRAIN) {
        if constexpr (BITS) {
          const int e = (j & 7) * 4 + 2 * i;
          bits[j >> 3] |= (lo != 0u ? 1u << e : 0u) | (hi != 0u ? 2u << e : 0u);
        }
        *reinterpret_cast<uint32_t*>(sb[i] + j * 512) = transpose8x8(u);
      }
    }
  }
}

// Words w[0..NW) of this thread's relu signs to (or from) p, in the widest
// loads its alignment allows (p is NW words past a multiple of NW words).
template <int NW>
__device__ __forceinline__ void put_words(uint32_t* p, const uint32_t (&w)[NW]) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int k = 0; k < NW; k += 4)
      *reinterpret_cast<uint4*>(p + k) = make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
  } else if constexpr (NW % 2 == 0) {
#pragma unroll
    for (int k = 0; k < NW; k += 2) *reinterpret_cast<uint2*>(p + k) = make_uint2(w[k], w[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < NW; ++k) p[k] = w[k];
  }
}

template <int NW>
__device__ __forceinline__ void get_words(const uint32_t* p, uint32_t (&w)[NW]) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int k = 0; k < NW; k += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + k);
      w[k] = v.x; w[k + 1] = v.y; w[k + 2] = v.z; w[k + 3] = v.w;
    }
  } else if constexpr (NW % 2 == 0) {
#pragma unroll
    for (int k = 0; k < NW; k += 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + k);
      w[k] = v.x; w[k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NW; ++k) w[k] = p[k];
  }
}

// The column sums of a 64 x N accumulator over this warp's 16 rows into
// cs[warp][column]: per 4 column groups, a lane's two rows are added, then
// lanes 16, 8 and 4 apart swap halves of what they hold and add, so each
// lane ends with one column's sum.
template <int N>
__device__ __forceinline__ void col_sums(const float (&acc)[N / 2], float* cs) {
  const int t = threadIdx.x & 127, l = t & 31, w = t >> 5, q = l >> 2, p = l & 3;
  float* cb = opaque(cs) + w * HW + 8 * (q >> 1) + 2 * p + (q & 1);
#pragma unroll
  for (int j0 = 0; j0 < N / 8; j0 += 4) {
    float s[8];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[2 * jj + e] = acc[(j0 + jj) * 4 + e] + acc[(j0 + jj) * 4 + 2 + e];
#pragma unroll
    for (int half = 4; half >= 1; half >>= 1) {
      const int mask = 4 * half;  // lanes 16, 8, 4 apart: bits 2, 1, 0 of l / 4
      const bool up = (l & mask) != 0;
#pragma unroll
      for (int k = 0; k < half; ++k) {
        const float mine = up ? s[half + k] : s[k], other = up ? s[k] : s[half + k];
        s[k] = mine + __shfl_xor_sync(0xffffffffu, other, mask);
      }
    }
    // s[0] now holds column 8 (j0 + q / 2) + 2 p + q % 2
    cb[8 * j0] = s[0];
  }
}

// A finished cotangent (acc: the gradient at a layer's output, 64 x N fp32)
// masked by the layer's relu signs (MASK), summed over the tile's rows into
// this consumer's bias partial bp (first: its first tile), rounded to bf16
// and written in place as the next product's A operand (h) and into the
// scratch block st. Returns with h ready for wgmma.
template <int N, bool MASK>
__device__ __forceinline__ void put_cot(float (&acc)[N / 2], const uint32_t (&bits)[N / 64],
                                        float* cs, float* bp, bool first, uint8_t* h, bf16* st,
                                        int bar) {
  if constexpr (MASK) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e)
      if (!((bits[e >> 5] >> (e & 31)) & 1u)) acc[e] = 0.f;
  }
  col_sums<N>(acc, cs);
  wg_sync(bar);  // every warp's wgmma has read h; cs is complete
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int c = t; c < N; c += 128) {
    const float s = ((cs[c] + cs[HW + c]) + cs[2 * HW + c]) + cs[3 * HW + c];
    bp[c] = first ? s : bp[c] + s;
  }
  uint32_t none[N / 64];
  put_act<N, true, false>(acc, nullptr, false, h, st, none);
  fence_async_smem();
  wg_sync(bar);
}

// A product of the chain with N output columns (A: h, kc chunks) made a
// cotangent: pre(acc) adds what the product takes besides, then put_cot.
template <int N, bool MASK, class Pre>
__device__ __forceinline__ void cot_layer(Ring& ring, uint32_t ha, int kc,
                                          uint32_t (&bits)[N / 64], float* cs, float* bp,
                                          bool first, uint8_t* h, bf16* st, int bar, Pre pre) {
  float acc[N / 2];
  tc_layer<N>(ring, acc, ha, kc, 0, 0);
  pre(acc);
  put_cot<N, MASK>(acc, bits, cs, bp, first, h, st, bar);
}

// dx rows of this consumer's tile (fp32, n_in columns) = (first ? 0 : dx) +
// acc, acc the tile's 64 x 128 product.
__device__ __forceinline__ void dx_add(const K3Params& P, const float (&acc)[64],
                                       float* __restrict__ dx, int row0, bool first) {
  const int t = threadIdx.x & 127, l = t & 31, r0 = (t >> 5) * 16 + (l >> 2), p = l & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r0 + 8 * i;
    if (row >= P.N) continue;
    float* d = opaque(dx) + (size_t)row * P.n_in + 2 * p;
#pragma unroll
    for (int j = 0; j < XW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * j + 2 * p + e < P.n_in) {
          const float v = acc[j * 4 + 2 * i + e];
          d[8 * j + e] = first ? v : d[8 * j + e] + v;
        }
  }
}

// The forward of one 64-row tile (x: the tile's bf16 x, ready), shared by
// k3_fwd and the recompute: the trunk, the feature layer and the views
// layer, leaving the views output in h. side_t(c) runs under the trunk
// layers 1.., side_f(c) under the feature layer's chunk c (of KH a pass)
// while h holds the trunk's output. TRAIN stores each layer's output to its
// scratch block of tile ti (scr), the trunk's relu signs to masks (layer l
// at l * MASK_WORDS) and the views layer's to hvbits.
template <bool TRAIN, class SideT, class SideF>
__device__ __forceinline__ void forward_tile(const K3Params& P, Ring& ring,
                                             const float* __restrict__ vec, uint32_t xa,
                                             uint8_t* h, int bar, bf16* scr, long long ti,
                                             uint32_t* masks, uint32_t (&hvbits)[VW / 64],
                                             SideT side_t, SideF side_f) {
  const uint32_t ha = smem_u32(h);
  const long long oh = ti * HW * 64, ov = ti * VW * 64;
  // one pass a layer, every value that is not the accumulator dead while
  // the wgmmas run: the consumers are compiled to 168 registers (the
  // launch bound), and an accumulator of 128 leaves little room
  float acc[HW / 2];
  for (int l = 0; l < P.depth; ++l) {
    if (l == 0) {
      tc_layer<HW>(ring, acc, xa, KX, 0, 0);
    } else {
      fence_async_smem();
      wg_sync(bar);
      tc_layer<HW>(ring, acc, ha, KH, xa, takes_x(P, l) ? KX : 0, side_t);
      wg_sync(bar);  // every warp's wgmma has read h
    }
    uint32_t bits[WPT] = {};
    put_act<HW, TRAIN, TRAIN>(acc, vec + lt_b(P, l), true, h,
                              TRAIN ? scr + lt_sh(P, l) + oh : nullptr, bits);
    if constexpr (TRAIN) put_words(masks + l * MASK_WORDS, bits);
  }
  fence_async_smem();
  wg_sync(bar);
  // feature = h @ wf + bf, no activation
  tc_layer<HW>(ring, acc, ha, KH, 0, 0, side_f);
  wg_sync(bar);
  uint32_t none[WPT];
  put_act<HW, TRAIN, false>(acc, vec + P.bf, false, h, TRAIN ? scr + P.s_feat + oh : nullptr,
                            none);
  fence_async_smem();
  wg_sync(bar);
  // views = relu([feature, x] @ wv + bv), VW wide
  float v[VW / 2];
  tc_layer<VW>(ring, v, ha, KH, xa, KX);
  wg_sync(bar);
  put_act<VW, TRAIN, TRAIN>(v, vec + P.bv, true, h, TRAIN ? scr + P.s_hv + ov : nullptr, hvbits);
}

// The feature layer's chunks: KH. side_f(c) takes chunk c's share
// [share<R>(c), share<R>(c + 1)) of R rows.
constexpr int CF = KH;
template <int R>
__device__ __forceinline__ int share(int c) {
  if constexpr (R % CF == 0) return (R / CF) * c;
  else return R * c / CF;
}

// The forward over the block's tiles, shared by k3_fwd and k3_recompute.
// k3_fwd (TRAIN false) computes the heads into out (N, 4). k3_recompute
// (TRAIN) stores every layer's output and x to the scratch, the trunk's
// and the views layer's relu signs to masks (layer D: the views layer), and
// sums, on the CUDA cores, the heads' gradients from the output cotangents
// gout: alpha.w from the trunk output under the feature layer's wgmmas,
// rgb.w from the views output, and the heads' biases, into the consumer's
// row of the partials.
template <bool TRAIN>
__device__ __forceinline__ void forward_pass(const K3Params& P, const float* __restrict__ x,
                                             const bf16* __restrict__ fstream,
                                             const float* __restrict__ vec, float* __restrict__ out,
                                             const float* __restrict__ gout, bf16* __restrict__ scr,
                                             uint32_t* __restrict__ masks,
                                             float* __restrict__ bpart) {
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  FwdSmall* small = reinterpret_cast<FwdSmall*>(sm + F_OFF_SMALL);
  const int ntiles = P.tiles / 2;
  Ring ring{smem_u32(small->full), smem_u32(small->empty), smem_u32(sm), 0, 0};
  if (!split_roles(sm, small->full, small->empty, TC_STAGES, [&] {
        k3_produce(P, fstream, false, ntiles, ring.full, ring.empty, ring.buf);
      }))
    return;
  const int g = threadIdx.x >> 7, bar = 1 + g, tl = threadIdx.x & 127;
  const int lane = tl & 31, wq = tl >> 5;
  uint8_t* xb[2] = {sm + F_OFF_X + 2 * g * X_BYTES, sm + F_OFF_X + (2 * g + 1) * X_BYTES};
  uint8_t* h = sm + F_OFF_H + g * H_BYTES;
  float* alpha_s = small->alpha + g * TC_ROWS;
  float4* gr = small->gout[g];
  const int slot = 2 * blockIdx.x + g;
  float* bp = TRAIN ? bpart + (size_t)slot * P.bp_width : nullptr;
  // the heads' weight gradients, alpha.w columns 2 tl + 256 k and + 1 and
  // rgb.w rows tl + 128 k, are summed per tile and added to the consumer's
  // partials row in tile order (held in registers across the tiles, they
  // would spill)
  float dwa[2 * NA];
#pragma unroll
  for (int k = 0; k < 2 * NA; ++k) dwa[k] = 0.f;
  auto x_tile = [&](int tile) -> bf16* {  // the tile's block of the x scratch matrix
    return TRAIN ? scr + P.s_x + (long long)(2 * tile + g) * XW * 64 : nullptr;
  };

  if (blockIdx.x < ntiles)
    load_x(P, x, xb[0], x_tile(blockIdx.x), blockIdx.x * TILE + g * TC_ROWS, 0, 8);
  int b = 0;
  bool first = true;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, b ^= 1) {
    const int row0 = tile * TILE + g * TC_ROWS, next = tile + gridDim.x;
    int part = 0;  // the next tile's x, an 8-row part under each trunk chunk
    auto side_t = [&](int) {
      if (part < 8 && next < ntiles)
        load_x(P, x, xb[b ^ 1], x_tile(next), next * TILE + g * TC_ROWS, part, part + 1);
      ++part;
    };
    // under the feature layer's wgmmas, chunk c: the alpha head (its share
    // of a warp's 16 rows) or alpha.w's gradient (of the 64 rows), from the
    // trunk output in h
    auto side_f = [&](int c) {
      if constexpr (TRAIN) {
        for (int r = share<TC_ROWS>(c); r < share<TC_ROWS>(c + 1); ++r) {
          const float ga = bfr(gr[r].w);
#pragma unroll
          for (int k = 0; k < NA; ++k)
            if (2 * tl + 256 * k < HW) {
              const float2 hv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(h + sw128(r, 2 * tl + 256 * k)));
              dwa[2 * k] = fmaf(hv.x, ga, dwa[2 * k]);
              dwa[2 * k + 1] = fmaf(hv.y, ga, dwa[2 * k + 1]);
            }
        }
      } else {
        for (int r = share<16>(c); r < share<16>(c + 1); ++r) {
          const int row = wq * 16 + r;
          float s = 0.f;
          for (int k = lane; k < HW; k += 32) s = fmaf(ld_bf16(h, row, k), vec[P.wa + k], s);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == 0) alpha_s[row] = s + vec[P.ba];
        }
      }
    };
    if (TRAIN && tl < TC_ROWS)
      gr[tl] = row0 + tl < P.N ? *reinterpret_cast<const float4*>(gout + (size_t)(row0 + tl) * 4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    fence_async_smem();
    wg_sync(bar);  // x(b) and the cotangents are loaded; the previous tile's readers of h are done
    uint32_t hvb[VW / 64] = {};
    uint32_t* mk = TRAIN ? masks + (size_t)(2 * tile + g) * (P.depth + 1) * MASK_WORDS + WPT * tl
                         : nullptr;
    forward_tile<TRAIN>(P, ring, vec, smem_u32(xb[b]), h, bar, scr, 2 * tile + g, mk, hvb, side_t,
                        side_f);
    while (part < 8) side_t(0);  // a shallow trunk leaves parts over
    wg_sync(bar);  // h holds the views output
    if constexpr (TRAIN) {
      put_words(mk + P.depth * MASK_WORDS, hvb);
      for (int c = tl; c < VW; c += 128) {
        float dr0 = 0.f, dr1 = 0.f, dr2 = 0.f;
        for (int r = 0; r < TC_ROWS; ++r) {
          const float hv = ld_bf16(h, r, c);
          const float4 g4 = gr[r];
          dr0 = fmaf(hv, bfr(g4.x), dr0);
          dr1 = fmaf(hv, bfr(g4.y), dr1);
          dr2 = fmaf(hv, bfr(g4.z), dr2);
        }
        float* d = bp + P.bp_wrgb + 3 * c;
        if (first) {
          d[0] = dr0; d[1] = dr1; d[2] = dr2;
        } else {
          d[0] += dr0; d[1] += dr1; d[2] += dr2;
        }
      }
#pragma unroll
      for (int k = 0; k < NA; ++k)
        if (2 * tl + 256 * k < HW) {
          float* d = bp + P.bp_wa + 2 * tl + 256 * k;
          const float da0 = dwa[2 * k], da1 = dwa[2 * k + 1];
          dwa[2 * k] = dwa[2 * k + 1] = 0.f;
          if (first) {
            d[0] = da0; d[1] = da1;
          } else {
            d[0] += da0; d[1] += da1;
          }
        }
      if (tl < 4) {  // rgb.b and alpha.b: sums of the unrounded cotangents
        float s = 0.f;
        for (int r = 0; r < TC_ROWS; ++r) {
          const float4 g4 = gr[r];
          s += tl == 0 ? g4.x : tl == 1 ? g4.y : tl == 2 ? g4.z : g4.w;
        }
        float* d = bp + (tl < 3 ? P.bp_rgb + tl : P.bp_a);
        *d = first ? s : *d + s;
      }
      wg_sync(bar);  // every reader of this tile's cotangents is done: the next tile loads its own
    } else {
      // rgb head and the (N, 4) rows: rgb in columns 0..2, alpha in 3
      for (int i = 0; i < 16; ++i) {
        const int row = wq * 16 + i;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f;
        for (int k = lane; k < VW; k += 32) {
          const float hv = ld_bf16(h, row, k);
          s0 = fmaf(hv, vec[P.wrgb + 3 * k], s0);
          s1 = fmaf(hv, vec[P.wrgb + 3 * k + 1], s1);
          s2 = fmaf(hv, vec[P.wrgb + 3 * k + 2], s2);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        const int n = row0 + row;
        if (lane == 0 && n < P.N)
          *reinterpret_cast<float4*>(out + (size_t)n * 4) = make_float4(
              s0 + vec[P.brgb], s1 + vec[P.brgb + 1], s2 + vec[P.brgb + 2], alpha_s[row]);
      }
    }
    first = false;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
k3_fwd(const K3Params P, const float* __restrict__ x, const bf16* __restrict__ fstream,
       const float* __restrict__ vec, float* __restrict__ out) {
  forward_pass<false>(P, x, fstream, vec, out, nullptr, nullptr, nullptr, nullptr);
}

__global__ void __launch_bounds__(THREADS, 1)
k3_recompute(const K3Params P, const float* __restrict__ x, const float* __restrict__ gout,
             const bf16* __restrict__ fstream, const float* __restrict__ vec,
             bf16* __restrict__ scr, uint32_t* __restrict__ masks, float* __restrict__ bpart) {
  forward_pass<true>(P, x, fstream, vec, nullptr, gout, scr, masks, bpart);
}

// The chain walked back, per tile: g_hv = (g_rgb @ wrgb^T) * (hv > 0) on the
// CUDA cores (K = 3), dX's first term g_hv @ wv_d^T, g_feat = g_hv @
// wv_f^T, the trunk output's g_feat @ wf^T + g_alpha wa^T (the rank-1 term
// on the CUDA cores), then the trunk from its last layer down; every
// cotangent through put_cot (mask, bias partial, bf16, in place as the next
// A operand, scratch), every dX term added into the tile's rows of dx.
__global__ void __launch_bounds__(THREADS, 1)
k3_chain(const K3Params P, const float* __restrict__ gout, const bf16* __restrict__ bstream,
         const float* __restrict__ vec, bf16* __restrict__ scr,
         const uint32_t* __restrict__ masks, float* __restrict__ bpart, float* __restrict__ dx) {
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  ChainSmall* small = reinterpret_cast<ChainSmall*>(sm + C_OFF_SMALL);
  const int ntiles = P.tiles / 2;
  Ring ring{smem_u32(small->full), smem_u32(small->empty), smem_u32(sm), 0, 0};
  if (!split_roles(sm, small->full, small->empty, TC_STAGES, [&] {
        k3_produce(P, bstream, true, ntiles, ring.full, ring.empty, ring.buf);
      }))
    return;
  const int g = threadIdx.x >> 7, bar = 1 + g, tl = threadIdx.x & 127;
  const int lane = tl & 31, r0 = (tl >> 5) * 16 + (lane >> 2), p = lane & 3;
  uint8_t* h = sm + C_OFF_H + g * H_BYTES;
  const uint32_t ha = smem_u32(h);
  float* cs = &small->cs[g][0][0];
  float4* gr = small->gout[g];
  const int slot = 2 * blockIdx.x + g, D = P.depth;
  float* bp = bpart + (size_t)slot * P.bp_width;
  bool first = true;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long ti = 2 * tile + g;  // 64-row tile
    const int row0 = (int)ti * TC_ROWS;
    const long long oh = ti * HW * 64, ov = ti * VW * 64;
    const uint32_t* mk = masks + ti * (D + 1) * MASK_WORDS + WPT * tl;  // the tile's relu signs
    if (tl < TC_ROWS)
      gr[tl] = row0 + tl < P.N ? *reinterpret_cast<const float4*>(gout + (size_t)(row0 + tl) * 4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    wg_sync(bar);  // the cotangents are loaded
    // each product's accumulator is its own, scoped to its block: no
    // accumulator stays live between products
    {
      uint32_t bits[VW / 64];
      get_words(mk + D * MASK_WORDS, bits);
      float v[VW / 2], gq[2][3];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 g4 = gr[r0 + 8 * i];
        gq[i][0] = bfr(g4.x); gq[i][1] = bfr(g4.y); gq[i][2] = bfr(g4.z);
      }
#pragma unroll
      for (int j = 0; j < VW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* wr = vec + P.wrgb + 3 * (8 * j + 2 * p + e);
          const float w0 = wr[0], w1 = wr[1], w2 = wr[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            v[j * 4 + 2 * i + e] = fmaf(gq[i][2], w2, fmaf(gq[i][1], w1, gq[i][0] * w0));
        }
      put_cot<VW, true>(v, bits, cs, bp + P.bp_v, first, h, scr + P.s_ghv + ov, bar);
    }
    {  // dX = g_hv @ wv_d^T, the first of its terms
      float v[64];
      tc_layer<128>(ring, v, ha, KV, 0, 0);
      dx_add(P, v, dx, row0, true);
    }
    auto nothing = [](auto&) {};
    {  // g_feat = g_hv @ wv_f^T (the feature layer has no relu)
      uint32_t none[WPT];
      cot_layer<HW, false>(ring, ha, KV, none, cs, bp + P.bp_f, first, h, scr + P.s_gfeat + oh,
                           bar, nothing);
    }
    {  // g_h = g_feat @ wf^T + g_alpha wa^T at the trunk's output
      uint32_t bits[WPT];
      get_words(mk + (D - 1) * MASK_WORDS, bits);
      const float ga0 = bfr(gr[r0].w), ga1 = bfr(gr[r0 + 8].w);
      cot_layer<HW, true>(ring, ha, KH, bits, cs, bp + lt_bp(P, D - 1), first, h,
                          scr + lt_sg(P, D - 1) + oh, bar, [&](auto& acc) {
#pragma unroll
        for (int j = 0; j < HW / 8; ++j) {
          const float2 wa = *reinterpret_cast<const float2*>(vec + P.wa + 8 * j + 2 * p);
          acc[j * 4 + 0] = fmaf(ga0, wa.x, acc[j * 4 + 0]);
          acc[j * 4 + 1] = fmaf(ga0, wa.y, acc[j * 4 + 1]);
          acc[j * 4 + 2] = fmaf(ga1, wa.x, acc[j * 4 + 2]);
          acc[j * 4 + 3] = fmaf(ga1, wa.y, acc[j * 4 + 3]);
        }
      });
    }
    // the trunk from its last layer down: where layer i took x, dX +=
    // g_pre_i @ wx_i^T; the cotangent at layer i-1's output g_pre_i @ w_i^T
    for (int i = D - 1; i >= 1; --i) {
      if (takes_x(P, i)) {
        float v[64];
        tc_layer<128>(ring, v, ha, KH, 0, 0);
        dx_add(P, v, dx, row0, false);
      }
      uint32_t bits[WPT];
      get_words(mk + (i - 1) * MASK_WORDS, bits);
      cot_layer<HW, true>(ring, ha, KH, bits, cs, bp + lt_bp(P, i - 1), first, h,
                          scr + lt_sg(P, i - 1) + oh, bar, nothing);
    }
    {  // dX += g_pre_0 @ w_0^T
      float v[64];
      tc_layer<128>(ring, v, ha, KH, 0, 0);
      dx_add(P, v, dx, row0, false);
    }
    first = false;
  }
}

// The consumers of k3_dw: consumer g multiplies A's slab g by B, over the
// slice's row tiles, and writes its 64 x N fp32 partial to out. A consumer
// without a slab only frees the stages.
template <int N>
__device__ __forceinline__ void dw_consume(const DwTile& D, int t0, int t1, uint32_t full,
                                           uint32_t empty, uint32_t buf, float* __restrict__ out) {
  const int g = threadIdx.x >> 7;
  const bool lead = (threadIdx.x & 31) == 0;
  int stage = 0;
  uint32_t phase = 0;
  if (g >= D.nslab) {
    for (int t = t0; t < t1; ++t) {
      mbar_wait(full + 8 * stage, phase);
      if (lead) mbar_arrive(empty + 8 * stage);
      if (++stage == DW_STAGES) { stage = 0; phase ^= 1; }
    }
    return;
  }
  float acc[N / 2];
  int prev = -1;
  wgmma_fence();
  for (int t = t0; t < t1; ++t) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t st = buf + stage * DW_STAGE_BYTES;
    const uint64_t da = sw128_desc(st + g * DW_A_BYTES), db = sw128_desc(st + 2 * DW_A_BYTES);
#pragma unroll
    for (int kk = 0; kk < TC_KC / 16; ++kk)
      wgmma_k16<N>(acc, da + 2 * kk, db + 2 * kk, t > t0 || kk > 0);
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if (lead) mbar_arrive(empty + 8 * prev);
    }
    prev = stage;
    if (++stage == DW_STAGES) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (lead) mbar_arrive(empty + 8 * prev);
  const int tl = threadIdx.x & 127, l = tl & 31, r0 = (tl >> 5) * 16 + (l >> 2), p = l & 3;
  float* o = out + g * TC_ROWS * N;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(o + (r0 + 8 * i) * N + 8 * j + 2 * p) =
          make_float2(acc[j * 4 + 2 * i], acc[j * 4 + 2 * i + 1]);
}

// Block b: output tile b % n_tiles of the table over row slice b / n_tiles
// (row tiles [s tps, (s + 1) tps) of T), its partial into slot (tile * S +
// s) of part.
__global__ void __launch_bounds__(THREADS, 1)
k3_dw(const DwTile* __restrict__ tiles, int n_tiles, int tps, int T,
      const bf16* __restrict__ scr, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(sm + DW_STAGES * DW_STAGE_BYTES);
  unsigned long long* empty = full + DW_STAGES;
  const int ti = blockIdx.x % n_tiles, s = blockIdx.x / n_tiles, S = gridDim.x / n_tiles;
  const DwTile D = tiles[ti];
  const int t0 = s * tps, t1 = min(T, t0 + tps);
  const uint32_t buf = smem_u32(sm), fb = smem_u32(full), eb = smem_u32(empty);
  if (!split_roles(sm, full, empty, DW_STAGES, [&] {
        int stage = 0;
        uint32_t phase = 0;
        const uint32_t bytes = DW_A_BYTES * D.nslab + D.n * TC_KC * 2;
        for (int t = t0; t < t1; ++t) {
          mbar_wait(eb + 8 * stage, phase ^ 1);
          const uint32_t dst = buf + stage * DW_STAGE_BYTES, bar = fb + 8 * stage;
          const bf16* a = scr + D.a + (long long)t * D.a_stride;
          mbar_expect(bar, bytes);
          bulk_copy(dst, a, DW_A_BYTES, bar);
          if (D.nslab == 2) bulk_copy(dst + DW_A_BYTES, a + BLK, DW_A_BYTES, bar);
          bulk_copy(dst + 2 * DW_A_BYTES, scr + D.b + (long long)t * D.b_stride, D.n * TC_KC * 2,
                    bar);
          if (++stage == DW_STAGES) { stage = 0; phase ^= 1; }
        }
      }))
    return;
  float* out = part + ((size_t)ti * S + s) * DW_PART;
  switch (D.n) {  // B's columns: a gradient's output tile, at most 256 wide
    case 256: dw_consume<256>(D, t0, t1, fb, eb, buf, out); break;
    case 192: dw_consume<192>(D, t0, t1, fb, eb, buf, out); break;
    case 128: dw_consume<128>(D, t0, t1, fb, eb, buf, out); break;
    default: dw_consume<64>(D, t0, t1, fb, eb, buf, out); break;
  }
}

// blockIdx.y < n_tiles: one dW output tile, its partials summed over the S
// slices in order; blockIdx.y == n_tiles: the bias partials (and the heads'
// weight gradients) summed over the consumers in order. Into gbuf.
__global__ void k3_reduce(const DwTile* __restrict__ tiles, int n_tiles, int S,
                          const float* __restrict__ part, const float* __restrict__ bpart,
                          int slots, int bp_width, float* __restrict__ gbuf) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.y == n_tiles) {
    if (e >= bp_width) return;
    float s = 0.f;
    for (int i = 0; i < slots; ++i) s += bpart[(size_t)i * bp_width + e];
    gbuf[e] = s;
    return;
  }
  const DwTile D = tiles[blockIdx.y];
  if (e >= D.nslab * TC_ROWS * D.n) return;
  const int slab = e / (TC_ROWS * D.n), r = (e / D.n) % TC_ROWS, c = e % D.n;
  const int k = D.k0 + TC_ROWS * slab + r;
  if (k < D.k_lo || k >= D.k_hi || c >= D.m_valid) return;
  const float* src = part + (size_t)blockIdx.y * S * DW_PART + e;
  float s = 0.f;
  for (int i = 0; i < S; ++i) s += src[(size_t)i * DW_PART];
  gbuf[D.dst + (long long)(k - D.k_lo) * D.ldo + c] = s;
}

// k3_dw over the table's n_tiles output tiles and S slices of tps of the T
// row tiles, then k3_reduce of its partials and of slots bias-partial rows.
cudaError_t weight_grads(const void* tiles, int n_tiles, int S, int tps, int T, const bf16* scr,
                         float* part, const float* bpart, int slots, int bp_width, float* gbuf,
                         cudaStream_t s) {
  const DwTile* tt = static_cast<const DwTile*>(tiles);
  k3_dw<<<n_tiles * S, THREADS, DW_SMEM, s>>>(tt, n_tiles, tps, T, scr, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k3_reduce<<<dim3(DW_PART / 256, n_tiles + 1), 256, 0, s>>>(tt, n_tiles, S, part, bpart, slots,
                                                             bp_width, gbuf);
  return cudaGetLastError();
}

cudaError_t set_smem() {
  cudaError_t e = cudaFuncSetAttribute(k3_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)F_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k3_recompute, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)F_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k3_chain, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k3_dw, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DW_SMEM);
  return e;
}

}  // namespace

extern "C" int k3_forward(int device, const K3Params* P, const float* x, const void* fstream,
                          const float* vec, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = set_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  k3_fwd<<<P->blocks, THREADS, F_SMEM, s>>>(*P, x, static_cast<const bf16*>(fstream), vec, out);
  return static_cast<int>(cudaGetLastError());
}

// The whole backward in four launches: the recompute (scratch, relu bits,
// the heads' gradients), the chain (cotangents, bias partials, dx), the
// weight-gradient GEMMs of the n_tiles table entries over S slices of tps
// row tiles (partials into part), and the reduce into gbuf.
extern "C" int k3_backward(int device, const K3Params* P, const float* x, const float* gout,
                           const void* fstream, const void* bstream, const float* vec,
                           void* scratch, void* masks, float* bpart, float* dx,
                           const void* tiles, int n_tiles, int S, int tps, float* part,
                           float* gbuf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = set_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  bf16* scr = static_cast<bf16*>(scratch);
  uint32_t* mk = static_cast<uint32_t*>(masks);
  k3_recompute<<<P->blocks, THREADS, F_SMEM, s>>>(*P, x, gout, static_cast<const bf16*>(fstream),
                                                  vec, scr, mk, bpart);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  k3_chain<<<P->blocks, THREADS, C_SMEM, s>>>(*P, gout, static_cast<const bf16*>(bstream), vec,
                                              scr, mk, bpart, dx);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(weight_grads(tiles, n_tiles, S, tps, P->tiles, scr, part, bpart,
                                        2 * P->blocks, (int)P->bp_width, gbuf, s));
}

// The weight gradients of the wide path (wide.cu), whose chain leaves the
// same scratch and one bias-partial row per 128-row tile (slots rows): k3_dw
// and k3_reduce alone.
extern "C" int k3_weight_grads(int device, const void* tiles, int n_tiles, int S, int tps, int T,
                               const void* scratch, float* part, const float* bpart, int slots,
                               int bp_width, float* gbuf, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = set_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(weight_grads(tiles, n_tiles, S, tps, T, static_cast<const bf16*>(scratch),
                                        part, bpart, slots, bp_width, gbuf,
                                        static_cast<cudaStream_t>(stream)));
}

// which 0: sizeof(K3Params), 1: sizeof(DwTile), 2: the hidden width this
// library is built for.
extern "C" int k3_struct_size(int which) {
  return which == 0 ? static_cast<int>(sizeof(K3Params))
                    : which == 1 ? static_cast<int>(sizeof(DwTile)) : HW;
}
