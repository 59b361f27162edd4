// The wide path of K1, K2 and K3 for Hopper (sm_90a): the MLP layers one at
// a time, each a hand-written GEMM with a fused epilogue, the activations
// between layers in device memory. It takes every network shape that the
// fused kernels (megakernel.cuh, nerf_train.cu, at 128 and 256 columns) do
// not: an MLP of 384 columns and up (any multiple of 64; the width is a
// run-time argument, so this one library serves every width), and K3's
// NeRF with more than 128 encoded input columns. Depth has no cap here
// either.
//
// Replaces, at those shapes, what the fused kernels replace:
// adanerf_tpu/ops/pallas/megakernel3.py::make_megakernel_compact (K1),
// adanerf_tpu/ops/pallas/megakernel.py::make_megakernel (K2) and
// adanerf_tpu/ops/pallas/train_kernel.py::make_nerf_train_apply (K3). The
// wrappers (ops/kernels/megakernel_compact.py, nerf_train.py) launch the
// kernels below layer by layer; their plain versions are the same as the
// fused kernels'.
//
// Why not fused: each consumer warpgroup of the fused kernels keeps its 64
// rows of activations (64 x W bf16) in shared memory, and above 256
// columns a layer needs two wgmma passes whose first parks in registers
// and spills; at 640 the tile no longer fits a block. What bounds the wide
// path: a W x W layer over R rows does 2 R W^2 operations and moves 4 R W
// bytes of bf16 activations in and out, W / 2 operations a byte, near the
// H100's ridge of ~295 at 512 and above it from 640 up. So the layers are
// bound by arithmetic or close to it with their activations off chip, and
// each runs as one GEMM.
//
// wd_gemm, the GEMM of the bf16 layers: C = epi([A0 | A1] @ B), a tile of
// 128 rows x 128 columns (64 where a pass of the weight stream ends on a
// half) at a time. What bounds it: the tensor cores, fed from L2 (a tile's
// k step brings 32 KB for 2.1 MFLOP, 64 operations a byte). The grid is
// persistent, one block an SM (288 threads: two consumer warpgroups and a
// producer warp, 168 registers a thread; a producer warpgroup handing its
// registers to the consumers by setmaxnreg leaves ptxas at 168 too, and
// measured slower at three of gemm_ablation.py's four shapes): each block walks the
// tiles blockIdx.x, + gridDim.x, ... of the launch, their count read on the
// device (rows_of: K1's live count), so a fixed grid covers any count with
// no empty blocks. One producer thread runs ahead through the block's tiles
// chunk after chunk of K = 64, bringing both 64 x 64 A blocks of the tile's
// rows and the tile's 128 x 64 share of the B chunk (the packed weight
// stream's chunk of the pass, whose rows are the output columns) by bulk
// async copies into a 5-stage ring, and after a tile's chunks its relu mask
// (K3's backward). Two consumer warpgroups take the block's tiles in turns
// (ping-pong, their mainloops ordered by a barrier pair): each owns a whole
// tile, runs two m64n128k16 wgmmas a k step (one for each 64-row half;
// bf16 operands, fp32 sums) and then its epilogue, which runs under the
// other warpgroup's wgmmas. The activations in device memory are in the
// tile layout of mlp_wgmma.cuh (a 64-row tile of F columns = F / 64
// swizzled 64 x 64 blocks), so that a block lands ready for wgmma by one
// linear copy. The epilogue adds, in this order, K3's rank-1 alpha term,
// the bias, the relu and K3's relu mask (from shared memory, 8 x 8 at a
// time, transposed by movmatrix), sums columns for K3's bias partials
// (deterministic: a fixed butterfly and a fixed order over the tile's eight
// 16-row groups, one partial row per 128-row tile), stores fp32 (logits,
// dX) from registers, and stages bf16 in the tile layout (the next layer's
// A) and transposed into K3's scratch (movmatrix, as nerf_train.cu's
// put_act) through shared memory, 64 x 64 a time in two alternating
// halves, written back by bulk async stores. The arithmetic is the fused
// kernels': bf16 operands, fp32 sums and biases, each stored activation
// rounded to bf16, the k chunks in stream order; the warpgroup's index is
// broadcast from lane 0, so that the compiler sees its branches as uniform
// and issues the wgmmas unserialized.
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

constexpr int WD_THREADS = 288;  // two consumer warpgroups and the producer's warp
constexpr int WD_TM = 2 * TC_ROWS;  // rows of a tile: two 64-row tiles of the layout
constexpr int WD_TN = 128;          // columns of a tile
constexpr int WD_STAGES = 5;
constexpr int WD_A_BYTES = TC_ROWS * TC_KC * 2;                 // one 64 x 64 A block
constexpr int WD_STAGE_BYTES = 2 * WD_A_BYTES + WD_TN * TC_KC * 2;
constexpr int WD_EPI_BYTES = 2 * WD_TM * WD_TN;  // a consumer's epilogue buffer: 128 x 128 bf16
constexpr int WD_OFF_EPI = WD_STAGES * WD_STAGE_BYTES;
constexpr int WD_OFF_BAR = WD_OFF_EPI + 2 * WD_EPI_BYTES;
// barriers: full and empty a stage, order a consumer, and a consumer's
// epilogue buffer's mask arrived (efull) and free again (efree)
constexpr size_t WD_SMEM = WD_OFF_BAR + (2 * WD_STAGES + 6) * 8;
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

// One bulk async store of `bytes` (a multiple of 16) from shared memory to
// global memory, in the issuing thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until at most N of the issuing thread's bulk groups have yet to
// read their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}

// Waits until the issuing thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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

// The block's k-th tile, consumer g's (k % 2 == g), the launch's tile
// blockIdx.x + k gridDim.x of nct column tiles a 128-row tile: rows 128 bt..
// (the 64-row tiles 2 bt and 2 bt + 1), columns col0.. (nt of them: 128, or
// 64 where a pass ends, whose other 64 columns the wgmmas compute from
// stale stage bytes and the epilogue leaves), its chunks at the ring
// positions k kc.. (every tile has kc chunks); the order barrier ob + 8 g
// lets it start. One code path for every tile: no wgmma sits in a branch.
// epi is the warpgroup's epilogue buffer (32 KB): the producer's copy of
// the tile's relu mask (K3's scratch layout, each 64-row half at 16 KB)
// where there is one, signalled on efull; then the column sums of the bias
// partials; then two 16 KB halves in turn, each a staged 64 x 64 block of
// out and of st; released on efree where a mask comes. The shared-memory
// addresses are derived here from the base, through opaque, so that none
// stays live (and spills) across the consumer's loop over its tiles.
__device__ __forceinline__ void wd_tile(const WdGemm& G, int g, int k, int M, int nct) {
  extern __shared__ float4 smem4[];
  constexpr int NT = WD_TN;
  const int t = blockIdx.x + k * gridDim.x, bt = t / nct, col0 = (t - bt * nct) * WD_TN;
  const int nt = G.n - col0 < WD_TN ? G.n - col0 : WD_TN, kc = G.kc0 + G.kc1, it = k >> 1;
  const uint32_t buf = opaque(smem_u32(smem4)), fb = buf + WD_OFF_BAR;
  const uint32_t eb = fb + 8 * WD_STAGES, ob = eb + 8 * WD_STAGES;
  const uint32_t efull = ob + 16 + 8 * g, efree = ob + 32 + 8 * g;
  uint8_t* epi = reinterpret_cast<uint8_t*>(smem4) + WD_OFF_EPI + g * WD_EPI_BYTES;
  const uint32_t pos = static_cast<uint32_t>(k) * kc;
  const int tl = threadIdx.x & 127, lane = tl & 31, w = tl >> 5;
  const int q = lane >> 2, p = lane & 3;
  float acc[2][NT / 2];
  int stage = pos % WD_STAGES;
  uint32_t phase = (pos / WD_STAGES) & 1;
  // the other consumer's tile before this one has seen all its chunks
  // arrive: every ring position before pos is filled, so the parity of
  // pos's stage names pos's chunk and no earlier one
  mbar_wait(ob + 8 * g, (it + 1 - g) & 1);
  // the tile's chunks, the first peeled off so that no wgmma, commit or
  // wait sits in a branch: chunk c's wgmmas run while chunk c - 1's stage
  // is released
  wgmma_fence();
  int prev = stage;
  {
    mbar_wait(fb + 8 * stage, phase);
    const uint32_t st = buf + stage * WD_STAGE_BYTES;
    const uint64_t da0 = sw128_desc(st), da1 = sw128_desc(st + WD_A_BYTES);
    const uint64_t db = sw128_desc(st + 2 * WD_A_BYTES);
#pragma unroll
    for (int kk = 0; kk < TC_KC / 16; ++kk) {
      wgmma_k16<NT>(acc[0], da0 + 2 * kk, db + 2 * kk, kk > 0);
      wgmma_k16<NT>(acc[1], da1 + 2 * kk, db + 2 * kk, kk > 0);
    }
    wgmma_commit();
    if (++stage == WD_STAGES) { stage = 0; phase ^= 1; }
  }
  for (int c = 1; c < kc; ++c) {
    mbar_wait(fb + 8 * stage, phase);
    const uint32_t st = buf + stage * WD_STAGE_BYTES;
    const uint64_t da0 = sw128_desc(st), da1 = sw128_desc(st + WD_A_BYTES);
    const uint64_t db = sw128_desc(st + 2 * WD_A_BYTES);
#pragma unroll
    for (int kk = 0; kk < TC_KC / 16; ++kk) {
      wgmma_k16<NT>(acc[0], da0 + 2 * kk, db + 2 * kk, 1);
      wgmma_k16<NT>(acc[1], da1 + 2 * kk, db + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (lane == 0) mbar_arrive(eb + 8 * prev);
    prev = stage;
    if (++stage == WD_STAGES) { stage = 0; phase ^= 1; }
  }
  if (tl == 0) mbar_arrive(ob + 8 * (1 - g));  // the other consumer's next tile may start
  wgmma_wait<0>();
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  if (lane == 0) mbar_arrive(eb + 8 * prev);

  // accumulator element acc[m][j * 4 + 2 i + e]: row rt + 8 i of the
  // 64-row tile 2 bt + m, column col0 + 8 j + 2 p + e
  const int rt = w * 16 + q;
  if (G.mask != nullptr) mbar_wait(efull, it & 1);
  float gr[2][2];  // the rows' bf16(ga[row][3]), where the alpha term applies (row < M)
  bool ga[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (2 * bt + m) * TC_ROWS + rt + 8 * i;
      ga[m][i] = G.ga != nullptr && row < M;
      gr[m][i] = ga[m][i] ? bfr(G.ga[(size_t)row * 4 + 3]) : 0.f;
    }
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    if (8 * j >= nt) continue;
    const int c = col0 + 8 * j + 2 * p;
    float b[2] = {0.f, 0.f}, wa[2] = {0.f, 0.f};
    if (G.bias != nullptr) { b[0] = __ldg(G.bias + c); b[1] = __ldg(G.bias + c + 1); }
    if (G.ga != nullptr) { wa[0] = __ldg(G.wa + c); wa[1] = __ldg(G.wa + c + 1); }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t mk = 0xffffffffu;  // the mask at (row, c, c + 1), transposed from K3's scratch
        if (G.mask != nullptr)
          mk = transpose8x8(*reinterpret_cast<const uint32_t*>(
              epi + 2 * (m * 8192 + j * 512 + q * 64 + ((((2 * w + i) ^ q) & 7) << 3) + 2 * p)));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = acc[m][j * 4 + 2 * i + e];
          if (ga[m][i]) v = fmaf(gr[m][i], wa[e], v);
          if (G.bias != nullptr) v += b[e];
          if (G.relu) v = fmaxf(v, 0.f);
          if (((mk >> (16 * e)) & 0xffffu) == 0) v = 0.f;
          acc[m][j * 4 + 2 * i + e] = v;
        }
      }
  }
  wg_sync(1 + g);  // the mask is read: epi holds the column sums, then the staged stores
  if (G.bp != nullptr) {  // column sums of the tile's 128 rows, 16-row group by group
    float* cs = reinterpret_cast<float*>(epi);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = acc[m][j * 4 + e] + acc[m][j * 4 + 2 + e];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          if (q == 0) cs[(4 * m + w) * WD_TN + 8 * j + 2 * p + e] = s;
        }
    wg_sync(1 + g);  // the warpgroup's sums are in
    if (tl < nt) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) s += cs[k * WD_TN + tl];
      G.bp[(size_t)bt * G.ldbp + col0 + tl] = s;
    }
    wg_sync(1 + g);  // cs is free again
  }
  if (G.f32 != nullptr) {  // row-major, columns < f32_cols, rows < M
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = (2 * bt + m) * TC_ROWS + rt + 8 * i;
        if (row >= M) continue;
        float* d = G.f32 + (size_t)row * G.ldf + col0 + 2 * p;
        const int left = G.f32_cols - col0 - 2 * p;  // the row's columns from d on
#pragma unroll
        for (int j = 0; j < NT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * j + e < left) {
              const float v = acc[m][j * 4 + 2 * i + e];
              d[8 * j + e] = G.f32_add ? d[8 * j + e] + v : v;
            }
      }
  }
  if (G.out != nullptr || G.st != nullptr) {
    // 64 x 64 at a time: the block of out in the tile layout and of st in
    // the scratch layout, each 8 KB and contiguous in device memory, staged
    // in one half of epi as they lie there, then stored by one thread while
    // the warpgroup stages the next block in the other half
    int u = 0;  // blocks staged so far
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int jb = 0; jb < NT / 64; ++jb) {
        if (64 * jb >= nt) continue;
        const uint32_t sb = opaque(smem_u32(epi)) + (u & 1) * 2 * TC_BLOCK_BYTES;
        if (u >= 2) {
          if (tl == 0) bulk_wait_read<1>();  // the block before last has left this half
          wg_sync(1 + g);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // (row rt + 8 i, column 8 jj + 2 p) of out's block: sw128, row % 8 == q;
          // (feature 8 jj + q, rows 16 w + 8 i + 2 p, + 1) of st's: tile_off
          const uint32_t ob = sb + (rt + 8 * i) * 128 + 4 * p;
          const uint32_t tb = sb + TC_BLOCK_BYTES + 2 * (q * 64 + ((((2 * w + i) ^ q) & 7) << 3) + 2 * p);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * jb + jj;
            const uint32_t v =
                as_u32(__floats2bfloat162_rn(acc[m][j * 4 + 2 * i], acc[m][j * 4 + 2 * i + 1]));
            if (G.out != nullptr) st_shared(ob + ((jj ^ q) << 4), v);
            if (G.st != nullptr) st_shared(tb + jj * 1024, transpose8x8(v));
          }
        }
        fence_async_smem();
        wg_sync(1 + g);
        if (tl == 0) {
          const size_t ti = 2 * bt + m, cb = col0 + 64 * jb;
          if (G.out != nullptr)
            bulk_store(reinterpret_cast<uint8_t*>(G.out) + (ti * G.n + cb) * 128, sb,
                       TC_BLOCK_BYTES);
          if (G.st != nullptr)
            bulk_store(G.st + (ti * G.n + cb) * 64, sb + TC_BLOCK_BYTES, TC_BLOCK_BYTES);
          bulk_commit();
        }
        ++u;
      }
  }
  // epi is free once the stores have read it: for the next tile's mask,
  // and the next tile's first staged blocks
  fence_async_smem();  // this tile's writes to epi come before the next mask's copy
  if (tl == 0) {
    bulk_wait_read<0>();
    if (G.mask != nullptr) mbar_arrive(efree);
  }
  wg_sync(1 + g);
}

__global__ void __launch_bounds__(WD_THREADS, 1) wd_gemm(const WdGemm G) {
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  const int M = rows_of(G.count, G.base, G.rows);
  const int nct = (G.n + WD_TN - 1) / WD_TN, tiles = (M + WD_TM - 1) / WD_TM * nct;
  const int kc = G.kc0 + G.kc1;
  const uint32_t buf = smem_u32(sm), fb = smem_u32(sm + WD_OFF_BAR);
  const uint32_t eb = fb + 8 * WD_STAGES, ob = eb + 8 * WD_STAGES, efb = ob + 16, erb = efb + 16;
  if (buf & 1023) __trap();  // the swizzle needs 1024-byte aligned stages
  if (threadIdx.x == 0) {
    for (int i = 0; i < WD_STAGES; ++i) {
      mbar_init(fb + 8 * i, 1);
      mbar_init(eb + 8 * i, 4);  // the warps of the warpgroup that read the stage
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(ob + 8 * i, 1);   // consumer i may start its next tile
      mbar_init(efb + 8 * i, 1);  // consumer i's mask is in
      mbar_init(erb + 8 * i, 1);  // consumer i's epilogue buffer is free
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the warpgroup's index, broadcast from lane 0 so that the compiler sees
  // every branch on it as uniform across the warp (a wgmma behind a branch
  // it takes for divergent is serialized)
  const int g = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  if (g == 2) {  // the producer warp
    if (threadIdx.x == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x, k = 0; t < tiles; t += gridDim.x, ++k) {
        const int bt = t / nct, col0 = (t - bt * nct) * WD_TN, c0 = col0 & ~255;
        const int np = G.n - c0 < 256 ? G.n - c0 : 256, nt = G.n - col0 < WD_TN ? G.n - col0 : WD_TN;
        // earlier passes are 256 wide: pass c0 / 256 starts c0 kc 64 elements
        // in; the tile's columns are rows col0 - c0.. of each of its chunks
        const bf16* wp = G.w + (size_t)c0 * kc * TC_KC + (size_t)(col0 - c0) * TC_KC;
        for (int c = 0; c < kc; ++c) {
          mbar_wait(eb + 8 * stage, phase ^ 1);
          const uint32_t dst = buf + stage * WD_STAGE_BYTES, bar = fb + 8 * stage;
          const bool first = c < G.kc0;
          const int kb = first ? G.kc0 : G.kc1;  // blocks a tile of this operand
          const bf16* a =
              (first ? G.a0 : G.a1) + ((size_t)(2 * bt) * kb + (first ? c : c - G.kc0)) * 4096;
          mbar_expect(bar, 2 * WD_A_BYTES + nt * TC_KC * 2);
          bulk_copy(dst, a, WD_A_BYTES, bar);
          bulk_copy(dst + WD_A_BYTES, a + (size_t)kb * 4096, WD_A_BYTES, bar);
          bulk_copy(dst + 2 * WD_A_BYTES, wp + (size_t)c * np * TC_KC, nt * TC_KC * 2, bar);
          if (++stage == WD_STAGES) { stage = 0; phase ^= 1; }
        }
        if (G.mask != nullptr) {
          // the tile's relu mask into its consumer's epilogue buffer, once
          // that consumer's tile before has done with it (parity 1 of a
          // fresh barrier for its first)
          const int cg = k & 1;
          const uint32_t ebuf = buf + WD_OFF_EPI + cg * WD_EPI_BYTES, bar = efb + 8 * cg;
          mbar_wait(erb + 8 * cg, ((k >> 1) & 1) ^ 1);
          mbar_expect(bar, 2 * nt * 128);
          for (int m = 0; m < 2; ++m)
            bulk_copy(ebuf + m * 2 * TC_BLOCK_BYTES, G.mask + ((size_t)(2 * bt + m) * G.n + col0) * 64,
                      nt * 128, bar);
        }
      }
    }
    return;
  }
  // the block's k-th tile is consumer k % 2's; its chunks sit at ring
  // positions k kc.. (every tile has kc chunks). The two take their
  // mainloops in turns: tile k's starts once tile k - 1 has all its chunks
  // (the order barriers; consumer 0's first tile waits on none, parity 1
  // of a fresh barrier)
  for (int k = g; blockIdx.x + k * gridDim.x < tiles; k += 2) wd_tile(G, g, k, M, nct);
  if ((threadIdx.x & 127) == 0) bulk_wait_all();  // the stores are out before the block ends
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
  int sms = 0;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wd_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WD_SMEM);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the most tiles the launch can have (the device count may cut them)
  const long long tiles = (long long)((G->rows + WD_TM - 1) / WD_TM) * ((G->n + WD_TN - 1) / WD_TN);
  if (tiles == 0) return 0;
  wd_gemm<<<tiles < sms ? (int)tiles : sms, WD_THREADS, WD_SMEM, as_stream(stream)>>>(*G);
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
