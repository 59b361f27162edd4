// The layer core of the bf16 frame renderers, K1 and K2 (megakernel.cuh),
// and of the train step's K3 (nerf_train.cu), for Hopper (sm_90a): warpgroup
// matrix multiplies (wgmma) on bf16 operands
// in shared memory with fp32 accumulators in registers, fed by a producer
// that brings each layer's weights, chunk after chunk, by bulk async copy
// into a ring of shared-memory stages guarded by mbarriers.
//
// A layer's N output columns are at most 256, one wgmma (the fused
// libraries' widths, 128 and 256; wider layers run on the wide path,
// wide.cu, which reads its weight streams pass by pass, 256 columns a
// pass).
//
// A block runs one producer warpgroup (one thread issues the copies) and
// two consumer warpgroups. Each consumer owns a 64-row tile (the wgmma M)
// and reads every staged chunk; both read the same stage, so a chunk
// fetched from L2 once serves 128 rows.
//
// Layout, mirrored by ops/kernels/megakernel_compact.py (swizzle128): every
// operand in shared memory is K-major with the 128-byte swizzle. A block of
// rows x 64 bf16 columns keeps each row in 128 bytes, 16-byte group g of
// row r at group g ^ (r % 8), and 8-row groups 1024 bytes apart. An
// activation tile (64 rows x K) is K / 64 such blocks of 8 KB. A weight
// chunk is 64 rows of the K x N matrix W, transposed (N rows x 64) and
// swizzled by the packer, N * 128 bytes, so that one linear bulk copy lands
// it ready for wgmma's B operand. Stages and tiles are 1024-byte aligned.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>


namespace {

constexpr int TC_ROWS = 64;                            // rows per consumer = wgmma M
constexpr int TC_KC = 64;                              // K per chunk: one swizzle atom
constexpr int TC_STAGES = 3;                           // weight chunks in flight
constexpr int TC_STAGE_BYTES = 256 * TC_KC * 2;        // the widest chunk, N = 256
constexpr int TC_BLOCK_BYTES = TC_ROWS * TC_KC * 2;    // one 64 x 64 activation block
constexpr int TC_CONSUMER_WARPS = 8;                   // arrivals that free a stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, k) in a 64-row activation tile.
__device__ __forceinline__ uint32_t sw128(int r, int k) {
  return (k >> 6) * TC_BLOCK_BYTES + r * 128 + ((((k >> 3) & 7) ^ (r & 7)) << 4) + ((k & 7) << 1);
}

__device__ __forceinline__ float ld_bf16(const uint8_t* tile, int r, int k) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(tile + sw128(r, k)));
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart. Adding 2 advances the start by 32 bytes (K by 16).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

// Waits for the barrier's phase of the given parity to complete. Every wait
// of these kernels ends within microseconds; one that has not ended after
// 2^26 tries is a fault, and traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// One bulk async copy of `bytes` (a multiple of 16) from global memory into
// shared memory, counted against the barrier's expected transaction bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Barrier over one consumer warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;" :: "r"(id) : "memory");
}

// A copy of v the compiler cannot see through: the addresses an epilogue
// derives from it are computed where they are used, rather than shared by
// every inlined epilogue and kept live (spilled) across the kernel.
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}
template <class T>
__device__ __forceinline__ T* opaque(T* v) {
  asm volatile("" : "+l"(v));
  return v;
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" :: "r"(addr), "r"(v) : "memory");
}

// Generic-proxy writes to shared memory become visible to wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int M>
__device__ __forceinline__ void fence_acc(float (&a)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(a[i]) :: "memory");
}

// d (+)= A (64 x 16) @ B (16 x N), A and B in shared memory as their
// descriptors da and db say; scale_d = 0 starts the sum afresh.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256, "wgmma N of this core");
  if constexpr (N == 256) wgmma_m64n256k16(d, da, db, scale_d);
  else if constexpr (N == 192) wgmma_m64n192k16(d, da, db, scale_d);
  else if constexpr (N == 128) wgmma_m64n128k16(d, da, db, scale_d);
  else wgmma_m64n64k16(d, da, db, scale_d);
}

// The consumer side of a weight ring of STAGES stages, one copy per thread
// of a consumer warpgroup; both consumers walk the same stages in the same
// order.
template <int STAGES>
struct RingN {
  uint32_t full, empty, buf;  // shared addresses of full[0], empty[0], stage 0
  int stage;
  uint32_t phase;

  __device__ __forceinline__ uint32_t wait() {
    mbar_wait(full + 8 * stage, phase);
    return buf + stage * TC_STAGE_BYTES;
  }
  __device__ __forceinline__ void release(int st) {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * st);
  }
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
};
using Ring = RingN<TC_STAGES>;

// acc = [a0 | a1] @ W for the ring's next kc0 + kc1 chunks: a0 and a1 are
// shared addresses of 64-row tiles (kc0 and kc1 blocks of 64 columns).
// side(c) runs on the CUDA cores while chunk c's wgmmas run: work of the
// warpgroup that touches neither the accumulators nor what the layer's
// wgmmas read. Returns with every wgmma of the layer complete and its
// stages released.
template <int N, class Rg, class Side>
__device__ __forceinline__ void tc_layer(Rg& ring, float (&acc)[N / 2], uint32_t a0, int kc0,
                                         uint32_t a1, int kc1, Side side) {
  wgmma_fence();
  int prev = -1;
  for (int c = 0; c < kc0 + kc1; ++c) {
    const uint32_t a = c < kc0 ? a0 + c * TC_BLOCK_BYTES : a1 + (c - kc0) * TC_BLOCK_BYTES;
    const uint64_t da = sw128_desc(a), db = sw128_desc(ring.wait());
#pragma unroll
    for (int kk = 0; kk < TC_KC / 16; ++kk)
      wgmma_k16<N>(acc, da + 2 * kk, db + 2 * kk, c > 0 || kk > 0);
    wgmma_commit();
    side(c);
    if (prev >= 0) {
      wgmma_wait<1>();
      ring.release(prev);
    }
    prev = ring.stage;
    ring.advance();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  ring.release(prev);
}

template <int N, class Rg>
__device__ __forceinline__ void tc_layer(Rg& ring, float (&acc)[N / 2], uint32_t a0, int kc0,
                                         uint32_t a1, int kc1) {
  tc_layer<N>(ring, acc, a0, kc0, a1, kc1, [](int) {});
}

// Accumulator element e of this thread: row and column in the 64 x N tile.
// Thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and
// columns 8 j + 2 (t % 4) (+ 1) for j < N / 8.

// out (a 64-row bf16 tile) = round_bf16(relu?(acc + bias)).
template <int N>
__device__ __forceinline__ void tc_store_bf16(const float (&acc)[N / 2], const float* bias,
                                              bool relu, uint8_t* out) {
  const int t = threadIdx.x & 127, l = t & 31;
  const int r0 = (t >> 5) * 16 + (l >> 2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = j * 8 + 2 * (l & 3);
    const float2 b = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v0 = acc[j * 4 + 2 * i] + b.x, v1 = acc[j * 4 + 2 * i + 1] + b.y;
      if (relu) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
      *reinterpret_cast<__nv_bfloat162*>(out + sw128(r0 + 8 * i, c)) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// out (64 x 128 fp32, row-major) = acc + bias: the oracle's raw logits.
__device__ __forceinline__ void tc_store_f32(const float (&acc)[64], const float* bias, float* out) {
  const int t = threadIdx.x & 127, l = t & 31;
  const int r0 = (t >> 5) * 16 + (l >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = j * 8 + 2 * (l & 3);
    const float2 b = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(out + (r0 + 8 * i) * 128 + c) =
          make_float2(acc[j * 4 + 2 * i] + b.x, acc[j * 4 + 2 * i + 1] + b.y);
  }
}

}  // namespace
