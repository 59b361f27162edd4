// Compacted adaptive frame renderer for Hopper (sm_90a).
//
// Replaces adanerf_tpu/ops/pallas/megakernel3.py::make_megakernel_compact,
// the fused Pallas kernel of the real-time renderer: ray setup -> oracle MLP
// -> adaptive select -> compacted NeRF shading of the live samples only ->
// front-to-back composite. The plain PyTorch version it is held against is
// adanerf_tpu_torch/realtime.py (through ops/kernels/megakernel_compact.py).
//
// What bounds it: arithmetic. One ray costs
// 449,024 multiply-adds in the 8x256 oracle and each live sample 593,408 in
// the 8x256 NeRF; an 800x800 frame at ~1.3 samples per pixel is ~1.54 TFLOP
// (1.553 ms at the bf16 tensor-core peak of 989 TFLOP/s), against ~2 MB of
// bf16 weights and under 20 MB of frame input and output. Every activation
// therefore stays on chip, and the weights are streamed from L2 into shared
// memory for each tile of rows.
//
// bf16 (the viewer's precision) runs on the tensor cores (mk_front_tc,
// mk_shade_tc; mlp_wgmma.cuh): a persistent block of one producer and two
// consumer warpgroups walks 128-row tiles. Each consumer owns 64 rows, the
// wgmma M, and runs every layer as m64n256k16 (m64n128k16 for the oracle's
// logits and the views layer) wgmma on bf16 operands in shared memory with
// fp32 accumulators in registers; the producer brings the layer's weights
// in 64-row chunks (32 KB at N = 256) by bulk async copy into a 3-stage ring
// guarded by mbarriers, so loads overlap the multiplies. Both consumers read
// each staged chunk, so a tile of 128 rows reads each weight byte from L2
// once: 0.918 MB for the oracle and 1.278 MB for the NeRF per tile, 4.59 GB
// + 8.08 GB reckoned for an 800x800 frame at 0.2. The shade then runs at
// about a third of the tensor-core peak; whether that traffic, the chain of
// wgmma groups before each epilogue or the per-row work sets its pace is
// not measured (PERF.md section 5). A 2-block cluster multicasting each
// chunk halves the traffic but was slower: it ties four warpgroups to one
// ring, so the slowest paces all.
//
// fp32 weights run the FMA kernels (mk_front, mk_shade; mlp_tile.cuh): a
// block owns a 64-row tile, holds the encoded input and two 64x256 fp32
// activation buffers in shared memory and streams each layer's weights
// through shared memory in 32-row chunks; each thread accumulates an 8-row
// x 8-column register tile with fp32 FMAs. They are the exact reference.
//
// Widths: the numbers above are the 8x256 MLPs of the shipped configs. The
// library is built once per MLP width (MLP_WIDTH: 128 or 256; the views
// layer half of it); the front runs in the library of the oracle's width
// and the shade in the NeRF's (MkParams::from_stage, stages), and an MLP
// of any other width takes the wide path (wide.cu) for its half (at 384
// and 512 it measured faster than two wgmma passes a layer here).
//
// The kernels live in megakernel.cuh, shared with K2 (megakernel_dense.cu),
// and are instantiated here with DENSE = false. Three launches on the
// caller's stream, no host synchronisation:
//   (a) front:        ray setup, oracle encode + MLP, select, per-ray
//                     (count, z, p); reserves compact row offsets with one
//                     atomicAdd per 64 rays (bf16: per consumer warpgroup).
//   (b) shade:        persistent blocks walk the compact rows (the live count
//                     is read on the device): normalize, encode, NeRF MLP,
//                     raw rgba written back by (ray, slot).
//   (c) mk_composite: one thread per ray.
//
// Precision: geometry and the positional encode stay in full fp32 (sinf /
// cosf, no fast-math); the top encode band multiplies coordinates by 512.
// Weights come in fp32 or bf16; accumulation is fp32 either way, and in
// bf16 mode every matmul's activation input is rounded to bf16 (round to
// nearest even), matching the plain version's bf16 emulation.

#include "megakernel.cuh"

extern "C" int mk_compact_launch(int device, const MkParams* P, const float* dirs, const float* pose,
                                 const float* rot, const void* wts, const float* bias,
                                 float* o_sh, float* d_sh, float* zbuf, float* pbuf,
                                 int* counts, int* rows, int* counter, float* raw,
                                 float* rgb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = P->bf16
      ? launch_all<__nv_bfloat16, false>(*P, dirs, pose, rot, wts, bias, o_sh, d_sh, zbuf, pbuf,
                                  counts, rows, counter, raw, rgb, s)
      : launch_all<float, false>(*P, dirs, pose, rot, wts, bias, o_sh, d_sh, zbuf, pbuf, counts,
                          rows, counter, raw, rgb, s);
  return static_cast<int>(e);
}

extern "C" int mk_struct_size() { return static_cast<int>(sizeof(MkParams)); }

// The MLP width this library is built for (MLP_WIDTH).
extern "C" int mk_width() { return W; }

// Dynamic shared memory a block of the fp32 (bf16 = 0) or bf16 kernels takes.
extern "C" int mk_smem_bytes(int bf16) {
  return static_cast<int>(bf16 ? TC_SMEM_BYTES : SMEM_BYTES);
}
