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
// The kernels live in megakernel.cuh, shared with K2 (megakernel_dense.cu),
// and are instantiated here with DENSE = false. Three launches on the
// caller's stream, no host synchronisation:
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
