// Dense-slot adaptive frame renderer for Hopper (sm_90a).
//
// Replaces adanerf_tpu/ops/pallas/megakernel.py::make_megakernel, the fused
// Pallas kernel that shades every one of a ray's S sample slots: ray setup
// -> oracle MLP -> adaptive select -> NeRF shading of all B*S slots, dead
// slots included -> front-to-back composite with the dead slots masked
// (alpha times live). The plain PyTorch version it is held against is
// RealtimeRenderer._dense_shade_stage in adanerf_tpu_torch/realtime.py
// (through ops/kernels/megakernel_dense.py).
//
// What bounds it: arithmetic, and unlike K1 the work does not depend on
// the oracle's threshold. An 800x800 frame at S = 8 is 640,000 oracle rows
// of 449,024 multiply-adds and 5,120,000 NeRF rows of 593,408, ~6.65 TFLOP
// (6.7 ms at the bf16 tensor-core peak), though the function needs the NeRF
// at the live samples only (a dead slot adds exact zeros). In bf16 the
// MLPs run on the tensor cores (megakernel_compact.cu's note, mlp_wgmma.cuh):
// 128-row tiles, each reading the NeRF's 1.278 MB of weight chunks from L2
// once, 51.1 GB (reckoned) for the 40,000 shade tiles of a frame. The shade
// runs at about a third of the tensor-core peak; which of that L2 traffic,
// the chain of wgmma groups and the per-tile encode and epilogues sets its
// pace is not measured (PERF.md section 5). What the design does about
// them: two consumer warpgroups share every
// staged chunk, a 3-stage ring of bulk copies overlaps the loads with the
// multiplies, and activations never leave shared memory.
//
// The kernels are K1's (megakernel.cuh), instantiated with DENSE = true:
//   (a) front:        K1's front half, step for step (rotate, sphere exit,
//                     fp32 nerf encode, oracle MLP, select with ties to the
//                     lower bin and the argmax fallback, slots front to
//                     back); dead slots get bin 0's depth and p 0, and no
//                     compact rows are reserved.
//   (b) shade:        persistent blocks walk the B*S (ray, slot) rows in
//                     tiles: InverseSqrtDistCentered, [pos | dir] encode,
//                     the NeRF MLP.
//   (c) mk_composite: one thread per ray over all S slots; a dead slot's
//                     alpha is multiplied by 0, so it adds exact zeros and
//                     multiplies the transmittance by 1 + 1e-10 == 1 in fp32.
// Live slots are computed by the same instructions as in K1, and each row
// of a layer depends on its own inputs and the weights only, so K2 and K1
// give bit-identical frames in either precision.
//
// Precision: as K1 (full fp32 geometry and encode; fp32 or bf16 weights,
// fp32 accumulation, bf16-rounded activations in bf16 mode).

#include "megakernel.cuh"

extern "C" int mk_dense_launch(int device, const MkParams* P, const float* dirs, const float* pose,
                               const float* rot, const void* wts, const float* bias,
                               float* o_sh, float* d_sh, float* zbuf, float* pbuf,
                               int* counts, int* rows, int* counter, float* raw,
                               float* rgb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = P->bf16
      ? launch_all<__nv_bfloat16, true>(*P, dirs, pose, rot, wts, bias, o_sh, d_sh, zbuf, pbuf,
                                        counts, rows, counter, raw, rgb, s)
      : launch_all<float, true>(*P, dirs, pose, rot, wts, bias, o_sh, d_sh, zbuf, pbuf, counts,
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
