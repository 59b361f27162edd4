"""What paces the wide path's layer GEMM (``csrc/wide.cu``'s ``wd_gemm``) on one
NVIDIA card: the kernel as it is against copies of it with one part taken
out, built side by side and timed in turns.

  python adanerf_tpu_torch/gemm_ablation.py [--rounds N]

Each variant is ``csrc/wide.cu`` with a few lines replaced (``VARIANTS``),
built with the package's nvcc flags into ``adanerf_tpu_torch/_build/ablation``
(its ptxas registers and spills printed), and timed by
``frame_times.gemm_times`` at its shapes with ``wide.build.load`` pointed at
the variant's library; the variants run in turns, ``--rounds`` times. A
variant without its wgmmas or its stores computes nothing useful: only its
time is read. The last line is one JSON object with every number. Exits
non-zero where there is no CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") !=
                   os.path.dirname(os.path.abspath(__file__))]
    sys.path.insert(0, HERE)

import torch  # noqa: E402

_WGMMA = ("      wgmma_k16<NT>(acc[0], da0 + 2 * kk, db + 2 * kk, {0});\n"
          "      wgmma_k16<NT>(acc[1], da1 + 2 * kk, db + 2 * kk, {0});\n")
# name: [(text of csrc/wide.cu, its replacement)]
VARIANTS = {
    "as is": [],
    # the copies, the barriers and the epilogue, no tensor-core work
    "no wgmma": [(_WGMMA.format("kk > 0"), ""), (_WGMMA.format("1"), "")],
    # no staged bf16 stores (out, st) and no bulk stores
    "no stores": [("  if (G.out != nullptr || G.st != nullptr) {\n    // 64 x 64 at a time",
                   "  if (false) {\n    // 64 x 64 at a time")],
    # a producer warpgroup that hands its registers to the consumers
    "setmaxnreg": [
        ("constexpr int WD_THREADS = 288;", "constexpr int WD_THREADS = 384;"),
        ("  if (g == 2) {  // the producer warp\n",
         "  if (g == 2) {  // the producer warp\n"
         "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 40;\" ::: \"memory\");\n"),
        ("  // the block's k-th tile is consumer k % 2's;",
         "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 232;\" ::: \"memory\");\n"
         "  // the block's k-th tile is consumer k % 2's;")],
    # 2-block clusters, each block loading half of the B chunk into both
    # (cp.async.bulk .multicast::cluster), stages freed by both blocks' consumers
    "cluster multicast": [
        ('// Rows a launch covers',
         '__device__ __forceinline__ uint32_t cluster_rank() {\n  uint32_t r;\n  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));\n  return r;\n}\n\n__device__ __forceinline__ void cluster_sync() {\n  asm volatile("barrier.cluster.arrive.release.aligned;\\n"\n               "barrier.cluster.wait.acquire.aligned;" ::: "memory");\n}\n\n// Arrive on the barrier at the same shared offset in the other block of\n// the pair.\n__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar, uint32_t peer) {\n  uint32_t remote;\n  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(bar), "r"(peer));\n  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" :: "r"(remote)\n               : "memory");\n}\n\n// A bulk copy into both blocks of the pair at the same shared offset, each\n// block\'s barrier at bar counting its bytes.\n__device__ __forceinline__ void bulk_copy_pair(uint32_t dst, const void* src, uint32_t bytes,\n                                               uint32_t bar) {\n  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"\n               ".multicast::cluster [%0], [%1], %2, [%3], %4;"\n               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"((unsigned short)3) : "memory");\n}\n\n// Rows a launch covers'),
        ('__device__ __forceinline__ void wd_tile(const WdGemm& G, int g, int k, int M, int nct) {\n  extern __shared__ float4 smem4[];\n  constexpr int NT = WD_TN;\n  const int t = blockIdx.x + k * gridDim.x, bt = t / nct, col0 = (t - bt * nct) * WD_TN;',
         "__device__ __forceinline__ void wd_tile(const WdGemm& G, int g, int k, int M, int nct) {\n  extern __shared__ float4 smem4[];\n  constexpr int NT = WD_TN;\n  const uint32_t rank = cluster_rank();\n  const int t = (blockIdx.x >> 1) + k * (gridDim.x >> 1), bt2 = t / nct;\n  const int bt = 2 * bt2 + rank, col0 = (t - bt2 * nct) * WD_TN;\n  const bool real = bt * WD_TM < M;  // the pair's second tile may lie past the rows"),
        ('    wgmma_commit();\n    wgmma_wait<1>();\n    if (lane == 0) mbar_arrive(eb + 8 * prev);',
         '    wgmma_commit();\n    wgmma_wait<1>();\n    if (lane == 0) {\n      mbar_arrive(eb + 8 * prev);\n      mbar_arrive_peer(eb + 8 * prev, rank ^ 1);\n    }'),
        ('  fence_acc(acc[1]);\n  if (lane == 0) mbar_arrive(eb + 8 * prev);',
         '  fence_acc(acc[1]);\n  if (lane == 0) {\n    mbar_arrive(eb + 8 * prev);\n    mbar_arrive_peer(eb + 8 * prev, rank ^ 1);\n  }'),
        ("  if (G.bp != nullptr) {  // column sums of the tile's 128 rows, 16-row group by group",
         "  if (G.bp != nullptr && real) {  // column sums of the tile's 128 rows, 16-row group by group"),
        ('  if (G.f32 != nullptr) {  // row-major, columns < f32_cols, rows < M',
         '  if (G.f32 != nullptr && real) {  // row-major, columns < f32_cols, rows < M'),
        ('  if (G.out != nullptr || G.st != nullptr) {\n    // 64 x 64 at a time',
         '  if ((G.out != nullptr || G.st != nullptr) && real) {\n    // 64 x 64 at a time'),
        ('__global__ void __launch_bounds__(WD_THREADS, 1) wd_gemm(const WdGemm G) {',
         '__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(WD_THREADS, 1) wd_gemm(const WdGemm G) {'),
        ('  const int nct = (G.n + WD_TN - 1) / WD_TN, tiles = (M + WD_TM - 1) / WD_TM * nct;',
         '  const int nct = (G.n + WD_TN - 1) / WD_TN, tiles = (M + 2 * WD_TM - 1) / (2 * WD_TM) * nct;'),
        ('      mbar_init(eb + 8 * i, 4);  // the warps of the warpgroup that read the stage',
         "      mbar_init(eb + 8 * i, 8);  // the warps of both blocks' warpgroups that read the stage"),
        ('    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");\n  }\n  __syncthreads();',
         '    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");\n  }\n  cluster_sync();  // both blocks\' barriers are set up before either copies into the other'),
        ('  if (g == 2) {  // the producer warp\n    if (threadIdx.x == 2 * 128) {\n      int stage = 0;\n      uint32_t phase = 0;\n      for (int t = blockIdx.x, k = 0; t < tiles; t += gridDim.x, ++k) {\n        const int bt = t / nct, col0 = (t - bt * nct) * WD_TN, c0 = col0 & ~255;',
         "  const uint32_t rank = cluster_rank();\n  const int rt_all = (M + WD_TM - 1) / WD_TM;\n  if (g == 2) {  // the producer warp\n    if (threadIdx.x == 2 * 128) {\n      int stage = 0;\n      uint32_t phase = 0;\n      for (int t = blockIdx.x >> 1, k = 0; t < tiles; t += gridDim.x >> 1, ++k) {\n        const int bt2 = t / nct, col0 = (t - bt2 * nct) * WD_TN, c0 = col0 & ~255;\n        // the pair's second tile past the rows loads the first's (its\n        // results are dropped)\n        const int bt = 2 * bt2 + rank < rt_all ? 2 * bt2 + rank : 2 * bt2;"),
        ('          mbar_expect(bar, 2 * WD_A_BYTES + nt * TC_KC * 2);\n          bulk_copy(dst, a, WD_A_BYTES, bar);\n          bulk_copy(dst + WD_A_BYTES, a + (size_t)kb * 4096, WD_A_BYTES, bar);\n          bulk_copy(dst + 2 * WD_A_BYTES, wp + (size_t)c * np * TC_KC, nt * TC_KC * 2, bar);',
         "          mbar_expect(bar, 2 * WD_A_BYTES + nt * TC_KC * 2);\n          bulk_copy(dst, a, WD_A_BYTES, bar);\n          bulk_copy(dst + WD_A_BYTES, a + (size_t)kb * 4096, WD_A_BYTES, bar);\n          // this block's half of the B rows, into both blocks\n          if (64 * rank < nt)\n            bulk_copy_pair(dst + 2 * WD_A_BYTES + rank * 64 * 128,\n                           wp + (size_t)c * np * TC_KC + rank * 64 * TC_KC, 64 * 128, bar);"),
        ("    return;\n  }\n  // the block's k-th tile is consumer k % 2's; its chunks sit at ring",
         "  } else {\n  // the block's k-th tile is consumer k % 2's; its chunks sit at ring"),
        ('  for (int k = g; blockIdx.x + k * gridDim.x < tiles; k += 2) wd_tile(G, g, k, M, nct);\n  if ((threadIdx.x & 127) == 0) bulk_wait_all();  // the stores are out before the block ends\n}',
         "  for (int k = g; (int)(blockIdx.x >> 1) + k * (int)(gridDim.x >> 1) < tiles; k += 2)\n    wd_tile(G, g, k, M, nct);\n  if ((threadIdx.x & 127) == 0) bulk_wait_all();  // the stores are out before the block ends\n  }\n  cluster_sync();  // the other block's last arrivals on this block's barriers are in\n}"),
        ('  const long long tiles = (long long)((G->rows + WD_TM - 1) / WD_TM) * ((G->n + WD_TN - 1) / WD_TN);\n  if (tiles == 0) return 0;\n  wd_gemm<<<tiles < sms ? (int)tiles : sms, WD_THREADS, WD_SMEM, as_stream(stream)>>>(*G);',
         '  const long long tiles = (long long)((G->rows + 2 * WD_TM - 1) / (2 * WD_TM)) * ((G->n + WD_TN - 1) / WD_TN);\n  if (tiles == 0) return 0;\n  const int pairs = sms / 2;\n  wd_gemm<<<2 * (tiles < pairs ? (int)tiles : pairs), WD_THREADS, WD_SMEM, as_stream(stream)>>>(*G);'),
    ],
}


def build_variants(names):
    """{name: (loaded library, ptxas lines of wd_gemm)}, built in parallel."""
    from adanerf_tpu_torch.ops.kernels import build
    source = open(os.path.join(build.CSRC_DIR, "wide.cu")).read()
    nvcc, procs = build.find_nvcc(), {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: csrc/wide.cu no longer holds {old!r}")
            text = text.replace(old, new)
        d = os.path.join(build.BUILD_DIR, "ablation", name.replace(" ", "_"))
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f in os.listdir(build.CSRC_DIR):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(build.CSRC_DIR, f), d)
        with open(os.path.join(d, "wide.cu"), "w") as f:
            f.write(text)
        out = os.path.join(d, "wide.so")
        procs[name] = (out, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", d, "-o", out, os.path.join(d, "wide.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        lines = log.splitlines()
        info = [lines[i + 2].strip() + "; " + lines[i + 3].split(":", 1)[-1].strip()
                for i, line in enumerate(lines[:-3])
                if "Compiling entry function" in line and "7wd_gemmE" in line]
        info += [line.split("Potential Performance Loss:")[1].strip()
                 for line in lines if "Potential Performance Loss" in line and "7wd_gemmE" in line]
        libs[name] = (ctypes.CDLL(out), info)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2, help="turns over the variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_ablation: no CUDA device", file=sys.stderr)
        return 2
    from adanerf_tpu_torch import frame_times
    from adanerf_tpu_torch.ops.kernels import wide
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    libs = build_variants(list(VARIANTS))
    out = {"card": card, "ptxas": {n: info for n, (_, info) in libs.items()}, "times": {}}
    for name, (_, info) in libs.items():
        print(f"{name}: wd_gemm {'; '.join(info)}", flush=True)
    dev = torch.device("cuda")
    for r in range(args.rounds):
        for name, (lib, _) in libs.items():
            wide.build.load = lambda source, lib=lib: lib
            print(f"-- {name}, round {r + 1}", flush=True)
            t = frame_times.gemm_times(dev)
            out["times"].setdefault(name, []).append({k: v["ms"] for k, v in t.items()})
    print(f"card after: {frame_times.card_state()}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
