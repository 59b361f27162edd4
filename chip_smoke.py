#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (adanerf_tpu_torch) on one NVIDIA card.

  python3 chip_smoke.py

Builds the CUDA kernels from the checkout, holds each against its plain
PyTorch version on the card, drives the port's main path (the viewer
rendering a trained export through the kernel) and prints, as its last two
lines, a JSON line of per-kernel numbers and a JSON line
``{"ok": true, "device": {...}}``. Exits non-zero, without those lines, when
there is no CUDA device or any phase fails. Imports torch, numpy and the
standard library besides the port itself.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MSCENE = os.path.join(ROOT, "demo", "trained_mscene_export")
NDC = os.path.join(ROOT, "demo", "trained_ndc_export")

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and the bf16
# tensor-core and fp32 FMA operation rates
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}

T0 = time.perf_counter()


def phase(name):
    print(f"[{time.perf_counter() - T0:7.1f}s] phase {name}", flush=True)


def done(name, t):
    print(f"[{time.perf_counter() - T0:7.1f}s] phase {name} ok ({time.perf_counter() - t:.1f}s)",
          flush=True)


def psnr(a, b):
    mse = torch.mean((a.clamp(0, 1) - b.clamp(0, 1)) ** 2).item()
    return float("inf") if mse == 0 else -10.0 * math.log10(mse)


def check_fp32(mk, rt, dirs, pose, rot, label):
    """K1 vs its plain version in fp32: at most 1 ray in 10,000 may differ
    in count (a logit within rounding of the threshold flips a bin when the
    two sides sum the oracle's products in different orders), and rgb must
    agree within 2e-4 on the rays whose counts agree."""
    rgb_k, cnt_k = mk(dirs, pose, rot)
    torch.cuda.synchronize()
    rgb_p, cnt_p = mk.plain(dirs, torch.as_tensor(pose, dtype=torch.float32, device=dirs.device),
                            torch.as_tensor(rot, dtype=torch.float32, device=dirs.device))
    agree = cnt_k == cnt_p
    n_bad = int((~agree).sum())
    err = float((rgb_k - rgb_p).abs()[agree].max())
    n = dirs.shape[0]
    print(f"  {label}: {n} rays, count mismatches {n_bad} (allowed {n // 10000}), "
          f"rgb max abs err {err:.3e} (allowed 2e-4), samples/px {float(cnt_k.float().mean()):.3f}",
          flush=True)
    if n_bad > n // 10000 or not err <= 2e-4:
        raise SystemExit(f"{label}: kernel disagrees with its plain version")
    return err, n_bad


def time_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from adanerf_tpu_torch import viewer
    from adanerf_tpu_torch.ops.kernels import build
    from adanerf_tpu_torch.ops.kernels.megakernel_compact import SOURCE, MegakernelCompact

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t = time.perf_counter()
    phase("1 device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}", flush=True)
    done("1 device", t)

    t = time.perf_counter()
    phase("2 build")
    logs = build.build([SOURCE])
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}", flush=True)
    print(f"  built {len(logs)} source(s) in {time.perf_counter() - t:.1f}s", flush=True)
    done("2 build", t)

    t = time.perf_counter()
    phase("3 fp32 check, trained_mscene_export, 400x400 frame")
    rt32, scene = viewer.build_renderer_from_export(MSCENE, dtype_str="fp32", device=dev)
    mk32 = MegakernelCompact(rt32)
    rot = np.eye(3, dtype=np.float32)
    pose = viewer.orbit_poses(scene.view_cell_center, 0.4 * scene.view_cell_radius, 8)[1]
    dirs400 = viewer.frame_directions(scene, 400, 400, dev)
    err32, _ = check_fp32(mk32, rt32, dirs400, pose, rot, "mscene fp32")
    done("3", t)

    t = time.perf_counter()
    phase("4 fp32 check, trained_ndc_export (S=16, NDC), 16,384 rays")
    rtn, scn = viewer.build_renderer_from_export(NDC, dtype_str="fp32", device=dev)
    posen = viewer.orbit_poses(scn.view_cell_center, 0.4 * scn.view_cell_radius, 8)[3]
    check_fp32(MegakernelCompact(rtn), rtn, viewer.frame_directions(scn, 128, 128, dev),
               posen, rot, "ndc fp32")
    done("4", t)

    t = time.perf_counter()
    phase("5 bf16 check, trained_mscene_export: K1 bf16 vs plain fp32, >= 40 dB")
    rt16, _ = viewer.build_renderer_from_export(MSCENE, dtype_str="bf16", device=dev)
    mk16 = MegakernelCompact(rt16)
    rgb16, _ = mk16(dirs400, pose, rot)
    rgb32, _ = mk32.plain(dirs400, torch.as_tensor(pose, dtype=torch.float32, device=dev),
                          torch.eye(3, device=dev))
    p16 = psnr(rgb16, rgb32)
    print(f"  K1 bf16 vs plain fp32: {p16:.2f} dB", flush=True)
    if not p16 >= 40.0:
        raise SystemExit("bf16 kernel below 40 dB against fp32")
    done("5", t)

    t = time.perf_counter()
    phase("6 main path: viewer, trained_mscene_export, 800x800, 20 frames, bf16")
    MegakernelCompact.launches = 0
    stats = viewer.main([MSCENE, "-s", "800", "800", "-n", "20", "--logging_interval", "10"])
    launches = MegakernelCompact.launches
    print(f"  main path: megakernel_compact launches {launches}", flush=True)
    if launches < 1:
        raise SystemExit("the main path never launched megakernel_compact")
    done("6", t)

    t = time.perf_counter()
    phase("7 kernel vs plain at the main path's shape (800x800, bf16): time and agreement")
    dirs800 = viewer.frame_directions(scene, 800, 800, dev)
    pose_t = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    rot_t = torch.eye(3, device=dev)
    rgb_k, cnt_k = mk16(dirs800, pose, rot)
    rgb_p, cnt_p = mk16.plain(dirs800, pose_t, rot_t)
    agree = cnt_k == cnt_p
    n_bad = int((~agree).sum())
    err16 = float((rgb_k - rgb_p).abs()[agree].max())
    p_main = psnr(rgb_k, rgb_p)
    # bf16 rounds activations at the same points on both sides, but a sum
    # that lands on the other side of a bf16 rounding boundary moves a value
    # by 2^-8 relative; hold the frame to the same 40 dB bar as phase 5
    print(f"  K1 bf16 vs plain bf16: {p_main:.2f} dB, count mismatches {n_bad} of "
          f"{dirs800.shape[0]}, rgb max abs err on agreeing rays {err16:.3e}", flush=True)
    if not p_main >= 40.0:
        raise SystemExit("bf16 kernel below 40 dB against its plain version")
    ms_k = time_ms(lambda: mk16(dirs800, pose, rot), 10)
    ms_p = time_ms(lambda: mk16.plain(dirs800, pose_t, rot_t), 3)
    ms_front = time_ms(lambda: mk16(dirs800, pose, rot, stages=1), 5)
    ms_shade = time_ms(lambda: mk16(dirs800, pose, rot, stages=2), 5)
    n_pix = dirs800.shape[0]
    n_samp = int(cnt_k.sum())
    oracle, nerf = rt16.oracle, rt16.nerf
    ops = 2.0 * (n_pix * oracle.macs_per_input() + n_samp * nerf.macs_per_input())
    wbytes = mk16.weights.numel() * mk16.weights.element_size() + mk16.biases.numel() * 4
    nbytes = n_pix * 12 + 12 + 36 + wbytes + n_pix * (12 + 4)
    bound_ops = ops / PEAK_OPS["bf16"] * 1e3
    bound_bytes = nbytes / HBM_BPS * 1e3
    bound = max(bound_ops, bound_bytes)
    print(f"  K1 {ms_k:.3f} ms/frame ({n_pix / ms_k / 1e3:.2f} Mrays/s; front {ms_front:.3f} ms, "
          f"front+shade {ms_shade:.3f} ms), plain {ms_p:.3f} ms/frame, "
          f"samples/px {n_samp / n_pix:.4f}", flush=True)
    print(f"  bound: {ops / 1e12:.4f} TFLOP over {PEAK_OPS['bf16'] / 1e12:.0f} TFLOP/s bf16 = "
          f"{bound_ops:.3f} ms; {nbytes / 1e6:.2f} MB over 3.35 TB/s = {bound_bytes:.4f} ms; "
          f"K1 at {100 * bound / ms_k:.2f}% of bound; fp32 FMA bound "
          f"{ops / PEAK_OPS['fp32'] * 1e3:.3f} ms", flush=True)
    done("7", t)

    phase("8 kernels")
    print(json.dumps({"kernels": [{
        "name": "megakernel_compact", "route": "cuda",
        "source": "adanerf_tpu_torch/csrc/megakernel_compact.cu",
        "replaces": "adanerf_tpu/ops/pallas/megakernel3.py:209",
        "launches": launches, "max_abs_err": err16, "fp32_max_abs_err": err32,
        "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound,
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": None,
        "viewer_device_ms": stats["device_ms_per_frame"],
        "viewer_device_ms_median": stats["device_ms_median"],
        "samples_per_pixel": n_samp / n_pix}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
