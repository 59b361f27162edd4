#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (adanerf_tpu_torch) on one NVIDIA card.

  python3 chip_smoke.py

Builds the CUDA kernels from the checkout (printing each kernel's
registers, spills, shared memory and HGMMA count), holds each against its
plain PyTorch version on the card (K3's backward also against itself: two
calls must agree bit for bit), drives the port's three paths (the viewer
rendering a trained export through K1, the dense trainer taking a few
steps through K3, and the viewer's ``--megakernel v3`` rendering through
K2), checks and times K1 in bf16 on the S=16 NDC export at
800x800, and prints, as its last two lines, a JSON line of per-kernel
numbers and a JSON line ``{"ok": true, "device": {...}}``. Exits
non-zero, without those lines, when there is no CUDA device or any phase
fails. Imports torch, numpy and the standard library besides the port
itself.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MSCENE = os.path.join(ROOT, "demo", "trained_mscene_export")
NDC = os.path.join(ROOT, "demo", "trained_ndc_export")
MSCENE_DATA = os.path.join(ROOT, "demo", "mscene")
DENSE_INI = os.path.join(ROOT, "configs", "dense_training.ini")
K3_ROWS = 2 * 2048 * 128  # batchImages x samples x numRaymarchSamples of the dense config
TRAIN_WARMUP, TRAIN_TIMED = 3, 30

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and the bf16
# tensor-core and fp32 FMA operation rates
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}

K2_THRESHOLDS = (None, 0.01, 1e-4)  # the export's own 0.2; lower keeps more slots; at cap

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


NEAR = 1e-5  # a logit this close to the threshold or to the S-th largest may flip a bin


def float64_frame(rt, o_sh, d_sh, z, p, mask, chunk=20000):
    """(B, 3) float64: the renderer's dense shading and composite of the
    given slots (shading rays (B, 3); depths, oracle values and live mask
    (B, S)), with the encoding, the NeRF and the composite in float64."""
    rt64 = copy.copy(rt)
    rt64.nerf, rt64.dtype = copy.deepcopy(rt.nerf).double(), None
    rt64.center = rt.center.double()
    with torch.no_grad():
        return torch.cat([rt64._dense_shade_stage(
            o_sh[s:s + chunk].double(), d_sh[s:s + chunk].double(), z[s:s + chunk].double(),
            p[s:s + chunk].double(), mask[s:s + chunk]) for s in range(0, z.shape[0], chunk)])


def kept_bins(rt, z, mask):
    """(B, D) bool: the oracle bins whose depths fill a ray's live slots."""
    D = rt.oracle.n_out
    table = rt._to_world((torch.arange(D, device=z.device, dtype=torch.float32) + 0.5) / D)
    b = (z[..., None] - table).abs().argmin(dim=-1)
    keep = torch.zeros((z.shape[0], D + 1), dtype=torch.bool, device=z.device)
    return keep.scatter_(1, torch.where(mask, b, D), True)[:, :D]


def check_dense(k2, k1, dirs, pose, rot, label, hold_plain):
    """K2 in fp32 against K1 on the same rays (counts exact, rgb within
    1.5e-7, the bar tests/test_megakernel3.py holds the JAX kernels to each
    other: K2's live slots run K1's instructions, and a dead slot adds exact
    zeros and multiplies the transmittance by 1 - 0 + 1e-10 == 1 in fp32),
    against a float64 shading of its own slots (within 2e-4 on every ray)
    and against its plain version: counts exact and rgb within 2e-4 on every
    ray where hold_plain; else on every ray but at most 1 in 10,000 (phase
    3's allowance), each of which must keep other bins than the plain
    version, all at a near tie: a logit within NEAR of the threshold or of
    the ray's S-th largest, where the two sides' summation orders of the
    oracle's products may keep another bin. Returns (max err vs plain, max
    err vs K1, samples/px, share of rays at cap)."""
    rgb2, cnt2 = k2(dirs, pose, rot)
    rgb1, cnt1 = k1(dirs, pose, rot)
    o2, d2, z2, p2, c2 = k2.front(dirs, pose, rot)
    torch.cuda.synchronize()
    rt, dev, S = k2.renderer, dirs.device, k2.params.S
    pose_t = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    rot_t = torch.as_tensor(rot, dtype=torch.float32, device=dev)
    rgb_p, cnt_p = k2.plain(dirs, pose_t, rot_t)
    with torch.no_grad():
        logits = rt.oracle_logits(pose_t, rot_t, dirs)[3]
        o_p, d_p, z_p, p_p, mask_p = rt._oracle_stage(pose_t, rot_t, dirs)
    live2 = torch.arange(S, device=dev)[None, :] < c2[:, None]
    # the float64 witness: each side's own slots shaded in float64
    err64_2 = float((rgb2.double() - float64_frame(rt, o2, d2, z2, p2, live2)).abs().max())
    err64_p = float((rgb_p.double() - float64_frame(rt, o_p, d_p, z_p, p_p, mask_p)).abs().max())
    bad_p, bad_1 = int((cnt2 != cnt_p).sum()), int((cnt2 != cnt1).sum())
    bad_front = int((c2 != cnt2).sum())
    per_ray = (rgb2 - rgb_p).abs().max(dim=1).values
    err_p, err_1 = float(per_ray.max()), float((rgb2 - rgb1).abs().max())
    kept2, keptp = kept_bins(rt, z2, live2), kept_bins(rt, z_p, mask_p)
    flipped = kept2 ^ keptp
    top = torch.topk(logits, S + 1, dim=1).values
    at_tie = ((logits - rt.threshold).abs() <= NEAR) | ((logits - top[:, S - 1:S]).abs() <= NEAR)
    beyond = torch.nonzero(per_ray > 2e-4).flatten().tolist()
    n_unexplained = 0
    for r in beyond:
        bins = torch.nonzero(flipped[r]).flatten()
        explained = len(bins) > 0 and bool(at_tie[r, bins].all())
        n_unexplained += not explained
        only2, onlyp = bins[kept2[r, bins]].tolist(), bins[keptp[r, bins]].tolist()
        print(f"    ray {r}: vs plain {float(per_ray[r]):.3e}; bins kept by K2 only {only2}, by "
              f"plain only {onlyp}, their logits {[f'{v:.9g}' for v in logits[r, bins].tolist()]}; "
              f"S-th and (S+1)-th largest {float(top[r, S - 1]):.9g}, {float(top[r, S]):.9g}; "
              f"near tie: {explained}", flush=True)
    n = dirs.shape[0]
    allowed = 0 if hold_plain else n // 10000
    spp = float(cnt2.float().mean())
    at_cap = float((cnt2 == S).float().mean())
    print(f"  {label}: {n} rays, samples/px {spp:.4f}, at cap {100 * at_cap:.2f}%; vs plain: "
          f"count mismatches {bad_p} (allowed 0), rgb max abs err {err_p:.3e}, rays beyond "
          f"2e-4 {len(beyond)} (allowed {allowed}, each keeping other bins at a near tie; "
          f"{n_unexplained} not); rays keeping other bins than plain "
          f"{int(flipped.any(1).sum())}; vs float64 of each side's own slots: K2 {err64_2:.3e} "
          f"(allowed 2e-4), plain fp32 {err64_p:.3e}; vs K1: count mismatches {bad_1} "
          f"(allowed 0), rgb max abs err {err_1:.3e} (allowed 1.5e-7)", flush=True)
    if bad_p or bad_1 or bad_front or not err_1 <= 1.5e-7 or not err64_2 <= 2e-4 \
            or n_unexplained or len(beyond) > allowed:
        raise SystemExit(f"{label}: K2 disagrees with its plain version, float64 or K1")
    return err_p, err_1, spp, at_cap


def encoded_samples(n_rays, seed, dev):
    """NeRF inputs as the dense train step makes them: 128 log-spaced depths
    along rays from inside the mscene view cell, InverseSqrtDistCentered,
    encoded 10-4; directions and origins from a numpy seed."""
    from adanerf_tpu_torch.ops.depth_transforms import LogTransform
    from adanerf_tpu_torch.ops.encoding import positional_encode
    from adanerf_tpu_torch.ops.normalization import get_normalization
    from adanerf_tpu_torch.ops.samplers import linspace_midpoints
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.array([0.0, 0.0, 3.0]) + rng.uniform(-0.6, 0.6, (n_rays, 3))
    z = LogTransform.to_world(linspace_midpoints(128).astype(np.float64), (0.1, 8.0))
    pos = torch.tensor(o[:, None, :] + d[:, None, :] * z[None, :, None], dtype=torch.float32,
                       device=dev)
    pos = get_normalization("InverseSqrtDistCentered")(
        pos, torch.tensor([0.0, 0.0, 3.0], device=dev), 8.0)
    dirs = torch.tensor(d, dtype=torch.float32, device=dev)[:, None, :].expand(pos.shape)
    return torch.cat([positional_encode(pos.reshape(-1, 3), 10),
                      positional_encode(dirs.reshape(-1, 3), 4)], dim=-1).contiguous()


def grad_errors(ref, got):
    """{name: (max |ref - got| / max |ref|, max |ref - got|)} over two
    {name: tensor} dicts."""
    out = {}
    for k, a in ref.items():
        diff = float((a - got[k]).abs().max())
        out[k] = (diff / (float(a.abs().max()) + 1e-12), diff)
    return out


def demangle(name):
    """A kernel's C++ name, by the toolkit's cu++filt where there is one."""
    from adanerf_tpu_torch.ops.kernels.build import find_nvcc
    tool = os.path.join(os.path.dirname(find_nvcc()), "cu++filt")
    if not os.path.isfile(tool):
        return name
    out = subprocess.run([tool, name], capture_output=True, text=True, timeout=60).stdout.strip()
    return out.replace("(anonymous namespace)::", "").split("(")[0] or name


def ptxas_report(log):
    """[(kernel, "N registers, ... spill ...")] from an nvcc -Xptxas -v log."""
    out, name, info = [], None, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            if name:
                out.append((name, "; ".join(info)))
            name, info = demangle(line.split("'")[1]), []
        elif name and ("spill" in line or "Used" in line):
            info.append(line.split(":", 1)[-1].strip())
    if name:
        out.append((name, "; ".join(info)))
    return out


def stage_report(label, n_rows_front, n_rows_shade, oracle, nerf, mk, ms_front, ms_shade):
    """Per-stage achieved TFLOP/s, and the L2 weight bytes the tensor-core
    design reckons (one walk of a weight stream per TC_ROWS_PER_WALK rows;
    printed, not measured, so not returned)."""
    from adanerf_tpu_torch.ops.kernels.megakernel_compact import TC_ROWS_PER_WALK, stream_bytes
    tiles_f = math.ceil(n_rows_front / TC_ROWS_PER_WALK)
    tiles_s = math.ceil(n_rows_shade / TC_ROWS_PER_WALK)
    l2_f = tiles_f * stream_bytes(mk.params, True)
    l2_s = tiles_s * stream_bytes(mk.params, False)
    ops_f = 2.0 * n_rows_front * oracle.macs_per_input()
    ops_s = 2.0 * n_rows_shade * nerf.macs_per_input()
    ms_s = ms_shade - ms_front
    # a shade shorter than the timing noise leaves its rates unresolved
    rate = (lambda x: f"{x / ms_s / 1e9:.1f}") if ms_s > 0 else (lambda x: "unresolved")
    print(f"  {label} stages: front {ms_front:.3f} ms, {ops_f / ms_front / 1e9:.1f} TFLOP/s, "
          f"reckoned L2 weight reads {l2_f / 1e9:.3f} GB ({tiles_f} walks); "
          f"shade {ms_s:.3f} ms ({n_rows_shade} rows), {rate(ops_s)} TFLOP/s, "
          f"reckoned L2 weight reads {l2_s / 1e9:.3f} GB ({tiles_s} walks)", flush=True)
    return dict(front_ms=ms_front, shade_ms=ms_s, front_tflops=ops_f / ms_front / 1e9,
                shade_tflops=ops_s / ms_s / 1e9 if ms_s > 0 else None)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from adanerf_tpu_torch import train, viewer
    from adanerf_tpu_torch.frame_times import card_state, frame_ms, time_ms
    from adanerf_tpu_torch.models.mlp import NeRFDef
    from adanerf_tpu_torch.ops.kernels import build
    from adanerf_tpu_torch.ops.kernels import nerf_train, nerf_train_check
    from adanerf_tpu_torch.data.png import read_png
    from adanerf_tpu_torch.ops.kernels import megakernel_dense, sass
    from adanerf_tpu_torch.ops.kernels.megakernel_compact import SOURCE, MegakernelCompact
    from adanerf_tpu_torch.ops.kernels.megakernel_dense import MegakernelDense
    from adanerf_tpu_torch.ops.kernels.nerf_train import NerfTrainKernel
    from adanerf_tpu_torch.utils.weights import load_export_weights

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
    print(f"  card: {card_state()}", flush=True)
    done("1 device", t)

    t = time.perf_counter()
    phase("2 build")
    sources = [SOURCE, nerf_train.SOURCE, megakernel_dense.SOURCE]
    logs = build.build(sources)
    print(f"  built {len(logs)} source(s) in {time.perf_counter() - t:.1f}s", flush=True)
    for src, log in logs.items():
        for name, info in ptxas_report(log):
            print(f"  {src}: {name}: {info}", flush=True)
    for src in (SOURCE, megakernel_dense.SOURCE):
        lib = build.library_path(src)
        smem = build.load(src).mk_smem_bytes
        print(f"  {src}: dynamic shared memory per block: fp32 kernels {smem(0)} B, "
              f"bf16 (tensor-core) kernels {smem(1)} B", flush=True)
        for name, instrs in sass.kernel_sass(lib).items():
            n_hgmma = sass.hgmma_count(instrs)
            print(f"  {src}: {demangle(name)}: {len(instrs)} SASS instructions, {n_hgmma} HGMMA",
                  flush=True)
            if "_tc" in name and n_hgmma == 0:
                raise SystemExit(f"{name} has no HGMMA instruction")
    # K3: every kernel but the reduce multiplies on the tensor cores
    for name, instrs in sass.kernel_sass(build.library_path(nerf_train.SOURCE)).items():
        n_hgmma = sass.hgmma_count(instrs)
        print(f"  {nerf_train.SOURCE}: {demangle(name)}: {len(instrs)} SASS instructions, "
              f"{n_hgmma} HGMMA", flush=True)
        if "k3_reduce" not in name and n_hgmma == 0:
            raise SystemExit(f"{name} has no HGMMA instruction")
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
    stats_view = viewer.main([MSCENE, "-s", "800", "800", "-n", "20", "--logging_interval", "10"])
    launches = MegakernelCompact.launches
    print(f"  main path: megakernel_compact launches {launches}", flush=True)
    if launches < 1:
        raise SystemExit("the main path never launched megakernel_compact")
    print(f"  card: {card_state()}", flush=True)
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
    fr = frame_ms(mk16, dirs800, pose, rot)
    ms_k, ms_front, ms_shade = fr["ms"], fr["front_ms"], fr["front_shade_ms"]
    ms_p = time_ms(lambda: mk16.plain(dirs800, pose_t, rot_t), 3)
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
    k1_stages = stage_report("K1 bf16", n_pix, n_samp, oracle, nerf, mk16, ms_front, ms_shade)
    print(f"  card: {card_state()}", flush=True)
    done("7", t)

    t = time.perf_counter()
    phase(f"8 K3 vs plain at the train step's shape ({K3_ROWS} rows, NeRF 8x256, bf16)")
    nerf = load_export_weights(NeRFDef(), os.path.join(MSCENE, "model1.weights")).to(dev)
    k3 = NerfTrainKernel(nerf)
    x = encoded_samples(K3_ROWS // 128, 8, dev)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal((K3_ROWS, 4)).astype(
        np.float32)).to(dev) / (K3_ROWS * 4)  # the cotangent scale of a mean loss
    leaves = [p for _, p in nerf.named_parameters()]
    # The TPU kernel's bars, as nerf_train_check states them (every row;
    # the rows where a bf16 rounding or relu sign flips between the two
    # sides' summation orders capped in number and held to the looser
    # bars stated there; every layer of the kernel's recomputed forward
    # held against float64 sums of its own inputs). With the trained
    # weights the TPU kernel's absolute bars do not carry over, so the
    # forward is held relative to max |out| (set for O(1) outputs; the
    # trained net's alpha logits reach the hundreds, and a bf16 rounding
    # flip moves a value in proportion). The absolute bars themselves are
    # held below, on the inputs they were set for.
    res = nerf_train_check.compare(k3, x, lambda out: g)
    torch.cuda.synchronize()
    out_k, out_p = res["out"]["k"], res["out"]["p"]
    fwd_abs = float((out_k - out_p).abs().max())
    fwd_rel = fwd_abs / float(out_p.abs().max())
    errs = grad_errors(res["grads"]["p"], res["grads"]["k"])
    worst = max((v[0], k) for k, v in errs.items() if k != "x")
    worst_f = max((v[0], k) for k, v in grad_errors(res["grads"]["f"], res["grads"]["k"]).items())
    dx_abs = errs["x"][1]
    bwd_abs = max(v[1] for v in errs.values())
    ok, lines = nerf_train_check.verdict(res, scale=float(out_p.abs().max()))
    # here the TPU kernel's forward bar holds on every row as well
    lines.insert(1, f"forward on every row: {fwd_rel:.3e} of max |out| (allowed 4e-3)")
    print("  trained weights, encoded samples, a mean loss's cotangent:\n    "
          + "\n    ".join(lines + res["report"]), flush=True)
    if not (ok and fwd_rel <= 4e-3):
        raise SystemExit("K3 disagrees with its plain version")
    del res
    # tools/check_train_kernel_grads.py's own setup, where its absolute dX
    # bar was set: seeded initial weights, x and targets standard normal, the
    # grads of mean((out - t)^2); parameter leaves within 2e-2 of their max
    # |ref| and every dX element within 1e-6 absolute, its bars. That tool
    # holds no forward bar; the forward is held as above, relative to max
    # |out|.
    init = NeRFDef()
    init.reset_parameters(torch.Generator().manual_seed(0))
    init = init.to(dev)
    k3i = NerfTrainKernel(init)
    rng = np.random.default_rng(1)
    xi = torch.from_numpy(rng.standard_normal((K3_ROWS, 90)).astype(np.float32)).to(dev)
    ti = torch.from_numpy(rng.standard_normal((K3_ROWS, 4)).astype(np.float32)).to(dev)
    res = nerf_train_check.compare(
        k3i, xi,
        lambda out: torch.autograd.grad(torch.mean((out - ti) ** 2), out, retain_graph=True)[0])
    ok, lines = nerf_train_check.verdict(res, scale=float(res["out"]["p"].abs().max()),
                                         dx_abs=1e-6)
    print("  the JAX check's setup (init weights, normal x and targets, MSE):\n    "
          + "\n    ".join(lines + res["report"]), flush=True)
    if not ok:
        raise SystemExit("K3 disagrees with its plain version on the JAX check's setup")
    jax_dx_abs = grad_errors(res["grads"]["p"], res["grads"]["k"])["x"][1]
    del init, k3i, xi, ti, res
    named = dict(nerf.named_parameters())
    packed = k3.pack(named, dev)
    # deterministic: the chain's column sums, the weight gradients' row
    # slices and the bias partials are all summed in fixed orders
    dx1, gr1 = k3.backward_kernel(x, g, packed)
    dx2, gr2 = k3.backward_kernel(x, g, packed)
    same = torch.equal(dx1, dx2) and all(torch.equal(gr1[n], gr2[n]) for n in gr1)
    print(f"  two backward calls on the same inputs: dX and every dW and db bit for bit equal: "
          f"{same}", flush=True)
    if not same:
        raise SystemExit("K3's backward is not deterministic")
    del dx1, gr1, dx2, gr2
    ms_k3f = time_ms(lambda: k3.forward_kernel(x, packed), 5)
    ms_k3b = time_ms(lambda: k3.backward_kernel(x, g, packed), 3)
    # the backward's kernels, each timed by the profiler over 3 calls
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            k3.backward_kernel(x, g, packed)
        torch.cuda.synchronize()
    k3_bwd_kernels = {re.search(r"k3_\w+", e.key).group(0): e.self_device_time_total / 1e3 / 3
                      for e in prof.key_averages()
                      if e.device_type.name == "CUDA" and "k3_" in e.key}
    print(f"  backward kernels (ms a call): "
          + ", ".join(f"{k} {v:.3f}" for k, v in k3_bwd_kernels.items()), flush=True)
    del prof
    with torch.no_grad():
        ms_pf = time_ms(lambda: k3.plain(x), 5)
    xr = x.clone().requires_grad_(True)
    out_graph = k3.plain(xr)
    ms_pb = time_ms(lambda: torch.autograd.grad(out_graph, [xr] + leaves, g, retain_graph=True), 3)
    del out_graph
    macs = nerf.macs_per_input()
    ops_f = 2.0 * K3_ROWS * macs
    ops_b = 3.0 * ops_f  # recompute, the dX chain, dW
    nbytes_w = sum(p.numel() for p in leaves) * 4
    bytes_f = K3_ROWS * (90 + 4) * 4 + nbytes_w
    bytes_b = K3_ROWS * (90 + 4 + 90) * 4 + 2 * nbytes_w
    k3_bounds = {}
    for key, ops, nbytes in (("fwd", ops_f, bytes_f), ("bwd", ops_b, bytes_b)):
        bo, bb = ops / PEAK_OPS["bf16"] * 1e3, nbytes / HBM_BPS * 1e3
        k3_bounds[key] = (max(bo, bb), "operations" if bo >= bb else "bytes",
                          ops / PEAK_OPS["fp32"] * 1e3)
    scratch_bytes = 2 * k3.scratch_layout(K3_ROWS)[""][0]
    print(f"  K3 forward {ms_k3f:.3f} ms ({ops_f / ms_k3f / 1e9:.1f} TFLOP/s), backward "
          f"{ms_k3b:.3f} ms ({ops_b / ms_k3b / 1e9:.1f} TFLOP/s); plain forward {ms_pf:.3f} ms, "
          f"plain backward {ms_pb:.3f} ms", flush=True)
    print(f"  bounds: forward {k3_bounds['fwd'][0]:.3f} ms, backward {k3_bounds['bwd'][0]:.3f} ms "
          f"(bf16 peak; fp32 FMA {k3_bounds['fwd'][2]:.2f} / {k3_bounds['bwd'][2]:.2f} ms); the "
          f"backward's scratch ({scratch_bytes / 1e9:.2f} GB written and read) alone takes "
          f"{2 * scratch_bytes / HBM_BPS * 1e3:.2f} ms", flush=True)
    del x, g, out_k, out_p, packed
    torch.cuda.empty_cache()
    done("8", t)

    t = time.perf_counter()
    steps = TRAIN_WARMUP + TRAIN_TIMED
    phase(f"9 main path: train, dense_training.ini on demo/mscene, bf16, {steps} steps")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_logs_") as log_dir:
        argv = ["-c", DENSE_INI, "-data", MSCENE_DATA, "-log", log_dir, "--bf16",
                "--epochs", str(1 + steps), "--randomSeed", "0",
                # one value per network (an append option): neither is locked
                "--epochsLockWeightsBefore", "-1", "--epochsLockWeightsBefore", "-1",
                "--epochsRender", "1000000", "--epochsValidate", "1000000",
                "--epochsCheckpoint", "1000000", "--no-performEvaluation",
                "--verboseEvery", "10"]
        NerfTrainKernel.forward_launches = NerfTrainKernel.backward_launches = 0
        stats = train.main(argv)
        k3_launches = (NerfTrainKernel.forward_launches, NerfTrainKernel.backward_launches)
        ts = stats["state"]
        mse = stats["losses"][:, 1]
        step_ms = stats["step_ms"][TRAIN_WARMUP:]
        train_ms = float(np.mean(step_ms))
        print(f"  K3 launches on the main path: forward {k3_launches[0]}, backward "
              f"{k3_launches[1]} ({steps} steps)", flush=True)
        print(f"  train step {train_ms:.3f} ms (mean of {len(step_ms)}; median "
              f"{float(np.median(step_ms)):.3f}, min {min(step_ms):.3f}, max {max(step_ms):.3f}), "
              f"{K3_ROWS / train_ms / 1e3:.3f} M shading rows/s", flush=True)
        print(f"  MSE mean of the first 10 steps {float(mse[:10].mean()):.6f}, of the last 10 "
              f"{float(mse[-10:].mean()):.6f}; all losses finite: "
              f"{bool(np.isfinite(stats['losses']).all())}", flush=True)
        print(f"  checkpoint: {[os.path.basename(p) for p in stats['checkpoint']]}", flush=True)
        if k3_launches != (steps, steps):
            raise SystemExit(f"the train path launched K3 {k3_launches} times, expected {steps}")
        if not (np.isfinite(stats["losses"]).all() and mse[-10:].mean() < mse[:10].mean()):
            raise SystemExit("training loss did not fall or is not finite")
        if not all(os.path.exists(p) for p in stats["checkpoint"]):
            raise SystemExit("the final checkpoint is missing")
        # one step's grads through K3 and through the plain path, same
        # params and batch (no update is applied)
        batch, targets = ts.assemble_train_batch(ts.train_dataset, np.array([0, 1]))
        _, grads_k = ts.make_loss_and_grads()(batch, targets, steps + 1)
        ts.config_file.fusedTrainKernel = 0
        _, grads_p = ts.make_loss_and_grads()(batch, targets, steps + 1)
        step_errs = {}
        for i, m in enumerate(ts.models):
            for k, (rel, _) in grad_errors(grads_p[i], grads_k[i]).items():
                step_errs[f"{m.name}.{k}"] = rel
        worst_step = max((v, k) for k, v in step_errs.items())
        print(f"  train step grads, K3 vs plain: worst leaf {worst_step[1]} rel "
              f"{worst_step[0]:.3e} (allowed 2e-2)", flush=True)
        if not worst_step[0] <= 2e-2:
            raise SystemExit("the train step's grads through K3 disagree with the plain path")
        # where a step's device time goes: 3 more steps through K3 under the
        # profiler, counting device-side events only (an aten op's "self"
        # device time repeats its kernels')
        ts.config_file.fusedTrainKernel = 1
        step = ts.make_train_step()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t_prof = time.perf_counter()
            for epoch in range(steps + 2, steps + 5):
                step(batch, targets, epoch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t_prof) * 1e3 / 3
        kernels = sorted(((e.self_device_time_total / 1e3 / 3, e.key) for e in prof.key_averages()
                          if e.self_device_time_total > 0 and e.device_type.name == "CUDA"),
                         reverse=True)
        device_ms = sum(ms for ms, _ in kernels)
        k3_ms = sum(ms for ms, name in kernels if "k3_" in name)
        # K3's kernels launched per step: the forward's one, the backward's
        k3_step_counts = {re.search(r"k3_\w+", e.key).group(0): e.count / 3
                          for e in prof.key_averages()
                          if e.device_type.name == "CUDA" and "k3_" in e.key}
        print(f"  K3 kernels launched per step: {k3_step_counts}", flush=True)
        expected = {k: 1.0 for k in ("k3_fwd",) + nerf_train.BACKWARD_KERNEL_NAMES}
        if k3_step_counts != expected:
            raise SystemExit(f"K3 launched {k3_step_counts} a step, expected {expected}")
        if device_ms > 0:
            print(f"  profiled step (3 steps): device busy {device_ms:.3f} ms of {wall_ms:.3f} ms "
                  f"wall ({100 * device_ms / wall_ms:.1f}%, profiler on); K3 kernels "
                  f"{k3_ms:.3f} ms, the rest {device_ms - k3_ms:.3f} ms", flush=True)
            for ms, name in kernels[:12]:
                print(f"    {ms:9.3f} ms  {name[:90]}", flush=True)
        else:
            print("  profiled step: the profiler recorded no device time (not measured)", flush=True)
        del ts, stats, batch, targets, grads_k, grads_p, step, prof
    done("9", t)

    t = time.perf_counter()
    phase("10 K2 fp32 checks, trained_mscene_export, 400x400 frame, thresholds 0.2 / 0.01 / 1e-4")
    k2_fp32 = {}
    scene_thr = rt32.threshold
    for thr in K2_THRESHOLDS:
        rt32.threshold = scene_thr if thr is None else thr
        # at cap the S-th and (S+1)-th largest logits of a ray may lie
        # within rounding of each other, so the two sides' summation orders
        # may keep different bins for a few rays: there the plain bar holds
        # on the rays without such a near tie
        k2_fp32[rt32.threshold] = check_dense(MegakernelDense(rt32), MegakernelCompact(rt32),
                                              dirs400, pose, rot,
                                              f"K2 fp32, threshold {rt32.threshold}",
                                              hold_plain=thr != 1e-4)
    rt32.threshold = scene_thr
    spp_by_thr = [v[2] for v in k2_fp32.values()]
    if not spp_by_thr[1] > spp_by_thr[0]:
        raise SystemExit("threshold 0.01 kept no more samples than the export's threshold")
    done("10", t)

    t = time.perf_counter()
    phase("11 K2 bf16 at 800x800: agreement, time, bound")
    rt16d, _ = viewer.build_renderer_from_export(MSCENE, dtype_str="bf16", device=dev)
    k2_16 = {}
    for thr in K2_THRESHOLDS:
        rt16d.threshold = rt32.threshold = scene_thr if thr is None else thr
        k2 = MegakernelDense(rt16d)
        rgb_k, cnt_k = k2(dirs800, pose, rot)
        rgb_f, _ = rt32.render_rays(pose_t, rot_t, dirs800, compaction=False)
        p_f = psnr(rgb_k, rgb_f)
        del rgb_f
        rgb_p, cnt_p = k2.plain(dirs800, pose_t, rot_t)
        agree = cnt_k == cnt_p
        n_bad = int((~agree).sum())
        err = float((rgb_k - rgb_p).abs()[agree].max())
        p_p = psnr(rgb_k, rgb_p)
        del rgb_p
        samp2 = int(cnt_k.sum())
        print(f"  threshold {rt16d.threshold}: samples/px {samp2 / n_pix:.4f}; K2 bf16 vs plain "
              f"fp32 {p_f:.2f} dB (allowed >= 40); vs plain bf16 {p_p:.2f} dB (allowed >= 40), "
              f"count mismatches {n_bad} of {n_pix}, rgb max abs err on agreeing rays "
              f"{err:.3e}", flush=True)
        if not (p_f >= 40.0 and p_p >= 40.0):
            raise SystemExit("K2 bf16 below 40 dB against its plain version")
        fr = frame_ms(k2, dirs800, pose, rot)
        ms, ms_front, ms_shade = fr["ms"], fr["front_ms"], fr["front_shade_ms"]
        ms_plain = time_ms(lambda: k2.plain(dirs800, pose_t, rot_t), 2)
        k1 = MegakernelCompact(rt16d)
        rgb_1, cnt_1 = k1(dirs800, pose, rot)
        same = torch.equal(rgb_k, rgb_1) and torch.equal(cnt_k, cnt_1)
        print(f"  K2 bf16 equal to K1 bf16 bit for bit: {same}", flush=True)
        if not same:
            raise SystemExit("K2 bf16 differs from K1 bf16")
        del rgb_1, cnt_1
        ms_k1 = frame_ms(k1, dirs800, pose, rot)["ms"]
        # K2 shades all S slots of every ray (its own work), but a dead slot
        # adds exact zeros: the same function needs the NeRF at the live
        # samples only, so the bound counts those, as phase 7's does
        oracle_macs, nerf_macs = rt16d.oracle.macs_per_input(), rt16d.nerf.macs_per_input()
        work = 2.0 * n_pix * (oracle_macs + k2.params.S * nerf_macs)
        ops = 2.0 * (n_pix * oracle_macs + samp2 * nerf_macs)
        wbytes = k2.weights.numel() * k2.weights.element_size() + k2.biases.numel() * 4
        nbytes = n_pix * 12 + 12 + 36 + wbytes + n_pix * (12 + 4)
        bo, bb = ops / PEAK_OPS["bf16"] * 1e3, nbytes / HBM_BPS * 1e3
        print(f"  K2 {ms:.3f} ms/frame ({n_pix / ms / 1e3:.2f} Mrays/s; its own work, all slots, "
              f"{work / 1e12:.4f} TFLOP at {work / ms / 1e9:.1f} TFLOP/s; front {ms_front:.3f} ms, "
              f"front+shade {ms_shade:.3f} ms), plain dense {ms_plain:.3f} ms/frame, K1 on the "
              f"same frame {ms_k1:.3f} ms", flush=True)
        print(f"  bound (live samples): {ops / 1e12:.4f} TFLOP over {PEAK_OPS['bf16'] / 1e12:.0f} "
              f"TFLOP/s bf16 = {bo:.3f} ms; {nbytes / 1e6:.2f} MB over 3.35 TB/s = {bb:.4f} ms; "
              f"K2 at {100 * max(bo, bb) / ms:.2f}% of bound; fp32 FMA bound "
              f"{ops / PEAK_OPS['fp32'] * 1e3:.3f} ms", flush=True)
        stages = stage_report("K2 bf16", n_pix, n_pix * k2.params.S, rt16d.oracle, rt16d.nerf,
                              k2, ms_front, ms_shade)
        k2_16[rt16d.threshold] = dict(ms=ms, front=ms_front, shade=ms_shade, plain=ms_plain,
                                      stages=stages,
                                      k1=ms_k1, err=err, n_bad=n_bad, psnr_fp32=p_f,
                                      psnr_plain=p_p, spp=samp2 / n_pix, bound=max(bo, bb),
                                      bound_by="operations" if bo >= bb else "bytes")
        del rgb_k, cnt_k, cnt_p, agree, k1
    rt16d.threshold = rt32.threshold = scene_thr
    del rt16d
    torch.cuda.empty_cache()
    print(f"  card: {card_state()}", flush=True)
    done("11", t)

    t = time.perf_counter()
    phase("12 main path: viewer --megakernel v3, trained_mscene_export, 800x800, 5 frames, bf16")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_frames_") as dump:
        MegakernelDense.launches = 0
        stats_v3 = viewer.main([MSCENE, "-s", "800", "800", "-n", "5", "--megakernel", "v3",
                                "-d", dump])
        k2_launches = MegakernelDense.launches
        print(f"  main path: megakernel_dense launches {k2_launches}", flush=True)
        if k2_launches < 1:
            raise SystemExit("the v3 path never launched megakernel_dense")
        frames = sorted(os.listdir(dump))
        png = read_png(os.path.join(dump, frames[-1]))
        want = (stats_v3["last_frame"].clamp(0, 1).cpu().numpy() * 255).astype(np.uint8)
        print(f"  dumped {frames}; {frames[-1]} reads back {png.shape}, equal to the frame: "
              f"{bool(np.array_equal(png, want))}", flush=True)
        if frames != [f"{i:05d}.png" for i in range(5)] or not np.array_equal(png, want):
            raise SystemExit("the v3 viewer's PNG frames are missing or differ from the frame")
        if not torch.isfinite(stats_v3["last_frame"]).all():
            raise SystemExit("the v3 viewer rendered non-finite values")
    print(f"  card: {card_state()}", flush=True)
    done("12", t)

    t = time.perf_counter()
    phase("13 bf16 check and time, trained_ndc_export (S=16, NDC), 800x800")
    rtn16, _ = viewer.build_renderer_from_export(NDC, dtype_str="bf16", device=dev)
    mkn = MegakernelCompact(rtn16)
    dirsn = viewer.frame_directions(scn, 800, 800, dev)
    posen_t = torch.as_tensor(posen, dtype=torch.float32, device=dev)
    rgb_k, cnt_k = mkn(dirsn, posen, rot)
    rgb_pb, cnt_pb = mkn.plain(dirsn, posen_t, rot_t)
    rgb_pf, cnt_pf = MegakernelCompact(rtn).plain(dirsn, posen_t, rot_t)
    p_b, p_f = psnr(rgb_k, rgb_pb), psnr(rgb_k, rgb_pf)
    ndc_bad = int((cnt_k != cnt_pb).sum())
    print(f"  K1 bf16 vs plain bf16 {p_b:.2f} dB, count mismatches {ndc_bad} of {dirsn.shape[0]}; "
          f"vs plain fp32 {p_f:.2f} dB (count mismatches {int((cnt_k != cnt_pf).sum())}); "
          f"samples/px {float(cnt_k.float().mean()):.4f} of S={mkn.params.S}", flush=True)
    if not (p_b >= 40.0 and p_f >= 40.0 and bool(torch.isfinite(rgb_k).all())):
        raise SystemExit("K1 bf16 on the NDC export below 40 dB against its plain version")
    fr = frame_ms(mkn, dirsn, posen, rot)
    ndc_ms, ndc_front, ndc_shade = fr["ms"], fr["front_ms"], fr["front_shade_ms"]
    ndc_plain = time_ms(lambda: mkn.plain(dirsn, posen_t, rot_t), 3)
    print(f"  K1 bf16 {ndc_ms:.3f} ms/frame, plain bf16 {ndc_plain:.3f} ms/frame", flush=True)
    ndc_stages = stage_report("K1 bf16 NDC", dirsn.shape[0], int(cnt_k.sum()), rtn16.oracle,
                              rtn16.nerf, mkn, ndc_front, ndc_shade)
    del rtn16, mkn, dirsn, rgb_k, cnt_k, rgb_pb, cnt_pb, rgb_pf, cnt_pf
    torch.cuda.empty_cache()
    print(f"  card: {card_state()}", flush=True)
    done("13", t)

    k2_main = k2_16[scene_thr]
    phase("14 kernels")
    print(json.dumps({"kernels": [{
        "name": "megakernel_compact", "route": "cuda",
        "source": "adanerf_tpu_torch/csrc/megakernel_compact.cu + adanerf_tpu_torch/csrc/megakernel.cuh",
        "replaces": "adanerf_tpu/ops/pallas/megakernel3.py:227",
        "launches": launches, "max_abs_err": err16, "fp32_max_abs_err": err32,
        "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound,
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": None,
        "viewer_device_ms": stats_view["device_ms_per_frame"],
        "viewer_device_ms_median": stats_view["device_ms_median"],
        "samples_per_pixel": n_samp / n_pix, "stages": k1_stages,
        "ndc_800_ms": ndc_ms, "ndc_800_plain_ms": ndc_plain, "ndc_psnr_vs_plain_bf16": p_b,
        "ndc_psnr_vs_plain_fp32": p_f, "ndc_stages": ndc_stages}, {
        "name": "nerf_train_forward", "route": "cuda",
        "source": "adanerf_tpu_torch/csrc/nerf_train.cu",
        "replaces": "adanerf_tpu/ops/pallas/train_kernel.py:95",
        "launches": k3_launches[0], "max_abs_err": fwd_abs, "rel_err": fwd_rel,
        "ms": ms_k3f, "plain_ms": ms_pf, "bound_ms": k3_bounds["fwd"][0],
        "bound_by": k3_bounds["fwd"][1], "library_ms": None, "rows": K3_ROWS}, {
        "name": "nerf_train_backward", "route": "cuda",
        "source": "adanerf_tpu_torch/csrc/nerf_train.cu",
        "replaces": "adanerf_tpu/ops/pallas/train_kernel.py:95",
        "launches": k3_launches[1], "max_abs_err": bwd_abs, "worst_leaf_rel_err": worst[0],
        "dx_rel_err": errs["x"][0], "forced_outputs_worst_leaf_rel_err": worst_f[0],
        "dx_max_abs_err": dx_abs, "jax_check_dx_max_abs_err": jax_dx_abs, "ms": ms_k3b, "plain_ms": ms_pb,
        "bound_ms": k3_bounds["bwd"][0], "bound_by": k3_bounds["bwd"][1], "library_ms": None,
        "rows": K3_ROWS, "train_step_ms": train_ms, "kernels_ms": k3_bwd_kernels,
        "kernels_per_step": k3_step_counts, "deterministic": same}, {
        "name": "megakernel_dense", "route": "cuda",
        "source": "adanerf_tpu_torch/csrc/megakernel_dense.cu + adanerf_tpu_torch/csrc/megakernel.cuh",
        "replaces": "adanerf_tpu/ops/pallas/megakernel.py:281",
        "launches": k2_launches, "max_abs_err": k2_main["err"],
        "fp32_max_abs_err": {str(k): v[0] for k, v in k2_fp32.items()},
        "fp32_max_abs_err_vs_k1": max(v[1] for v in k2_fp32.values()),
        "ms": k2_main["ms"], "plain_ms": k2_main["plain"], "bound_ms": k2_main["bound"],
        "bound_by": k2_main["bound_by"], "library_ms": None,
        "k1_ms_same_frame": k2_main["k1"],
        "ms_by_threshold": {str(k): v["ms"] for k, v in k2_16.items()},
        "plain_ms_by_threshold": {str(k): v["plain"] for k, v in k2_16.items()},
        "bound_ms_by_threshold": {str(k): v["bound"] for k, v in k2_16.items()},
        "k1_ms_by_threshold": {str(k): v["k1"] for k, v in k2_16.items()},
        "samples_per_pixel_by_threshold": {str(k): v["spp"] for k, v in k2_16.items()},
        "stages_by_threshold": {str(k): v["stages"] for k, v in k2_16.items()},
        "viewer_device_ms": stats_v3["device_ms_per_frame"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
