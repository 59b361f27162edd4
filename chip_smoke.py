#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (adanerf_tpu_torch) on one NVIDIA card.

  python3 chip_smoke.py

Builds the CUDA kernels from the checkout, one library per source and MLP
width (printing each kernel's
registers, spills, shared memory and HGMMA count), holds each against its
plain PyTorch version on the card (K3's backward also against itself: two
calls must agree bit for bit), drives the port's paths (the viewer
rendering a trained export through K1, the dense trainer taking a few
steps through K3 and validating at its last, the fine trainer
bootstrapped from that run's ``_opt`` checkpoints taking a few steps
through K3 with its render, video, validation and evaluation legs, the
export of that fine run viewed through K1 and K2, and the viewer's
``--megakernel v3`` rendering through K2), checks and times K1 in bf16 on
the S=16 NDC export at 800x800, evaluates the committed JAX run against
the JAX package's own CPU evaluation of it
(``tests/torch_fixtures/eval_mscene_fine02.json``) and its videos leg
against that evaluation's images leg, trains the repo's other two
configurations (``adanerf_tpu_torch/configs/nerf_baseline.ini``: a coarse
and a fine NeRF, both through K3, at 262,144 and 786,432 rows a step;
``gt_depth_training.ini``: GT pretraining of the oracle, then joint steps
with the NeRF through K3), runs the scale-out (phase 17: two gloo ranks
sharing the card through K3 against the one-process step, a 1-rank NCCL
step, K1 and K2 over 4 slices of a frame, the viewer with ``--mesh 1``),
drives the main path at other MLP widths (phase 18: K3 alone at 524,288
rows at widths 128, 384 and 512; at 128 and 512 both nets of the dense
then the fine ini through K3, and the fine run's export through K1 and
K2), takes a real forward-facing capture end to end (phase 19: the JPEG
decoder against imageio's committed pixels, ``convert_llff`` on
``demo/llff_scene_jpeg``, ``configs/dense_training_ndc.ini`` through K3 on
the converted capture, the committed JAX fine NDC run resumed at epoch
6,000 through K3 for 6,000 steps and scored against JAX's own epoch-12,000
weights by the same port code, its validation 1,000 steps in against the
JAX package's own resume on the CPU, a traced step, the run's ``epoch_*.pdf``
plots, its export through K1 with ``--megakernel v3`` refused), and
prints, as its last two lines, a JSON line of per-kernel numbers (each
kernel's ``widths`` too) and a JSON line
``{"ok": true, "device": {...}}``. Exits
non-zero, without those lines, when there is no CUDA device or any phase
fails. Imports torch, numpy and the standard library besides the port
itself.
"""

from __future__ import annotations

import copy
import csv
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
FINE_INI = os.path.join(ROOT, "configs", "fine_training.ini")
BASELINE_INI = os.path.join(ROOT, "adanerf_tpu_torch", "configs", "nerf_baseline.ini")
GT_INI = os.path.join(ROOT, "adanerf_tpu_torch", "configs", "gt_depth_training.ini")
K3_ROWS = 2 * 2048 * 128  # batchImages x samples x numRaymarchSamples of the dense config
K3_FINE_ROWS = 2 * 2048 * 16  # the same of the fine config (numRaymarchSamples = [16, 16])
TRAIN_WARMUP, TRAIN_TIMED = 3, 30
FINE_STEPS = 20
# nerf_baseline.ini: 2 x 2048 rays x 64 coarse samples, then x (64 + 128) fine
K3_BASELINE_ROWS = (2 * 2048 * 64, 2 * 2048 * (64 + 128))
K3_GT_ROWS = 2 * 2048 * 16  # gt_depth_training.ini's NeRF: 16 samples a ray
BASELINE_STEPS, GT_PRETRAIN, GT_STEPS = 20, 10, 20
DP_STEPS = 3  # phase 17's data-parallel steps
# phase 18: the main path at other MLP widths (both nets --layerWidth W):
# K3 alone at K3_ROWS rows at each of K3_WIDTHS, the dense -> fine -> export
# -> viewer path at each of MAIN_WIDTHS
K3_WIDTHS, MAIN_WIDTHS = (128, 384, 512), (128, 512)
WIDTH_DENSE_STEPS = 8
# the JAX package's fine run committed in the repo (S=8, threshold 0.2, fp32),
# its evaluation on this host's CPU by the JAX package, and the bars the
# port's evaluation on the card is held to against that fixture
JAX_RUN = os.path.join(
    ROOT, "demo", "mlogs", "mscene",
    "lo_SpPoDi(nerf(10-4))-relu0(256x8)-S-128_RayMarchFromPoses_nSD[8_LSfCDA_(0.2)_128_0.0]_"
    "acc_alpha(nerf(10-4))-NeRF1(256x8[4])-RGBARayMarch_[0.025_1.0]_[10k_30k]_O_Z_N")
EVAL_FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "eval_mscene_fine02.json")
EVAL_BARS = {"psnr": 0.01, "flip": 1e-4, "samples": 1e-4}

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and the bf16
# tensor-core and fp32 FMA operation rates
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}

K2_THRESHOLDS = (None, 0.01, 1e-4)  # the export's own 0.2; lower keeps more slots; at cap

# phase 19: a forward-facing capture with JPEG images (demo/llff_scene's 32
# images at quality 95, 4:2:0), the NDC configs, and the committed JAX fine
# NDC run (configs/fine_training_ndc.ini, fp32, 25,001 epochs) resumed at
# its NDC_RESUME checkpoint for NDC_RESUME steps, validating every
# NDC_VALIDATE, scored against its own checkpoint at 2 x NDC_RESUME with the
# bars below; its validation loss NDC_VALIDATE steps in is held to the JAX
# package's own resume on the CPU (NDC_JAX_RESUME, written by
# tests/torch_ndc_resume_reference.py) with the same ratio bar
LLFF_PNG = os.path.join(ROOT, "demo", "llff_scene")
LLFF_JPEG = os.path.join(ROOT, "demo", "llff_scene_jpeg")
JPEG_FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "jpeg")
LLFF_PINNED = os.path.join(ROOT, "tests", "torch_fixtures", "llff_jpeg.json")
DENSE_NDC_INI = os.path.join(ROOT, "configs", "dense_training_ndc.ini")
NDC_LOGS = os.path.join(ROOT, "demo", "ndclogs", "llff_scene")
NDC_DENSE_STEPS, NDC_RESUME, NDC_VALIDATE = 8, 6000, 1000
NDC_JAX_RESUME = os.path.join(ROOT, "tests", "torch_fixtures", "ndc_resume_jax.json")
QUALITY_BARS = {"val_loss_ratio": 1.10, "test_psnr_db": 0.5}

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


def slot_bins(rt, z):
    """(B, S) long: the oracle bin whose depth each slot holds."""
    D = rt.oracle.n_out
    table = rt._to_world((torch.arange(D, device=z.device, dtype=torch.float32) + 0.5) / D)
    return (z[..., None] - table).abs().argmin(dim=-1)


def kept_bins(rt, z, mask):
    """(B, D) bool: the oracle bins whose depths fill a ray's live slots."""
    D = rt.oracle.n_out
    keep = torch.zeros((z.shape[0], D + 1), dtype=torch.bool, device=z.device)
    return keep.scatter_(1, torch.where(mask, slot_bins(rt, z), D), True)[:, :D]


def float64_logits(rt, pose, rot, dirs, chunk=40000):
    """(B, D) float64: the oracle's logits summed in float64 on the
    renderer's own (fp32) encoded inputs."""
    oracle64 = copy.deepcopy(rt.oracle).double()
    out = []
    with torch.no_grad():
        for c in range(0, dirs.shape[0], chunk):
            _, nds, proj, _ = rt.oracle_logits(pose, rot, dirs[c:c + chunk])
            x = torch.cat([rt.enc0_dir(nds), rt.enc0_pos(proj)], dim=-1)
            out.append(oracle64(x.double()))
    return torch.cat(out)


def check_slots(k, dirs, pose, rot, label, allowed, referee=False):
    """A render kernel in fp32 (K1 or K2) against a float64 shading of its
    own slots (within 2e-4 on every ray) and against its plain version:
    counts exact, and rgb within 2e-4 on every ray but at most ``allowed``,
    each of which must keep other bins than the plain
    version, all at a near tie, where the two sides' summation orders of
    the oracle's products may keep another bin: a logit within NEAR of the
    threshold or of the ray's S-th largest; with ``referee``, the float64
    logits of the same inputs decide instead: a kept or dropped bin's
    float64 logit lies within 2e of the threshold or of the float64 S-th
    largest, e the larger of the ray's two fp32 roundings as measured
    against float64 (the plain version's over all bins, the kernel's over
    its own slots, whose logits its front returns): for two bins to swap
    places on one side, that side's roundings of them must together cover
    their float64 gap. Returns {err_p: max err vs
    plain, err_same: max err on the rays that keep the plain version's
    bins, spp, at_cap, n_flipped: rays keeping other bins, beyond: rays
    beyond 2e-4, rgb, counts}."""
    rgb_k, cnt_k = k(dirs, pose, rot)
    o_k, d_k, z_k, p_k, c_k = k.front(dirs, pose, rot)
    torch.cuda.synchronize()
    rt, dev, S = k.renderer, dirs.device, k.params.S
    pose_t = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    rot_t = torch.as_tensor(rot, dtype=torch.float32, device=dev)
    rgb_p, cnt_p = k.plain(dirs, pose_t, rot_t)
    with torch.no_grad():
        logits = rt.oracle_logits(pose_t, rot_t, dirs)[3]
        o_p, d_p, z_p, p_p, mask_p = rt._oracle_stage(pose_t, rot_t, dirs)
    live_k = torch.arange(S, device=dev)[None, :] < c_k[:, None]
    # the float64 witness: each side's own slots shaded in float64
    err64_k = float((rgb_k.double() - float64_frame(rt, o_k, d_k, z_k, p_k, live_k)).abs().max())
    err64_p = float((rgb_p.double() - float64_frame(rt, o_p, d_p, z_p, p_p, mask_p)).abs().max())
    bad_p, bad_front = int((cnt_k != cnt_p).sum()), int((c_k != cnt_k).sum())
    per_ray = (rgb_k - rgb_p).abs().max(dim=1).values
    kept_k, kept_p = kept_bins(rt, z_k, live_k), kept_bins(rt, z_p, mask_p)
    flipped = kept_k ^ kept_p
    rays_flipped = flipped.any(1)
    err_same = float(per_ray[~rays_flipped].max()) if bool((~rays_flipped).any()) else 0.0
    top = torch.topk(logits, S + 1, dim=1).values
    at_tie = ((logits - rt.threshold).abs() <= NEAR) | ((logits - top[:, S - 1:S]).abs() <= NEAR)
    if referee:
        l64 = float64_logits(rt, pose_t, rot_t, dirs)
        e_p = (logits.double() - l64).abs().max(dim=1).values
        e_k = torch.where(live_k, (p_k.double() - l64.gather(1, slot_bins(rt, z_k))).abs(),
                          torch.zeros_like(p_k, dtype=torch.float64)).max(dim=1).values
        tol = 2.0 * torch.maximum(e_p, e_k)[:, None]
        top64 = torch.topk(l64, S, dim=1).values[:, S - 1:S]
        at_tie = ((l64 - rt.threshold).abs() <= tol) | ((l64 - top64).abs() <= tol)
        print(f"  {label}: oracle logits against float64 sums of the same inputs: plain fp32 "
              f"within {float(e_p.max()):.3e}, the kernel's at its slots within "
              f"{float(e_k.max()):.3e}", flush=True)
    beyond = torch.nonzero(per_ray > 2e-4).flatten().tolist()
    n_unexplained = 0
    for j, r in enumerate(beyond):
        bins = torch.nonzero(flipped[r]).flatten()
        explained = len(bins) > 0 and bool(at_tie[r, bins].all())
        n_unexplained += not explained
        if j < 8 or not explained:
            only_k, only_p = bins[kept_k[r, bins]].tolist(), bins[kept_p[r, bins]].tolist()
            ref = (f"; float64 logits {[f'{v:.9g}' for v in l64[r, bins].tolist()]}, float64 "
                   f"S-th largest {float(top64[r, 0]):.9g}, allowed gap {float(tol[r, 0]):.3e}"
                   if referee else "")
            print(f"    ray {r}: vs plain {float(per_ray[r]):.3e}; bins kept by the kernel only "
                  f"{only_k}, by plain only {only_p}, their logits "
                  f"{[f'{v:.9g}' for v in logits[r, bins].tolist()]}; S-th and (S+1)-th "
                  f"largest {float(top[r, S - 1]):.9g}, {float(top[r, S]):.9g}{ref}; near tie: "
                  f"{explained}", flush=True)
    n = dirs.shape[0]
    spp = float(cnt_k.float().mean())
    at_cap = float((cnt_k == S).float().mean())
    print(f"  {label}: {n} rays, samples/px {spp:.4f}, at cap {100 * at_cap:.2f}%; vs plain: "
          f"count mismatches {bad_p} (allowed 0), rgb max abs err {float(per_ray.max()):.3e}, "
          f"on the {n - int(rays_flipped.sum())} rays keeping the plain version's bins "
          f"{err_same:.3e}; rays beyond 2e-4 {len(beyond)} (allowed {allowed}, each keeping "
          f"other bins at a near tie; {n_unexplained} not); rays keeping other bins than plain "
          f"{int(rays_flipped.sum())}; vs float64 of each side's own slots: kernel "
          f"{err64_k:.3e} (allowed 2e-4), plain fp32 {err64_p:.3e}", flush=True)
    if bad_p or bad_front or not err64_k <= 2e-4 or n_unexplained or len(beyond) > allowed:
        raise SystemExit(f"{label}: the kernel disagrees with its plain version or float64")
    return dict(err_p=float(per_ray.max()), err_same=err_same, spp=spp, at_cap=at_cap,
                n_flipped=int(rays_flipped.sum()), beyond=len(beyond), rgb=rgb_k, counts=cnt_k)


def check_dense(k2, k1, dirs, pose, rot, label, allowed, referee=False):
    """K2 in fp32 through ``check_slots`` (``allowed`` rays beyond 2e-4 of
    its plain version) and against K1 on the same rays: counts exact, rgb
    within 1.5e-7, the bar tests/test_megakernel3.py holds the JAX kernels
    to each other (K2's live slots run K1's instructions, and a dead slot
    adds exact zeros and multiplies the transmittance by 1 - 0 + 1e-10 == 1
    in fp32). Returns (max err vs plain, max err vs K1, samples/px, share
    of rays at cap)."""
    res = check_slots(k2, dirs, pose, rot, label, allowed, referee)
    rgb1, cnt1 = k1(dirs, pose, rot)
    torch.cuda.synchronize()
    bad_1 = int((res["counts"] != cnt1).sum())
    err_1 = float((res["rgb"] - rgb1).abs().max())
    print(f"  {label} vs K1: count mismatches {bad_1} (allowed 0), rgb max abs err {err_1:.3e} "
          f"(allowed 1.5e-7)", flush=True)
    if bad_1 or not err_1 <= 1.5e-7:
        raise SystemExit(f"{label}: K2 disagrees with K1")
    return res["err_p"], err_1, res["spp"], res["at_cap"]


def one_image_scene(tmp):
    """demo/mscene as a scene of symlinks whose val and test splits are cut
    to their first image: one validation image a validation pass, a
    one-image evaluation."""
    scene = os.path.join(tmp, "mscene")
    os.makedirs(scene)
    for name in os.listdir(MSCENE_DATA):
        if name not in ("transforms_val.json", "transforms_test.json"):
            os.symlink(os.path.join(MSCENE_DATA, name), os.path.join(scene, name))
    for split in ("val", "test"):
        with open(os.path.join(MSCENE_DATA, f"transforms_{split}.json")) as f:
            frames = json.load(f)["frames"]
        with open(os.path.join(scene, f"transforms_{split}.json"), "w") as f:
            json.dump({"frames": frames[:1]}, f)
    return scene


def record_rows(kernel):
    """Keeps the row count of every K3 forward launch (the wrapper still
    counts its launches itself). Returns (the list, a function that undoes
    the wrapping)."""
    rows, launch = [], kernel.forward_kernel

    def keep(self, x, packed):
        rows.append(x.shape[0])
        return launch(self, x, packed)

    kernel.forward_kernel = keep
    return rows, lambda: setattr(kernel, "forward_kernel", launch)


def k3_at(kernel, check, nerf, x, seed, label):
    """K3 against its plain version (``nerf_train_check``, its bars) on one
    net's own NeRF input rows x, a mean loss's seeded cotangent; then its
    forward and backward times, the plain version's and the bounds.
    Returns the numbers; fails when the check does not hold."""
    from adanerf_tpu_torch.frame_times import time_ms
    k3 = kernel(nerf)
    N = x.shape[0]
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal((N, 4)).astype(
        np.float32)).to(x.device) / (N * 4)
    res = check.compare(k3, x, lambda out: g)
    torch.cuda.synchronize()
    out_k, out_p = res["out"]["k"], res["out"]["p"]
    fwd_abs = float((out_k - out_p).abs().max())
    bwd_abs = max(float((a - res["grads"]["k"][n]).abs().max())
                  for n, a in res["grads"]["p"].items())
    ok, lines = check.verdict(res, scale=float(out_p.abs().max()))
    print(f"  K3 vs plain, {label}, on the step's own {N} NeRF input rows:\n    "
          + "\n    ".join(lines + res["report"]), flush=True)
    if not ok:
        raise SystemExit(f"K3 disagrees with its plain version at {label}'s {N} rows")
    del res, out_k, out_p
    packed = k3.pack(dict(k3.nerf.named_parameters()), x.device)
    ms_f = time_ms(lambda: k3.forward_kernel(x, packed), 10)
    ms_b = time_ms(lambda: k3.backward_kernel(x, g, packed), 5)
    with torch.no_grad():
        ms_pf = time_ms(lambda: k3.plain(x), 5)
    xr = x.clone().requires_grad_(True)
    out_graph = k3.plain(xr)
    leaves = [p for _, p in k3.nerf.named_parameters()]
    ms_pb = time_ms(lambda: torch.autograd.grad(out_graph, [xr] + leaves, g, retain_graph=True),
                    3)
    del out_graph, xr, packed
    bounds = k3_bounds(N, k3.nerf)
    print(f"  K3 at {N} rows ({label}): forward {ms_f:.3f} ms, backward {ms_b:.3f} ms; plain "
          f"forward {ms_pf:.3f} ms, plain backward {ms_pb:.3f} ms; bounds {bounds['fwd'][0]:.3f} "
          f"/ {bounds['bwd'][0]:.3f} ms ({bounds['fwd'][1]}); scratch "
          f"{2 * k3.scratch_layout(N)[''][0] / 1e9:.2f} GB", flush=True)
    torch.cuda.empty_cache()
    return dict(rows=N, ms_fwd=ms_f, ms_bwd=ms_b, plain_fwd_ms=ms_pf, plain_bwd_ms=ms_pb,
                bound_fwd_ms=bounds["fwd"][0], bound_bwd_ms=bounds["bwd"][0],
                bound_by=bounds["fwd"][1], max_abs_err_fwd=fwd_abs, max_abs_err_bwd=bwd_abs)


def baseline_leg(train, kernel, check):
    """Phase 15: ``adanerf_tpu_torch/configs/nerf_baseline.ini`` (a coarse
    NeRF on 64 samples a ray, a fine NeRF on 64 + 128, both 8 x 256) on
    demo/mscene in bf16 for BASELINE_STEPS steps, its last epoch validating
    one image, then the ini's evaluation of one test image. Fails unless
    K3 ran both nets in every step (a forward launch at each stage's rows,
    in order), every loss is finite and both nets' losses fall, the run's
    files exist, one step's grads through K3 agree with the plain path's,
    K3 holds against its plain version on each stage's own rows, and a
    profiled step launches each K3 kernel twice."""
    from adanerf_tpu_torch.ops.kernels.nerf_train import BACKWARD_KERNEL_NAMES
    steps = BASELINE_STEPS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_baseline_") as tmp:
        argv = ["-c", BASELINE_INI, "-data", one_image_scene(tmp), "-log",
                os.path.join(tmp, "logs"), "--bf16", "--epochs", str(1 + steps),
                "--randomSeed", "0", "--epochsRender", "1000000", "--epochsValidate", str(steps),
                "--epochsCheckpoint", "1000000", "--verboseEvery", "5"]
        torch.cuda.reset_peak_memory_stats()
        kernel.forward_launches = kernel.backward_launches = 0
        rows, undo = record_rows(kernel)
        try:
            stats = train.main(argv)
        finally:
            undo()
        launches = (kernel.forward_launches, kernel.backward_launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ts = stats["state"]
        d = ts.logDir
        want = ["opt.txt", "image_quality_images.csv", "complexity.txt", "eval/0_out.png"]
        want += [f"{m.name}__opt.weights" for m in ts.models]
        missing = [f for f in want + [os.path.basename(p) for p in stats["checkpoint"]]
                   if not os.path.exists(os.path.join(d, f))]
        quality = read_quality_csv(os.path.join(d, "image_quality_images.csv"))
    losses = stats["losses"]
    step_ms = stats["step_ms"][TRAIN_WARMUP:]
    mean_ms = float(np.mean(step_ms))
    print(f"  K3 launches: forward {launches[0]}, backward {launches[1]} ({steps} steps, 2 nets); "
          f"rows per launch {sorted(set(rows))}; peak device memory {peak_gb:.2f} GB", flush=True)
    print(f"  train step {mean_ms:.3f} ms (mean of {len(step_ms)} after {TRAIN_WARMUP}; median "
          f"{float(np.median(step_ms)):.3f}, min {min(step_ms):.3f}, max {max(step_ms):.3f}) for "
          f"{sum(K3_BASELINE_ROWS)} K3 rows; each step (ms): "
          + ", ".join(f"{v:.3f}" for v in stats["step_ms"]), flush=True)
    print(f"  legs: validation {stats['legs_ms']['validate']} ms (1 image), evaluation "
          f"{stats.get('evaluate_ms', float('nan')):.1f} ms (1 image, PSNR "
          f"{quality[0]['psnr'] if quality else float('nan'):.3f} dB); files missing {missing}",
          flush=True)
    first, last = losses[:5].mean(0), losses[-5:].mean(0)
    print(f"  MSE of the first 5 steps (coarse, fine) {first.tolist()}, of the last 5 "
          f"{last.tolist()}; all finite: {bool(np.isfinite(losses).all())}", flush=True)
    if launches != (2 * steps, 2 * steps) or rows != list(K3_BASELINE_ROWS) * steps:
        raise SystemExit(f"the baseline launched K3 {launches} times at rows {sorted(set(rows))}; "
                         f"expected both nets in each of {steps} steps at {K3_BASELINE_ROWS}")
    if not (np.isfinite(losses).all() and (last < first).all()):
        raise SystemExit("the baseline's losses are not finite or did not fall")
    if missing or not quality:
        raise SystemExit(f"the baseline did not write {missing or 'its evaluation'}")
    worst_step, batch, targets, seen = step_grads_vs_plain(ts, kernel, steps + 1)
    print(f"  train step grads, K3 vs plain: worst leaf {worst_step[1]} rel {worst_step[0]:.3e} "
          f"(allowed 2e-2)", flush=True)
    if not worst_step[0] <= 2e-2 or [x.shape[0] for x in seen] != list(K3_BASELINE_ROWS):
        raise SystemExit("the baseline step's grads through K3 disagree with the plain path")
    stages = [k3_at(kernel, check, m, x, 20 + i, label)
              for i, (m, x, label) in enumerate(zip(ts.models, seen, ("coarse", "fine")))]
    del seen
    prof = profile_steps(ts, batch, targets, steps + 2)
    expected = {k: 2.0 for k in ("k3_fwd",) + BACKWARD_KERNEL_NAMES}
    print(f"  K3 kernels launched per step: {prof['k3_counts']}", flush=True)
    if prof["k3_counts"] != expected:
        raise SystemExit(f"K3 launched {prof['k3_counts']} a baseline step, expected {expected}")
    print_profile("profiled baseline step (3 steps)", prof, 10)
    per_step = len(prof["k3_launch_ms"]) // 3
    print("  each K3 launch of the last profiled step (ms, in launch order): " + ", ".join(
        f"{name} {ms:.3f}" for name, ms in prof["k3_launch_ms"][-per_step:]), flush=True)
    evaluate_ms = stats.get("evaluate_ms")
    del ts, stats, batch, targets
    torch.cuda.empty_cache()
    return dict(evaluate_ms=evaluate_ms, psnr=quality[0]["psnr"], launches=launches,
                rows=rows[:2], step_ms=mean_ms, peak_gb=peak_gb,
                step_grads_worst_rel=worst_step[0], stages=stages,
                step_device_ms=prof["device_ms"], step_k3_ms=prof["k3_ms"],
                step_wall_ms_profiled=prof["wall_ms"],
                k3_launch_ms=prof["k3_launch_ms"][-per_step:],
                first5=first.tolist(), last5=last.tolist())


def gt_leg(train, kernel):
    """Phase 16: ``adanerf_tpu_torch/configs/gt_depth_training.ini`` on
    demo/mscene (its ``*_depth.npz``) in bf16: GT_PRETRAIN epochs of the
    oracle alone on its ClassifiedDepth target (the plain path), validating
    at the last, then GT_STEPS + 1 joint steps with the NeRF through K3,
    one validation image at each validation epoch, and the ini's
    evaluation of one test image; then the batch assembly is timed and 3
    joint steps are profiled. Fails unless the pretraining loss falls, it
    saved the oracle's ``_opt`` checkpoint, K3 ran every joint step (and
    none in the pretraining) at the NeRF's rows, the NeRF's training
    samples differ from ray to ray (they follow the oracle), and every loss
    is finite."""
    pre, steps = GT_PRETRAIN, GT_STEPS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gt_") as tmp:
        argv = ["-c", GT_INI, "-data", one_image_scene(tmp), "-log", os.path.join(tmp, "logs"),
                "--bf16", "--epochsPretrain", str(pre), "--epochsPretrain", "-1",
                "--epochs", str(pre + steps + 1), "--randomSeed", "0",
                "--epochsValidate", str(pre), "--epochsRender", "1000000",
                "--epochsCheckpoint", "1000000", "--verboseEvery", "5"]
        kernel.forward_launches = kernel.backward_launches = 0
        rows, undo = record_rows(kernel)
        try:
            stats = train.main(argv)
        finally:
            undo()
        launches = (kernel.forward_launches, kernel.backward_launches)
        ts = stats["state"]
        opt_files = sorted(f for f in os.listdir(ts.logDir) if f.endswith("__opt.weights"))
        quality = read_quality_csv(os.path.join(ts.logDir, "image_quality_images.csv"))
    pretrain = stats["pretrain"][0]
    pre_losses = pretrain["losses"]
    losses = stats["losses"]
    step_ms = stats["step_ms"][TRAIN_WARMUP:]
    mean_ms = float(np.mean(step_ms))
    pre_ms = float(np.mean(pretrain["step_ms"][TRAIN_WARMUP:]))
    print(f"  pretraining: {len(pre_losses)} steps of the oracle, BCE "
          + ", ".join(f"{v:.5f}" for v in pre_losses) + f"; {pre_ms:.3f} ms a step; _opt saved "
          f"at epochs {pretrain['opt_epochs']}; validation {pretrain['validate_ms']} ms", flush=True)
    print(f"  joint: K3 launches forward {launches[0]}, backward {launches[1]} ({len(losses)} "
          f"steps) at rows {sorted(set(rows))}; step {mean_ms:.3f} ms (mean of {len(step_ms)} "
          f"after {TRAIN_WARMUP}; median {float(np.median(step_ms)):.3f}, min {min(step_ms):.3f}, "
          f"max {max(step_ms):.3f}); losses (oracle, NeRF) first {losses[0].tolist()}, last "
          f"{losses[-1].tolist()}; _opt files {opt_files}; evaluation "
          f"{stats.get('evaluate_ms', float('nan')):.1f} ms (PSNR "
          f"{quality[0]['psnr'] if quality else float('nan'):.3f} dB)", flush=True)
    if not (pre_losses[-3:].mean() < pre_losses[:3].mean() and np.isfinite(pre_losses).all()):
        raise SystemExit("the GT pretraining loss did not fall")
    if pretrain["opt_epochs"] != [pre] or len(opt_files) != 2:
        raise SystemExit("the GT pretraining did not save the oracle's _opt checkpoint")
    n = len(losses)
    if n != steps + 1 or launches != (n, n) or rows != [K3_GT_ROWS] * n:
        raise SystemExit(f"the GT leg launched K3 {launches} times at rows {sorted(set(rows))}; "
                         f"expected once in each of {steps + 1} joint steps at {K3_GT_ROWS}")
    if not np.isfinite(losses).all() or not quality:
        raise SystemExit("the GT leg's losses are not finite or it did not evaluate")
    # where a joint step's time goes: the batch assembly (the host's gather,
    # then the ClassifiedDepth target on the card) and 3 profiled steps
    idx = np.array([0, 1])
    assemble_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ts.assemble_train_batch(ts.train_dataset, idx)
        torch.cuda.synchronize()
        assemble_ms.append((time.perf_counter() - t) * 1e3)
    batch, targets = ts.assemble_train_batch(ts.train_dataset, idx)
    prof = profile_steps(ts, batch, targets, pre + steps + 1)
    print(f"  batch assembly (2 images, the ClassifiedDepth target built on the card): "
          + ", ".join(f"{v:.3f}" for v in assemble_ms) + " ms", flush=True)
    print_profile("profiled GT joint step (3 steps, batch fixed)", prof, 6)
    # the NeRF's training samples come from the oracle's bins: they differ
    # from ray to ray (a one-bin pdf would give every ray the same ones)
    from adanerf_tpu_torch.pipeline.cascade import run_cascade
    from adanerf_tpu_torch.pipeline.keys import FSK
    with torch.no_grad():
        _, dicts = run_cascade(ts.models, ts.f_in, batch, is_inference=False)
    spread = float(dicts[1][FSK.nerf_input_feature_z_vals].std(0).min())
    del dicts
    print(f"  the NeRF's training samples: the least spread of a sample slot across the "
          f"batch's rays {spread:.5f}", flush=True)
    if not spread > 1e-3:
        raise SystemExit("the GT leg's NeRF samples do not follow the oracle's depth")
    out = dict(assemble_ms=assemble_ms, step_device_ms=prof["device_ms"],
               step_k3_ms=prof["k3_ms"], step_wall_ms_profiled=prof["wall_ms"], launches=launches,
               rows=rows[0], step_ms=mean_ms, pretrain_step_ms=pre_ms,
               pretrain_losses=pre_losses.tolist(), opt_epochs=pretrain["opt_epochs"],
               evaluate_ms=stats.get("evaluate_ms"), psnr=quality[0]["psnr"],
               z_spread=spread)
    del ts, stats, batch, targets
    torch.cuda.empty_cache()
    return out


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
    l2_f = tiles_f * stream_bytes(mk.params, True, mk.width)
    l2_s = tiles_s * stream_bytes(mk.params, False, mk.width)
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


def step_grads_vs_plain(ts, kernel, epoch):
    """One train step's grads through K3 and through the plain path, same
    params and batch (train images 0 and 1; no update is applied). Returns
    ((worst leaf's max |diff| / max |plain|, its name), batch, targets, the
    rows K3's forward was given at each launch, [(N, n_in)], in order)."""
    batch, targets = ts.assemble_train_batch(ts.train_dataset, np.array([0, 1]))
    seen, launch = [], kernel.forward_kernel

    def keep_rows(self, x, packed):
        seen.append(x.detach().clone())
        return launch(self, x, packed)

    kernel.forward_kernel = keep_rows
    try:
        _, grads_k = ts.make_loss_and_grads()(batch, targets, epoch)
    finally:
        kernel.forward_kernel = launch
    ts.config_file.fusedTrainKernel = 0
    try:
        _, grads_p = ts.make_loss_and_grads()(batch, targets, epoch)
    finally:
        ts.config_file.fusedTrainKernel = 1
    errs = {f"{m.name}.{k}": rel for i, m in enumerate(ts.models)
            for k, (rel, _) in grad_errors(grads_p[i], grads_k[i]).items()}
    return max((v, k) for k, v in errs.items()), batch, targets, seen


def profile_steps(ts, batch, targets, epoch0, n=3, trace_dir=None):
    """n train steps through K3 under the profiler, device-side events only
    (an aten op's "self" device time repeats its kernels'); with
    ``trace_dir``, through ``utils/profiling.device_trace``, which also
    writes the steps' Chrome trace there (``trace_path``). Returns
    {kernels: [(ms a step, name)] longest first, device_ms and k3_ms a
    step, wall_ms a step, k3_counts: {K3 kernel: launches a step},
    k3_launch_ms: [(K3 kernel, ms)] of every launch in order}."""
    from adanerf_tpu_torch.utils.profiling import device_trace
    step = ts.make_train_step()
    torch.cuda.synchronize()
    profiler = device_trace(trace_dir) if trace_dir else torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
    with profiler as prof:
        t_prof = time.perf_counter()
        for epoch in range(epoch0, epoch0 + n):
            step(batch, targets, epoch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_prof) * 1e3 / n
    averages = prof.key_averages()
    kernels = sorted(((e.self_device_time_total / 1e3 / n, e.key) for e in averages
                      if e.self_device_time_total > 0 and e.device_type.name == "CUDA"),
                     reverse=True)
    counts = {re.search(r"k3_\w+", e.key).group(0): e.count / n for e in averages
              if e.device_type.name == "CUDA" and "k3_" in e.key}
    launch_ms = [(re.search(r"k3_\w+", e.name).group(0), e.self_device_time_total / 1e3)
                 for e in sorted(prof.events(), key=lambda e: e.time_range.start)
                 if e.device_type.name == "CUDA" and "k3_" in e.name]
    return dict(kernels=kernels, device_ms=sum(ms for ms, _ in kernels),
                k3_ms=sum(ms for ms, name in kernels if "k3_" in name), wall_ms=wall_ms,
                k3_counts=counts, k3_launch_ms=launch_ms,
                trace_path=getattr(prof, "trace_path", None))


def print_profile(label, prof, top):
    if prof["device_ms"] > 0:
        print(f"  {label}: device busy {prof['device_ms']:.3f} ms of {prof['wall_ms']:.3f} ms "
              f"wall a step ({100 * prof['device_ms'] / prof['wall_ms']:.1f}%, profiler on); "
              f"K3 kernels {prof['k3_ms']:.3f} ms, the rest "
              f"{prof['device_ms'] - prof['k3_ms']:.3f} ms", flush=True)
        for ms, name in prof["kernels"][:top]:
            print(f"    {ms:9.3f} ms  {name[:90]}", flush=True)
    else:
        print(f"  {label}: the profiler recorded no device time (not measured)", flush=True)


def k3_bounds(rows, nerf):
    """{"fwd"|"bwd": (bound ms, "operations"|"bytes", fp32 FMA ms)}: K3's
    least time at this row count, from the bf16 peak and HBM rates (each
    input read once, each output written once; the backward's products are
    the recompute, the dX chain and dW, three times the forward's)."""
    ops_f = 2.0 * rows * nerf.macs_per_input()
    nbytes_w = sum(p.numel() for p in nerf.parameters()) * 4
    out = {}
    for key, ops, nbytes in (("fwd", ops_f, rows * (90 + 4) * 4 + nbytes_w),
                             ("bwd", 3.0 * ops_f, rows * (90 + 4 + 90) * 4 + 2 * nbytes_w)):
        bo, bb = ops / PEAK_OPS["bf16"] * 1e3, nbytes / HBM_BPS * 1e3
        out[key] = (max(bo, bb), "operations" if bo >= bb else "bytes",
                    ops / PEAK_OPS["fp32"] * 1e3)
    return out


def k3_alone(width, dev):
    """Phase 18a: K3 at K3_ROWS rows on a seeded 8 x ``width`` NeRF (x in
    the encoding's range [-1, 1], the grads of mean((out - t)^2) with
    seeded targets) against its plain version, with nerf_train_check's bars
    and its caps for the width; then its times, the plain version's and
    the bounds. Returns the numbers."""
    from adanerf_tpu_torch.frame_times import time_ms
    from adanerf_tpu_torch.models.mlp import NeRFDef
    from adanerf_tpu_torch.ops.kernels import nerf_train_check
    from adanerf_tpu_torch.ops.kernels.nerf_train import NerfTrainKernel
    nerf = NeRFDef(8, width, 63, 27, 4, (4,))
    nerf.reset_parameters(torch.Generator().manual_seed(width))
    nerf = nerf.to(dev)
    k3 = NerfTrainKernel(nerf)
    rng = np.random.default_rng(width)
    x = torch.from_numpy(rng.uniform(-1, 1, (K3_ROWS, 90)).astype(np.float32)).to(dev)
    tg = torch.from_numpy(rng.standard_normal((K3_ROWS, 4)).astype(np.float32)).to(dev)
    res = nerf_train_check.compare(
        k3, x, lambda out: torch.autograd.grad(torch.mean((out - tg) ** 2), out,
                                               retain_graph=True)[0])
    torch.cuda.synchronize()
    errs = grad_errors(res["grads"]["p"], res["grads"]["k"])
    fwd_abs = float((res["out"]["k"] - res["out"]["p"]).abs().max())
    bwd_abs = max(v[1] for v in errs.values())
    ok, lines = nerf_train_check.verdict(res)
    print(f"  K3 at width {width}, {K3_ROWS} rows, seeded weights and inputs, MSE:\n    "
          + "\n    ".join(lines + res["report"][-3:]), flush=True)
    if not ok or res["launched"] != (1, 1):
        raise SystemExit(f"K3 at width {width} disagrees with its plain version")
    del res
    g = (2.0 / (K3_ROWS * 4)) * (k3.plain(x).detach() - tg)  # the MSE's cotangent
    packed = k3.pack(dict(nerf.named_parameters()), dev)
    ms_f = time_ms(lambda: k3.forward_kernel(x, packed), 5)
    ms_b = time_ms(lambda: k3.backward_kernel(x, g, packed), 3)
    with torch.no_grad():
        ms_pf = time_ms(lambda: k3.plain(x), 3)
    xr = x.clone().requires_grad_(True)
    out_graph = k3.plain(xr)
    leaves = [p for _, p in nerf.named_parameters()]
    ms_pb = time_ms(lambda: torch.autograd.grad(out_graph, [xr] + leaves, g, retain_graph=True), 2)
    del out_graph, xr, packed, x, tg, g
    bounds = k3_bounds(K3_ROWS, nerf)
    print(f"  K3 at width {width}: forward {ms_f:.3f} ms (bound {bounds['fwd'][0]:.3f}, "
          f"{bounds['fwd'][1]}), backward {ms_b:.3f} ms (bound {bounds['bwd'][0]:.3f}, "
          f"{bounds['bwd'][1]}); plain forward {ms_pf:.3f} ms, plain backward {ms_pb:.3f} ms; "
          f"{nerf.macs_per_input()} multiply-adds a row forward", flush=True)
    torch.cuda.empty_cache()
    return dict(fwd_ms=ms_f, bwd_ms=ms_b, plain_fwd_ms=ms_pf, plain_bwd_ms=ms_pb,
                bound_fwd_ms=bounds["fwd"][0], bound_bwd_ms=bounds["bwd"][0],
                bound_fwd_by=bounds["fwd"][1], bound_bwd_by=bounds["bwd"][1],
                max_abs_err_fwd=fwd_abs, max_abs_err_bwd=bwd_abs,
                worst_leaf_rel_err=max(v[0] for k, v in errs.items() if k != "x"))


def width_runs(train, kernel, width, log_dir, extra=()):
    """Phase 18b: ``configs/dense_training.ini`` with both nets
    ``--layerWidth width`` on demo/mscene (val and test cut to one image),
    bf16, WIDTH_DENSE_STEPS steps validating at the last, then
    ``configs/fine_training.ini`` at the same width from its ``_opt``
    checkpoints (the teacher its regex derives) for FINE_STEPS steps,
    validating at the last. K3's launches are counted from 0 for each run
    and must equal its steps; each run's NeRF loss must fall. Returns
    (numbers, the fine run's state, its trained weights as flat dicts, its
    arguments)."""
    from adanerf_tpu_torch.utils.weights import to_flat
    scene = one_image_scene(log_dir)
    logs = os.path.join(log_dir, "logs")
    wide = ["--layerWidth", str(width), "--layerWidth", str(width), "--randomSeed", "0",
            "--bf16", "--epochsRender", "1000000", "--epochsVideo", "-1",
            "--epochsCheckpoint", "1000000", "--no-performEvaluation", "--verboseEvery", "5",
            *extra]
    out = {}
    runs = (("dense", DENSE_INI, WIDTH_DENSE_STEPS,
             ["--epochsLockWeightsBefore", "-1", "--epochsLockWeightsBefore", "-1"]),
            ("fine", FINE_INI, FINE_STEPS, ["--preTrained", os.path.join(logs, "mscene")] * 2))
    for name, ini, steps, more in runs:
        argv = ["-c", ini, "-data", scene, "-log", logs, "--epochs", str(1 + steps),
                "--epochsValidate", str(steps)] + wide + more
        kernel.forward_launches = kernel.backward_launches = 0
        kernel.forward_rows = None
        stats = train.main(argv)
        launches = (kernel.forward_launches, kernel.backward_launches)
        ts = stats["state"]
        mse = stats["losses"][:, 1]
        k = max(1, steps // 4)
        step_ms = stats["step_ms"][min(TRAIN_WARMUP, steps - 1):]
        opt = sorted(f for f in os.listdir(ts.logDir) if "__opt." in f)
        widths = [getattr(m, "width", None) for m in ts.models]
        print(f"  {name} run at width {width} ({ts.logDir.rstrip('/').split('/')[-1]}): nets "
              f"{widths}; K3 launches forward {launches[0]}, backward {launches[1]} ({steps} "
              f"steps) at {kernel.forward_rows} rows; step {float(np.mean(step_ms)):.3f} ms "
              f"(mean of {len(step_ms)}); NeRF loss mean of the first {k} steps "
              f"{float(mse[:k].mean()):.6f}, of the last {k} {float(mse[-k:].mean()):.6f}; "
              f"_opt files {opt}", flush=True)
        if launches != (steps, steps) or widths != [width, width]:
            raise SystemExit(f"the {name} run at width {width} launched K3 {launches} times, "
                             f"expected {steps}, or its nets are {widths}")
        if not (np.isfinite(stats["losses"]).all() and mse[-k:].mean() < mse[:k].mean()):
            raise SystemExit(f"the {name} run's loss at width {width} did not fall")
        if len(opt) != 2 * len(ts.models):
            raise SystemExit(f"the {name} run at width {width} wrote no _opt checkpoints")
        if name == "fine" and ts.teacher_experiment_name() != out["dense"]["name"]:
            raise SystemExit(f"the fine run's teacher {ts.teacher_experiment_name()} is not the "
                             f"dense run {out['dense']['name']}")
        out[name] = dict(name=os.path.basename(ts.logDir.rstrip("/")), launches=launches,
                         rows=kernel.forward_rows,
                         step_ms=float(np.mean(step_ms)), loss_first=float(mse[:k].mean()),
                         loss_last=float(mse[-k:].mean()))
    return out, ts, [to_flat(m) for m in ts.models], argv


def fine_leg(train, port_test, kernel, check, log_dir, dense_dir):
    """Phase 9b: ``configs/fine_training.ini`` as shipped, in bf16 through
    K3, bootstrapped from the dense leg's ``_opt`` checkpoints through the
    teacher name its regex derives, for FINE_STEPS steps; the last epoch
    renders, writes a video, validates (and saves ``_opt``), and the run
    evaluates as the ini asks. Then K3 at the rows the leg gave it: one
    step's grads against the plain path's, the kernel against its plain
    version (``nerf_train_check``) on that step's NeRF inputs, its times
    and a profile of 3 steps; and ``python -m adanerf_tpu_torch.test`` on
    the run. Fails unless every loss is finite, K3 ran every step, every
    check holds and the legs' and the offline render's files exist.
    Returns (numbers, the run's state, its trained weights as flat dicts,
    the arguments of the run)."""
    from adanerf_tpu_torch.frame_times import time_ms
    from adanerf_tpu_torch.ops.kernels.nerf_train import BACKWARD_KERNEL_NAMES
    from adanerf_tpu_torch.utils.weights import to_flat
    steps = FINE_STEPS
    teachers = os.path.join(log_dir, "mscene")
    argv = ["-c", FINE_INI, "-data", MSCENE_DATA, "-log", log_dir, "--bf16",
            "--epochs", str(1 + steps), "--randomSeed", "0",
            "--preTrained", teachers, "--preTrained", teachers,
            "--epochsRender", str(steps), "--epochsValidate", str(steps),
            "--epochsVideo", str(steps), "--epochsCheckpoint", "1000000",
            # demo/mscene has no camera path file: a 4-frame orbit in the view cell
            "--camType", "RotatingCamera", "--camCenter", "0", "--camCenter", "0",
            "--camCenter", "3", "--camRadius", "0.3", "--videoFrames", "4",
            "--verboseEvery", "5"]
    kernel.forward_launches = kernel.backward_launches = 0
    kernel.forward_rows = None
    stats = train.main(argv)
    launches = (kernel.forward_launches, kernel.backward_launches)
    rows = kernel.forward_rows
    ts = stats["state"]
    # the run's weights as training left them (phase 9c exports them; the
    # profiled steps below move the live modules on)
    trained = [to_flat(m) for m in ts.models]
    teacher = ts.teacher_experiment_name()
    dense_name = os.path.basename(dense_dir.rstrip("/"))
    print(f"  teacher from the fine run's name: {teacher}; the dense leg's: {dense_name}; "
          f"same: {teacher == dense_name}", flush=True)
    if teacher != dense_name:
        raise SystemExit("the fine leg's regex-derived teacher is not the dense leg's run")
    losses = stats["losses"]
    step_ms = stats["step_ms"][TRAIN_WARMUP:]
    fine_ms = float(np.mean(step_ms))
    n_val, n_test = len(ts.valid_dataset), len(ts.test_dataset)
    legs = stats["legs_ms"]
    val_ms = legs["validate"][0] / n_val if legs["validate"] else float("nan")
    print(f"  K3 launches on the fine leg: forward {launches[0]}, backward {launches[1]} "
          f"({steps} steps) at {rows} rows", flush=True)
    print(f"  fine train step {fine_ms:.3f} ms at {rows} rows (mean of {len(step_ms)} after "
          f"{TRAIN_WARMUP}; median {float(np.median(step_ms)):.3f}, min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}), {rows / fine_ms / 1e3:.3f} M shading rows/s; each step (ms): "
          + ", ".join(f"{v:.3f}" for v in stats["step_ms"]), flush=True)
    print(f"  legs (not in the step times): render {legs['render']} ms, video {legs['video']} ms, "
          f"validation {legs['validate']} ms = {val_ms:.1f} ms per image ({n_val} images); "
          f"evaluation {stats.get('evaluate_ms', float('nan')):.1f} ms ({n_test} test images)",
          flush=True)
    print(f"  MSE of the first 5 steps {float(losses[:5, 1].mean()):.6f}, of the last 5 "
          f"{float(losses[-5:, 1].mean()):.6f}; all losses finite: "
          f"{bool(np.isfinite(losses).all())}", flush=True)
    # where a validation image's time goes: one more render of it under the
    # profiler, device-side events only
    from adanerf_tpu_torch.render import render_rays_chunked
    vd = ts.valid_dataset
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t_prof = time.perf_counter()
        render_rays_chunked(ts, vd.poses[0], vd.rotations[0], ts.config_file.inferenceChunkSize,
                            collect=["NeRFWeightsOutput"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_prof) * 1e3
    events = sorted(((e.self_device_time_total / 1e3, e.key) for e in prof.key_averages()
                     if e.self_device_time_total > 0 and e.device_type.name == "CUDA"),
                    reverse=True)
    busy = sum(ms for ms, _ in events)
    print(f"  one validation image ({ts.h}x{ts.w}, chunks of {ts.config_file.inferenceChunkSize} "
          f"rays) under the profiler: device busy {busy:.3f} ms of {wall_ms:.3f} ms wall "
          f"({100 * busy / wall_ms:.1f}%); top device events: "
          + "; ".join(f"{ms:.3f} ms {name[:60]}" for ms, name in events[:6]), flush=True)
    del prof
    d = ts.logDir
    e = f"{steps:07d}"
    want = [f"{e}_0.png", f"{e}_1.png", f"{e}_1_train_targets.png", f"{e}_estimated_depth.png",
            f"{e}_nerf_weights.png", f"{e}_oracle_weights.png", f"{e}_oracle_histogram.png",
            f"{e}_0_frames/00003.png", f"{e}_1_frames/00003.png", "opt.txt",
            "complexity.txt", "network_description.txt", "image_quality_images.csv",
            "image_quality_images.txt", "logs.csv", "logs.txt", "eval/opt.txt"]
    want += [f"{m.name}__opt.weights" for m in ts.models]
    want += [f"opt/val/_{net}_{i}.png" for net in range(len(ts.models)) for i in range(n_val)]
    want += [f"eval/{i}_out.png" for i in range(n_test)]
    missing = [f for f in want if not os.path.exists(os.path.join(d, f))]
    flips = sorted(f for f in os.listdir(os.path.join(d, "eval")) if "_flip_" in f)
    adaptive = os.path.exists(os.path.join(d, e + "_adaptive_samples.png"))
    print(f"  files: {len(want) - len(missing)} of {len(want)} expected present; "
          f"{e}_adaptive_samples.png: {adaptive}; "
          f"eval flip images {len(flips)}; opt.txt: {open(os.path.join(d, 'opt.txt')).read()!r}",
          flush=True)
    if missing or len(flips) != n_test:
        raise SystemExit(f"the fine leg did not write {missing or 'its flip images'}")
    if launches != (steps, steps):
        raise SystemExit(f"the fine leg launched K3 {launches} times, expected {steps}")
    if rows != K3_FINE_ROWS:
        raise SystemExit(f"the fine leg ran K3 at {rows} rows, expected {K3_FINE_ROWS}")
    if not np.isfinite(losses).all():
        raise SystemExit("the fine leg's losses are not all finite")

    # K3 at the fine leg's shape: one step's grads through K3 and through
    # the plain path, then the kernel against its plain version on the NeRF
    # inputs of that step, with a mean loss's cotangent
    worst_step, batch, targets, (x,) = step_grads_vs_plain(ts, kernel, steps + 1)
    print(f"  fine train step grads, K3 vs plain: worst leaf {worst_step[1]} rel "
          f"{worst_step[0]:.3e} (allowed 2e-2)", flush=True)
    if not worst_step[0] <= 2e-2:
        raise SystemExit("the fine step's grads through K3 disagree with the plain path")
    k3 = kernel(ts.models[-1])
    g = torch.from_numpy(np.random.default_rng(10).standard_normal((x.shape[0], 4)).astype(
        np.float32)).to(x.device) / (x.shape[0] * 4)
    res = check.compare(k3, x, lambda out: g)
    torch.cuda.synchronize()
    out_k, out_p = res["out"]["k"], res["out"]["p"]
    fwd_abs = float((out_k - out_p).abs().max())
    bwd_abs = max(float((a - res["grads"]["k"][n]).abs().max())
                  for n, a in res["grads"]["p"].items())
    ok, lines = check.verdict(res, scale=float(out_p.abs().max()))
    print(f"  K3 vs plain on the fine step's {x.shape[0]} NeRF input rows:\n    "
          + "\n    ".join(lines + res["report"]), flush=True)
    if not ok:
        raise SystemExit("K3 disagrees with its plain version at the fine leg's shape")
    del res, out_k, out_p
    packed = k3.pack(dict(k3.nerf.named_parameters()), x.device)
    ms_f = time_ms(lambda: k3.forward_kernel(x, packed), 10)
    ms_b = time_ms(lambda: k3.backward_kernel(x, g, packed), 10)
    with torch.no_grad():
        ms_pf = time_ms(lambda: k3.plain(x), 10)
    xr = x.clone().requires_grad_(True)
    out_graph = k3.plain(xr)
    leaves = [p for _, p in k3.nerf.named_parameters()]
    ms_pb = time_ms(lambda: torch.autograd.grad(out_graph, [xr] + leaves, g, retain_graph=True),
                    10)
    del out_graph, xr, packed
    bounds = k3_bounds(x.shape[0], k3.nerf)
    print(f"  K3 at {x.shape[0]} rows: forward {ms_f:.3f} ms, backward {ms_b:.3f} ms; plain "
          f"forward {ms_pf:.3f} ms, plain backward {ms_pb:.3f} ms; bounds {bounds['fwd'][0]:.3f} "
          f"/ {bounds['bwd'][0]:.3f} ms", flush=True)
    prof = profile_steps(ts, batch, targets, steps + 2)
    expected = {k: 1.0 for k in ("k3_fwd",) + BACKWARD_KERNEL_NAMES}
    print(f"  K3 kernels launched per fine step: {prof['k3_counts']}", flush=True)
    if prof["k3_counts"] != expected:
        raise SystemExit(f"K3 launched {prof['k3_counts']} a fine step, expected {expected}")
    print_profile("profiled fine step (3 steps)", prof, 8)
    del batch, targets, x, g, k3

    # the offline render of the run: python -m adanerf_tpu_torch.test
    t = time.perf_counter()
    psnrs = port_test.main(argv)
    torch.cuda.synchronize()
    test_ms = (time.perf_counter() - t) * 1e3
    splits = {"train": ts.train_dataset, "val": ts.valid_dataset, "test": ts.test_dataset}
    absent = []
    for name, ds in splits.items():
        for f in ds.image_filenames:
            base = os.path.splitext(os.path.basename(f))[0]
            absent += [p for p in (f"1_{base}.png", f"{base}_estimated_depth.png",
                                   f"{base}_depth.npz", f"{base}_weights.trch.npy")
                       if not os.path.exists(os.path.join(d, "test_images", name, p))]
    n_img = sum(len(ds) for ds in splits.values())
    print(f"  offline render (adanerf_tpu_torch.test): {n_img} images in {test_ms:.1f} ms; mean "
          f"PSNR " + ", ".join(f"{k} {float(np.mean(v)):.3f} dB" for k, v in psnrs.items())
          + f"; files missing {len(absent)}", flush=True)
    if absent or any(len(psnrs[k]) != len(ds) or not np.isfinite(psnrs[k]).all()
                     for k, ds in splits.items()):
        raise SystemExit(f"the offline render did not write {absent[:4]} or its PSNRs")
    return dict(launches=launches, step_ms=fine_ms, rows=rows, val_ms_per_image=val_ms,
                evaluate_ms=stats.get("evaluate_ms"), val_image_device_busy_ms=busy,
                val_image_wall_ms=wall_ms, step_grads_worst_rel=worst_step[0],
                k3_fwd_ms=ms_f, k3_bwd_ms=ms_b, plain_fwd_ms=ms_pf, plain_bwd_ms=ms_pb,
                bound_fwd_ms=bounds["fwd"][0], bound_bwd_ms=bounds["bwd"][0],
                max_abs_err_fwd=fwd_abs, max_abs_err_bwd=bwd_abs,
                step_device_ms=prof["device_ms"], step_k3_ms=prof["k3_ms"],
                step_wall_ms_profiled=prof["wall_ms"], test_ms=test_ms,
                test_images=n_img), ts, trained, argv


def export_leg(port_export, viewer, ts, trained, argv, dev):
    """Phase 9c: ``python -m adanerf_tpu_torch.export`` on phase 9b's fine
    run (its ``_opt`` checkpoints, the default ``--checkPointName``), then
    the export in both viewers' roles: every file present; the
    ``model{i}.weights`` equal to the trained weights and the ONNX files
    read back to the same arrays, bit for bit; the export's plain fp32
    render of a 400x400 test pose within 1e-5 of the trainer-side plain
    renderer built from the trained modules (the JAX package's bar,
    ``tests/test_export_viewer.py``); K1 against its plain version in fp32
    (``check_fp32``) and in bf16 at 800x800 (>= 40 dB against plain fp32,
    timed); K2 in fp32 as phase 10 holds it and in bf16 at 800x800 (bit for
    bit K1's bf16 frame, timed); and the viewer CLI on the export through
    K1 and, ``--megakernel v3``, K2, each path's launches counted from 0.
    On an NDC export, which K2 refuses as JAX's does, the viewer's
    ``--megakernel v3`` must refuse the export instead. Returns the phase's
    numbers."""
    from adanerf_tpu_torch.frame_times import frame_ms, time_ms
    from adanerf_tpu_torch.ops.kernels.megakernel_compact import MegakernelCompact
    from adanerf_tpu_torch.ops.kernels.megakernel_dense import MegakernelDense
    from adanerf_tpu_torch.realtime import RealtimeRenderer
    from adanerf_tpu_torch.train_state import load_tree
    from adanerf_tpu_torch.utils.onnx_weights import load_onnx_weights
    from adanerf_tpu_torch.utils.torch_ckpt import flat_from_state_dict
    from adanerf_tpu_torch.utils.weights import load_flat

    t = time.perf_counter()
    out = port_export.main(argv)
    export_s = time.perf_counter() - t
    names = ["dataset_info.txt", "pos_enc.txt", "config.ini", "model0.weights",
             "model1.weights", "model0.onnx", "model1.onnx"]
    missing = [n for n in names if not os.path.exists(os.path.join(out, n))]
    equal_w, equal_onnx = [], []
    for i, want in enumerate(trained):
        for got, flags in ((load_tree(os.path.join(out, f"model{i}.weights")), equal_w),
                           (flat_from_state_dict(load_onnx_weights(
                               os.path.join(out, f"model{i}.onnx")), out), equal_onnx)):
            flags.append(set(got) == set(want) and all(np.array_equal(got[k], want[k])
                                                        for k in want))
    print(f"  export of the fine run in {export_s:.1f} s to {out}: {sorted(os.listdir(out))}; "
          f"missing {missing}; model{{0,1}}.weights equal to the trained weights bit for bit: "
          f"{equal_w}; model{{0,1}}.onnx read back (transposed to (in, out)) equal: "
          f"{equal_onnx}", flush=True)
    if missing or not all(equal_w + equal_onnx):
        raise SystemExit("the export of the fine run is incomplete or differs from the trained "
                         "weights")

    rt32, scene = viewer.build_renderer_from_export(out, dtype_str="fp32", device=dev)
    with_k2 = not rt32.use_ndc
    live = [load_flat(copy.deepcopy(m), w) for m, w in zip(ts.models, trained)]
    rt_live = RealtimeRenderer(live[0], live[1], ts.scene, ts.config_file, dtype=None,
                               device=dev)
    pose, rot = ts.test_dataset.poses[0], ts.test_dataset.rotations[0]
    dirs400 = viewer.frame_directions(scene, 400, 400, dev)
    same_dirs = bool(torch.equal(dirs400.cpu(), torch.from_numpy(ts.test_dataset.directions)))
    img_exp, cnt_exp = rt32.render_frame(pose, rot, dirs400)
    img_live, cnt_live = rt_live.render_frame(pose, rot, dirs400)
    load_err = float((img_exp - img_live).abs().max())
    print(f"  the export's plain fp32 render vs the trainer-side plain renderer of the trained "
          f"modules, test pose 0, 400x400: rgb max abs err {load_err:.3e} (allowed 1e-5), count "
          f"mismatches {int((cnt_exp != cnt_live).sum())}; S={rt32.max_samples}, threshold "
          f"{rt32.threshold}, samples/px {float(cnt_exp.float().mean()):.4f}; the viewer's rays "
          f"are the test split's: {same_dirs}", flush=True)
    if not load_err <= 1e-5:
        raise SystemExit("the export renders otherwise than the trained modules")
    del live, rt_live, img_live, cnt_live

    # A barely trained oracle keeps all S bins of most rays, and which S of
    # its 128 bins pass is decided by logits that may lie within rounding
    # of each other: at equal counts a ray may keep other bins in the
    # kernel than in the plain version. So K1 is held as K2 is (check_slots):
    # within 2e-4 where both keep the same bins, every other ray at a near
    # tie, and every ray within 2e-4 of a float64 shading of its own slots.
    # Its logits near 1.1 carry fp32 roundings beyond NEAR (the kernel's up
    # to 4.3e-5), so float64 logits referee the ties; at most 1 ray in 1,000
    # may keep other bins (28 of 160,000 did on the card).
    mk32 = MegakernelCompact(rt32)
    tie_rays = dirs400.shape[0] // 1000
    k1_32 = check_slots(mk32, dirs400, pose, rot, "K1 fp32 on the fine export",
                        allowed=tie_rays, referee=True)
    del k1_32["rgb"], k1_32["counts"]
    rt16, _ = viewer.build_renderer_from_export(out, dtype_str="bf16", device=dev)
    mk16 = MegakernelCompact(rt16)
    dirs800 = viewer.frame_directions(scene, 800, 800, dev)
    n_pix = dirs800.shape[0]
    S = mk16.params.S
    rgb_k1, cnt_k1 = mk16(dirs800, pose, rot)
    o_k, d_k, z_k, p_k, c_k = mk16.front(dirs800, pose, rot)
    live_k = torch.arange(S, device=dev)[None, :] < c_k[:, None]
    rgb_f, _ = rt32.render_frame(pose, rot, dirs800)
    pose_t = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    rot_t = torch.as_tensor(rot, dtype=torch.float32, device=dev)
    with torch.no_grad():
        stages = [rt32._oracle_stage(pose_t, rot_t, dirs800[c:c + 80_000])
                  for c in range(0, n_pix, 80_000)]
    z_f, mask_f = torch.cat([st[2] for st in stages]), torch.cat([st[4] for st in stages])
    del stages
    same_bins = ~(kept_bins(rt32, z_k, live_k) ^ kept_bins(rt32, z_f, mask_f)).any(1)
    p16 = psnr(rgb_k1, rgb_f)
    p16_same = psnr(rgb_k1[same_bins], rgb_f[same_bins]) if bool(same_bins.any()) \
        else float("nan")
    p16_64 = psnr(rgb_k1, float64_frame(rt32, o_k, d_k, z_k, p_k, live_k).float())
    del rgb_f, o_k, d_k, z_k, p_k, c_k, z_f, mask_f
    spp = float(cnt_k1.float().mean())
    at_cap = float((cnt_k1 == S).float().mean())
    fr = frame_ms(mk16, dirs800, pose, rot)
    k1_plain_ms = time_ms(lambda: rt16.render_frame(pose_t, rot_t, dirs800), 1)
    n_same = int(same_bins.sum())
    print(f"  K1 bf16 on the fine export, 800x800: vs plain fp32 {p16:.2f} dB (allowed >= 40); "
          f"{p16_same:.2f} dB on the {n_same} of {n_pix} rays keeping plain fp32's bins (where "
          f"logits lie within a bf16 rounding of each other, bf16 keeps other bins); vs a "
          f"float64 shading of its own slots {p16_64:.2f} dB (allowed >= 40); "
          f"{fr['ms']:.3f} ms/frame (front {fr['front_ms']:.3f}, front+shade "
          f"{fr['front_shade_ms']:.3f}), plain bf16 {k1_plain_ms:.3f} ms; samples/px {spp:.4f} "
          f"of S={S}, at cap {100 * at_cap:.2f}%", flush=True)
    if not (p16 >= 40.0 and p16_64 >= 40.0 and bool(torch.isfinite(rgb_k1).all())):
        raise SystemExit("K1 bf16 on the fine export below 40 dB against plain fp32 or a "
                         "float64 shading of its own slots")

    k2_numbers = {}
    if with_k2:
        k2_err, k2_err_k1, _, _ = check_dense(MegakernelDense(rt32), mk32, dirs400, pose, rot,
                                              "K2 fp32 on the fine export", allowed=tie_rays,
                                              referee=True)
        k2 = MegakernelDense(rt16)
        rgb_k2, cnt_k2 = k2(dirs800, pose, rot)
        same = bool(torch.equal(rgb_k2, rgb_k1) and torch.equal(cnt_k2, cnt_k1))
        fr2 = frame_ms(k2, dirs800, pose, rot)
        # the dense plain path shades all S=16 slots of every ray: in the viewer's
        # chunks of 80,000 rays, as a whole frame would not fit the card
        k2_plain_ms = time_ms(lambda: [k2.plain(dirs800[c:c + 80_000], pose_t, rot_t)
                                       for c in range(0, n_pix, 80_000)], 1)
        print(f"  K2 bf16 on the fine export, 800x800: {fr2['ms']:.3f} ms/frame (front "
              f"{fr2['front_ms']:.3f}, front+shade {fr2['front_shade_ms']:.3f}), plain dense "
              f"bf16 {k2_plain_ms:.3f} ms (chunks of 80,000 rays); equal to K1 bf16 bit for "
              f"bit: {same}", flush=True)
        if not same:
            raise SystemExit("K2 bf16 differs from K1 bf16 on the fine export")
        k2_numbers = dict(k2_fp32_err=k2_err, k2_fp32_err_vs_k1=k2_err_k1, k2_ms=fr2["ms"],
                          k2_plain_ms=k2_plain_ms)
        del k2, rgb_k2, cnt_k2
    else:  # K2, as the JAX make_megakernel, refuses the NDC ray transform
        MegakernelDense.launches = 0
        try:
            viewer.main([out, "-s", "64", "64", "-n", "1", "--megakernel", "v3"])
            refused = None
        except (SystemExit, ValueError) as err:
            refused = str(err)
        print(f"  viewer --megakernel v3 on the export: refused: {refused!r}; "
              f"MegakernelDense launches {MegakernelDense.launches}", flush=True)
        if not refused or "NDC" not in refused or MegakernelDense.launches:
            raise SystemExit("the viewer's --megakernel v3 did not refuse the NDC export")
        k2_numbers = dict(v3_refused=refused)
    del rgb_k1, cnt_k1

    # the viewer CLI on the export, each kernel's launches counted from 0
    oracle_macs, nerf_macs = rt16.oracle.macs_per_input(), rt16.nerf.macs_per_input()
    views = {}
    routes = ((MegakernelCompact, []), (MegakernelDense, ["--megakernel", "v3"]))
    for cls, extra in routes[:2 if with_k2 else 1]:
        cls.launches = 0
        st = viewer.main([out, "-s", "800", "800", "-n", "5"] + extra)
        views[cls.__name__] = (cls.launches, st)
        print(f"  viewer {' '.join(extra) or '(K1)'} on the export: {cls.__name__} launches "
              f"{cls.launches}, device {st['device_ms_per_frame']:.3f} ms a frame (median "
              f"{st['device_ms_median']:.3f}), samples/px {st['samples_per_pixel']:.4f}",
              flush=True)
        if cls.launches < 1 or not torch.isfinite(st["last_frame"]).all():
            raise SystemExit(f"the viewer on the export never launched {cls.__name__} or "
                             "rendered non-finite values")
    # the least time of the frame's function, K1's and K2's alike: the NeRF
    # at the live samples only (a dead slot adds exact zeros), as phases 7 and 11
    ops = 2.0 * (n_pix * oracle_macs + spp * n_pix * nerf_macs)
    nbytes = n_pix * 12 + 12 + 36 + mk16.weights.numel() * mk16.weights.element_size() \
        + mk16.biases.numel() * 4 + n_pix * (12 + 4)
    bo, bb = ops / PEAK_OPS["bf16"] * 1e3, nbytes / HBM_BPS * 1e3
    bound = max(bo, bb)
    print(f"  bound (live samples): {ops / 1e12:.4f} TFLOP over the bf16 peak = {bo:.3f} ms; "
          f"{nbytes / 1e6:.2f} MB over 3.35 TB/s = {bb:.4f} ms; K1 at {100 * bound / fr['ms']:.2f}%"
          + (f", K2 at {100 * bound / k2_numbers['k2_ms']:.2f}%" if with_k2 else ""), flush=True)
    del rt32, rt16, mk32, mk16, dirs800
    torch.cuda.empty_cache()
    if with_k2:
        k2_numbers.update(k2_launches=views["MegakernelDense"][0],
                          k2_viewer_ms=views["MegakernelDense"][1]["device_ms_per_frame"])
    return dict(export_s=export_s, load_err=load_err, k1_fp32=k1_32,
                k1_psnr_fp32=p16, k1_psnr_fp32_same_bins=p16_same, k1_rays_same_bins=n_same,
                k1_psnr_float64_own_slots=p16_64, k1_ms=fr["ms"], k1_front_ms=fr["front_ms"],
                k1_front_shade_ms=fr["front_shade_ms"], k1_plain_ms=k1_plain_ms,
                spp=spp, at_cap=at_cap, bound_ms=bound,
                bound_by="operations" if bo >= bb else "bytes",
                k1_launches=views["MegakernelCompact"][0],
                k1_viewer_ms=views["MegakernelCompact"][1]["device_ms_per_frame"], **k2_numbers)


def jax_ndc_run():
    """The committed JAX fine NDC run (threshold 0.15) in demo/ndclogs."""
    names = [n for n in os.listdir(NDC_LOGS) if "LSfCDA_(0.15)" in n]
    if len(names) != 1:
        raise SystemExit(f"expected one fine NDC run in {NDC_LOGS}, found {names}")
    return os.path.join(NDC_LOGS, names[0])


def decode_check():
    """Phase 19a: the port's JPEG decoder against imageio's committed
    pixels (tests/torch_fixtures/jpeg), at most 1 level on at most 0.1% of
    the values (the CPU tests' bar), and the host time of decoding the 32
    images of demo/llff_scene_jpeg."""
    from adanerf_tpu_torch.data.jpeg import read_jpeg
    names = sorted(f for f in os.listdir(JPEG_FIXTURES) if f.endswith(".jpg"))
    n_off, worst, n_values = 0, 0, 0
    for name in names:
        got = read_jpeg(os.path.join(JPEG_FIXTURES, name))
        want = np.load(os.path.join(JPEG_FIXTURES, name[:-4] + ".npy"))
        if got.shape != want.shape:
            raise SystemExit(f"{name} decodes to {got.shape}, imageio to {want.shape}")
        d = np.abs(got.astype(np.int16) - want)
        n_off, worst, n_values = n_off + int((d > 0).sum()), max(worst, int(d.max())), \
            n_values + d.size
    images = sorted(os.listdir(os.path.join(LLFF_JPEG, "images")))
    t = time.perf_counter()
    decoded = [read_jpeg(os.path.join(LLFF_JPEG, "images", f)) for f in images]
    decode_s = time.perf_counter() - t
    print(f"  JPEG fixtures: {len(names)} files, {n_off} of {n_values} values differ from "
          f"imageio's, max {worst}; demo/llff_scene_jpeg: {len(images)} images "
          f"{decoded[0].shape} decoded in {decode_s:.3f} s (host CPU, "
          f"{1e3 * decode_s / len(images):.1f} ms an image)", flush=True)
    if len(names) < 6 or worst > 1 or n_off > n_values // 1000 or len(images) != 32:
        raise SystemExit("the JPEG decoder disagrees with imageio's committed pixels")
    return dict(fixtures=len(names), values_differing=n_off, max_diff=worst,
                llff_images=len(images), llff_decode_s=decode_s)


def convert_check(tmp):
    """Phase 19b: ``python -m adanerf_tpu_torch.convert_llff`` on copies of
    demo/llff_scene_jpeg. At -factor 1 the JSON files equal demo/llff_scene's
    and the split images' mean PSNR against that PNG conversion equals the
    pinned CPU reading (tests/torch_fixtures/llff_jpeg.json) within its
    bar; at -factor 2 (the area resize) the focal length and the image size
    halve. Returns (the numbers, the factor-1 scene)."""
    import shutil
    from adanerf_tpu_torch import convert_llff
    from adanerf_tpu_torch.data.png import read_png
    with open(LLFF_PINNED) as f:
        pinned = json.load(f)
    scenes, infos = {}, {}
    for factor in (1, 2):
        d = os.path.join(tmp, f"llff_jpeg_f{factor}")
        shutil.copytree(LLFF_JPEG, d)
        convert_llff.main(["-dir", d, "-factor", str(factor)])
        scenes[factor] = d
        with open(os.path.join(d, "dataset_info.json")) as f:
            infos[factor] = json.load(f)
    jsons = ["dataset_info.json", "cam_path_spiral.json", "transforms_train.json",
             "transforms_val.json", "transforms_test.json"]
    same_json = []
    for n in jsons:
        with open(os.path.join(scenes[1], n)) as a, open(os.path.join(LLFF_PNG, n)) as b:
            same_json.append(json.load(a) == json.load(b))
    psnrs = []
    for split in ("train", "val", "test"):
        for f in sorted(os.listdir(os.path.join(LLFF_PNG, split))):
            a = read_png(os.path.join(scenes[1], split, f)).astype(np.float64) / 255
            b = read_png(os.path.join(LLFF_PNG, split, f)).astype(np.float64) / 255
            psnrs.append(10 * np.log10(1.0 / np.mean((a - b) ** 2)))
    mean = float(np.mean(psnrs))
    focal = {k: v["resolution"][0] / 2 / math.tan(v["camera_angle_x"] / 2)
             for k, v in infos.items()}
    print(f"  convert_llff -factor 1: JSON files equal demo/llff_scene's: "
          f"{dict(zip(jsons, same_json))}; split images' mean PSNR against the PNG "
          f"conversion {mean:.6f} dB over {len(psnrs)} images (pinned CPU reading "
          f"{pinned['mean_psnr_db']:.6f}, bar {pinned['bar_db']}); -factor 2: resolution "
          f"{infos[2]['resolution']} (from {infos[1]['resolution']}), focal {focal[2]:.4f} "
          f"(from {focal[1]:.4f})", flush=True)
    if not all(same_json) or len(psnrs) != pinned["images"] \
            or abs(mean - pinned["mean_psnr_db"]) > pinned["bar_db"]:
        raise SystemExit("the JPEG scene's conversion differs from the PNG scene's")
    if infos[2]["resolution"] != [r // 2 for r in infos[1]["resolution"]] \
            or abs(focal[2] - focal[1] / 2) > 1e-4 * focal[1]:
        raise SystemExit("-factor 2 did not halve the image size and the focal length")
    return dict(json_equal=all(same_json), mean_psnr_vs_png_db=mean, images=len(psnrs),
                factor2_resolution=infos[2]["resolution"]), scenes[1]


def score(ts, out_dir, epoch):
    """The port's validation loss (``train.validate_batch``, its logs
    written under out_dir) and test PSNRs (``evaluation.evaluate``, images
    and psnr) of the weights in ts.models."""
    from adanerf_tpu_torch import train
    from adanerf_tpu_torch.evaluation.evaluate import evaluate
    os.makedirs(out_dir, exist_ok=True)
    log_dir = ts.logDir
    ts.logDir = ts.outDir = out_dir
    try:
        loss, _ = train.validate_batch(ts, epoch, 0.0)
        q = evaluate(ts, None, ["images", "psnr"])
    finally:
        ts.logDir = log_dir
        del ts.outDir
    return float(loss), [float(p) for p in q.psnr]


def resume_jax_ndc_run(train, kernel, tmp, flags=("--bf16",)):
    """Phase 19d: the committed JAX fine NDC run's config.ini and its
    NDC_RESUME checkpoints copied under the experiment name the port
    derives, resumed on demo/llff_scene with ``flags`` (bf16 through K3 by
    default) to epoch 2 x NDC_RESUME, validating every NDC_VALIDATE
    epochs; then the run's weights and JAX's committed ones at that epoch
    scored by the same port code (``score``). K3's launches and rows are
    counted from 0. Returns {stats, state, scores: {"port"|"jax":
    (validation loss, test PSNRs)}, validated: {epoch: the run's
    validation loss}, logged: the JAX run's logs.csv loss at 2 x
    NDC_RESUME, wall_s, launches, rows, trained: the run's weights as flat
    dicts, argv}."""
    import shutil
    from adanerf_tpu_torch.train_state import load_tree
    from adanerf_tpu_torch.utils.weights import load_flat, to_flat
    jax_run, r = jax_ndc_run(), NDC_RESUME
    log = os.path.join(tmp, "quality")
    run_dir = os.path.join(log, "llff_scene", os.path.basename(jax_run))
    os.makedirs(run_dir)
    config = shutil.copy(os.path.join(jax_run, "config.ini"), os.path.join(log, "jax_config.ini"))
    for f in os.listdir(jax_run):
        if f"_{r:07d}." in f:
            shutil.copy(os.path.join(jax_run, f), run_dir)
    argv = ["-c", config, "-data", LLFF_PNG, "-log", log, *flags, "--epochs", str(2 * r + 1),
            "--epochsRender", "1000000", "--epochsVideo", "-1", "--no-performEvaluation",
            "--epochsValidate", str(NDC_VALIDATE), "--verboseEvery", "1000"]
    kernel.forward_launches = kernel.backward_launches = 0
    kernel.forward_rows = None
    t = time.perf_counter()
    stats = train.main(argv)
    wall_s = time.perf_counter() - t
    launches, rows = (kernel.forward_launches, kernel.backward_launches), kernel.forward_rows
    ts = stats["state"]
    step_ms = stats["step_ms"]
    print(f"  resumed {os.path.basename(jax_run)} ({' '.join(flags)}) at epoch {ts.epoch0} in "
          f"{ts.logDir}: K3 launches forward {launches[0]}, backward {launches[1]} "
          f"({len(step_ms)} steps) at {rows} rows; step median {float(np.median(step_ms)):.3f} "
          f"ms (mean {float(np.mean(step_ms)):.3f}); {wall_s:.1f} s in all, validation "
          f"{stats['legs_ms']['validate']} ms", flush=True)
    if ts.logDir.rstrip("/") != run_dir or ts.epoch0 != r + 1:
        raise SystemExit("the quality run did not resume from the copied JAX checkpoint")
    trained = [{k: v.copy() for k, v in to_flat(m).items()} for m in ts.models]
    scores = {"port": score(ts, os.path.join(tmp, "score_port"), 2 * r)}
    for m in ts.models:
        load_flat(m, load_tree(os.path.join(jax_run, f"{m.name}_{2 * r:07d}.weights")))
    scores["jax"] = score(ts, os.path.join(tmp, "score_jax"), 2 * r)
    for m, w in zip(ts.models, trained):
        load_flat(m, w)
    def losses(run):
        with open(os.path.join(run, "logs.csv")) as f:
            return {int(row["epoch"]): float(row["loss"]) for row in csv.DictReader(f)}

    logged, validated = losses(jax_run), losses(run_dir)
    return dict(stats=stats, state=ts, scores=scores, validated=validated,
                logged=logged.get(2 * r), wall_s=wall_s, launches=launches, rows=rows,
                trained=trained, argv=argv)


def llff_leg(train, port_export, viewer, kernel, dev, tmp):
    """Phase 19: a real forward-facing capture end to end. (a) the JPEG
    decoder against imageio's pixels; (b) JPEG LLFF conversion; (c)
    configs/dense_training_ndc.ini on the converted scene, NDC_DENSE_STEPS
    steps through K3; (d) training quality: the committed JAX fine NDC run
    resumed on demo/llff_scene in bf16 through K3 from its NDC_RESUME
    checkpoints with its own config.ini, NDC_RESUME steps, validating
    every NDC_VALIDATE; the port's weights and JAX's committed ones at the
    end scored by the same port code, and the first validation held to the
    JAX package's own resume (NDC_JAX_RESUME), both with QUALITY_BARS; 3
    steps traced with
    ``utils/profiling.device_trace``; (e) its export through K1 (fp32
    ``check_slots``, bf16 >= 40 dB at 800x800, the viewer's default route)
    with ``--megakernel v3`` refused; (f) its five ``epoch_*.pdf`` plots.
    Returns the phase's numbers."""
    from adanerf_tpu_torch.ops.kernels.nerf_train import BACKWARD_KERNEL_NAMES
    from adanerf_tpu_torch.utils.pdfplot import read_plot
    out = {"decode": decode_check()}
    out["convert"], scene = convert_check(tmp)

    # (c) the dense NDC config on the JPEG capture (its NeRF unlocked)
    steps = NDC_DENSE_STEPS
    argv = ["-c", DENSE_NDC_INI, "-data", scene, "-log", os.path.join(tmp, "dense"), "--bf16",
            "--epochs", str(1 + steps), "--randomSeed", "0",
            "--epochsLockWeightsBefore", "-1", "--epochsLockWeightsBefore", "-1",
            "--epochsRender", "1000000", "--epochsValidate", "1000000",
            "--epochsCheckpoint", "1000000", "--no-performEvaluation", "--verboseEvery", "2"]
    kernel.forward_launches = kernel.backward_launches = 0
    kernel.forward_rows = None
    stats = train.main(argv)
    launches, rows = (kernel.forward_launches, kernel.backward_launches), kernel.forward_rows
    mse, k = stats["losses"][:, 1], max(1, steps // 4)
    print(f"  dense NDC run on the JPEG capture ({stats['state'].h}x{stats['state'].w}): K3 "
          f"launches forward {launches[0]}, backward {launches[1]} ({steps} steps) at {rows} "
          f"rows; step {float(np.median(stats['step_ms'])):.3f} ms (median); NeRF loss mean of "
          f"the first {k} steps {float(mse[:k].mean()):.6f}, of the last {k} "
          f"{float(mse[-k:].mean()):.6f}", flush=True)
    if launches != (steps, steps) or rows != K3_ROWS:
        raise SystemExit(f"the dense NDC run launched K3 {launches} times at {rows} rows")
    if not (np.isfinite(stats["losses"]).all() and mse[-k:].mean() < mse[:k].mean()):
        raise SystemExit("the dense NDC run's loss did not fall")
    out["dense"] = dict(launches=launches, rows=rows, steps=steps,
                        step_ms_median=float(np.median(stats["step_ms"])),
                        loss_first=float(mse[:k].mean()), loss_last=float(mse[-k:].mean()))
    del stats
    torch.cuda.empty_cache()

    # (d) quality: resume the JAX run's checkpoint in the port, through K3
    q = resume_jax_ndc_run(train, kernel, tmp)
    stats, ts, scores, r = q["stats"], q["state"], q["scores"], NDC_RESUME
    launches, rows, step_ms, trained, argv = (q["launches"], q["rows"], stats["step_ms"],
                                              q["trained"], q["argv"])
    if launches != (r, r) or rows != K3_FINE_ROWS or not np.isfinite(stats["losses"]).all():
        raise SystemExit(f"the quality run launched K3 {launches} times at {rows} rows, or its "
                         "losses are not finite")
    ratio = scores["port"][0] / scores["jax"][0]
    dpsnr = float(np.mean(scores["port"][1]) - np.mean(scores["jax"][1]))
    print(f"  quality at epoch {2 * r}, scored by the port on the card: validation loss port "
          f"{scores['port'][0]:.8f}, JAX's committed weights {scores['jax'][0]:.8f} (ratio "
          f"{ratio:.4f}, bar {QUALITY_BARS['val_loss_ratio']}; the JAX run's logs.csv "
          f"{q['logged']}, not gated); mean test PSNR port "
          f"{float(np.mean(scores['port'][1])):.4f} dB, JAX's weights "
          f"{float(np.mean(scores['jax'][1])):.4f} dB (difference {dpsnr:+.4f}, bar "
          f"-{QUALITY_BARS['test_psnr_db']}); per image port {scores['port'][1]}, JAX "
          f"{scores['jax'][1]}", flush=True)
    # like with like: the JAX package's own resume of the same checkpoint on
    # the CPU, whose rays are rotated in fp32 as the port's are (the
    # committed run's were not: ROADMAP Queue 3, F10)
    with open(NDC_JAX_RESUME) as f:
        ref = json.load(f)
    e, ref_loss = ref["fp32"]["epoch"], ref["fp32"]["val_loss"]
    own = q["validated"].get(e, float("nan"))
    like = own / ref_loss
    print(f"  the run's validation loss at epoch {e} {own:.8f}; the JAX package's resume on the "
          f"CPU ({ref['fp32']['steps']} steps, tests/torch_ndc_resume_reference.py) "
          f"{ref_loss:.8f} (ratio {like:.4f}, bar {QUALITY_BARS['val_loss_ratio']}), at a TPU's "
          f"default precision {ref['tpu']['val_loss']:.8f} (not gated); the run's validations "
          f"{q['validated']}", flush=True)
    batch, targets = ts.assemble_train_batch(ts.train_dataset, np.array([0, 1]))
    prof = profile_steps(ts, batch, targets, 2 * r + 1, trace_dir=os.path.join(tmp, "trace"))
    top = [name for _, name in prof["kernels"][:8]]
    print(f"  trace of 3 steps (utils/profiling.device_trace, {prof['trace_path']}, "
          f"{os.path.getsize(prof['trace_path'])} bytes): K3 kernels a step {prof['k3_counts']}",
          flush=True)
    print_profile("traced resumed step (3 steps)", prof, 8)
    expected = {k: 1.0 for k in ("k3_fwd",) + BACKWARD_KERNEL_NAMES}
    if prof["k3_counts"] != expected or not any("k3_" in n for n in top):
        raise SystemExit(f"the trace's top CUDA ops hold no K3 kernel: {top}")
    if not (ratio <= QUALITY_BARS["val_loss_ratio"] and dpsnr >= -QUALITY_BARS["test_psnr_db"]
            and like <= QUALITY_BARS["val_loss_ratio"]):
        raise SystemExit("the port's bf16 K3 run misses the quality bars against JAX's weights "
                         "or against the JAX package's own resume")
    out["quality"] = dict(
        resumed_at=ts.epoch0, steps=len(step_ms), launches=launches, rows=rows,
        step_ms_median=float(np.median(step_ms)), step_ms_mean=float(np.mean(step_ms)),
        wall_s=q["wall_s"], val_loss_port=scores["port"][0], val_loss_jax=scores["jax"][0],
        val_loss_ratio=ratio, val_loss_logged_jax=q["logged"], validated=q["validated"],
        val_loss_jax_cpu_resume=ref_loss, val_loss_ratio_jax_cpu_resume=like,
        test_psnr_port=scores["port"][1], test_psnr_jax=scores["jax"][1],
        test_psnr_diff_db=dpsnr, traced_device_ms=prof["device_ms"],
        traced_wall_ms=prof["wall_ms"], traced_k3_ms=prof["k3_ms"],
        busy_share=prof["device_ms"] / prof["wall_ms"])
    del batch, targets, prof

    # (f) the run's training-stat plots, written at its validation
    plots = {}
    for name in ("epoch_loss", "epoch_train_loss", "epoch_accuracy",
                 "epoch_loss_train_loss_accuracy", "epoch_loss_train_loss"):
        path = os.path.join(ts.logDir, name + ".pdf")
        items = read_plot(path) if os.path.exists(path) else []
        plots[name] = sum(1 for it in items if it[0] == "path")
    print(f"  the run's plots (paths drawn in each): {plots}", flush=True)
    if not all(plots.values()):
        raise SystemExit("the quality run's epoch_*.pdf plots are missing or do not parse")
    out["plots"] = plots

    # (e) its export, viewed through K1; v3 refused
    out["export"] = export_leg(port_export, viewer, ts, trained, argv, dev)
    del ts, trained, stats
    torch.cuda.empty_cache()
    return out


def read_quality_csv(path):
    """[{mse, psnr, ssim, flip, samples, sparsity}] of an
    image_quality_images.csv (``\\r`` line ends)."""
    with open(path, newline="") as f:
        rows = [r for r in f.read().replace("\r", "\n").splitlines() if r.strip()]
    keys = rows[0].split(",")
    return [dict(zip(keys, map(float, r.split(",")))) for r in rows[1:]]


def count_near_ties(ts, index, chunk=40000):
    """One test image of an evaluated run on the card: the per-ray sample
    counts of the fp32 render (``render_rays_chunked``) against those the
    same oracle gives in float64 on the same encoded inputs. Returns (rays,
    count mismatches, rays keeping another set of bins, of which at a near
    tie: every bin that one side keeps and the other drops has a float64
    logit within NEAR of the threshold)."""
    from adanerf_tpu_torch.pipeline.keys import FSK, DatasetKeys
    from adanerf_tpu_torch.render import render_rays_chunked
    ds, dev = ts.test_dataset, ts.device
    S, thr = ts.config_file.numRaymarchSamples[-1], ts.config_file.adaptiveSamplingThreshold
    imgs, extras = render_rays_chunked(ts, ds.poses[index], ds.rotations[index],
                                       ts.config_file.inferenceChunkSize,
                                       collect=[FSK.adaptive_sample_positions])
    counts32 = torch.from_numpy(np.rint(extras[FSK.adaptive_sample_positions] * S)).to(dev)
    logits32 = torch.from_numpy(imgs[0]).to(dev)
    oracle64 = copy.deepcopy(ts.models[0]).double()
    pose = torch.as_tensor(ds.poses[index][None], device=dev)
    rot = torch.as_tensor(ds.rotations[index][None], device=dev)
    logits64 = []
    with torch.no_grad():
        for s in range(0, ds.directions.shape[0], chunk):
            dirs = torch.from_numpy(ds.directions[s:s + chunk][None]).to(dev)
            x = ts.f_in[0].batch({DatasetKeys.image_pose: pose, DatasetKeys.image_rotation: rot,
                                  DatasetKeys.ray_directions_samples: dirs},
                                 prev_outs=[], is_inference=True)[FSK.input_feature_batch]
            logits64.append(oracle64(x.double()))
    logits64 = torch.cat(logits64)
    counts64 = (logits64 >= thr).sum(dim=1).clamp(1, S)
    flipped = (logits32 >= thr) ^ (logits64 >= thr)
    rays = torch.nonzero(flipped.any(dim=1)).flatten()
    near = sum(bool(((logits64[r] - thr).abs()[flipped[r]] <= NEAR).all()) for r in rays.tolist())
    return (ds.directions.shape[0], int((counts32 != counts64).sum()), len(rays), near)


def evaluate_jax_run(port_evaluate):
    """Phase 13b: ``python -m adanerf_tpu_torch.evaluate`` on the committed
    JAX run, in fp32 as it was trained, on the card; per image PSNR, FLIP
    and samples/px held to EVAL_BARS against the JAX package's CPU
    evaluation (the fixture), and the gap to the committed CSV printed."""
    with open(EVAL_FIXTURE) as f:
        fixture = json.load(f)["images"]
    committed = read_quality_csv(os.path.join(JAX_RUN, "image_quality_images.csv"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as out:
        t = time.perf_counter()
        results = port_evaluate.main(["-data", MSCENE_DATA, "-log", JAX_RUN, "--outDir", out,
                                      "--force"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        (ts, _q), = results.values()
        got = read_quality_csv(os.path.join(out, "mscene", os.path.basename(JAX_RUN),
                                            "image_quality_images.csv"))
        n_eval_png = len(os.listdir(os.path.join(out, "mscene", os.path.basename(JAX_RUN),
                                                 "eval")))
    worst = {k: 0.0 for k in EVAL_BARS}
    for i, (g, fx, cm) in enumerate(zip(got, fixture, committed)):
        for k in EVAL_BARS:
            worst[k] = max(worst[k], abs(g[k] - fx[k]))
        print(f"  image {i}: PSNR {g['psnr']:.4f} dB (JAX CPU {fx['psnr']:.4f}, committed "
              f"{cm['psnr']:.4f}), FLIP {g['flip']:.6f} (JAX CPU {fx['flip']:.6f}, committed "
              f"{cm['flip']:.6f}), samples/px {g['samples']:.6f} (JAX CPU {fx['samples']:.6f}, "
              f"committed {cm['samples']:.6f}), IW-SSIM {g['ssim']:.6f}", flush=True)
    # the near ties behind any count that differs: fp32 on the card against
    # float64 sums of the same oracle inputs, every test image
    ties = [count_near_ties(ts, i) for i in range(len(ts.test_dataset))]
    print("  per-ray counts, fp32 on the card vs a float64 oracle on the same inputs: "
          + "; ".join(f"image {i}: {m} of {n} rays differ (allowed {n // 10000}), {f} keep other "
                      f"bins, {k} of them at a near tie" for i, (n, m, f, k) in enumerate(ties)),
          flush=True)
    gap = {k: max(abs(g[k] - cm[k]) for g, cm in zip(got, committed)) for k in EVAL_BARS}
    print(f"  against the JAX package's CPU evaluation: worst |PSNR| {worst['psnr']:.3e} dB "
          f"(allowed {EVAL_BARS['psnr']}), |FLIP| {worst['flip']:.3e} (allowed "
          f"{EVAL_BARS['flip']}), |samples/px| {worst['samples']:.3e} (allowed "
          f"{EVAL_BARS['samples']}); gap to the committed CSV (not gated): PSNR {gap['psnr']:.4f} "
          f"dB, FLIP {gap['flip']:.3e}, samples/px {gap['samples']:.3e}; {len(got)} images in "
          f"{ms:.1f} ms, {n_eval_png} files in eval/ on {ts.device}", flush=True)
    if len(got) != len(fixture) or any(worst[k] > EVAL_BARS[k] for k in EVAL_BARS) \
            or not all(np.isfinite(g[k]) for g in got for k in EVAL_BARS) \
            or any(m > n // 10000 or k != f for n, m, f, k in ties):
        raise SystemExit("the port's evaluation of the committed JAX run disagrees with the "
                         "JAX package's")
    return dict(ms=ms, worst=worst, gap_to_committed=gap, count_ties=ties,
                psnr=[g["psnr"] for g in got], flip=[g["flip"] for g in got],
                samples=[g["samples"] for g in got])


def videos_leg(port_evaluate, images_leg):
    """Phase 13c: ``python -m adanerf_tpu_torch.evaluate --evaluations
    videos`` on the committed JAX run, in a scratch scene of symlinks into
    demo/mscene with a ``cam_path.json`` of the 6 test poses and a
    ``reference_video/`` of the 6 test PNGs upscaled 2x by pixel repetition
    to 800x800, so the area resize runs. A 2x area downscale of a
    pixel-repeated frame gives back the frame (OpenCV's float32 sum, which
    the port reproduces, is exact for every 8-bit value), and both legs read
    a PNG alike (``/ 255`` in float32, the first three channels), so each
    frame's PSNR must equal the images leg's (phase 13b) within 1e-4 dB
    and its FLIP within 1e-6. Fails unless the frame folders and both
    reports are written."""
    from adanerf_tpu_torch.data.png import read_png, write_png
    with tempfile.TemporaryDirectory(prefix="chip_smoke_videos_") as tmp:
        scene = os.path.join(tmp, "mscene")
        os.makedirs(os.path.join(scene, "reference_video"))
        for name in os.listdir(MSCENE_DATA):
            os.symlink(os.path.join(MSCENE_DATA, name), os.path.join(scene, name))
        with open(os.path.join(MSCENE_DATA, "transforms_test.json")) as f:
            frames = json.load(f)["frames"]
        with open(os.path.join(scene, "cam_path.json"), "w") as f:
            json.dump({"frames": frames}, f)
        for i, fr in enumerate(frames):
            img = read_png(os.path.join(MSCENE_DATA, fr["file_path"][2:] + ".png"))
            write_png(os.path.join(scene, "reference_video", f"{i:04d}.png"),
                      np.ascontiguousarray(img.repeat(2, axis=0).repeat(2, axis=1)))
        out = os.path.join(tmp, "eval")
        t = time.perf_counter()
        port_evaluate.main(["-data", scene, "-log", JAX_RUN, "--outDir", out, "--force"]
                           + [a for e in ("videos", "psnr", "ssim", "flip")
                              for a in ("--evaluations", e)])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        run_out = os.path.join(out, "mscene", os.path.basename(JAX_RUN))
        rows = read_quality_csv(os.path.join(run_out, "image_quality_video.csv"))
        seqs = {seq: sorted(os.listdir(os.path.join(run_out, seq + "_frames")))
                if os.path.isdir(os.path.join(run_out, seq + "_frames")) else []
                for seq in ("_diff", "_square_diff", "_flip")}
        txt = os.path.exists(os.path.join(run_out, "image_quality_video.txt"))
    d_psnr = [abs(r["psnr"] - p) for r, p in zip(rows, images_leg["psnr"])]
    d_flip = [abs(r["flip"] - f) for r, f in zip(rows, images_leg["flip"])]
    for i, r in enumerate(rows):
        print(f"  frame {i}: PSNR {r['psnr']:.6f} dB (images leg {images_leg['psnr'][i]:.6f}), "
              f"FLIP {r['flip']:.8f} (images leg {images_leg['flip'][i]:.8f}), IW-SSIM "
              f"{r['ssim']:.6f}", flush=True)
    print(f"  videos leg: {len(rows)} frames in {ms:.1f} ms; worst |PSNR - images leg| "
          f"{max(d_psnr, default=float('nan')):.3e} dB (allowed 1e-4), |FLIP - images leg| "
          f"{max(d_flip, default=float('nan')):.3e} (allowed 1e-6); frame folders "
          f"{ {k: len(v) for k, v in seqs.items()} }; image_quality_video.txt: {txt}", flush=True)
    if len(rows) != len(images_leg["psnr"]) or not txt \
            or any(v != [f"{i:05d}.png" for i in range(len(rows))] for v in seqs.values()) \
            or not (max(d_psnr) <= 1e-4 and max(d_flip) <= 1e-6):
        raise SystemExit("the videos leg disagrees with the images leg or wrote too little")
    return dict(ms=ms, worst_psnr=max(d_psnr), worst_flip=max(d_flip),
                psnr=[r["psnr"] for r in rows])

def scale_out_leg(viewer, dev):
    """Phase 17: the port's scale-out on the one card. (a) Two gloo ranks
    sharing it take DP_STEPS data-parallel steps of dense_training.ini on
    demo/mscene at full width (each rank K3 at half the rows); their
    group-averaged gradients of the first step are held against the
    one-process K3 step on the same global batch (``nerf_train_check``'s
    per-leaf bar, 2e-2), and both ranks' parameters must end bit for bit
    equal. (b) A 1-rank NCCL group takes the same first step: its
    gradients must equal the one-process step's bit for bit. (c) K1 and K2
    render an 800x800 bf16 frame of trained_mscene_export over the device
    list [cuda:0] * 4, bit for bit the whole frame's launch, and the viewer
    renders with ``--mesh 1`` beside its unsharded run. Returns the
    phase's numbers."""
    import torch.distributed as dist
    from adanerf_tpu_torch.frame_times import time_ms
    from adanerf_tpu_torch.ops.kernels.megakernel_compact import MegakernelCompact
    from adanerf_tpu_torch.ops.kernels.megakernel_dense import MegakernelDense
    from adanerf_tpu_torch.parallel import check, mesh
    from adanerf_tpu_torch.parallel.render import ShardedFrame
    out = {}
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_dp_")
    argv = ["-c", DENSE_INI, "-data", MSCENE_DATA, "-log", os.path.join(work.name, "logs"),
            "--bf16", "--randomSeed", "0",
            "--epochsLockWeightsBefore", "-1", "--epochsLockWeightsBefore", "-1"]
    t = time.perf_counter()
    card = torch.device("cuda", 0)
    mesh.run_ranks(check.rank_steps, (argv, DP_STEPS, 1, work.name), [card, card], work.name,
                   timeout=300)
    ranks = check.rank_records(work.name, 2)
    print(f"  (a) 2 gloo ranks on one card, {DP_STEPS} steps: {time.perf_counter() - t:.1f} s "
          "wall with the processes' start", flush=True)
    ref = check.one_process_steps(argv, dev, DP_STEPS, 1)
    launches = [r["k3_launches"].tolist() for r in ranks]
    rows = [int(r["k3_rows"]) for r in ranks]
    print(f"  K3 launches (forward, backward) per rank: {launches} at {rows} rows; one process "
          f"{ref['k3_launches'].tolist()} at {int(ref['k3_rows'])} rows", flush=True)
    if launches != [[DP_STEPS, DP_STEPS]] * 2 or rows != [K3_ROWS // 2] * 2:
        raise SystemExit(f"the ranks launched K3 {launches} at {rows} rows, expected "
                         f"{DP_STEPS} each at {K3_ROWS // 2}")
    errs = {k: float(np.abs(ranks[0][k] - ref[k]).max()) / (float(np.abs(ref[k]).max()) + 1e-30)
            for k in ref if k.startswith("grad/")}
    worst = max(errs.items(), key=lambda kv: kv[1])
    print(f"  all-reduced grads vs one-process K3 step: worst leaf {worst[0]} rel {worst[1]:.3e} "
          f"(allowed 2e-2), median leaf {float(np.median(list(errs.values()))):.3e}", flush=True)
    same = all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0] if k.startswith("param/"))
    print(f"  ranks' parameters after {DP_STEPS} steps bit for bit equal: {same}; losses rank 0 "
          f"{ranks[0]['losses'].tolist()}, one process {ref['losses'].tolist()}", flush=True)
    step_ms = [r["step_ms"].tolist() for r in ranks]
    print(f"  step ms, rank 0 / rank 1 (sharing the card): {step_ms}; one process "
          f"{ref['step_ms'].tolist()}", flush=True)
    if not (worst[1] <= 2e-2 and same):
        raise SystemExit("the 2-rank step disagrees with the one-process step or the ranks differ")
    out.update(dp_k3_launches=launches, dp_k3_rows=rows, dp_worst_leaf_rel=worst[1],
               dp_step_ms=step_ms, one_process_step_ms=ref["step_ms"].tolist())

    # (b) a 1-rank NCCL group on the same first step
    dist.init_process_group("nccl", init_method=mesh.rendezvous(work.name), world_size=1, rank=0)
    try:
        one = check.take_steps(check.train_state(argv, dev), dist.group.WORLD, 1, 1)
    finally:
        dist.destroy_process_group()
    grads = [k for k in ref if k.startswith("grad/")]
    nccl_same = all(np.array_equal(one[k], ref[k]) for k in grads)
    nccl_err = max(float(np.abs(one[k] - ref[k]).max()) for k in grads)
    print(f"  (b) 1-rank NCCL group: grads bit for bit the one-process step's: {nccl_same} "
          f"(max abs diff {nccl_err:.3e})", flush=True)
    if not nccl_same:
        raise SystemExit("the 1-rank NCCL step differs from the one-process step")
    out.update(nccl_bit_equal=nccl_same)
    del ranks, ref, one
    work.cleanup()
    torch.cuda.empty_cache()

    # (c) K1 and K2 over 4 slices of one 800x800 frame on the card
    rt, scene = viewer.build_renderer_from_export(MSCENE, dtype_str="bf16", device=dev)
    dirs = viewer.frame_directions(scene, 800, 800, dev)
    pose = viewer.orbit_poses(scene.view_cell_center, 0.4 * scene.view_cell_radius, 8)[1]
    rot = np.eye(3, dtype=np.float32)
    for kind in (MegakernelCompact, MegakernelDense):
        k = kind(rt)
        rgb, counts = k(dirs, pose, rot)
        frame = ShardedFrame(k, [card] * 4, dirs)
        kind.launches = 0
        rgb_s, counts_s = frame(pose, rot)
        n_launch = kind.launches
        equal = torch.equal(rgb_s, rgb) and torch.equal(counts_s, counts)
        ms_whole = time_ms(lambda: k(dirs, pose, rot), 10)
        ms_4 = time_ms(lambda: frame(pose, rot), 10)
        print(f"  (c) {kind.__name__} over [cuda:0] * 4: {n_launch} launches, bit for bit the "
              f"whole frame: {equal}; {ms_4:.3f} ms a frame against {ms_whole:.3f} ms whole",
              flush=True)
        if n_launch != 4 or not equal:
            raise SystemExit(f"the 4-slice {kind.__name__} frame differs from the whole frame")
        out[kind.__name__] = {"launches": n_launch, "bit_equal": equal, "ms_4_slices": ms_4,
                              "ms_whole": ms_whole}
    del rt, dirs, rgb, counts, rgb_s, counts_s, frame, k
    args = [MSCENE, "-s", "800", "800", "-n", "5", "--logging_interval", "5"]
    MegakernelCompact.launches = 0
    meshed = viewer.main(args + ["--mesh", "1"])
    mesh_launches = MegakernelCompact.launches
    whole = viewer.main(args)
    print(f"  viewer --mesh 1 -n 5: {meshed['device_ms_per_frame']:.3f} ms a frame (device), "
          f"{mesh_launches} K1 launches; unsharded {whole['device_ms_per_frame']:.3f} ms; the "
          f"wrapper's overhead {meshed['device_ms_per_frame'] - whole['device_ms_per_frame']:.3f} "
          "ms", flush=True)
    if mesh_launches < 1 or not torch.equal(meshed["last_frame"], whole["last_frame"]):
        raise SystemExit("the --mesh 1 viewer did not launch K1 or rendered another frame")
    out.update(viewer_mesh1_ms=meshed["device_ms_per_frame"], viewer_mesh1_launches=mesh_launches,
               viewer_whole_ms=whole["device_ms_per_frame"])
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from adanerf_tpu_torch import evaluate as port_evaluate
    from adanerf_tpu_torch import export as port_export
    from adanerf_tpu_torch import test as port_test
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
    # every width the kernels are built for (one library each), all at once
    from adanerf_tpu_torch.ops.kernels.megakernel_compact import WIDTHS, library
    frame_libs = [library(src, w) for src in (SOURCE, megakernel_dense.SOURCE) for w in WIDTHS]
    k3_libs = [nerf_train.library(w) for w in nerf_train.WIDTHS]
    logs = build.build(frame_libs + k3_libs)
    print(f"  built {len(logs)} librar(ies) in {time.perf_counter() - t:.1f}s", flush=True)
    for src, log in logs.items():
        for name, info in ptxas_report(log):
            print(f"  {src}: {name}: {info}", flush=True)
    for src in frame_libs:
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
    for lib in k3_libs:
        for name, instrs in sass.kernel_sass(build.library_path(lib)).items():
            n_hgmma = sass.hgmma_count(instrs)
            print(f"  {lib}: {demangle(name)}: {len(instrs)} SASS instructions, "
                  f"{n_hgmma} HGMMA", flush=True)
            if "k3_reduce" not in name and n_hgmma == 0:
                raise SystemExit(f"{lib}: {name} has no HGMMA instruction")
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
    ops_f = 2.0 * K3_ROWS * nerf.macs_per_input()
    ops_b = 3.0 * ops_f  # recompute, the dX chain, dW
    k3_bounds_dense = k3_bounds(K3_ROWS, nerf)
    scratch_bytes = 2 * k3.scratch_layout(K3_ROWS)[""][0]
    print(f"  K3 forward {ms_k3f:.3f} ms ({ops_f / ms_k3f / 1e9:.1f} TFLOP/s), backward "
          f"{ms_k3b:.3f} ms ({ops_b / ms_k3b / 1e9:.1f} TFLOP/s); plain forward {ms_pf:.3f} ms, "
          f"plain backward {ms_pb:.3f} ms", flush=True)
    bf, bb = k3_bounds_dense["fwd"], k3_bounds_dense["bwd"]
    print(f"  bounds: forward {bf[0]:.3f} ms, backward {bb[0]:.3f} ms (bf16 peak; fp32 FMA "
          f"{bf[2]:.2f} / {bb[2]:.2f} ms); the "
          f"backward's scratch ({scratch_bytes / 1e9:.2f} GB written and read) alone takes "
          f"{2 * scratch_bytes / HBM_BPS * 1e3:.2f} ms", flush=True)
    del x, g, out_k, out_p, packed
    torch.cuda.empty_cache()
    done("8", t)

    t = time.perf_counter()
    steps = TRAIN_WARMUP + TRAIN_TIMED
    phase(f"9 main path: train, dense_training.ini on demo/mscene, bf16, {steps} steps, "
          "validating at the last")
    # phase 9b's fine leg bootstraps from this leg's _opt checkpoints
    train_logs = tempfile.TemporaryDirectory(prefix="chip_smoke_logs_")
    log_dir = train_logs.name
    # the flags overridden here leave the experiment's name as the
    # shipped ini gives it, so the fine leg finds it through its regex
    argv = ["-c", DENSE_INI, "-data", MSCENE_DATA, "-log", log_dir, "--bf16",
            "--epochs", str(1 + steps), "--randomSeed", "0",
            # one value per network (an append option): neither is locked
            "--epochsLockWeightsBefore", "-1", "--epochsLockWeightsBefore", "-1",
            "--epochsRender", "1000000", "--epochsValidate", str(steps),
            "--epochsCheckpoint", "1000000", "--no-performEvaluation",
            "--verboseEvery", "10"]
    NerfTrainKernel.forward_launches = NerfTrainKernel.backward_launches = 0
    NerfTrainKernel.forward_rows = None
    stats = train.main(argv)
    k3_launches = (NerfTrainKernel.forward_launches, NerfTrainKernel.backward_launches)
    dense_rows = NerfTrainKernel.forward_rows
    ts = stats["state"]
    dense_dir = ts.logDir
    n_val = len(ts.valid_dataset)
    dense_val_ms = stats["legs_ms"]["validate"]
    opt_files = sorted(f for f in os.listdir(dense_dir) if "__opt." in f)
    opt_txt = os.path.join(dense_dir, "opt.txt")
    print(f"  validation at epoch {steps} (not in the step times): {dense_val_ms} ms for {n_val} "
          f"images; opt.txt: {open(opt_txt).read() if os.path.exists(opt_txt) else None!r}; "
          f"{opt_files}", flush=True)
    if len(dense_val_ms) != 1 or len(opt_files) != 2 * len(ts.models):
        raise SystemExit("the dense leg did not validate once or wrote no _opt checkpoints")
    mse = stats["losses"][:, 1]
    step_ms = stats["step_ms"][TRAIN_WARMUP:]
    train_ms = float(np.mean(step_ms))
    print(f"  K3 launches on the main path: forward {k3_launches[0]}, backward "
          f"{k3_launches[1]} ({steps} steps) at {dense_rows} rows", flush=True)
    print(f"  train step {train_ms:.3f} ms (mean of {len(step_ms)}; median "
          f"{float(np.median(step_ms)):.3f}, min {min(step_ms):.3f}, max {max(step_ms):.3f}), "
          f"{dense_rows / train_ms / 1e3:.3f} M shading rows/s", flush=True)
    print(f"  MSE mean of the first 10 steps {float(mse[:10].mean()):.6f}, of the last 10 "
          f"{float(mse[-10:].mean()):.6f}; all losses finite: "
          f"{bool(np.isfinite(stats['losses']).all())}", flush=True)
    print(f"  checkpoint: {[os.path.basename(p) for p in stats['checkpoint']]}", flush=True)
    if k3_launches != (steps, steps):
        raise SystemExit(f"the train path launched K3 {k3_launches} times, expected {steps}")
    if dense_rows != K3_ROWS:  # the shape phase 8 holds K3 at
        raise SystemExit(f"the dense leg ran K3 at {dense_rows} rows, expected {K3_ROWS}")
    if not (np.isfinite(stats["losses"]).all() and mse[-10:].mean() < mse[:10].mean()):
        raise SystemExit("training loss did not fall or is not finite")
    if not all(os.path.exists(p) for p in stats["checkpoint"]):
        raise SystemExit("the final checkpoint is missing")
    worst_step, batch, targets, _ = step_grads_vs_plain(ts, NerfTrainKernel, steps + 1)
    print(f"  train step grads, K3 vs plain: worst leaf {worst_step[1]} rel "
          f"{worst_step[0]:.3e} (allowed 2e-2)", flush=True)
    if not worst_step[0] <= 2e-2:
        raise SystemExit("the train step's grads through K3 disagree with the plain path")
    # where a step's device time goes: 3 more steps through K3
    prof = profile_steps(ts, batch, targets, steps + 2)
    k3_step_counts = prof["k3_counts"]
    print(f"  K3 kernels launched per step: {k3_step_counts}", flush=True)
    expected = {k: 1.0 for k in ("k3_fwd",) + nerf_train.BACKWARD_KERNEL_NAMES}
    if k3_step_counts != expected:
        raise SystemExit(f"K3 launched {k3_step_counts} a step, expected {expected}")
    print_profile("profiled step (3 steps)", prof, 12)
    del ts, stats, batch, targets, prof
    torch.cuda.empty_cache()
    done("9", t)

    t = time.perf_counter()
    phase(f"9b main path: train, fine_training.ini as shipped on demo/mscene, bf16, {FINE_STEPS} "
          "steps from phase 9's _opt, render, video, validation and evaluation once each")
    fine, fine_ts, fine_trained, fine_argv = fine_leg(train, port_test, NerfTrainKernel,
                                                      nerf_train_check, log_dir, dense_dir)
    torch.cuda.empty_cache()
    print(f"  card: {card_state()}", flush=True)
    done("9b", t)

    t = time.perf_counter()
    phase("9c main path: export phase 9b's fine run and view it through K1 and K2 (S=16, "
          "log depth, not NDC)")
    exported = export_leg(port_export, viewer, fine_ts, fine_trained, fine_argv, dev)
    del fine_ts, fine_trained
    train_logs.cleanup()
    torch.cuda.empty_cache()
    print(f"  card: {card_state()}", flush=True)
    done("9c", t)

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
                                              allowed=0 if thr != 1e-4
                                              else dirs400.shape[0] // 10_000)
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

    t = time.perf_counter()
    phase("13b evaluate the committed JAX run (fine, S=8, threshold 0.2, fp32) on the card")
    evaluation = evaluate_jax_run(port_evaluate)
    print(f"  card: {card_state()}", flush=True)
    done("13b", t)

    t = time.perf_counter()
    phase("13c videos leg of the committed JAX run against its own test images at 800x800")
    videos = videos_leg(port_evaluate, evaluation)
    done("13c", t)

    t = time.perf_counter()
    phase(f"15 train nerf_baseline.ini (coarse + fine NeRF, both through K3, "
          f"{K3_BASELINE_ROWS[0]} + {K3_BASELINE_ROWS[1]} rows a step) on demo/mscene, bf16, "
          f"{BASELINE_STEPS} steps, validating and evaluating one image")
    baseline = baseline_leg(train, NerfTrainKernel, nerf_train_check)
    print(f"  card: {card_state()}", flush=True)
    done("15", t)

    t = time.perf_counter()
    phase(f"16 train gt_depth_training.ini on demo/mscene, bf16: {GT_PRETRAIN} pretraining "
          f"epochs of the oracle, then {GT_STEPS + 1} joint steps with the NeRF through K3")
    gt = gt_leg(train, NerfTrainKernel)
    print(f"  card: {card_state()}", flush=True)
    done("16", t)

    t = time.perf_counter()
    phase(f"17 scale-out: 2 gloo ranks x {K3_ROWS // 2} rows through K3 on one card, a 1-rank "
          "NCCL step, K1 and K2 over 4 slices of an 800x800 frame, the viewer with --mesh 1")
    scale_out = scale_out_leg(viewer, dev)
    print(f"  card: {card_state()}", flush=True)
    done("17", t)

    t = time.perf_counter()
    phase(f"18 the main path at other widths: K3 alone at {K3_ROWS} rows at widths {K3_WIDTHS}; "
          f"at widths {MAIN_WIDTHS} (both nets) the dense ini ({WIDTH_DENSE_STEPS} steps) and "
          f"the fine ini ({FINE_STEPS} steps from its _opt) through K3, bf16, and the fine run's "
          "export viewed through K1 and K2")
    widths = {w: {"k3": k3_alone(w, dev)} for w in K3_WIDTHS}
    for w in MAIN_WIDTHS:
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_w{w}_") as tmp:
            runs, ts_w, trained_w, argv_w = width_runs(train, NerfTrainKernel, w, tmp)
            widths[w]["runs"] = runs
            widths[w]["export"] = export_leg(port_export, viewer, ts_w, trained_w, argv_w, dev)
            del ts_w, trained_w
        torch.cuda.empty_cache()
    print(f"  card: {card_state()}", flush=True)
    done("18", t)

    t = time.perf_counter()
    phase(f"19 LLFF capture -> NDC training through K3 -> K1: JPEG decode, convert_llff, "
          f"dense_training_ndc.ini {NDC_DENSE_STEPS} steps on the JPEG capture, the committed "
          f"JAX fine NDC run resumed at {NDC_RESUME} for {NDC_RESUME} steps and scored against "
          "JAX's weights and the JAX package's own resume, its export through K1, its plots")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_llff_") as tmp:
        llff = llff_leg(train, port_export, viewer, NerfTrainKernel, dev, tmp)
    torch.cuda.empty_cache()
    print(f"  card: {card_state()}", flush=True)
    done("19", t)

    def k3_widths(way):  # the kernels line's K3 numbers at each width
        out = {}
        for w, v in widths.items():
            k = v["k3"]
            runs = v.get("runs", {})
            out[str(w)] = {
                "launches": {r: n["launches"][way == "bwd"] for r, n in runs.items()},
                "rows": {r: n["rows"] for r, n in runs.items()},
                "step_ms": {r: n["step_ms"] for r, n in runs.items()},
                "ms": k[f"{way}_ms"], "plain_ms": k[f"plain_{way}_ms"],
                "bound_ms": k[f"bound_{way}_ms"], "bound_by": k[f"bound_{way}_by"],
                "max_abs_err": k[f"max_abs_err_{way}"], "alone_rows": K3_ROWS}
        return out

    def frame_widths(key):  # the kernels line's K1 (key k1) or K2 (k2) numbers at each width
        out = {}
        for w in MAIN_WIDTHS:
            e = widths[w]["export"]
            out[str(w)] = {"launches": e[f"{key}_launches"], "ms": e[f"{key}_ms"],
                           "plain_ms": e[f"{key}_plain_ms"], "bound_ms": e["bound_ms"],
                           "bound_by": e["bound_by"],
                           "max_abs_err": e["k1_fp32"]["err_p"] if key == "k1"
                           else e["k2_fp32_err"], "viewer_device_ms": e[f"{key}_viewer_ms"],
                           "samples_per_pixel": e["spp"]}
            if key == "k1":
                out[str(w)]["psnr_bf16_vs_plain_fp32"] = e["k1_psnr_fp32"]
        return out

    k2_main = k2_16[scene_thr]
    phase("14 kernels")
    print(json.dumps({"widths": {str(w): d for w, d in widths.items()}}), flush=True)
    print(json.dumps({"training_legs": {"dense_validate_ms": dense_val_ms,
                                        "fine": {k: v for k, v in fine.items()},
                                        "nerf_baseline": baseline, "gt_depth": gt},
                      "export": exported, "evaluation": evaluation, "videos": videos,
                      "scale_out": scale_out}),
          flush=True)
    print(json.dumps({"llff_ndc": llff}), flush=True)
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
        "ndc_psnr_vs_plain_fp32": p_f, "ndc_stages": ndc_stages,
        "fine_export_launches": exported["k1_launches"], "fine_export_800_ms": exported["k1_ms"],
        "fine_export_800_plain_ms": exported["k1_plain_ms"],
        "fine_export_800_bound_ms": exported["bound_ms"],
        "fine_export_viewer_device_ms": exported["k1_viewer_ms"],
        "fine_export_samples_per_pixel": exported["spp"],
        "sharded_4_launches": scale_out["MegakernelCompact"]["launches"],
        "sharded_4_ms": scale_out["MegakernelCompact"]["ms_4_slices"],
        "sharded_4_whole_ms": scale_out["MegakernelCompact"]["ms_whole"],
        "viewer_mesh1_launches": scale_out["viewer_mesh1_launches"],
        "viewer_mesh1_device_ms": scale_out["viewer_mesh1_ms"],
        "llff_ndc_export_launches": llff["export"]["k1_launches"],
        "llff_ndc_export_800_ms": llff["export"]["k1_ms"],
        "llff_ndc_export_800_plain_ms": llff["export"]["k1_plain_ms"],
        "llff_ndc_export_800_bound_ms": llff["export"]["bound_ms"],
        "llff_ndc_export_max_abs_err": llff["export"]["k1_fp32"]["err_p"],
        "llff_ndc_export_psnr_vs_plain_fp32": llff["export"]["k1_psnr_fp32"],
        "widths": frame_widths("k1")}, {
        "name": "nerf_train_forward", "route": "cuda",
        "source": "adanerf_tpu_torch/csrc/nerf_train.cu",
        "replaces": "adanerf_tpu/ops/pallas/train_kernel.py:95",
        "launches": k3_launches[0], "max_abs_err": fwd_abs, "rel_err": fwd_rel,
        "ms": ms_k3f, "plain_ms": ms_pf, "bound_ms": k3_bounds_dense["fwd"][0],
        "bound_by": k3_bounds_dense["fwd"][1], "library_ms": None, "rows": K3_ROWS,
        "fine_launches": fine["launches"][0], "fine_rows": fine["rows"],
        "fine_ms": fine["k3_fwd_ms"], "fine_plain_ms": fine["plain_fwd_ms"],
        "fine_bound_ms": fine["bound_fwd_ms"], "fine_max_abs_err": fine["max_abs_err_fwd"],
        "fine_train_step_ms": fine["step_ms"],
        "baseline_launches": baseline["launches"][0], "baseline_rows": baseline["rows"],
        "baseline_ms": [st["ms_fwd"] for st in baseline["stages"]],
        "baseline_plain_ms": [st["plain_fwd_ms"] for st in baseline["stages"]],
        "baseline_bound_ms": [st["bound_fwd_ms"] for st in baseline["stages"]],
        "baseline_max_abs_err": [st["max_abs_err_fwd"] for st in baseline["stages"]],
        "baseline_train_step_ms": baseline["step_ms"],
        "gt_launches": gt["launches"][0], "gt_rows": gt["rows"],
        "gt_train_step_ms": gt["step_ms"],
        "dp_launches_per_rank": [x[0] for x in scale_out["dp_k3_launches"]],
        "dp_rows_per_rank": scale_out["dp_k3_rows"],
        "llff_ndc_dense_launches": llff["dense"]["launches"][0],
        "llff_ndc_dense_rows": llff["dense"]["rows"],
        "llff_ndc_fine_launches": llff["quality"]["launches"][0],
        "llff_ndc_fine_rows": llff["quality"]["rows"],
        "widths": k3_widths("fwd")}, {
        "name": "nerf_train_backward", "route": "cuda",
        "source": "adanerf_tpu_torch/csrc/nerf_train.cu",
        "replaces": "adanerf_tpu/ops/pallas/train_kernel.py:95",
        "launches": k3_launches[1], "max_abs_err": bwd_abs, "worst_leaf_rel_err": worst[0],
        "dx_rel_err": errs["x"][0], "forced_outputs_worst_leaf_rel_err": worst_f[0],
        "dx_max_abs_err": dx_abs, "jax_check_dx_max_abs_err": jax_dx_abs, "ms": ms_k3b, "plain_ms": ms_pb,
        "bound_ms": k3_bounds_dense["bwd"][0], "bound_by": k3_bounds_dense["bwd"][1],
        "library_ms": None,
        "rows": K3_ROWS, "train_step_ms": train_ms, "kernels_ms": k3_bwd_kernels,
        "kernels_per_step": k3_step_counts, "deterministic": same,
        "fine_launches": fine["launches"][1], "fine_rows": fine["rows"],
        "fine_ms": fine["k3_bwd_ms"], "fine_plain_ms": fine["plain_bwd_ms"],
        "fine_bound_ms": fine["bound_bwd_ms"], "fine_max_abs_err": fine["max_abs_err_bwd"],
        "fine_train_step_ms": fine["step_ms"],
        "baseline_launches": baseline["launches"][1], "baseline_rows": baseline["rows"],
        "baseline_ms": [st["ms_bwd"] for st in baseline["stages"]],
        "baseline_plain_ms": [st["plain_bwd_ms"] for st in baseline["stages"]],
        "baseline_bound_ms": [st["bound_bwd_ms"] for st in baseline["stages"]],
        "baseline_max_abs_err": [st["max_abs_err_bwd"] for st in baseline["stages"]],
        "baseline_train_step_ms": baseline["step_ms"],
        "gt_launches": gt["launches"][1], "gt_rows": gt["rows"],
        "gt_train_step_ms": gt["step_ms"],
        "dp_launches_per_rank": [x[1] for x in scale_out["dp_k3_launches"]],
        "dp_rows_per_rank": scale_out["dp_k3_rows"],
        "dp_worst_leaf_rel_err": scale_out["dp_worst_leaf_rel"],
        "dp_step_ms": scale_out["dp_step_ms"],
        "dp_one_process_step_ms": scale_out["one_process_step_ms"],
        "llff_ndc_dense_launches": llff["dense"]["launches"][1],
        "llff_ndc_dense_rows": llff["dense"]["rows"],
        "llff_ndc_fine_launches": llff["quality"]["launches"][1],
        "llff_ndc_fine_rows": llff["quality"]["rows"],
        "widths": k3_widths("bwd")}, {
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
        "viewer_device_ms": stats_v3["device_ms_per_frame"],
        "fine_export_launches": exported["k2_launches"], "fine_export_800_ms": exported["k2_ms"],
        "fine_export_800_plain_ms": exported["k2_plain_ms"],
        "fine_export_800_bound_ms": exported["bound_ms"],
        "fine_export_viewer_device_ms": exported["k2_viewer_ms"],
        "sharded_4_launches": scale_out["MegakernelDense"]["launches"],
        "sharded_4_ms": scale_out["MegakernelDense"]["ms_4_slices"],
        "sharded_4_whole_ms": scale_out["MegakernelDense"]["ms_whole"],
        "widths": frame_widths("k2")}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
