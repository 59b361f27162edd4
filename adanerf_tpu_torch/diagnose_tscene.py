"""Diagnose a fine run's PSNR drop against its dense run: render a strided
ray subset of one test image through both experiments of a scene on the
plain path (``render.py``) and decompose the fine error into three causes:

  1. the premultiplied-alpha ceiling: with ``accumulationMult = alpha`` a
     sample's composite weight is bounded by the oracle's mass p_s, so a
     ray's accumulated weight cannot exceed 1 - prod_live(1 - p_s); read
     as the PSNR of the ground truth clipped to that ceiling and as the
     PSNR of the weight-normalized fine render rgb / sum(weights);
  2. z placement: the fine run's top-weight depth against the dense run's
     expected depth;
  3. the residual shading error that normalization and placement leave.

Counterpart of ``tools/diagnose_tscene.py``, with its arguments; the runs
render on the card unless ``--device cpu`` is given.

  python -m adanerf_tpu_torch.diagnose_tscene --data demo/tscene --log demo/tlogs --stride 8
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .eval_megakernel import psnr
from .evaluation.evaluate import load_config
from .pipeline.keys import FSK
from .render import render_rays_chunked


def find_experiment(log_dir, scene, tag):
    base = os.path.join(log_dir, scene)
    cands = [d for d in sorted(os.listdir(base)) if tag in d]
    if not cands:
        raise SystemExit(f"no experiment dir matching {tag!r} under {base}")
    return os.path.join(base, cands[0])


def main(argv=None):
    """Run the diagnosis; returns {"dense": ..., "fine": ...} of each run's
    (gt, rgb clipped, rgb raw, extras) on the ray subset."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--log", required=True)
    ap.add_argument("--dense-tag", default="(0.0)")
    ap.add_argument("--fine-tag", default=None,
                    help="substring of the fine experiment dir (default: the first dir that "
                         "is not the dense one)")
    ap.add_argument("--image", type=int, default=0)
    ap.add_argument("--stride", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args(argv)

    scene = os.path.basename(os.path.normpath(args.data))
    dense_dir = find_experiment(args.log, scene, args.dense_tag)
    if args.fine_tag:
        fine_dir = find_experiment(args.log, scene, args.fine_tag)
    else:
        base = os.path.join(args.log, scene)
        others = [d for d in sorted(os.listdir(base))
                  if args.dense_tag not in d and os.path.isdir(os.path.join(base, d))]
        if not others:
            raise SystemExit("no fine experiment dir found")
        fine_dir = os.path.join(base, others[0])
    print(f"dense: {dense_dir}\nfine:  {fine_dir}")

    results = {}
    for name, path in (("dense", dense_dir), ("fine", fine_dir)):
        status, ts = load_config(args.data, args.device, path, ["images"], [],
                                 skip_if_already_done_once=False)
        if status != 0:
            raise SystemExit(f"load_config failed for {path}")
        h, w = ts.h, ts.w
        pix = np.arange(0, h * w, args.stride, dtype=np.int64)
        gt = ts.test_dataset.color_images[args.image].reshape(-1, 3)[pix]
        collect = [FSK.nerf_input_feature_z_vals, FSK.nerf_weights_output,
                   FSK.oracle_weights, FSK.adaptive_sample_positions,
                   FSK.nerf_estimated_depth]
        imgs, extras = render_rays_chunked(
            ts, ts.test_dataset.poses[args.image], ts.test_dataset.rotations[args.image],
            args.chunk, collect=collect, pixel_indices=pix)
        results[name] = (gt, np.clip(imgs[-1][:, :3], 0.0, 1.0), imgs[-1][:, :3], extras)
        print(f"{name}: rendered {len(pix)} rays")

    gt, rgb_d, _, ex_d = results["dense"]
    _, rgb_f, rgb_f_raw, ex_f = results["fine"]

    print(f"\n== 0. sanity: subset PSNR (image {args.image}, "
          f"stride {args.stride}) ==")
    p_dense = psnr(rgb_d, gt)
    p_fine = psnr(rgb_f, gt)
    print(f"dense PSNR {p_dense:.2f} dB | fine PSNR {p_fine:.2f} dB | "
          f"delta {p_fine - p_dense:+.2f} dB")

    # -- 1. premultiplied-alpha ceiling --------------------------------------
    print("\n== 1. premultiplied-alpha ceiling ==")
    w_f = ex_f[FSK.nerf_weights_output]          # (rays, S) composite weights
    mask = ex_f.get(FSK.adaptive_sample_positions)
    probs = ex_f.get(FSK.oracle_weights)         # z_probs at selected slots
    accw = w_f.sum(axis=1, keepdims=True)        # accumulated weight
    print(f"accumulated weight: mean {accw.mean():.4f} "
          f"p5 {np.percentile(accw, 5):.4f} p50 {np.percentile(accw, 50):.4f} "
          f"p95 {np.percentile(accw, 95):.4f}")
    if probs is not None:
        # adaptive_sample_positions is a per-ray live COUNT; z_probs packs 0
        # at dead slots already, but mask by count when shapes allow
        if mask is not None and mask.ndim == 2 and mask.shape == probs.shape:
            p_live = np.where(mask > 0, probs, 0.0)
        elif mask is not None and mask.ndim == 1:
            slot = np.arange(probs.shape[1])[None, :]
            p_live = np.where(slot < mask[:, None], probs, 0.0)
        else:
            p_live = probs
        mass = 1.0 - np.prod(1.0 - np.clip(p_live, 0.0, 1.0), axis=1,
                             keepdims=True)
        print(f"oracle ceiling 1-prod(1-p): mean {mass.mean():.4f} "
              f"p50 {np.percentile(mass, 50):.4f} "
              f"p5 {np.percentile(mass, 5):.4f}")
        gt_max = gt.max(axis=1, keepdims=True)
        over = (gt_max > mass + 1e-6).mean()
        print(f"rays whose GT brightness exceeds the oracle ceiling: "
              f"{100 * over:.1f}%")
        clipped = np.minimum(gt, mass)
        print(f"ceiling-clipped-GT PSNR (best possible through this "
              f"oracle): {psnr(clipped, gt):.2f} dB")
    norm = np.clip(rgb_f_raw / np.maximum(accw, 1e-6), 0.0, 1.0)
    print(f"weight-NORMALIZED fine PSNR rgb/sum(w): {psnr(norm, gt):.2f} dB "
          f"(vs raw fine {p_fine:.2f})")

    # -- 2. z placement -------------------------------------------------------
    print("\n== 2. z placement (fine top-weight z vs dense expected depth) ==")
    z_f = ex_f[FSK.nerf_input_feature_z_vals]
    top = np.argmax(w_f, axis=1)
    z_top = z_f[np.arange(len(top)), top]
    # estimated depth is sum(w*z) — normalize by the accumulated weight so
    # a sub-1 weight sum doesn't masquerade as a placement shift
    accw_d = ex_d[FSK.nerf_weights_output].sum(axis=1)
    d_dense = ex_d[FSK.nerf_estimated_depth][:, 0] / np.maximum(accw_d, 1e-6)
    raw = z_top - d_dense
    # the two channels differ by a constant convention offset (fine z is
    # measured from the ray's sphere-entry point, the dense estimate from
    # the camera) — the placement signal is the residual around the median
    off = float(np.median(raw))
    dz = np.abs(raw - off)
    rng = float(d_dense.max() - d_dense.min() + 1e-9)
    print(f"constant convention offset {off:+.4f}; residual |dz|: "
          f"p50 {np.percentile(dz, 50):.4f} p90 {np.percentile(dz, 90):.4f} "
          f"p99 {np.percentile(dz, 99):.4f} (dense depth span {rng:.3f})")

    # -- 3. error decomposition ----------------------------------------------
    print("\n== 3. per-ray error decomposition ==")
    err = ((rgb_f - gt) ** 2).mean(axis=1)
    err_n = ((norm - gt) ** 2).mean(axis=1)
    err_d = ((rgb_d - gt) ** 2).mean(axis=1)
    tot = err.sum()
    print(f"fine MSE {err.mean():.6f} | normalized {err_n.mean():.6f} | "
          f"dense {err_d.mean():.6f}")
    print(f"fraction of fine sq-error removed by weight normalization: "
          f"{100 * (1 - err_n.sum() / max(tot, 1e-12)):.1f}%")
    hi = err >= np.percentile(err, 90)
    print(f"top-decile error rays: accw mean {accw[hi].mean():.4f} "
          f"(vs {accw[~hi].mean():.4f} elsewhere), "
          f"|dz| p50 {np.percentile(dz[hi[:, 0] if hi.ndim > 1 else hi], 50):.4f}")
    print(f"corr(err, 1-accw) = "
          f"{np.corrcoef(err, (1 - accw[:, 0]))[0, 1]:.3f}; "
          f"corr(err, |dz|) = {np.corrcoef(err, dz)[0, 1]:.3f}")

    return results


if __name__ == "__main__":
    main()
