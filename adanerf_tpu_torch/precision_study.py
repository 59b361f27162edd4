"""Bisect a frame's PSNR deficit by precision stage: render the first
``--n-frames`` of a scene's split through the plain renderer with both
MLPs in bf16 (``bf16``), the oracle alone in fp32 (``oracle32``), the
NeRF alone in fp32 (``nerf32``) and both in fp32 (``fp32``), and report
each variant's PSNR against the ground truth (over the stacked frames and
as the per-image mean that ``eval_megakernel.py`` reports) and against
the fp32 variant.

Counterpart of ``tools/precision_study.py``. The plain renderer runs
everything but the two MLPs in fp32, so the four variants isolate each
MLP's bf16 rounding; a frame kernel's bf16 frames against the ``bf16``
variant isolate what the kernel itself adds (``chip_smoke.py`` phase 21
prints that row for K1). The variants run on the card unless ``--device
cpu`` is given.

  python -m adanerf_tpu_torch.precision_study demo/trained_mscene_export demo/mscene --n-frames 2
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .eval_megakernel import BATCH, ground_truth, psnr, scene_frames
from .viewer import build_renderer_from_export, frame_directions


def main(argv=None):
    """Run the study; returns ({variant: its three PSNRs}, {variant: its
    (h, w, 3) frames})."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("export_dir")
    ap.add_argument("scene_dir")
    ap.add_argument("--set", default="test")
    ap.add_argument("--n-frames", type=int, default=2)
    ap.add_argument("--variants", default="bf16,oracle32,nerf32,fp32")
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")

    (w, h), frames = scene_frames(args.scene_dir, args.set, args.n_frames)
    gts = [ground_truth(args.scene_dir, fr)[1] for fr in frames]
    variants = args.variants.split(",")
    if "fp32" not in variants:
        variants.append("fp32")

    imgs = {}
    for v in variants:
        rt, scene = build_renderer_from_export(args.export_dir, batch_size=BATCH, dtype_str=v,
                                               device=device)
        dirs = frame_directions(scene, w, h, device)
        imgs[v] = []
        for fr in frames:
            t = np.array(fr["transform_matrix"], np.float32)
            rgb = rt.render_frame(t[:3, 3], t[:3, :3], dirs)[0]
            imgs[v].append(rgb.clamp(0, 1).reshape(h, w, 3).cpu().numpy())
        print(f"# rendered {v}", flush=True)

    out = {}
    for v in variants:
        a = np.stack(imgs[v])
        out[v] = {"psnr_gt": psnr(a, np.stack(gts)),
                  # the per-image mean, the aggregate eval_megakernel.py reports
                  "psnr_gt_mean": float(np.mean([psnr(i, g) for i, g in zip(imgs[v], gts)])),
                  "psnr_vs_fp32": psnr(a, np.stack(imgs["fp32"]))}
        print(f"{v:9s} psnr_gt={out[v]['psnr_gt']:.3f} "
              f"psnr_gt_mean={out[v]['psnr_gt_mean']:.3f} "
              f"psnr_vs_fp32={out[v]['psnr_vs_fp32']:.3f}", flush=True)
    print(json.dumps(out), flush=True)
    return out, imgs


if __name__ == "__main__":
    main()
