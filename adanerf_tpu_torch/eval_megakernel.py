"""Frame quality through the frame kernels on one model: render a scene's
test split (or ``--orbit N`` in-cell poses) of an export through K1
(``--variant v5d`` / ``v5``, the default) or K2 (``v3``), the kernels the
viewer times, and report per image the PSNR against the ground-truth
images and the kernel's samples per pixel; with ``--fp32-delta`` also the
fp32 plain renderer's PSNR and the kernel's PSNR against it.

Counterpart of ``tools/eval_megakernel.py``: the check of the reference's
claim that its viewer renders "within 0.1 dB" of the offline evaluator.
``--mlp-f32`` renders through the kernels' fp32 build, whose every MLP sum
is an fp32 sum (what the flag asks of the TPU kernel). ``--pack-f32``,
``--oracle-split``, ``--nerf-split`` and a ``--tile`` other than 256 are
the TPU kernel's precision and tiling workarounds; the kernels here have no
such knobs, and each is refused by name. On the card the kernel renders
each whole frame; with ``--device cpu`` its plain PyTorch version renders
it, ``80,000`` rays at a time, as the viewer's.

  python -m adanerf_tpu_torch.eval_megakernel demo/trained_mscene_export demo/mscene --fp32-delta
  python -m adanerf_tpu_torch.eval_megakernel demo/trained_ndc_export --orbit 4
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .data.png import read_image, require_broadcast, write_png
from .viewer import (build_kernel, build_renderer_from_export, frame_directions,
                     kernel_frame, orbit_poses)

BATCH = 80_000  # rays per batch of the plain renderers, as the JAX tool's
# the TPU kernel's workarounds, with why the kernels here need none
REFUSED = {
    "pack_f32": "--pack-f32 stores fp32 weights but multiplies at the TPU MXU's default bf16 "
                "input rounding; K1/K2's fp32 build stores and multiplies in fp32 (--mlp-f32) "
                "and the bf16 build rounds both, so there is no third precision to isolate",
    "oracle_split": "--oracle-split is the TPU kernel's hi/lo two-pass split of the oracle's "
                    "activations; the kernels here have no such pass (--mlp-f32 gives fp32 sums)",
    "nerf_split": "--nerf-split is the TPU kernel's hi/lo two-pass split of the NeRF's "
                  "activations; the kernels here have no such pass (--mlp-f32 gives fp32 sums)",
}


def psnr(a, b):
    mse = float(np.mean((a - b) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def scene_frames(scene_dir, split, n_frames=0):
    """(resolution (w, h), the split's frames) of a scene directory, the
    first ``n_frames`` of them where that is not 0."""
    with open(os.path.join(scene_dir, "dataset_info.json")) as f:
        w, h = json.load(f)["resolution"]
    with open(os.path.join(scene_dir, f"transforms_{split}.json")) as f:
        frames = json.load(f)["frames"]
    return (w, h), frames[:n_frames] if n_frames else frames


def ground_truth(scene_dir, frame):
    """(name, (h, w, 3) float32 in [0, 1]) of a split frame's image."""
    path = os.path.join(scene_dir, frame["file_path"][2:] + ".png")
    return os.path.basename(path), read_image(path).astype(np.float32)[..., :3] / 255.0


def main(argv=None):
    """Run the tool; returns {"rows": [per-image dict], "mean": dict,
    "frames": [(h, w, 3) kernel frames], "fp32_frames": [...] or None}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("export_dir")
    ap.add_argument("scene_dir", nargs="?", default=None,
                    help="scene with the ground truth; omit with --orbit to compare the kernel "
                         "against the fp32 plain renderer only")
    ap.add_argument("--out", default=None, help="write the kernel's frames here as PNG")
    ap.add_argument("--set", default="test")
    ap.add_argument("--fp32-delta", action="store_true",
                    help="also render through the fp32 plain renderer and report the "
                         "kernel's PSNR against it")
    ap.add_argument("--variant", default="v5", choices=["v5d", "v5", "v3"],
                    help="v5d, v5: K1, the compacted kernel; v3: K2, the dense-slot kernel")
    ap.add_argument("--n-frames", type=int, default=0,
                    help="the first N frames of the split (0 = all)")
    ap.add_argument("--tile", type=int, default=256,
                    help="the TPU kernel's ray tile; the kernels here take 256 only")
    ap.add_argument("--mlp-f32", action="store_true",
                    help="the kernel's fp32 build: every MLP sum in fp32")
    ap.add_argument("--pack-f32", action="store_true", help="refused: " + REFUSED["pack_f32"])
    ap.add_argument("--oracle-split", action="store_true",
                    help="refused: " + REFUSED["oracle_split"])
    ap.add_argument("--nerf-split", action="store_true", help="refused: " + REFUSED["nerf_split"])
    ap.add_argument("--orbit", type=int, default=0,
                    help="render N in-cell orbit poses instead of a split (implies "
                         "--fp32-delta, against fp32 only)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' renders through the CUDA kernel; 'cpu' through its plain version")
    args = ap.parse_args(argv)
    for flag, why in REFUSED.items():
        if getattr(args, flag):
            raise SystemExit(why)
    if args.tile != 256:
        raise SystemExit(f"--tile {args.tile}: the tile is the TPU kernel's ray block; K1 "
                         "compacts the whole frame and K2 shades every slot, with no tile to set")
    if args.orbit == 0 and args.scene_dir is None:
        ap.error("need a scene_dir or --orbit N")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for the plain path")

    rt, scene = build_renderer_from_export(args.export_dir, batch_size=BATCH,
                                           dtype_str="fp32" if args.mlp_f32 else "bf16",
                                           device=device)
    if args.orbit:
        args.fp32_delta = True
        w, h = (scene.w, scene.h) if scene.w > 0 else (800, 800)
        eye = np.eye(3, dtype=np.float32)
        frames = [{"pose": p, "rot": eye, "name": f"orbit{i:02d}.png"} for i, p in enumerate(
            orbit_poses(scene.view_cell_center, 0.4 * scene.view_cell_radius, args.orbit))]
    else:
        (w, h), frames = scene_frames(args.scene_dir, args.set, args.n_frames)
    dirs = frame_directions(scene, w, h, device)
    kernel = build_kernel(rt, args.variant)
    rt32 = None
    if args.fp32_delta:
        rt32, _ = build_renderer_from_export(args.export_dir, batch_size=BATCH,
                                             dtype_str="fp32", device=device)

    rows, imgs, refs = [], [], []
    for fr in frames:
        gt = None
        if args.orbit:
            pose, rot, name = fr["pose"], fr["rot"], fr["name"]
        else:
            t = np.array(fr["transform_matrix"], np.float32)
            pose, rot = t[:3, 3], t[:3, :3]
            name, gt = ground_truth(args.scene_dir, fr)
        rgb, counts = kernel_frame(kernel, dirs, pose, rot, BATCH)
        img = rgb.clamp(0, 1).reshape(h, w, 3).cpu().numpy()
        row = {"name": name, "avg_samples": float(counts.float().mean())}
        if gt is not None:
            require_broadcast(img, gt, os.path.join(args.scene_dir, fr["file_path"][2:] + ".png"),
                              "the JAX tool's psnr (tools/eval_megakernel.py:135)")
            row["psnr_mk"] = psnr(img, gt)
        if rt32 is not None:
            ref = rt32.render_frame(pose, rot, dirs)[0].clamp(0, 1).reshape(h, w, 3).cpu().numpy()
            refs.append(ref)
            if gt is not None:
                row["psnr_fp32"] = psnr(ref, gt)
            row["psnr_mk_vs_fp32"] = psnr(img, ref)
        rows.append(row)
        imgs.append(img)
        print(" ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in row.items()), flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            write_png(os.path.join(args.out, name), (img * 255).astype(np.uint8))

    mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0] if k != "name"}
    print(json.dumps({"set": args.set, "n": len(rows), **mean}), flush=True)
    return {"rows": rows, "mean": mean, "frames": imgs, "fp32_frames": refs or None}


if __name__ == "__main__":
    main()
