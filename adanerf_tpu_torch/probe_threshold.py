"""Probe an export's oracle: the average samples per pixel that the
adaptive select keeps at each of a list of thresholds.

Counterpart of ``tools/probe_threshold.py``. For each threshold it runs
the oracle over a whole 800x800 frame at ``--poses`` in-cell poses (the
JAX tool's seeded draw, ``np.random.RandomState(1)``) and counts each
ray's live samples as the select keeps them, ``clip((logits >= thr).sum(-1),
1, S)``. The fine configurations train with the oracle locked, so this is
what a fine model retrained at that threshold would keep. The oracle runs
in fp32, on the card unless ``--device cpu`` is given.

  python -m adanerf_tpu_torch.probe_threshold demo/trained_mscene_export --thresholds 0.2,0.01
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .viewer import build_renderer_from_export, frame_directions

SIZE = 800  # the probe's frame, w = h
BATCH = 80_000  # rays per oracle batch; the frame's rays past a whole batch are left out


def probe_renderer(export_dir, device):
    """(the fp32 renderer of an export, its scene, the probe frame's dirs)."""
    rt, scene = build_renderer_from_export(export_dir, batch_size=BATCH, dtype_str="fp32",
                                           device=device)
    return rt, scene, frame_directions(scene, SIZE, SIZE, device)


def in_cell_poses(scene, n):
    """The JAX tools' ``n`` seeded poses inside the view cell, (3,) float32."""
    rng = np.random.RandomState(1)
    center = np.asarray(scene.view_cell_center)
    return [(center + rng.uniform(-1.0, 1.0, 3) * 0.38 * scene.view_cell_radius)
            .astype(np.float32) for _ in range(n)]


def frame_logits(rt, pose, dirs):
    """The oracle's raw per-bin logits of each whole batch of a frame's
    rays at ``pose`` with the identity rotation, one (B, D) tensor a batch."""
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dirs.device)
    rot = torch.eye(3, device=dirs.device)
    B = rt.batch_size
    for s in range(0, dirs.shape[0] // B * B, B):
        with torch.no_grad():
            yield rt.oracle_logits(pose, rot, dirs[s:s + B])[-1]


def ray_counts(logits, threshold, max_samples):
    """Each ray's kept samples: ``clip((logits >= thr).sum(-1), 1, S)``."""
    return torch.clamp((logits >= threshold).sum(-1), 1, max_samples)


def frame_counts(rt, pose, dirs, threshold):
    """(n,) per-ray counts of a frame's whole batches at ``threshold``."""
    return torch.cat([ray_counts(lg, threshold, rt.max_samples)
                      for lg in frame_logits(rt, pose, dirs)])


def main(argv=None):
    """Run the probe; returns {threshold: average samples per pixel}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("export_dir")
    ap.add_argument("--thresholds", default="0.2,0.15,0.1,0.05,0.02,0.01")
    ap.add_argument("--poses", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")
    rt, scene, dirs = probe_renderer(args.export_dir, device)
    poses = in_cell_poses(scene, args.poses)
    print(f"# export={args.export_dir} max_samples={rt.max_samples} "
          f"trained_thr={rt.threshold}", flush=True)
    out = {}
    for thr in [float(t) for t in args.thresholds.split(",")]:
        out[thr] = float(np.mean([float(frame_counts(rt, p, dirs, thr).sum()) for p in poses])) \
            / dirs.shape[0]
        print(f"thr={thr:<6} avg_samples_px={out[thr]:.3f}", flush=True)
    return out


if __name__ == "__main__":
    main()
