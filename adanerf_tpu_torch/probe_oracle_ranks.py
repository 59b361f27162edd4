"""Per-rank oracle statistics of an export: the mean and percentiles of
each ray's k-th largest oracle bin value over one 800x800 frame, which
tell whether a threshold exists that keeps two or more bins per ray (a
second surface mode) and where it lies.

Counterpart of ``tools/probe_oracle_ranks.py``: the first of the JAX
tools' seeded in-cell poses, the oracle in fp32, on the card unless
``--device cpu`` is given.

  python -m adanerf_tpu_torch.probe_oracle_ranks demo/trained_mscene_export
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .probe_threshold import frame_logits, in_cell_poses, probe_renderer


def main(argv=None):
    """Run the probe; returns the (rays, ranks) array of each ray's
    largest oracle values, in descending order."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("export_dir")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")
    rt, scene, dirs = probe_renderer(args.export_dir, device)
    pose = in_cell_poses(scene, 1)[0]
    tops = torch.cat([torch.topk(lg, args.ranks, dim=-1).values
                      for lg in frame_logits(rt, pose, dirs)]).cpu().numpy()
    print(f"# export={args.export_dir} rays={tops.shape[0]}")
    print("rank  mean      p50       p90       p99")
    for k in range(args.ranks):
        v = tops[:, k]
        print(f"{k + 1:>4}  {v.mean():.5f}  {np.percentile(v, 50):.5f}  "
              f"{np.percentile(v, 90):.5f}  {np.percentile(v, 99):.5f}", flush=True)
    return tops


if __name__ == "__main__":
    main()
