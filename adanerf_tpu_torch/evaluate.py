"""Batch evaluation over experiment directories:

  python -m adanerf_tpu_torch.evaluate -data <scene> -log <log dir> \\
      [--outDir <dir>] [--force] [--evaluations E]... [--skip E]... [--device cpu]

Counterpart of the JAX package's root ``evaluate.py``, with its flags:
find the experiment directories (``-log`` itself when it holds a
``config.ini``, else every directory below it that does), re-hydrate each
from its echoed ``config.ini`` and its ``--checkPointName`` checkpoint
(``opt`` by default), and write the quality metrics and the complexity
there, or under ``--outDir/<dataset>/<experiment>``. A run whose optimal
epoch is evaluated already is skipped unless ``--force``. The default
evaluations are complexity, images, flip, psnr, ssim and output_images;
``videos`` holds the ``cam_path.json`` camera path against
``<scene>/reference_video/*.{png,jpg}`` and ``export`` writes the viewer
artifacts to ``exported_model/``. A reference frame the port cannot decode
(a progressive JPEG, ROADMAP Queue 1, item 21) is refused before any run is
loaded.

``--device`` (``-d``) is ``cuda`` by default (an index N means
``cuda:N``), ``cpu`` on request; a missing card raises and nothing falls
back.
"""

from __future__ import annotations

import argparse
import os
import sys

from .evaluation.evaluate import (DEFAULT_EVALUATIONS, evaluate, load_config,
                                  reference_frame_files)
from .train_state import resolve_device


def find_experiments(log_dir):
    """``log_dir`` when it holds a config.ini, else every directory below
    it that holds one (not descending further)."""
    if os.path.exists(os.path.join(log_dir, "config.ini")):
        return [log_dir]
    found = []
    for root, dirs, files in os.walk(log_dir):
        if "config.ini" in files:
            found.append(root)
            dirs.clear()
    return sorted(found)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('-data', '--data', required=True, type=str)
    p.add_argument('-log', '--logDir', required=True, type=str)
    p.add_argument('-d', '--device', default="cuda", type=str)
    p.add_argument('--evaluations', default=[], action='append', type=str)
    p.add_argument('--skip', default=[], action='append', type=str)
    p.add_argument('--outDir', default=None, type=str)
    p.add_argument('--force', default=False, action='store_true',
                   help='re-evaluate even if opt epoch already evaluated')
    cl = p.parse_args(argv)

    if "videos" in cl.evaluations:
        try:
            reference_frame_files(cl.data)
        except ValueError as e:
            raise SystemExit(f"adanerf_tpu_torch.evaluate: {e}") from None
    device = str(resolve_device(cl.device))

    candidates = find_experiments(cl.logDir)
    if not candidates:
        print(f"no experiment directories found under {cl.logDir}")
        return 1

    results = {}
    for path in candidates:
        print(f"Evaluating {path}")
        status, ts = load_config(cl.data, device, path, list(cl.evaluations), list(cl.skip),
                                 cl_out_dir=cl.outDir, skip_if_already_done_once=not cl.force)
        if status != 0:
            continue
        evals = list(cl.evaluations) or [e for e in DEFAULT_EVALUATIONS if e not in cl.skip]
        results[path] = (ts, evaluate(ts, None, evals))
    return results


if __name__ == "__main__":
    out = main(sys.argv[1:])
    sys.exit(out if isinstance(out, int) else 0)
