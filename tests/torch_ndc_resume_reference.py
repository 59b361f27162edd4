"""The JAX package's own resume of its committed fine NDC run
(``demo/ndclogs/llff_scene``, threshold 0.15), on the CPU, that
``chip_smoke.py`` phase 19 holds the port's resume on the card to.

  python tests/torch_ndc_resume_reference.py [--precision fp32|tpu] [--write]

The root ``train.py`` resumes the run's ``config.ini`` from its 0006000
checkpoints (weights and Adam state of both nets) on ``demo/llff_scene``,
trains STEPS steps and validates at the last epoch; render, video,
checkpoint and evaluation legs are off. ``--precision tpu`` makes every
``jnp.einsum`` that asks for no precision take one bf16 pass with f32
sums, as a TPU's DEFAULT precision does, which is how the committed run
was made (ROADMAP Queue 3, F10; ``tests/test_torch_ndc_validation.py``).
The last line is one JSON object: the validation loss and accuracy and the
seconds it took. ``--write`` also stores that object, under its precision,
in ``tests/torch_fixtures/ndc_resume_jax.json``. The run takes about 1.7 s
a step on 8 host cores.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import re
import runpy
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = glob.glob(os.path.join(glob.escape(os.path.join(ROOT, "demo", "ndclogs", "llff_scene")),
                             "*LSfCDA_(0.15)*"))[0]
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "ndc_resume_jax.json")
RESUME, STEPS = 6000, 1000


def one_bf16_pass(jnp):
    """Make ``jnp.einsum`` without a precision round its f32 operands to
    bf16 (products exact, sums in f32): a TPU's DEFAULT precision."""
    einsum = jnp.einsum

    def einsum_default_precision(spec, *ops, **kw):
        if kw.get("precision") is None:
            ops = [o.astype(jnp.bfloat16).astype(jnp.float32)
                   if getattr(o, "dtype", None) == jnp.float32 else o for o in ops]
        return einsum(spec, *ops, **kw)

    jnp.einsum = einsum_default_precision


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--precision", choices=("fp32", "tpu"), default="fp32")
    ap.add_argument("--write", action="store_true", help=f"store the result in {FIXTURE}")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax.numpy as jnp
    if args.precision == "tpu":
        one_bf16_pass(jnp)
    epoch = RESUME + STEPS
    with tempfile.TemporaryDirectory(prefix="ndc_resume_jax_") as log:
        run_dir = os.path.join(log, "llff_scene", os.path.basename(RUN))
        os.makedirs(run_dir)
        with open(os.path.join(RUN, "config.ini")) as f:
            config = f.read()
        config = re.sub(r"\nlogDir = .*", "", config)
        config = config.replace("performEvaluation = True", "performEvaluation = False")
        with open(os.path.join(log, "config.ini"), "w") as f:
            f.write(config)
        for name in os.listdir(RUN):
            if f"_{RESUME:07d}." in name:
                shutil.copy(os.path.join(RUN, name), run_dir)
        sys.argv = ["train.py", "-c", os.path.join(log, "config.ini"),
                    "-data", os.path.join(ROOT, "demo", "llff_scene"), "-log", log,
                    "--epochs", str(epoch + 1), "-Ev", str(epoch), "-Er", "1000000",
                    "-Eckpt", "1000000", "--epochsVideo", "-1"]
        t = time.perf_counter()
        runpy.run_path(os.path.join(ROOT, "train.py"), run_name="__main__")
        seconds = time.perf_counter() - t
        with open(os.path.join(run_dir, "logs.csv")) as f:
            row = {r["epoch"]: r for r in csv.DictReader(f)}[str(epoch)]
    out = {"precision": args.precision, "resumed_at": RESUME, "steps": STEPS,
           "epoch": epoch, "val_loss": float(row["loss"]), "accuracy": float(row["accuracy"]),
           "seconds": seconds}
    if args.write:
        fixture = {}
        if os.path.exists(FIXTURE):
            with open(FIXTURE) as f:
                fixture = json.load(f)
        fixture[args.precision] = out
        with open(FIXTURE, "w") as f:
            json.dump(fixture, f, indent=1)
            f.write("\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
