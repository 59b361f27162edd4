"""The demo pipelines: the port's counterpart of the JAX package's
``tools/run_mscene_pipeline.sh``, ``run_tscene_pipeline.sh``,
``run_ndc_pipeline.sh``, ``run_r5_queue.sh`` (leg A) and the 300k legs of
``run_r5_queue.sh`` (B) and ``run_r5_fine.sh``:

  python -m adanerf_tpu_torch.pipelines {mscene,tscene,ndc,mscene_thr001,mscene300} \\
      [--log-root DIR] [--export-root DIR] [--device DEV] [--leg-args LEG "ARGS"]...

Each recipe holds its script's trainer arguments verbatim and runs the
script's steps in order through the port, from the repo root (the scripts
``cd`` there, and their paths are relative to it):

1. the training legs, each under ``python -m adanerf_tpu_torch.supervise_train``
   with the script's log file and ``--stall-min`` (the trainer runs with
   ``python -u``, so every line it prints moves the log's mtime, which the
   supervisor reads);
2. ``export`` with the last leg's arguments;
3. the copy of that run's ``exported_model`` (the first run directory
   whose name holds the leg's threshold) to the export folder;
4. ``evaluate`` over the log folder, where the script runs ``evaluate.py``;
5. ``eval_megakernel <export> <scene> --fp32-delta``, where the script runs
   ``tools/eval_megakernel.py``.

Steps 2-5 run in this process, their output also appended to the script's
log file where it ``tee``s one. The scripts' ``bench.py`` steps wait for the
port's bench (ROADMAP Queue 1, item 2): each is printed as skipped. A step
that fails ends the pipeline with exit 1.

``--log-root`` replaces the scripts' ``demo`` folder for the training logs,
the run folders and the log files (``demo/mlogs`` becomes
``<log-root>/mlogs``), ``--export-root`` for the export folder
(``demo/trained_mscene_export``); both default to ``demo``, which the
scripts write. ``--device`` is appended to every port command (the port
runs on ``cuda`` by default). ``--leg-args LEG ARGS`` appends ``ARGS``
(split as a shell splits them) to a leg's trainer arguments, and to the
export's for the last leg: later flags win, so ``-e``, ``-Er``, ``-Ev`` and
``-Eckpt`` cut a run short.

The ``mscene`` and ``ndc`` recipes pass no ``--bf16``, as their scripts:
the port then trains them on the plain fp32 path (K3 needs ``--bf16`` on
CUDA, ``train_state.py::train_apply_fns``). The ``tscene`` and r5 recipes
pass ``--bf16``, so their NeRF trains through K3. ``mscene300``'s fine leg
is ``run_r5_fine.sh``'s (75,001 epochs, the ini's loss blending), which
replaced ``run_r5_queue.sh``'s leg C.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os
import shlex
import shutil
import subprocess
import sys
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_ITEM = "ROADMAP Queue 1, item 2"

# ---- tools/run_mscene_pipeline.sh -------------------------------------------
MSCENE_DENSE_ARGS = """-c configs/dense_training.ini -data demo/mscene -log demo/mlogs
    -e 100001 --lossBlendingStart 10000 --lossBlendingDuration 30000
    --epochsLockWeightsBefore -1 --epochsLockWeightsBefore 1001
    --epochsLockWeightsAfter 90000 --epochsLockWeightsAfter -1
    -Er 50000 -Ev 25000 -Eckpt 20000"""
MSCENE_FINE_ARGS = """-c configs/fine_training.ini -data demo/mscene -log demo/mlogs
    -e 40001 --numRaymarchSamples 8 --numRaymarchSamples 8
    --adaptiveSamplingThreshold 0.2
    --lossBlendingStart 10000 --lossBlendingDuration 30000
    --preTrained demo/mlogs/mscene --preTrained demo/mlogs/mscene
    -Er 20000 -Ev 10000 -Eckpt 10000"""
# ---- tools/run_tscene_pipeline.sh -------------------------------------------
TSCENE_DENSE_ARGS = """-c configs/dense_training.ini -data demo/tscene -log demo/tlogs
    -e 100001 --lossBlendingStart 10000 --lossBlendingDuration 30000
    --epochsLockWeightsBefore -1 --epochsLockWeightsBefore 1001
    --epochsLockWeightsAfter 90000 --epochsLockWeightsAfter -1
    -Er 50000 -Ev 25000 -Eckpt 20000 --bf16"""
TSCENE_FINE_ARGS = """-c configs/fine_training.ini -data demo/tscene -log demo/tlogs
    -e 40001 --numRaymarchSamples 8 --numRaymarchSamples 8
    --adaptiveSamplingThreshold 0.2
    --lossBlendingStart 10000 --lossBlendingDuration 30000
    --preTrained demo/tlogs/tscene --preTrained demo/tlogs/tscene
    -Er 20000 -Ev 10000 -Eckpt 10000 --bf16"""
# ---- tools/run_ndc_pipeline.sh ----------------------------------------------
NDC_DENSE_ARGS = """-c configs/dense_training_ndc.ini -data demo/llff_scene
    -log demo/ndclogs -e 60001
    --lossBlendingStart 5000 --lossBlendingDuration 20000
    --epochsLockWeightsBefore -1 --epochsLockWeightsBefore 1001
    --epochsLockWeightsAfter 50000 --epochsLockWeightsAfter -1
    -Er 30000 -Ev 15000 -Eckpt 10000"""
NDC_FINE_ARGS = """-c configs/fine_training_ndc.ini -data demo/llff_scene
    -log demo/ndclogs -e 25001
    --lossBlendingStart 5000 --lossBlendingDuration 20000
    --preTrained demo/ndclogs/llff_scene --preTrained demo/ndclogs/llff_scene
    -Er 12000 -Ev 6000 -Eckpt 6000"""
# ---- tools/run_r5_queue.sh (F001_ARGS, D300_ARGS) ---------------------------
F001_ARGS = """-c configs/fine_training.ini -data demo/mscene -log demo/mlogs
    -e 40001 --numRaymarchSamples 8 --numRaymarchSamples 8
    --adaptiveSamplingThreshold 0.01
    --lossBlendingStart 10000 --lossBlendingDuration 30000
    --preTrained demo/mlogs/mscene --preTrained demo/mlogs/mscene
    -Er 40000 -Ev 40000 -Eckpt 10000 --nonVerbose --dispatchSleepMs 10
    --bf16 --performEvaluation --checkpointParamsOnly 1"""
D300_ARGS = """-c configs/dense_training.ini -data demo/mscene -log demo/m300logs
    -Er 300000 -Ev 300000 -Eckpt 25000 --nonVerbose --dispatchSleepMs 14
    --bf16 --performEvaluation --checkpointParamsOnly 1"""
# ---- tools/run_r5_fine.sh (F300_ARGS) ---------------------------------------
F300_ARGS = """-c configs/fine_training.ini -data demo/mscene -log demo/m300logs
    -e 75001 --numRaymarchSamples 8 --numRaymarchSamples 8
    --adaptiveSamplingThreshold 0.2
    --preTrained demo/m300logs/mscene --preTrained demo/m300logs/mscene
    -Er 75000 -Ev 75000 -Eckpt 25000 --nonVerbose --dispatchSleepMs 10
    --bf16 --performEvaluation --checkpointParamsOnly 1"""

# recipe -> (the script, [(leg, trainer args, its log file, --stall-min)],
# (the logs' run folder, the threshold in the run's name), the export folder,
# the scene, whether the script runs evaluate.py, whether it runs
# eval_megakernel (and to which log), the bench's log, the script's last line)
RECIPES = {
    "mscene": ("tools/run_mscene_pipeline.sh",
               [("dense", MSCENE_DENSE_ARGS, "demo/mdense_train.log", 12),
                ("fine", MSCENE_FINE_ARGS, "demo/mfine_train.log", 12)],
               ("demo/mlogs/mscene", "(0.2)"), "demo/trained_mscene_export", "demo/mscene",
               None, "demo/mscene_eval.log", "demo/mscene_bench.log", "PIPELINE DONE"),
    "tscene": ("tools/run_tscene_pipeline.sh",
               [("dense", TSCENE_DENSE_ARGS, "demo/tdense_train.log", 12),
                ("fine", TSCENE_FINE_ARGS, "demo/tfine_train.log", 12)],
               ("demo/tlogs/tscene", "(0.2)"), "demo/trained_tscene_export", "demo/tscene",
               "demo/tscene_quality.log", "demo/tscene_eval.log", "demo/tscene_bench.log",
               "PIPELINE DONE"),
    "ndc": ("tools/run_ndc_pipeline.sh",
            [("dense", NDC_DENSE_ARGS, "demo/ndc_dense_train.log", 12),
             ("fine", NDC_FINE_ARGS, "demo/ndc_fine_train.log", 12)],
            ("demo/ndclogs/llff_scene", "(0.15)"), "demo/trained_ndc_export",
            "demo/llff_scene", None, "demo/ndc_eval.log", "demo/ndc_bench.log",
            "NDC PIPELINE DONE"),
    "mscene_thr001": ("tools/run_r5_queue.sh",
                      [("fine", F001_ARGS, "demo/mfine001_train.log", 15)],
                      ("demo/mlogs/mscene", "(0.01)"), "demo/trained_mscene_thr001_export",
                      "demo/mscene", None, None, "demo/mscene_thr001_bench.log",
                      "QUEUE DONE"),
    "mscene300": ("tools/run_r5_fine.sh",  # its dense leg is run_r5_queue.sh's leg B
                  [("dense", D300_ARGS, "demo/m300dense_train.log", 20),
                   ("fine", F300_ARGS, "demo/m300fine_train.log", 15)],
                  ("demo/m300logs/mscene", "(0.2)"), "demo/trained_mscene300_export",
                  "demo/mscene", None, None, "demo/mscene300_bench.log", "FINE LEG DONE"),
}


@dataclass
class Step:
    """One step of a recipe: ``kind`` train, export, copy, evaluate,
    eval_megakernel or bench; ``argv`` its port command's arguments (for
    train, the trainer's; for copy, the run folder's glob and the export
    folder); ``leg`` a training leg's name (the last leg's for export, the
    script's for bench); ``log`` the file the script writes its output
    to; ``stall_min`` a training leg's."""
    kind: str
    argv: list
    leg: str = ""
    log: str = ""
    stall_min: float = 0.0

    def command(self) -> list:
        """A training leg's supervised command line."""
        return [sys.executable, "-m", "adanerf_tpu_torch.supervise_train", "--log", self.log,
                "--stall-min", f"{self.stall_min:g}", "--", sys.executable, "-u", "-m",
                "adanerf_tpu_torch.train", *self.argv]


def _under(path: str, root: str) -> str:
    """A script path under ``demo/`` moved under ``root``."""
    assert path.startswith("demo/"), path
    return os.path.join(root, path[len("demo/"):])


def _relocate(args: list, log_root: str) -> list:
    """A leg's arguments with its log folder and teachers under ``log_root``."""
    out = list(args)
    for i, a in enumerate(out[:-1]):
        if a in ("-log", "--preTrained"):
            out[i + 1] = _under(out[i + 1], log_root)
    return out


def recipe(name: str, log_root: str = "demo", export_root: str = "demo", device=None,
           leg_args=None) -> list:
    """The steps of recipe ``name`` in its script's order (see the module
    docstring); ``leg_args`` maps a leg to arguments appended to its own."""
    script, legs, (runs, thr), export, scene, quality_log, eval_log, bench_log, _ = \
        RECIPES[name]
    leg_args = leg_args or {}
    dev = ["--device", device] if device else []
    steps = []
    for leg, args, log, stall in legs:
        argv = _relocate(shlex.split(args), log_root) + list(leg_args.get(leg, [])) + dev
        steps.append(Step("train", argv, leg, _under(log, log_root), stall))
    last = steps[-1].argv
    export_dir = _under(export, export_root)
    steps.append(Step("export", last, steps[-1].leg))
    steps.append(Step("copy", [os.path.join(_under(runs, log_root), f"*{thr}*"), export_dir]))
    if quality_log:
        log_dir = _under(runs, log_root).rsplit("/", 1)[0]
        steps.append(Step("evaluate", ["-data", scene, "-log", log_dir] + dev,
                          log=_under(quality_log, log_root)))
    if eval_log:
        steps.append(Step("eval_megakernel", [export_dir, scene, "--fp32-delta"] + dev,
                          log=_under(eval_log, log_root)))
    steps.append(Step("bench", ["--export-dir", export_dir], log=_under(bench_log, log_root),
                      leg=script))
    return steps


class _Tee:
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for f in self.streams:
            f.write(s)
        return len(s)

    def flush(self):
        for f in self.streams:
            f.flush()


def run_step(step: Step):
    """Run one step (from the repo root, as the scripts run); returns what
    an in-process step's ``main`` returns, a leg's exit code."""
    if step.kind == "train":
        print(f"[pipeline] {' '.join(step.command())}", flush=True)
        os.makedirs(os.path.dirname(step.log) or ".", exist_ok=True)
        return subprocess.run(step.command(), cwd=ROOT).returncode
    if step.kind == "copy":
        pattern, dst = step.argv
        runs = sorted(d for d in glob.glob(pattern) if os.path.isdir(d))
        if not runs:
            raise RuntimeError(f"no run folder matches {pattern}")
        print(f"[pipeline] cp -r {runs[0]}/exported_model {dst}", flush=True)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(runs[0], "exported_model"), dst)
        return 0
    if step.kind == "bench":
        print(f"[pipeline] skipping {step.leg}'s bench.py {' '.join(step.argv)} (the port's "
              f"bench waits for {BENCH_ITEM})", flush=True)
        return 0
    from . import eval_megakernel, evaluate, export
    fn = {"export": export.main, "evaluate": evaluate.main,
          "eval_megakernel": eval_megakernel.main}[step.kind]
    print(f"[pipeline] python -m adanerf_tpu_torch.{step.kind} {' '.join(step.argv)}",
          flush=True)
    if not step.log:
        return fn(list(step.argv))
    os.makedirs(os.path.dirname(step.log) or ".", exist_ok=True)
    with open(step.log, "w") as f, contextlib.redirect_stdout(_Tee(sys.stdout, f)):
        return fn(list(step.argv))


def run(name: str, **kwargs) -> int:
    """Run recipe ``name`` from the repo root; 0 when every step ran."""
    os.chdir(ROOT)
    for step in recipe(name, **kwargs):
        if step.kind == "train" and run_step(step) != 0:
            print(f"[pipeline] {step.leg} leg failed", flush=True)
            return 1
        if step.kind != "train":
            run_step(step)
    print(RECIPES[name][-1], flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("recipe", choices=sorted(RECIPES))
    ap.add_argument("--log-root", default="demo",
                    help="the folder of the training logs and runs (the scripts' demo)")
    ap.add_argument("--export-root", default="demo",
                    help="the folder the export is copied into (the scripts' demo)")
    ap.add_argument("--device", default=None, help="appended to every port command")
    ap.add_argument("--leg-args", nargs=2, action="append", default=[], metavar=("LEG", "ARGS"),
                    help="arguments appended to a leg's trainer arguments")
    args = ap.parse_args(argv)
    legs = {leg for leg, *_ in RECIPES[args.recipe][1]}
    leg_args = {}
    for leg, extra in args.leg_args:
        if leg not in legs:
            ap.error(f"recipe {args.recipe} has no leg {leg!r} (legs: {sorted(legs)})")
        leg_args[leg] = leg_args.get(leg, []) + shlex.split(extra)
    return run(args.recipe, log_root=args.log_root, export_root=args.export_root,
               device=args.device, leg_args=leg_args)


if __name__ == "__main__":
    sys.exit(main())
