"""``python -m adanerf_tpu_torch.train`` on the repo's other two
configurations, ``adanerf_tpu_torch/configs/nerf_baseline.ini`` and
``gt_depth_training.ini``, scaled down by flags (4 x 32 nets, few
samples), for a few epochs with ``--device cpu`` on a synthetic scene
with depth: it runs (the GT-depth run pretrains its oracle first), writes
the run's files (``opt.txt``, the ``_opt`` checkpoints, the final save,
the evaluation's reports), and the evaluation of its ``_opt`` weights
matches the JAX package's evaluation of the same weights: per test image
PSNR within 0.01 dB, FLIP and samples/px within 1e-4 (the bars of
``tests/test_torch_evaluation.py``), and the same ``complexity.txt``."""

import csv
import importlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from adanerf_tpu_torch.evaluation import evaluate as t_eval

from scene_utils import make_scene
from test_torch_baseline_gt import INI, SCALED, SMALL

j_eval = importlib.import_module("adanerf_tpu.evaluation.evaluate")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = {"nerf_baseline": ["--epochs", "7", "--epochsValidate", "3", "--epochsRender", "6"],
          # pretraining epochs 1..4 (validating at 4), then joint epochs 4..8
          "gt_depth_training": ["--epochs", "9", "--epochsValidate", "4",
                                "--epochsRender", "8"]}
EVALS = ["complexity", "images", "flip", "psnr", "output_images"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene_cfg")), with_depth=True)


@pytest.fixture(scope="module", params=list(INI))
def run(request, scene, tmp_path_factory):
    name = request.param
    log = str(tmp_path_factory.mktemp(f"run_{name}"))
    argv = ["-c", INI[name], "-data", scene, "-log", log, "--device", "cpu",
            "--verboseEvery", "1", "--epochsCheckpoint", "5"] + SMALL + SCALED[name] + EPOCHS[name]
    proc = subprocess.run([sys.executable, "-m", "adanerf_tpu_torch.train"] + argv, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    run_dir = os.path.join(log, os.path.basename(scene))
    (exp,) = os.listdir(run_dir)
    return name, os.path.join(run_dir, exp), proc.stdout


def test_the_run_trains_and_writes_its_files(run):
    name, d, out = run
    steps = re.findall(r"epoch=(\d+)\s+losses=\[([^\]]*)\]", out)
    losses = np.array([[float(v) for v in l.split(",")] for _, l in steps])
    assert np.isfinite(losses).all() and (losses > 0).all()
    models = sorted(f[:-len("__opt.weights")] for f in os.listdir(d) if f.endswith("__opt.weights"))
    assert len(models) == 2
    want = ["opt.txt", "logs.csv", "image_quality_images.csv", "complexity.txt",
            "network_description.txt", "eval/0_out.png", "eval/opt.txt", "config.ini"]
    want += [f"{m}_0000008.weights" if name == "gt_depth_training" else f"{m}_0000006.weights"
             for m in models]
    assert [f for f in want if not os.path.exists(os.path.join(d, f))] == []
    if name == "gt_depth_training":
        assert "pre-training finished" in out
        # joint training starts where pretraining ended
        assert [int(e) for e, _ in steps] == [4, 5, 6, 7, 8]
    else:
        assert [int(e) for e, _ in steps] == list(range(1, 7))
        assert "NeRF0(32x4[4]): plain, NeRF1(32x4[4]): plain" in out


def test_evaluation_matches_jax_on_the_same_weights(run, scene, tmp_path):
    name, d, _ = run
    status_t, tts = t_eval.load_config(scene, "cpu", d, list(EVALS), [],
                                       cl_out_dir=str(tmp_path / "t"),
                                       skip_if_already_done_once=False)
    status_j, jts = j_eval.load_config(scene, 0, d, list(EVALS), [],
                                       cl_out_dir=str(tmp_path / "j"),
                                       skip_if_already_done_once=False)
    assert status_t == status_j == 0
    qt = t_eval.evaluate(tts, None, list(EVALS))
    qj = j_eval.evaluate(jts, None, list(EVALS))
    assert len(qt.psnr) == len(qj.psnr) == 1
    assert abs(qt.psnr[0] - qj.psnr[0]) <= 0.01
    assert abs(qt.flip[0] - qj.flip[0]) <= 1e-4
    assert len(qt.samples) == len(qj.samples)
    assert all(abs(a - b) <= 1e-4 for a, b in zip(qt.samples, qj.samples))
    exp = os.path.basename(d)
    with open(tmp_path / "t" / os.path.basename(scene) / exp / "complexity.txt") as a, \
            open(tmp_path / "j" / os.path.basename(scene) / exp / "complexity.txt") as b:
        assert a.read() == b.read()
    # the run's own evaluation (the same _opt weights, in the trainer) gave
    # the port's numbers
    with open(os.path.join(d, "image_quality_images.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    assert abs(float(rows[0]["psnr"]) - qt.psnr[0]) <= 1e-6


@pytest.mark.parametrize("device,echoed", [("cpu", None), ("cuda", "0"), ("cuda:1", "1"),
                                           ("2", "2")])
def test_echoed_config_reads_in_both_packages(scene, tmp_path, device, echoed):
    """A run's ``config.ini`` echo carries ``device`` as the JAX package's
    ``-d`` reads it (a card's index), or not at all for the CPU: the JAX
    package's evaluation re-reads a run of the port through it."""
    from adanerf_tpu.config import Config as JConfig
    from adanerf_tpu_torch.config import Config as TConfig, write_config_echo
    argv = ["-c", INI["gt_depth_training"], "-data", scene, "-log", str(tmp_path)]
    write_config_echo(TConfig.init(argv=argv + ["--device", device]), str(tmp_path))
    path = str(tmp_path / "config.ini")
    with open(path) as f:
        lines = [l.strip() for l in f if l.startswith("device =")]
    assert lines == ([] if echoed is None else [f"device = {echoed}"])
    j = JConfig.init(path=path, only_known_args=True, argv=[])
    t = TConfig.init(path=path, only_known_args=True, argv=[])
    assert j.device == (0 if echoed is None else int(echoed))
    assert j.epochsPretrain == t.epochsPretrain == [10000, -1]
    assert j.useNerfDepthMap and t.useNerfDepthMap and not (j.trainWithGTDepth or t.trainWithGTDepth)


def test_complexity_counts_the_samples_jax_counts(run, scene, tmp_path):
    """``complexity.txt`` counts each net's MACs at the samples a pixel the
    JAX package counts (the first net once, the others at
    ``numRaymarchSamples[-1]``). For the GT-depth run that is what its nets
    shade. The baseline's nets shade 16 and 16 + 32 samples (scaled down;
    64 and 192 as shipped), but the count takes 1 and 32: ROADMAP Queue 3,
    F8. Its evaluation prints a note saying so."""
    name, d, out = run
    status, tts = t_eval.load_config(scene, "cpu", d, ["complexity"], [],
                                     cl_out_dir=str(tmp_path), skip_if_already_done_once=False)
    assert status == 0
    counted, shaded = t_eval.complexity_samples(tts)
    macs = [m.macs_per_input() for m in tts.models]
    with open(os.path.join(d, "complexity.txt")) as f:
        per_pixel = float(f.read().splitlines()[-1].split(" : ")[1])
    assert per_pixel == pytest.approx(sum(c * m for c, m in zip(counted, macs)), rel=1e-9)
    notes = [l for l in out.splitlines() if l.startswith("note: complexity.txt")]
    if name == "nerf_baseline":
        assert (counted, shaded) == ([1, 32], [16, 48])
        assert sum(s * m for s, m in zip(shaded, macs)) > 1.5 * per_pixel
        assert notes == [f"note: complexity.txt counts the nets' MACs at {counted} samples a "
                         f"pixel, as the JAX package does, where they shade {shaded} "
                         f"(ROADMAP Queue 3, F8)"]
    else:
        assert counted == shaded == [1, 8] and notes == []
