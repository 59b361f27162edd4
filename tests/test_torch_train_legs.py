"""The port's whole training run on the CPU against the JAX package's: the
render, video and validation legs, the best-validation ``_opt``
checkpoints, the final save and the evaluation.

* Under the same arguments on a synthetic scene, the port's trainer and
  the JAX package's root ``train.py`` write the same files under the same
  names, and equal ``complexity.txt`` and ``network_description.txt``. Not
  compared: the JAX package's ``plot_training_stats`` PDFs (pandas and
  matplotlib, not ported; the CSV they plot is), and the numbers in the
  names of the diff and FLIP images, which come from each run's weights.
* ``configs/fine_training.ini`` as shipped, on the CPU, reaches every leg.
* Step times leave the legs out; ``load_specific_weights("opt")`` loads
  the ``_opt`` checkpoints; ``python -m adanerf_tpu_torch.test`` renders
  the three splits into the JAX package's file names; without
  ``--device cpu`` the entry points raise on a host without a card."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from adanerf_tpu_torch import evaluate as t_evaluate_cli
from adanerf_tpu_torch import test as t_test_cli
from adanerf_tpu_torch import train
from adanerf_tpu_torch.config import Config
from adanerf_tpu_torch.train_state import TrainState
from adanerf_tpu_torch.utils.weights import to_flat

from scene_utils import dense_config_args, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ENV = dict(os.environ, ADANERF_PLATFORM="cpu", JAX_PLATFORMS="cpu")


def _scene(path):
    scene = make_scene(str(path), n_val=2, n_test=2)
    # a two-frame camera path for the videos (camType PredefinedCamera,
    # camPath cam_path_pan are the defaults)
    with open(os.path.join(scene, "transforms_val.json")) as f:
        frames = json.load(f)["frames"]
    with open(os.path.join(scene, "cam_path_pan.json"), "w") as f:
        json.dump({"frames": frames}, f)
    return scene


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return _scene(tmp_path_factory.mktemp("scene_legs"))


def _leg_args(scene, log):
    # lossBlendingStart beyond the run lets a dense run validate
    return dense_config_args(scene, log, samples=64, epochs=7) + [
        "--randomSeed", "0", "--epochsRender", "3", "--epochsValidate", "3",
        "--epochsVideo", "6", "--lossBlendingStart", "100", "--epochsCheckpoint", "5",
        "--performEvaluation", "--verboseEvery", "2"]


@pytest.fixture(scope="module")
def port_run(scene, tmp_path_factory):
    log = str(tmp_path_factory.mktemp("legs_port"))
    return train.main(_leg_args(scene, log) + ["--device", "cpu"])


def _files(d):
    out = []
    for base, _dirs, names in os.walk(d):
        for n in names:
            rel = os.path.relpath(os.path.join(base, n), d)
            if rel.endswith(".pdf"):
                continue
            out.append(re.sub(r"_(diff|square_diff|flip)_[0-9.e-]+\.png$", r"_\1_N.png", rel))
    return sorted(out)


def test_legs_write_the_jax_trainers_files(scene, port_run, tmp_path):
    jlog = str(tmp_path / "jax")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "train.py")] + _leg_args(scene, jlog),
                          cwd=ROOT, env=JAX_ENV, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    t_dir = port_run["state"].logDir
    j_dir = os.path.join(jlog, os.path.basename(scene), port_run["state"].experiment_name)
    assert _files(t_dir) == _files(j_dir)
    for name in ("complexity.txt", "network_description.txt"):
        with open(os.path.join(t_dir, name)) as a, open(os.path.join(j_dir, name)) as b:
            assert a.read() == b.read(), name
    for name in ("logs.csv", "image_quality_images.csv"):
        with open(os.path.join(t_dir, name), newline="") as a, \
                open(os.path.join(j_dir, name), newline="") as b:
            assert a.readline() == b.readline(), name  # header and line end
    expected = {"0000003_0.png", "0000003_1_train_targets.png", "0000003_oracle_histogram.png",
                "0000006_estimated_depth.png", "0000006_0_frames/00001.png",
                "_opt_1_frames/00000.png", "opt.txt", "opt/val/_1_1.png", "eval/1_out.png",
                "eval/opt.txt", "image_quality_images.csv"}
    assert expected <= set(_files(t_dir))


def test_step_times_leave_the_legs_out(port_run):
    assert len(port_run["step_ms"]) == 6 and len(port_run["losses"]) == 6
    legs = port_run["legs_ms"]
    # renders at 3 and 6, validations at 3 and 6, videos at 6 and "_opt" at 3
    assert [len(legs[k]) for k in ("render", "video", "validate")] == [2, 2, 2]
    assert port_run["evaluate_ms"] > 0


def test_load_specific_weights_takes_the_opt_checkpoints(scene, port_run, tmp_path):
    run = port_run["state"]
    cfg = Config.init(argv=_leg_args(scene, str(tmp_path)) + ["--device", "cpu"])
    ts = TrainState()
    ts.initialize(cfg, log_path=run.logDir, training=False)
    ts.load_specific_weights("opt")
    for m in ts.models:
        with np.load(os.path.join(run.logDir, f"{m.name}__opt.weights")) as f:
            for k, v in to_flat(m).items():
                np.testing.assert_array_equal(v, f[k])
    with open(os.path.join(run.logDir, "opt.txt")) as f:
        opt_epoch = int(f.read().split()[-1])
    assert opt_epoch in (3, 6)
    assert [s.count for s in ts.opt_states] == [opt_epoch] * 2  # with its Adam state
    ts.load_specific_weights("0000005", model_idx=1)
    assert [s.count for s in ts.opt_states] == [opt_epoch, 5]
    with np.load(os.path.join(run.logDir, f"{ts.models[1].name}_0000005.weights")) as f:
        for k, v in to_flat(ts.models[1]).items():
            np.testing.assert_array_equal(v, f[k])


def test_test_cli_renders_every_split_with_the_jax_names(scene, port_run, tmp_path):
    run = port_run["state"]
    argv = _leg_args(scene, os.path.dirname(os.path.dirname(run.logDir.rstrip("/"))))
    psnrs = t_test_cli.main(argv + ["--device", "cpu"])
    assert [len(psnrs[k]) for k in ("train", "val", "test")] == [4, 2, 2]
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "test.py")] + argv
                          + ["-log", str(tmp_path / "jax")], cwd=ROOT, env=JAX_ENV,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    j_dir = os.path.join(str(tmp_path / "jax"), os.path.basename(scene), run.experiment_name)
    t_names = _files(os.path.join(run.logDir, "test_images"))
    assert t_names == _files(os.path.join(j_dir, "test_images"))
    assert "test/0000_estimated_depth.png" in t_names and "val/1_0001.png" in t_names


def test_fine_ini_as_shipped_reaches_every_leg_on_the_cpu(tmp_path):
    """configs/fine_training.ini with the published widths and batch: only
    the epochs, the data, the log dir and the device change, and the legs'
    epochs are brought inside a 3-step run (the ini places them at 10,000
    and 50,000)."""
    scene = _scene(tmp_path / "scene")
    stats = train.main(["-c", os.path.join(ROOT, "configs", "fine_training.ini"), "-data", scene,
                        "-log", str(tmp_path / "logs"), "--device", "cpu", "--epochs", "3",
                        "--epochsRender", "2", "--epochsValidate", "2", "--epochsVideo", "2"])
    ts = stats["state"]
    assert ts.config_file.performEvaluation and ts.config_file.numRaymarchSamples == [16, 16]
    assert np.isfinite(stats["losses"]).all()
    d = ts.logDir
    want = ["0000002_0.png", "0000002_1.png", "0000002_estimated_depth.png",
            "0000002_oracle_histogram.png", "0000002_0_frames/00000.png", "opt.txt",
            "opt/val/_0_1.png", "opt/val/_1_0.png", "eval/0_out.png", "eval/opt.txt",
            "image_quality_images.csv", "complexity.txt", "network_description.txt"]
    want += [f"{m.name}__opt.weights" for m in ts.models]
    assert [f for f in want if not os.path.exists(os.path.join(d, f))] == []


@pytest.mark.parametrize("entry", ["train", "test", "evaluate"])
def test_entry_points_without_a_card_raise(scene, tmp_path, entry):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    args = _leg_args(scene, str(tmp_path / "logs"))
    main = {"train": train.main, "test": t_test_cli.main,
            "evaluate": lambda a: t_evaluate_cli.main(["-data", scene, "-log", str(tmp_path)])}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main[entry](args)
