"""The port's trainer end to end on the CPU: ``python -m
adanerf_tpu_torch.train --device cpu`` on the synthetic scene for 30
epochs lowers the loss and writes checkpoints with the JAX package's names,
which the JAX package loads; what the trainer does not port yet (several
devices) is refused before step 0 with its ROADMAP item."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from adanerf_tpu.config import Config as JConfig
from adanerf_tpu.train_state import TrainState as JTrainState
from adanerf_tpu_torch import train

from scene_utils import dense_config_args, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene_e2e")))


def _args(scene, log, epochs=31):
    return dense_config_args(scene, log, samples=64, epochs=epochs) + [
        "--device", "cpu", "--randomSeed", "0", "--verboseEvery", "10",
        "--epochsCheckpoint", "10"]


def test_cli_trains_and_checkpoints(scene, tmp_path):
    log = str(tmp_path / "logs")
    proc = subprocess.run([sys.executable, "-m", "adanerf_tpu_torch.train"] + _args(scene, log),
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = re.findall(r"epoch=(\d+)\s+losses=\[([^\]]*)\]", proc.stdout)
    assert [int(e) for e, _ in lines] == [10, 20, 30]
    mse = [float(v.split(",")[1]) for _, v in lines]
    assert mse[-1] < mse[0] and np.isfinite(mse).all()
    jts = JTrainState()
    jts.initialize(JConfig.init(argv=dense_config_args(scene, log, samples=64, epochs=31)))
    names = sorted(os.listdir(jts.logDir))
    for d in jts.model_defs:
        for epoch in (10, 20, 30):
            assert f"{d.name}_{epoch:07d}.weights" in names
            assert f"{d.name}_{epoch:07d}.optimizer" in names
    jts.load_latest_weights()  # the JAX package resumes from the port's epoch 30
    assert jts.epoch0 == 31
    assert int(jts.opt_states[1].count) == 30


def test_main_returns_falling_losses(scene, tmp_path):
    stats = train.main(_args(scene, str(tmp_path / "logs")))
    losses = stats["losses"]
    assert losses.shape == (30, 2) and np.isfinite(losses).all()
    assert losses[-5:, 1].mean() < losses[:5, 1].mean()
    assert len(stats["step_ms"]) == 30
    assert all(os.path.exists(p) for p in stats["checkpoint"])
    assert stats["state"].epoch0 == 1


@pytest.mark.parametrize("extra,words", [
    pytest.param(["--device", "cuda", "--meshDevices", str(torch.cuda.device_count() + 2)],
                 "CUDA device(s) present", id="more GPUs than present"),
    pytest.param(["--device", "cpu", "--meshDevices", "3"], "do not split over 3 ranks",
                 id="rays that do not split over the ranks"),
])
def test_unported_options_are_refused_before_step_0(scene, tmp_path, extra, words):
    """Data-parallel training is ported (ROADMAP item 9 is done); what it
    refuses is refused before anything ran."""
    with pytest.raises(SystemExit) as err:
        train.main(_args(scene, str(tmp_path / "logs")) + extra)
    assert words in str(err.value)
    assert not os.path.exists(tmp_path / "logs")  # refused before anything ran


@pytest.mark.parametrize("widths,wide", [(("256", "640"), True), (("256", "1024"), True),
                                         (("256", "512"), True), (("256", "128"), False),
                                         (("32", "256"), False), (("256", "96"), None)])
def test_nerf_widths_k3_does_not_take_are_refused_on_cuda(scene, tmp_path, widths, wide):
    """No NeRF width is refused on CUDA any more: with --bf16, every NeRF
    that the JAX package trains through its TPU kernel (a width that is a
    multiple of 128) trains through K3, a width above 256 on its wide path
    (the libraries built before the ranks start say which); one that JAX
    trains on its plain path (96) trains plainly. Without a card the run
    gets past every refusal to the device check."""
    from adanerf_tpu_torch.ops.kernels import nerf_train, wide as wide_path
    args = _args(scene, str(tmp_path / "logs"))
    at = args.index("--layerWidth")
    args[at + 1], args[at + 3] = widths
    args[args.index("--device") + 1] = "cuda"
    cfg = train.Config.init(argv=args + ["--bf16"])
    assert train.unsupported(cfg) == []
    if wide is not None:
        libs = nerf_train.libraries(int(widths[1]), 90, 8)
        assert (wide_path.SOURCE in libs) == wide
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(args + ["--bf16"])


def test_render_points_beyond_the_run_are_fine():
    """Render, video and validation points and the evaluation are ported:
    none is refused, inside the run or beyond it."""
    cfg = type("C", (), dict(epochsPretrain=[-1, -1], epochsRender=31, epochsValidate=5,
                             epochsVideo=7, performEvaluation=True, meshDevices=-1))()
    assert train.unsupported(cfg) == []
    cfg.device, cfg.meshDevices = "cuda", torch.cuda.device_count() + 2
    assert len(train.unsupported(cfg)) == 1  # more GPUs than present


def test_cuda_device_without_a_card_raises(scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(_args(scene, str(tmp_path / "logs"))[:-8] + ["--randomSeed", "0"])
