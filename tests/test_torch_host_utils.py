"""The port's host utilities against the JAX package's, on the CPU:

* ``utils/profiling.py``: ``StageTimers`` gives JAX's report text for the
  same clock readings (``time.perf_counter`` patched); ``analytic_macs``
  JAX's numbers on the model definitions of the four shipped configs;
  ``chain_slope_time`` the slope between its two chains and its fence
  once a chain; ``device_trace`` writes a Chrome trace of the block's ops;
* ``TrainState.delete_saved_weights`` leaves the files JAX's leaves on a
  log dir of 25 fake checkpoints (two nets, with their ``.optimizer``
  files and the ``_opt`` ones) that holds epochs 50,000 and 100,000."""

import itertools
import json
import os
import time

import pytest
import torch

from adanerf_tpu.config import Config as JConfig
from adanerf_tpu.train_state import TrainState as JTrainState
from adanerf_tpu.utils import profiling as j_prof
from adanerf_tpu_torch.config import Config as TConfig
from adanerf_tpu_torch.train_state import TrainState as TTrainState
from adanerf_tpu_torch.utils import profiling as t_prof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [("dense_training.ini", "mscene"), ("fine_training.ini", "mscene"),
           ("dense_training_ndc.ini", "llff_scene"), ("fine_training_ndc.ini", "llff_scene")]


def test_stage_timers_report_as_jax(monkeypatch):
    ticks = itertools.count(0.0, 0.00125)
    reports = []
    for mod in (t_prof, j_prof):
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        timers = mod.StageTimers()
        for name in ("oracle", "shade", "oracle", "composite", "oracle"):
            with timers.stage(name):
                next(ticks)  # a stage lasts two ticks
        reports.append(timers.report())
        timers.reset()
        assert timers.report() == ""
    assert reports[0] == reports[1]
    assert reports[0].splitlines()[0] == "composite: 2500.0 us/call x1"


@pytest.mark.parametrize("ini,scene", CONFIGS, ids=[c for c, _ in CONFIGS])
def test_analytic_macs_match_jax(ini, scene, tmp_path):
    argv = ["-c", os.path.join(ROOT, "configs", ini), "-data",
            os.path.join(ROOT, "demo", scene), "-log", str(tmp_path)]
    tts = TTrainState()
    tts.initialize(TConfig.init(argv=argv + ["--device", "cpu"]), load_data=False)
    jts = JTrainState()
    jts.initialize(JConfig.init(argv=argv), load_data=False)
    for spp, pixels in ((1.27, 640_000), (16.0, 76_800)):
        got = t_prof.analytic_macs(tts.models, spp, pixels)
        want = j_prof.analytic_macs(jts.model_defs, spp, pixels)
        assert got == want
    assert [m.macs_per_input() for m in tts.models] == [d.macs_per_input()
                                                        for d in jts.model_defs]


def test_chain_slope_time_is_the_slope_and_fences_each_chain(monkeypatch):
    clock = iter(range(1000))
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock) * 1e-3)
    calls, fences = [], []
    ms = t_prof.chain_slope_time(lambda a: calls.append(a) or a, (7,), n1=2, n2=12,
                                 fence=fences.append)
    # each run reads the clock once before and once after: 1 ms a run, so
    # the slope between the 2- and 12-call chains is 0
    assert ms == 0.0 and len(calls) == 1 + 2 + 12 and fences == [7, 7, 7]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with t_prof.device_trace(str(tmp_path / "trace")) as prof:
        (a @ a).relu_()
    path = prof.trace_path
    assert os.path.dirname(path) == str(tmp_path / "trace") and os.path.exists(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names and "aten::relu_" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def _fake_checkpoints(log_dir, names):
    # the newest 10 come after 50000 and 100000, which the rule keeps
    epochs = [5000, 50000, 100000] + list(range(101000, 123000, 1000))
    assert len(epochs) == 25
    for name in names:
        for e in epochs:
            for ext in ("weights", "optimizer"):
                with open(os.path.join(log_dir, f"{name}_{e:07d}.{ext}"), "wb") as f:
                    f.write(b"x")
        for ext in ("weights", "optimizer"):
            with open(os.path.join(log_dir, f"{name}__opt.{ext}"), "wb") as f:
                f.write(b"x")


@pytest.mark.parametrize("model_idx", [-1, 0, 1])
def test_delete_saved_weights_leaves_what_jax_leaves(model_idx, tmp_path):
    from scene_utils import dense_config_args, make_scene
    scene = make_scene(str(tmp_path / "scene"))
    left = {}
    for who, cls, config in (("port", TTrainState, TConfig), ("jax", JTrainState, JConfig)):
        argv = dense_config_args(scene, str(tmp_path / who), samples=32)
        ts = cls()
        ts.initialize(config.init(argv=argv + (["--device", "cpu"] if who == "port" else [])),
                      load_data=False)
        names = [m.name for m in (ts.models if who == "port" else ts.model_defs)]
        _fake_checkpoints(ts.logDir, names)
        ts.delete_saved_weights(model_idx)
        left[who] = sorted(f for f in os.listdir(ts.logDir) if "weights" in f or "optimizer" in f)
    assert left["port"] == left["jax"]
    kept = [f for f in left["port"] if f.startswith(names[0]) and f.endswith(".weights")]
    if model_idx in (-1, 0):  # the newest 10, 50000 and 100000, and _opt
        assert len(kept) == 13 and f"{names[0]}_0050000.weights" in kept
        assert f"{names[0]}_0101000.optimizer" not in left["port"]
        assert f"{names[0]}_0005000.weights" not in left["port"]
    else:
        assert len(kept) == 26
