"""Checkpoints cross between the packages in both directions, exactly: the
port's npz files load in the JAX package's load_tree (parameters and
optax's Adam state) and the JAX package's load in the port; resume takes
the newest epoch every net has readable; the dense -> fine bootstrap finds
the teacher through the regex-derived experiment name (written by either
package) and fails fast when it is missing."""

import os

import numpy as np
import pytest
import torch

import jax

from adanerf_tpu.config import Config as JConfig
from adanerf_tpu.train_state import TrainState as JTrainState
from adanerf_tpu.train_state import load_tree as j_load_tree
from adanerf_tpu_torch.config import Config as TConfig
from adanerf_tpu_torch.train_state import TrainState as TTrainState
from adanerf_tpu_torch.utils.weights import adam_to_flat, flatten_params, to_flat

from scene_utils import dense_config_args, make_scene


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene_ckpt")))


def _port(scene, log, extra=()):
    ts = TTrainState()
    ts.initialize(TConfig.init(argv=dense_config_args(scene, log, samples=32, **_kw(extra))
                               + ["--device", "cpu"] + _rest(extra)))
    return ts


def _jax(scene, log, extra=()):
    ts = JTrainState()
    ts.initialize(JConfig.init(argv=dense_config_args(scene, log, samples=32, **_kw(extra))
                               + _rest(extra)))
    return ts


def _kw(extra):
    return {k: v for k, v in extra if k in ("threshold", "n_raymarch")}


def _rest(extra):
    return [a for k, v in extra if k not in ("threshold", "n_raymarch") for a in (k, v)]


def _train(ts, steps):
    step = ts.make_train_step()
    for epoch in range(1, steps + 1):
        b, t = ts.assemble_train_batch(ts.train_dataset, np.array([epoch % 4, 0]))
        step(b, t, epoch)


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten_params(jax.tree.map(np.asarray, tree)).items()}


def test_port_checkpoint_loads_in_jax(scene, tmp_path):
    tts = _port(scene, str(tmp_path))
    _train(tts, 3)
    paths = tts.save_weights("0000003")
    assert [os.path.basename(p) for p in paths] == [
        "relu0(32x4)_0000003.weights", "relu0(32x4)_0000003.optimizer",
        "NeRF1(32x4[4])_0000003.weights", "NeRF1(32x4[4])_0000003.optimizer"]
    jts = _jax(scene, str(tmp_path))
    assert jts.logDir == tts.logDir
    for i, m in enumerate(tts.models):
        p = j_load_tree(paths[2 * i], jts.params[i])
        o = j_load_tree(paths[2 * i + 1], jts.opt_states[i])
        for k, v in to_flat(m).items():
            np.testing.assert_array_equal(_flat_np(p)[k], v)
        assert int(o.count) == 3
        flat = adam_to_flat(tts.opt_states[i])
        for k, v in _flat_np(o.mu).items():
            np.testing.assert_array_equal(v, flat[f".mu.{k}"])
        for k, v in _flat_np(o.nu).items():
            np.testing.assert_array_equal(v, flat[f".nu.{k}"])
    jts.load_latest_weights()  # and the JAX package resumes from it
    assert jts.epoch0 == 4


def test_jax_checkpoint_resumes_in_port(scene, tmp_path):
    jts = _jax(scene, str(tmp_path))
    step = jts.make_train_step()
    b, t = jts.assemble_train_batch(jts.train_dataset, np.array([1, 2]))
    jts.params, jts.opt_states, _ = step(jts.params, jts.opt_states, b, t,
                                         jax.numpy.asarray(5), jax.random.PRNGKey(5))
    jts.save_weights("0000005")
    tts = _port(scene, str(tmp_path))
    tts.load_latest_weights()
    assert tts.epoch0 == 6
    for m, p, o, s in zip(tts.models, jts.params, jts.opt_states, tts.opt_states):
        for k, v in _flat_np(p).items():
            np.testing.assert_array_equal(to_flat(m)[k], v)
        assert s.count == int(o.count) == 1
        for k, v in _flat_np(o.nu).items():
            np.testing.assert_array_equal(s.nu[k].numpy(), v)


def test_resume_takes_newest_common_readable_epoch(scene, tmp_path):
    tts = _port(scene, str(tmp_path))
    _train(tts, 2)
    tts.save_weights("0000002")
    saved = [{k: v.clone() for k, v in m.state_dict().items()} for m in tts.models]
    _train(tts, 1)
    tts.save_weights("0000004")
    tts.save_weights("0000006", model_idx=0)  # only one net reached epoch 6
    with open(os.path.join(tts.logDir, "NeRF1(32x4[4])_0000004.weights"), "wb") as f:
        f.write(b"truncated")  # epoch 4 unreadable for one net
    fresh = _port(scene, str(tmp_path))
    fresh.load_latest_weights()
    assert fresh.epoch0 == 3
    for m, s in zip(fresh.models, saved):
        assert all(torch.equal(v, s[k]) for k, v in m.state_dict().items())



def test_resume_skips_a_half_length_checkpoint(scene, tmp_path):
    """A .weights file cut to half its length (a zip without its central
    directory: np.load raises BadZipFile) makes its epoch unreadable; resume
    falls back to the older common epoch, as the JAX package does on the
    same files."""
    tts = _port(scene, str(tmp_path))
    _train(tts, 2)
    tts.save_weights("0000002")
    saved = [{k: v.clone() for k, v in m.state_dict().items()} for m in tts.models]
    _train(tts, 1)
    tts.save_weights("0000004")
    path = os.path.join(tts.logDir, "NeRF1(32x4[4])_0000004.weights")
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    fresh = _port(scene, str(tmp_path))
    fresh.load_latest_weights()
    assert fresh.epoch0 == 3
    for m, s in zip(fresh.models, saved):
        assert all(torch.equal(v, s[k]) for k, v in m.state_dict().items())
    jts = _jax(scene, str(tmp_path))
    jts.load_latest_weights()
    assert jts.epoch0 == 3


def test_perturbed_resume_matches_an_unbroken_run(scene, tmp_path):
    """With --perturb each step draws its depth jitter from (seed, epoch):
    4 unbroken steps and 2 steps, a save, a resume and 2 more steps end
    with equal parameters (both runs take the same batches)."""
    def state(log):
        ts = TTrainState()
        ts.initialize(TConfig.init(argv=dense_config_args(scene, log, samples=32)
                                   + ["--device", "cpu", "--perturb"]))
        return ts

    ref = state(str(tmp_path / "batches"))
    assert ref.f_in[1].perturb
    batches = {e: ref.assemble_train_batch(ref.train_dataset, np.array([e % 4, 0]))
               for e in range(1, 5)}

    def train(ts, epochs):
        step = ts.make_train_step()
        for e in epochs:
            step(*batches[e], e)

    unbroken = state(str(tmp_path / "unbroken"))
    train(unbroken, range(1, 5))
    first = state(str(tmp_path / "resumed"))
    train(first, range(1, 3))
    first.save_weights("0000002")
    resumed = state(str(tmp_path / "resumed"))
    resumed.load_latest_weights()
    assert resumed.epoch0 == 3
    train(resumed, range(3, 5))
    for a, b in zip(unbroken.models, resumed.models):
        assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())

def test_dense_to_fine_bootstrap_from_either_package(scene, tmp_path):
    log = str(tmp_path / "logs")
    dense = _port(scene, log, [("threshold", 0.0), ("n_raymarch", 128)])
    assert "128_LSfCDA_(0.0)" in dense.experiment_name
    for state in dense.opt_states:  # (128 samples against 16 oracle bins do not train)
        state.count = 7
    dense.save_weights("_opt")
    dataset_dir = os.path.join(log, os.path.basename(scene))
    fine_extra = [("threshold", 0.15), ("n_raymarch", 16), ("--preTrainedSuffix", "opt"),
                  ("--preTrained", dataset_dir), ("--preTrained", dataset_dir)]
    fine = _port(scene, log, fine_extra)
    fine.load_latest_weights()
    assert fine.epoch0 == 1
    for a, b in zip(dense.models, fine.models):
        assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    assert [s.count for s in fine.opt_states] == [7, 7]
    jfine = _jax(scene, log, fine_extra)  # the JAX package finds the port's teacher
    jfine.load_latest_weights()
    for a, p in zip(dense.models, jfine.params):
        for k, v in _flat_np(p).items():
            np.testing.assert_array_equal(to_flat(a)[k], v)


def test_missing_teacher_fails_fast(scene, tmp_path):
    fine = _port(scene, str(tmp_path / "logs"), [
        ("threshold", 0.15), ("n_raymarch", 16), ("--preTrainedSuffix", "opt"),
        ("--preTrained", str(tmp_path / "nowhere")), ("--preTrained", str(tmp_path / "nowhere"))])
    with pytest.raises(FileNotFoundError, match="dense-pretrained weights"):
        fine.load_latest_weights()
