"""Resuming the committed JAX fine NDC run (``demo/ndclogs/llff_scene``,
``configs/fine_training_ndc.ini`` with ``tools/run_ndc_pipeline.sh``'s
overrides, as its ``config.ini`` records) in the port, against the JAX
package, on the CPU with ``--samples 64``: both packages take the run's
``config.ini`` and its ``0006000`` checkpoints (weights and Adam state of
both nets) from the log dir, resume at epoch 6001 with the same
parameters, and after 2 steps on the same batches their losses and their
parameter updates agree within ``tests/test_torch_train_step.py``'s
step-parity bars (losses rtol 1e-5; each leaf within 1e-4 of its largest
JAX value, here of the update); the locked oracle moves in neither. This
is the start of ``chip_smoke.py`` phase 19's quality run."""

import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adanerf_tpu.config import Config as JConfig
from adanerf_tpu.train_state import TrainState as JTrainState
from adanerf_tpu_torch.config import Config as TConfig
from adanerf_tpu_torch.train_state import TrainState as TTrainState
from adanerf_tpu_torch.utils.weights import flatten_params, to_flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = glob.glob(os.path.join(glob.escape(os.path.join(ROOT, "demo", "ndclogs", "llff_scene")),
                             "*LSfCDA_(0.15)*"))[0]
DATA = os.path.join(ROOT, "demo", "llff_scene")


def _jax_flat(params):
    return [{k: np.asarray(v) for k, v in flatten_params(jax.tree.map(np.asarray, p)).items()}
            for p in params]


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    states = {}
    for who, cls, config, extra in (("port", TTrainState, TConfig, ["--device", "cpu"]),
                                    ("jax", JTrainState, JConfig, [])):
        log = str(tmp_path_factory.mktemp(f"ndc_resume_{who}"))
        argv = ["-c", os.path.join(RUN, "config.ini"), "-data", DATA, "-log", log,
                "--samples", "64"] + extra
        ts = cls()
        ts.initialize(config.init(argv=argv))
        assert os.path.basename(ts.logDir.rstrip("/")) == os.path.basename(RUN)
        for f in os.listdir(RUN):
            if "_0006000." in f:
                shutil.copy(os.path.join(RUN, f), ts.logDir)
        ts.load_latest_weights()
        states[who] = ts
    return states["port"], states["jax"]


def test_both_resume_at_6001_with_the_checkpoints_parameters(resumed):
    tts, jts = resumed
    assert tts.epoch0 == jts.epoch0 == 6001
    for m, j in zip(tts.models, _jax_flat(jts.params)):
        got = to_flat(m)
        assert set(got) == set(j)
        for k in j:
            np.testing.assert_array_equal(got[k], j[k])
    assert [int(s.count) for s in tts.opt_states] == [int(s.count) for s in jts.opt_states]


def test_two_resumed_steps_match_jax(resumed):
    tts, jts = resumed
    before_t = [{k: v.copy() for k, v in to_flat(m).items()} for m in tts.models]
    before_j = _jax_flat(jts.params)
    t_step, j_step = tts.make_train_step(), jts.make_train_step()
    n = len(tts.train_dataset)
    for epoch in (6001, 6002):
        idx = np.array([epoch % n, (epoch + 3) % n])
        tb, tt = tts.assemble_train_batch(tts.train_dataset, idx)
        jb, jt = jts.assemble_train_batch(jts.train_dataset, idx)
        t_losses = [float(v) for v in t_step(tb, tt, epoch)]
        jts.params, jts.opt_states, j_losses = j_step(
            jts.params, jts.opt_states, jb, jt, jnp.asarray(epoch), jax.random.PRNGKey(epoch))
        print(f"epoch {epoch}: losses port {t_losses}, jax {[float(v) for v in j_losses]}")
        np.testing.assert_allclose(t_losses, [float(v) for v in j_losses], rtol=1e-5, atol=1e-8)
    after_t = [to_flat(m) for m in tts.models]
    after_j = _jax_flat(jts.params)
    for i in range(2):
        for k in before_j[i]:
            dj = after_j[i][k] - before_j[i][k]
            dt = after_t[i][k] - before_t[i][k]
            if i == 0:  # the oracle is locked (epochsLockWeightsAfter = [0, -1])
                assert not dj.any() and not dt.any(), k
                continue
            scale = float(np.abs(dj).max())
            assert scale > 0, k
            assert float(np.abs(dt - dj).max()) <= 1e-4 * scale, k
