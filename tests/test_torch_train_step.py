"""The port's train step against the JAX package's on the CPU, fp32, from
the same parameters (JAX's seed-0 init carried across) and the same batch
of the synthetic scene:

* per-net losses within rtol 1e-5 and every gradient leaf within 1e-4 of
  its max |ref| of jax.grad of the JAX step's loss (make_train_step's
  loss_fn); fp32, with XLA and torch summing in different orders;
* Adam: fed the same gradients, the port's update gives optax's
  scale_by_adam parameters and state within rtol 1e-6, atol 1e-9 (Adam's
  first steps are ~sign(g), so grads that differ by an ulp near zero
  would move parameters by 2 lr: the update is tested on equal grads);
* the learning-rate schedule, the lock predicate over a grid of epochs and
  bounds, and a locked net keeping its parameters and optimizer state."""

import itertools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from adanerf_tpu.config import Config as JConfig
from adanerf_tpu.pipeline.cascade import run_cascade as j_run_cascade
from adanerf_tpu.train_state import TrainState as JTrainState
from adanerf_tpu_torch.config import Config as TConfig
from adanerf_tpu_torch.train_state import AdamState, TrainState as TTrainState, adam_update
from adanerf_tpu_torch.utils.weights import flatten_params, from_jax_params

from scene_utils import dense_config_args, make_scene


def _pair(scene, log, extra=()):
    argv = dense_config_args(scene, log, samples=48) + ["--randomSeed", "0"] + list(extra)
    jts, tts = JTrainState(), TTrainState()
    jts.initialize(JConfig.init(argv=argv))
    tts.initialize(TConfig.init(argv=argv + ["--device", "cpu"]), log_path=log + "/t/")
    for m, p in zip(tts.models, jts.params):
        from_jax_params(m, jax.tree.map(np.asarray, p))
    return jts, tts


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene_step")))


def _jax_loss_and_grads(jts, batch, targets, epoch):
    """The body of JAX's make_train_step: cascade, losses, lock weights."""
    def loss_fn(params):
        outs, dicts = j_run_cascade(jts.model_defs, params, jts.f_in, batch,
                                    is_inference=False, key=None, dtype=None)
        total, per_net = 0.0, []
        for i, crit in enumerate(jts.losses):
            if crit is None or jts.loss_weights[i] == 0 or not jts.ever_unlocked(i):
                per_net.append(jnp.asarray(0.0))
                continue
            li = crit(outs[i], targets.get(i), inference_dicts=dicts, epoch=epoch)
            w = jnp.where(jts.weights_locked(epoch, i), 0.0, jts.loss_weights[i])
            total = total + w * li
            per_net.append(li)
        return total, per_net
    grads, per_net = jax.grad(loss_fn, has_aux=True)(jts.params)
    return [float(v) for v in per_net], [
        {k: np.asarray(v) for k, v in flatten_params(jax.tree.map(np.asarray, g)).items()}
        for g in grads]


@pytest.mark.parametrize("thr,epoch", [(0.0, 1), (0.0, 12), (0.2, 12), (0.0, 40)])
def test_losses_and_grads_match_jax(scene, tmp_path, thr, epoch):
    jts, tts = _pair(scene, str(tmp_path), ["--adaptiveSamplingThreshold", str(thr)])
    idx = np.array([0, 2])
    jb, jt = jts.assemble_train_batch(jts.train_dataset, idx)
    tb, tt = tts.assemble_train_batch(tts.train_dataset, idx)
    j_losses, j_grads = _jax_loss_and_grads(jts, jb, jt, jnp.asarray(epoch))
    t_losses, t_grads = tts.make_loss_and_grads()(tb, tt, epoch)
    np.testing.assert_allclose([float(v) for v in t_losses], j_losses, rtol=1e-5, atol=1e-8)
    for i, (jg, tg) in enumerate(zip(j_grads, t_grads)):
        assert set(jg) == set(tg)
        for k, ref in jg.items():
            scale = float(np.abs(ref).max()) + 1e-20
            rel = float(np.abs(tg[k].numpy() - ref).max()) / scale
            assert rel <= 1e-4, (i, k, rel)


def test_adam_matches_optax_on_equal_grads():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(params["w"].copy()))
            self.b = torch.nn.Parameter(torch.from_numpy(params["b"].copy()))
    net = Net()
    state = AdamState(net)
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    for step in range(4):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * (10.0 ** -step)
             for k, v in params.items()}
        g["b"][0] = 0.0  # an exactly-zero gradient
        lr = np.float32(5e-4) * np.float32(0.1) ** np.float32((step + 2) / 300000)
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: -lr * u, upd))
        adam_update(net, state, {k: torch.from_numpy(v) for k, v in g.items()}, float(lr))
        for k in params:
            np.testing.assert_allclose(getattr(net, k).detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(state.mu[k].numpy(), np.asarray(js.mu[k]), rtol=1e-6,
                                       atol=1e-12)
            np.testing.assert_allclose(state.nu[k].numpy(), np.asarray(js.nu[k]), rtol=1e-6,
                                       atol=1e-15)
        assert state.count == int(js.count)


def test_learning_rate_matches_jax(scene, tmp_path):
    jts, tts = _pair(scene, str(tmp_path))
    c = jts.config_file
    pre = max(c.epochsPretrain) if c.epochsPretrain else 0
    for epoch in (0, 1, 1000, 299999):
        e = jnp.asarray(epoch)
        ref = c.lrate * c.lrate_decay ** ((e - pre) / c.lrate_decay_steps)
        assert tts.learning_rate(epoch) == pytest.approx(float(ref), rel=1e-6)


BOUNDS = [-1, 0, 1, 5, 10, 30]


@pytest.mark.parametrize("bef,aft", list(itertools.product(BOUNDS, BOUNDS)))
def test_lock_predicate_matches_jax(bef, aft):
    jts, tts = JTrainState(), TTrainState()
    cfg = dict(epochsLockWeightsBefore=[bef, -1], epochsLockWeightsAfter=[aft, -1], epochs=20)
    for ts in (jts, tts):
        ts.config_file = type("C", (), cfg)()
    for epoch in range(0, 35):
        assert tts.weights_locked(epoch, 0) == bool(jts.weights_locked(epoch, 0)), epoch
        assert tts.weights_locked(epoch, 1) is False
    assert tts.ever_unlocked(0) == jts.ever_unlocked(0)


def test_locked_net_keeps_params_and_optimizer_state(scene, tmp_path):
    # the NeRF locked before epoch 100, as the dense config locks it before 1001
    _, tts = _pair(scene, str(tmp_path))
    tts.config_file.epochsLockWeightsBefore = [-1, 100]
    before = [{k: v.clone() for k, v in m.state_dict().items()} for m in tts.models]
    step = tts.make_train_step()
    for epoch in (1, 2):
        b, t = tts.assemble_train_batch(tts.train_dataset, np.array([epoch, 0]))
        step(b, t, epoch)
    oracle, nerf = tts.models
    assert all(torch.equal(v, before[1][k]) for k, v in nerf.state_dict().items())
    assert tts.opt_states[1].count == 0
    assert all(float(v.abs().max()) == 0.0 for v in tts.opt_states[1].mu.values())
    assert any(not torch.equal(v, before[0][k]) for k, v in oracle.state_dict().items())
    assert tts.opt_states[0].count == 2
