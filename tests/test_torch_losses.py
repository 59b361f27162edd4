"""The port's losses (adanerf_tpu_torch/pipeline/losses.py) against the JAX
package's on random inputs from a numpy seed: every loss of the registry,
its value and its gradient with respect to each differentiable input, and
the oracle loss across the One -> Zero -> NerfA blend schedule. fp32 on the
CPU: rtol 1e-5, atol 1e-7 (the two sum in different orders)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adanerf_tpu.pipeline import losses as jl
from adanerf_tpu.pipeline.keys import FSK
from adanerf_tpu_torch.pipeline import losses as tl

RTOL, ATOL = 1e-5, 1e-7


def _config(**kw):
    base = dict(multiDepthIgnoreValue=[1.01, 1.01], lossAlpha=[0.7, 0.7], lossBeta=[0.3, 0.3],
                multiDepthFeatures=[16, 16], lossComponents=["One", "Zero", "NerfA"],
                lossComponentBlending=[-1.0, -1.0, -1.0], lossBlendingStart=5,
                lossBlendingDuration=20)
    base.update(kw)
    return SimpleNamespace(**base)


def _compare(name, config, outputs, targets, dicts_np, epoch, wrt_dict=()):
    """Value and grads (wrt outputs and the dict entries named in wrt_dict)
    of the JAX and the port loss."""
    jloss, tloss = jl.get_loss_by_name(name, config, 0), tl.get_loss_by_name(name, config, 0)

    def jf(out, extra):
        dicts = [dict(d) for d in dicts_np]
        for k, v in extra.items():
            dicts[1][k] = v
        return jloss(out, None if targets is None else jnp.asarray(targets),
                     inference_dicts=dicts, epoch=epoch)

    extra_j = {k: jnp.asarray(dicts_np[1][k]) for k in wrt_dict}
    jv, (jg_out, jg_extra) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(outputs), extra_j)

    out_t = torch.tensor(outputs, requires_grad=True)
    dicts_t = [{k: torch.tensor(v) for k, v in d.items()} for d in dicts_np]
    for k in wrt_dict:
        dicts_t[1][k].requires_grad_(True)
    tv = tloss(out_t, None if targets is None else torch.tensor(targets),
               inference_dicts=dicts_t, epoch=epoch)
    leaves = [out_t] + [dicts_t[1][k] for k in wrt_dict]
    grads = torch.autograd.grad(tv, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL, atol=ATOL)
    refs = [jg_out] + [jg_extra[k] for k in wrt_dict]
    for g, r in zip(grads, refs):
        g = np.zeros(np.shape(r), np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(r), rtol=RTOL, atol=ATOL)


def _rand(shape, seed, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("name", ["MSE", "LimitedDepthMSE", "BCEWithLogitsLoss"])
def test_elementwise_losses(name):
    out = _rand((64, 3), 1)
    tgt = _rand((64, 3), 2, 0.0, 1.2)  # some targets above the 1.01 ignore value
    _compare(name, _config(), out, tgt, [{}, {}], 0)


def test_multi_depth_limited_mse():
    out = _rand((40, 4), 3, 0.0, 1.0)
    tgt = _rand((40, 4), 4, 0.0, 1.0)
    tgt[::3, 1] = 1.01  # ignored targets
    _compare("MultiDepthLimitedMSE", _config(), out, tgt, [{}, {}], 0)


@pytest.mark.parametrize("name", ["CrossEntropyLoss", "CrossEntropyLossWeighted"])
def test_cross_entropy(name):
    out = _rand((50, 17), 5)
    tgt = np.random.default_rng(6).integers(0, 17, (50, 1)).astype(np.float32)
    _compare(name, _config(), out, tgt, [{}, {}], 0)


def test_mse_plus_weight_accum():
    out, tgt = _rand((32, 3), 7), _rand((32, 3), 8)
    weights = _rand((32, 16), 9, 0.0, 0.2)
    _compare("MSEPlusWeightAccum", _config(), out, tgt,
             [{}, {FSK.nerf_weights_output: weights}], 0, wrt_dict=(FSK.nerf_weights_output,))


@pytest.mark.parametrize("epoch", [0, 5, 12, 25, 40])
@pytest.mark.parametrize("components,blend", [
    (["One", "Zero", "NerfA"], [-1.0, -1.0, -1.0]),
    (["One", "NerfW", "NerfA"], [0.5, 0.25, -1.0]),
])
def test_oracle_loss_across_the_blend_schedule(epoch, components, blend):
    cfg = _config(lossComponents=components, lossComponentBlending=blend)
    out = _rand((32, 16), 10)
    d1 = {FSK.nerf_weights_output: _rand((32, 16), 11, 0.0, 1.0),
          FSK.nerf_alpha_output: _rand((32, 16), 12, -1.0, 1.0)}
    _compare("NeRFWeightMultiplicationLoss", cfg, out, None, [{}, d1], epoch,
             wrt_dict=(FSK.nerf_weights_output, FSK.nerf_alpha_output))


def test_registry_names():
    cfg = _config()
    for name in ("none", "None"):
        assert tl.get_loss_by_name(name, cfg, 0) is None
    with pytest.raises(ValueError):
        tl.get_loss_by_name("Huber", cfg, 0)
