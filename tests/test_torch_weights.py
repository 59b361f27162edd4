"""Weight carry-over: the JAX parameter pytree (as numpy) and the exported
npz give identical port modules, and those modules hold exactly the JAX
package's loaded parameters."""

import os

import numpy as np
import pytest
import torch

import jax

from adanerf_tpu.models import mlp as jmlp
from adanerf_tpu.train_state import load_tree
from adanerf_tpu_torch.models import mlp as tmlp
from adanerf_tpu_torch.utils.weights import (flatten_params, from_jax_params,
                                             load_export_weights)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORT = os.path.join(ROOT, "demo", "trained_mscene_export")


@pytest.mark.parametrize("net", [0, 1])
def test_from_jax_params_equals_load_export_weights(net):
    path = os.path.join(EXPORT, f"model{net}.weights")
    if net == 0:
        jdef, tdefs = (jmlp.BaseNetDef(depth=8, width=256, n_in=90, n_out=128),
                       [tmlp.BaseNetDef(8, 256, 90, 128) for _ in range(2)])
    else:
        jdef, tdefs = jmlp.NeRFDef(), [tmlp.NeRFDef() for _ in range(2)]
    params = load_tree(path, jdef.init(jax.random.PRNGKey(0)))
    a = from_jax_params(tdefs[0], jax.tree.map(np.asarray, params))
    b = load_export_weights(tdefs[1], path)
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    flat = flatten_params(jax.tree.map(np.asarray, params))
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
        np.testing.assert_array_equal(sa[k].numpy(), flat[k])


def test_flat_keys_match_export_files():
    with np.load(os.path.join(EXPORT, "model1.weights")) as f:
        keys = set(f.files)
    assert keys == set(tmlp.NeRFDef().state_dict())


def test_mismatched_weights_raise():
    with pytest.raises(KeyError):
        load_export_weights(tmlp.NeRFDef(), os.path.join(EXPORT, "model0.weights"))
    with pytest.raises(ValueError):
        load_export_weights(tmlp.BaseNetDef(8, 256, 91, 128), os.path.join(EXPORT, "model0.weights"))
