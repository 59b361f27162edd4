"""The port's MLP modules against BaseNetDef.apply / NeRFDef.apply on the
CPU, same weights carried across with from_jax_params, 256 rows made from a
numpy seed. fp32 tolerance atol 1e-4 (XLA and torch sum the products in
different orders). bf16 mode (bf16 operands, fp32 accumulation): a sum that
lands on the other side of a bf16 rounding boundary moves a later layer's
input by 2^-8 relative, so differences are rare but not tiny: at most 1% of
outputs may differ by more than 1e-3, none by more than 1e-2."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adanerf_tpu.models import mlp as jmlp
from adanerf_tpu_torch.models import mlp as tmlp
from adanerf_tpu_torch.utils.weights import from_jax_params

ROWS = 256


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _x(n_in, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (ROWS, n_in)).astype(np.float32)


@pytest.mark.parametrize("depth,width,n_in,n_out,skip", [
    (4, 32, 30, 16, ""),          # small oracle
    (4, 32, 30, 16, "0::20-2:20:"),  # skip DSL: layer 2 takes features [20, 30)
    (8, 256, 90, 128, ""),        # the exported oracle's shape
])
def test_basenet_matches_jax(depth, width, n_in, n_out, skip):
    jdef = jmlp.BaseNetDef(depth=depth, width=width, n_in=n_in, n_out=n_out, skip=skip)
    params = jdef.init(jax.random.PRNGKey(depth + width))
    tdef = from_jax_params(tmlp.BaseNetDef(depth, width, n_in, n_out, skip), _np_tree(params))
    assert tdef.layer_dims() == jdef.layer_dims()
    assert tdef.macs_per_input() == jdef.macs_per_input()
    x = _x(n_in)
    with torch.no_grad():
        out = tdef(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jdef.apply(params, jnp.asarray(x))), atol=1e-4, rtol=0)


@pytest.mark.parametrize("depth,width,in_ch,in_views,skips", [
    (4, 32, 27, 15, (2,)),
    (8, 256, 63, 27, (4,)),       # the exported NeRF's shape
])
def test_nerf_matches_jax(depth, width, in_ch, in_views, skips):
    jdef = jmlp.NeRFDef(depth=depth, width=width, input_ch=in_ch, input_ch_views=in_views,
                        skips=skips)
    params = jdef.init(jax.random.PRNGKey(depth))
    tdef = from_jax_params(tmlp.NeRFDef(depth, width, in_ch, in_views, 4, skips), _np_tree(params))
    assert tdef.macs_per_input() == jdef.macs_per_input()
    x = _x(in_ch + in_views, 1)
    with torch.no_grad():
        out = tdef(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jdef.apply(params, jnp.asarray(x))), atol=1e-4, rtol=0)


def test_bf16_mode_matches_jax():
    jdef = jmlp.NeRFDef(depth=8, width=256, input_ch=63, input_ch_views=27)
    params = jdef.init(jax.random.PRNGKey(3))
    tdef = from_jax_params(tmlp.NeRFDef(), _np_tree(params))
    x = _x(90, 2)
    with torch.no_grad():
        out = tdef(torch.from_numpy(x), torch.bfloat16).numpy()
    ref = np.asarray(jdef.apply(params, jnp.asarray(x), dtype=jnp.bfloat16))
    diff = np.abs(out - ref)
    assert (diff > 1e-3).mean() <= 0.01, (diff > 1e-3).mean()
    assert diff.max() <= 1e-2, diff.max()


def test_skip_dsl_and_auto_skip():
    assert tmlp.parse_skip_dsl("0::63-7:63:", 90) == jmlp.parse_skip_dsl("0::63-7:63:", 90)
    assert tmlp.parse_skip_dsl("3:17", 40) == jmlp.parse_skip_dsl("3:17", 40)
    assert tmlp.auto_skip("auto", 8, "10-4") == jmlp.auto_skip("auto", 8, "10-4")
    with pytest.raises(ValueError):
        tmlp.parse_skip_dsl("x", 4)


def test_reset_parameters_uses_generator():
    a, b = tmlp.NeRFDef(4, 32, 27, 15), tmlp.NeRFDef(4, 32, 27, 15)
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
