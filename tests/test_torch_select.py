"""The port's adaptive select against both JAX forms on the CPU.

Counts, slots, depths and values must be exact: the select only compares,
counts and indexes. Logits are quantized to a few levels to force ties, and
one threshold lies above every logit to exercise the argmax fallback."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adanerf_tpu.ops import samplers as jsamp
from adanerf_tpu_torch.ops import samplers as tsamp


def _logits(seed, n, d, levels):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if levels:
        x = np.round(x * levels) / levels  # many ties
    return x


def _check(t_out, j_out):
    tz, tp, tm = (a.numpy() for a in t_out)
    jz, jp, jm = (np.asarray(a) for a in j_out)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tm.sum(1), jm.sum(1))
    np.testing.assert_array_equal(tz, jz)  # inf at dead slots on both sides
    np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("seed,levels,threshold,S", [
    (0, 0, 0.5, 8), (1, 2, 0.5, 8), (2, 1, 0.0, 8), (3, 4, 1.0, 16),
    (4, 2, 99.0, 8),   # nothing passes: argmax fallback
    (5, 1, -99.0, 4),  # everything passes: top-S cap with ties
])
def test_adaptive_select_matches_jax(seed, levels, threshold, S):
    d = _logits(seed, 512, 128, levels)
    j_fast = jsamp.adaptive_select(jnp.asarray(d), S, threshold)
    j_ref = jsamp.adaptive_select_reference(jnp.asarray(d), S, threshold)
    _check(tsamp.adaptive_select(torch.from_numpy(d), S, threshold), j_fast)
    _check(tsamp.adaptive_select(torch.from_numpy(d), S, threshold), j_ref)
    _check(tsamp.adaptive_select_reference(torch.from_numpy(d), S, threshold), j_ref)


def test_fallback_takes_lowest_argmax_bin():
    d = np.zeros((2, 32), np.float32)
    d[0, [3, 7]] = 1.0  # tie at the max: lower bin wins
    d[1, :] = -1.0      # all equal
    z, p, m = tsamp.adaptive_select(torch.from_numpy(d), 4, 5.0)
    assert m.sum(1).tolist() == [1, 1]
    np.testing.assert_allclose(z[:, 0].numpy(), [(3 + 0.5) / 32, 0.5 / 32])
    np.testing.assert_array_equal(p[:, 0].numpy(), [1.0, -1.0])


def test_select_keep_caps_ties_in_bin_order():
    d = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.5, 0.1]])
    keep = tsamp.select_keep(d, 3, 0.2)
    assert keep.tolist() == [[True, True, False, True, False, False]]
