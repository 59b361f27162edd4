"""The port's elementwise ops against the JAX package on the CPU, fp32.

Inputs are made from a numpy seed and handed to both sides. Tolerance: atol
1e-5 (both sides run the same fp32 formula; XLA and torch may round
transcendentals and reductions differently in the last ulp)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adanerf_tpu.ops import depth_transforms as jdt
from adanerf_tpu.ops import encoding as jenc
from adanerf_tpu.ops import normalization as jnorm
from adanerf_tpu.ops import raygen as jraygen
from adanerf_tpu.ops import raymarch as jrm
from adanerf_tpu.ops import samplers as jsamp
from adanerf_tpu_torch.ops import depth_transforms as tdt
from adanerf_tpu_torch.ops import encoding as tenc
from adanerf_tpu_torch.ops import normalization as tnorm
from adanerf_tpu_torch.ops import raygen as traygen
from adanerf_tpu_torch.ops import raymarch as trm
from adanerf_tpu_torch.ops import samplers as tsamp

ATOL = 1e-5


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), atol=atol, rtol=0)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("n_freqs", [0, 2, 4, 10])
def test_positional_encode(rng, n_freqs):
    x = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    t = tenc.positional_encode(torch.from_numpy(x), n_freqs)
    _close(t, jenc.positional_encode(jnp.asarray(x), n_freqs))
    assert t.shape[-1] == tenc.encoded_width("nerf", 3, n_freqs)


def test_get_encoder(rng):
    x = rng.uniform(-1, 1, (8, 3)).astype(np.float32)
    _close(tenc.get_encoder("nerf", 4)(torch.from_numpy(x)),
           jenc.get_encoder("nerf", 4)(jnp.asarray(x)))
    _close(tenc.get_encoder("none", 4)(torch.from_numpy(x)), x)
    with pytest.raises(ValueError):
        tenc.get_encoder("hash", 4)


@pytest.mark.parametrize("name", [None, "None", "Centered", "MaxDepth", "MaxDepthCentered",
                                  "LogCentered", "InverseDistCentered",
                                  "InverseSqrtDistCentered"])
def test_normalizations(rng, name):
    x = rng.uniform(-4, 4, (128, 3)).astype(np.float32)
    c = np.array([0.3, -0.2, 1.0], np.float32)
    t = tnorm.get_normalization(name)(torch.from_numpy(x), torch.from_numpy(c), 8.0)
    _close(t, jnorm.get_normalization(name)(jnp.asarray(x), jnp.asarray(c), 8.0))


@pytest.mark.parametrize("name", ["log", "linear", "none"])
def test_depth_transforms(rng, name):
    dr = (0.1, 8.0)
    z = rng.uniform(0, 1, (256,)).astype(np.float32)
    w = rng.uniform(0.05, 8.0, (256,)).astype(np.float32)
    tt, jt = tdt.get_depth_transform(name), jdt.get_depth_transform(name)
    assert tt.name == jt.name
    _close(tt.to_world(torch.from_numpy(z), dr), jt.to_world(jnp.asarray(z), dr))
    _close(tt.from_world(torch.from_numpy(w), dr), jt.from_world(jnp.asarray(w), dr))
    # numpy inputs stay numpy, as in the JAX module
    _close(tt.from_world(w, dr), jt.from_world(w, dr))


def test_raygen():
    np.testing.assert_array_equal(traygen.generate_ray_directions(12, 8, 0.8, 300.0),
                                  jraygen.generate_ray_directions(12, 8, 0.8, 300.0))


def test_rotate_and_sphere_offset(rng):
    rot = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(2)]).astype(np.float32)
    d = rng.normal(size=(2, 32, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rd_t = trm.rotate_ray_dirs(torch.from_numpy(rot), torch.from_numpy(d))
    _close(rd_t, jrm.rotate_ray_dirs(jnp.asarray(rot), jnp.asarray(d)))
    o = rng.uniform(-0.3, 0.3, (64, 3)).astype(np.float32)
    c = np.array([0.1, 0.0, -0.1], np.float32)
    _close(trm.ray_sphere_offset(rd_t, torch.from_numpy(o), torch.from_numpy(c), 0.9),
           jrm.ray_sphere_offset(jnp.asarray(rd_t.numpy()), jnp.asarray(o), jnp.asarray(c), 0.9))


def test_ndc_rays(rng):
    o = np.concatenate([rng.uniform(-0.2, 0.2, (64, 2)), rng.uniform(-0.1, 0.1, (64, 1))],
                       1).astype(np.float32)
    d = np.concatenate([rng.uniform(-0.4, 0.4, (64, 2)), -np.ones((64, 1))], 1).astype(np.float32)
    to, td = trm.ndc_rays(240, 320, 378.4, 1.0, torch.from_numpy(o), torch.from_numpy(d))
    jo, jd = jrm.ndc_rays(240, 320, 378.4, 1.0, jnp.asarray(o), jnp.asarray(d))
    _close(to, jo)
    _close(td, jd)


@pytest.mark.parametrize("acc", ["alpha", "weights", None])
def test_adaptive_raw2outputs_masked(rng, acc):
    raw = rng.normal(size=(48, 8, 4)).astype(np.float32) * 3
    z = np.sort(rng.uniform(0.1, 1, (48, 8)), axis=1).astype(np.float32)
    mask = rng.uniform(size=(48, 8)) < 0.6
    z = np.where(mask, z, np.inf).astype(np.float32)
    p = rng.normal(size=(48, 8)).astype(np.float32)
    outs_t = trm.adaptive_raw2outputs_masked(torch.from_numpy(raw), torch.from_numpy(z),
                                             torch.from_numpy(mask), torch.from_numpy(p), acc)
    outs_j = jrm.adaptive_raw2outputs_masked(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(mask),
                                             jnp.asarray(p), acc)
    for i in (0, 2, 3, 4, 5):  # rgb, acc, weights, depth, alpha (disp divides by ~0)
        _close(outs_t[i], outs_j[i])


def test_linearly_spaced_z():
    _close(tsamp.linearly_spaced_z(5, 0.001, 1.0, 8), jsamp.linearly_spaced_z(5, 0.001, 1.0, 8))
