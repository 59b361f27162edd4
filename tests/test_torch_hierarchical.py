"""The port's hierarchical-sampling ops and z-samplers against the JAX
package's on the CPU, fp32, on inputs made from a numpy seed:

* ``raw2alpha``, ``nerf_raw2outputs`` (with and without the oracle
  premultiply) and ``compaction``: within 1e-6;
* ``sample_pdf`` (deterministic, and on uniforms drawn by JAX and handed
  to the port) in CDF space: each side's samples, put through the float64
  CDF of the same weights, give the uniforms back within 1e-6 plus the
  CDF's slope times four fp32 roundings of the position. A sample's
  position itself is (u - cdf_below) / (cdf_above - cdf_below) of its bin:
  XLA's cumsum and torch's sum the pdf in different orders (up to ~4e-7
  apart), and a bin of small mass divides that difference by its mass; in
  a bin of mass near the 1e-5 guard (which may take the bin on one side
  and not the other) a sample is held to lie in its bin;
* every sampler of ``ops/samplers.py``: the deterministic forms (``det``,
  noise 0) and the noisy ones on JAX's draws handed to the port, within
  1e-6 in normalized depth and 1e-5 in world depth (up to 9, where an
  fp32 ulp is ~1e-6 and the log warp's ``pow`` rounds differently in XLA
  and torch); ``from_classified_depth``, whose samples come from
  ``sample_pdf``, in CDF space as above."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adanerf_tpu.ops import compaction as jcomp
from adanerf_tpu.ops import depth_transforms as jdt
from adanerf_tpu.ops import raymarch as jrm
from adanerf_tpu.ops import samplers as jsamp
from adanerf_tpu_torch.ops import compaction as tcomp
from adanerf_tpu_torch.ops import depth_transforms as tdt
from adanerf_tpu_torch.ops import raymarch as trm
from adanerf_tpu_torch.ops import samplers as tsamp

TOL = 1e-6
WORLD = 1e-5  # world depths up to 9
DR = (0.5, 9.0)


def _close(t, j, atol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_raw2alpha(rng):
    raw = rng.normal(0, 2, (64, 16)).astype(np.float32)
    dists = rng.uniform(0, 0.3, (64, 16)).astype(np.float32)
    _close(trm.raw2alpha(_t(raw), _t(dists)), jrm.raw2alpha(jnp.asarray(raw), jnp.asarray(dists)))


@pytest.mark.parametrize("mult", [None, "alpha", "weights"])
def test_nerf_raw2outputs(rng, mult):
    raw = rng.normal(0, 2, (48, 24, 4)).astype(np.float32)
    z = np.sort(rng.uniform(0.5, 9.0, (48, 24)), axis=1).astype(np.float32)
    rays_d = rng.normal(0, 1, (48, 3)).astype(np.float32)
    depth = rng.uniform(0, 1, (48, 24)).astype(np.float32) if mult else None
    got = trm.nerf_raw2outputs(_t(raw), _t(z), _t(rays_d),
                               depth=None if depth is None else _t(depth), accumulation_mult=mult)
    want = jrm.nerf_raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rays_d),
                                depth=None if depth is None else jnp.asarray(depth),
                                accumulation_mult=mult)
    for name, a, b in zip(("rgb", "disp", "acc", "weights", "depth", "alpha"), got, want):
        # disparity is 1 / depth of a world depth ~5: its ulp is ~1e-8
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=1e-6, err_msg=name)


def _cdf_space(bins, weights, u, z, guard=1e-5, atol=TOL):
    """Each sample z in [0, 1], put through the float64 piecewise-linear
    CDF of ``weights`` (with sample_pdf's 1e-5 floor) over ``bins``, is its
    uniform u within atol plus the CDF's slope times 4 fp32 roundings of z;
    in a bin whose mass is near the guard (which may or may not take it in
    fp32) the sample lies in its bin (or a neighbour, u at an edge)."""
    w = weights.astype(np.float64) + 1e-5
    cdf = np.concatenate([np.zeros((w.shape[0], 1)), np.cumsum(w / w.sum(1, keepdims=True), 1)],
                         1)
    for r in range(z.shape[0]):
        f = np.interp(z[r].astype(np.float64), bins[r].astype(np.float64), cdf[r])
        k = np.clip(np.searchsorted(cdf[r], u[r], side="right"), 1, cdf.shape[1] - 1)
        mass = cdf[r][k] - cdf[r][k - 1]
        thin = mass < 2 * guard
        slope = mass / np.maximum(bins[r][k] - bins[r][k - 1], 1e-30)
        bad = np.abs(f - u[r]) > atol + slope * 4 * 2.0 ** -24
        assert not bad[~thin].any(), (r, np.abs(f - u[r])[bad & ~thin])
        n = bins.shape[1]
        lo, hi = bins[r][np.maximum(k - 2, 0)], bins[r][np.minimum(k + 1, n - 1)]
        assert ((z[r] >= lo - atol) & (z[r] <= hi + atol))[thin].all(), r


@pytest.mark.parametrize("det", [True, False])
@pytest.mark.parametrize("n_bins,n_samples", [(63, 128), (16, 18), (1, 10)])
def test_sample_pdf(rng, det, n_bins, n_samples):
    bins = np.sort(rng.uniform(0.0, 1.0, (40, n_bins + 1)), axis=1).astype(np.float32)
    weights = (rng.uniform(0, 1, (40, n_bins)) ** 3).astype(np.float32)
    weights[3] = 0.0  # a ray whose weights vanish: the 1e-5 floor
    key = None if det else jax.random.PRNGKey(n_bins)
    want = np.asarray(jrm.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), n_samples,
                                     det=det, key=key))
    u = np.broadcast_to(np.linspace(0, 1, n_samples, dtype=np.float32), (40, n_samples)) \
        if det else np.asarray(jax.random.uniform(key, (40, n_samples)))
    got = trm.sample_pdf(_t(bins), _t(weights), n_samples, det=det,
                         u=None if det else _t(u)).numpy()
    assert got.shape == want.shape
    for z in (want, got):  # JAX's samples hold the same bar
        _cdf_space(bins, weights, u, z)
    if det:
        assert (got[:, 1:] >= got[:, :-1]).all()


def test_sample_pdf_draws_from_the_generator():
    bins = torch.linspace(0, 1, 9).expand(5, 9)
    w = torch.ones(5, 8)
    a = trm.sample_pdf(bins, w, 7, generator=torch.Generator().manual_seed(1))
    b = trm.sample_pdf(bins, w, 7, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, trm.sample_pdf(bins, w, 7, det=True))


@pytest.mark.parametrize("capacity", [5, 40, 200])
def test_compaction(rng, capacity):
    mask = rng.uniform(0, 1, 120) < 0.3
    src, n_act = tcomp.compact_indices(_t(mask), capacity)
    j_src, j_n = jcomp.compact_indices(jnp.asarray(mask), capacity)
    assert int(n_act) == int(j_n)
    np.testing.assert_array_equal(src.numpy(), np.asarray(j_src))
    vals = rng.normal(0, 1, (capacity, 4)).astype(np.float32)
    _close(tcomp.scatter_back(_t(vals), src, n_act, 120),
           jcomp.scatter_back(jnp.asarray(vals), j_src, j_n, 120))


# -- samplers -----------------------------------------------------------------

@pytest.mark.parametrize("noise", [0.0, 0.5])
@pytest.mark.parametrize("world", [False, True])
def test_linearly_spaced_z(noise, world):
    key = jax.random.PRNGKey(3)
    det = noise == 0.0
    kw = dict(z_step=1 / 16, noise_amplitude=noise, det=det)
    if world:
        want = jsamp.linearly_spaced_z_world(12, 0.001, 1.0, 16, DR, jdt.LogTransform, key=key,
                                             **kw)
    else:
        want = jsamp.linearly_spaced_z(12, 0.001, 1.0, 16, key=key, **kw)
    u = None if det else _t(np.asarray(jax.random.uniform(key, (12, 16))))
    if world:
        got = tsamp.linearly_spaced_z_world(12, 0.001, 1.0, 16, DR, tdt.LogTransform, u=u, **kw)
    else:
        got = tsamp.linearly_spaced_z(12, 0.001, 1.0, 16, u=u, **kw)
    _close(got, want, atol=WORLD if world else TOL)
    assert det == bool((got == got[:1]).all())


@pytest.mark.parametrize("noise", [0.0, 0.7])
@pytest.mark.parametrize("which", ["from_depth", "from_depth_no_range", "depth_cells"])
def test_samplers_around_a_depth(rng, noise, which):
    depth = rng.uniform(0.1, 0.9, (30, 1)).astype(np.float32)
    key = jax.random.PRNGKey(5) if noise else None
    u = _t(np.asarray(jax.random.uniform(key, depth.shape))) if noise else None
    if which == "depth_cells":
        want = jsamp.from_depth_cells(jnp.asarray(depth), 8, 1 / 64, 32, noise, DR,
                                      jdt.LogTransform, key)
        got = tsamp.from_depth_cells(_t(depth), 8, 1 / 64, 32, noise, DR, tdt.LogTransform, u=u)
    else:
        world = which == "from_depth"
        want = jsamp.linearly_spaced_from_depth(jnp.asarray(depth), 8, 1 / 64, noise, DR,
                                                jdt.LogTransform, to_world=world, key=key)
        got = tsamp.linearly_spaced_from_depth(_t(depth), 8, 1 / 64, noise, DR, tdt.LogTransform,
                                               to_world=world, u=u)
    _close(got, want, atol=TOL if which == "from_depth_no_range" else WORLD)


@pytest.mark.parametrize("noise", [0.0, 0.3])
@pytest.mark.parametrize("n_depths,n_samples", [(3, 16), (4, 10), (1, 8)])
def test_linearly_spaced_from_multi_depth(rng, noise, n_depths, n_samples):
    depth = rng.uniform(-0.1, 1.1, (25, n_depths)).astype(np.float32)
    depth[0] = 0.5  # coincident depths: the separation pass pushes them apart
    key = jax.random.PRNGKey(7) if noise else None
    u = _t(np.asarray(jax.random.uniform(key, depth.shape))) if noise else None
    want = jsamp.linearly_spaced_from_multi_depth(jnp.asarray(depth), n_samples, 1 / 32, noise,
                                                  DR, jdt.LogTransform, key)
    got = tsamp.linearly_spaced_from_multi_depth(_t(depth), n_samples, 1 / 32, noise, DR,
                                                 tdt.LogTransform, u=u)
    assert got.shape == tuple(want.shape)
    _close(got, want, atol=WORLD)


def test_unit_sphere_linear_outside_log(rng):
    o = rng.uniform(-0.4, 0.4, (20, 3)).astype(np.float32)
    d = rng.normal(0, 1, (20, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = jsamp.unit_sphere_linear_outside_log(jnp.asarray(o), jnp.asarray(d), 20, 0.001, 1.0,
                                                16, DR)
    _close(tsamp.unit_sphere_linear_outside_log(_t(o), _t(d), 20, 0.001, 1.0, 16, DR), want,
           atol=WORLD)


@pytest.mark.parametrize("fixture", ["set_2_samples_test", "set_16_samples_test", "random"])
def test_from_iterative_sample_placement(rng, fixture):
    from adanerf_tpu_torch.utils.sample_placement_tracker import SamplePlacementTracker
    tracker = SamplePlacementTracker(1, 4, 3, max_sample_count=128)
    if fixture == "random":
        tracker.replace_samples_batch(rng.uniform(0, 1, (1, 12, 128)) < 0.2, 0, 0)
    else:
        getattr(tracker, fixture)()
    placement = tracker.get_unpacked_image(0).reshape(12, 128).astype(np.float32)
    want = jsamp.from_iterative_sample_placement(jnp.asarray(placement), 16, DR,
                                                 jdt.LogTransform)
    got = tsamp.from_iterative_sample_placement(_t(placement), 16, DR, tdt.LogTransform)
    finite = np.isfinite(np.asarray(want))
    np.testing.assert_array_equal(np.isfinite(got.numpy()), finite)
    _close(torch.where(torch.from_numpy(finite), got, 0), np.where(finite, want, 0), atol=WORLD)


@pytest.mark.parametrize("det", [True, False])
@pytest.mark.parametrize("disc", [128, 16, 1])
def test_from_classified_depth(rng, det, disc):
    """Unit depths from sample_pdf over the oracle's sigmoided bins, held
    in CDF space, then warped to the world as JAX warps them."""
    logits = rng.normal(0, 3, (36, disc)).astype(np.float32)
    key = None if det else jax.random.PRNGKey(disc)
    want = jsamp.from_classified_depth(jnp.asarray(logits), 16, DR, jdt.LogTransform, det=det,
                                       key=key, transform=jax.nn.sigmoid)
    unit_j = jsamp.from_classified_depth(jnp.asarray(logits), 16, DR, jdt.NoneTransform,
                                         det=det, key=key, transform=jax.nn.sigmoid)
    u = np.broadcast_to(np.linspace(0, 1, 18, dtype=np.float32), (36, 18)) if det \
        else np.asarray(jax.random.uniform(key, (36, 18)))
    kw = dict(det=det, u=None if det else _t(u), transform=torch.sigmoid)
    got = tsamp.from_classified_depth(_t(logits), 16, DR, tdt.LogTransform, **kw)
    unit = tsamp.from_classified_depth(_t(logits), 16, DR, tdt.NoneTransform, **kw)
    assert got.shape == tuple(want.shape) == (36, 16)
    _close(got, jdt.LogTransform.to_world(jnp.asarray(unit.numpy()), DR), atol=WORLD)
    weights = np.asarray(jax.nn.sigmoid(jnp.asarray(logits)))
    bins = np.broadcast_to(np.linspace(0, 1, disc + 1, dtype=np.float32), (36, disc + 1))
    for z in (unit.numpy(), np.asarray(unit_j)):
        _cdf_space(bins, weights, u[:, 1:-1], z)


def test_perturb_z_on_shared_draws():
    z = jsamp.linearly_spaced_z(9, 0.001, 1.0, 12)
    key = jax.random.PRNGKey(11)
    u = _t(np.asarray(jax.random.uniform(key, (9, 12))))
    _close(tsamp.perturb_z(_t(np.asarray(z)), u=u), jsamp.perturb_z(z, key))
