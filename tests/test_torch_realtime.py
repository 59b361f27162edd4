"""The whole slice on the CPU: the port's export loader and renderer against
the JAX package's viewer.build_renderer_from_export(..., "fp32") on 2048 rays
of each trained export in the repo.

Counts must be exact and rgb within 2e-4. The one allowed exception is a
ray whose JAX oracle logit lies within 1e-5 of the threshold or of its S-th
largest value, where XLA's and torch's different summation orders can flip
a bin; the test shows that this is the cause of every such ray."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adanerf_tpu.ops.raymarch import ray_sphere_offset
from adanerf_tpu_torch import viewer as tviewer
from adanerf_tpu_torch.realtime import RealtimeRenderer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import viewer as jviewer  # noqa: E402  (the JAX package's root viewer)

NEAR = 1e-5


def _jax_logits(rt, pose, rot, dirs):
    """The JAX renderer's raw oracle logits for these rays (its _oracle_stage
    up to the select)."""
    sc = rt.scene
    nds = jnp.asarray(dirs) @ jnp.asarray(rot).T
    origins = jnp.broadcast_to(jnp.asarray(pose), nds.shape)
    dist = ray_sphere_offset(nds, origins, jnp.asarray(sc.view_cell_center), sc.view_cell_radius)
    proj = origins + nds * dist[:, None]
    x = jnp.concatenate([rt.enc0_dir(nds), rt.enc0_pos(proj)], axis=-1)
    return np.asarray(rt.oracle_def.apply(rt.params[0], x))


@pytest.mark.parametrize("name", ["trained_mscene_export", "trained_ndc_export"])
def test_slice_matches_jax(name):
    path = os.path.join(ROOT, "demo", name)
    rt_j, _ = jviewer.build_renderer_from_export(path, 2048, "fp32")
    rt_t, scene = tviewer.build_renderer_from_export(path, 2048, "fp32", device="cpu")
    assert rt_t.use_ndc == rt_j.use_ndc and rt_t.norm_name == rt_j.config.rayMarchNormalization[1]
    dirs = tviewer.frame_directions(scene, 64, 32, "cpu")
    pose = np.asarray(tviewer.orbit_poses(scene.view_cell_center,
                                          0.4 * scene.view_cell_radius, 4)[1], np.float32)
    rot = np.eye(3, dtype=np.float32)

    rgb_j = rt_j.render_frame(pose, rot, dirs.numpy())
    _, mask, _ = rt_j._oracle_fn(rt_j.params[0], jnp.asarray(pose), jnp.asarray(rot),
                                 jnp.asarray(dirs.numpy()))
    cnt_j = np.asarray(mask).sum(axis=1)
    rgb_t, cnt_t = rt_t.render_frame(pose, rot, dirs)
    rgb_t, cnt_t = rgb_t.numpy(), cnt_t.numpy()

    agree = cnt_t == cnt_j
    if not agree.all():
        logits = _jax_logits(rt_j, pose, rot, dirs.numpy())[~agree]
        kth = -np.sort(-logits, axis=1)[:, rt_t.max_samples - 1:rt_t.max_samples]
        near = np.minimum(np.abs(logits - rt_t.threshold), np.abs(logits - kth)).min(axis=1)
        assert (near <= NEAR).all(), f"count flips away from a boundary: {near}"
    assert agree.mean() >= 0.999
    np.testing.assert_allclose(rgb_t[agree], rgb_j[agree], atol=2e-4, rtol=0)


def test_counts_and_samples_per_pixel_are_plausible():
    """The mscene export keeps about 1.3 samples per pixel (its test-view
    rate), far under its cap of 8."""
    rt, scene = tviewer.build_renderer_from_export(
        os.path.join(ROOT, "demo", "trained_mscene_export"), 4096, "fp32", device="cpu")
    dirs = tviewer.frame_directions(scene, 64, 64, "cpu")
    rgb, counts = rt.render_frame(np.asarray(scene.view_cell_center), np.eye(3), dirs)
    assert rgb.shape == (4096, 3) and torch.isfinite(rgb).all()
    assert 1 <= counts.min() and counts.max() <= 8
    assert 1.0 < counts.float().mean() < 3.0


def test_threshold_zero_shades_every_slot_like_jax():
    """threshold 0 (a dense-sampled export): every ray shades all S slots at
    linearly spaced depths with unit oracle weights, as the JAX renderer's
    uncompacted path does; rgb within 2e-4."""
    path = os.path.join(ROOT, "demo", "trained_mscene_export")
    rt_j, _ = jviewer.build_renderer_from_export(path, 512, "fp32")
    rt_j.threshold, rt_j.compaction = 0.0, False
    rt_t, scene = tviewer.build_renderer_from_export(path, 512, "fp32", device="cpu")
    rt_t.threshold = 0.0
    dirs = tviewer.frame_directions(scene, 32, 16, "cpu")
    pose = np.asarray(scene.view_cell_center, np.float32)
    rgb_j = rt_j.render_frame(pose, np.eye(3, dtype=np.float32), dirs.numpy())
    rgb_t, cnt_t = rt_t.render_frame(pose, np.eye(3), dirs)
    assert (cnt_t == rt_t.max_samples).all()
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, atol=2e-4, rtol=0)


def test_dense_path_matches_jax_uncompacted_renderer():
    """compaction=False shades every slot (dead ones masked) as the JAX
    RealtimeRenderer(compaction=False) does, at the export's threshold 0.2:
    counts exact, rgb within 2e-4, and within 2e-4 of the compacted path."""
    path = os.path.join(ROOT, "demo", "trained_mscene_export")
    rt_j, _ = jviewer.build_renderer_from_export(path, 512, "fp32")
    rt_j.compaction = False
    rt_t, scene = tviewer.build_renderer_from_export(path, 512, "fp32", device="cpu")
    assert rt_t.compaction
    dense = RealtimeRenderer(rt_t.oracle, rt_t.nerf, scene, rt_t.config, batch_size=512,
                             device="cpu", compaction=False)
    assert not dense.compaction and rt_t.threshold == 0.2
    dirs = tviewer.frame_directions(scene, 32, 32, "cpu")
    pose = np.asarray(tviewer.orbit_poses(scene.view_cell_center,
                                          0.4 * scene.view_cell_radius, 4)[2], np.float32)
    rot = np.eye(3, dtype=np.float32)
    rgb_j = rt_j.render_frame(pose, rot, dirs.numpy())
    _, mask, _ = rt_j._oracle_fn(rt_j.params[0], jnp.asarray(pose), jnp.asarray(rot),
                                 jnp.asarray(dirs.numpy()))
    rgb_t, cnt_t = dense.render_frame(pose, rot, dirs)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(mask).sum(axis=1))
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, atol=2e-4, rtol=0)
    rgb_c, _ = rt_t.render_frame(pose, rot, dirs)
    np.testing.assert_allclose(rgb_t.numpy(), rgb_c.numpy(), atol=2e-4, rtol=0)
