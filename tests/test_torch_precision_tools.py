"""The port's ``precision_study``, ``probe_threshold`` and
``probe_oracle_ranks`` and the viewer's per-net precisions
(``"oracle32"``, ``"nerf32"``) held against the JAX package's on the CPU
(``tests/torch_tool_scene.py``'s 40x40 scene; 4,096 rays of
demo/trained_mscene_export), and K1/K2's refusal of a mixed precision."""

import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adanerf_tpu_torch import eval_megakernel, precision_study, probe_oracle_ranks
from adanerf_tpu_torch import probe_threshold
from adanerf_tpu_torch import viewer as tviewer

from torch_tool_scene import EXPORT, N_RAYS, ROOT, SIZE, run_jax_tool, small_scene

sys.path.insert(0, ROOT)
import viewer as jviewer  # noqa: E402  (the JAX package's root viewer)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return small_scene(tmp_path_factory.mktemp("scene") / "mscene40")


def test_precision_study_matches_jax(scene, monkeypatch, capsys):
    argv = [EXPORT, scene, "--n-frames", "2"]
    out = run_jax_tool("precision_study", argv, monkeypatch, capsys)
    want = json.loads(out.strip().splitlines()[-1])
    got, imgs = precision_study.main(argv + ["--device", "cpu"])
    assert list(got) == list(want) == ["bf16", "oracle32", "nerf32", "fp32"]
    for v, bar in (("bf16", 0.05), ("oracle32", 0.05), ("nerf32", 0.05), ("fp32", 1e-4)):
        for k in ("psnr_gt", "psnr_gt_mean"):
            assert abs(got[v][k] - want[v][k]) <= bar, (v, k)
    assert got["fp32"]["psnr_vs_fp32"] == want["fp32"]["psnr_vs_fp32"] == 120.0
    assert all(len(imgs[v]) == 2 and imgs[v][0].shape == (SIZE, SIZE, 3) for v in imgs)


def _rays(scene_obj, seed=0):
    dirs = tviewer.frame_directions(scene_obj, 64, 64, "cpu")[:N_RAYS]
    rng = np.random.RandomState(seed)
    pose = (np.asarray(scene_obj.view_cell_center)
            + rng.uniform(-0.3, 0.3, 3) * scene_obj.view_cell_radius).astype(np.float32)
    return dirs, pose


@pytest.mark.parametrize("dtype_str", ["oracle32", "nerf32"])
def test_per_net_precision_matches_jax(dtype_str):
    """The viewer's "oracle32" / "nerf32" renderers against JAX's on 4,096
    rays: the fp32 net's outputs (the oracle's logits, the NeRF's sigmoided
    rgba) within 1e-5, the frame within bf16's
    reach of the other net's rounding."""
    rt, sc = tviewer.build_renderer_from_export(EXPORT, batch_size=N_RAYS, dtype_str=dtype_str,
                                                device="cpu")
    jrt, _ = jviewer.build_renderer_from_export(EXPORT, N_RAYS, dtype_str)
    fp32_net = "oracle" if dtype_str == "oracle32" else "nerf"
    assert getattr(rt, f"{fp32_net}_dtype") is None and rt.dtype is torch.bfloat16
    assert getattr(jrt, f"{fp32_net}_dtype") is None
    dirs, pose = _rays(sc)
    rot = np.eye(3, dtype=np.float32)
    # the fp32 net alone, on the same inputs in both packages
    if fp32_net == "oracle":
        with torch.no_grad():
            *_, got = rt.oracle_logits(torch.from_numpy(pose), torch.from_numpy(rot), dirs)
        x = np.concatenate([np.asarray(jrt.enc0_dir(jnp.asarray(dirs.numpy()))),
                            np.asarray(jrt.enc0_pos(jnp.asarray(
                                _sphere_exit(rt, pose, dirs))))], -1)
        want = np.asarray(jrt.oracle_def.apply(jrt.params[0], jnp.asarray(x),
                                               dtype=jrt.oracle_dtype))
    else:
        x = np.random.RandomState(3).uniform(-1, 1, (N_RAYS, rt.nerf.input_ch
                                                      + rt.nerf.input_ch_views))
        x = x.astype(np.float32)
        # the rgba that the renderer composites: the raw outputs reach ~1e2,
        # where an fp32 ulp is ~1e-5 already
        with torch.no_grad():
            got = torch.sigmoid(rt.nerf(torch.from_numpy(x), rt.nerf_dtype))
        want = np.asarray(jax.nn.sigmoid(jrt.nerf_def.apply(jrt.params[1], jnp.asarray(x),
                                                            dtype=jrt.nerf_dtype)))
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-5, rtol=0)
    frame = rt.render_frame(pose, rot, dirs)[0].numpy()
    jframe = np.asarray(jrt.render_frame(pose, rot, dirs.numpy()))
    assert eval_megakernel.psnr(frame, jframe[:, :3]) >= 40.0


def _sphere_exit(rt, pose, dirs):
    _, _, proj, _ = rt.oracle_logits(torch.from_numpy(pose), torch.eye(3), dirs)
    return proj.numpy()


def test_kernels_refuse_a_mixed_precision():
    for dtype_str in ("oracle32", "nerf32"):
        rt, _ = tviewer.build_renderer_from_export(EXPORT, dtype_str=dtype_str, device="cpu")
        for variant in ("v5d", "v5", "v3"):
            with pytest.raises(ValueError, match="mixed precision.*one precision"):
                tviewer.build_kernel(rt, variant)
    with pytest.raises(ValueError, match="dtype_str"):
        tviewer.build_renderer_from_export(EXPORT, dtype_str="fp16", device="cpu")


@pytest.mark.parametrize("threshold", [0.2, 0.01, 1e-4])
def test_probe_counts_match_jax(threshold):
    """The probes' oracle logits and counts against the JAX tools' math
    (oracle_def.apply in fp32, tools/probe_threshold.py:57-66) on 4,096
    rays: the counts exactly."""
    rt, sc = tviewer.build_renderer_from_export(EXPORT, batch_size=N_RAYS, dtype_str="fp32",
                                                device="cpu")
    jrt, _ = jviewer.build_renderer_from_export(EXPORT, N_RAYS)
    pose = probe_threshold.in_cell_poses(sc, 2)[1]
    dirs = tviewer.frame_directions(sc, 64, 64, "cpu")
    got = torch.cat(list(probe_threshold.frame_logits(rt, pose, dirs)))
    from adanerf_tpu.ops.raymarch import ray_sphere_offset
    nds = jnp.asarray(dirs.numpy()) @ jnp.eye(3).T
    origins = jnp.broadcast_to(jnp.asarray(pose), nds.shape)
    dist = ray_sphere_offset(nds, origins, jnp.asarray(sc.view_cell_center), sc.view_cell_radius)
    proj = origins + nds * dist[:, None]
    want = jrt.oracle_def.apply(jrt.params[0], jnp.concatenate(
        [jrt.enc0_dir(nds), jrt.enc0_pos(proj)], -1))
    want_counts = np.asarray(jnp.clip((want >= threshold).sum(-1), 1, jrt.max_samples))
    got_counts = probe_threshold.ray_counts(got, threshold, rt.max_samples).numpy()
    assert got.shape == (N_RAYS, 128)
    # the two packages' fp32 sums differ in order: a logit by up to ~1e-4 of its size
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)
    np.testing.assert_array_equal(got_counts, want_counts)
    # the renderer keeps the same counts (the select clips to [1, S] as the probe does)
    _, counts = rt.render_rays(torch.from_numpy(pose), torch.eye(3), dirs)
    if threshold == rt.threshold:
        np.testing.assert_array_equal(counts.numpy(), got_counts)


def test_probe_main_and_ranks(capsys, monkeypatch):
    """The two CLIs on the CPU, their 800x800 frame cut to 64x64 (one
    batch of 4,096 rays): samples per pixel grow as the threshold falls,
    and the ranks come out in descending order."""
    monkeypatch.setattr(probe_threshold, "SIZE", 64)
    monkeypatch.setattr(probe_threshold, "BATCH", N_RAYS)
    out = probe_threshold.main([EXPORT, "--thresholds", "0.2,0.01", "--poses", "2",
                                "--device", "cpu"])
    assert 1.0 <= out[0.2] < out[0.01] <= 8.0
    assert "avg_samples_px" in capsys.readouterr().out
    tops = probe_oracle_ranks.main([EXPORT, "--ranks", "4", "--device", "cpu"])
    assert tops.shape == (N_RAYS, 4) and (np.diff(tops, axis=1) <= 0).all()
    assert "rank  mean" in capsys.readouterr().out
