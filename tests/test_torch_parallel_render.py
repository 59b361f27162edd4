"""Ray-sharded frames (adanerf_tpu_torch/parallel/render.py) on the CPU,
counterpart of tests/test_parallel_render.py: a frame cut into equal padded
slices over a device list (here the CPU named n times) must equal the whole
frame bit for bit, through K1's and K2's plain versions, in fp32 and bf16,
on a 24x24 frame that needs padding; and it must agree with the JAX
package's renderer on the same rays as the unsharded port frame does
(tests/test_torch_realtime.py's bars: counts exact, rgb within 2e-4). The
viewer's ``--mesh`` renders through it, and refuses more devices than
there are and a frame that no kernel renders."""

import functools
import os
import re
import sys

import numpy as np
import pytest
import torch

from adanerf_tpu.parallel.render import frame_pad as j_frame_pad
from adanerf_tpu_torch import viewer as tviewer
from adanerf_tpu_torch.ops.kernels.megakernel_compact import MegakernelCompact
from adanerf_tpu_torch.ops.kernels.megakernel_dense import MegakernelDense
from adanerf_tpu_torch.parallel.render import ShardedFrame, devices_mesh, frame_pad

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORT = os.path.join(ROOT, "demo", "trained_mscene_export")
sys.path.insert(0, ROOT)
import viewer as jviewer  # noqa: E402  (the JAX package's root viewer)


@pytest.mark.parametrize("n_pix,tile,n", [(640_000, 256, 8), (640_000, 256, 1), (512, 64, 4),
                                          (513, 64, 4), (576, 128, 8), (1, 128, 3)])
def test_frame_pad(n_pix, tile, n):
    assert frame_pad(n_pix, tile, n) == j_frame_pad(n_pix, tile, n)
    assert frame_pad(n_pix, tile, n) % (tile * n) == 0 and frame_pad(n_pix, tile, n) >= n_pix
    assert frame_pad(640_000, 256, 8) == 641_024


def _frame(dtype):
    rt, scene = tviewer.build_renderer_from_export(EXPORT, dtype_str=dtype, device="cpu")
    dirs = tviewer.frame_directions(scene, 24, 24, "cpu")
    pose = tviewer.orbit_poses(scene.view_cell_center, 0.4 * scene.view_cell_radius, 8)[1]
    return rt, scene, dirs, pose, np.eye(3, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _whole_frame(dtype, kind):
    rt, _, dirs, pose, rot = _frame(dtype)
    kernel = kind(rt)
    return kernel, dirs, pose, rot, kernel(dirs, pose, rot)


# K2's plain version shades every slot; in bf16 on the CPU that is the slow
# case, so bf16 runs through K1's
@pytest.mark.parametrize("dtype,kind", [("fp32", MegakernelCompact), ("fp32", MegakernelDense),
                                        ("bf16", MegakernelCompact)])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_plain_frame_is_bit_exact(dtype, kind, n):
    kernel, dirs, pose, rot, (rgb, counts) = _whole_frame(dtype, kind)
    assert frame_pad(576, 128, n) > 576  # every slicing pads the 24x24 frame
    frame = ShardedFrame(kernel, ["cpu"] * n, dirs)
    assert len(frame.slices) == n and len({s.shape[0] for s in frame.slices}) == 1
    rgb_s, counts_s = frame(pose, rot)
    assert rgb_s.shape == (576, 3) and counts_s.shape == (576,)
    torch.testing.assert_close(counts_s, counts, rtol=0, atol=0)
    torch.testing.assert_close(rgb_s, rgb, rtol=0, atol=0)


def test_sharded_frame_agrees_with_jax():
    """The sharded K1 frame (its plain version, fp32, 4 slices) against the
    JAX renderer's frame on the same rays."""
    rt, scene, dirs, pose, rot = _frame("fp32")
    rgb, counts = ShardedFrame(MegakernelCompact(rt), ["cpu"] * 4, dirs)(pose, rot)
    rt_j, _ = jviewer.build_renderer_from_export(EXPORT, 576, "fp32")
    pose = np.asarray(pose, np.float32)
    rgb_j = rt_j.render_frame(pose, rot, dirs.numpy())
    _, mask, _ = rt_j._oracle_fn(rt_j.params[0], pose, rot, dirs.numpy())
    np.testing.assert_array_equal(counts.numpy(), np.asarray(mask).sum(axis=1))
    np.testing.assert_allclose(rgb.numpy(), rgb_j, atol=2e-4, rtol=0)


def test_devices_mesh_refuses_more_devices_than_present():
    assert devices_mesh(1, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="only 1 device"):
        devices_mesh(2, "cpu")
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"only {n} device"):
        devices_mesh(n + 1, "cuda")


def test_viewer_mesh_renders_the_unsharded_frame(capsys):
    args = [EXPORT, "--device", "cpu", "-s", "24", "24", "-n", "2", "--fp32"]
    whole = tviewer.main(args)
    sharded = tviewer.main(args + ["--mesh", "1"])
    assert "rays-sharded rendering over 1 device(s)" in capsys.readouterr().out
    torch.testing.assert_close(sharded["last_frame"], whole["last_frame"], rtol=0, atol=0)
    assert sharded["samples_per_pixel"] == whole["samples_per_pixel"]


def test_viewer_mesh_above_the_device_count_is_refused():
    with pytest.raises(SystemExit, match="only 1 device"):
        tviewer.main([EXPORT, "--device", "cpu", "--mesh", "2", "-s", "8", "8", "-n", "1"])


def test_viewer_mesh_on_the_plain_path_is_refused(tmp_path):
    """A dense run's export (threshold 0) renders on the plain path, which
    has no sharded frame, as the JAX viewer refuses --mesh without
    --megakernel."""
    dst = tmp_path / "dense_export"
    dst.mkdir()
    for name in os.listdir(EXPORT):
        data = open(os.path.join(EXPORT, name), "rb").read()
        if name == "config.ini":
            data = re.sub(rb"adaptiveSamplingThreshold = [0-9.e-]+",
                          b"adaptiveSamplingThreshold = 0.0", data)
        (dst / name).write_bytes(data)
    with pytest.raises(SystemExit, match="needs a frame kernel"):
        tviewer.main([str(dst), "--device", "cpu", "--mesh", "1", "-s", "8", "8", "-n", "1"])
