"""The port's viewer entry point and its host helpers, on the CPU."""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adanerf_tpu.data import camera as jcamera
from adanerf_tpu.ops.raygen import generate_ray_directions
from adanerf_tpu_torch import viewer as tviewer
from adanerf_tpu_torch.data.png import read_png
from adanerf_tpu_torch.ops.kernels.megakernel_dense import MegakernelDense

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import viewer as jviewer  # noqa: E402  (the JAX package's root viewer)


@pytest.mark.parametrize("export", ["trained_mscene_export", "trained_ndc_export"])
@pytest.mark.parametrize("fname", ["config.ini", "dataset_info.txt"])
def test_parse_kv_file_matches_jax(export, fname):
    path = os.path.join(ROOT, "demo", export, fname)
    assert tviewer.parse_kv_file(path) == jviewer.parse_kv_file(path)


def test_orbit_poses_match_jax():
    np.testing.assert_array_equal(np.array(tviewer.orbit_poses((0, 0, 3), 0.5, 7)),
                                  np.array(jviewer.orbit_poses((0, 0, 3), 0.5, 7)))


def test_none_normalization_stays_a_string():
    rt, _ = tviewer.build_renderer_from_export(os.path.join(ROOT, "demo", "trained_ndc_export"),
                                               device="cpu")
    assert rt.norm_name == "None" and rt.use_ndc and rt.max_samples == 16


def test_viewer_main_on_cpu(tmp_path, capsys):
    stats = tviewer.main([os.path.join(ROOT, "demo", "trained_mscene_export"), "-s", "24", "16",
                          "-n", "2", "--logging_interval", "1", "--device", "cpu",
                          "-d", str(tmp_path)])
    out = capsys.readouterr().out
    assert "frame     2:" in out and "avg samples/px" in out and "Mrays/s" in out
    frames = sorted(os.listdir(tmp_path))
    assert frames == ["00000.png", "00001.png"]
    img = read_png(str(tmp_path / frames[-1]))
    assert img.shape == (16, 24, 3)
    want = (stats["last_frame"].clamp(0, 1).numpy() * 255).astype(np.uint8)
    np.testing.assert_array_equal(img, want)
    assert stats["frames"] == 2 and 1.0 <= stats["samples_per_pixel"] <= 8.0


def _write_cam_path(path, transforms):
    with open(path, "w") as f:
        json.dump({"frames": [{"transform_matrix": t.tolist()} for t in transforms]}, f)


def test_viewer_v3_on_cpu_with_a_camera_path(tmp_path):
    """--megakernel v3 renders the dense path along a --camPath file and
    dumps PNG frames; the frame equals K2's plain version at that camera."""
    export = os.path.join(ROOT, "demo", "trained_mscene_export")
    rt, scene = tviewer.build_renderer_from_export(export, dtype_str="fp32", device="cpu")
    c = np.asarray(scene.view_cell_center, np.float32)
    rot = jcamera.euler2mat(0.1, -0.2, 0.05).astype(np.float32)
    transforms = []
    for k in range(3):
        t = np.eye(4, dtype=np.float32)
        t[:3, :3] = rot
        t[:3, 3] = c + 0.1 * k
        transforms.append(t)
    cam = tmp_path / "path.json"
    _write_cam_path(cam, transforms)
    dump = tmp_path / "frames"
    stats = tviewer.main([export, "--device", "cpu", "--megakernel", "v3", "-s", "24", "24",
                          "-n", "2", "-bs", "100", "-d", str(dump), "--camPath", str(cam),
                          "--fp32"])
    assert sorted(os.listdir(dump)) == ["00000.png", "00001.png"]
    dirs = tviewer.frame_directions(scene, 24, 24, "cpu")
    want, _ = MegakernelDense(rt).plain(dirs, torch.from_numpy(transforms[1][:3, 3].copy()),
                                        torch.from_numpy(rot))
    np.testing.assert_allclose(stats["last_frame"].reshape(-1, 3).numpy(), want.numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        read_png(str(dump / "00001.png")),
        (want.clamp(0, 1).reshape(24, 24, 3).numpy() * 255).astype(np.uint8))


@pytest.mark.parametrize("variant,kernel", [("v5d", "MegakernelCompact"),
                                            ("v5", "MegakernelCompact"),
                                            ("v3", "MegakernelDense")])
def test_variant_picks_its_kernel(variant, kernel):
    rt, _ = tviewer.build_renderer_from_export(
        os.path.join(ROOT, "demo", "trained_mscene_export"), device="cpu")
    assert type(tviewer.build_kernel(rt, variant)).__name__ == kernel


def test_v3_refuses_an_ndc_export(tmp_path):
    with pytest.raises(ValueError, match="NDC"):
        tviewer.main([os.path.join(ROOT, "demo", "trained_ndc_export"), "--device", "cpu",
                      "--megakernel", "v3", "-s", "8", "8", "-n", "1"])


def test_non_adaptive_model_is_refused():
    rt, _ = tviewer.build_renderer_from_export(
        os.path.join(ROOT, "demo", "trained_mscene_export"), device="cpu")
    rt.threshold = 0.0
    with pytest.raises(SystemExit, match="adaptive model"):
        tviewer.build_kernel(rt, "v3")


def test_mesh_is_refused_naming_its_roadmap_item():
    with pytest.raises(SystemExit, match="item 13"):
        tviewer.main([os.path.join(ROOT, "demo", "trained_mscene_export"), "--device", "cpu",
                      "--mesh", "2"])


def test_camera_path_matches_jax_viewer():
    path = os.path.join(ROOT, "demo", "llff_scene", "cam_path_spiral.json")
    cams = tviewer.camera_path(path, 5)
    ref = jcamera.PredefinedCamera.import_camera_path(os.path.dirname(path), "cam_path_spiral", 5)
    assert len(cams) == 5
    for (pos, rot), t in zip(cams, ref):
        np.testing.assert_array_equal(pos, t[:3, 3])
        np.testing.assert_array_equal(rot, t[:3, :3])


def _dense_copy(tmp_path):
    """demo/trained_mscene_export with adaptiveSamplingThreshold 0.0: the
    kind of export a dense run writes, which the kernels do not take."""
    src = os.path.join(ROOT, "demo", "trained_mscene_export")
    dst = tmp_path / "dense_export"
    dst.mkdir()
    for name in os.listdir(src):
        with open(os.path.join(src, name), "rb") as f:
            data = f.read()
        if name == "config.ini":
            text = data.decode()
            text = re.sub(r"adaptiveSamplingThreshold = [0-9.e-]+",
                          "adaptiveSamplingThreshold = 0.0", text)
            assert "adaptiveSamplingThreshold = 0.0" in text
            data = text.encode()
        (dst / name).write_bytes(data)
    return str(dst)


def test_dense_export_renders_through_the_plain_path_as_jax_does(tmp_path, capsys):
    """Without --megakernel the port renders an export the kernels do not
    take through RealtimeRenderer.render_frame, within 2e-4 of the JAX
    viewer's plain frame (its make_frame_renderer) at the same camera, in
    fp32; --dynamic parses."""
    export = _dense_copy(tmp_path)
    stats = tviewer.main([export, "-s", "20", "16", "-n", "2", "--device", "cpu", "--fp32",
                          "--logging_interval", "1", "--dynamic"])
    out = capsys.readouterr().out
    assert "rendering through the plain renderer" in out and "threshold 0.0" in out
    assert stats["route"].startswith("the plain renderer")
    assert stats["samples_per_pixel"] == 8.0  # every slot of every ray
    rt, scene = jviewer.build_renderer_from_export(export, 320, "fp32")
    assert rt.threshold == 0.0
    focal = 0.5 * 20 / np.tan(0.5 * scene.fov)
    dirs = generate_ray_directions(20, 16, scene.fov, focal).reshape(-1, 3).astype(np.float32)
    pose = jviewer.orbit_poses(scene.view_cell_center, 0.4 * scene.view_cell_radius, 2)[1]
    render = rt.make_frame_renderer(dirs.shape[0])
    frame, counts = render(*rt.params, jnp.asarray(pose, jnp.float32),
                           jnp.eye(3, dtype=jnp.float32), jnp.asarray(dirs))
    got = stats["last_frame"].reshape(-1, 3).numpy()
    np.testing.assert_allclose(got, np.asarray(frame), rtol=0, atol=2e-4)


def test_megakernel_still_refuses_a_dense_export(tmp_path):
    with pytest.raises(SystemExit, match="adaptive model"):
        tviewer.main([_dense_copy(tmp_path), "-s", "8", "8", "-n", "1", "--device", "cpu",
                      "--megakernel", "v5d"])


def test_an_adaptive_export_renders_through_k1_by_default(capsys):
    stats = tviewer.main([os.path.join(ROOT, "demo", "trained_mscene_export"), "-s", "8", "8",
                          "-n", "1", "--device", "cpu"])
    assert stats["route"].startswith("K1 (MegakernelCompact")
    assert "rendering through K1" in capsys.readouterr().out
