"""The port's viewer entry point and its host helpers, on the CPU."""

import os
import sys

import numpy as np
import pytest

from adanerf_tpu_torch import viewer as tviewer

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
    assert frames == ["00000.npy", "00001.npy"]
    img = np.load(tmp_path / frames[0])
    assert img.shape == (16, 24, 3) and np.isfinite(img).all()
    assert stats["frames"] == 2 and 1.0 <= stats["samples_per_pixel"] <= 8.0
