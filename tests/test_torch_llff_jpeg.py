"""A real capture's JPEG images through the port, against the JAX package
on the CPU, on ``demo/llff_scene_jpeg`` (``demo/llff_scene``'s 32 images
written as quality-95 4:2:0 JPEG, half of them with restart markers, by
``tests/torch_jpeg_fixtures.py``):

* ``load_llff_data`` at factor 1 and 2 (the area resize): images within
  1/255 of the JAX package's (imageio), poses, bounds, spiral path and
  ``i_test`` equal;
* ``python -m adanerf_tpu_torch.convert_llff`` against the JAX package's
  root ``convert_llff.py`` on copies of the scene: every JSON file equal,
  every split image within 1 level;
* the factor-1 conversion against the PNG scene's (``demo/llff_scene``):
  the same JSON files, and the images' mean PSNR equal to the constant
  pinned in ``tests/torch_fixtures/llff_jpeg.json`` within its bar (the
  value ``chip_smoke.py`` phase 19 holds the card's reading to); at
  factor 2 the focal length and the image size halve."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from adanerf_tpu.data import llff as j_llff
from adanerf_tpu_torch import convert_llff as t_convert
from adanerf_tpu_torch.data import llff as t_llff
from adanerf_tpu_torch.data.png import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG_SCENE = os.path.join(ROOT, "demo", "llff_scene_jpeg")
PNG_SCENE = os.path.join(ROOT, "demo", "llff_scene")
PINNED = os.path.join(ROOT, "tests", "torch_fixtures", "llff_jpeg.json")
JSONS = ["dataset_info.json", "cam_path_spiral.json", "transforms_train.json",
         "transforms_val.json", "transforms_test.json"]
SPLITS = ("train", "val", "test")


def test_the_jpeg_scene_is_the_png_scenes_images():
    names = sorted(os.listdir(os.path.join(JPEG_SCENE, "images")))
    assert names == [n.replace(".png", ".jpg")
                     for n in sorted(os.listdir(os.path.join(PNG_SCENE, "images")))]
    assert len(names) == 32
    assert np.array_equal(np.load(os.path.join(JPEG_SCENE, "poses_bounds.npy")),
                          np.load(os.path.join(PNG_SCENE, "poses_bounds.npy")))


@pytest.mark.parametrize("factor", [1, 2])
def test_load_llff_data_on_jpeg_matches_jax(factor):
    got = t_llff.load_llff_data(JPEG_SCENE, factor=factor, recenter=True, bd_factor=0.75)
    want = j_llff.load_llff_data(JPEG_SCENE, factor=factor, recenter=True, bd_factor=0.75)
    assert got[0].shape == want[0].shape == (32, 240 // factor, 320 // factor, 3)
    err = float(np.abs(got[0] - want[0]).max())
    print(f"factor {factor}: images max abs err {err:.3e}")
    assert err <= 1 / 255
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def _convert_port(d, factor):
    t_convert.main(["-dir", d, "-factor", str(factor)])


def _convert_jax(d, factor):
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "convert_llff.py"), "-dir", d,
                           "-factor", str(factor)], cwd=ROOT, capture_output=True, text=True,
                          env=dict(os.environ, ADANERF_PLATFORM="cpu", JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]


def _jsons(d):
    out = {}
    for n in JSONS:
        with open(os.path.join(d, n)) as f:
            out[n] = json.load(f)
    return out


def _split_images(d):
    return {f"{s}/{f}": read_png(os.path.join(d, s, f))
            for s in SPLITS for f in sorted(os.listdir(os.path.join(d, s)))}


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The JPEG scene converted by the port at factors 1 and 2, and by the
    JAX package at factor 1."""
    out = {}
    for who, factor, fn in (("port", 1, _convert_port), ("port", 2, _convert_port),
                            ("jax", 1, _convert_jax)):
        d = str(tmp_path_factory.mktemp(f"llff_jpeg_{who}{factor}") / "scene")
        shutil.copytree(JPEG_SCENE, d)
        fn(d, factor)
        out[who, factor] = d
    return out


def test_convert_llff_on_jpeg_matches_jax(converted):
    t, j = converted["port", 1], converted["jax", 1]
    assert _jsons(t) == _jsons(j)
    got, want = _split_images(t), _split_images(j)
    assert sorted(got) == sorted(want) and len(got) == 36
    worst = max(int(np.abs(got[k].astype(np.int16) - want[k]).max()) for k in want)
    print(f"split images: worst {worst} level(s) apart")
    assert worst <= 1


def mean_psnr_vs_png(d):
    """Mean PSNR (dB) of a conversion's split images against the PNG
    scene's: the number tests/torch_fixtures/llff_jpeg.json pins."""
    got, want = _split_images(d), _split_images(PNG_SCENE)
    assert sorted(got) == sorted(want)
    psnrs = [10 * np.log10(1.0 / np.mean((got[k].astype(np.float64) / 255
                                          - want[k].astype(np.float64) / 255) ** 2))
             for k in sorted(want)]
    return float(np.mean(psnrs)), len(psnrs)


def test_factor_1_conversion_matches_the_png_scene(converted):
    d = converted["port", 1]
    assert _jsons(d) == _jsons(PNG_SCENE)
    with open(PINNED) as f:
        pinned = json.load(f)
    mean, n = mean_psnr_vs_png(d)
    print(f"mean PSNR of the JPEG scene's conversion against the PNG scene's: {mean:.6f} dB "
          f"over {n} images (pinned {pinned['mean_psnr_db']:.6f})")
    assert n == pinned["images"]
    assert abs(mean - pinned["mean_psnr_db"]) <= pinned["bar_db"]


def test_factor_2_halves_the_focal_length_and_the_size(converted):
    full, half = (_jsons(converted["port", f])["dataset_info.json"] for f in (1, 2))
    assert half["resolution"] == [160, 120] and full["resolution"] == [320, 240]
    focal = [r[0] / 2 / np.tan(info["camera_angle_x"] / 2)
             for r, info in ((full["resolution"], full), (half["resolution"], half))]
    np.testing.assert_allclose(focal[1], focal[0] / 2, rtol=1e-6)
    img = read_png(os.path.join(converted["port", 2], "train", "00001.png"))
    assert img.shape == (120, 160, 3)
