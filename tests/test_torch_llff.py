"""The port's LLFF loader, ``convert_llff`` and ``prepare_dataset``
against the JAX package's, on the CPU, on the synthetic scenes of
``tests/test_llff.py`` and ``tests/scene_utils.py``:

* ``load_llff_data`` and ``load_llff_data_nex``, with ``images_{factor}/``
  present and without it (the images area-resized, ``utils/resize.py``,
  as the JAX package does with cv2): images, poses, bounds, the spiral
  path, ``i_test`` and the NeX intrinsics equal, the images bit for bit
  (OpenCV's integer-scale area sums are reproduced in float32);
* ``python -m adanerf_tpu_torch.convert_llff`` against the JAX package's
  root ``convert_llff.py``: every JSON file equal value for value, every
  split PNG equal pixel for pixel (the port writes them with its own PNG
  encoder, JAX with PIL);
* ``python -m adanerf_tpu_torch.prepare_dataset`` against the JAX
  package's root ``prepare_dataset.py`` on a ``make_scene`` scene with
  depth maps: ``dataset_info.json`` within 1e-6 relative (the same numpy
  operations on the same float32 depths)."""

import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest

from adanerf_tpu.data import llff as j_llff
from adanerf_tpu_torch import convert_llff as t_convert
from adanerf_tpu_torch import prepare_dataset as t_prepare
from adanerf_tpu_torch.data import llff as t_llff
from adanerf_tpu_torch.data.png import read_png, write_png

from scene_utils import make_scene
from test_llff import make_llff_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(path, factor_dir=None):
    """The test_llff scene; with factor_dir=N also an ``images_N/`` folder
    of other (seeded) images at 1/N size, so a loader that read
    ``images/`` instead would differ."""
    d = make_llff_scene(str(path))
    if factor_dir:
        os.makedirs(os.path.join(d, f"images_{factor_dir}"))
        rng = np.random.default_rng(factor_dir)
        for f in sorted(os.listdir(os.path.join(d, "images"))):
            write_png(os.path.join(d, f"images_{factor_dir}", f),
                      rng.integers(0, 256, (32 // factor_dir, 40 // factor_dir, 3), np.uint8))
    return d


def _assert_same_outputs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


LOADS = [(1, None), (2, None), (4, None), (2, 2)]  # (factor, images_N folder)


@pytest.mark.parametrize("factor,folder", LOADS,
                         ids=[f"factor{f}-" + ("folder" if d else "resized" if f > 1 else "full")
                              for f, d in LOADS])
def test_load_llff_data_matches_jax(factor, folder, tmp_path):
    d = _scene(tmp_path, folder)
    got = t_llff.load_llff_data(d, factor=factor, recenter=True, bd_factor=0.75)
    want = j_llff.load_llff_data(d, factor=factor, recenter=True, bd_factor=0.75)
    _assert_same_outputs(got, want)
    assert got[0].shape == (10, 32 // factor, 40 // factor, 3)


@pytest.mark.parametrize("factor,folder,hwf", [(1, None, True), (2, None, True),
                                               (2, 2, False)])
def test_load_llff_data_nex_matches_jax(factor, folder, hwf, tmp_path):
    d = _scene(tmp_path, folder)
    if hwf:
        np.save(os.path.join(d, "hwf_cxcy.npy"), np.array([32.0, 40.0, 30.0, 20.0, 16.0]))
    got = t_llff.load_llff_data_nex(d, factor=factor)
    want = j_llff.load_llff_data_nex(d, factor=factor)
    _assert_same_outputs(got, want)
    assert got[-1].shape[0] == (5 if hwf else 3)


def _load_root_script(name):
    spec = importlib.util.spec_from_file_location(f"_root_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".json"))


@pytest.mark.parametrize("args", [["-factor", "1"], ["-factor", "2"], ["-factor", "2", "-nex", "1"]],
                         ids=["factor1", "factor2-resized", "factor2-nex"])
def test_convert_llff_matches_jax(args, tmp_path, monkeypatch):
    t_dir = _scene(tmp_path / "t")
    if "-nex" in args:
        np.save(os.path.join(t_dir, "hwf_cxcy.npy"), np.array([32.0, 40.0, 30.0, 20.0, 16.0]))
    j_dir = str(tmp_path / "j")
    shutil.copytree(t_dir, j_dir)
    t_convert.main(["-dir", t_dir] + args)
    monkeypatch.setattr(sys, "argv", ["convert_llff.py", "-dir", j_dir] + args)
    _load_root_script("convert_llff").main()

    assert _json_files(t_dir) == _json_files(j_dir) == [
        "cam_path_spiral.json", "dataset_info.json", "transforms_test.json",
        "transforms_train.json", "transforms_val.json"]
    for f in _json_files(t_dir):
        with open(os.path.join(t_dir, f)) as a, open(os.path.join(j_dir, f)) as b:
            assert json.load(a) == json.load(b), f
    n_png = 0
    for split in ("train", "val", "test"):
        names = sorted(os.listdir(os.path.join(t_dir, split)))
        assert names == sorted(os.listdir(os.path.join(j_dir, split)))
        for n in names:
            np.testing.assert_array_equal(read_png(os.path.join(t_dir, split, n)),
                                          read_png(os.path.join(j_dir, split, n)))
            n_png += 1
    assert n_png == 12  # 8 train, 2 val, 2 test (every 8th image is both)


def test_convert_llff_on_the_demo_layout(tmp_path):
    """``-factor`` with a folder of PNGs and no ``images_N/``, the layout of
    ``demo/llff_scene``: the split images are the area-resized originals."""
    d = str(tmp_path / "llff")
    os.makedirs(d)
    shutil.copytree(os.path.join(ROOT, "demo", "llff_scene", "images"), os.path.join(d, "images"))
    shutil.copyfile(os.path.join(ROOT, "demo", "llff_scene", "poses_bounds.npy"),
                    os.path.join(d, "poses_bounds.npy"))
    t_convert.main(["-dir", d, "-factor", "4"])
    with open(os.path.join(d, "dataset_info.json")) as f:
        info = json.load(f)
    assert info["resolution"] == [80, 60]
    images = j_llff.load_llff_data(d, factor=4)[0]
    with open(os.path.join(d, "transforms_test.json")) as f:
        first = json.load(f)["frames"][0]
    idx = int(os.path.basename(first["file_path"]))
    np.testing.assert_array_equal(read_png(os.path.join(d, first["file_path"][2:] + ".png")),
                                  (images[idx] * 255).astype(np.uint8))


def test_prepare_dataset_matches_jax(tmp_path, monkeypatch):
    t_dir = make_scene(str(tmp_path / "t"), with_depth=True, objects="multi")
    j_dir = str(tmp_path / "j")
    shutil.copytree(t_dir, j_dir)
    got = t_prepare.main(["-data", t_dir])
    monkeypatch.setattr(sys, "argv", ["prepare_dataset.py", "-data", j_dir])
    _load_root_script("prepare_dataset").main()
    with open(os.path.join(t_dir, "dataset_info.json")) as f:
        port = json.load(f)
    with open(os.path.join(j_dir, "dataset_info.json")) as f:
        jax_info = json.load(f)
    assert port == got and set(port) == set(jax_info)
    for k, want in jax_info.items():
        np.testing.assert_allclose(np.asarray(port[k], np.float64),
                                   np.asarray(want, np.float64), rtol=1e-6, atol=0)
    assert port["depth_range"] != [1.0, 8.0]  # rewritten from the depth maps


def test_prepare_dataset_takes_the_jax_command_line(tmp_path):
    """The JAX script's ``-d/--device`` is accepted (and, as there, unused):
    the same file as without it."""
    a = make_scene(str(tmp_path / "a"), with_depth=True)
    b = str(tmp_path / "b")
    shutil.copytree(a, b)
    want = t_prepare.main(["-data", a])
    got = t_prepare.main(["-data", b, "-d", "0"])
    assert got == want
    assert t_prepare.main(["-data", b, "--device", "1"]) == want
