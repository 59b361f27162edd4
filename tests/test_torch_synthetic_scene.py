"""The port's synthetic scene makers (``utils/synthetic.py`` and its CLIs
``make_synthetic_scene`` and ``make_llff_scene``) against the JAX
package's (``tests/scene_utils.py``, ``tools/make_*_scene.py``) on the
CPU: the same JSON files and ``poses_bounds.npy``, PNG pixels equal when
decoded, depth maps within 1e-6; the port's files import neither JAX nor
imageio."""

import json
import os

import imageio.v2 as imageio
import numpy as np
import pytest

from adanerf_tpu_torch import make_llff_scene as t_llff_cli
from adanerf_tpu_torch import make_synthetic_scene as t_scene_cli
from adanerf_tpu_torch.data.png import read_png
from adanerf_tpu_torch.utils import synthetic

import scene_utils


def _files(d):
    return sorted(os.path.relpath(os.path.join(b, n), d)
                  for b, _dirs, names in os.walk(d) for n in names)


def _same_scene(got, want):
    assert _files(got) == _files(want)
    for f in _files(want):
        a, b = os.path.join(got, f), os.path.join(want, f)
        if f.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), f
        elif f.endswith(".png"):
            np.testing.assert_array_equal(read_png(a), imageio.imread(b))
        elif f.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert za.files == zb.files
                np.testing.assert_allclose(za["depth"], zb["depth"], atol=1e-6, rtol=0)
        elif f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            raise AssertionError(f"unexpected file {f}")


@pytest.mark.parametrize("objects", ["sphere", "multi", "translucent"])
def test_make_scene_matches_jax(tmp_path, objects):
    kw = dict(w=20, h=16, n_train=3, n_val=1, n_test=1, with_depth=True, objects=objects)
    got = synthetic.make_scene(str(tmp_path / "port"), **kw)
    want = scene_utils.make_scene(str(tmp_path / "jax"), **kw)
    _same_scene(got, want)


def test_make_llff_scene_matches_jax(tmp_path):
    got = synthetic.make_llff_scene(str(tmp_path / "port"), w=40, h=30, n_images=5, seed=2)
    want = scene_utils.make_llff_scene(str(tmp_path / "jax"), w=40, h=30, n_images=5, seed=2)
    _same_scene(got, want)


def test_clis_write_the_jax_scenes(tmp_path, capsys):
    t_scene_cli.main([str(tmp_path / "s"), "-s", "16", "12", "--n-train", "2", "--n-val", "1",
                      "--n-test", "1", "--depth", "--objects", "multi", "--cell-frac", "0.3"])
    assert "wrote synthetic scene" in capsys.readouterr().out
    _same_scene(str(tmp_path / "s"), scene_utils.make_scene(
        str(tmp_path / "js"), w=16, h=12, n_train=2, n_val=1, n_test=1, with_depth=True,
        objects="multi", cell_frac=0.3))
    t_llff_cli.main([str(tmp_path / "l"), "-s", "24", "18", "--n-images", "3", "--seed", "1"])
    assert "wrote LLFF scene" in capsys.readouterr().out
    _same_scene(str(tmp_path / "l"), scene_utils.make_llff_scene(
        str(tmp_path / "jl"), w=24, h=18, n_images=3, seed=1))
