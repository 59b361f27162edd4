"""The port's image output and rendering against the JAX package's on the
CPU:

* the plasma, coolwarm and magma tables against matplotlib's within 1e-7,
  and their 8-bit colours equal; the histogram's red-green-blue ramp;
* ``save_img``: the PNG decoded equal to ``pyplot.imsave``'s, pixel for
  pixel, for the images the render and evaluation paths write;
  ``transform_img`` equal to the JAX package's;
* ``render_rays_chunked`` on 4,096 pixels of test image 0 of the committed
  fine run (S=8, threshold 0.2), fp32, in padded chunks: rgb within 2e-4,
  sample counts exact except on at most 1 ray in 10,000;
* ``validate_batch``'s loss equal to the JAX trainer's (rtol 1e-5) with the
  same weights on a synthetic scene."""

import importlib.util
import os

import matplotlib
import numpy as np
import pytest
import torch
from matplotlib import colors, pyplot as plt

import jax

from adanerf_tpu.config import Config as JConfig
from adanerf_tpu.evaluation.evaluate import load_config as j_load_config
from adanerf_tpu.pipeline.keys import FSK
from adanerf_tpu.render import render_rays_chunked as j_render_rays_chunked
from adanerf_tpu.train_state import TrainState as JTrainState
from adanerf_tpu.utils.saveimage import transform_img as j_transform_img
from adanerf_tpu_torch import train as t_train
from adanerf_tpu_torch.config import Config as TConfig
from adanerf_tpu_torch.data.png import read_png
from adanerf_tpu_torch.evaluation.evaluate import load_config as t_load_config
from adanerf_tpu_torch.render import render_rays_chunked as t_render_rays_chunked
from adanerf_tpu_torch.train_state import TrainState as TTrainState
from adanerf_tpu_torch.utils import colormaps
from adanerf_tpu_torch.utils.saveimage import Dim, save_img, transform_img
from adanerf_tpu_torch.utils.weights import from_jax_params

from scene_utils import dense_config_args, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "demo", "mscene")
RUN = os.path.join(
    ROOT, "demo", "mlogs", "mscene",
    "lo_SpPoDi(nerf(10-4))-relu0(256x8)-S-128_RayMarchFromPoses_nSD[8_LSfCDA_(0.2)_128_0.0]_"
    "acc_alpha(nerf(10-4))-NeRF1(256x8[4])-RGBARayMarch_[0.025_1.0]_[10k_30k]_O_Z_N")


@pytest.mark.parametrize("name", ["plasma", "coolwarm", "magma"])
def test_colour_tables_match_matplotlib(name):
    cmap = matplotlib.colormaps.get_cmap(name)
    lut = cmap(np.arange(256))  # integer input: the table's entries
    assert float(np.abs(colormaps.TABLES[name] - lut[:, :3]).max()) <= 1e-7
    for dtype in (np.float32, np.float64):
        x = np.concatenate([np.linspace(-0.1, 1.1, 40001), [np.nan, 0.0, 1.0, np.inf]]).astype(dtype)
        want, got = cmap(x), colormaps.apply(name, x)
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= 1e-7
        np.testing.assert_array_equal((got * 255).astype(np.uint8), cmap(x, bytes=True))


def test_histogram_ramp_matches_matplotlib():
    cmap = colors.LinearSegmentedColormap.from_list("", ["red", "green", "blue"])
    x = np.arange(255.0) / 255
    got = colormaps.ramp(x, [(1, 0, 0), (0, 128 / 255, 0), (0, 0, 1)])
    assert float(np.abs(got - cmap(x)[:, :3]).max()) <= 1e-7


def _images():
    rng = np.random.default_rng(0)
    h, w = 13, 17
    flat_rgb = rng.random((h * w, 3)).astype(np.float32)
    return h, w, {
        "rgb_f32": (rng.random((h, w, 3)).astype(np.float32), False),
        "rgb_f64": (rng.random((h, w, 3)), False),
        "rgb_edges": (np.array([[[0, 1, 0.5], [1 - 1e-7, 1 / 255, 254.999 / 255]]],
                               np.float32), False),
        "magma_f64": (matplotlib.colormaps.get_cmap("magma")(
            rng.random((h, w)).astype(np.float32))[..., :3], False),
        "flat_rgb": (flat_rgb, True),
        "flat_depth": (rng.random((h * w, 1)).astype(np.float32), True),
        "plasma_rgba": (matplotlib.colormaps.get_cmap("plasma")(rng.random(h * w)), True),
        "multi_depth": (rng.random((h * w, 16)).astype(np.float32), True),
    }


@pytest.mark.parametrize("key", sorted(_images()[2]))
def test_save_img_pixels_equal_imsave(key, tmp_path):
    h, w, images = _images()
    img, transform = images[key]
    if key == "rgb_edges":
        h, w = img.shape[:2]
    dim = Dim(h, w)
    ref = j_transform_img(img, dim) if transform else img
    plt.imsave(tmp_path / "want.png", np.asarray(ref))
    save_img(img, dim, str(tmp_path / "got.png"), transform)
    want = np.asarray(matplotlib.image.imread(tmp_path / "want.png"))
    want = (want * 255).round().astype(np.uint8) if want.dtype != np.uint8 else want
    got = read_png(str(tmp_path / "got.png"))
    assert got.shape == want.shape == (h, w, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", ["flat_rgb", "flat_depth", "plasma_rgba", "multi_depth"])
def test_transform_img_matches_jax(key):
    h, w, images = _images()
    img, _ = images[key]
    np.testing.assert_array_equal(transform_img(img, Dim(h, w)), j_transform_img(img, Dim(h, w)))


@pytest.fixture(scope="module")
def committed_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("render_run")
    _, tts = t_load_config(DATA, "cpu", RUN, [], [], cl_out_dir=str(out / "t"),
                           skip_if_already_done_once=False)
    _, jts = j_load_config(DATA, 0, RUN, [], [], cl_out_dir=str(out / "j"),
                           skip_if_already_done_once=False)
    return tts, jts


def test_render_rays_chunked_matches_jax(committed_run):
    tts, jts = committed_run
    pix = np.sort(np.random.default_rng(0).choice(400 * 400, 4096, replace=False))
    ds = jts.test_dataset
    collect = [FSK.adaptive_sample_positions, FSK.oracle_weights, FSK.nerf_estimated_depth,
               FSK.nerf_weights_output]
    # 1,000-ray chunks: the last of the five is padded
    j_imgs, j_extras = j_render_rays_chunked(jts, ds.poses[0], ds.rotations[0], 1000,
                                             collect=collect, pixel_indices=pix)
    t_imgs, t_extras = t_render_rays_chunked(tts, ds.poses[0], ds.rotations[0], 1000,
                                             collect=collect, pixel_indices=pix)
    assert [i.shape for i in t_imgs] == [i.shape for i in j_imgs] == [(4096, 128), (4096, 3)]
    assert sorted(t_extras) == sorted(j_extras) == sorted(collect)
    S = tts.config_file.numRaymarchSamples[-1]
    cnt_t = np.rint(t_extras[FSK.adaptive_sample_positions] * S).astype(int)
    cnt_j = np.rint(j_extras[FSK.adaptive_sample_positions] * S).astype(int)
    agree = cnt_t == cnt_j
    assert int((~agree).sum()) <= len(pix) // 10000
    assert float(np.abs(t_imgs[1] - j_imgs[1])[agree].max()) <= 2e-4
    assert float(np.abs(t_imgs[0] - j_imgs[0]).max()) <= 2e-4  # the oracle's outputs
    assert 1.0 < cnt_t.mean() < 2.0  # the run's ~1.3 samples a pixel
    for k in (FSK.nerf_estimated_depth, FSK.nerf_weights_output, FSK.oracle_weights):
        assert t_extras[k].shape == j_extras[k].shape
        assert float(np.abs(t_extras[k] - j_extras[k])[agree].max()) <= 2e-4


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene_render")), n_val=2)


def _jax_root_train():
    spec = importlib.util.spec_from_file_location("jax_root_train",
                                                  os.path.join(ROOT, "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("thr", [0.0, 0.2])
def test_validate_batch_loss_matches_jax(scene, tmp_path, thr):
    argv = dense_config_args(scene, str(tmp_path), samples=48, threshold=thr) + [
        "--randomSeed", "0", "--inferenceChunkSize", "100"]
    jts, tts = JTrainState(), TTrainState()
    jts.initialize(JConfig.init(argv=argv))
    tts.initialize(TConfig.init(argv=argv + ["--device", "cpu"]), log_path=str(tmp_path / "t") + "/")
    for m, p in zip(tts.models, jts.params):
        from_jax_params(m, jax.tree.map(np.asarray, p))
    j_loss, j_imgs = _jax_root_train().validate_batch(jts, 7, 0.5)
    t_loss, t_imgs = t_train.validate_batch(tts, 7, 0.5)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    assert len(t_imgs) == len(j_imgs) == 2
    for t, j in zip(t_imgs, j_imgs):
        assert abs(t["psnr"] - j["psnr"]) <= 1e-3
        for a, b in zip(t["images"], j["images"]):
            assert a.shape == b.shape and float(np.abs(a - b).max()) <= 2e-4
    with open(os.path.join(tts.logDir, "logs.csv"), newline="") as f:
        assert f.read().startswith("epoch,loss,accuracy,train_loss\r\n7,")
