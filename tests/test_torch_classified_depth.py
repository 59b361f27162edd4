"""The GT-depth oracle's target, ``ClassifiedDepth``, against the JAX
package's on the CPU, on depth maps made from a numpy seed:

* ``ClassifiedDepth.features_from_depth`` (the target the port's trainers
  build on the batch's device) equal to the JAX trainer's target, the
  numpy path of ``adanerf_tpu/native/disc_depth.py``, and to its C library
  (``disc_depth.c``, compiled here from the JAX package's source into the
  test's directory) within 1e-6 (the C code takes its window weights in
  float32), for windows 1, 3 and 5;
* for ``multiDepthWindowSize`` 1, 3, ``5:3`` and ``5:4``: the name as
  JAX's; the numbers as the JAX trainer's target (which applies no depth
  window) and, without a depth window, as JAX's ``features_from_depth``;
* the trainer's target for a batch (``assemble_train_batch``) equal to
  the JAX trainer's."""

import ctypes
import os
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adanerf_tpu.config import Config as JConfig
from adanerf_tpu.native import disc_depth as jdd
from adanerf_tpu.pipeline.features import ClassifiedDepth as JClassifiedDepth
from adanerf_tpu.train_state import TrainState as JTrainState
from adanerf_tpu_torch.config import Config as TConfig
from adanerf_tpu_torch.pipeline.features import ClassifiedDepth as TClassifiedDepth
from adanerf_tpu_torch.train_state import TrainState as TTrainState

from scene_utils import dense_config_args, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 20, 28


def _depth(seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 1, (H, W)).astype(np.float32)
    d[rng.uniform(0, 1, (H, W)) < 0.15] = 1.0  # background, at the ignore value below
    d[0, :3] = [0.0, 0.999999, 1.0 - 1e-7]      # the first and last bins' edges
    idx = rng.choice(H * W, 96, replace=False).astype(np.int64)
    idx[:2] = [0, H * W - 1]                     # corners: the window clamps
    return d, idx


@pytest.fixture(scope="module")
def c_library(tmp_path_factory):
    """The JAX package's disc_depth.c built on its own into a temporary
    directory (the JAX package's tree is left as it is)."""
    out = str(tmp_path_factory.mktemp("native") / "libdisc_depth.so")
    subprocess.run(["cc", "-O2", "-shared", "-fPIC",
                    os.path.join(ROOT, "adanerf_tpu", "native", "disc_depth.c"), "-o", out, "-lm"],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    lib.disc_depth_features.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float]
    return lib


@pytest.mark.parametrize("window", [1, 3, 5])
@pytest.mark.parametrize("n_feat,ignore", [(128, 1.01), (16, 1.0)])
def test_disc_depth_matches_jax_numpy_and_c(c_library, window, n_feat, ignore):
    d, idx = _depth(window)
    config = SimpleNamespace(multiDepthFeatures=[n_feat], multiDepthWindowSize=[str(window)],
                             multiDepthIgnoreValue=[ignore])
    target = TClassifiedDepth(config, 0, SimpleNamespace(w=W, h=H))
    got = target.features_from_depth(torch.from_numpy(d), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, jdd.disc_depth_features_numpy(d, idx, window, n_feat,
                                                                     ignore))
    c_out = np.zeros((idx.shape[0], n_feat), np.float32)
    c_library.disc_depth_features(d.ctypes.data, idx.ctypes.data, c_out.ctypes.data, H, W,
                                  idx.shape[0], window, n_feat, ignore)
    np.testing.assert_allclose(got, c_out, rtol=0, atol=1e-6)
    assert got.max() <= 1.0 and (got > 0).any()


def _config(window):
    return SimpleNamespace(multiDepthFeatures=[32, 32], multiDepthWindowSize=[window, window],
                           multiDepthIgnoreValue=[1.01, 1.01])


@pytest.mark.parametrize("window", ["1", "3", "5:3", "5:4"])
def test_features_from_depth_matches_jax(window):
    d, idx = _depth(7)
    scene = SimpleNamespace(w=W, h=H)
    jf = JClassifiedDepth(_config(window), 0, scene)
    tf = TClassifiedDepth(_config(window), 0, scene)
    assert tf.abbr == jf.abbr and tf.n_feat == jf.n_feat == 32
    got = tf.features_from_depth(torch.from_numpy(d[None, :, :, None]), torch.from_numpy(idx))
    trainer = jdd.disc_depth_features_numpy(d, idx, jf.window_size, 32, 1.01)
    np.testing.assert_allclose(got.numpy(), trainer, rtol=0, atol=1e-6)
    if jf.d_kernel is None:
        want = jf.features_from_depth(jnp.asarray(d[None, :, :, None]), jnp.asarray(idx))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_trainer_target_matches_jax(tmp_path):
    scene = make_scene(str(tmp_path / "scene"), with_depth=True)
    argv = dense_config_args(scene, str(tmp_path / "logs")) + ["--trainWithGTDepth",
                                                              "--multiDepthWindowSize", "3",
                                                              "--multiDepthWindowSize", "3"]
    argv[argv.index("RawSigmoid")] = "ClassifiedDepth"
    argv[argv.index("NeRFWeightMultiplicationLoss")] = "BCEWithLogitsLoss"
    jts, tts = JTrainState(), TTrainState()
    jts.initialize(JConfig.init(argv=argv))
    tts.initialize(TConfig.init(argv=argv + ["--device", "cpu"]), log_path=str(tmp_path / "t"))
    jb, jt = jts.assemble_train_batch(jts.train_dataset, np.array([1, 3]))
    tb, tt = tts.assemble_train_batch(tts.train_dataset, np.array([1, 3]))
    assert sorted(tt) == sorted(jt) == [0, 1]
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt[0]))
    assert tt[0].shape == (128, 16) and float(tt[0].sum()) > 0
    np.testing.assert_array_equal(tb["DepthImageSamples"].numpy(),
                                  np.asarray(jb["DepthImageSamples"]))
