"""The port's config parser and data layer against the JAX package's, on
the CPU, exactly (no tolerance: the same numpy arithmetic on the same
files): parsed flags of the dense config with command-line overrides, the
scene metadata, the loaded split arrays, the R-sequence pixel picks, the
shuffled image batches and the assembled train batch."""

import numpy as np
import pytest

from adanerf_tpu.config import Config as JConfig
from adanerf_tpu.data import dataset as jdataset
from adanerf_tpu.data import prefetch as jprefetch
from adanerf_tpu.data import sampling as jsampling
from adanerf_tpu.train_state import TrainState as JTrainState
from adanerf_tpu_torch.config import Config as TConfig
from adanerf_tpu_torch.data import dataset as tdataset
from adanerf_tpu_torch.data import prefetch as tprefetch
from adanerf_tpu_torch.data import sampling as tsampling
from adanerf_tpu_torch.train_state import TrainState as TTrainState

from scene_utils import dense_config_args, make_scene

DENSE_INI = "configs/dense_training.ini"


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene_data")), w=24, h=20, n_train=5,
                      with_depth=True)


def _overrides():
    return ["--epochsLockWeightsBefore", "-1", "--epochsLockWeightsBefore", "-1",
            "--lrate", "1e-3", "--samples", "64", "--perturb"]


def test_config_matches_jax_on_the_dense_ini(tmp_path):
    argv = ["-c", DENSE_INI, "-data", str(tmp_path), "-log", str(tmp_path)] + _overrides()
    j, t = vars(JConfig.init(argv=argv)), vars(TConfig.init(argv=argv))
    assert t.pop("device") == "cuda"
    j.pop("device")
    assert t == j


def test_config_no_flags_turn_off_ini_switches(tmp_path):
    base = ["-c", DENSE_INI, "-data", str(tmp_path), "-log", str(tmp_path)]
    assert TConfig.init(argv=base).performEvaluation is True
    c = TConfig.init(argv=base + ["--no-performEvaluation", "--device", "cpu", "--bf16"])
    assert c.performEvaluation is False and c.device == "cpu" and c.bf16 is True


def test_config_matches_jax_on_test_args(scene, tmp_path):
    argv = dense_config_args(scene, str(tmp_path)) + ["--randomSeed", "3"]
    j, t = vars(JConfig.init(argv=argv)), vars(TConfig.init(argv=argv))
    j.pop("device"), t.pop("device")
    assert t == j


def _configs(scene, tmp_path, extra=()):
    argv = dense_config_args(scene, str(tmp_path), samples=32) + ["--randomSeed", "0"] + list(extra)
    return JConfig.init(argv=argv), TConfig.init(argv=argv + ["--device", "cpu"])


@pytest.mark.parametrize("transform,scale", [("log", 1), ("linear", 1), ("log", 2)])
def test_dataset_info_and_split_match_jax(scene, tmp_path, transform, scale):
    """At scale 2 the JAX package downscales with cv2's INTER_AREA and the
    port with a 2x2 block mean: equal up to float rounding (atol 1e-6)."""
    jc, tc = _configs(scene, tmp_path, ["--depthTransform", transform, "--trainWithGTDepth",
                                        "--scale", str(scale)])
    ji, ti = jdataset.DatasetInfo(jc), tdataset.DatasetInfo(tc)
    js, ts = ji.scene_static(), ti.scene_static()
    for f in ("w", "h", "fov", "focal", "view_cell_center", "view_cell_radius", "depth_range",
              "depth_range_warped", "depth_max"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.depth_transform.name == js.depth_transform.name
    jd = jdataset.ViewCellDataset(jc, ji, "train", 32)
    td = tdataset.ViewCellDataset(tc, ti, "train", 32)
    for f in ("color_images", "poses", "rotations", "directions", "base_ray_z"):
        np.testing.assert_allclose(getattr(td, f), getattr(jd, f), rtol=0,
                                   atol=0 if scale == 1 else 1e-6, err_msg=f)
    assert jd.depth_images is not None
    np.testing.assert_allclose(td.depth_images, jd.depth_images, rtol=0, atol=1e-6)
    assert td.image_filenames == jd.image_filenames and len(td) == len(jd)


@pytest.mark.parametrize("window", [(0, 4096), (29_999_000, 4096), (123, 1)])
def test_rsequence_picks_match_jax(window):
    start, count = window
    j, t = jsampling.RSequence(dims=2), tsampling.RSequence(dims=2)
    np.testing.assert_array_equal(t.alpha, j.alpha)
    for seq in (j, t):
        seq.set_offset(start)
    for _ in range(3):  # consecutive windows, through the 30M wrap
        np.testing.assert_array_equal(t.pixel_indices(count, 400, 300),
                                      j.pixel_indices(count, 400, 300))
        assert t.offset_start == j.offset_start


def test_uniform_sequence_matches_jax():
    j = jsampling.get_sequence_generator("PreGeneratedUniformRandomSequenceGenerator", dims=2,
                                         num_pregeneration=5000)
    t = tsampling.get_sequence_generator("PreGeneratedUniformRandomSequenceGenerator", dims=2,
                                         num_pregeneration=5000)
    np.testing.assert_array_equal(t.pixel_indices(700, 24, 20), j.pixel_indices(700, 24, 20))


def test_epoch_image_indices_match_jax():
    j = list(jprefetch.epoch_image_indices(7, 2, 12, seed=4))
    t = list(tprefetch.epoch_image_indices(7, 2, 12, seed=4))
    assert len(t) == len(j) == 12
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_prefetcher_yields_in_order_and_closes():
    pre = tprefetch.BatchPrefetcher(lambda idx: int(idx.sum()),
                                    tprefetch.epoch_image_indices(9, 3, 20, seed=1))
    got = [next(pre) for _ in range(5)]
    ref = [int(i.sum()) for i in list(tprefetch.epoch_image_indices(9, 3, 5, seed=1))]
    assert got == ref
    pre.close()
    assert not pre._thread.is_alive()


def test_prefetcher_raises_the_producers_error():
    def bad(_idx):
        raise OSError("unreadable image")
    pre = tprefetch.BatchPrefetcher(bad, iter([np.zeros(1)]))
    with pytest.raises(OSError, match="unreadable image"):
        next(pre)
    pre.close()


def test_assemble_train_batch_matches_jax(scene, tmp_path):
    jc, tc = _configs(scene, tmp_path / "a", ["--trainWithGTDepth"])
    jts, tts = JTrainState(), TTrainState()
    jts.initialize(jc)
    tts.initialize(tc)
    for idx in (np.array([0, 3]), np.array([4, 1]), np.array([2, 2])):
        jb, jt = jts.assemble_train_batch(jts.train_dataset, idx)
        tb, tt = tts.assemble_train_batch(tts.train_dataset, idx)
        assert set(tb) == set(jb) - {"ImageSampleIndices"}
        for k in tb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
        assert set(tt) == set(jt) == {1}
        np.testing.assert_array_equal(tt[1].numpy(), np.asarray(jt[1]))
