"""The port's streaming split (adanerf_tpu_torch/data/streaming.py), a
bounded LRU image store for splits over the host memory budget, against
the JAX package's fully loaded and streaming splits: counterpart of
tests/test_streaming.py. The store holds the same frames as the JAX
split, drops the least recently used, the train batches assembled from it
equal the fully loaded split's and the JAX package's, and the policy
follows ADANERF_HOST_MEM_BUDGET_MB and --storeFullData as JAX's does."""

import numpy as np
import pytest

from adanerf_tpu.config import Config as JConfig
from adanerf_tpu.data import dataset as jdataset
from adanerf_tpu.data import streaming as jstreaming
from adanerf_tpu.train_state import TrainState as JTrainState
from adanerf_tpu_torch.config import Config
from adanerf_tpu_torch.data.dataset import DatasetInfo, ViewCellDataset, load_dataset_split
from adanerf_tpu_torch.data.sampling import get_sequence_generator
from adanerf_tpu_torch.data.streaming import (LazyImageStore, StreamingViewCellDataset,
                                              host_memory_budget_bytes, split_fits_in_memory)
from adanerf_tpu_torch.train_state import TrainState

from scene_utils import dense_config_args, make_scene


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene") / "s"), w=24, h=24, n_train=6,
                      with_depth=True)


def _argv(scene, tmp_path, extra=()):
    return dense_config_args(scene, str(tmp_path / "logs")) + list(extra)


def _cfg(scene, tmp_path, extra=()):
    return Config.init(argv=_argv(scene, tmp_path, extra) + ["--device", "cpu"])


def test_lazy_store_matches_jax_and_evicts(scene, tmp_path):
    cfg = _cfg(scene, tmp_path, ["--trainWithGTDepth"])
    info = DatasetInfo(cfg)
    jcfg = JConfig.init(argv=_argv(scene, tmp_path, ["--trainWithGTDepth"]))
    full = jdataset.ViewCellDataset(jcfg, jdataset.DatasetInfo(jcfg), "train", 64)
    frame_bytes = info.w * info.h * 3 * 4
    streaming = StreamingViewCellDataset(cfg, info, "train", 64, max_bytes=3 * frame_bytes * 2)
    assert len(streaming.color_images) == len(full) == 6
    assert streaming.color_images.shape == full.color_images.shape
    assert streaming.color_images.max_items == 3
    for i in range(len(full)):
        np.testing.assert_array_equal(streaming.color_images[i], np.asarray(full.color_images[i]))
        np.testing.assert_allclose(streaming.depth_images[i], np.asarray(full.depth_images[i]),
                                   atol=1e-6)
    assert streaming.color_images.resident == 3 < len(full)
    loads = streaming.color_images.loads
    streaming.color_images[0]  # evicted: decoded again
    assert streaming.color_images.loads == loads + 1
    streaming.color_images[0]  # resident now
    assert streaming.color_images.loads == loads + 1
    stacked = streaming.depth_images[np.array([4, 1])]
    np.testing.assert_allclose(stacked, np.asarray(full.depth_images[np.array([4, 1])]),
                               atol=1e-6)


def test_store_keeps_two_frames_and_refuses_bad_ones():
    store = LazyImageStore(4, (2, 2, 3), lambda i: np.full((2, 2, 3), i, np.float32), 0)
    assert store.max_items == 2 and len(store) == 4 and store.shape == (4, 2, 2, 3)
    assert store[-1][0, 0, 0] == 3 and store.resident == 1
    with pytest.raises(IndexError):
        store[4]
    bad = LazyImageStore(1, (2, 2, 3), lambda i: np.zeros((3, 2, 3), np.float32), 1 << 20)
    with pytest.raises(ValueError, match="expected"):
        bad[0]


@pytest.mark.parametrize("target", ["rgb", "classified_depth"])
def test_train_batches_identical(scene, tmp_path, target):
    """assemble_train_batch gives the same batch from the streaming split,
    the fully loaded split and the JAX package's split, the GT-depth
    samples and a ClassifiedDepth target (built from the stored depth maps)
    included."""
    extra = ["--trainWithGTDepth"]
    argv = _argv(scene, tmp_path, extra)
    if target == "classified_depth":
        argv[argv.index("RawSigmoid")] = "ClassifiedDepth"
        argv[argv.index("NeRFWeightMultiplicationLoss")] = "BCEWithLogitsLoss"
    ts = TrainState()
    ts.initialize(Config.init(argv=argv + ["--device", "cpu"]), log_path=str(tmp_path / "t"))
    cfg = ts.config_file
    full = ViewCellDataset(cfg, ts.dataset_info, "train", cfg.samples)
    frame_bytes = ts.dataset_info.w * ts.dataset_info.h * 3 * 4
    streaming = StreamingViewCellDataset(cfg, ts.dataset_info, "train", cfg.samples,
                                         max_bytes=2 * frame_bytes * 2)
    idx = np.array([1, 4])
    batches = []
    for ds in (full, streaming):
        ts.pixel_idx_sequence_gen = get_sequence_generator(cfg.sampleGenerator, dims=2)
        batches.append(ts.assemble_train_batch(ds, idx))
    jts = JTrainState()
    jts.initialize(JConfig.init(argv=argv))
    jb, jt = jts.assemble_train_batch(jts.train_dataset, idx)
    (b_full, t_full), (b_str, t_str) = batches
    assert sorted(b_full) == sorted(b_str) == sorted(jb)
    assert sorted(t_full) == sorted(t_str) == sorted(jt)
    for k in b_full:
        np.testing.assert_array_equal(b_str[k].numpy(), b_full[k].numpy(), err_msg=str(k))
        np.testing.assert_array_equal(b_str[k].numpy(), np.asarray(jb[k]), err_msg=str(k))
    for k in t_full:
        np.testing.assert_array_equal(t_str[k].numpy(), t_full[k].numpy())
        np.testing.assert_array_equal(t_str[k].numpy(), np.asarray(jt[k]))


def test_split_selection_by_budget(scene, tmp_path, monkeypatch):
    cfg = _cfg(scene, tmp_path)
    info = DatasetInfo(cfg)
    jcfg = JConfig.init(argv=_argv(scene, tmp_path))
    jinfo = jdataset.DatasetInfo(jcfg)
    monkeypatch.setenv("ADANERF_HOST_MEM_BUDGET_MB", "1024")  # fits: fully loaded
    assert host_memory_budget_bytes() == jstreaming.host_memory_budget_bytes() == 1 << 30
    assert split_fits_in_memory(cfg, info, "train")
    assert jstreaming.split_fits_in_memory(jcfg, jinfo, "train")
    assert type(load_dataset_split(cfg, info, "train", 64)) is ViewCellDataset
    monkeypatch.setenv("ADANERF_HOST_MEM_BUDGET_MB", "0.01")  # over budget: streams
    assert not split_fits_in_memory(cfg, info, "train")
    assert not jstreaming.split_fits_in_memory(jcfg, jinfo, "train")
    ds = load_dataset_split(cfg, info, "train", 64)
    assert isinstance(ds, StreamingViewCellDataset)
    assert isinstance(jdataset.load_dataset_split(jcfg, jinfo, "train", 64),
                      jstreaming.StreamingViewCellDataset)
    np.testing.assert_array_equal(ds.color_images[2],
                                  ViewCellDataset(cfg, info, "train", 64).color_images[2])
    # --storeFullData overrides the budget
    cfg2 = _cfg(scene, tmp_path, ["--storeFullData"])
    assert type(load_dataset_split(cfg2, info, "train", 64)) is ViewCellDataset
    # a training run over budget streams every split and still steps
    ts = TrainState()
    ts.initialize(cfg, log_path=str(tmp_path / "t"))
    assert isinstance(ts.train_dataset, StreamingViewCellDataset)
    batch, targets = ts.assemble_train_batch(ts.train_dataset, np.array([0, 5]))
    losses = ts.make_train_step()(batch, targets, 3)
    assert all(np.isfinite(float(v)) for v in losses)
