"""The repo's other two configurations through the port against the JAX
package on the CPU, fp32, scaled down (4 x 32 nets, encodings 4-2, a
24 x 24 synthetic scene with depth), the JAX package's seed-0 parameters
carried across (``utils/weights.py``):

* ``adanerf_tpu_torch/configs/nerf_baseline.ini`` (a coarse NeRF on
  linearly spaced samples, a fine NeRF through ``RayMarchFromCoarse``) and
  ``gt_depth_training.ini`` (the ``ClassifiedDepth`` oracle on the GT
  depth, the NeRF through ``FromClassifiedDepth``): the experiment
  names, the cascade's outputs and dicts (atol 1e-5, the bar of
  ``tests/test_torch_cascade.py``), a train step's losses (rtol 1e-5) and
  gradient leaves (1e-4 of the leaf's max, as ``tests/test_torch_train_
  step.py``), with ``--perturb`` off and ``--deterministicSampling`` on,
  since the two packages draw other random numbers;
* one GT pretraining step (``make_pretrain_step``): the pretrained net's
  parameters within 1e-6, the other net untouched;
* the GT-depth ini's NeRF samples in training: they follow the oracle's
  depth, as at inference and as JAX's (atol 1e-5); and the two faults that
  the ini's options keep out of its path, shared with the JAX package
  (ROADMAP Queue 3, F6 and F7);
* ``CamPosDir``'s batch (atol 1e-5), every sampler's part of the
  experiment name;
* the sample-placement (``--samplePlacementDir``) and exported-NeRF depth
  (``--useNerfDepthMap``) paths, as ``tests/test_sample_placement.py``
  drives them in JAX: the same batches and depth maps as the JAX
  package's, and a finite step."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adanerf_tpu.config import Config as JConfig
from adanerf_tpu.data.dataset import DatasetInfo as JDatasetInfo
from adanerf_tpu.pipeline.features import get_feature_sets as j_feature_sets
from adanerf_tpu.pipeline.keys import FSK, DatasetKeys
from adanerf_tpu.train_state import TrainState as JTrainState
from adanerf_tpu.utils.sample_placement_tracker import SamplePlacementTracker
from adanerf_tpu_torch.config import Config as TConfig
from adanerf_tpu_torch.data.dataset import DatasetInfo as TDatasetInfo
from adanerf_tpu_torch.pipeline.cascade import run_cascade
from adanerf_tpu_torch.pipeline.features import SAMPLERS
from adanerf_tpu_torch.pipeline.features import get_feature_sets as t_feature_sets
from adanerf_tpu_torch.train_state import TrainState as TTrainState
from adanerf_tpu_torch.utils.weights import flatten_params, from_jax_params, to_flat

from scene_utils import dense_config_args, make_scene
from test_torch_train_step import _jax_loss_and_grads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INI = {name: os.path.join(ROOT, "adanerf_tpu_torch", "configs", f"{name}.ini")
       for name in ("nerf_baseline", "gt_depth_training")}
SMALL = ["--layers", "4", "--layers", "4", "--layerWidth", "32", "--layerWidth", "32",
         "--posEncArgs", "4-2", "--posEncArgs", "4-2", "--samples", "48", "--randomSeed", "0",
         "--inferenceChunkSize", "256"]
SCALED = {"nerf_baseline": ["--numRaymarchSamples", "16", "--numRaymarchSamples", "32"],
          "gt_depth_training": ["--numRaymarchSamples", "16", "--numRaymarchSamples", "8",
                                "--multiDepthFeatures", "16", "--multiDepthFeatures", "16",
                                "--epochsPretrain", "4", "--epochsPretrain", "-1"]}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene_bgt")), with_depth=True)


def scaled_args(name, scene, log):
    return ["-c", INI[name], "-data", scene, "-log", log] + SMALL + SCALED[name]


def _pair(argv, log, **overrides):
    """Both packages' TrainState on argv, the port's from JAX's parameters;
    ``overrides`` are set on both configs before the feature sets read
    them (the JAX CLI cannot turn an ini's store_true flag off)."""
    jc, tc = JConfig.init(argv=argv), TConfig.init(argv=argv + ["--device", "cpu"])
    for c in (jc, tc):
        for k, v in overrides.items():
            setattr(c, k, v)
    jts, tts = JTrainState(), TTrainState()
    jts.initialize(jc)
    tts.initialize(tc, log_path=os.path.join(log, "t/"))
    for m, p in zip(tts.models, jts.params):
        from_jax_params(m, jax.tree.map(np.asarray, p))
    return jts, tts


@pytest.fixture(scope="module")
def pairs(scene, tmp_path_factory):
    log = str(tmp_path_factory.mktemp("logs_bgt"))
    return {name: _pair(scaled_args(name, scene, log), log, perturb=False,
                        deterministicSampling=True) for name in INI}


@pytest.mark.parametrize("name", list(INI))
def test_ini_names_match_jax(scene, tmp_path, name):
    """The experiment directory of each ini as shipped (full widths) and
    scaled down."""
    for argv in (["-c", INI[name], "-data", scene, "-log", str(tmp_path)],
                 scaled_args(name, scene, str(tmp_path))):
        jc, tc = JConfig.init(argv=argv), TConfig.init(argv=argv + ["--device", "cpu"])
        jf = j_feature_sets(jc, JDatasetInfo(jc).scene_static())
        tf = t_feature_sets(tc, TDatasetInfo(tc).scene_static())
        for a, b in zip(jf, tf):
            assert [f.get_string() for f in a] == [f.get_string() for f in b]
            assert [f.n_feat for f in a] == [f.n_feat for f in b]


@pytest.mark.parametrize("name", list(INI))
def test_experiment_name_matches_jax(pairs, name):
    jts, tts = pairs[name]
    assert tts.experiment_name == jts.experiment_name
    assert [m.name for m in tts.models] == [d.name for d in jts.model_defs]


@pytest.mark.parametrize("name", list(INI))
def test_cascade_matches_jax(pairs, name):
    jts, tts = pairs[name]
    jb, _ = jts.assemble_train_batch(jts.train_dataset, np.array([2]))
    j_outs, j_dicts = jts.inference(jb)
    tb, _ = tts.assemble_train_batch(tts.train_dataset, np.array([2]))
    t_outs, t_dicts = tts.inference(tb)
    for i in range(2):
        np.testing.assert_allclose(t_outs[i].numpy(), np.asarray(j_outs[i]), rtol=0, atol=1e-5)
        for key in (FSK.input_feature_batch, FSK.nerf_input_feature_z_vals,
                    FSK.nerf_weights_output, FSK.nerf_alpha_output, FSK.nerf_estimated_depth):
            if key in j_dicts[i]:
                a, b = t_dicts[i][key].numpy(), np.asarray(j_dicts[i][key])
                assert a.shape == b.shape, (i, key)
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=f"{i} {key}")
    if name == "nerf_baseline":  # 16 coarse + 32 fine samples, sorted
        z = t_dicts[1][FSK.nerf_input_feature_z_vals]
        assert z.shape[1] == 48 and bool((z[:, 1:] >= z[:, :-1]).all())


@pytest.mark.parametrize("name,epoch", [("nerf_baseline", 1), ("nerf_baseline", 9),
                                        ("gt_depth_training", 5)])
def test_train_step_matches_jax(pairs, name, epoch):
    jts, tts = pairs[name]
    idx = np.array([0, 3])
    jb, jt = jts.assemble_train_batch(jts.train_dataset, idx)
    tb, tt = tts.assemble_train_batch(tts.train_dataset, idx)
    j_losses, j_grads = _jax_loss_and_grads(jts, jb, jt, jnp.asarray(epoch))
    t_losses, t_grads = tts.make_loss_and_grads()(tb, tt, epoch)
    assert all(v > 0 for v in j_losses)  # both nets train in both configurations
    np.testing.assert_allclose([float(v) for v in t_losses], j_losses, rtol=1e-5, atol=1e-8)
    for i, (jg, tg) in enumerate(zip(j_grads, t_grads)):
        assert set(jg) == set(tg)
        for k, ref in jg.items():
            rel = float(np.abs(tg[k].numpy() - ref).max()) / (float(np.abs(ref).max()) + 1e-20)
            assert rel <= 1e-4, (i, k, rel)


def test_pretrain_step_matches_jax(pairs):
    """One GT pretraining step of the oracle from the same parameters and
    batch: the oracle's parameters within 1e-6 of JAX's, the NeRF's
    untouched on both sides."""
    jts, tts = pairs["gt_depth_training"]
    before = [{k: v.copy() for k, v in to_flat(m).items()} for m in tts.models]
    jb, jt = jts.assemble_train_batch(jts.train_dataset, np.array([1, 2]))
    tb, tt = tts.assemble_train_batch(tts.train_dataset, np.array([1, 2]))
    params, opts = jax.tree.map(jnp.copy, jts.params), jax.tree.map(jnp.copy, jts.opt_states)
    j_params, _ = jts.make_pretrain_step(0)(params, opts, jb, jt, jnp.asarray(1), jnp.asarray(0),
                                             jax.random.PRNGKey(1))
    loss = tts.make_pretrain_step(0)(tb, tt, 1, 0)
    try:
        assert bool(torch.isfinite(loss)) and float(loss) > 0
        for i, m in enumerate(tts.models):
            want = flatten_params(jax.tree.map(np.asarray, j_params[i]))
            for k, v in to_flat(m).items():
                np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-6, err_msg=f"{i} {k}")
        assert any(not np.array_equal(v, before[0][k]) for k, v in to_flat(tts.models[0]).items())
        assert all(np.array_equal(v, before[1][k]) for k, v in to_flat(tts.models[1]).items())
        assert tts.opt_states[0].count == 1 and tts.opt_states[1].count == 0
    finally:  # later tests of the module start from JAX's parameters again
        for m, p in zip(tts.models, jts.params):
            from_jax_params(m, jax.tree.map(np.asarray, p))
        tts.opt_states[0].count = 0


def _nerf_z(ts, batch, logits, is_inference):
    """The NeRF stage's z_vals for ``batch`` when the oracle gave ``logits``
    (the cascade's first stage, its network output replaced)."""
    if isinstance(ts, JTrainState):
        d0 = ts.f_in[0].batch(batch, is_inference=is_inference)
        d0[FSK.postprocessed_network_output] = jnp.asarray(logits)
        d1 = ts.f_in[1].batch(batch, prev_outs=[d0], is_inference=is_inference)
        return np.asarray(d1[FSK.nerf_input_feature_z_vals])
    d0 = ts.f_in[0].batch(batch, is_inference=is_inference)
    d0[FSK.postprocessed_network_output] = torch.from_numpy(logits)
    d1 = ts.f_in[1].batch(batch, prev_outs=[d0], is_inference=is_inference)
    return d1[FSK.nerf_input_feature_z_vals].numpy()


def _gt_batches(pairs):
    """One batch of both packages for the GT-depth ini (the same pixels),
    the port's on the CPU, with the batch images' depth maps, a second
    map whose depths are moved by half the range, and the pixel picks."""
    jts, tts = pairs["gt_depth_training"]
    idx = np.array([0, 3])
    jb, _ = jts.assemble_train_batch(jts.train_dataset, idx)
    hb, _, pixels = tts.assemble_host_batch(tts.train_dataset, idx)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in hb.items()}
    depth = tts.train_dataset.depth_images[idx, :, :, 0]
    moved = np.where(depth < 1.0, (depth + 0.5) % 1.0, depth).astype(np.float32)
    return jts, tts, jb, tb, depth, moved, pixels


def test_gt_ini_nerf_samples_follow_the_depth(pairs):
    """``gt_depth_training.ini`` as shipped: the NeRF's training samples come
    from the oracle's bins, as at inference, so they follow the depth the
    oracle learned. The oracle's output stands in for one trained on a
    depth map: its logits are the map's ``ClassifiedDepth`` target scaled
    to +-8. Moving the map's depths moves every training sample of a ray
    whose depth moved; the training samples equal the inference ones and
    the JAX package's (atol 1e-5)."""
    jts, tts, jb, tb, depth, moved, pixels = _gt_batches(pairs)
    assert not tts.f_in[1].train_with_gt_depth and tts.f_in[1].deterministic_sampling
    target = tts.f_out[0]
    z = {}
    for name, maps in (("depth", depth), ("moved", moved)):
        logits = torch.cat([target.features_from_depth(torch.from_numpy(m), torch.from_numpy(p))
                            for m, p in zip(maps, pixels)]).numpy() * 16.0 - 8.0
        z[name] = _nerf_z(tts, tb, logits, is_inference=False)
        np.testing.assert_array_equal(z[name], _nerf_z(tts, tb, logits, is_inference=True))
        np.testing.assert_allclose(z[name], _nerf_z(jts, jb, logits, is_inference=False),
                                   rtol=0, atol=1e-5)
        assert z[name].shape == (96, 8) and float(z[name].std(0).min()) > 1e-3
    ray_depth = np.stack([m.reshape(-1)[p] for m, p in zip(depth, pixels)]).reshape(-1)
    shifted = ray_depth < 1.0
    assert shifted.sum() > 48
    assert (np.abs(z["depth"] - z["moved"]).max(1)[shifted] > 1e-3).all()


def test_gt_depth_flag_gives_samples_that_ignore_the_depth(pairs):
    """ROADMAP Queue 3, F6, in both packages: with ``--trainWithGTDepth``,
    ``FromClassifiedDepth`` gets the (rays, 1) GT depth in training, a
    one-bin pdf. Every ray's training samples are the same fixed
    quantiles, whatever its depth; which is why the shipped ini leaves the
    flag off."""
    jts, tts, jb, tb, depth, moved, pixels = _gt_batches(pairs)
    logits = np.zeros((96, 16), np.float32)
    try:
        for f in (jts.f_in[1], tts.f_in[1]):
            f.train_with_gt_depth = True
        seen = []
        for maps in (depth, moved):
            gt = np.stack([m.reshape(-1)[p] for m, p in zip(maps, pixels)]).reshape(-1, 1)
            tb[DatasetKeys.depth_image_samples] = torch.from_numpy(gt)
            jb[DatasetKeys.depth_image_samples] = jnp.asarray(gt)
            seen += [_nerf_z(tts, tb, logits, False), _nerf_z(jts, jb, logits, False)]
    finally:
        for f in (jts.f_in[1], tts.f_in[1]):
            f.train_with_gt_depth = False
    for z in seen:
        np.testing.assert_allclose(z, np.broadcast_to(seen[0][0], z.shape), rtol=0, atol=1e-5)


def test_random_classified_depth_draws_come_out_unsorted(scene):
    """ROADMAP Queue 3, F7, in both packages: ``FromClassifiedDepth`` with
    random draws (``deterministicSampling`` off) returns each ray's samples
    in the order of its uniforms, not sorted; the composite then takes
    negative distances. The shipped ini samples at fixed quantiles."""
    from adanerf_tpu.ops import samplers as JS
    from adanerf_tpu_torch.ops import samplers as TS
    from adanerf_tpu_torch.ops.depth_transforms import LogTransform
    from adanerf_tpu.ops.depth_transforms import LogTransform as JLogTransform
    probs = np.random.default_rng(5).uniform(0.0, 1.0, (64, 16)).astype(np.float32)
    zt = TS.from_classified_depth(torch.from_numpy(probs), 8, (1.0, 8.0), LogTransform,
                                  det=False, generator=torch.Generator().manual_seed(0)).numpy()
    zj = np.asarray(JS.from_classified_depth(jnp.asarray(probs), 8, (1.0, 8.0), JLogTransform,
                                             det=False, key=jax.random.PRNGKey(0)))
    for z in (zt, zj):
        assert z.shape == (64, 8) and (np.diff(z, axis=1) < 0).any(axis=1).mean() > 0.9


@pytest.mark.parametrize("ray_samples", [0, 3])
def test_cam_pos_dir_batch_matches_jax(scene, tmp_path, ray_samples):
    argv = dense_config_args(scene, str(tmp_path)) + ["--randomSeed", "0"]
    argv[argv.index("SpherePosDir")] = "CamPosDir"
    argv[argv.index("--raySampleInput") + 1] = str(ray_samples)
    jts, tts = _pair(argv, str(tmp_path))
    assert tts.experiment_name == jts.experiment_name and "CaPoDi" in tts.experiment_name
    jb, _ = jts.assemble_train_batch(jts.train_dataset, np.array([1]))
    tb, _ = tts.assemble_train_batch(tts.train_dataset, np.array([1]))
    jd, td = jts.f_in[0].batch(jb), tts.f_in[0].batch(tb)
    assert tts.f_in[0].n_feat == jts.f_in[0].n_feat
    for key in (FSK.input_feature_batch, FSK.input_feature_ray_origins,
                FSK.input_feature_ray_directions):
        np.testing.assert_allclose(td[key].numpy(), np.asarray(jd[key]), rtol=0, atol=1e-5)
    j_outs, _ = jts.inference(jb)
    t_outs, _ = tts.inference(tb)
    np.testing.assert_allclose(t_outs[1].numpy(), np.asarray(j_outs[1]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("noise", ["0.0", "0.25"])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_sampler_names_match_jax(scene, sampler, noise):
    argv = dense_config_args(scene, "unused") + ["--rayMarchSamplingNoise", "0.0",
                                                 "--rayMarchSamplingNoise", noise]
    argv[argv.index("FromClassifiedDepthAdaptive")] = sampler
    jc, tc = JConfig.init(argv=argv), TConfig.init(argv=argv + ["--device", "cpu"])
    jf = j_feature_sets(jc, JDatasetInfo(jc).scene_static())[0][1]
    tf = t_feature_sets(tc, TDatasetInfo(tc).scene_static())[0][1]
    assert tf.get_string() == jf.get_string() and tf.adaptive == jf.adaptive


def _placement(tmp_path, scene, n_samples=16):
    sp_dir = tmp_path / "placement"
    for split, n in (("train", 4), ("val", 1)):
        tracker = SamplePlacementTracker(n, 24, 24, max_sample_count=128)
        tracker.set_16_samples_test()
        os.makedirs(sp_dir / split)
        tracker.save(str(sp_dir / split / f"{n_samples}.ckpt.npy"))
    argv = dense_config_args(scene, str(tmp_path / "logs")) + [
        "--randomSeed", "0", "--samplePlacementDir", str(sp_dir)]
    argv[argv.index("FromClassifiedDepthAdaptive")] = "FromIterativeSamplePlacement"
    argv[argv.index("--multiDepthFeatures") + 1] = "128"
    argv[argv.index("--multiDepthFeatures", argv.index("--multiDepthFeatures") + 1) + 1] = "128"
    # the One / Zero oracle components and no premultiply: 16 placed samples
    # against 128 bins, as tests/test_sample_placement.py sets them
    at = argv.index("NerfA")
    del argv[at - 1:at + 1]
    at = [i for i, a in enumerate(argv) if a == "--lossComponentBlending"][-1]
    del argv[at:at + 2]
    argv[argv.index("--accumulationMult") + 1] = "none"
    return argv


def test_sample_placement_path_matches_jax(scene, tmp_path):
    jts, tts = _pair(_placement(tmp_path, scene), str(tmp_path))
    tracker = tts.train_dataset.sample_placement_tracker
    assert tracker is not None and tracker.get_unpacked_image(0).sum(-1).max() == 16
    jb, jt = jts.assemble_train_batch(jts.train_dataset, np.array([0, 1]))
    tb, tt = tts.assemble_train_batch(tts.train_dataset, np.array([0, 1]))
    sp = tb[DatasetKeys.sample_placement]
    assert sp.shape == (128, 128) and bool((sp.sum(1) == 16).all())
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jb[DatasetKeys.sample_placement]))
    j_outs, j_dicts = jts.inference(jb)
    t_outs, t_dicts = tts.inference(tb)
    np.testing.assert_allclose(t_dicts[1][FSK.nerf_input_feature_z_vals].numpy(),
                               np.asarray(j_dicts[1][FSK.nerf_input_feature_z_vals]), atol=1e-5)
    np.testing.assert_allclose(t_outs[1].numpy(), np.asarray(j_outs[1]), rtol=0, atol=1e-5)
    before = [{k: v.copy() for k, v in to_flat(m).items()} for m in tts.models]
    losses = tts.make_train_step()(tb, tt, 3)
    assert np.isfinite([float(v) for v in losses]).all()
    # parameters moved (as in the JAX test: JAX's seed-0 NeRF gives no
    # density at these samples, so its own gradients vanish here)
    assert any(not np.array_equal(v, before[i][k]) for i, m in enumerate(tts.models)
               for k, v in to_flat(m).items())


def test_sample_placement_without_a_checkpoint_is_all_active(scene, tmp_path):
    argv = _placement(tmp_path, scene)
    argv[argv.index("--samplePlacementDir") + 1] = str(tmp_path / "nonexistent")
    tts = TTrainState()
    tts.initialize(TConfig.init(argv=argv + ["--device", "cpu"]), log_path=str(tmp_path / "t"))
    assert tts.train_dataset.sample_placement_tracker.get_unpacked_image(0).all()


def test_nerf_depth_map_matches_jax(scene, tmp_path):
    """--useNerfDepthMap: a frame's depth comes from an exported NeRF run's
    ``*_QuantizedWeights_lo_nSD.raw`` (a torch container) where it has one,
    else from its ``_depth.npz``; the same maps as the JAX package's."""
    rng = np.random.default_rng(3)
    for i in (0, 2):  # frames 1 and 3 keep their GT depth
        torch.save({"OutputDepthMap": torch.from_numpy(rng.uniform(1.5, 7.5, (24, 24)).astype(
                        np.float32)),
                    "InputDepthRange": torch.tensor([1.0, 8.0])},
                   os.path.join(scene, "train", f"{i:04d}_QuantizedWeights_lo_nSD.raw"))
    try:
        argv = dense_config_args(scene, str(tmp_path / "logs")) + ["--useNerfDepthMap",
                                                                   "--randomSeed", "0"]
        jts, tts = _pair(argv, str(tmp_path))
        assert tts.experiment_name == jts.experiment_name and "noGT_" in tts.experiment_name
        np.testing.assert_allclose(tts.train_dataset.depth_images,
                                   jts.train_dataset.depth_images, rtol=0, atol=1e-6)
        gt = TTrainState()
        gt.initialize(TConfig.init(argv=dense_config_args(scene, str(tmp_path / "logs")) + [
            "--trainWithGTDepth", "--device", "cpu"]), log_path=str(tmp_path / "gt"))
        d, d_gt = tts.train_dataset.depth_images, gt.train_dataset.depth_images
        assert not np.allclose(d[0], d_gt[0]) and np.array_equal(d[1], d_gt[1])
    finally:
        for i in (0, 2):
            os.remove(os.path.join(scene, "train", f"{i:04d}_QuantizedWeights_lo_nSD.raw"))
