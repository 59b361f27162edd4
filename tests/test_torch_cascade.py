"""The port's cascade (feature sets, both MLPs, adaptive select, composite)
against the JAX package's on the CPU: JAX's seed-0 parameters carried
across, the same batch of the synthetic scene. It must reproduce the
golden values of tests/test_golden.py (rtol 1e-4, and the exact adaptive
mask sum of 384), match JAX's outputs elementwise in fp32 (atol 1e-5: XLA
and torch sum the products in different orders), name the experiment
directory as JAX does, and refuse what it does not port."""

import numpy as np
import pytest
import torch

import jax

from adanerf_tpu.config import Config as JConfig
from adanerf_tpu.pipeline.keys import FSK
from adanerf_tpu.train_state import TrainState as JTrainState
from adanerf_tpu_torch.config import Config as TConfig
from adanerf_tpu_torch.pipeline.cascade import run_cascade
from adanerf_tpu_torch.pipeline.features import get_feature_sets
from adanerf_tpu_torch.train_state import TrainState as TTrainState
from adanerf_tpu_torch.utils.weights import from_jax_params

from scene_utils import dense_config_args, make_scene

GOLDEN = {0.0: dict(rgb=0.55500060, oracle=1.08444655, wsum=64.615936),
          0.2: dict(rgb=0.54290968, mask=384)}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    scene = make_scene(str(tmp_path_factory.mktemp("scene_casc")))
    out = {}
    for thr in (0.0, 0.2):
        log = str(tmp_path_factory.mktemp(f"logs_casc_{thr}"))
        argv = dense_config_args(scene, log, threshold=thr) + ["--randomSeed", "0"]
        jts, tts = JTrainState(), TTrainState()
        jts.initialize(JConfig.init(argv=argv))
        tts.initialize(TConfig.init(argv=argv + ["--device", "cpu"]), log_path=log + "/t/")
        for m, p in zip(tts.models, jts.params):
            from_jax_params(m, jax.tree.map(np.asarray, p))
        out[thr] = (jts, tts)
    return out


def _probe(jts, tts):
    jb, _ = jts.assemble_train_batch(jts.train_dataset, np.array([0]))
    j_outs, j_dicts = jts.inference(jb)
    tb, _ = tts.assemble_train_batch(tts.train_dataset, np.array([0]))
    with torch.no_grad():
        t_outs, t_dicts = run_cascade(tts.models, tts.f_in, tb, is_inference=True)
    return j_outs, j_dicts, t_outs, t_dicts


@pytest.mark.parametrize("thr", [0.0, 0.2])
def test_cascade_reproduces_golden_and_jax(pairs, thr):
    j_outs, j_dicts, t_outs, t_dicts = _probe(*pairs[thr])
    rgb, oracle = t_outs[1].numpy(), t_outs[0].numpy()
    gold = GOLDEN[thr]
    np.testing.assert_allclose(float(rgb.mean()), gold["rgb"], rtol=1e-4)
    if thr == 0.0:
        np.testing.assert_allclose(float(np.abs(oracle).mean()), gold["oracle"], rtol=1e-4)
        np.testing.assert_allclose(float(t_dicts[1][FSK.nerf_weights_output].sum()),
                                   gold["wsum"], rtol=1e-4)
    else:
        assert int(t_dicts[1][FSK.adaptive_sample_mask].sum()) == gold["mask"]
        np.testing.assert_array_equal(t_dicts[1][FSK.adaptive_sample_mask].numpy(),
                                      np.asarray(j_dicts[1][FSK.adaptive_sample_mask]))
    np.testing.assert_allclose(rgb, np.asarray(j_outs[1]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(oracle, np.asarray(j_outs[0]), rtol=0, atol=1e-5)
    for key in (FSK.nerf_weights_output, FSK.nerf_alpha_output, FSK.input_feature_batch,
                FSK.nerf_input_feature_z_vals, FSK.nerf_estimated_depth):
        a, b = t_dicts[1][key].numpy(), np.asarray(j_dicts[1][key])
        assert a.shape == b.shape, key
        np.testing.assert_allclose(np.where(np.isfinite(b), a, 0), np.where(np.isfinite(b), b, 0),
                                   rtol=0, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(t_dicts[0][FSK.input_feature_batch].numpy(),
                               np.asarray(j_dicts[0][FSK.input_feature_batch]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("thr", [0.0, 0.2])
def test_experiment_name_matches_jax(pairs, thr):
    jts, tts = pairs[thr]
    assert tts.experiment_name == jts.experiment_name
    assert [m.name for m in tts.models] == [d.name for d in jts.model_defs]
    assert [f.get_string() for f in tts.f_in] == [f.get_string() for f in jts.f_in]


@pytest.mark.parametrize("flag,value,what", [
    ("--rayMarchSampler", "LinearlySpacedZNearZFar", "sampler"),
    ("--inFeatures", "CamPosDir", "feature set"),
    ("--outFeatures", "ClassifiedDepth", "feature set"),
])
def test_unported_feature_sets_and_samplers_raise(pairs, flag, value, what):
    jts, tts = pairs[0.0]
    c = TConfig.init(argv=dense_config_args("unused", "unused") + ["--device", "cpu"])
    getattr(c, flag[2:])[-1 if flag == "--rayMarchSampler" else 0] = value
    with pytest.raises(NotImplementedError, match=f"{what} {value} is not ported yet"):
        get_feature_sets(c, tts.scene)


def test_sphere_pos_dir_with_ray_sample_input_matches_jax(pairs):
    """The oracle input with raySampleInput extra samples along the ray."""
    from adanerf_tpu.pipeline.features import SpherePosDir as JSpherePosDir
    from adanerf_tpu_torch.pipeline.features import SpherePosDir as TSpherePosDir
    jts, tts = pairs[0.0]
    for ts in (jts, tts):
        ts.config_file.raySampleInput = [3, 0]
    try:
        jf = JSpherePosDir(config=jts.config_file, net_idx=0, scene=jts.scene)
        tf = TSpherePosDir(config=tts.config_file, net_idx=0, scene=tts.scene)
        jb, _ = jts.assemble_train_batch(jts.train_dataset, np.array([1]))
        tb, _ = tts.assemble_train_batch(tts.train_dataset, np.array([1]))
        assert tf.n_feat == jf.n_feat and tf.abbr == jf.abbr
        np.testing.assert_allclose(tf.batch(tb)[FSK.input_feature_batch].numpy(),
                                   np.asarray(jf.batch(jb)[FSK.input_feature_batch]),
                                   rtol=0, atol=1e-5)
    finally:
        for ts in (jts, tts):
            ts.config_file.raySampleInput = [0, 0]


def test_perturb_jitters_between_midpoints():
    """--perturb: the port draws from its own seeded generator (JAX's keys
    give other numbers), so the test holds the stratification itself:
    every sample stays between its neighbours' midpoints, and one seed
    gives one draw."""
    from adanerf_tpu_torch.ops.samplers import linearly_spaced_z, perturb_z
    z = linearly_spaced_z(6, 0.0, 1.0, 16)
    a = perturb_z(z, torch.Generator().manual_seed(3))
    b = perturb_z(z, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, z)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    lower = torch.cat([z[:, :1], mids], dim=1)
    upper = torch.cat([mids, z[:, -1:]], dim=1)
    assert bool(((a >= lower) & (a <= upper)).all())
