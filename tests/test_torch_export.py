"""The port's export (``adanerf_tpu_torch/export.py``) against the JAX
package's, on the CPU, at the full widths of ``tests/test_export_viewer.py``
(8x256 nets, 10-4 encodings, 128 oracle bins):

* on the same fp32 weights, ``dataset_info.txt``, ``pos_enc.txt``,
  ``config.ini`` and both ``model{i}.onnx`` files hold the same bytes as
  the JAX export, and the ``model{i}.weights`` arrays are equal. Both runs
  share one log directory, so both exports copy the one echoed
  ``config.ini``; the port's own echo differs from JAX's only in its
  ``logDir`` and ``device`` lines (a device name, where JAX has an index);
* the port's viewer on the port's export renders within 1e-5 of the port's
  live renderer (the bar of ``tests/test_export_viewer.py``), and each
  package's viewer renders the other's export within 1e-5 of the other;
* the same for an NDC export with the "None" normalization;
* the ``export`` evaluation writes the same directory;
* ``python -m adanerf_tpu_torch.export`` on a port run exports its
  ``_opt`` checkpoints."""

import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from adanerf_tpu.config import Config as JConfig
from adanerf_tpu.export import export_artifacts as j_export
from adanerf_tpu.train_state import TrainState as JTrainState
from adanerf_tpu_torch import export as t_export_mod
from adanerf_tpu_torch import train as t_train
from adanerf_tpu_torch import viewer as tviewer
from adanerf_tpu_torch.config import Config as TConfig
from adanerf_tpu_torch.evaluation.evaluate import evaluate as t_evaluate
from adanerf_tpu_torch.realtime import RealtimeRenderer
from adanerf_tpu_torch.train_state import TrainState as TTrainState, load_tree
from adanerf_tpu_torch.utils.weights import from_jax_params, to_flat

from scene_utils import dense_config_args, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import viewer as jviewer  # noqa: E402  (the JAX package's root viewer)

TEXT_AND_ONNX = ["dataset_info.txt", "pos_enc.txt", "config.ini", "model0.onnx", "model1.onnx"]
ATOL = 1e-5  # tests/test_export_viewer.py's bar between an export and its live renderer


def _full_width_args(scene, log):
    args = dense_config_args(scene, log, threshold=0.2)
    args = [a if a != "4-2" else "10-4" for a in args]
    for i, a in enumerate(args):
        if a == "--layerWidth":
            args[i + 1] = "256"
        if a == "--multiDepthFeatures":
            args[i + 1] = "128"
        if a == "--rayMarchSamplingStep":
            args[i + 1] = "0.0078125"
        if a == "--layers":
            args[i + 1] = "8"
    return args


def _ndc_args(scene, log):
    args = dense_config_args(scene, log, threshold=0.2)
    args[args.index("FromClassifiedDepthAdaptive")] = "FromClassifiedDepthAdaptiveNoDepthRange"
    k = args.index("InverseSqrtDistCentered")
    args[args.index("InverseSqrtDistCentered", k + 1)] = "None"
    args[args.index("log")] = "linear"
    return args + ["--useNDC"]


def _both_exports(args):
    """The JAX package's export and the port's of the same weights: the JAX
    state initializes first (writing the run's config echo), the port's
    takes its parameters. Returns (jax ts, port ts, jax dir, port dir)."""
    jts = JTrainState()
    jts.initialize(JConfig.init(argv=args))
    tts = TTrainState()
    tts.initialize(TConfig.init(argv=args + ["--device", "cpu"]))
    assert tts.logDir == jts.logDir
    for m, p in zip(tts.models, jts.params):
        from_jax_params(m, jax.tree.map(np.asarray, p))
    j_dir = j_export(jts, os.path.join(jts.logDir, "exported_model_jax"), aot=False)
    t_dir = t_export_mod.export_artifacts(tts, os.path.join(tts.logDir, "exported_model"))
    return jts, tts, j_dir, t_dir


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    scene = make_scene(str(tmp_path_factory.mktemp("scene_texp")))
    log = str(tmp_path_factory.mktemp("logs_texp"))
    return _both_exports(_full_width_args(scene, log))


@pytest.fixture(scope="module")
def exported_ndc(tmp_path_factory):
    scene = make_scene(str(tmp_path_factory.mktemp("scene_texp_ndc")))
    log = str(tmp_path_factory.mktemp("logs_texp_ndc"))
    return _both_exports(_ndc_args(scene, log))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", TEXT_AND_ONNX)
def test_export_files_byte_equal_to_jax(exported, name):
    _, _, j_dir, t_dir = exported
    assert _read(os.path.join(t_dir, name)) == _read(os.path.join(j_dir, name))


@pytest.mark.parametrize("i", [0, 1])
def test_export_weights_equal_jax(exported, i):
    _, tts, j_dir, t_dir = exported
    got = load_tree(os.path.join(t_dir, f"model{i}.weights"))
    want = load_tree(os.path.join(j_dir, f"model{i}.weights"))
    assert set(got) == set(want) == set(to_flat(tts.models[i]))
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])


def test_export_writes_no_xla_executable(exported, capsys):
    _, tts, _, t_dir = exported
    assert sorted(os.listdir(t_dir)) == sorted(TEXT_AND_ONNX + ["model0.weights",
                                                                "model1.weights"])
    t_export_mod.export_artifacts(tts, t_dir)
    assert "AOT export skipped: stage0_oracle.xla" in capsys.readouterr().out


def _frame_inputs(ts, n=128):
    ds = ts.test_dataset
    return ds.directions[:n], ds.poses[0], ds.rotations[0]


def _port_live_and_export(tts, t_dir):
    rt_exp, _ = tviewer.build_renderer_from_export(t_dir, batch_size=128, dtype_str="fp32",
                                                   device="cpu")
    rt_live = RealtimeRenderer(tts.models[0], tts.models[1], tts.scene, tts.config_file,
                               batch_size=128, dtype=None, device="cpu")
    return rt_exp, rt_live


def test_port_viewer_on_port_export_matches_live_renderer(exported):
    _, tts, _, t_dir = exported
    rt_exp, rt_live = _port_live_and_export(tts, t_dir)
    for a, b in ((rt_exp.oracle, tts.models[0]), (rt_exp.nerf, tts.models[1])):
        fa, fb = to_flat(a), to_flat(b)
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
    assert rt_exp.scene.depth_max == tts.scene.depth_max
    dirs, pose, rot = _frame_inputs(tts)
    d = torch.from_numpy(dirs)
    img_exp, cnt_exp = rt_exp.render_frame(pose, rot, d)
    img_live, cnt_live = rt_live.render_frame(pose, rot, d)
    torch.testing.assert_close(img_exp, img_live, atol=ATOL, rtol=0)
    assert torch.equal(cnt_exp, cnt_live)


def test_each_viewer_loads_the_other_packages_export(exported):
    jts, tts, j_dir, t_dir = exported
    dirs, pose, rot = _frame_inputs(tts)
    # the JAX viewer on the port's export, the port's viewer on JAX's
    j_rt, _ = jviewer.build_renderer_from_export(t_dir, batch_size=128, dtype_str="fp32")
    t_rt, _ = tviewer.build_renderer_from_export(j_dir, batch_size=128, dtype_str="fp32",
                                                 device="cpu")
    j_img = j_rt.render_frame(pose, rot, dirs)
    t_img, _ = t_rt.render_frame(pose, rot, torch.from_numpy(dirs))
    np.testing.assert_allclose(t_img.numpy(), j_img, atol=ATOL, rtol=0)
    # and each package's viewer on its own export agrees with the other's
    j_own, _ = jviewer.build_renderer_from_export(j_dir, batch_size=128, dtype_str="fp32")
    np.testing.assert_allclose(j_own.render_frame(pose, rot, dirs), j_img, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", TEXT_AND_ONNX)
def test_ndc_none_normalization_export_byte_equal_to_jax(exported_ndc, name):
    _, _, j_dir, t_dir = exported_ndc
    assert _read(os.path.join(t_dir, name)) == _read(os.path.join(j_dir, name))


def test_ndc_none_normalization_export_renders_as_live(exported_ndc):
    """A stored ``rayMarchNormalization = [..., None]`` reconstructs the
    explicit "None" (identity) normalization, and the NDC export renders as
    the live renderer and as the JAX viewer on the same export."""
    _, tts, _, t_dir = exported_ndc
    rt_exp, rt_live = _port_live_and_export(tts, t_dir)
    assert rt_exp.use_ndc and rt_exp.z_no_range and rt_exp.norm_name == "None"
    dirs, pose, rot = _frame_inputs(tts)
    img_exp, _ = rt_exp.render_frame(pose, rot, torch.from_numpy(dirs))
    img_live, _ = rt_live.render_frame(pose, rot, torch.from_numpy(dirs))
    torch.testing.assert_close(img_exp, img_live, atol=ATOL, rtol=0)
    j_rt, _ = jviewer.build_renderer_from_export(t_dir, batch_size=128, dtype_str="fp32")
    np.testing.assert_allclose(img_exp.numpy(), j_rt.render_frame(pose, rot, dirs), atol=ATOL,
                               rtol=0)


def test_export_evaluation_writes_the_export(exported, tmp_path):
    _, tts, _, t_dir = exported
    tts.outDir = str(tmp_path)
    try:
        assert t_evaluate(tts, None, ["export"]) is None
    finally:
        del tts.outDir
    out = tmp_path / "exported_model"
    assert sorted(os.listdir(out)) == sorted(os.listdir(t_dir))
    for name in TEXT_AND_ONNX + ["model0.weights", "model1.weights"]:
        if name.endswith(".weights"):
            a, b = load_tree(str(out / name)), load_tree(os.path.join(t_dir, name))
            assert all(np.array_equal(a[k], b[k]) for k in b) and set(a) == set(b)
        else:
            assert _read(str(out / name)) == _read(os.path.join(t_dir, name))


def test_export_cli_on_a_port_run(tmp_path):
    """``python -m adanerf_tpu_torch.export`` with the run's own arguments
    loads the run's ``_opt`` checkpoints (the default ``--checkPointName``)
    and writes every file."""
    scene = make_scene(str(tmp_path / "scene"))
    # the camera path of the video a new best validation renders
    shutil.copyfile(os.path.join(scene, "transforms_val.json"),
                    os.path.join(scene, "cam_path_pan.json"))
    args = dense_config_args(scene, str(tmp_path / "logs"), samples=32, epochs=4) + [
        "--device", "cpu", "--randomSeed", "0", "--epochsValidate", "3",
        "--lossBlendingStart", "100", "--epochsRender", "100", "--epochsVideo", "100",
        "--epochsCheckpoint", "100", "--no-performEvaluation"]
    stats = t_train.main(args)
    run = stats["state"].logDir
    out = t_export_mod.main(args)
    assert out == os.path.join(run, "exported_model")
    assert sorted(os.listdir(out)) == sorted(TEXT_AND_ONNX + ["model0.weights",
                                                              "model1.weights"])
    for i, m in enumerate(stats["state"].models):
        want = load_tree(os.path.join(run, f"{m.name}__opt.weights"))
        got = load_tree(os.path.join(out, f"model{i}.weights"))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert _read(os.path.join(out, "config.ini")) == _read(os.path.join(run, "config.ini"))
    rt, _ = tviewer.build_renderer_from_export(out, dtype_str="fp32", device="cpu")
    assert rt.max_samples == 16 and abs(rt.threshold - 0.0) < 1e-12
