"""The port's evaluation against the JAX package's on the CPU:

* FLIP (torch, float32) against the jnp FLIP on seeded images: the mean
  within 1e-6 and every pixel of the map within 1e-5;
* IW-SSIM without OpenCV against the JAX package's with OpenCV: within
  1e-6 on a seeded 96x96 pair and on a 400x400 test image of demo/mscene,
  and the two OpenCV stand-ins (``filter2d``, ``_resize_linear``) against
  cv2 itself;
* the metrics, the parameter census (``network_description.txt``), a
  JPEG reference video frame read as the JAX package reads it (ROADMAP item
  19, done) and the refusal of a progressive one (item 21), before any run
  is loaded;
* re-hydrating the committed JAX run (``load_config``), which loads its
  ``_opt`` checkpoints through ``load_specific_weights("opt")``;
* the comparison tool's CSV and XML against the JAX package's on the same
  reports;
* (slow) the whole test split of that run evaluated by both packages: per
  image PSNR within 0.01 dB, FLIP within 1e-4, samples/px within 1e-4;
  and the JAX package's numbers within a tenth of those bars of
  ``tests/torch_fixtures/eval_mscene_fine02.json``, which ``chip_smoke.py``
  holds the card's evaluation to. No run rewrites that file, unless
  ADANERF_WRITE_EVAL_FIXTURE=1 asks it to."""

import importlib
import importlib.util
import json
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

# the package's __init__ binds the names evaluate and iw_ssim to functions
j_eval = importlib.import_module("adanerf_tpu.evaluation.evaluate")
j_flip = importlib.import_module("adanerf_tpu.evaluation.flip")
j_iw = importlib.import_module("adanerf_tpu.evaluation.iw_ssim")
j_metrics = importlib.import_module("adanerf_tpu.evaluation.metrics")
from adanerf_tpu_torch import comparison as t_comparison
from adanerf_tpu_torch import evaluate as t_evaluate_cli
from adanerf_tpu_torch.data.png import read_png
from adanerf_tpu_torch.evaluation import evaluate as t_eval
from adanerf_tpu_torch.evaluation import flip as t_flip
from adanerf_tpu_torch.evaluation import iw_ssim as t_iw
from adanerf_tpu_torch.evaluation import metrics as t_metrics
from adanerf_tpu_torch.utils.weights import to_flat

from torch_jpeg_fixtures import encode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "demo", "mscene")
RUN = os.path.join(
    ROOT, "demo", "mlogs", "mscene",
    "lo_SpPoDi(nerf(10-4))-relu0(256x8)-S-128_RayMarchFromPoses_nSD[8_LSfCDA_(0.2)_128_0.0]_"
    "acc_alpha(nerf(10-4))-NeRF1(256x8[4])-RGBARayMarch_[0.025_1.0]_[10k_30k]_O_Z_N")
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "eval_mscene_fine02.json")
# how far the JAX package's CPU evaluation may move from the committed
# fixture: a tenth of the bars chip_smoke.py holds the card's evaluation to
# it (samples/px: one ray of an image's 160,000 may keep another bin)
FIXTURE_BARS = {"psnr": 1e-3, "flip": 1e-5, "samples": 1e-5, "ssim": 1e-5}


def _pair(seed, h, w, noise):
    rng = np.random.default_rng(seed)
    a = rng.random((h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed,h,w,noise", [(0, 64, 80, 0.05), (1, 48, 48, 0.3),
                                            (2, 96, 72, 0.01)])
def test_flip_matches_jax(seed, h, w, noise):
    ref, test = _pair(seed, h, w, noise)
    want = np.asarray(j_flip.flip_error_map(ref, test))
    got = t_flip.flip_error_map(ref, test).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert abs(float(got.mean()) - float(want.mean())) <= 1e-6
    assert float(np.abs(got - want).max()) <= 1e-5


def test_flip_leaves_tf32_settings_as_it_found_them():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    t_flip.flip_error_map(*_pair(3, 16, 16, 0.1))
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before


@pytest.mark.parametrize("size", [(23, 31), (5, 7), (50, 50), (100, 64)])
def test_resize_linear_matches_cv2(size):
    m, n = size
    img = np.random.default_rng(m * n).random((m, n))
    want = cv2.resize(img, (4 * n - 3, 4 * m - 3), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(t_iw._resize_linear(img, 4 * m - 3, 4 * n - 3), want,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("border,cv_border", [("reflect101", cv2.BORDER_REFLECT_101),
                                              ("constant", cv2.BORDER_CONSTANT)])
@pytest.mark.parametrize("k", [3, 5, 11])
def test_filter2d_matches_cv2(border, cv_border, k):
    rng = np.random.default_rng(k)
    img, kernel = rng.random((37, 29)) * 255, rng.random((k, k))
    want = cv2.filter2D(img, -1, kernel, borderType=cv_border)
    np.testing.assert_allclose(t_iw.filter2d(img, kernel, border), want, rtol=0, atol=1e-9)


def test_iw_ssim_matches_jax_on_seeded_96():
    rng = np.random.default_rng(0)
    o = rng.random((96, 96)) * 255
    d = np.clip(o + rng.normal(0, 10, o.shape), 0, 255)
    assert abs(t_iw.iw_ssim(o, d) - j_iw.iw_ssim(o, d)) <= 1e-6


def test_iw_ssim_matches_jax_on_a_400x400_test_image():
    img = read_png(os.path.join(DATA, "test", "0000.png"))[..., :3].astype(np.float64) / 255
    rng = np.random.default_rng(1)
    noisy = np.clip(img + rng.normal(0, 0.03, img.shape), 0, 1)
    o, d = t_iw.rgb_to_gray255(img), t_iw.rgb_to_gray255(noisy)
    assert o.shape == (400, 400)
    assert abs(t_iw.iw_ssim(o, d) - j_iw.iw_ssim(o, d)) <= 1e-6


def test_metrics_are_the_jax_packages():
    a, b = _pair(4, 20, 30, 0.1)
    assert t_metrics.mse(a, b) == j_metrics.mse(a, b)
    assert t_metrics.psnr(a, b) == j_metrics.psnr(a, b)
    assert t_metrics.psnr(a, a) == float("inf")


@pytest.mark.parametrize("evals,item", [(["videos"], "item 19"),
                                        (["images", "videos"], "item 19")])
def test_unported_evaluations_are_refused(evals, item, tmp_path):
    """A JPEG reference video, refused until ``item`` was done, decodes as
    the JAX package reads it; what the port still cannot decode, a
    progressive frame, is refused by name (item 21, not ``item``), by the
    CLI before anything is loaded or written."""
    scene = tmp_path / "scene"
    shutil.copytree(DATA, scene, ignore=shutil.ignore_patterns("train", "*_depth.npz"))
    (scene / "reference_video").mkdir()
    frame = read_png(os.path.join(DATA, "test", "0000.png"))[..., :3]
    (scene / "reference_video" / "0000.jpg").write_bytes(encode(frame, quality=90,
                                                                subsampling=2))
    got = t_eval.load_reference_video(str(scene))
    want = j_eval.load_reference_video(str(scene))
    assert len(got) == len(want) == 1 and got[0].shape == frame.shape
    np.testing.assert_array_equal(got[0], want[0])
    from PIL import Image
    Image.fromarray(frame).save(str(scene / "reference_video" / "0001.jpg"), "JPEG",
                                progressive=True)
    with pytest.raises(ValueError, match="progressive.*item 21") as err:
        t_eval.load_reference_video(str(scene))
    assert item not in str(err.value)
    out = tmp_path / "out"
    out.mkdir()
    with pytest.raises(SystemExit, match="progressive.*item 21"):
        t_evaluate_cli.main(["-data", str(scene), "-log", RUN, "--outDir", str(out),
                             "--device", "cpu"] + [a for e in evals for a in ("--evaluations", e)])
    assert not os.listdir(out)  # refused before anything ran


def _load_both(out_dir):
    status_t, tts = t_eval.load_config(DATA, "cpu", RUN, [], [], cl_out_dir=str(out_dir / "t"),
                                       skip_if_already_done_once=False)
    status_j, jts = j_eval.load_config(DATA, 0, RUN, [], [], cl_out_dir=str(out_dir / "j"),
                                       skip_if_already_done_once=False)
    assert status_t == status_j == 0
    return tts, jts


def test_load_config_loads_the_opt_checkpoints(tmp_path):
    tts, jts = _load_both(tmp_path)
    assert tts.test_dataset is not None and tts.train_dataset is None
    assert tts.test_dataset.directions.shape == (400 * 400, 3)
    assert tts.outDir == os.path.join(str(tmp_path / "t"), "mscene", os.path.basename(RUN))
    for m in tts.models:
        with np.load(os.path.join(RUN, f"{m.name}__opt.weights")) as f:
            want = {k: f[k] for k in f.files}
        got = to_flat(m)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_network_description_matches_jax(tmp_path):
    tts, jts = _load_both(tmp_path)
    t_eval.get_network_size(tts, str(tmp_path / "t"))
    j_eval.get_network_size(jts, str(tmp_path / "j"))
    with open(tmp_path / "t" / "network_description.txt") as f:
        got = f.read()
    with open(tmp_path / "j" / "network_description.txt") as f:
        assert got == f.read()
    with open(os.path.join(RUN, "network_description.txt")) as f:
        assert got == f.read()


def test_an_evaluated_epoch_is_skipped_without_force(tmp_path):
    out = tmp_path / "mscene" / os.path.basename(RUN) / "eval"
    out.mkdir(parents=True)
    shutil.copy(os.path.join(RUN, "opt.txt"), out / "opt.txt")
    status, ts = t_eval.load_config(DATA, "cpu", RUN, [], [], cl_out_dir=str(tmp_path))
    assert (status, ts) == (2, None)
    assert t_eval.get_optimal_epoch(RUN) == "20000"


def test_evaluate_cli_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_evaluate_cli.main(["-data", DATA, "-log", RUN, "--outDir", str(tmp_path)])


def _jax_comparison():
    spec = importlib.util.spec_from_file_location("jax_root_comparison",
                                                  os.path.join(ROOT, "comparison.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_comparison_matches_jax(tmp_path):
    for name in os.listdir(os.path.dirname(RUN)):
        src, dst = os.path.join(os.path.dirname(RUN), name), tmp_path / name
        dst.mkdir()
        for f in ("network_description.txt", "complexity.txt", "opt.txt",
                  "image_quality_images.csv"):
            if os.path.exists(os.path.join(src, f)):
                shutil.copy(os.path.join(src, f), dst / f)
    results = t_comparison.main(["-d", str(tmp_path)])
    assert len(results) == 3
    jc = _jax_comparison()
    paths = [str(tmp_path / s) for s in sorted(os.listdir(tmp_path)) if (tmp_path / s).is_dir()]
    j_results = [r for r in (jc.ExperimentResults(p) for p in paths) if r.completed]
    with open(tmp_path / "comparison.csv", newline="") as f:
        assert f.read() == "".join(jc.csv_lines(j_results))
    assert "".join(t_comparison.xml_lines(results)) == "".join(jc.xml_lines(j_results))


@pytest.mark.slow
def test_whole_test_split_matches_jax_and_the_fixture(tmp_path):
    """The committed run's six test images through both packages' whole
    evaluation (complexity, images, flip, psnr, ssim, output_images) on
    the CPU in fp32. The JAX package's numbers are written to tmp_path and
    held to the committed fixture at FIXTURE_BARS; with
    ADANERF_WRITE_EVAL_FIXTURE=1 they replace the fixture instead."""
    evals = ["complexity", "images", "flip", "psnr", "ssim", "output_images"]
    tts, jts = _load_both(tmp_path)
    qt = t_eval.evaluate(tts, None, list(evals))
    qj = j_eval.evaluate(jts, None, list(evals))
    n = len(jts.test_dataset)
    assert len(qt.psnr) == len(qj.psnr) == n == 6
    for i in range(n):
        assert abs(qt.psnr[i] - qj.psnr[i]) <= 0.01, i
        assert abs(qt.flip[i] - qj.flip[i]) <= 1e-4, i
        assert abs(qt.samples[i] - qj.samples[i]) <= 1e-4, i
        assert abs(qt.ssim[i] - qj.ssim[i]) <= 1e-4, i
    t_dir, j_dir = tmp_path / "t" / "mscene" / os.path.basename(RUN), \
        tmp_path / "j" / "mscene" / os.path.basename(RUN)
    names = lambda d: sorted(f.split("_")[0] + "_" + f.split("_")[1] if "_" in f else f
                             for f in os.listdir(d / "eval"))
    assert names(t_dir) == names(j_dir)
    fixture = {"source": "the JAX package's evaluation (adanerf_tpu/evaluation/evaluate.py) "
                         "of the committed fine run (S=8, threshold 0.2, fp32) on the CPU, "
                         "written by tests/test_torch_evaluation.py",
               "run": os.path.relpath(RUN, ROOT),
               "images": [{"mse": qj.mse[i], "psnr": qj.psnr[i], "ssim": qj.ssim[i],
                           "flip": qj.flip[i], "samples": qj.samples[i]} for i in range(n)]}
    written = tmp_path / "eval_mscene_fine02.json"
    with open(written, "w") as f:
        json.dump(fixture, f, indent=1)
        f.write("\n")
    if os.environ.get("ADANERF_WRITE_EVAL_FIXTURE") == "1":
        os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
        shutil.copy(written, FIXTURE)
        return
    with open(FIXTURE) as f:
        committed = json.load(f)
    assert committed["run"] == fixture["run"]
    assert len(committed["images"]) == n
    for i, (got, want) in enumerate(zip(fixture["images"], committed["images"])):
        for key, bar in FIXTURE_BARS.items():
            assert abs(got[key] - want[key]) <= bar, (i, key, got[key], want[key])
