"""The port's ``videos`` evaluation and its area resize against the JAX
package's and OpenCV, on the CPU:

* ``utils/resize.py::resize_area`` against ``cv2.resize(..., INTER_AREA)``
  on float32 images: bit for bit at integer downscales (2x, 4x, 2x by 4x;
  1, 3 and 4 channels), where the port sums in float32 in OpenCV's order;
  within 1e-6 at non-integer ones (400->300, 37->16), an upscale (16->37)
  and one axis up and one down, where OpenCV sums in float32 and the port
  in float64 with OpenCV's float32 weights;
* the ``videos`` leg against JAX's ``generate_video_data`` on a
  ``make_scene`` scene with a ``cam_path.json`` and a seeded
  ``reference_video/`` at another resolution (so the area resize runs),
  on the same weights: per-frame PSNR within 1e-4 dB, IW-SSIM and FLIP
  within 1e-5; the report rows alike in format (the numbers aside, which
  are held to those bars); the diff and square-diff frames equal pixel for
  pixel but where a float rounding puts a value on the other side of a
  level (at most 1 level, on at most 1% of the values); through both
  packages' ``evaluate``, the same files;
* a JPEG reference frame, and the JPEG images of an LLFF scene, read as
  the JAX package reads them (ROADMAP item 19, done); a progressive one
  is refused by name (item 21)."""

import json
import os
import re

import cv2
import imageio.v2 as imageio
import jax
import numpy as np
import pytest

from adanerf_tpu.config import Config as JConfig
from adanerf_tpu.train_state import TrainState as JTrainState
from adanerf_tpu_torch.config import Config as TConfig
from adanerf_tpu_torch.data.llff import load_llff_data
from adanerf_tpu_torch.data.png import read_png
from adanerf_tpu_torch.evaluation import evaluate as t_eval
from adanerf_tpu_torch.train_state import TrainState as TTrainState
from adanerf_tpu_torch.utils.resize import resize_area
from adanerf_tpu_torch.utils.weights import from_jax_params

import importlib

from adanerf_tpu.data import llff as j_llff
from scene_utils import dense_config_args, make_scene
from test_llff import make_llff_scene
from torch_jpeg_fixtures import encode, seeded_image

j_eval = importlib.import_module("adanerf_tpu.evaluation.evaluate")

# (image shape, (width, height) out, bit for bit)
RESIZES = [((64, 48, 3), (24, 32), True), ((64, 48, 3), (12, 16), True),
           ((64, 48), (24, 32), True), ((62, 90), (45, 31), True),
           ((64, 48, 4), (24, 32), True), ((64, 48, 3), (24, 16), True),
           ((400, 400, 3), (300, 300), False), ((37, 37, 3), (16, 16), False),
           ((16, 16, 3), (37, 37), False), ((20, 30, 3), (41, 13), False),
           ((33, 50, 4), (20, 20), False), ((30, 17), (10, 51), False)]


@pytest.mark.parametrize("shape,size,exact", RESIZES,
                         ids=[f"{s[0]}x{s[1]}x{s[2] if len(s) > 2 else 1}-{d[1]}x{d[0]}"
                              for s, d, _ in RESIZES])
def test_resize_area_matches_cv2(shape, size, exact):
    img = np.random.default_rng(shape[0] * size[0]).random(shape).astype(np.float32)
    want = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
    got = resize_area(img, *size)
    assert got.shape == want.shape and got.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


REF_W, REF_H = 40, 31  # the reference video's frames; the scene renders 24x24
EVALS = ["videos", "psnr", "ssim", "flip"]


@pytest.fixture(scope="module")
def video_states(tmp_path_factory):
    """The scene, then the JAX and the port's states on the same weights."""
    scene = make_scene(str(tmp_path_factory.mktemp("scene_videos")), n_test=3)
    with open(os.path.join(scene, "transforms_test.json")) as f:
        frames = json.load(f)["frames"]
    with open(os.path.join(scene, "cam_path.json"), "w") as f:
        json.dump({"frames": frames}, f)
    os.makedirs(os.path.join(scene, "reference_video"))
    rng = np.random.default_rng(7)
    for i in range(len(frames)):
        imageio.imwrite(os.path.join(scene, "reference_video", f"{i:04d}.png"),
                        rng.integers(0, 256, (REF_H, REF_W, 3), dtype=np.uint8))
    log = str(tmp_path_factory.mktemp("logs_videos"))
    args = dense_config_args(scene, log, threshold=0.2)
    jts = JTrainState()
    jts.initialize(JConfig.init(argv=args), training=False)
    tts = TTrainState()
    tts.initialize(TConfig.init(argv=args + ["--device", "cpu"]), training=False)
    for m, p in zip(tts.models, jts.params):
        from_jax_params(m, jax.tree.map(np.asarray, p))
    return scene, jts, tts


@pytest.fixture(scope="module")
def video_data(video_states, tmp_path_factory):
    scene, jts, tts = video_states
    j_out = str(tmp_path_factory.mktemp("videos_jax"))
    t_out = str(tmp_path_factory.mktemp("videos_port"))
    j_frames = j_eval.load_reference_video(scene)
    t_frames = t_eval.load_reference_video(scene)
    jq = j_eval.generate_video_data(jts, EVALS, j_frames, out_dir=j_out)
    tq = t_eval.generate_video_data(tts, EVALS, t_frames, out_dir=t_out)
    return jq, tq, j_out, t_out, j_frames, t_frames


def test_reference_frames_read_as_jax_reads_them(video_data):
    *_, j_frames, t_frames = video_data
    assert len(t_frames) == len(j_frames) == 3
    for a, b in zip(t_frames, j_frames):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("metric,tol", [("mse", 1e-6), ("psnr", 1e-4), ("ssim", 1e-5),
                                        ("flip", 1e-5)])
def test_video_metrics_match_jax(video_data, metric, tol):
    jq, tq = video_data[:2]
    got, want = getattr(tq, metric), getattr(jq, metric)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("key", ["diff_data", "square_diff_data"])
def test_video_diff_frames_match_jax(video_data, key):
    """The frames are ``(x * 255).astype(uint8)`` of each side's own float
    render: equal but where a value lies within a rounding of a level."""
    jq, tq = video_data[:2]
    for a, b in zip(getattr(tq, key), getattr(jq, key)):
        assert a.shape == b.shape == (24, 24, 3) and a.dtype == b.dtype == np.uint8
        d = np.abs(a.astype(np.int16) - b)
        n_off = int((d > 0).sum())
        print(f"{key}: {n_off} of {d.size} values one level apart")
        assert d.max() <= 1 and n_off <= d.size // 100


def test_video_flip_frames_match_jax(video_data):
    """FLIP frames are the magma colours of each side's FLIP map: a map
    value near an entry boundary of the 256-entry table may pick the
    neighbouring colour (the maps agree within 1e-5)."""
    jq, tq = video_data[:2]
    for a, b in zip(tq.flip_data, jq.flip_data):
        assert a.shape == b.shape == (24, 24, 3) and a.dtype == b.dtype == np.uint8
        off = np.any(a != b, axis=-1)
        print(f"flip frames: {int(off.sum())} of {off.size} pixels differ")
        assert int(np.abs(a.astype(np.int16) - b).max()) <= 8 and off.sum() <= off.size // 100


NUM = re.compile(r"-?\d+(\.\d+)?(e-?\d+)?|nan|inf")


@pytest.mark.parametrize("name", ["image_quality_video.txt", "image_quality_video.csv"])
def test_video_reports_match_jax_in_format(video_data, name):
    j_out, t_out = video_data[2:4]
    with open(os.path.join(t_out, name), newline="") as f:
        got = f.read()
    with open(os.path.join(j_out, name), newline="") as f:
        want = f.read()
    assert NUM.sub("#", got) == NUM.sub("#", want)
    assert got.count("\r") == want.count("\r") == (3 if name.endswith("txt") else 4)
    for a, b in zip(NUM.finditer(got), NUM.finditer(want)):
        assert abs(float(a.group(0)) - float(b.group(0))) <= 1e-4


@pytest.mark.parametrize("seq", ["_diff", "_square_diff", "_flip"])
def test_video_frame_sequences_written(video_data, seq):
    """The port writes each sequence as PNG frames, as the JAX package does
    when it cannot encode a video; the frames read back as the data."""
    jq, tq, _, t_out = video_data[:4]
    frames = sorted(os.listdir(os.path.join(t_out, seq + "_frames")))
    assert frames == [f"{i:05d}.png" for i in range(3)]
    key = {"_diff": "diff_data", "_square_diff": "square_diff_data", "_flip": "flip_data"}[seq]
    for f, want in zip(frames, getattr(tq, key)):
        np.testing.assert_array_equal(read_png(os.path.join(t_out, seq + "_frames", f)), want)


def test_videos_evaluation_through_evaluate_matches_jax(video_states, tmp_path):
    """Both packages' ``evaluate`` with the videos evaluation read the
    scene's reference_video/ themselves and write the same files."""
    _, jts, tts = video_states
    names = {}
    for ts, ev, out in ((jts, j_eval, tmp_path / "j"), (tts, t_eval, tmp_path / "t")):
        out.mkdir()
        ts.outDir = str(out)
        try:
            ev.evaluate(ts, None, EVALS)
        finally:
            del ts.outDir
        names[ev] = sorted(os.listdir(out))
    assert names[t_eval] == names[j_eval]
    assert {"image_quality_video.txt", "image_quality_video.csv", "_diff_frames",
            "_square_diff_frames", "_flip_frames"} <= set(names[t_eval])


def _progressive(img):
    from PIL import Image
    import io
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", progressive=True)
    return buf.getvalue()


def test_jpeg_reference_frame_is_refused(tmp_path):
    """A baseline JPEG reference frame beside a PNG one reads as the JAX
    package reads it (imageio); a progressive one, which the port does not
    decode, is refused by name (ROADMAP item 21; item 19 is done)."""
    ref = tmp_path / "reference_video"
    ref.mkdir()
    imageio.imwrite(str(ref / "0000.png"), np.zeros((4, 4, 3), np.uint8))
    (ref / "0001.jpg").write_bytes(encode(seeded_image(31, 40, 3, seed=9), quality=90,
                                          subsampling=2))
    got, want = t_eval.load_reference_video(str(tmp_path)), j_eval.load_reference_video(
        str(tmp_path))
    assert len(got) == len(want) == 2 and got[1].shape == (31, 40, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    (ref / "0002.jpg").write_bytes(_progressive(seeded_image(8, 8, 3)))
    with pytest.raises(ValueError, match="0002.jpg.*progressive.*item 21"):
        t_eval.load_reference_video(str(tmp_path))
    assert t_eval.load_reference_video(str(tmp_path / "nowhere")) is None


def test_jpeg_llff_images_are_refused(tmp_path):
    """An LLFF capture whose images are JPEG (named .JPG, as cameras name
    them) loads as the JAX package loads it; a progressive image is refused
    by name (ROADMAP item 21; item 19 is done)."""
    d = make_llff_scene(str(tmp_path / "scene"))
    for f in sorted(os.listdir(os.path.join(d, "images"))):
        img = imageio.imread(os.path.join(d, "images", f))
        os.remove(os.path.join(d, "images", f))
        (tmp_path / "scene" / "images" / f.replace(".png", ".JPG")).write_bytes(
            encode(img, quality=95, subsampling=2))
    for factor in (None, 2):
        got, want = load_llff_data(d, factor=factor), j_llff.load_llff_data(d, factor=factor)
        assert got[0].shape == want[0].shape
        assert float(np.abs(got[0] - want[0]).max()) <= 1 / 255
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
    (tmp_path / "scene" / "images" / "000.JPG").write_bytes(
        _progressive(seeded_image(32, 40, 3)))
    with pytest.raises(ValueError, match="000.JPG.*progressive.*item 21"):
        load_llff_data(d, factor=None)
