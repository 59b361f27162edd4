"""The callers of the port that read images as the JAX package reads them
through imageio (``data/llff.py``, ``eval_megakernel.py``, the videos
evaluation), on the arrays of the new PNG formats (and a greyscale JPEG)
against their JAX counterparts: the JAX package's results where it gives
one, nonsense included (ROADMAP Queue 3, F13: JAX's, kept), and a
ValueError naming the file and its format where the JAX line fails."""

import glob
import importlib
import os
import warnings

import numpy as np
import pytest

import imageio.v2 as imageio

from adanerf_tpu.data import llff as j_llff
from adanerf_tpu_torch.data import llff as t_llff
from adanerf_tpu_torch.data.png import read_image, read_png, require_broadcast

import png_format_writer as pw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSCENE = os.path.join(ROOT, "demo", "mscene")


def _llff_scene(tmp_path, images, n=4):
    """demo/llff_scene's first ``n`` images and poses, each image written
    by ``images``."""
    d = tmp_path / "llff"
    (d / "images").mkdir(parents=True)
    poses = np.load(os.path.join(ROOT, "demo", "llff_scene", "poses_bounds.npy"))
    np.save(d / "poses_bounds.npy", poses[:n])
    src = sorted(glob.glob(os.path.join(ROOT, "demo", "llff_scene", "images", "*.png")))[:n]
    for i, path in enumerate(src):
        (d / "images" / f"{i:04d}.png").write_bytes(images(read_png(path)[..., :3]))
    return str(d)


def _grey(rgb):
    return rgb.mean(-1).astype(np.uint8)


# greyscale forms of demo/llff_scene's images: what the JAX LLFF loader
# makes of each (F13: nonsense, kept)
LLFF_FORMS = {
    "grey8": lambda x: pw.encode(_grey(x), 0, 8),
    "grey16": lambda x: pw.encode(_grey(x).astype(np.uint16) * 257, 0, 16),
    "grey1": lambda x: pw.encode(_grey(x) > 128, 0, 1),
    "grey_alpha": lambda x: pw.encode(np.stack([_grey(x), _grey(x)], -1), 4, 8),
    "rgb16_adam7": lambda x: pw.encode(x.astype(np.uint16) * 257, 2, 16, interlace=1),
    "palette": lambda x: pw.encode(x[..., 0] // 4, 3, 8,
                                   palette=np.stack([np.arange(64) * 4] * 3, -1)),
}


@pytest.mark.parametrize("form", sorted(LLFF_FORMS))
@pytest.mark.parametrize("factor", [1, 2])
def test_llff_loader_gives_the_jax_arrays(tmp_path, form, factor):
    d = _llff_scene(tmp_path, LLFF_FORMS[form])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_llff.load_llff_data(d, factor=factor)
    got = t_llff.load_llff_data(d, factor=factor)
    assert got[0].shape == want[0].shape and got[0].dtype == want[0].dtype
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=0 if factor == 1 else 1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    if form in ("grey8", "grey16", "grey1"):  # F13: the first three columns of each image
        assert got[0].shape == (4, 240 // factor, 3)


def test_llff_images_of_two_shapes_raise_naming_the_file(tmp_path):
    d = _llff_scene(tmp_path, lambda x: pw.encode(x, 2, 8))
    grey = os.path.join(d, "images", "0005.png")
    with open(grey, "wb") as f:
        f.write(pw.encode(np.zeros((240, 320), np.uint8), 0, 8))
    with pytest.raises(ValueError):
        j_llff.load_llff_data(d, factor=1)
    with pytest.raises(ValueError, match="8-bit greyscale PNG") as err:
        t_llff.load_llff_data(d, factor=1)
    assert grey in str(err.value)


@pytest.mark.parametrize("form,raises", [("grey8", False), ("grey16", False),
                                         ("grey_alpha", True), ("rgb16_adam7", False)])
def test_eval_megakernel_ground_truth_as_the_jax_tool(tmp_path, form, raises):
    """The JAX tool reads its ground truth as ``imread(...)[..., :3] / 255``
    and takes ``psnr(frame, gt)``: on a square greyscale image that
    broadcasts its first three columns (F13), on greyscale+alpha it fails;
    the port computes the same numbers, or raises naming the file."""
    from adanerf_tpu_torch import eval_megakernel as em
    rgb = read_png(sorted(glob.glob(os.path.join(MSCENE, "test", "*.png")))[0])[..., :3]
    path = tmp_path / "gt.png"
    path.write_bytes(LLFF_FORMS[form](rgb))
    frame = np.random.default_rng(0).random((400, 400, 3)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_gt = imageio.imread(str(path)).astype(np.float32)[..., :3] / 255.0
    _, gt = em.ground_truth(str(tmp_path), {"file_path": "./gt"})
    np.testing.assert_array_equal(gt, jax_gt)
    if raises:
        with pytest.raises(ValueError):
            em.psnr(frame, jax_gt)
        with pytest.raises(ValueError, match="8-bit greyscale\\+alpha PNG") as err:
            require_broadcast(frame, gt, str(path), "the JAX tool's psnr")
        assert str(path) in str(err.value)
    else:
        require_broadcast(frame, gt, str(path), "the JAX tool's psnr")
        mse = float(np.mean((frame - jax_gt) ** 2))  # tools/eval_megakernel.py's psnr
        assert em.psnr(frame, gt) == 10.0 * np.log10(1.0 / max(mse, 1e-12))


@pytest.fixture(scope="module")
def video_states(tmp_path_factory):
    from test_torch_videos import video_states as states
    return states.__wrapped__(tmp_path_factory)


@pytest.mark.parametrize("form", ["grey8", "grey_alpha", "grey_jpeg", "rgb16_adam7"])
def test_videos_evaluation_on_a_new_format_as_jax(video_states, tmp_path, form):
    """A reference frame in a new format through the videos evaluation: the
    JAX package's numbers where it computes them, a ValueError naming the
    file and its format where ``test - ref`` fails in JAX."""
    from adanerf_tpu_torch.evaluation import evaluate as t_eval
    from torch_jpeg_fixtures import encode
    j_eval = importlib.import_module("adanerf_tpu.evaluation.evaluate")
    scene, jts, tts = video_states
    rgb = np.random.default_rng(3).integers(0, 256, (31, 40, 3), dtype=np.uint8)
    path = str(tmp_path / ("frame.jpg" if form == "grey_jpeg" else "frame.png"))
    with open(path, "wb") as f:
        f.write(encode(_grey(rgb), quality=90) if form == "grey_jpeg" else LLFF_FORMS[form](rgb))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_frames = [imageio.imread(path)]
    t_frames = [read_image(path)]
    np.testing.assert_array_equal(t_frames[0], j_frames[0])
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    if form == "rgb16_adam7":
        jq = j_eval.generate_video_data(jts, ["videos", "psnr"], j_frames, out_dir=str(tmp_path / "j"))
        tq = t_eval.generate_video_data(tts, ["videos", "psnr"], t_frames, out_dir=str(tmp_path / "t"),
                                        files=[path])
        np.testing.assert_allclose(tq.psnr, jq.psnr, rtol=0, atol=1e-4)
        return
    with pytest.raises(ValueError):
        j_eval.generate_video_data(jts, ["videos"], j_frames, out_dir=str(tmp_path / "j"))
    with pytest.raises(ValueError, match="cannot be compared") as err:
        t_eval.generate_video_data(tts, ["videos"], t_frames, out_dir=str(tmp_path / "t"),
                                   files=[path])
    assert path in str(err.value) and ("greyscale" in str(err.value)
                                       or "1-component JPEG" in str(err.value))
