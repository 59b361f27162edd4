"""Quantitative evaluation: MSE, PSNR, IW-SSIM and FLIP of the test split
and of a camera path against a reference video, the analytic complexity
scaled by the measured adaptive sample counts, the diff and FLIP images,
the CSV and TXT reports, the export, and re-hydrating a run from its
experiment directory.

Counterpart of ``adanerf_tpu/evaluation/evaluate.py``, writing the same
files under the same names: ``complexity.txt``, ``network_description.txt``,
``image_quality_images.{txt,csv}`` and ``image_quality_video.{txt,csv}``
(``\\r`` line ends), ``eval/{i}_out.png``, ``eval/{i}_diff_*.png``,
``eval/{i}_square_diff_*.png``, ``eval/{i}_flip_*.png``, ``eval/opt.txt``
and ``exported_model/``. Rendering runs the plain cascade on the run's
device, FLIP runs there too, IW-SSIM on the host.

The ``videos`` evaluation reads ``<scene>/reference_video/*.{png,jpg}``
with the port's PNG and JPEG decoders (``data/png.py::read_image``) and
resizes a frame of another size with
``utils/resize.py::resize_area`` (OpenCV's ``INTER_AREA``). Its diff,
square-diff and FLIP frame sequences are written as
``{_diff,_square_diff,_flip}_frames/%05d.png``, what the JAX package writes
when it has no video encoder. A JPEG frame in a format that imageio
refuses too (hierarchical, arithmetic-coded lossless, 12-bit: ROADMAP
Queue 1, item 23) is refused by name, and so is a frame that the JAX
package cannot subtract from its render either (a greyscale or
greyscale+alpha image).
"""

from __future__ import annotations

import os
import re
from shutil import copyfile

import numpy as np

from ..data.camera import PredefinedCamera
from ..data.png import check_image, read_image, require_broadcast, write_png
from ..pipeline.keys import FSK
from ..render import render_rays_chunked, render_video
from ..utils import colormaps
from ..utils.resize import resize_area
from ..utils.saveimage import Dim, save_img
from .flip import flip_error_map
from .iw_ssim import iw_ssim, rgb_to_gray255
from .metrics import mse as mse_fn, psnr as psnr_fn

DEFAULT_EVALUATIONS = ["complexity", "images", "flip", "psnr", "ssim", "output_images"]


class QualityContainer:
    """Per-image metric accumulators."""

    def __init__(self):
        self.flip = []
        self.mse = []
        self.psnr = []
        self.ssim = []
        self.samples = []
        self.sparsity = []
        self.diff_data = []
        self.square_diff_data = []
        self.flip_data = []


def _jax_key_order(key: str):
    """Sort key of a flat parameter name in the JAX package's pytree order:
    dict keys as strings, list indices as numbers."""
    return tuple(int(p) if p.isdigit() else p for p in key.split("."))


def get_network_size(ts, out_dir):
    """Parameter census -> network_description.txt."""
    total = 0
    lines = []
    for m in ts.models:
        params = dict(m.named_parameters())
        for key in sorted(params, key=_jax_key_order):
            shape = tuple(params[key].shape)
            n = int(np.prod(shape))
            name = f"{m.name}.{key}"
            if len(shape) > 1:
                lines.append(f"{n} = {'x'.join(str(x) for x in shape)} ({name})")
            else:
                lines.append(f"{n} ({name})")
            total += n
    lines.insert(0, f"{total} total params")
    with open(os.path.join(out_dir, "network_description.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def complexity_samples(ts):
    """Per net, the samples a pixel at which ``complexity.txt`` counts its
    MACs on a non-adaptive run, as the JAX package does (the first net
    once, every other at ``numRaymarchSamples[-1]``), and the samples it
    shades: one for an oracle, its own ``numRaymarchSamples`` for a
    ``RayMarchFromPoses`` net, the coarse net's and its own for a
    ``RayMarchFromCoarse`` one. The two differ for the NeRF baseline
    (ROADMAP Queue 3, F8)."""
    n = ts.config_file.numRaymarchSamples
    counted = [1] + [n[-1]] * (len(ts.models) - 1)
    shaded = []
    for i, f in enumerate(ts.f_in):
        kind = type(f).__name__
        shaded.append(n[i - 1] + n[i] if kind == "RayMarchFromCoarse"
                      else n[i] if kind == "RayMarchFromPoses" else 1)
    return counted, shaded


def generate_data(ts, flags, out_dir=None):
    """Test-split render, metrics and complexity."""
    out_dir = out_dir or getattr(ts, 'outDir', ts.logDir)
    os.makedirs(os.path.join(out_dir, "eval"), exist_ok=True)
    dataset = ts.test_dataset
    h, w = ts.h, ts.w
    chunk = ts.config_file.inferenceChunkSize
    dim = Dim(h, w)

    count_flops = "complexity" in flags
    image_macs = []
    image_macs_pp = []
    q = QualityContainer()

    for i in range(len(dataset)):
        collect = [FSK.adaptive_sample_positions, FSK.oracle_weights]
        imgs, extras = render_rays_chunked(ts, dataset.poses[i], dataset.rotations[i], chunk,
                                           collect=collect)
        test = np.clip(imgs[-1][:, :3], 0.0, 1.0)
        reference = dataset.color_images[i].reshape(-1, 3)

        # the measured average adaptive sample count scales the shading net's MACs
        samples = float(ts.config_file.numRaymarchSamples[-1])
        if FSK.adaptive_sample_positions in extras:
            frac = float(np.sum(extras[FSK.adaptive_sample_positions]))
            if frac > 0:
                samples = frac / (h * w) * ts.config_file.numRaymarchSamples[-1]
                q.samples.append(samples)

        if count_flops:
            total_macs = 0.0
            for k, m in enumerate(ts.models):
                macs = m.macs_per_input()
                total_macs += macs if k == 0 else macs * samples
            image_macs.append(total_macs * w * h)
            image_macs_pp.append(total_macs)

        diff = np.abs(test - reference)
        q.mse.append(mse_fn(test, reference))
        if "psnr" in flags:
            q.psnr.append(psnr_fn(test, reference))
        if "ssim" in flags:
            q.ssim.append(iw_ssim(rgb_to_gray255(reference.reshape(h, w, 3)),
                                  rgb_to_gray255(test.reshape(h, w, 3))))
        if "flip" in flags:
            fmap = flip_error_map(reference.reshape(h, w, 3), test.reshape(h, w, 3),
                                  device=ts.device).cpu().numpy()
            q.flip.append(float(fmap.mean()))
            q.flip_data.append(colormaps.apply("magma", fmap)[..., :3])
        q.diff_data.append(diff.reshape(h, w, 3))
        q.square_diff_data.append((diff ** 2).reshape(h, w, 3))

        if "output_images" in flags:
            save_img(test.reshape(h, w, 3), dim, os.path.join(out_dir, "eval", f"{i}_out.png"),
                     False)

        if ts.config_file.adaptiveSamplingThreshold == 0.0 and FSK.oracle_weights in extras:
            q.sparsity.append(float(np.mean(extras[FSK.oracle_weights])))

    for i in range(len(q.diff_data)):
        save_img(q.diff_data[i], dim, os.path.join(
            out_dir, "eval", f"{i}_diff_{q.diff_data[i].mean()}.png"), False)
        save_img(q.square_diff_data[i], dim, os.path.join(
            out_dir, "eval", f"{i}_square_diff_{q.square_diff_data[i].mean()}.png"), False)
        if "flip" in flags and i < len(q.flip_data):
            save_img(q.flip_data[i], dim, os.path.join(
                out_dir, "eval", f"{i}_flip_{q.flip[i]}.png"), False)

    if count_flops:
        with open(os.path.join(out_dir, "complexity.txt"), "w") as f:
            cma = cma_pp = 0.0
            for idx, (macs, macs_pp) in enumerate(zip(image_macs, image_macs_pp)):
                f.write(f"{idx} - {macs} - {macs_pp}\n")
                cma = cma + (macs - cma) / (idx + 1)
                cma_pp = cma_pp + (macs_pp - cma_pp) / (idx + 1)
            f.write(f"{cma} : {cma_pp}\n")
        counted, shaded = complexity_samples(ts)
        if counted != shaded:
            print(f"note: complexity.txt counts the nets' MACs at {counted} samples a pixel, "
                  f"as the JAX package does, where they shade {shaded} (ROADMAP Queue 3, F8)",
                  flush=True)

    default_samples = float(ts.config_file.numRaymarchSamples[-1])
    with open(os.path.join(out_dir, "image_quality_images.txt"), "w") as f:
        for idx, m in enumerate(q.mse):
            f.write(f"image={idx} mse={m:.4f} psnr="
                    f"{q.psnr[idx] if 'psnr' in flags else -1.0:.4f} "
                    f"ssim={q.ssim[idx] if 'ssim' in flags else -1.0:.4f} "
                    f"flip_loss={q.flip[idx] if 'flip' in flags else -1.0:.4f} "
                    f"samples={q.samples[idx] if len(q.samples) > idx else default_samples} "
                    f"sparsity={q.sparsity[idx] if len(q.sparsity) > idx else -1.0:.4f}\r")
    with open(os.path.join(out_dir, "image_quality_images.csv"), "w") as c:
        c.write("mse,psnr,ssim,flip,samples,sparsity\r")
        for idx, m in enumerate(q.mse):
            c.write(f"{m},{q.psnr[idx] if 'psnr' in flags else -1.0},"
                    f"{q.ssim[idx] if 'ssim' in flags else -1.0},"
                    f"{q.flip[idx] if 'flip' in flags else -1.0},"
                    f"{q.samples[idx] if len(q.samples) > idx else default_samples},"
                    f"{q.sparsity[idx] if len(q.sparsity) > idx else -1.0}\r")
    return q


def reference_frame_files(data_path):
    """The frames of ``<data_path>/reference_video`` (``.png`` and ``.jpg``,
    in name order), or None when there is no such directory. A frame the
    port cannot decode (``data/png.py::check_image``: a hierarchical JPEG,
    say) raises ValueError, from its headers alone."""
    ref_path = os.path.join(data_path, "reference_video")
    if not os.path.exists(ref_path):
        return None
    names = [f for f in sorted(os.listdir(ref_path)) if f.lower().endswith((".png", ".jpg"))]
    files = [os.path.join(ref_path, f) for f in names]
    for f in files:
        check_image(f)
    return files


def load_reference_video(data_path):
    """The frames of ``<data_path>/reference_video/*.{png,jpg}`` as uint8
    arrays, or None when there are none."""
    files = reference_frame_files(data_path)
    if not files:
        return None
    return [read_image(f) for f in files]


def _write_frames(out_dir, name, frames):
    """``<out_dir>/<name>_frames/%05d.png``: the frame sequence the JAX
    package writes when it cannot encode a video."""
    frame_dir = os.path.join(out_dir, name + "_frames")
    os.makedirs(frame_dir, exist_ok=True)
    for i, frame in enumerate(frames):
        write_png(os.path.join(frame_dir, f"{i:05d}.png"), frame)


def generate_video_data(ts, flags, reference_video, out_dir=None, files=None):
    """The ``cam_path`` camera path rendered against a reference video:
    per-frame metrics, the diff, square-diff and FLIP frame sequences and
    ``image_quality_video.{txt,csv}``. A frame of another size than the
    run's is area-resized to it. ``files``, the frames' files where they
    were read from a scene, names a frame that cannot be compared with the
    render (a greyscale image, say), on which the JAX package fails too."""
    out_dir = out_dir or getattr(ts, 'outDir', ts.logDir)
    h, w = ts.h, ts.w
    chunk = ts.config_file.inferenceChunkSize
    transforms = PredefinedCamera.import_camera_path(
        ts.config_file.data, "cam_path", len(reference_video))

    q = QualityContainer()
    for i in range(min(len(transforms), len(reference_video))):
        t = transforms[i]
        imgs, _ = render_rays_chunked(ts, t[:3, 3], t[:3, :3], chunk, collect=[])
        test = np.clip(imgs[-1][:, :3], 0.0, 1.0).reshape(h, w, 3)
        ref = np.asarray(reference_video[i]).astype(np.float32)
        if ref.max() > 1.5:
            ref = ref / 255.0
        ref = ref[..., :3]
        if ref.shape[:2] != (h, w):
            ref = resize_area(ref, w, h)
        if files is not None:
            require_broadcast(test, ref, files[i], "the JAX package's videos evaluation "
                              "(evaluation/evaluate.py:209, test - ref)")

        diff = np.abs(test - ref)
        q.mse.append(mse_fn(test, ref))
        if "psnr" in flags:
            q.psnr.append(psnr_fn(test, ref))
        if "ssim" in flags:
            q.ssim.append(iw_ssim(rgb_to_gray255(ref), rgb_to_gray255(test)))
        if "flip" in flags:
            fmap = flip_error_map(ref, test, device=ts.device).cpu().numpy()
            q.flip.append(float(fmap.mean()))
            q.flip_data.append((colormaps.apply("magma", fmap)[..., :3] * 255).astype(np.uint8))
        q.diff_data.append((diff * 255).astype(np.uint8))
        q.square_diff_data.append((diff ** 2 * 255).astype(np.uint8))

    _write_frames(out_dir, "_diff", q.diff_data)
    _write_frames(out_dir, "_square_diff", q.square_diff_data)
    if "flip" in flags and q.flip_data:
        _write_frames(out_dir, "_flip", q.flip_data)

    default_samples = float(ts.config_file.numRaymarchSamples[-1])
    with open(os.path.join(out_dir, "image_quality_video.txt"), "w") as f:
        for idx, m in enumerate(q.mse):
            f.write(f"image={idx} mse={m:.4f} psnr="
                    f"{q.psnr[idx] if 'psnr' in flags else -1.0:.4f} "
                    f"ssim={q.ssim[idx] if 'ssim' in flags else -1.0:.4f} "
                    f"flip_loss={q.flip[idx] if 'flip' in flags else -1.0:.4f} "
                    f"samples={default_samples} sparsity=-1.0\r")
    with open(os.path.join(out_dir, "image_quality_video.csv"), "w") as c:
        c.write("mse,psnr,ssim,flip,samples,sparsity\r")
        for idx, m in enumerate(q.mse):
            c.write(f"{m},{q.psnr[idx] if 'psnr' in flags else -1.0},"
                    f"{q.ssim[idx] if 'ssim' in flags else -1.0},"
                    f"{q.flip[idx] if 'flip' in flags else -1.0},"
                    f"{default_samples},-1.0\r")
    return q


def _render_cam_path(ts, cam_path, vid_name):
    """A PredefinedCamera video of ``<scene>/<cam_path>.json`` into
    ``ts.outDir``; a missing path file is reported and skipped, as JAX does."""
    c = ts.config_file
    saved = (c.camType, c.camPath, c.videoFrames)
    c.camPath, c.camType, c.videoFrames = cam_path, "PredefinedCamera", -1
    try:
        render_video(ts, vid_name=vid_name, out_dir=ts.outDir)
    except FileNotFoundError:
        print(f"no {cam_path}.json — skipping video {vid_name}")
    finally:
        c.camType, c.camPath, c.videoFrames = saved


def evaluate(ts, reference_video, evaluations):
    """Run the requested evaluations; ``videos`` reads the scene's
    ``reference_video/`` unless ``reference_video`` (frames) is given.
    Returns the images leg's metrics, or None."""
    if not hasattr(ts, 'outDir'):
        ts.outDir = ts.logDir
    videos = "videos" in evaluations and not ts.config_file.trainWithGTDepth
    files = None
    if videos and reference_video is None:
        # read before any leg runs, so a refused frame (a progressive JPEG) stops the run early
        files = reference_frame_files(ts.config_file.data)
        reference_video = load_reference_video(ts.config_file.data)

    if "opt" in evaluations and not ts.config_file.trainWithGTDepth:
        _render_cam_path(ts, "cam_path", "_opt")

    if "complexity" in evaluations:
        get_network_size(ts, ts.outDir)

    q = None
    if "images" in evaluations:
        q = generate_data(ts, evaluations)

    if videos and reference_video is not None:
        try:
            generate_video_data(ts, evaluations, reference_video, files=files)
        except FileNotFoundError:
            print("no cam_path.json — skipping video evaluation")

    if "output_videos" in evaluations and not ts.config_file.trainWithGTDepth:
        cam_paths = getattr(ts, "evaluation_cam_path", None) or \
            ([ts.config_file.camPath] if ts.config_file.camPath else [])
        for cam_path in cam_paths:
            _render_cam_path(ts, cam_path, cam_path)

    if "export" in evaluations:
        from ..export import export_artifacts
        export_artifacts(ts, os.path.join(ts.outDir, "exported_model"))

    if os.path.exists(os.path.join(ts.logDir, "opt.txt")):
        os.makedirs(os.path.join(ts.outDir, "eval"), exist_ok=True)
        copyfile(os.path.join(ts.logDir, "opt.txt"), os.path.join(ts.outDir, "eval", "opt.txt"))
    return q


def get_optimal_epoch(path):
    """The epoch at the end of opt.txt's first line (or its second)."""
    with open(os.path.join(path, "opt.txt")) as f:
        line = f.readline()
        m = re.search(r'\d+$', line)
        if m is None:
            line = f.readline()
            m = re.search(r'\d+$', line)
        return line[m.start():m.end()]


def load_config(data_path, device, path, evaluations, skip, cl_out_dir=None,
                skip_if_already_done_once=True, load_training_datasets=False):
    """Re-hydrate a TrainState from an experiment directory's echoed
    config.ini on ``device``. Returns (status, ts): 0 ok, 1 error, 2
    skipped (this optimal epoch is evaluated already)."""
    from ..config import Config
    from ..train_state import TrainState

    c_file = os.path.join(path, "config.ini")
    orig_path = os.path.join(path, '')
    if path.endswith("-D") or path.endswith(f"-D{os.path.sep}"):
        return 1, None
    if not os.path.exists(c_file):
        print("No config.ini found!")
        return 1, None

    try:
        optimal_epoch = get_optimal_epoch(orig_path)
    except (FileNotFoundError, AttributeError):
        optimal_epoch = None

    if len(evaluations) == 0:
        evaluations.extend(e for e in DEFAULT_EVALUATIONS if e not in skip)

    # strip the experiment and dataset directories to find the base log dir
    base = path
    for _ in range(2):
        base, _tail = os.path.split(base.rstrip(os.path.sep))

    config = Config.init(path=c_file, only_known_args=True, argv=[])
    config.data = data_path
    config.logDir = base
    config.device = device

    dataset_name = os.path.basename(os.path.normpath(config.data))
    experiment_name = os.path.basename(os.path.normpath(orig_path))
    out_dir = orig_path
    if cl_out_dir is not None:
        out_dir = os.path.join(cl_out_dir, dataset_name, experiment_name)
    os.makedirs(os.path.join(out_dir, "eval"), exist_ok=True)

    try:
        evaluated_epoch = get_optimal_epoch(os.path.join(out_dir, "eval"))
    except (FileNotFoundError, AttributeError):
        evaluated_epoch = None
    if evaluated_epoch is not None and optimal_epoch is not None and \
            optimal_epoch == evaluated_epoch and skip_if_already_done_once:
        print("Evaluation already performed for this optimal epoch!")
        return 2, None

    while len(config.lossWeights) < len(config.losses):
        config.lossWeights.append(1)

    ts = TrainState()
    ts.initialize(config, log_path=orig_path, training=load_training_datasets)
    ts.outDir = out_dir

    checkpoint_name = config.checkPointName.replace(".weights", "")
    if any(checkpoint_name in f for f in os.listdir(orig_path)):
        ts.load_specific_weights(checkpoint_name)
    else:
        ts.load_latest_weights()
    return 0, ts
