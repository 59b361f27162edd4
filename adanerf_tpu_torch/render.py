"""Full-image rendering, debug images and camera-path videos.

Counterpart of ``adanerf_tpu/render.py``. Rendering runs the plain cascade
(``TrainState.inference``) over fixed-size ray chunks; the last chunk is
padded to the chunk size by repeating its last ray, as the JAX package
pads it for its compiled program. A split's ray directions stay on the
host and each chunk moves to the device on its own; the per-net outputs
and the collected per-ray channels come back once per image.

Two outputs differ from the JAX package's, whose libraries the GPU machine
lacks: the oracle histogram (``{name}_oracle_histogram.png``) is a plain
bar raster drawn with numpy, in the same counts and colours, without axes
or text; and a video is always written as PNG frames
(``{vid}_{net}_frames/00000.png``...), the JAX code's own fallback when it
cannot write mp4. ``plot_training_stats`` writes the JAX package's
``{x}_{y}.pdf`` files with the port's own PDF writer
(``utils/pdfplot.py``) where JAX uses pandas and matplotlib: the same
columns against the same x, drawn otherwise.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .data.camera import camera_path_transforms
from .data.png import write_png
from .ops.normalization import get_normalization_abbr
from .pipeline.keys import FSK, DatasetKeys
from .utils import colormaps, pdfplot
from .utils.saveimage import Dim, save_img, transform_img


def calculate_mse(diff):
    return float(np.mean(np.asarray(diff) ** 2))


def calculate_psnr(mse):
    return 10 * np.log10(1.0 / mse)


def render_rays_chunked(ts, pose, rotation, chunk_size: int,
                        collect: Optional[List[str]] = None,
                        pixel_indices: Optional[np.ndarray] = None):
    """Render all (or the selected) pixels of one camera pose in chunks of
    ``chunk_size`` rays.

    Returns (imgs, extras): per-net flat images (n_pix, C) float32 and a
    dict of the last net's collected per-ray channels, (n_pix,) or
    (n_pix, C) float32. ``collect=None`` collects every per-ray channel.
    """
    dirs_full = ts.test_dataset.directions
    if pixel_indices is None:
        pixel_indices = np.arange(ts.h * ts.w, dtype=np.int64)
    dirs_sel = dirs_full[pixel_indices]
    n_pix = dirs_sel.shape[0]
    dev = ts.device
    pose_t = torch.as_tensor(np.asarray(pose, np.float32)[None], device=dev)
    rot_t = torch.as_tensor(np.asarray(rotation, np.float32)[None], device=dev)

    outs_by_net, extras_parts = None, {}
    for start in range(0, n_pix, chunk_size):
        end = min(start + chunk_size, n_pix)
        chunk = dirs_sel[start:end]
        pad = chunk_size - (end - start)
        if pad > 0:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
        batch = {DatasetKeys.image_pose: pose_t, DatasetKeys.image_rotation: rot_t,
                 DatasetKeys.ray_directions_samples:
                     torch.from_numpy(np.ascontiguousarray(chunk[None])).to(dev)}
        outs, dicts = ts.inference(batch)
        last = dicts[-1]
        if outs_by_net is None:
            outs_by_net = [[] for _ in outs]
            if collect is None:
                collect = [k for k, v in last.items()
                           if isinstance(v, torch.Tensor) and v.dim() in (1, 2)]
            # only per-ray channels can be stitched across chunks
            extras_parts = {k: [] for k in collect if isinstance(last.get(k), torch.Tensor)
                            and last[k].dim() in (1, 2) and last[k].shape[0] == chunk_size}
        for i, o in enumerate(outs):
            outs_by_net[i].append(o[:end - start].float())
        for k, parts in extras_parts.items():
            parts.append(last[k][:end - start].float())
    imgs = [torch.cat(parts).cpu().numpy() for parts in outs_by_net]
    extras: Dict[str, np.ndarray] = {k: torch.cat(parts).cpu().numpy()
                                     for k, parts in extras_parts.items()}
    return imgs, extras


def histogram_raster(counts, colors, width=640, height=480) -> np.ndarray:
    """(height, width, 4) uint8: one bar per count on white, bar i centred at
    x = i with width 0.8 in the colour ``colors[i]``, in the axes box and
    data limits ``pyplot.bar`` gives a 640x480 figure by default; no axes,
    ticks or text."""
    counts = np.asarray(counts, np.float64)
    img = np.full((height, width, 4), 255, np.uint8)
    x0, x1 = 0.125 * width, 0.9 * width          # the default axes box
    y0, y1 = (1 - 0.88) * height, (1 - 0.11) * height  # top, bottom (rows)
    lo, hi = -0.4, len(counts) - 1 + 0.4
    lo, hi = lo - 0.05 * (hi - lo), hi + 0.05 * (hi - lo)
    top = max(float(counts.max()), 1.0) * 1.05
    for i, (c, rgb) in enumerate(zip(counts, np.asarray(colors))):
        if c <= 0:
            continue
        left = int(round(x0 + (i - 0.4 - lo) / (hi - lo) * (x1 - x0)))
        right = max(int(round(x0 + (i + 0.4 - lo) / (hi - lo) * (x1 - x0))), left + 1)
        upper = int(round(y1 - c / top * (y1 - y0)))
        img[upper:int(round(y1)), left:right, :3] = (np.asarray(rgb[:3]) * 255).astype(np.uint8)
    return img


def render_img(ts, image_index: int, dataset=None, img_name=None, model_idxs=None):
    """Debug render of one validation image, with the estimated-depth
    colour map, the adaptive-sample heat map, the oracle histogram and the
    oracle and NeRF weight slices along the middle row."""
    dataset = dataset or ts.valid_dataset
    h, w = ts.h, ts.w
    chunk = ts.config_file.inferenceChunkSize
    collect = [FSK.nerf_estimated_depth, FSK.adaptive_sample_positions,
               FSK.oracle_weights, FSK.nerf_weights_output, FSK.nerf_alpha_output]
    imgs, extras = render_rays_chunked(ts, dataset.poses[image_index],
                                       dataset.rotations[image_index], chunk, collect=collect)
    target = None
    if dataset.color_images is not None:
        target = dataset.color_images[image_index].reshape(-1, 3)

    dim = Dim(h, w)
    log_dir = ts.logDir
    for i, img in enumerate(imgs):
        if model_idxs is not None and i not in model_idxs:
            continue
        save_img(img, dim, os.path.join(log_dir, f"{img_name}_{i}.png"))
    if target is not None:
        save_img(target, dim, os.path.join(log_dir, f"{img_name}_{len(imgs) - 1}_train_targets.png"))

    if FSK.nerf_estimated_depth in extras:
        d = extras[FSK.nerf_estimated_depth]
        save_img(colormaps.apply("plasma", d.reshape(-1)), dim,
                 os.path.join(log_dir, f"{img_name}_estimated_depth.png"))

    if FSK.adaptive_sample_positions in extras:
        a = extras[FSK.adaptive_sample_positions]
        if a.sum() != h * w:
            save_img(colormaps.apply("coolwarm", a), dim,
                     os.path.join(log_dir, f"{img_name}_adaptive_samples.png"))

    if FSK.oracle_weights in extras:
        ow = extras[FSK.oracle_weights]
        counts, edges = np.histogram((ow * 255).flatten(), 255, (0.0, 255.0))
        colors = colormaps.ramp(edges[:-1] / 255, [(1, 0, 0), (0, 128 / 255, 0), (0, 0, 1)])
        write_png(os.path.join(log_dir, f"{img_name}_oracle_histogram.png"),
                  histogram_raster(counts, colors))
        weight_slice = np.flip(np.transpose(ow[int(h * 0.5 * w):int((h * 0.5 + 1) * w)]), 0)
        save_img(colormaps.apply("magma", weight_slice), Dim(weight_slice.shape[0], w),
                 os.path.join(log_dir, f"{img_name}_oracle_weights.png"))

    if FSK.nerf_weights_output in extras:
        nw = extras[FSK.nerf_weights_output]
        weight_slice = np.flip(np.transpose(nw[int(h * 0.5 * w):int((h * 0.5 + 1) * w)]), 0)
        save_img(colormaps.apply("magma", weight_slice), Dim(weight_slice.shape[0], w),
                 os.path.join(log_dir, f"{img_name}_nerf_weights.png"))

    if target is not None:
        psnr = calculate_psnr(calculate_mse(target - imgs[-1]))
        print(f"\nRender img PSNR {img_name}: {psnr}\n")
        return psnr
    return None


def render_all_imgs(ts, subfolder_name="", dataset_name="test"):
    """Offline render of a whole split, with each image's estimated depth
    (PNG and world-space npz) and the quantized NeRF weights."""
    out_dir = os.path.join(ts.logDir, subfolder_name, dataset_name)
    os.makedirs(out_dir, exist_ok=True)
    dataset = {"train": ts.train_dataset, "val": ts.valid_dataset,
               "test": ts.test_dataset}.get(dataset_name) or ts.test_dataset
    chunk = ts.config_file.inferenceChunkSize
    dim = Dim(ts.h, ts.w)

    raw_save_suffix = ""
    if "lin" not in ts.config_file.depthTransform:
        raw_save_suffix += ts.config_file.depthTransform[0:2]
    if ts.config_file.rayMarchNormalization:
        raw_save_suffix += get_normalization_abbr(ts.config_file.rayMarchNormalization[-1]) or ""

    psnrs = []
    for i in range(len(dataset)):
        base = os.path.splitext(os.path.basename(dataset.image_filenames[i]))[0]
        collect = [FSK.nerf_estimated_depth, FSK.nerf_weights_output,
                   FSK.adaptive_sample_positions, FSK.oracle_weights]
        imgs, extras = render_rays_chunked(ts, dataset.poses[i], dataset.rotations[i], chunk,
                                           collect=collect)
        for net_idx, img in enumerate(imgs):
            save_img(img, dim, os.path.join(out_dir, f"{net_idx}_{base}.png"))

        if FSK.nerf_estimated_depth in extras:
            depth_map = extras[FSK.nerf_estimated_depth]
            save_img(depth_map, dim, os.path.join(out_dir, f"{base}_estimated_depth.png"))
            world_depth = np.asarray(ts.scene.depth_transform.to_world(
                depth_map, ts.f_in[-1].depth_range))
            np.savez(os.path.join(out_dir, f"{base}_depth.npz"), world_depth)
            save_img(depth_map, dim, os.path.join(out_dir, f"{base}_{raw_save_suffix}_depth.png"))
            if FSK.nerf_weights_output in extras:
                quant = (extras[FSK.nerf_weights_output] * 255).astype(np.uint8)
                np.save(os.path.join(out_dir, f"{base}_weights.trch.npy"), quant)
        else:
            # a final net that does not ray-march: the raw collected channels
            for key, value in extras.items():
                np.save(os.path.join(out_dir, f"{i}_{key}_{raw_save_suffix}.raw.npy"), value)

        if dataset.color_images is not None:
            target = dataset.color_images[i].reshape(-1, 3)
            psnrs.append(calculate_psnr(calculate_mse(target - imgs[-1])))

    if psnrs:
        for i, p in enumerate(psnrs):
            print(f"Render all img psnr {i} {p}")
        print(f"Average PSNR: {np.mean(psnrs)}")
    return psnrs


def render_video(ts, vid_name=None, out_dir=None):
    """Render the configured camera path, one PNG frame sequence per net:
    ``{out_dir}/{vid_name}_{net}_frames/00000.png``..."""
    c = ts.config_file
    transforms = camera_path_transforms(c, ts.dataset_info)
    chunk = c.inferenceChunkSize
    dim = Dim(ts.h, ts.w)
    video_output_dir = out_dir or ts.logDir
    frames_by_net = None
    for t in transforms:
        imgs, _ = render_rays_chunked(ts, t[:3, 3], t[:3, :3], chunk, collect=[])
        if frames_by_net is None:
            frames_by_net = [[] for _ in imgs]
        for net_idx, img in enumerate(imgs):
            frames_by_net[net_idx].append((transform_img(img, dim) * 255).astype(np.uint8))
    for net_idx, frames in enumerate(frames_by_net or []):
        frame_dir = os.path.join(video_output_dir, f"{vid_name}_{net_idx}_frames")
        os.makedirs(frame_dir, exist_ok=True)
        for fi, fr in enumerate(frames):
            write_png(os.path.join(frame_dir, f"{fi:05d}.png"), fr)


def plot_training_stats(log_dir, csv_path, x_column, y_column):
    """Plot the column (or list of columns) ``y_column`` of the CSV
    ``log_dir/csv_path`` against ``x_column`` into
    ``log_dir/{x_column}_{y_column joined by _}.pdf``, as the JAX package's
    ``plot_training_stats`` names it."""
    with open(os.path.join(log_dir, csv_path), newline="") as f:
        rows = list(csv.DictReader(f))
    ys = [y_column] if isinstance(y_column, str) else list(y_column)
    x = [float(r[x_column]) for r in rows]
    series = [(y, [float(r[y]) for r in rows]) for y in ys]
    pdfplot.line_plot(os.path.join(log_dir, f"{x_column}_{'_'.join(ys)}.pdf"), x, series,
                      xlabel=x_column)
