"""Training entry point of the port:

  python -m adanerf_tpu_torch.train -c configs/dense_training.ini \\
      -data <scene> -log <dir> --bf16 [--device cpu] [flags]

Counterpart of the JAX package's root ``train.py``: initialize, resume (or
bootstrap from a dense teacher), GT pretraining of each net with
``epochsPretrain`` > 0 (``pre_train``), the training loop with periodic
checkpoints (``epochsCheckpoint``), debug renders (``epochsRender``),
camera-path videos (``epochsVideo``, PNG frames) and validation passes
(``epochsValidate``), whose best loss goes to ``opt.txt`` with the
``_opt`` checkpoints and the ``opt/val`` images; then a final save and,
with ``performEvaluation``, the evaluation of the ``checkPointName``
checkpoint (``evaluation/evaluate.py``). On a CUDA device with ``--bf16``
the shading MLP's forward and backward run through the K3 kernel.

Refused before step 0, each naming its ROADMAP item: ``--meshDevices`` > 1
(the port trains on one device), and a NeRF that the JAX package would
train through its TPU kernel but K3 does not take yet (a width other than
256) on a run that asks for K3.
"""

from __future__ import annotations

import csv
import os
import sys
import time

import numpy as np
import torch

from .config import Config
from .data.prefetch import BatchPrefetcher, epoch_image_indices
from .pipeline.keys import FSK
from .render import calculate_mse, render_img, render_rays_chunked, render_video
from .train_state import TrainState, parse_device
from .utils.saveimage import Dim, save_img, transform_img


def unsupported(config) -> list:
    """What this run asks for that the port cannot do yet, one message each."""
    out = []
    if config.meshDevices > 1:
        out.append(f"--meshDevices {config.meshDevices}: multi-device training is not "
                   "ported yet (ROADMAP Queue 1, item 9)")
    return out


def unsupported_by_k3(config) -> list:
    """On a run that asks for K3 (a CUDA device, ``--bf16``,
    ``--fusedTrainKernel 1``), each NeRF that the JAX package trains through
    its TPU kernel (width a multiple of 128) but K3 does not take yet: such a
    run is refused rather than trained on the plain path."""
    from .ops.kernels.nerf_train import MAXL, ROADMAP, WIDTH
    if not (config.bf16 and config.fusedTrainKernel
            and parse_device(config.device).type == "cuda"):
        return []
    out = []
    for i, act in enumerate(config.activation):
        width, depth = config.layerWidth[i], config.layers[i]
        if act != "nerf" or width % 128 or width < 128:
            continue
        if width != WIDTH or depth > MAXL:
            out.append(f"--layerWidth {width}, --layers {depth} (net {i}) with --bf16 and "
                       f"--fusedTrainKernel 1 on CUDA: K3 takes width {WIDTH} and at most "
                       f"{MAXL} layers ({ROADMAP}); --fusedTrainKernel 0 trains this net on "
                       "the plain path")
    return out


class _StepClock:
    """Per-step times: CUDA events on a CUDA device (read once at the end,
    no per-step synchronisation), the host clock on the CPU. A step runs
    from the end of the one before it (or from ``restart``) to its
    ``mark``; ``restart`` after the work done between two steps (a render,
    a video, a validation pass) keeps that work out of the next step."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.spans = []
        self.start = None

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def restart(self):
        self.start = self._now()

    def mark(self):
        end = self._now()
        self.spans.append((self.start, end))
        self.start = end

    def step_ms(self):
        if self.cuda:
            if self.spans:
                self.spans[-1][1].synchronize()
            return [a.elapsed_time(b) for a, b in self.spans]
        return [(b - a) * 1e3 for a, b in self.spans]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def validate_batch(ts: TrainState, epoch, train_loss, model_idx=-1):
    """Full-image validation pass over the validation split: the loss of
    net ``model_idx`` on every image (its MSE where that loss cannot be
    evaluated on a whole image), the share of channels within 1e-3 of the
    target, ``logs.txt`` and the ``trainStatsName`` CSV. Returns (mean
    loss, per-image {"images", "psnr"})."""
    c = ts.config_file
    dataset = ts.valid_dataset
    dim = Dim(ts.h, ts.w)
    losses, accuracies, validation_images = [], [], []
    for i in range(len(dataset)):
        imgs, extras = render_rays_chunked(ts, dataset.poses[i], dataset.rotations[i],
                                           c.inferenceChunkSize,
                                           collect=[FSK.nerf_weights_output])
        target = dataset.color_images[i].reshape(-1, 3)
        inference_dict = {FSK.nerf_weights_output:
                          torch.from_numpy(extras[FSK.nerf_weights_output])
                          if FSK.nerf_weights_output in extras else None}
        try:
            loss_val = float(ts.losses[model_idx](
                torch.from_numpy(imgs[-1]), torch.from_numpy(target),
                inference_dict=inference_dict, epoch=epoch))
        except (KeyError, TypeError, ValueError, RuntimeError):
            # a loss that needs what a whole-image render does not give
            # (other nets' outputs, matching shapes): its MSE, as JAX does
            loss_val = calculate_mse(imgs[-1] - target)
        losses.append(loss_val)
        diff = np.abs(imgs[-1] - target)
        accuracies.append(float((diff < 0.001).sum()) / diff.size)
        psnr = 10 * np.log10(1.0 / np.mean(diff ** 2))
        validation_images.append({"images": [transform_img(img, dim) for img in imgs],
                                  "psnr": psnr})

    loss = float(np.mean(losses))
    accuracy = float(np.mean(accuracies))
    print(f"\nvalidation epoch={epoch:<10} loss={loss:.8f} acc={accuracy:.8f}")
    with open(os.path.join(ts.logDir, "logs.txt"), "a") as f:
        f.write(f"epoch={epoch} loss={loss:.4f}  acc={accuracy:.8f} "
                f"train_loss={train_loss:.8f}\r")
    stats_path = os.path.join(ts.logDir, c.trainStatsName)
    add_header = not os.path.isfile(stats_path)
    with open(stats_path, "a", newline="") as csv_file:
        writer = csv.DictWriter(csv_file, fieldnames=["epoch", "loss", "accuracy", "train_loss"])
        if add_header:
            writer.writeheader()
        writer.writerow({"epoch": f"{epoch}", "loss": f"{loss}", "accuracy": f"{accuracy}",
                         "train_loss": f"{train_loss}"})
    return loss, validation_images


def _save_opt(ts: TrainState, epoch: int, val_loss: float, img_data):
    """A new best validation loss: opt.txt, the ``_opt`` checkpoints and
    the validation images under ``opt/val``."""
    with open(os.path.join(ts.logDir, "opt.txt"), "w") as f:
        f.write(f"Optimal validation loss {val_loss} at epoch {epoch}")
    ts.save_weights(name_suffix="_opt")
    valid_dir = os.path.join(ts.logDir, "opt", "val")
    os.makedirs(valid_dir, exist_ok=True)
    psnrs = []
    for i, data in enumerate(img_data):
        psnrs.append(data["psnr"])
        print(f"Render all img psnr {i} {psnrs[i]}")
        for net_index, img in enumerate(data["images"]):
            save_img(img, ts.dataset_info, os.path.join(valid_dir, f"_{net_index}_{i}.png"),
                     False)
    print(f"Average PSNR: {np.array(psnrs).mean()}")


def pre_train(ts: TrainState) -> dict:
    """GT pretraining: each net with ``epochsPretrain`` beyond the start
    epoch trains alone (``TrainState.make_pretrain_step``) from ts.epoch0 to
    its epoch count on ``samplesPretrain`` rays of ``batchImagesPretrain``
    images a step, with checkpoints, validation of its loss, ``opt.txt``
    and the net's ``_opt`` checkpoint; then the net's ``checkPointName``
    checkpoint is loaded and ts.epoch0 moves to its epoch count. The images
    come from a permutation seeded by ``randomSeed`` (JAX draws from
    numpy's unseeded global generator). Returns {net index: {"losses",
    "step_ms", "validate_ms", "opt_epochs"}}, the last the epochs at which
    a new best validation loss saved the net's ``_opt`` checkpoint."""
    c = ts.config_file
    out = {}
    if not c.epochsPretrain:
        return out
    samples = c.samplesPretrain if c.samplesPretrain != -1 else c.samples
    batch_images = c.batchImagesPretrain if c.batchImagesPretrain != -1 else c.batchImages
    ts.train_dataset.num_samples = samples
    rng = np.random.default_rng(c.randomSeed if c.randomSeed != -1 else 0)
    for model_idx in range(len(ts.models)):
        epoch_pretrain = c.epochsPretrain[model_idx]
        if ts.epoch0 >= epoch_pretrain:
            continue
        best_val_loss = sys.float_info.max
        if model_idx < len(ts.best_valid_loss_pretrain):
            best_val_loss = ts.best_valid_loss_pretrain[model_idx]
        step = ts.make_pretrain_step(model_idx)
        n_images = len(ts.train_dataset)
        perm, cursor = rng.permutation(n_images), 0
        clock = _StepClock(ts.device)
        losses, validate_ms, opt_epochs = [], [], []
        clock.restart()
        for epoch in range(ts.epoch0, epoch_pretrain + 1):
            if cursor + batch_images > n_images:
                perm, cursor = rng.permutation(n_images), 0
            img_idx = perm[cursor:cursor + batch_images]
            cursor += batch_images
            batch, targets = ts.assemble_train_batch(ts.train_dataset, img_idx)
            losses.append(step(batch, targets, epoch, ts.epoch0))
            clock.mark()
            if epoch > 0 and epoch % c.epochsCheckpoint == 0:
                ts.save_weights(name_suffix=f"{epoch:07d}",
                                params_only=bool(c.checkpointParamsOnly))
            if epoch % c.epochsValidate == 0 and epoch > 0:
                _sync(ts.device)
                t = time.perf_counter()
                val_loss, _ = validate_batch(ts, epoch, 0.0, model_idx)
                validate_ms.append((time.perf_counter() - t) * 1e3)
                if val_loss < best_val_loss:
                    best_val_loss = val_loss
                    with open(os.path.join(ts.logDir, "opt.txt"), "w") as f:
                        f.write(f"Optimal validation loss {best_val_loss} at epoch {epoch}")
                    ts.save_weights(name_suffix="_opt", model_idx=model_idx)
                    opt_epochs.append(epoch)
                clock.restart()
        ts.load_specific_weights(c.checkPointName, model_idx)
        ts.epoch0 = epoch_pretrain
        out[model_idx] = {"losses": torch.stack(losses).float().cpu().numpy(),
                          "step_ms": clock.step_ms(), "validate_ms": validate_ms,
                          "opt_epochs": opt_epochs}
    ts.train_dataset.num_samples = c.samples
    print("pre-training finished", flush=True)
    return out


def train(ts: TrainState) -> dict:
    """The training loop from ts.epoch0 to ts.epochs - 1, with its
    checkpoint, render, video and validation legs. Returns per-step losses
    (steps, nets), step times in ms (the legs excluded) and the legs' own
    times in ms: {"render": [...], "video": [...], "validate": [...]}, and
    the validation passes' images."""
    c = ts.config_file
    step = ts.make_train_step()
    n_images = len(ts.train_dataset)
    batch_images = c.batchImages if c.batchImages != -1 else n_images
    seed = c.randomSeed if c.randomSeed != -1 else 0
    best_val_loss = sys.float_info.max if ts.best_valid_loss is None else ts.best_valid_loss
    prefetcher = BatchPrefetcher(
        lambda idx: ts.assemble_train_batch(ts.train_dataset, idx),
        epoch_image_indices(n_images, batch_images, ts.epochs - ts.epoch0 + 1, seed))
    clock = _StepClock(ts.device)
    losses, legs = [], {"render": [], "video": [], "validate": []}
    loss_host = 0.0
    t0 = time.perf_counter()

    def leg(name, fn, *args, **kwargs):
        _sync(ts.device)
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(ts.device)
        legs[name].append((time.perf_counter() - t) * 1e3)
        return out

    try:
        clock.restart()
        for epoch in range(ts.epoch0, ts.epochs):
            batch, targets = next(prefetcher)
            per_net = step(batch, targets, epoch)
            losses.append(torch.stack(per_net))
            clock.mark()
            if not c.nonVerbose and c.verboseEvery > 0 and epoch % c.verboseEvery == 0:
                vals = [float(v) for v in per_net]
                loss_host = vals[-1]
                print(f"epoch={epoch:<10} losses=[{', '.join(f'{v:.8f}' for v in vals)}] "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
            if epoch % c.epochsCheckpoint == 0 and epoch > 0:
                ts.save_weights(name_suffix=f"{epoch:07d}",
                                params_only=bool(c.checkpointParamsOnly))
            ran_leg = False
            if epoch % c.epochsRender == 0 and epoch > 0:
                leg("render", render_img, ts, 0, ts.valid_dataset, img_name=f"{epoch:07d}")
                ran_leg = True
            rendered_video = False
            if c.epochsVideo >= 0 and epoch % c.epochsVideo == 0 and epoch > 0:
                leg("video", render_video, ts, vid_name=f"{epoch:07d}")
                rendered_video = ran_leg = True
            if epoch % c.epochsValidate == 0 and epoch > 0 and (
                    c.adaptiveSamplingThreshold > 0.0
                    or epoch > c.lossBlendingStart + c.lossBlendingDuration
                    or c.lossBlendingStart > ts.epochs):
                val_loss, img_data = leg("validate", validate_batch, ts, epoch, loss_host)
                ran_leg = True
                if val_loss < best_val_loss:
                    best_val_loss = val_loss
                    _save_opt(ts, epoch, val_loss, img_data)
                    # (the JAX package copies an epoch's mp4 videos to _opt;
                    # the port writes frames, which it does not copy)
                    if not rendered_video and c.epochsVideo >= 0:
                        leg("video", render_video, ts, vid_name="_opt")
            if ran_leg:
                clock.restart()
    finally:
        prefetcher.close()
    return {"losses": torch.stack(losses).cpu().numpy() if losses else np.zeros((0, 0)),
            "step_ms": clock.step_ms(), "legs_ms": legs}


def main(argv=None) -> dict:
    """Parse ``argv`` (default: the command line), train, save and, with
    ``performEvaluation``, evaluate. Returns the train-loop statistics, the
    pretraining's (``pretrain``), the paths of the final checkpoint, the
    evaluation's time in ms and the TrainState."""
    config = Config.init(argv=argv)
    early = unsupported(config) + unsupported_by_k3(config)
    if early:  # refuse before loading any data
        raise SystemExit("adanerf_tpu_torch.train: not supported yet:\n  " + "\n  ".join(early))
    ts = TrainState()
    ts.initialize(config)
    ts.load_latest_weights()
    try:
        routes = ts.train_apply_fns() or [None] * len(ts.models)
    except ValueError as err:  # a NeRF shape K3 does not take yet
        raise SystemExit(f"adanerf_tpu_torch.train: not supported yet:\n  {err}") from err
    print(f"Training config: {ts.logDir.rstrip('/').split('/')[-1]} ({config.config}) on "
          f"{ts.device}; epochs {ts.epoch0}..{ts.epochs - 1}; " + ", ".join(
              f"{m.name}: {'K3 kernel' if r is not None else 'plain'}"
              for m, r in zip(ts.models, routes)), flush=True)
    pretrain = pre_train(ts)
    stats = train(ts)
    stats["pretrain"] = pretrain
    stats["checkpoint"] = ts.save_weights(name_suffix=f"{ts.epochs - 1:07d}")
    if config.performEvaluation:
        from .evaluation.evaluate import evaluate
        t = time.perf_counter()
        ts.load_specific_weights(config.checkPointName.replace(".weights", ""))
        evaluate(ts, None, ["complexity", "images", "flip", "psnr", "output_images"])
        _sync(ts.device)
        stats["evaluate_ms"] = (time.perf_counter() - t) * 1e3
    stats["state"] = ts
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
