"""Training entry point of the port:

  python -m adanerf_tpu_torch.train -c configs/dense_training.ini \\
      -data <scene> -log <dir> --bf16 [--device cpu] [--meshDevices N] [flags]

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

Data-parallel over the rays (``parallel/mesh.py``), as the JAX trainer
with ``--meshDevices``: -1 takes every visible GPU (the one CPU with
``--device cpu``), N takes N. Without a launcher the trainer starts one
process per device itself and is rank 0 (``--device cpu --meshDevices N``:
N gloo ranks on the CPU); under torchrun or the JAX package's
``ADANERF_COORD`` / ``ADANERF_NPROC`` / ``ADANERF_PROC_ID`` each process
is one rank of the launcher's group, joined before anything touches the
device. Rank 0 alone writes: ``logs.csv``, checkpoints, ``opt.txt``,
renders, videos, validation and the evaluation; the others wait at a
barrier, and take rank 0's weights after it resumed or loaded a
checkpoint. GT pretraining is not data-parallel (neither is JAX's): every
rank runs it whole.

Refused before step 0: more GPUs than the host has (JAX's ``make_mesh``
would truncate) and rays per image that do not divide over the ranks. On
a run that asks for K3, every NeRF that the JAX package trains through its
TPU kernel (a width that is a multiple of 128) trains through K3, at any
depth and any number of encoded input columns.
"""

from __future__ import annotations

import csv
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .config import Config
from .data.prefetch import BatchPrefetcher, epoch_image_indices
from .parallel import mesh
from .pipeline.keys import FSK
from .render import (calculate_mse, plot_training_stats, render_img, render_rays_chunked,
                     render_video)
from .train_state import TrainState, parse_device
from .utils.saveimage import Dim, save_img, transform_img


# the columns of the trainStatsName CSV plotted after every validation
# (epoch_loss.pdf, ..., epoch_loss_train_loss.pdf), the JAX trainer's five
STAT_PLOTS = ["loss", "train_loss", "accuracy", ["loss", "train_loss", "accuracy"],
              ["loss", "train_loss"]]


def mesh_size(config) -> int:
    """The run's ranks: a launcher's processes (``--meshDevices`` -1 or
    their count), else ``--meshDevices`` devices of this host, -1 being
    every GPU (the one CPU with ``--device cpu``). Raises ValueError for
    more GPUs than the host has."""
    n = config.meshDevices
    launch = mesh.launcher_env()
    if launch is not None:
        if n not in (-1, launch["world"]):
            raise ValueError(f"--meshDevices {n}: the launcher started {launch['world']} "
                             "processes, one rank each")
        return launch["world"]
    if n == 0 or n < -1:
        raise ValueError(f"--meshDevices {n}: -1 (every device) or a device count")
    if parse_device(getattr(config, "device", "cuda")).type != "cuda":
        return 1 if n == -1 else n
    count = torch.cuda.device_count()
    if n == -1:
        return max(count, 1)
    if n > 1 and n > count:
        raise ValueError(f"--meshDevices {n}: only {count} CUDA device(s) present")
    return n


def unsupported(config) -> list:
    """What this run asks for that the port refuses, one message each."""
    try:
        world = mesh_size(config)
    except ValueError as err:
        return [str(err)]
    samples = getattr(config, "samples", None)
    if world > 1 and samples and samples % world:
        return [f"--samples {samples}: an image's rays do not split over {world} ranks"]
    return []


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
    target, ``logs.txt``, the ``trainStatsName`` CSV and its five
    ``epoch_*.pdf`` plots (``STAT_PLOTS``). Returns (mean
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
    for y in STAT_PLOTS:
        try:  # as the JAX trainer, a plot that fails does not stop the run
            plot_training_stats(ts.logDir, c.trainStatsName, "epoch", y)
        except Exception:
            pass
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


def pre_train(ts: TrainState, group=None) -> dict:
    """GT pretraining: each net with ``epochsPretrain`` beyond the start
    epoch trains alone (``TrainState.make_pretrain_step``) from ts.epoch0 to
    its epoch count on ``samplesPretrain`` rays of ``batchImagesPretrain``
    images a step, with checkpoints, validation of its loss, ``opt.txt``
    and the net's ``_opt`` checkpoint; then the net's ``checkPointName``
    checkpoint is loaded and ts.epoch0 moves to its epoch count. The images
    come from a permutation seeded by ``randomSeed`` (JAX draws from
    numpy's unseeded global generator). Returns {net index: {"losses",
    "step_ms", "validate_ms", "opt_epochs"}}, the last the epochs at which
    a new best validation loss saved the net's ``_opt`` checkpoint. In a
    group every rank takes every step (JAX's pretraining step is not
    sharded either); rank 0 alone writes and validates, and its loaded
    checkpoint goes to the others."""
    c = ts.config_file
    writer = mesh.rank_and_size(group)[0] == 0
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
            if epoch > 0 and epoch % c.epochsCheckpoint == 0 and writer:
                ts.save_weights(name_suffix=f"{epoch:07d}",
                                params_only=bool(c.checkpointParamsOnly))
            if epoch % c.epochsValidate == 0 and epoch > 0:
                _sync(ts.device)
                t = time.perf_counter()
                if writer:
                    val_loss, _ = validate_batch(ts, epoch, 0.0, model_idx)
                    if val_loss < best_val_loss:
                        best_val_loss = val_loss
                        with open(os.path.join(ts.logDir, "opt.txt"), "w") as f:
                            f.write(f"Optimal validation loss {best_val_loss} at epoch {epoch}")
                        ts.save_weights(name_suffix="_opt", model_idx=model_idx)
                        opt_epochs.append(epoch)
                mesh.barrier(group)
                validate_ms.append((time.perf_counter() - t) * 1e3)
                clock.restart()
        if writer:
            ts.load_specific_weights(c.checkPointName, model_idx)
        mesh.broadcast_state(ts, group)
        ts.epoch0 = epoch_pretrain
        out[model_idx] = {"losses": torch.stack(losses).float().cpu().numpy(),
                          "step_ms": clock.step_ms(), "validate_ms": validate_ms,
                          "opt_epochs": opt_epochs}
    ts.train_dataset.num_samples = c.samples
    if writer:
        print("pre-training finished", flush=True)
    return out


def train(ts: TrainState, group=None) -> dict:
    """The training loop from ts.epoch0 to ts.epochs - 1, with its
    checkpoint, render, video and validation legs. Returns per-step losses
    (steps, nets), step times in ms (the legs excluded) and the legs' own
    times in ms: {"render": [...], "video": [...], "validate": [...]}, and
    the validation passes' images. In a group each rank gathers and steps
    on its slice of every image's rays (``mesh.shard_train_step``); rank 0
    alone saves and runs the legs while the others wait at a barrier."""
    c = ts.config_file
    writer = mesh.rank_and_size(group)[0] == 0
    step = mesh.shard_train_step(ts, group)
    rays = None if group is None else mesh.local_batch_slice(group, c.samples)
    n_images = len(ts.train_dataset)
    batch_images = c.batchImages if c.batchImages != -1 else n_images
    seed = c.randomSeed if c.randomSeed != -1 else 0
    best_val_loss = sys.float_info.max if ts.best_valid_loss is None else ts.best_valid_loss
    prefetcher = BatchPrefetcher(
        lambda idx: ts.assemble_train_batch(ts.train_dataset, idx, rays),
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
                if writer:
                    print(f"epoch={epoch:<10} losses=[{', '.join(f'{v:.8f}' for v in vals)}] "
                          f"({time.perf_counter() - t0:.1f}s)", flush=True)
            if epoch % c.epochsCheckpoint == 0 and epoch > 0 and writer:
                ts.save_weights(name_suffix=f"{epoch:07d}",
                                params_only=bool(c.checkpointParamsOnly))
            render = epoch % c.epochsRender == 0 and epoch > 0
            video = c.epochsVideo >= 0 and epoch % c.epochsVideo == 0 and epoch > 0
            validate = epoch % c.epochsValidate == 0 and epoch > 0 and (
                c.adaptiveSamplingThreshold > 0.0
                or epoch > c.lossBlendingStart + c.lossBlendingDuration
                or c.lossBlendingStart > ts.epochs)
            if writer and render:
                leg("render", render_img, ts, 0, ts.valid_dataset, img_name=f"{epoch:07d}")
            if writer and video:
                leg("video", render_video, ts, vid_name=f"{epoch:07d}")
            if writer and validate:
                val_loss, img_data = leg("validate", validate_batch, ts, epoch, loss_host)
                if val_loss < best_val_loss:
                    best_val_loss = val_loss
                    _save_opt(ts, epoch, val_loss, img_data)
                    # (the JAX package copies an epoch's mp4 videos to _opt;
                    # the port writes frames, which it does not copy)
                    if not video and c.epochsVideo >= 0:
                        leg("video", render_video, ts, vid_name="_opt")
            if render or video or validate:
                mesh.barrier(group)
                clock.restart()
    finally:
        prefetcher.close()
    return {"losses": torch.stack(losses).cpu().numpy() if losses else np.zeros((0, 0)),
            "step_ms": clock.step_ms(), "legs_ms": legs}


def run(config, group=None) -> dict:
    """Train ``config`` as one rank of ``group`` (None: alone), save and,
    with ``performEvaluation``, evaluate (rank 0). Returns the train-loop
    statistics, the pretraining's (``pretrain``), the paths of the final
    checkpoint (none on other ranks), the evaluation's time in ms, the
    rank, the group's size and the TrainState."""
    rank, world = mesh.rank_and_size(group)
    ts = TrainState()
    ts.initialize(config, writes=rank == 0)
    if rank == 0:
        ts.load_latest_weights()
    mesh.broadcast_state(ts, group)
    try:
        routes = ts.train_apply_fns() or [None] * len(ts.models)
    except ValueError as err:  # a NeRF shape K3 does not take yet
        raise SystemExit(f"adanerf_tpu_torch.train: not supported yet:\n  {err}") from err
    if rank == 0:
        print(f"Training config: {ts.logDir.rstrip('/').split('/')[-1]} ({config.config}) on "
              f"{ts.device}; epochs {ts.epoch0}..{ts.epochs - 1}; " + ", ".join(
                  f"{m.name}: {'K3 kernel' if r is not None else 'plain'}"
                  for m, r in zip(ts.models, routes)), flush=True)
        if group is not None:
            print(f"data-parallel over {world} ranks (rays axis, {dist.get_backend(group)}), "
                  f"{config.samples // world} of each image's {config.samples} rays a rank",
                  flush=True)
    k3 = None
    if any(r is not None for r in routes):
        from .ops.kernels.nerf_train import NerfTrainKernel as k3
        launched = (k3.forward_launches, k3.backward_launches)
    pretrain = pre_train(ts, group)
    stats = train(ts, group)
    stats["pretrain"] = pretrain
    if k3 is not None and rank == 0:  # a supervised run's log shows its route at work
        print(f"K3 launches: forward {k3.forward_launches - launched[0]}, backward "
              f"{k3.backward_launches - launched[1]} in {len(stats['losses'])} steps",
              flush=True)
    stats["checkpoint"] = ts.save_weights(name_suffix=f"{ts.epochs - 1:07d}") if rank == 0 else []
    mesh.barrier(group)
    if config.performEvaluation and rank == 0:
        from .evaluation.evaluate import evaluate
        t = time.perf_counter()
        ts.load_specific_weights(config.checkPointName.replace(".weights", ""))
        evaluate(ts, None, ["complexity", "images", "flip", "psnr", "output_images"])
        _sync(ts.device)
        stats["evaluate_ms"] = (time.perf_counter() - t) * 1e3
    stats.update(state=ts, rank=rank, world=world)
    return stats


def _rank_main(rank, group, device, argv):
    """A rank the trainer started (``mesh.spawn_ranks``)."""
    config = Config.init(argv=argv)
    config.device = str(device)
    run(config, group)


def main(argv=None) -> dict:
    """Parse ``argv`` (default: the command line) and train (``run``): in
    the launcher's group, in a group of this host's devices that this
    process starts and joins as rank 0, or alone. Returns rank 0's (this
    process's) ``run`` statistics."""
    argv = sys.argv[1:] if argv is None else list(argv)
    config = Config.init(argv=argv)
    early = unsupported(config)
    if early:  # refuse before loading any data
        raise SystemExit("adanerf_tpu_torch.train: refused:\n  " + "\n  ".join(early))
    launch = mesh.launcher_env()
    if launch is not None:
        mesh.init_multi_host(device=config.device)
        config.device = str(mesh.rank_device(config.device, launch["rank"],
                                             launch["local_rank"]))
        done = False
        try:
            stats = run(config, mesh.make_mesh(config.meshDevices))
            done = True
            return stats
        finally:
            mesh.leave_group(in_step=done)
    world = mesh_size(config)
    if world == 1:
        return run(config)
    dev = parse_device(config.device)
    devices = [torch.device("cpu")] * world if dev.type == "cpu" else \
        [torch.device("cuda", i) for i in range(world)]
    if dev.type == "cuda" and config.bf16 and config.fusedTrainKernel:
        from .ops.kernels import build, nerf_train
        build.build(sorted({lib for a, w, d, enc in zip(config.activation, config.layerWidth,
                                                        config.layers, config.posEncArgs)
                            if a == "nerf" and w % 128 == 0
                            for lib in nerf_train.libraries(w, sum(
                                6 * int(f) + 3 for f in enc.split("-")), d)}))  # before the ranks
    init = mesh.rendezvous(config.logDir)
    procs = mesh.spawn_ranks(_rank_main, (argv,), devices, init, first=1)
    watching = mesh.watch_ranks(procs)
    try:
        group = mesh.join_group(0, devices, init)
        config.device = str(devices[0])
        stats = run(config, group)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    watching.set()
    mesh.join_ranks(procs, timeout=600.0)
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
