"""Training entry point of the port:

  python -m adanerf_tpu_torch.train -c configs/dense_training.ini \\
      -data <scene> -log <dir> --bf16 [--device cpu] [flags]

Counterpart of the JAX package's root ``train.py``: initialize, resume (or
bootstrap from a dense teacher), the training loop with periodic
checkpoints every ``epochsCheckpoint`` epochs, and a final save. On a CUDA
device with ``--bf16`` the shading MLP's forward and backward run through
the K3 kernel.

Refused before step 0, each naming its ROADMAP item: GT pretraining
(``epochsPretrain`` > 0), an epoch range that reaches an ``epochsRender``,
``epochsValidate`` or ``epochsVideo`` point, ``--performEvaluation``, and
``--meshDevices`` > 1 (rendering, validation and evaluation belong to a
later slice; the port trains on one device), and a NeRF that the JAX
package would train through its TPU kernel but K3 does not take yet (a
width other than 256) on a run that asks for K3.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .config import Config
from .data.prefetch import BatchPrefetcher, epoch_image_indices
from .train_state import TrainState, parse_device


def _first_point(every: int, start: int, end: int):
    """The first epoch e in [start, end) with e > 0 and e % every == 0."""
    if every <= 0:
        return None
    e = max(start, 1)
    e += (-e) % every
    return e if e < end else None


def unsupported(config, epoch0: int, epochs: int) -> list:
    """What this run asks for that the port cannot do yet, one message each."""
    out = []
    if config.epochsPretrain and max(config.epochsPretrain) > 0:
        out.append(f"epochsPretrain {config.epochsPretrain}: GT pretraining "
                   "(make_pretrain_step) is not ported yet (ROADMAP Queue 1, item 5)")
    for flag, every in (("epochsRender", config.epochsRender),
                        ("epochsValidate", config.epochsValidate),
                        ("epochsVideo", config.epochsVideo)):
        e = _first_point(every, epoch0, epochs)
        if e is not None:
            out.append(f"--{flag} {every}: epoch {e} of this run reaches it; rendering, "
                       "validation and video are not ported yet (ROADMAP Queue 1, items "
                       "10-11); pass a value beyond --epochs")
    if config.performEvaluation:
        out.append("--performEvaluation: evaluation is not ported yet (ROADMAP Queue 1, "
                   "item 11); pass --no-performEvaluation")
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
    no per-step synchronisation), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self):
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def train(ts: TrainState) -> dict:
    """The training loop from ts.epoch0 to ts.epochs - 1. Returns per-step
    losses (steps, nets) and step times in ms."""
    c = ts.config_file
    step = ts.make_train_step()
    n_images = len(ts.train_dataset)
    batch_images = c.batchImages if c.batchImages != -1 else n_images
    seed = c.randomSeed if c.randomSeed != -1 else 0
    prefetcher = BatchPrefetcher(
        lambda idx: ts.assemble_train_batch(ts.train_dataset, idx),
        epoch_image_indices(n_images, batch_images, ts.epochs - ts.epoch0 + 1, seed))
    clock = _StepClock(ts.device)
    losses = []
    t0 = time.perf_counter()
    try:
        clock.mark()
        for epoch in range(ts.epoch0, ts.epochs):
            batch, targets = next(prefetcher)
            per_net = step(batch, targets, epoch)
            losses.append(torch.stack(per_net))
            clock.mark()
            if not c.nonVerbose and c.verboseEvery > 0 and epoch % c.verboseEvery == 0:
                vals = ", ".join(f"{float(v):.8f}" for v in per_net)
                print(f"epoch={epoch:<10} losses=[{vals}] "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
            if epoch % c.epochsCheckpoint == 0 and epoch > 0:
                ts.save_weights(name_suffix=f"{epoch:07d}",
                                params_only=bool(c.checkpointParamsOnly))
    finally:
        prefetcher.close()
    return {"losses": torch.stack(losses).cpu().numpy() if losses else np.zeros((0, 0)),
            "step_ms": clock.step_ms()}


def main(argv=None) -> dict:
    """Parse ``argv`` (default: the command line), train, save. Returns the
    train-loop statistics, the paths of the final checkpoint and the
    TrainState."""
    config = Config.init(argv=argv)
    early = unsupported(config, 1, config.epochs) + unsupported_by_k3(config)
    if early:  # refuse before loading any data
        raise SystemExit("adanerf_tpu_torch.train: not supported yet:\n  " + "\n  ".join(early))
    ts = TrainState()
    ts.initialize(config)
    ts.load_latest_weights()
    late = unsupported(config, ts.epoch0, ts.epochs)
    if late:
        raise SystemExit("adanerf_tpu_torch.train: not supported yet:\n  " + "\n  ".join(late))
    try:
        routes = ts.train_apply_fns() or [None] * len(ts.models)
    except ValueError as err:  # a NeRF shape K3 does not take yet
        raise SystemExit(f"adanerf_tpu_torch.train: not supported yet:\n  {err}") from err
    print(f"Training config: {ts.logDir.rstrip('/').split('/')[-1]} ({config.config}) on "
          f"{ts.device}; epochs {ts.epoch0}..{ts.epochs - 1}; " + ", ".join(
              f"{m.name}: {'K3 kernel' if r is not None else 'plain'}"
              for m, r in zip(ts.models, routes)), flush=True)
    stats = train(ts)
    stats["checkpoint"] = ts.save_weights(name_suffix=f"{ts.epochs - 1:07d}")
    stats["state"] = ts
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
