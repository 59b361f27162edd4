"""The data-parallel step held against the one-process step on the same
global batches: what ``tests/test_torch_parallel.py`` checks on CPU ranks
and ``chip_smoke.py`` on the card.

``rank_steps`` runs in each rank of a group (``mesh.run_ranks``): the run
of ``argv`` on the rank's device takes ``n_steps`` data-parallel steps
(``mesh.shard_loss_and_grads`` and each rank's Adam update) and writes
``<out_dir>/rank<r>.npz``. ``one_process_steps`` takes the same steps
alone and returns the same record. Both draw the same image and pixel
picks: the batches' images from ``epoch_image_indices`` with the run's
seed, the pixels from a fresh sequence generator.

A record: ``losses`` (steps, nets), the group-averaged gradients of the
first step (``grad/<net>/<key>``, before its update), the parameters
after the last step (``param/<net>/<key>``), the step times in ms
(``step_ms``: CUDA events on a CUDA device) and, on a CUDA device, K3's
forward and backward launches and the rows of its last forward.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import Config
from ..data.prefetch import epoch_image_indices
from ..train_state import TrainState
from . import mesh


def train_state(argv, device, writes=True) -> TrainState:
    """The run of ``argv`` initialized on ``device``."""
    config = Config.init(argv=list(argv))
    config.device = str(device)
    ts = TrainState()
    ts.initialize(config, writes=writes)
    return ts


def image_batches(ts: TrainState, n_steps: int):
    """The image indices of ``n_steps`` batches, as the trainer draws them."""
    c = ts.config_file
    n = len(ts.train_dataset)
    seed = c.randomSeed if c.randomSeed != -1 else 0
    return list(epoch_image_indices(n, c.batchImages if c.batchImages != -1 else n,
                                    n_steps, seed))


def take_steps(ts: TrainState, group, n_steps: int, epoch0: int) -> dict:
    """``n_steps`` steps of ``ts`` in ``group`` (None: alone) from epoch
    ``epoch0``; returns the record."""
    cuda = ts.device.type == "cuda"
    if cuda:
        from ..ops.kernels.nerf_train import NerfTrainKernel
        NerfTrainKernel.forward_launches = NerfTrainKernel.backward_launches = 0
    rays = None if group is None else mesh.local_batch_slice(group, ts.config_file.samples)
    loss_and_grads = mesh.shard_loss_and_grads(ts, group)
    out, losses, spans = {}, [], []
    for k, idx in enumerate(image_batches(ts, n_steps)):
        batch, targets = ts.assemble_train_batch(ts.train_dataset, idx, rays)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            start = time.perf_counter()
        per_net, grads = loss_and_grads(batch, targets, epoch0 + k)
        if k == 0:
            out.update({f"grad/{i}/{n}": g.detach().cpu().numpy()
                        for i, gi in enumerate(grads) for n, g in gi.items()})
        ts.apply_updates(grads, epoch0 + k)
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        else:
            end = time.perf_counter()
        spans.append((start, end))
        losses.append(torch.stack(per_net).detach().cpu().numpy())
    if cuda:
        torch.cuda.synchronize(ts.device)
        out["step_ms"] = np.array([a.elapsed_time(b) for a, b in spans])
        out["k3_launches"] = np.array([NerfTrainKernel.forward_launches,
                                       NerfTrainKernel.backward_launches])
        out["k3_rows"] = np.array(NerfTrainKernel.forward_rows or 0)
    else:
        out["step_ms"] = np.array([(b - a) * 1e3 for a, b in spans])
    out["losses"] = np.stack(losses)
    out.update({f"param/{i}/{n}": p.detach().cpu().numpy()
                for i, m in enumerate(ts.models) for n, p in m.state_dict().items()})
    return out


def rank_steps(rank, group, device, argv, n_steps, epoch0, out_dir):
    """One rank of the check (``mesh.run_ranks``'s ``fn``)."""
    ts = train_state(argv, device, writes=rank == 0)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **take_steps(ts, group, n_steps, epoch0))


def one_process_steps(argv, device, n_steps, epoch0) -> dict:
    """The same steps in this process alone."""
    return take_steps(train_state(argv, device), None, n_steps, epoch0)


def rank_records(out_dir, world):
    """Every rank's record of a ``rank_steps`` run."""
    out = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            out.append({k: f[k] for k in f.files})
    return out
