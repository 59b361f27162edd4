"""Ray-data-parallel training: one process per GPU, each batch's rays split
over a group of ranks.

Counterpart of ``adanerf_tpu/parallel/mesh.py``. The JAX package shards
every ray-indexed batch array over a 1-D ``("rays",)`` mesh under one
global-view jit, which inserts the gradient all-reduce itself. Here each
rank is a process with a device of its own (``torch.distributed``: NCCL
when every rank has a GPU of its own, gloo on the CPU or when ranks share
a card, whose CUDA tensors gloo reduces through the host). Parameters and
Adam state are replicated. Every rank draws the same global pixel picks
from the shared seed and gathers the same contiguous slice of every
image's rays into every ray-indexed array (``local_batch_slice``), so its
arrays pair the same (image, ray) couples; it runs the cascade, the losses
and their gradients on its rays (the NeRF through K3 on a CUDA device),
and the group sums the gradients of every net and the per-net losses in
one flat ``all_reduce`` and divides them by its size. With equal shards
that mean of per-rank means is the whole batch's mean (a ratio-of-sums
loss sums its denominator over the group: ``losses.CrossEntropyLoss``).
Each rank then applies the same Adam step.

Launch, one of:
  python -m adanerf_tpu_torch.train ... --meshDevices -1        # every local GPU
  python -m adanerf_tpu_torch.train ... --device cpu --meshDevices 2   # 2 gloo ranks
  torchrun --nproc_per_node N -m adanerf_tpu_torch.train ...
  ADANERF_COORD=<host0>:<port> ADANERF_NPROC=<N> ADANERF_PROC_ID=<i> \\
      python -m adanerf_tpu_torch.train ... --meshDevices -1    # one line a process
Without a launcher the trainer starts one process per device itself
(``spawn_ranks``, a ``file://`` rendezvous in the log directory) and is
rank 0.
"""

from __future__ import annotations

import datetime
import os
import sys
import threading
import time
from multiprocessing.connection import wait
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..pipeline.keys import DatasetKeys

# how long a rank waits at a barrier or a collective: rank 0 alone runs the
# render, video and validation legs while the others wait
TIMEOUT = datetime.timedelta(minutes=30)


def launcher_env() -> Optional[Dict]:
    """The group a launcher describes in the environment: the JAX
    package's ``ADANERF_COORD`` (host:port), ``ADANERF_NPROC`` and
    ``ADANERF_PROC_ID``, or torchrun's ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``. None when neither names
    more than one process."""
    env = os.environ
    if env.get("ADANERF_COORD"):
        out = {"coord": env["ADANERF_COORD"], "world": int(env.get("ADANERF_NPROC", "1")),
               "rank": int(env.get("ADANERF_PROC_ID", "0")), "local_rank": None}
    elif env.get("WORLD_SIZE") and env.get("MASTER_ADDR"):
        out = {"coord": f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}",
               "world": int(env["WORLD_SIZE"]), "rank": int(env.get("RANK", "0")),
               "local_rank": int(env["LOCAL_RANK"]) if env.get("LOCAL_RANK") else None}
    else:
        return None
    return out if out["world"] > 1 else None


def rank_device(device, rank: int, local_rank: Optional[int] = None) -> torch.device:
    """The device of a launched rank: the CPU for ``--device cpu``, else the
    GPU of its local rank (torchrun's ``LOCAL_RANK``, or the rank modulo the
    host's GPU count)."""
    dev = torch.device(f"cuda:{device}" if str(device).isdigit() else device)
    if dev.type != "cuda":
        return dev
    if local_rank is None:
        local_rank = rank % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", local_rank)


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a GPU of its own, else gloo (CPU ranks, or
    ranks sharing a card: NCCL takes one rank a GPU)."""
    devices = [torch.device(d) for d in devices]
    cuda = [d.index for d in devices if d.type == "cuda"]
    return "nccl" if len(cuda) == len(devices) and len(set(cuda)) == len(cuda) else "gloo"


def _use_device(dev: torch.device, world_on_cpu: int = 0):
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    elif world_on_cpu > 1:  # CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_on_cpu))


def init_multi_host(device="cpu") -> int:
    """Join the group a launcher describes (``launcher_env``) before
    anything touches the device; returns this process's rank. A
    single-process run sets up nothing and returns 0. The rank's device
    (``rank_device``) becomes the current CUDA device."""
    if dist.is_initialized():
        return dist.get_rank()
    launch = launcher_env()
    if launch is None:
        return 0
    dev = rank_device(device, launch["rank"], launch["local_rank"])
    _use_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{launch['coord']}", world_size=launch["world"],
                            rank=launch["rank"], timeout=TIMEOUT)
    return launch["rank"]


def leave_group(in_step: bool = True):
    """End this process's part in the group ``init_multi_host`` joined:
    a barrier, then ``destroy_process_group``. Rank 0 hosts the ``tcp://``
    store, so it leaves last: it keeps the store up until every other rank
    has destroyed its group and said so through the store (a rank whose
    store goes while its c10d threads run aborts at exit). ``in_step``
    False (this rank failed, the others may never reach the barrier) only
    destroys the group. Nothing to do without a group."""
    if not dist.is_initialized():
        return
    if not in_step:
        dist.destroy_process_group()
        return
    store = dist.distributed_c10d._get_default_store()  # outlives the group below
    rank, world = dist.get_rank(), dist.get_world_size()
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        store.wait([f"left/{r}" for r in range(1, world)], TIMEOUT)
    else:
        store.set(f"left/{rank}", "1")


def make_mesh(n_devices: int = -1):
    """The group of ranks that trains: the default group of a run that
    joined one (``init_multi_host``, ``spawn_ranks``), None on a single
    process, whose step is the one-process step. ``n_devices`` -1 takes
    every rank; any other count must be the group's size (JAX truncates its
    mesh to it; the port refuses, as its frames refuse a ``--mesh`` above
    the device count)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices not in (-1, world):
        raise ValueError(f"--meshDevices {n_devices}: the run has {world} rank(s)")
    return dist.group.WORLD if world > 1 else None


def rank_and_size(group):
    """(rank, size) of ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def local_batch_slice(group, n_rays: int) -> slice:
    """The [start, stop) of each image's ``n_rays`` rays that this rank
    gathers: contiguous, equal, in rank order. Rays that do not divide by
    the group's size are refused, as JAX asserts."""
    rank, world = rank_and_size(group)
    if n_rays % world:
        raise ValueError(f"{n_rays} rays per image do not split over {world} ranks")
    per = n_rays // world
    return slice(rank * per, (rank + 1) * per)


def slice_batch(batch: Dict, targets: Dict, rays: slice):
    """The rays ``rays`` of every image of a whole batch (numpy arrays or
    tensors): ``ray_directions_samples`` (n_img, R, 3) on its ray axis,
    every other ray-indexed array, (n_img * R, ...) image-major, on the same
    (image, ray) pairs; the per-image pose and rotation whole."""
    n_img, n_rays = batch[DatasetKeys.ray_directions_samples].shape[:2]

    def cut(v):
        rest = tuple(v.shape[1:])
        return v.reshape((n_img, n_rays) + rest)[:, rays].reshape((-1,) + rest)

    out = {}
    for k, v in batch.items():
        if k in (DatasetKeys.image_pose, DatasetKeys.image_rotation):
            out[k] = v
        elif k == DatasetKeys.ray_directions_samples:
            out[k] = v[:, rays]
        else:
            out[k] = cut(v)
    return out, {i: cut(v) for i, v in targets.items()}


def shard_loss_and_grads(ts, group):
    """``fn(batch, targets, epoch) -> (per-net losses, per-net grads)``:
    ``TrainState.make_loss_and_grads`` on this rank's rays (its jitter
    drawn over the whole batch, a ratio-of-sums loss over the group's
    rays), the gradients of every net and the losses then averaged over
    the group in one flat ``all_reduce``. ``group`` None is the
    one-process function."""
    rank, world = rank_and_size(group)
    if group is not None:
        ts.ray_shard = (rank, world)
        for crit in ts.losses:
            if hasattr(crit, "group"):
                crit.group = group
    local = ts.make_loss_and_grads()
    if group is None:
        return local

    def loss_and_grads(batch, targets, epoch):
        per_net, grads = local(batch, targets, epoch)
        leaves = [(i, k, g) for i, gi in enumerate(grads) for k, g in gi.items()]
        flat = torch.cat([g.reshape(-1) for _, _, g in leaves]
                         + [torch.stack(per_net).to(leaves[0][2].dtype)])
        dist.all_reduce(flat, group=group)
        flat /= world
        out = [dict() for _ in grads]
        at = 0
        for i, k, g in leaves:
            out[i][k] = flat[at:at + g.numel()].view(g.shape)
            at += g.numel()
        return list(flat[at:].unbind()), out

    return loss_and_grads


def shard_train_step(ts, group):
    """``step(batch, targets, epoch) -> per-net losses``: the data-parallel
    train step (``shard_loss_and_grads``, then every rank's Adam update in
    place), the counterpart of JAX's sharded jit. ``group`` None is
    ``TrainState.make_train_step``."""
    loss_and_grads = shard_loss_and_grads(ts, group)

    def step(batch, targets, epoch):
        per_net, grads = loss_and_grads(batch, targets, epoch)
        ts.apply_updates(grads, epoch)
        return per_net

    return step


def broadcast_state(ts, group, src: int = 0):
    """Rank ``src``'s parameters, Adam states and start epoch on every rank
    (after it resumed or loaded a checkpoint that the others need not
    see)."""
    if group is None:
        return
    tensors = []
    for m, s in zip(ts.models, ts.opt_states):
        tensors += list(m.state_dict().values()) + list(s.mu.values()) + list(s.nu.values())
    flat = torch.cat([t.reshape(-1) for t in tensors])
    counts = torch.tensor([s.count for s in ts.opt_states] + [ts.epoch0], dtype=torch.int64,
                          device=flat.device)
    dist.broadcast(flat, src=src, group=group)
    dist.broadcast(counts, src=src, group=group)
    at = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()
    for s, c in zip(ts.opt_states, counts.tolist()):
        s.count = c
    ts.epoch0 = int(counts[-1])


def barrier(group):
    """Wait for every rank of ``group`` (nothing for None)."""
    if group is None:
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def rendezvous(directory: str) -> str:
    """A ``file://`` rendezvous of a new group in ``directory`` (a name no
    earlier group used: a file store must start empty)."""
    os.makedirs(directory, exist_ok=True)
    return "file://" + os.path.join(os.path.abspath(directory),
                                    f".rendezvous-{os.getpid()}-{time.time_ns()}")


def join_group(rank: int, devices: Sequence, init_method: str):
    """Join the group of ``len(devices)`` ranks as rank ``rank`` on
    ``devices[rank]``; returns the group."""
    devices = [torch.device(d) for d in devices]
    _use_device(devices[rank], sum(d.type == "cpu" for d in devices))
    dist.init_process_group(backend_for(devices), init_method=init_method,
                            world_size=len(devices), rank=rank, timeout=TIMEOUT)
    return dist.group.WORLD


def _rank_entry(fn, rank, devices, init_method, args):
    group = join_group(rank, devices, init_method)
    try:
        fn(rank, group, torch.device(devices[rank]), *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, args: tuple, devices: Sequence, init_method: str,
                first: int = 0) -> List:
    """Start ranks ``first .. len(devices) - 1``, one process each (the
    ``spawn`` start method), each calling ``fn(rank, group, device,
    *args)`` in the group. The processes are daemons: they end with the
    process that started them. ``first`` 1 leaves rank 0 to the caller
    (``join_group``)."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = []
    for rank in range(first, len(devices)):
        p = ctx.Process(target=_rank_entry, daemon=True,
                        args=(fn, rank, [str(d) for d in devices], init_method, args))
        p.start()
        procs.append(p)
    return procs


def join_ranks(procs: List, timeout: float):
    """Wait for the processes of ``spawn_ranks``. When one fails, or any
    still runs after ``timeout`` seconds, all are killed and RuntimeError
    (TimeoutError) is raised: a rank that died would leave the others
    waiting at their next collective."""
    def failed():
        return [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode not in (None, 0)]

    deadline = time.monotonic() + timeout
    while any(p.is_alive() for p in procs) and not failed() and time.monotonic() < deadline:
        wait([p.sentinel for p in procs if p.is_alive()], timeout=1.0)
    bad, alive = failed(), any(p.is_alive() for p in procs)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    if bad:
        raise RuntimeError(f"rank process(es) failed (index, exit code): {bad}")
    if alive:
        raise TimeoutError(f"a rank did not finish within {timeout} s")


def watch_ranks(procs: List) -> threading.Event:
    """Watch the ranks this process started while it is a rank itself:
    when one exits with an error the run is over (this rank would wait for
    it at its next collective), so this process ends too, with exit code
    1. Set the returned event to stop watching."""
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            wait([p.sentinel for p in procs], timeout=1.0)
            bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if bad and not stop.is_set():
                print(f"a rank process exited with code {bad[0]}: ending the run",
                      file=sys.stderr, flush=True)
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    return stop


def run_ranks(fn: Callable, args: tuple, devices: Sequence, workdir: str,
              timeout: float = 600.0):
    """Run ``fn(rank, group, device, *args)`` in one process per entry of
    ``devices`` (a list may name one device more than once: its ranks
    share it through gloo) and wait for all of them."""
    join_ranks(spawn_ranks(fn, args, devices, rendezvous(workdir)), timeout)
