"""Ray-sharded frames: one frame's rays cut into contiguous slices, one per
device, each rendered by its own frame kernel, with no collectives.

Counterpart of ``adanerf_tpu/parallel/render.py``. Every stage of the frame
kernels (ray setup, oracle, adaptive select, encode, the NeRF, composite)
is per ray, and K1/K2 shade each row from its own inputs and the weights
only, so a frame cut into slices renders bit for bit as the whole frame
(K1's compaction runs within each slice). ``ShardedFrame`` pads the
frame's rays to equal slices of whole ``tile``-row blocks (``frame_pad``;
the pad repeats the last ray), places each slice on its device once,
launches every slice before it synchronises anything, and gathers rgb and
counts on the first device with the padding dropped. Each device has its
own copy of the kernel's packed weights (the kernels take weights on the
rays' device). A device list may name one device more than once: the
slices then run one after the other on it, which holds the slicing on a
one-card host; the viewer's ``--mesh N`` takes N distinct devices
(``devices_mesh``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

TILE = 128  # rows of a tensor-core block of K1 and K2


def frame_pad(n_pix: int, tile: int, n_devices: int) -> int:
    """Rows the ray array is padded to: each device's slice holds a whole
    number of ``tile``-row blocks (800x800 over 8 devices at tile 256 ->
    641,024 rows, 0.16% pad)."""
    quantum = tile * n_devices
    return ((n_pix + quantum - 1) // quantum) * quantum


def devices_mesh(n_devices: int, device="cuda") -> List[torch.device]:
    """The first ``n_devices`` devices of ``device``'s type (the CPU is
    one device); more than are present is refused."""
    dev = torch.device(device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_devices > count:
        raise ValueError(f"--mesh {n_devices}: only {count} device(s) present")
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(n_devices)]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current CUDA device's index, so that one device
    compares equal however it is named."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class ShardedFrame:
    """``frame(pose, rot) -> (rgb (n, 3), counts (n,))`` of a fixed set of
    camera-space ray directions, sharded over ``devices``.

    ``kernel``: a ``MegakernelCompact`` or ``MegakernelDense``; ``dirs``:
    (n, 3) float32. On CUDA devices every slice launches its kernel (and
    counts its launch); on the CPU each slice runs the kernel's plain
    version."""

    def __init__(self, kernel, devices: Sequence, dirs: torch.Tensor, tile: int = TILE):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        self.n_pix = dirs.shape[0]
        n = len(self.devices)
        n_pad = frame_pad(self.n_pix, tile, n)
        padded = torch.cat([dirs, dirs[-1:].expand(n_pad - self.n_pix, 3)]) \
            if n_pad > self.n_pix else dirs
        per = n_pad // n
        self.kernels = {}
        for d in self.devices:
            if d not in self.kernels:
                self.kernels[d] = kernel.to(d)
        self.slices = [padded[i * per:(i + 1) * per].to(d).contiguous()
                       for i, d in enumerate(self.devices)]

    def __call__(self, pose, rot):
        outs = [self.kernels[d](s, pose, rot) for d, s in zip(self.devices, self.slices)]
        first = self.devices[0]
        rgb = torch.cat([o[0].to(first, non_blocking=True) for o in outs])[:self.n_pix]
        counts = torch.cat([o[1].to(first, non_blocking=True) for o in outs])[:self.n_pix]
        return rgb, counts
