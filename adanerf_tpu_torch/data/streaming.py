"""Streaming view-cell dataset for splits that exceed the host's memory
budget.

Counterpart of ``adanerf_tpu/data/streaming.py``. A bounded LRU image
store sits behind the same per-image indexing the fully loaded
``ViewCellDataset`` offers (``color_images[idx]``, ``depth_images[idx]``):
a frame is decoded (``data/png.py``, as the fully loaded split reads it)
on first touch, and the least
recently used frames are dropped once the byte budget is reached, so the
batch assembly, the renderer and the evaluation run unchanged on scenes of
any size. The trainer's ``BatchPrefetcher`` thread overlaps the decodes
with the step.

Policy (``dataset.load_dataset_split``): the fully loaded split wherever
it fits the budget, this store where it does not, unless
``--storeFullData`` asks for the fully loaded split. The budget is half of
the host's available memory, or ``ADANERF_HOST_MEM_BUDGET_MB``.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import numpy as np

from .dataset import DatasetInfo, ViewCellDataset
from .png import read_png


class LazyImageStore:
    """Bounded LRU cache of per-frame arrays behind ``store[idx]``.

    Offers enough of an ndarray (``__getitem__`` with an index or an array
    of indices, ``__len__``, ``shape``) for the fully loaded code paths."""

    def __init__(self, n_items: int, item_shape: Tuple[int, ...],
                 load_fn: Callable[[int], np.ndarray], max_bytes: int):
        self.n_items = n_items
        self.item_shape = tuple(item_shape)
        self._load = load_fn
        item_bytes = int(np.prod(item_shape)) * 4
        # at least two resident frames: a batch gathers from its images in turn
        self.max_items = max(2, int(max_bytes // max(item_bytes, 1)))
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self.loads = 0  # decodes so far

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.n_items,) + self.item_shape

    def __len__(self) -> int:
        return self.n_items

    def __getitem__(self, index) -> np.ndarray:
        if np.ndim(index):  # an array of frames, stacked
            return np.stack([self[i] for i in np.asarray(index).reshape(-1)])
        index = int(index)
        if index < 0:
            index += self.n_items
        if not 0 <= index < self.n_items:
            raise IndexError(index)
        with self._lock:
            if index in self._cache:
                self._cache.move_to_end(index)
                return self._cache[index]
        img = np.ascontiguousarray(self._load(index), dtype=np.float32)
        if img.shape != self.item_shape:
            raise ValueError(f"frame {index}: expected {self.item_shape}, got {img.shape}")
        with self._lock:
            self.loads += 1
            self._cache[index] = img
            while len(self._cache) > self.max_items:
                self._cache.popitem(last=False)
        return img

    @property
    def resident(self) -> int:
        with self._lock:
            return len(self._cache)


class StreamingViewCellDataset(ViewCellDataset):
    """``ViewCellDataset`` whose image arrays are bounded LRU stores: the
    same constructor and interface, another residency policy."""

    def __init__(self, config, dataset_info: DatasetInfo, set_name="train",
                 num_samples=2048, max_bytes: Optional[int] = None):
        super().__init__(config, dataset_info, set_name, num_samples, load_images=False)
        if max_bytes is None:
            max_bytes = host_memory_budget_bytes()
        # the budget is split: colour always, depth where there is any
        has_depth = self.load_depth and any(p is not None for p in self._depth_sources())
        per_store = max_bytes // (2 if has_depth else 1)
        if self.num_items > 0:
            self.color_images = LazyImageStore(self.num_items, (self.h, self.w, 3),
                                               self._decode_color, per_store)
        if has_depth:
            self.depth_images = LazyImageStore(self.num_items, (self.h, self.w, 1),
                                               self._decode_depth, per_store)

    def _depth_sources(self) -> List[Optional[Tuple[str, str]]]:
        """Each frame's depth source (kind, path), in the fully loaded
        split's order of precedence: the exported NeRF's depth, then the GT
        ``*_depth.npz``."""
        if getattr(self, "_depth_source_cache", None) is None:
            sources = []
            for file_name in self.image_filenames:
                base = file_name[:-len(".png")]
                src = None
                nerf_depth = base + "_QuantizedWeights_lo_nSD.raw"
                if self.config.useNerfDepthMap and os.path.exists(nerf_depth):
                    src = ("nerf", nerf_depth)
                elif os.path.exists(base + "_depth.npz"):
                    src = ("gt", base + "_depth.npz")
                sources.append(src)
            self._depth_source_cache = sources
        return self._depth_source_cache

    def _decode_color(self, index: int) -> np.ndarray:
        file_name = self.image_filenames[index]
        return self._color_image(read_png(file_name, rgb=True), file_name)

    def _decode_depth(self, index: int) -> np.ndarray:
        src = self._depth_sources()[index]
        if src is None:
            return np.zeros((self.h, self.w, 1), np.float32)
        kind, path = src
        if kind == "nerf":
            return self.load_exported_nerf_depth(path)[0]
        return self.load_depth_image(path)[0]


def host_memory_budget_bytes() -> int:
    """The host memory budget for decoded images:
    ``ADANERF_HOST_MEM_BUDGET_MB`` where set, else half of MemAvailable (8
    GiB where that cannot be read)."""
    env = os.environ.get("ADANERF_HOST_MEM_BUDGET_MB")
    if env:
        return int(float(env) * (1 << 20))
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024 // 2
    except OSError:
        pass
    return 8 << 30


def split_fits_in_memory(config, dataset_info: DatasetInfo, set_name: str) -> bool:
    """Does the split's decoded footprint fit the host budget?"""
    try:
        with open(os.path.join(config.data, f"transforms_{set_name}.json")) as f:
            n = len(json.load(f)["frames"])
    except (OSError, KeyError, ValueError):
        return True
    per_frame = dataset_info.w * dataset_info.h * 3 * 4
    if config.trainWithGTDepth or config.useNerfDepthMap:
        per_frame += dataset_info.w * dataset_info.h * 4
    return n * per_frame <= host_memory_budget_bytes()
