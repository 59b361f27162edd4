"""The PNG files the port's decoder is held to, with the readings of both
JAX readers pinned.

  python tests/make_png_fixtures.py

(needs imageio, ``g++`` and libpng's headers: the CPU host) rewrites
``tests/torch_fixtures/png/``: for each case of
``png_format_writer.fixtures()``, ``<name>.png`` (the writer's bytes);
``<name>.npy``, the array ``imageio.v2.imread`` gives; ``<name>.rgb.npy``,
the RGB bytes of the JAX package's native loader
(``adanerf_tpu/native/dataloader.cpp``, compiled into a temporary
directory by ``native_loader``; its floats times 255, which are whole).
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from png_format_writer import case_file, fixtures  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "png")


def native_loader(tmp: str):
    """The JAX package's native PNG loader compiled into ``tmp``: a
    function of (path, h, w, scale) giving its (h // scale, w // scale, 3)
    float32 image, or None where it fails."""
    import ctypes
    import subprocess
    lib = os.path.join(tmp, "libadanerf_dataloader.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", lib,
                    os.path.join(ROOT, "adanerf_tpu", "native", "dataloader.cpp"),
                    "-lpng", "-lz", "-lpthread"], check=True)
    fn = ctypes.CDLL(lib).load_images_parallel
    fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                   ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int]

    def load(path: str, h: int, w: int, scale: int = 1):
        out = np.zeros((h // scale, w // scale, 3), np.float32)
        paths = (ctypes.c_char_p * 1)(path.encode())
        failed = fn(paths, 1, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    h // scale, w // scale, scale, 1)
        return None if failed else out
    return load


def write_fixtures():
    import tempfile

    import imageio.v2 as imageio
    os.makedirs(FIXTURES, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        load = native_loader(tmp)
        for name, kw in fixtures().items():
            path = os.path.join(FIXTURES, name + ".png")
            with open(path, "wb") as f:
                f.write(case_file(**kw))
            np.save(path[:-4] + ".npy", imageio.imread(path))
            np.save(path[:-4] + ".rgb.npy",
                    np.round(load(path, kw["h"], kw["w"]) * 255).astype(np.uint8))


if __name__ == "__main__":
    write_fixtures()
