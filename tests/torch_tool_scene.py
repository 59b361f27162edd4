"""Helpers of the tool tests (``tests/test_torch_eval_tools.py``,
``tests/test_torch_precision_tools.py``): a 40x40 copy of demo/mscene's
first two test images, and the JAX package's tools run in this process."""

import importlib.util
import json
import os
import sys

import numpy as np

from adanerf_tpu_torch.data.png import read_png, write_png
from adanerf_tpu_torch.utils.resize import resize_area

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORT = os.path.join(ROOT, "demo", "trained_mscene_export")
SIZE = 40
N_RAYS = 4096


def small_scene(d):
    """demo/mscene's first two test images at 40x40 (area resize) in
    ``d`` (a pathlib.Path), with its JSON files and the resolution
    rewritten; returns the scene's path."""
    src = os.path.join(ROOT, "demo", "mscene")
    (d / "test").mkdir(parents=True)
    with open(os.path.join(src, "dataset_info.json")) as f:
        info = json.load(f)
    info["resolution"] = [SIZE, SIZE]
    (d / "dataset_info.json").write_text(json.dumps(info))
    with open(os.path.join(src, "transforms_test.json")) as f:
        frames = json.load(f)["frames"][:2]
    (d / "transforms_test.json").write_text(json.dumps({"frames": frames}))
    for fr in frames:
        img = read_png(os.path.join(src, fr["file_path"][2:] + ".png"))[..., :3]
        small = np.round(resize_area(img, SIZE, SIZE)).clip(0, 255).astype(np.uint8)
        write_png(str(d / (fr["file_path"][2:] + ".png")), small)
    return str(d)


def run_jax_tool(name, argv, monkeypatch, capsys):
    """stdout of ``tools/<name>.py``'s ``main`` run here with ``argv``."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out
