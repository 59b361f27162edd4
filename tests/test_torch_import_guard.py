"""The port imports nothing of JAX or of the JAX package: the machine that
runs it on the GPU has no jax, optax, imageio, matplotlib, tqdm, OpenCV or
pandas, and modules of adanerf_tpu import jax indirectly
(adanerf_tpu/platform.py, the package __init__ files), matplotlib
(adanerf_tpu/utils/saveimage.py) or cv2 (adanerf_tpu/evaluation/iw_ssim.py)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "adanerf_tpu", "optax", "imageio", "matplotlib", "tqdm", "cv2",
             "pandas")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, names in os.walk(os.path.join(ROOT, "adanerf_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_port_has_files():
    assert len(_port_files()) > 10


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
