"""The port imports nothing of JAX or of the JAX package: the machine that
runs it on the GPU has no jax, optax, imageio, matplotlib, tqdm, OpenCV,
PIL or pandas, and modules of adanerf_tpu import jax indirectly
(adanerf_tpu/platform.py, the package __init__ files), matplotlib
(adanerf_tpu/utils/saveimage.py) or cv2 (adanerf_tpu/evaluation/iw_ssim.py).
The same holds for tests/png_format_writer.py, which chip_smoke.py
imports."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRITER = os.path.join(ROOT, "tests", "png_format_writer.py")
FORBIDDEN = ("jax", "jaxlib", "adanerf_tpu", "optax", "imageio", "matplotlib", "tqdm", "cv2",
             "pandas", "PIL")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"), WRITER]
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


# the port's counterparts of the JAX package's tools and scene makers: run
# where there is no jax, imageio or PIL
TOOLS = ["eval_megakernel", "precision_study", "probe_threshold", "probe_oracle_ranks",
         "diagnose_tscene", "make_synthetic_scene", "make_llff_scene", "utils.synthetic",
         "supervise_train", "pipelines", "data.jpeg", "data.png"]
BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import importlib
importlib.import_module("adanerf_tpu_torch." + {module!r})
"""


@pytest.mark.parametrize("module", TOOLS)
def test_tools_import_without_the_jax_stack(module):
    """Each tool is among the guarded files, and imports in a process where
    importing any of FORBIDDEN fails."""
    import subprocess
    import sys
    path = os.path.join(ROOT, "adanerf_tpu_torch", *module.split(".")) + ".py"
    assert path in _port_files()
    proc = subprocess.run([sys.executable, "-c", BLOCKER.format(forbidden=set(FORBIDDEN),
                                                                module=module)],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_png_format_writer_imports_without_the_jax_stack():
    import subprocess
    import sys
    code = BLOCKER.split("import importlib\nimportlib")[0] + \
        f"sys.path.insert(0, {os.path.dirname(WRITER)!r})\nimport png_format_writer\n"
    proc = subprocess.run([sys.executable, "-c", code.format(forbidden=set(FORBIDDEN))],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
