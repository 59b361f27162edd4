"""The port's ``diagnose_tscene`` against the JAX package's
``tools/diagnose_tscene.py`` on the CPU, on the committed demo/tscene
runs (demo/tlogs/tscene, dense and fine) at a stride of 193 rays: every
number of the three decompositions as the JAX tool prints it, within its
printed precision or 1e-4 of its size."""

import importlib.util
import os
import re
import sys

import numpy as np

from adanerf_tpu_torch import diagnose_tscene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--data", os.path.join(ROOT, "demo", "tscene"), "--log",
        os.path.join(ROOT, "demo", "tlogs"), "--stride", "193"]
NUMBER = re.compile(r"[-+]?\d+\.\d+")


def _numbers(out):
    """(value, half a unit of its last printed place) of every decimal
    number printed after the two run paths."""
    body = out[out.index("== 0."):]
    return [(float(m), 0.5 * 10.0 ** -len(m.split(".")[1])) for m in NUMBER.findall(body)]


def test_diagnose_tscene_matches_jax(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "jax_diagnose_tscene", os.path.join(ROOT, "tools", "diagnose_tscene.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["diagnose_tscene"] + ARGV)
    tool.main()
    want = capsys.readouterr().out
    results = diagnose_tscene.main(ARGV + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert "rendered 830 rays" in got and got.count("== ") == 4
    assert [ln.split(":")[0] for ln in got.splitlines()] == \
        [ln.split(":")[0] for ln in want.splitlines()]
    g, w = _numbers(got), _numbers(want)
    assert len(g) == len(w) > 20
    for (a, ha), (b, hb) in zip(g, w):
        assert abs(a - b) <= ha + hb + 1e-4 * abs(b), (a, b)
    gt, rgb, _, _ = results["fine"]
    assert gt.shape == rgb.shape == (830, 3) and np.isfinite(rgb).all()
