"""The port's ``eval_megakernel`` held against the JAX package's
``tools/eval_megakernel.py`` on the CPU: a 40x40 copy of demo/mscene's
first two test images (``tests/torch_tool_scene.py``), rendered from
demo/trained_mscene_export, the JAX kernel in interpret mode and the port's
kernels through their plain versions; its orbit, its PNG frames and its
refusals of the TPU kernel's workarounds."""

import json
import re
import shutil

import numpy as np
import pytest

import jax

from adanerf_tpu_torch import eval_megakernel
from adanerf_tpu_torch.data.png import read_png

from torch_tool_scene import EXPORT, run_jax_tool, small_scene


def _rows(out):
    """The per-image rows and the final JSON line of a tool's stdout."""
    lines = [ln for ln in out.splitlines() if ln.strip()]
    rows = [dict(kv.split("=", 1) for kv in ln.split()) for ln in lines
            if ln.startswith("name=")]
    return rows, json.loads(lines[-1])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return small_scene(tmp_path_factory.mktemp("scene") / "mscene40")


@pytest.fixture
def jax_precision():
    """The JAX tool's --mlp-f32 sets the process-wide default matmul
    precision; put it back after the test."""
    yield
    jax.config.update("jax_default_matmul_precision", None)


@pytest.mark.parametrize("variant,flags,bar", [
    ("v5", ["--fp32-delta"], 0.05),
    ("v3", ["--fp32-delta"], 0.05),
    ("v5", ["--fp32-delta", "--mlp-f32"], 1e-4),
], ids=["k1_bf16", "k2_bf16", "k1_mlp_f32"])
def test_eval_megakernel_matches_jax(scene, variant, flags, bar, monkeypatch, capsys,
                                     jax_precision):
    argv = [EXPORT, scene, "--variant", variant] + flags
    jrows, jmean = _rows(run_jax_tool("eval_megakernel", argv, monkeypatch, capsys))
    got = eval_megakernel.main(argv + ["--device", "cpu"])
    trows, tmean = _rows(capsys.readouterr().out)
    assert tmean["n"] == jmean["n"] == 2 and len(got["frames"]) == 2
    assert [r["name"] for r in trows] == [r["name"] for r in jrows]
    half = 5e-4  # the per-image rows print 3 decimals; the mean line prints in full
    for t, j, r in zip(got["rows"], jrows, trows):
        assert set(r) == set(j)
        assert abs(t["avg_samples"] - float(j["avg_samples"])) <= half
        assert abs(t["psnr_fp32"] - float(j["psnr_fp32"])) <= 1e-4 + half
        assert abs(t["psnr_mk"] - float(j["psnr_mk"])) <= bar + half
    assert tmean["avg_samples"] == jmean["avg_samples"]  # exact: the counts are integers
    assert abs(tmean["psnr_fp32"] - jmean["psnr_fp32"]) <= 1e-4
    assert abs(tmean["psnr_mk"] - jmean["psnr_mk"]) <= bar
    if "--mlp-f32" in flags:  # the fp32 build's plain version is the fp32 renderer
        assert tmean["psnr_mk"] == tmean["psnr_fp32"]


def test_eval_megakernel_orbit_and_out(tmp_path, capsys):
    """--orbit renders in-cell poses against fp32 only, at the export's
    resolution (a copy of the export with its resolution set to 40x40);
    --out writes the kernel's frames as PNG."""
    export = tmp_path / "export"
    shutil.copytree(EXPORT, export)
    info = (export / "dataset_info.txt").read_text()
    (export / "dataset_info.txt").write_text(re.sub(r"resolution = .*", "resolution = [40, 40]",
                                                    info))
    got = eval_megakernel.main([str(export), "--orbit", "2", "--out", str(tmp_path / "out"),
                                "--device", "cpu"])
    assert [r["name"] for r in got["rows"]] == ["orbit00.png", "orbit01.png"]
    assert set(got["mean"]) == {"avg_samples", "psnr_mk_vs_fp32"}
    assert got["mean"]["psnr_mk_vs_fp32"] >= 40.0
    img = read_png(str(tmp_path / "out" / "orbit01.png"))
    assert img.shape == (40, 40, 3)
    np.testing.assert_array_equal(img, (got["frames"][1] * 255).astype(np.uint8))


@pytest.mark.parametrize("flag,words", [
    (["--pack-f32"], "--pack-f32"), (["--oracle-split"], "--oracle-split"),
    (["--nerf-split"], "--nerf-split"), (["--tile", "128"], "--tile 128")])
def test_eval_megakernel_refuses_the_tpu_workarounds(scene, flag, words):
    with pytest.raises(SystemExit, match=words):
        eval_megakernel.main([EXPORT, scene, "--device", "cpu"] + flag)
