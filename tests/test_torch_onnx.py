"""The port's ONNX writer and reader, its reader of the reference's torch
checkpoints and the two converter CLIs, against the JAX package's, on the
CPU:

* ``utils/onnx_export.py`` writes the same bytes as the JAX writer on the
  same fp32 weights, for the oracle with and without a skip input and for
  the NeRF with one or two skips;
* ``load_onnx_weights`` reads JAX-written and port-written files into equal
  dicts (every array bit for bit), and reads a hand-encoded model with
  packed and unpacked dims, raw and ``float_data`` tensors, as
  ``tests/test_onnx_weights.py`` does for the JAX reader;
* ``torch_ckpt`` turns ``torch.save``d BaseNet and NeRF state dicts (the
  reference's names) into the same flat arrays as the JAX package's
  ``torch_ckpt``, one file or a directory;
* ``python -m adanerf_tpu_torch.convert_reference_onnx`` and
  ``...convert_reference_checkpoint`` write what the JAX tools write (text
  files byte for byte, weight arrays bit for bit), on a sample directory
  made from an export; the converted export renders as the live modules
  within 1e-5 (the export bar of ``tests/test_export_viewer.py``)."""

import importlib.util
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from adanerf_tpu.models import mlp as jmlp
from adanerf_tpu.utils import onnx_export as j_onnx
from adanerf_tpu.utils import torch_ckpt as j_ckpt
from adanerf_tpu.utils.onnx_weights import load_onnx_weights as j_load_onnx
from adanerf_tpu_torch import convert_reference_checkpoint as t_conv_ckpt
from adanerf_tpu_torch import convert_reference_onnx as t_conv_onnx
from adanerf_tpu_torch import viewer as tviewer
from adanerf_tpu_torch.models import mlp as tmlp
from adanerf_tpu_torch.realtime import RealtimeRenderer
from adanerf_tpu_torch.train_state import load_tree
from adanerf_tpu_torch.utils import onnx_export as t_onnx
from adanerf_tpu_torch.utils import torch_ckpt as t_ckpt
from adanerf_tpu_torch.utils.onnx_weights import load_onnx_weights as t_load_onnx
from adanerf_tpu_torch.utils.weights import from_jax_params, to_flat

from test_onnx_weights import _len_delim, _model, _tensor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSCENE = os.path.join(ROOT, "demo", "trained_mscene_export")

BASENETS = {"plain": dict(depth=4, width=32, n_in=20, n_out=8),
            "skip": dict(depth=5, width=16, n_in=30, n_out=12, skip="0::20-3:20:")}
NERFS = {"one_skip": dict(depth=8, width=64, input_ch=63, input_ch_views=27),
         "two_skips": dict(depth=6, width=32, input_ch=21, input_ch_views=9, skips=(2, 4))}


def _pair(kind, kw, seed):
    """(JAX def, its params as numpy, the port's module with those params)."""
    jdef = (jmlp.BaseNetDef if kind == "basenet" else jmlp.NeRFDef)(**kw)
    params = jax.tree.map(np.asarray, jdef.init(jax.random.PRNGKey(seed)))
    tkw = dict(kw, skips=tuple(kw["skips"])) if "skips" in kw else kw
    module = from_jax_params((tmlp.BaseNetDef if kind == "basenet" else tmlp.NeRFDef)(**tkw),
                             params)
    return jdef, params, module


CASES = [("basenet", k, v) for k, v in BASENETS.items()] + \
    [("nerf", k, v) for k, v in NERFS.items()]


@pytest.mark.parametrize("kind,label,kw", CASES, ids=[c[1] for c in CASES])
def test_onnx_bytes_equal_jax_writer(kind, label, kw, tmp_path):
    jdef, params, module = _pair(kind, kw, seed=len(label))
    j_path, t_path = str(tmp_path / "j.onnx"), str(tmp_path / "t.onnx")
    j_onnx.write_model_onnx(j_path, jdef, params)
    t_onnx.write_model_onnx(t_path, module)
    with open(j_path, "rb") as a, open(t_path, "rb") as b:
        assert a.read() == b.read()
    # the module alone and the module with its flat dict write the same
    assert t_onnx.write_model_onnx(str(tmp_path / "f.onnx"), module, to_flat(module))
    with open(t_path, "rb") as a, open(str(tmp_path / "f.onnx"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("kind,label,kw", CASES, ids=[c[1] for c in CASES])
def test_onnx_reader_matches_jax_reader(kind, label, kw, tmp_path):
    jdef, params, module = _pair(kind, kw, seed=10 + len(label))
    j_path, t_path = str(tmp_path / "j.onnx"), str(tmp_path / "t.onnx")
    j_onnx.write_model_onnx(j_path, jdef, params)
    t_onnx.write_model_onnx(t_path, module)
    reads = [t_load_onnx(j_path), t_load_onnx(t_path), j_load_onnx(t_path), j_load_onnx(j_path)]
    for got in reads[1:]:
        assert set(got) == set(reads[0])
        for k in reads[0]:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], reads[0][k])
    # and the names map back to the module's own parameters
    back = t_ckpt.flat_from_state_dict(reads[0], t_path)
    flat = to_flat(module)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_onnx_reader_on_a_hand_encoded_model(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    c = rng.normal(size=(2, 2, 2)).astype(np.float32)
    graph = (_len_delim(5, _tensor("layers.0.weight", a, True, True))
             + _len_delim(5, _tensor("layers.0.bias", b, False, True))
             + _len_delim(5, _tensor("float_data.t", c, True, False)))
    path = str(tmp_path / "hand.onnx")
    with open(path, "wb") as f:
        f.write(_model(graph))
    w = t_load_onnx(path)
    assert set(w) == {"layers.0.weight", "layers.0.bias", "float_data.t"}
    np.testing.assert_array_equal(w["layers.0.weight"], a)
    np.testing.assert_array_equal(w["layers.0.bias"], b)
    np.testing.assert_array_equal(w["float_data.t"], c)
    assert w.keys() == j_load_onnx(path).keys()


def _reference_state_dict(kind, seed):
    """A reference-layout state dict of torch tensors (weights (out, in))."""
    g = torch.Generator().manual_seed(seed)
    if kind == "basenet":
        dims = [(20, 32), (32, 32), (32, 8)]
        return {k: v for i, (a, b) in enumerate(dims) for k, v in
                ((f"layers.{i}.weight", torch.randn(b, a, generator=g)),
                 (f"layers.{i}.bias", torch.randn(b, generator=g)))}
    sd = {}
    for i, (a, b) in enumerate([(21, 32), (32, 32), (53, 32)]):
        sd[f"pts_linears.{i}.weight"] = torch.randn(b, a, generator=g)
        sd[f"pts_linears.{i}.bias"] = torch.randn(b, generator=g)
    for name, (a, b) in (("views_linears.0", (41, 16)), ("feature_linear", (32, 32)),
                         ("alpha_linear", (32, 1)), ("rgb_linear", (16, 3))):
        sd[f"{name}.weight"] = torch.randn(b, a, generator=g)
        sd[f"{name}.bias"] = torch.randn(b, generator=g)
    return sd


def _assert_same_npz(a, b):
    fa, fb = load_tree(a), load_tree(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype
        np.testing.assert_array_equal(fa[k], fb[k])


@pytest.mark.parametrize("kind", ["basenet", "nerf"])
def test_torch_checkpoint_matches_jax(kind, tmp_path):
    src = str(tmp_path / f"{kind}_300000.weights")
    torch.save(_reference_state_dict(kind, 3), src)
    t_out = t_ckpt.convert_torch_checkpoint(src, str(tmp_path / "t.weights"))
    j_out = j_ckpt.convert_torch_checkpoint(src, str(tmp_path / "j.weights"))
    _assert_same_npz(t_out, j_out)
    sd = {k: v.numpy() for k, v in _reference_state_dict(kind, 3).items()}
    fn = "basenet_flat_from_torch" if kind == "basenet" else "nerf_flat_from_torch"
    want, got = getattr(j_ckpt, fn)(sd), getattr(t_ckpt, fn)(sd)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_tool(name, args, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + args)
    _load_tool(name).main()


def _assert_same_dirs(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        if name.endswith(".weights"):
            _assert_same_npz(os.path.join(a, name), os.path.join(b, name))
        else:
            with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
                assert fa.read() == fb.read(), name


@pytest.mark.parametrize("suffix", [None, "300000"])
def test_convert_reference_checkpoint_cli_matches_jax_tool(suffix, tmp_path, monkeypatch):
    src = tmp_path / "run"
    src.mkdir()
    for kind, name in (("basenet", "relu0(32x3)"), ("nerf", "NeRF1(32x3[1])")):
        for ep, seed in (("100000", 1), ("300000", 2), ("_opt", 3)):
            sep = "" if ep == "_opt" else "_"
            torch.save(_reference_state_dict(kind, seed), str(src / f"{name}{sep}{ep}.weights"))
    extra = [] if suffix is None else ["--suffix", suffix]
    done = t_conv_ckpt.main([str(src), str(tmp_path / "t")] + extra)
    _run_tool("convert_reference_checkpoint", [str(src), str(tmp_path / "j")] + extra,
              monkeypatch)
    assert len(done) == (4 if suffix is None else 2)
    assert not any("_opt" in d for d in done)
    _assert_same_dirs(str(tmp_path / "t"), str(tmp_path / "j"))
    # one file, converted in place
    one = str(src / "relu0(32x3)_300000.weights")
    t_conv_ckpt.main([one])
    _assert_same_npz(one, str(tmp_path / "j" / "relu0(32x3)_300000.weights"))


def test_convert_reference_onnx_cli_matches_jax_tool(tmp_path, monkeypatch):
    """A sample directory made from an export (its ONNX files, config.ini
    and dataset_info.txt) converts as the JAX tool converts it, and the
    result renders as the modules it was written from."""
    rt, scene = tviewer.build_renderer_from_export(MSCENE, batch_size=256, dtype_str="fp32",
                                                   device="cpu")
    sample = tmp_path / "sample"
    sample.mkdir()
    for i, m in enumerate((rt.oracle, rt.nerf)):
        t_onnx.write_model_onnx(str(sample / f"model{i}.onnx"), m)
    for name in ("config.ini", "dataset_info.txt"):
        shutil.copyfile(os.path.join(MSCENE, name), str(sample / name))
    t_conv_onnx.main([str(sample), str(tmp_path / "t")])
    _run_tool("convert_reference_onnx", [str(sample), str(tmp_path / "j")], monkeypatch)
    _assert_same_dirs(str(tmp_path / "t"), str(tmp_path / "j"))
    for i in range(2):
        _assert_same_npz(str(tmp_path / "t" / f"model{i}.weights"),
                         os.path.join(MSCENE, f"model{i}.weights"))
    conv, _ = tviewer.build_renderer_from_export(str(tmp_path / "t"), batch_size=256,
                                                 dtype_str="fp32", device="cpu")
    live = RealtimeRenderer(rt.oracle, rt.nerf, scene, rt.config, batch_size=256, device="cpu")
    dirs = tviewer.frame_directions(scene, 16, 16, "cpu")
    pose = np.asarray(scene.view_cell_center, np.float32)
    a, ca = conv.render_frame(pose, np.eye(3, dtype=np.float32), dirs)
    b, cb = live.render_frame(pose, np.eye(3, dtype=np.float32), dirs)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert torch.equal(ca, cb)
