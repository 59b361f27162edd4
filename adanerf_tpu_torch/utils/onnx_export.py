"""A minimal ONNX writer (no onnx dependency): ``model{i}.onnx`` for the
reference's TensorRT viewer.

Counterpart of ``adanerf_tpu/utils/onnx_export.py``; on the same fp32
weights it writes the same bytes. The graphs have the structure the
reference's ``torch.onnx.export`` gives its two model families (opset 9):

* BaseNet (oracle):  Slice(input) -> [Gemm -> Relu]*(D-1) -> Gemm
* NeRF (shading):    Split(input) -> pts trunk with skip Concats ->
                     alpha/feature Gemms -> Concat(feature, views) ->
                     views Gemm+Relu -> rgb Gemm -> Concat(rgb, alpha)

Weights are stored ``transB=1`` (torch Linear layout, (out, in)) under the
reference's state-dict names (``layers.{i}.weight``, ``pts_linears.{i}.*``,
...), so ``onnx_weights.load_onnx_weights`` and ``torch_ckpt`` read them
back. The writers take a port module and, optionally, its flat parameter
dict (``utils/weights.py::to_flat``; the module's own by default).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..models.mlp import BaseNetDef, NeRFDef
from .weights import to_flat

# --- protobuf wire encoding -------------------------------------------------

FLOAT = 1  # TensorProto.DataType.FLOAT
# ModelProto.producer_name: the JAX package's, so both write the same bytes
PRODUCER = "adanerf_tpu"


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, v: int) -> bytes:
    if v < 0:                     # int64 two's-complement (10-byte varint)
        v += 1 << 64
    return _tag(field, 0) + _varint(v)


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _str_field(field: int, s: str) -> bytes:
    return _len_field(field, s.encode())


# --- ONNX message builders --------------------------------------------------
# AttributeProto: name(1), f(2), i(3), ints(8, unpacked), type(20)
_ATTR_FLOAT, _ATTR_INT, _ATTR_INTS = 1, 2, 7


def attr_f(name: str, v: float) -> bytes:
    return _str_field(1, name) + _float_field(2, v) + _int_field(20, _ATTR_FLOAT)


def attr_i(name: str, v: int) -> bytes:
    return _str_field(1, name) + _int_field(3, v) + _int_field(20, _ATTR_INT)


def attr_ints(name: str, vs: Sequence[int]) -> bytes:
    body = _str_field(1, name)
    for v in vs:
        body += _int_field(8, v)
    return body + _int_field(20, _ATTR_INTS)


def node(op: str, name: str, inputs: Sequence[str], outputs: Sequence[str],
         attrs: Sequence[bytes] = ()) -> bytes:
    """NodeProto: input(1), output(2), name(3), op_type(4), attribute(5)."""
    body = b""
    for i in inputs:
        body += _str_field(1, i)
    for o in outputs:
        body += _str_field(2, o)
    body += _str_field(3, name) + _str_field(4, op)
    for a in attrs:
        body += _len_field(5, a)
    return body


def tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims(1), data_type(2), name(8), raw_data(9)."""
    arr = np.ascontiguousarray(arr, np.float32)
    body = b""
    for d in arr.shape:
        body += _int_field(1, d)
    body += _int_field(2, FLOAT) + _str_field(8, name)
    body += _len_field(9, arr.tobytes())
    return body


def value_info(name: str, width: int) -> bytes:
    """ValueInfoProto for a (batch=-1, width) float tensor, encoded the way
    torch.onnx emits it (dim_param "-1" + dim_value)."""
    dim_batch = _str_field(2, "-1")                     # Dimension.dim_param
    dim_width = _int_field(1, width)                    # Dimension.dim_value
    shape = _len_field(1, dim_batch) + _len_field(1, dim_width)
    tensor_type = _int_field(1, FLOAT) + _len_field(2, shape)
    type_proto = _len_field(1, tensor_type)
    return _str_field(1, name) + _len_field(2, type_proto)


def model_proto(nodes: List[bytes], initializers: List[bytes],
                in_width: int, out_width: int,
                graph_name: str = "main_graph") -> bytes:
    """ModelProto matching the shipped samples: ir_version 4, opset 9."""
    graph = b""
    for n in nodes:
        graph += _len_field(1, n)
    graph += _str_field(2, graph_name)
    for t in initializers:
        graph += _len_field(5, t)
    graph += _len_field(11, value_info("input_1", in_width))
    graph += _len_field(12, value_info("output1", out_width))

    opset = _int_field(2, 9)                            # OperatorSetId.version
    return (_int_field(1, 4) + _str_field(2, PRODUCER) +
            _str_field(3, "0.1") + _len_field(7, graph) +
            _len_field(8, opset))


# --- model-family graph builders -------------------------------------------


def _gemm_attrs() -> List[bytes]:
    return [attr_f("alpha", 1.0), attr_f("beta", 1.0), attr_i("transB", 1)]


def basenet_onnx(model: BaseNetDef, flat: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """BaseNet -> ONNX bytes: a leading Slice of the used input columns, a
    Gemm/Relu trunk (no activation on the last layer), extra skip inputs
    sliced and concatenated where the skip DSL places them."""
    flat = to_flat(model) if flat is None else flat
    locs = model.input_locations
    in_width = max(hi for (_, hi) in locs.values())

    nodes: List[bytes] = []
    inits: List[bytes] = []
    nid = 0

    def slice_cols(lo, hi):
        nonlocal nid
        out = f"slice_{lo}_{hi}"
        nodes.append(node("Slice", f"Slice_{nid}", ["input_1"], [out],
                          [attr_ints("axes", [1]), attr_ints("ends", [hi]),
                           attr_ints("starts", [lo])]))
        nid += 1
        return out

    cur = slice_cols(*locs[0])
    for i in range(model.depth):
        if i in locs and i != 0:
            extra = slice_cols(*locs[i])
            cat = f"concat_in_{i}"
            nodes.append(node("Concat", f"Concat_{nid}", [cur, extra], [cat],
                              [attr_i("axis", -1)]))
            nid += 1
            cur = cat
        wname, bname = f"layers.{i}.weight", f"layers.{i}.bias"
        # ours (in, out) -> torch (out, in)
        inits += [tensor(wname, flat[f"{i}.w"].T), tensor(bname, flat[f"{i}.b"])]
        last = i + 1 == model.depth
        gemm_out = "output1" if last else f"gemm_{i}"
        nodes.append(node("Gemm", f"Gemm_{nid}", [cur, wname, bname],
                          [gemm_out], _gemm_attrs()))
        nid += 1
        if not last:
            relu_out = f"relu_{i}"
            nodes.append(node("Relu", f"Relu_{nid}", [gemm_out], [relu_out]))
            nid += 1
            cur = relu_out

    return model_proto(nodes, inits, in_width, model.n_out)


def nerf_onnx(model: NeRFDef, flat: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """NeRF -> ONNX bytes: Split into [pts | views] encodings, a relu trunk
    with post-relu skip Concats (input first), alpha and feature heads, a
    [feature, views] Concat, the W/2 view layer, the rgb head and a final
    Concat(rgb, alpha). The port's NeRF always has the view branch."""
    flat = to_flat(model) if flat is None else flat
    d = model
    in_width = d.input_ch + d.input_ch_views

    nodes: List[bytes] = []
    inits: List[bytes] = []
    nid = 0

    def add(op, inputs, outputs, attrs=()):
        nonlocal nid
        nodes.append(node(op, f"{op}_{nid}", inputs, outputs, attrs))
        nid += 1

    def linear(key, ref_name, src, dst):
        inits.append(tensor(f"{ref_name}.weight", flat[f"{key}.w"].T))
        inits.append(tensor(f"{ref_name}.bias", flat[f"{key}.b"]))
        add("Gemm", [src, f"{ref_name}.weight", f"{ref_name}.bias"], [dst],
            _gemm_attrs())

    add("Split", ["input_1"], ["input_pts", "input_views"],
        [attr_i("axis", -1),      # torch emits the last axis as -1 here
         attr_ints("split", [d.input_ch, d.input_ch_views])])

    h = "input_pts"
    for i in range(len(d.pts)):
        linear(f"pts.{i}", f"pts_linears.{i}", h, f"pts_gemm_{i}")
        add("Relu", [f"pts_gemm_{i}"], [f"pts_relu_{i}"])
        h = f"pts_relu_{i}"
        if i in d.skips:
            add("Concat", ["input_pts", h], [f"pts_skip_{i}"],
                [attr_i("axis", -1)])
            h = f"pts_skip_{i}"

    linear("alpha", "alpha_linear", h, "alpha_out")
    linear("feature", "feature_linear", h, "feature_out")
    add("Concat", ["feature_out", "input_views"], ["views_in"],
        [attr_i("axis", -1)])
    h = "views_in"
    for i in range(len(d.views)):
        linear(f"views.{i}", f"views_linears.{i}", h, f"views_gemm_{i}")
        add("Relu", [f"views_gemm_{i}"], [f"views_relu_{i}"])
        h = f"views_relu_{i}"
    linear("rgb", "rgb_linear", h, "rgb_out")
    add("Concat", ["rgb_out", "alpha_out"], ["output1"],
        [attr_i("axis", -1)])
    return model_proto(nodes, inits, in_width, 4)


def write_model_onnx(path: str, model, flat: Optional[Dict[str, np.ndarray]] = None) -> str:
    """Serialize one model (a port module, optionally with its flat
    parameters) to ``path`` by family."""
    if isinstance(model, BaseNetDef):
        data = basenet_onnx(model, flat)
    elif isinstance(model, NeRFDef):
        data = nerf_onnx(model, flat)
    else:
        raise ValueError(f"no ONNX writer for {type(model).__name__}")
    with open(path, "wb") as f:
        f.write(data)
    return path
