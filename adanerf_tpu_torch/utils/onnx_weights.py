"""A minimal ONNX weight reader (no onnx dependency).

Counterpart of ``adanerf_tpu/utils/onnx_weights.py``. The reference viewer
ships its trained sample scenes as ONNX graphs (``model{0,1}.onnx``, from
the reference's ``torch.onnx.export``), and ``utils/onnx_export.py`` writes
the same layout. This reads just enough of the protobuf wire format to
recover the initializer tensors (the weights) under their torch
state-dict names; ``torch_ckpt`` maps those names to the port's.

Wire-format subset: ModelProto.graph(7) -> GraphProto.initializer(5,
repeated TensorProto) with TensorProto.dims(1), data_type(2),
float_data(4), name(8), raw_data(9). Only FLOAT tensors are returned.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _fields(buf: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:      # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:    # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:    # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:    # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_tensor(buf: memoryview):
    dims = []
    name = None
    dtype = None
    raw = None
    floats = []
    for field, wt, val in _fields(buf):
        if field == 1 and wt == 0:
            dims.append(val)
        elif field == 1 and wt == 2:  # packed dims
            p = 0
            while p < len(val):
                v, p = _read_varint(val, p)
                dims.append(v)
        elif field == 2:
            dtype = val
        elif field == 4:
            if wt == 2:  # packed floats
                floats.extend(np.frombuffer(bytes(val), np.float32))
            else:
                floats.append(struct.unpack("<f", bytes(val))[0])
        elif field == 8:
            name = bytes(val).decode()
        elif field == 9:
            raw = bytes(val)
    if dtype != 1:  # not FLOAT
        return name, None
    if raw is not None:
        arr = np.frombuffer(raw, np.float32)
    else:
        arr = np.asarray(floats, np.float32)
    return name, arr.reshape(dims) if dims else arr


def load_onnx_weights(path: str) -> Dict[str, np.ndarray]:
    """name -> float32 ndarray for every FLOAT initializer in the model."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    out = {}
    for field, wt, val in _fields(data):
        if field == 7 and wt == 2:           # ModelProto.graph
            for gfield, gwt, gval in _fields(val):
                if gfield == 5 and gwt == 2:  # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    if arr is not None and name:
                        out[name] = arr
    return out
