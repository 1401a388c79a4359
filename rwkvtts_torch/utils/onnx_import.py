"""ONNX initializer reader and writer, numpy only (a copy of
rwkvtts_tpu/utils/onnx_import.py): it walks the protobuf wire format of a
.onnx file and pulls out the graph initializers (the weights), which is
enough to map them onto the port's S3 tokenizer and CAM++ models; no onnx
or onnxruntime package is needed.

Wire-format facts used (protobuf encoding spec):
  * ModelProto.graph = field 7 (len-delimited GraphProto)
  * GraphProto.initializer = field 5 (repeated TensorProto)
  * TensorProto: dims=1 (varint, repeated), data_type=2 (varint),
    name=8 (bytes), raw_data=9 (bytes), float_data=4 (packed floats),
    int64_data=7 (packed varints)
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

# ONNX TensorProto.DataType -> numpy
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload) over one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wt, val
        elif wt == 1:  # 64-bit
            yield field, wt, buf[pos : pos + 8]
            pos += 8
        elif wt == 2:  # len-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wt, buf[pos : pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            yield field, wt, buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = 1
    name = ""
    raw = b""
    floats: List[bytes] = []
    int64s: List[int] = []
    for field, wt, val in _fields(buf):
        if field == 1:  # dims
            if wt == 0:
                dims.append(val)  # type: ignore[arg-type]
            else:  # packed
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(v)
        elif field == 2 and wt == 0:
            dtype = val  # type: ignore[assignment]
        elif field == 8 and wt == 2:
            name = val.decode("utf-8")
        elif field == 9 and wt == 2:
            raw = val
        elif field == 4:  # float_data
            if wt == 5:
                floats.append(val)
            elif wt == 2:
                floats.append(val)
        elif field == 7:  # int64_data
            if wt == 0:
                int64s.append(val)  # type: ignore[arg-type]
            elif wt == 2:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int64s.append(v)
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw:
        arr = np.frombuffer(raw, np_dtype)
    elif floats:
        arr = np.frombuffer(b"".join(floats), np.float32)
    elif int64s:
        arr = np.asarray(int64s, np.int64)
    else:
        arr = np.zeros(0, np_dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


_DTYPE_IDS = {np.dtype(v): k for k, v in _DTYPES.items()}


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


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def write_onnx_initializers(arrays: Dict[str, np.ndarray]) -> bytes:
    """Serialize {name: array} as a minimal ModelProto holding only graph
    initializers: the exact subset load_onnx_initializers reads back (the
    golden fixtures hold such synthetic exports in the published models'
    initializer naming and layout)."""
    tensors = []
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        body = bytearray()
        for d in arr.shape:
            body += _varint(1 << 3) + _varint(d)          # dims (field 1)
        body += _varint(2 << 3) + _varint(_DTYPE_IDS[arr.dtype])
        body += _len_field(8, name.encode("utf-8"))        # name
        body += _len_field(9, arr.tobytes())               # raw_data
        tensors.append(_len_field(5, bytes(body)))          # initializer
    graph = b"".join(tensors)
    return _len_field(7, graph)                             # ModelProto.graph


def load_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """Extract {initializer_name: array} from an .onnx file."""
    with open(path, "rb") as f:
        model = f.read()
    out: Dict[str, np.ndarray] = {}
    for field, wt, graph in _fields(model):
        if field == 7 and wt == 2:  # ModelProto.graph
            for gfield, gwt, tensor in _fields(graph):
                if gfield == 5 and gwt == 2:  # initializer
                    name, arr = _parse_tensor(tensor)
                    if name:
                        out[name] = arr
    return out
