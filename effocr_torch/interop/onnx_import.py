"""ONNX checkpoint reader without the onnx or onnxruntime packages (the
JAX package's interop/onnx_import.py).

An ONNX-only recognizer dir holds ``enc_best.onnx``, exported by the
reference with torch.onnx (opset 11, input 'imgs', output 'embs').  No
runtime is needed: the weights in the file are the state dict of the
timm encoder the exporting module held (as ``self.net``), so a protobuf
wire-format walk over the GraphProto's initializers recovers ``{name:
ndarray}`` and the timm converters of interop/reference_artifacts.py do
the rest.

Two artifacts of torch's exporter are handled:

- parameter names carry the exporting module's attribute path ("net."),
  stripped like the "module." DataParallel prefix;
- ``nn.Linear`` on >2-D activations lowers to MatMul + Add with a
  pre-transposed weight initializer renamed to an anonymous constant
  ("onnx::MatMul_123" or a bare number), while the bias keeps its name on
  the Add: the graph walk re-derives "<stem>.weight" from the sibling
  "<stem>.bias" and transposes it back.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# TensorProto.DataType -> numpy dtype (little-endian, the proto layout)
_DTYPES = {
    1: np.dtype("<f4"),    # FLOAT
    2: np.dtype("u1"),     # UINT8
    3: np.dtype("i1"),     # INT8
    5: np.dtype("<i2"),    # INT16
    6: np.dtype("<i4"),    # INT32
    7: np.dtype("<i8"),    # INT64
    9: np.dtype("?"),      # BOOL
    10: np.dtype("<f2"),   # FLOAT16
    11: np.dtype("<f8"),   # DOUBLE
}


def _read_varint(buf: bytes, off: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7
        if shift > 70:
            raise ValueError("varint overflow (not a protobuf file?)")


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, payload) over one message's bytes.

    payload is an int for wire types 0/1/5 and a bytes slice for type 2.
    """
    off = 0
    n = len(buf)
    while off < n:
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 0:                     # varint
            val, off = _read_varint(buf, off)
        elif wire == 1:                   # fixed64
            val = struct.unpack_from("<Q", buf, off)[0]
            off += 8
        elif wire == 2:                   # length-delimited
            ln, off = _read_varint(buf, off)
            val = buf[off : off + ln]
            off += ln
        elif wire == 5:                   # fixed32
            val = struct.unpack_from("<I", buf, off)[0]
            off += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    """TensorProto -> (name, array).  Fields (onnx.proto): dims=1,
    data_type=2, float_data=4, int32_data=5, int64_data=7, name=8,
    raw_data=9, double_data=10."""
    dims: List[int] = []
    dtype_code: Optional[int] = None
    name = ""
    raw: Optional[bytes] = None
    typed: List[Any] = []
    typed_fmt: Optional[str] = None
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            if wire == 0:
                dims.append(val)
            else:                          # packed repeated
                off = 0
                while off < len(val):
                    d, off = _read_varint(val, off)
                    dims.append(d)
        elif field == 2:
            dtype_code = val
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = bytes(val)
        elif field == 4:                   # float_data
            if wire == 5:
                typed.append(struct.unpack("<f", struct.pack("<I", val))[0])
            else:
                typed.extend(np.frombuffer(val, "<f4").tolist())
            typed_fmt = "<f4"
        elif field == 10:                  # double_data
            if wire == 1:
                typed.append(struct.unpack("<d", struct.pack("<Q", val))[0])
            else:
                typed.extend(np.frombuffer(val, "<f8").tolist())
            typed_fmt = "<f8"
        elif field in (5, 7):              # int32_data / int64_data
            if wire == 0:
                typed.append(val)
            else:
                off = 0
                while off < len(val):
                    d, off = _read_varint(val, off)
                    typed.append(d)
            typed_fmt = "<i4" if field == 5 else "<i8"
    if dtype_code is None:
        raise ValueError(f"initializer {name!r}: missing data_type")
    if raw is not None:
        dt = _DTYPES.get(dtype_code)
        if dt is None:
            raise ValueError(
                f"initializer {name!r}: unsupported dtype {dtype_code}")
        arr = np.frombuffer(raw, dt)
    elif typed_fmt is not None:
        arr = np.asarray(typed, np.dtype(typed_fmt))
    else:
        arr = np.zeros(0, np.float32)
    return name, arr.reshape(dims if dims else ())


def read_onnx_graph(path: str) -> Tuple[
        Dict[str, np.ndarray], List[Dict[str, Any]]]:
    """Parse a .onnx file into (initializers, nodes).

    nodes are dicts {op_type, inputs, outputs} — just enough graph to
    resolve renamed initializers; no execution semantics.
    ModelProto.graph=7; GraphProto.node=1, initializer=5;
    NodeProto.input=1, output=2, op_type=4.
    """
    with open(path, "rb") as f:
        blob = f.read()
    graph = None
    for field, wire, val in _iter_fields(blob):
        if field == 7 and wire == 2:
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no GraphProto (field 7) — not ONNX?")
    inits: Dict[str, np.ndarray] = {}
    nodes: List[Dict[str, Any]] = []
    for field, wire, val in _iter_fields(graph):
        if field == 5 and wire == 2:
            name, arr = _parse_tensor(val)
            inits[name] = arr
        elif field == 1 and wire == 2:
            node: Dict[str, Any] = {"inputs": [], "outputs": [],
                                    "op_type": ""}
            for nf, nw, nv in _iter_fields(val):
                if nf == 1:
                    node["inputs"].append(nv.decode("utf-8"))
                elif nf == 2:
                    node["outputs"].append(nv.decode("utf-8"))
                elif nf == 4:
                    node["op_type"] = nv.decode("utf-8")
            nodes.append(node)
    return inits, nodes


def _recover_matmul_weights(inits: Dict[str, np.ndarray],
                            nodes: List[Dict[str, Any]]) -> None:
    """Re-name anonymous MatMul weight constants from their Add bias.

    torch Linear on rank>2 input exports as
        h = MatMul(x, W_t)          # W_t = weight.T, anonymous name
        y = Add(h, bias)            # bias keeps "stem.bias"
    so "<stem>.weight" = W_t.T.  Mutates ``inits`` in place.
    """
    add_bias_for: Dict[str, str] = {}
    for node in nodes:
        if node["op_type"] != "Add" or len(node["inputs"]) != 2:
            continue
        named = [i for i in node["inputs"]
                 if i in inits and i.endswith(".bias")]
        if len(named) == 1:
            other = [i for i in node["inputs"] if i != named[0]][0]
            add_bias_for[other] = named[0]
    for node in nodes:
        if node["op_type"] != "MatMul" or len(node["inputs"]) != 2:
            continue
        w_name = node["inputs"][1]
        if w_name not in inits or "." in w_name:
            continue                        # named params need no recovery
        out = node["outputs"][0]
        bias = add_bias_for.get(out)
        if bias is None:
            continue
        stem = bias[: -len(".bias")]
        if f"{stem}.weight" not in inits:
            w = inits.pop(w_name)
            inits[f"{stem}.weight"] = np.ascontiguousarray(w.T)


def onnx_to_state_dict(path: str) -> Dict[str, np.ndarray]:
    """enc_best.onnx -> a timm-style float32 state dict.

    Strips the exporting wrapper's attribute prefix ("net."; "module."
    from DataParallel) and recovers
    MatMul-renamed Linear weights.  Raises with the leftover names if
    anonymous constants remain that the recovery could not attribute.
    """
    inits, nodes = read_onnx_graph(path)
    _recover_matmul_weights(inits, nodes)
    sd: Dict[str, np.ndarray] = {}
    for name, arr in inits.items():
        if "." not in name:
            # shape/constant leftovers (Reshape targets etc.) are fine to
            # drop — but a big float matrix we failed to attribute is not
            if arr.dtype.kind == "f" and arr.ndim >= 2:
                raise ValueError(
                    f"{path}: could not attribute weight constant "
                    f"{name!r} {arr.shape} to a parameter; re-export "
                    "without exotic graph rewrites or convert via "
                    "enc_best.pth")
            continue
        for prefix in ("net.", "module.net.", "module."):
            if name.startswith(prefix):
                name = name[len(prefix):]
                break
        sd[name] = np.asarray(arr, np.float32) \
            if arr.dtype.kind == "f" else arr
    return sd
