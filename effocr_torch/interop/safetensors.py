"""Reader and writer for the safetensors format, without the safetensors
package.

A file is an 8-byte little-endian header length N, a JSON header of N
bytes mapping each tensor name to ``{"dtype", "shape", "data_offsets":
[begin, end]}`` (offsets into the data that follows the header; an
optional ``__metadata__`` entry holds strings), then the raw little-endian
tensor data.  ``load_file`` returns numpy arrays; BF16, which numpy has
no type for, is widened to float32 exactly (its 16 bits are the high half
of a float32).
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional

import numpy as np

_DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"), "I32": np.dtype("<i4"), "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"), "U8": np.dtype("u1"), "BOOL": np.dtype("?"),
}
_CODES = {v: k for k, v in _DTYPES.items()}


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file, by name."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 8:
        raise ValueError(f"{path}: too short to be a safetensors file")
    n, = struct.unpack_from("<Q", blob, 0)
    if 8 + n > len(blob):
        raise ValueError(f"{path}: header length {n} past the end of file")
    header = json.loads(blob[8:8 + n].decode("utf-8"))
    data = memoryview(blob)[8 + n:]
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end > len(data) or begin > end:
            raise ValueError(f"{path}: {name} lies outside the data")
        raw = data[begin:end]
        code = info["dtype"]
        if code == "BF16":
            arr = (np.frombuffer(raw, "<u2").astype(np.uint32) << 16
                   ).view(np.float32)
        elif code in _DTYPES:
            arr = np.frombuffer(raw, _DTYPES[code]).copy()
        else:
            raise ValueError(f"{path}: {name} has unsupported dtype {code}")
        if arr.size != int(np.prod(shape)):
            raise ValueError(f"{path}: {name} holds {arr.size} values for "
                             f"shape {shape}")
        out[name] = arr.reshape(shape)
    return out


def save_file(tensors: Mapping[str, np.ndarray], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write numpy arrays as a ``.safetensors`` file: names sorted, data
    in that order, the header padded with spaces to a multiple of 8
    bytes."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    chunks, off = [], 0
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        dt = arr.dtype.newbyteorder("<") if arr.dtype.itemsize > 1 \
            else arr.dtype
        code = _CODES.get(dt)
        if code is None:
            raise ValueError(f"{name}: dtype {arr.dtype} has no "
                             "safetensors code")
        raw = np.ascontiguousarray(arr, dt).tobytes()
        header[name] = {"dtype": code, "shape": list(arr.shape),
                        "data_offsets": [off, off + len(raw)]}
        chunks.append(raw)
        off += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in chunks:
            f.write(raw)
