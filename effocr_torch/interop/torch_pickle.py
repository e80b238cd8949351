"""Tensors from full torch module pickles, without the pickling package
(the JAX package's interop/torch_pickle.py).

An ultralytics ``best.pt`` (the reference's localizer artifact) is not a
state dict but a pickle of their ``Model`` object, which normally needs
the ultralytics package to load.  The tensors inside do not need those
classes: only the containers are foreign.  We unpickle with an
**allowlist** ``find_class``: only torch's tensor-rebuild helpers, torch
storage and dtype types, ``collections.OrderedDict`` and numpy's array
reconstructors resolve to real callables; every other global, importable
or not, becomes an inert stub that records its ``__dict__``.  After
loading we walk the module tree's ``_parameters`` / ``_buffers`` /
``_modules`` dicts (the same structure on stubs and on genuine
``nn.Module``s) and emit a flat ``state_dict``-style name -> array map.

Trust model: a pickle's REDUCE can normally call any importable callable
(``os.system``, ``builtins.eval``, ...); the allowlist closes that.  A
malicious ``best.pt`` can at worst give wrong tensors or fail to load; it
never runs code outside the allowlisted data constructors.  There is no
fallback to a plain ``torch.load(weights_only=False)``, and no path to
one: the nested loads that legacy storages make (``_load_from_bytes``)
and the legacy format's header records go through the same allowlist.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Dict, Optional

import numpy as np

# (module, name) globals that may resolve to real callables during
# unpickling.  Everything here is a pure data constructor: torch's
# _rebuild_* helpers build tensors from storages already read via
# persistent_load, the storage/dtype classes are leaf types, and the
# numpy entries reconstruct ndarrays from buffers.  Nothing on this
# list can be abused to run foreign code.
_SAFE_BUILTINS = {
    "set", "frozenset", "list", "dict", "tuple", "bytearray", "complex",
    "slice", "range",
}
_TORCH_TOPLEVEL = {
    "Size", "device", "dtype", "Tensor",
    "FloatStorage", "DoubleStorage", "HalfStorage", "BFloat16Storage",
    "LongStorage", "IntStorage", "ShortStorage", "CharStorage",
    "ByteStorage", "BoolStorage", "UntypedStorage",
    "float32", "float64", "float16", "bfloat16", "int64", "int32",
    "int16", "int8", "uint8", "bool",
}
_NUMPY_NAMES = {"ndarray", "dtype", "_reconstruct", "scalar", "_frombuffer"}


def _is_allowlisted(module: str, name: str) -> bool:
    if module == "collections" and name == "OrderedDict":
        return True
    if module == "builtins" and name in _SAFE_BUILTINS:
        return True
    if module == "torch._utils" and name.startswith("_rebuild_"):
        return True
    if module == "torch" and name in _TORCH_TOPLEVEL:
        return True
    # protocol 2 (torch.save's default) pickles bytes as
    # _codecs.encode(str, "latin1"); codecs are stdlib data transforms
    if module == "_codecs" and name == "encode":
        return True
    if module == "torch.serialization" and name == "_get_layout":
        return True
    if module in ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric") and name in _NUMPY_NAMES:
        return True
    return False


class _Stub:
    """Inert stand-in for a non-allowlisted pickled class."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_stub_state"] = state

    # some classes pickle via __reduce__ with append/extend calls
    def append(self, item):
        self.__dict__.setdefault("_stub_items", []).append(item)

    def extend(self, items):
        self.__dict__.setdefault("_stub_items", []).extend(items)

    # dict-like containers pickle via __reduce__ with setitems batches
    def __setitem__(self, key, value):
        self.__dict__.setdefault("_stub_dict", {})[key] = value


def _load_from_bytes(b):
    """Legacy torch storages pickle as ``torch.storage._load_from_bytes(b)``,
    whose own body is a plain ``torch.load(weights_only=False)`` of ``b``;
    this stand-in reads ``b`` through the allowlist instead."""
    import torch

    return torch.load(io.BytesIO(b), map_location="cpu", weights_only=False,
                      pickle_module=_PickleModule)


class _AllowlistUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "torch.storage" and name == "_load_from_bytes":
            return _load_from_bytes
        if _is_allowlisted(module, name):
            return super().find_class(module, name)
        return type(name, (_Stub,), {"__module__": module})


def _allowlist_load(f, **kwargs):
    return _AllowlistUnpickler(f, **kwargs).load()


class _PickleModule:
    """pickle-module shim for torch.load.  torch's loaders call both
    ``.Unpickler`` and ``.load`` (the legacy format reads its header
    records and storage tables with ``load``), so both use the allowlist."""

    Unpickler = _AllowlistUnpickler
    load = staticmethod(_allowlist_load)


def _walk_modules(obj: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return
    for coll in ("_parameters", "_buffers"):
        for k, v in (d.get(coll) or {}).items():
            if v is None or k == "num_batches_tracked":
                continue
            try:
                out[prefix + k] = v.detach().float().cpu().numpy()
            except Exception:
                continue
    for k, m in (d.get("_modules") or {}).items():
        if m is not None:
            _walk_modules(m, f"{prefix}{k}.", out)


def load_module_pickle_state_dict(
    path: str, root_key: Optional[str] = None
) -> Dict[str, np.ndarray]:
    """Full module pickle (.pt zip) -> flat {name: float32 array}.

    ``root_key``: key inside a checkpoint dict to walk ("model"/"ema");
    default prefers "ema" when present and not None (ultralytics'
    ``attempt_load`` runs the EMA weights of an unstripped mid-training
    checkpoint), then "model".  Key names match what
    ``obj.state_dict()`` would have produced.
    """
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False,
                     pickle_module=_PickleModule)
    if isinstance(obj, dict):
        if root_key is not None:
            obj = obj[root_key]
        else:
            for k in ("ema", "model"):
                if obj.get(k) is not None and hasattr(obj[k], "__dict__"):
                    obj = obj[k]
                    break
    out: Dict[str, np.ndarray] = {}
    _walk_modules(obj, "", out)
    if not out:
        raise ValueError(
            f"{path}: no parameters found walking the pickled module tree "
            "(not a torch module checkpoint?)")
    return out
