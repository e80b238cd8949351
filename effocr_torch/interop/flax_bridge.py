"""Flax variables tree -> PyTorch ``state_dict`` for the port's models.

The port's modules name their submodules after the Flax scopes they mirror
(``stem``, ``c3_1.ConvBnAct_0.Conv_0``, ``block3.SqueezeExcite_0.reduce``),
so the conversion is a walk over the flattened tree that renames each leaf
and relayouts it:

- conv kernel HWIO ``(kh, kw, in/groups, out)`` -> OIHW ``(out, in/groups,
  kh, kw)``; a depthwise ``(k, k, 1, C)`` becomes ``(C, 1, k, k)``;
- Dense kernel ``[in, out]`` -> ``weight [out, in]``;
- BatchNorm ``scale``/``bias`` (params) and ``mean``/``var``
  (batch_stats) -> ``weight``/``bias``/``running_mean``/``running_var``.
  Each BatchNorm keeps its own epsilon in the module definition (1e-3 in
  ConvBnAct, 1e-5 in MobileNetV3), not in the checkpoint;
- LayerNorm ``scale``/``bias`` -> ``weight``/``bias`` (ConvNeXt's
  ``stem_norm``, ``downsample_norm{i}``, the blocks' ``LayerNorm_0``,
  ``head_norm``);
- parameters that are neither kernel nor norm keep their name and
  layout: ConvNeXt's LayerScale ``gamma``, the transformers' ``pos``
  (1, n, dim) and ``cls`` (1, 1, dim), XCA's ``temperature`` (heads, 1,
  1) and XCiT's layer scales ``gamma1``, ``gamma2``, ``gamma3``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

# leaves that keep their name and layout both ways
_SAME_NAMES = ("bias", "gamma", "gamma1", "gamma2", "gamma3", "pos", "cls",
               "temperature")
_PARAM_NAMES = {"scale": "weight", **{k: k for k in _SAME_NAMES}}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def flax_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` -> torch state_dict."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(variables.get("params", {})):
        *scope, leaf = path
        if leaf == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"{'/'.join(path)}: kernel of rank "
                                 f"{arr.ndim}")
            name = "weight"
        elif leaf in _PARAM_NAMES:
            name = _PARAM_NAMES[leaf]
        else:
            raise KeyError(f"unexpected parameter {'/'.join(path)}")
        out[".".join(scope + [name])] = torch.from_numpy(
            np.array(arr, order="C"))
    for path, arr in _flatten(variables.get("batch_stats", {})):
        *scope, leaf = path
        if leaf not in _STAT_NAMES:
            raise KeyError(f"unexpected batch stat {'/'.join(path)}")
        out[".".join(scope + [_STAT_NAMES[leaf]])] = torch.from_numpy(
            np.array(arr, order="C"))
    return out


def state_dict_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``flax_to_state_dict``: writes checkpoints the JAX
    package (and this package's loader) read.  A 4-D ``weight`` is a conv
    kernel, a 2-D one a Dense kernel, a 1-D one a BatchNorm or LayerNorm
    scale."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    inv_stats = {v: k for k, v in _STAT_NAMES.items()}
    for key, t in state.items():
        *scope, leaf = key.split(".")
        arr = t.detach().cpu().numpy()
        if leaf in inv_stats:
            tree, name = stats, inv_stats[leaf]
        elif leaf == "weight" and arr.ndim == 4:
            tree, name, arr = params, "kernel", arr.transpose(2, 3, 1, 0)
        elif leaf == "weight" and arr.ndim == 2:
            tree, name, arr = params, "kernel", arr.T
        elif leaf == "weight":
            tree, name = params, "scale"
        elif leaf in _SAME_NAMES:
            tree, name = params, leaf
        else:
            raise KeyError(f"unexpected state_dict entry {key}")
        for s in scope:
            tree = tree.setdefault(s, {})
        tree[name] = np.ascontiguousarray(arr)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out
