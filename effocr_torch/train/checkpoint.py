"""Checkpoints (the JAX package's train/checkpoint.py).

Model variables go to ``<run_dir>/enc_best.msgpack`` in Flax's msgpack
format through the port's own codec (interop/flax_msgpack.py), so the
JAX package's loaders read what this package writes and the other way
round.  Writes are atomic: a temp file, then ``os.replace``, so a
reader harvesting a live run never sees a torn file.

``last.msgpack``, the resumable train state, has the JAX package's
layout, so a run started by either package resumes in the other:
``{"params", "batch_stats", "opt_state"[, "aux"]}``, where ``opt_state``
is optax's state tree as ``flax.serialization`` writes it (tuples as
maps keyed "0", "1", ..., empty states as empty maps).  ``train_state``
builds it from a model and its AdamW (train/optim.py), and
``restore_train_state`` reads it back:

- ``optax.adamw`` is the chain (``ScaleByAdamState`` {count, mu, nu},
  ``add_decayed_weights``'s empty state, the learning rate's state:
  ``{"count"}`` for a schedule, empty for a constant);
- the localizer's ``chain(clip_by_global_norm, adamw)`` puts the clip's
  empty state first (``clip``);
- the recognizer's aux head: one adamw over ``{"model", "aux": {"w"}}``,
  or with its own rate (``multi``) ``optax.multi_transform``'s
  ``inner_states`` {"model", "aux"}, each holding an adamw whose mu and
  nu leave the other label's subtree empty (optax's MaskedNode).

Train states of this package's earlier layout (``format`` =
TRAIN_STATE_FORMAT_V1) still load; a file of neither layout is refused.

Inside a process group only the primary rank writes; every rank waits
at a barrier until the file is in place, so a rank that reads it next
(``--resume``) reads the whole file.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from effocr_torch.core import distributed
from effocr_torch.interop.flax_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from effocr_torch.interop.flax_msgpack import read_variables, write_variables

TRAIN_STATE_FORMAT_V1 = "effocr_torch.train_state.v1"

Path = Tuple[str, ...]


def _atomic_write(tree: Dict[str, Any], path: str) -> None:
    if distributed.is_primary():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        write_variables(tree, tmp)
        os.replace(tmp, path)
    distributed.barrier()


def save_variables(variables: Dict[str, Any], path: str) -> None:
    """Flax variables tree ({"params", "batch_stats"}) -> msgpack file."""
    _atomic_write(variables, path)


def load_variables(path: str) -> Dict[str, Any]:
    return read_variables(path)


def save_train_state(state: Dict[str, Any], path: str) -> None:
    _atomic_write(state, path)


def load_train_state(path: str) -> Dict[str, Any]:
    """A train state tree of either layout (the JAX package's, or this
    package's v1); anything else raises."""
    state = read_variables(path)
    if state.get("format") == TRAIN_STATE_FORMAT_V1 or {
            "params", "opt_state"} <= set(state):
        return state
    raise ValueError(
        f"{path} is not a train state written by effocr_torch or by the JAX "
        "package (neither this package's format "
        f"{TRAIN_STATE_FORMAT_V1!r} nor params + opt_state).  Start from a "
        "best checkpoint with --checkpoint instead")


def best_checkpoint_path(run_dir: str, name: str = "enc_best") -> str:
    return os.path.join(run_dir, f"{name}.msgpack")


# ------------------------------------------------- optax's state layout
def _get(tree: Dict, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: Dict, path: Path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _chains(clip: bool, aux: bool, multi: bool
            ) -> List[Tuple[Path, List[Tuple[int, Path]]]]:
    """[(path of an adamw chain's state in opt_state, [(AdamW group, path
    of the group's tree in that chain's mu / nu), ...])]."""
    if clip:
        return [(("1",), [(0, ())])]
    if not aux:
        return [((), [(0, ())])]
    if not multi:
        return [((), [(0, ("model",)), (1, ("aux", "w"))])]
    return [(("inner_states", "model", "inner_state"), [(0, ("model",))]),
            (("inner_states", "aux", "inner_state"), [(1, ("aux", "w"))])]


def _group_trees(model: torch.nn.Module, moments: Sequence[Sequence[
        torch.Tensor]]) -> List[Any]:
    """Each AdamW group's moments as the tree optax keeps: the model's
    as its Flax params tree, the aux head's as its array."""
    names = [n for n, _ in model.named_parameters()]
    trees = [state_dict_to_flax(dict(zip(names, moments[0])))["params"]]
    trees += [g[0].detach().cpu().numpy() for g in moments[1:]]
    return trees


def _group_tensors(model: torch.nn.Module, trees: Sequence[Any]
                   ) -> List[List[np.ndarray]]:
    """Inverse of ``_group_trees``."""
    sd = flax_to_state_dict({"params": trees[0]})
    names = [n for n, _ in model.named_parameters()]
    if set(sd) != set(names):
        raise ValueError("optimizer state does not match the model's "
                         f"parameters ({sorted(set(sd) ^ set(names))[:4]})")
    out = [[sd[n].numpy() for n in names]]
    return out + [[np.asarray(t)] for t in trees[1:]]


def train_state(model: torch.nn.Module, optimizer,
                aux: Optional[torch.Tensor] = None, clip: bool = False,
                multi: bool = False) -> Dict[str, Any]:
    """The JAX package's train state of ``model`` (params and
    batch_stats), its AdamW (``optimizer``; group 1 is ``aux`` when
    given) and the aux head: the tree its trainers save as last.msgpack.
    ``clip``: the localizer's chain; ``multi``: the aux head at its own
    rate (optax.multi_transform)."""
    variables = state_dict_to_flax(model.state_dict())
    schedule = callable(optimizer.groups[0][1])
    count = np.asarray(optimizer.count, np.int32)
    mus = _group_trees(model, optimizer.mu)
    nus = _group_trees(model, optimizer.nu)
    opt: Dict[str, Any] = {"0": {}} if clip else {}
    for chain_path, members in _chains(clip, aux is not None, multi):
        mu: Dict[str, Any] = {"aux": {}, "model": {}} if multi else {}
        nu: Dict[str, Any] = {"aux": {}, "model": {}} if multi else {}
        for g, sub in members:
            if sub:
                _set(mu, sub, mus[g])
                _set(nu, sub, nus[g])
            else:
                mu, nu = mus[g], nus[g]
        chain = {"0": {"count": count, "mu": mu, "nu": nu}, "1": {},
                 "2": {"count": count} if schedule else {}}
        if chain_path:
            _set(opt, chain_path, chain)
        else:
            opt.update(chain)
    state = {"params": variables["params"],
             "batch_stats": variables.get("batch_stats", {}),
             "opt_state": opt}
    if aux is not None:
        state["aux"] = {"w": aux.detach().cpu().numpy()}
    return state


def restore_train_state(state: Dict[str, Any], model: torch.nn.Module,
                        optimizer, aux: Optional[torch.Tensor] = None,
                        clip: bool = False, multi: bool = False) -> None:
    """Load a train state of either layout (``load_train_state``) into
    ``model``, ``optimizer`` and ``aux`` in place; ``clip`` and ``multi``
    as in ``train_state``."""
    if state.get("format") == TRAIN_STATE_FORMAT_V1:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in state["model"].items()},
                              strict=True)
        if aux is not None:
            with torch.no_grad():
                aux.copy_(torch.from_numpy(state["aux"]))
        optimizer.load_state_dict(state["opt"])
        return
    if (aux is not None) != ("aux" in state):
        raise ValueError("the train state's aux head does not match this "
                         f"run's (aux_ce_weight > 0: {aux is not None})")
    n_groups = 2 if aux is not None else 1
    mus: List[Any] = [None] * n_groups
    nus: List[Any] = [None] * n_groups
    counts = set()
    try:
        for chain_path, members in _chains(clip, aux is not None, multi):
            adam = _get(state["opt_state"], chain_path)["0"]
            counts.add(int(np.asarray(adam["count"])))
            for g, sub in members:
                mus[g] = _get(adam["mu"], sub)
                nus[g] = _get(adam["nu"], sub)
    except (KeyError, TypeError) as e:
        raise ValueError(
            "the train state's optimizer layout does not match this run's "
            f"(gradient clip: {clip}, aux head: {aux is not None}, aux at "
            f"its own rate: {multi}): missing {e}") from None
    if len(counts) != 1:
        raise ValueError(f"the train state's update counts differ: {counts}")
    model.load_state_dict(flax_to_state_dict(
        {"params": state["params"], "batch_stats": state["batch_stats"]}),
        strict=True)
    if aux is not None:
        with torch.no_grad():
            aux.copy_(torch.from_numpy(np.asarray(state["aux"]["w"])))
    optimizer.load_state_dict({"count": counts.pop(),
                               "mu": _group_tensors(model, mus),
                               "nu": _group_tensors(model, nus)})
