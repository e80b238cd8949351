"""Checkpoints (the JAX package's train/checkpoint.py).

Model variables go to ``<run_dir>/enc_best.msgpack`` in Flax's msgpack
format through the port's own codec (interop/flax_msgpack.py), so the
JAX package's loaders read what this package writes and the other way
round.  Writes are atomic: a temp file, then ``os.replace``, so a
reader harvesting a live run never sees a torn file.

``last.msgpack``, the resumable train state, has this package's own
layout: the optimizer state is this package's AdamW, not optax's.  It
carries ``format`` = TRAIN_STATE_FORMAT, and a file without it (such as
the JAX package's ``last.msgpack``) is refused.

Inside a process group only the primary rank writes; every rank waits
at a barrier until the file is in place, so a rank that reads it next
(``--resume``) reads the whole file.
"""

from __future__ import annotations

import os
from typing import Any, Dict

from effocr_torch.core import distributed
from effocr_torch.interop.flax_msgpack import read_variables, write_variables

TRAIN_STATE_FORMAT = "effocr_torch.train_state.v1"


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
    _atomic_write({"format": TRAIN_STATE_FORMAT, **state}, path)


def load_train_state(path: str) -> Dict[str, Any]:
    state = read_variables(path)
    if state.get("format") != TRAIN_STATE_FORMAT:
        raise ValueError(
            f"{path} is not a train state written by effocr_torch (no "
            f"format {TRAIN_STATE_FORMAT!r}; the JAX package's last.msgpack "
            "holds optax's optimizer state, which this package cannot "
            "resume from).  Start from its enc_best.msgpack with "
            "--checkpoint instead")
    return state


def best_checkpoint_path(run_dir: str, name: str = "enc_best") -> str:
    return os.path.join(run_dir, f"{name}.msgpack")
