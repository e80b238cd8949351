"""Data parallelism over processes: the port's counterpart of the JAX
package's core/mesh.py and core/distributed.py.

A JAX mesh runs one global-batch program and XLA inserts the collectives.
Here each device has a process of its own (a "rank", torch.distributed),
each rank runs its contiguous slice of the global batch, and the code
makes every batch-global quantity global by hand: BatchNorm statistics
(models/layers.py), SupCon's similarity matrix and every loss denominator
(train/losses.py, models/fcos.py), and the gradients
(``DistributedDataParallel``).  N ranks compute what one rank computes on
the whole batch.

Rules:

- a rank's device is ``cuda:(LOCAL_RANK % device_count())``;
- the backend is NCCL when every rank of the node has a card of its own,
  and gloo when ranks share a card (NCCL refuses two ranks on one device)
  or run on the CPU;
- a global batch splits into equal contiguous slices in rank order, the
  way ``P("data")`` splits it, so it must divide by the world size.

Every collective here is an all-reduce (gloo takes it on CUDA tensors).
The all-gather is an all-reduce of a zero-padded buffer: x + 0 is x, so
the gathered rows are exact.

Autograd-aware collectives together with DDP's averaging give the
gradient of the mean over ranks of each rank's loss, so each rank's loss
is built so that its mean over ranks is the global-batch loss: a
global-batch term computed identically on every rank, or ``N *
local_sum / global_count``.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import socket
import subprocess
import sys
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    return rank() == 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def choose_backend(device, local_world: int) -> str:
    """NCCL when every rank of the node has a CUDA card of its own, gloo
    when ranks share a card or run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count())`` for a
    CUDA request without an index, else the request itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and is_initialized():
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda", timeout_s: float = 1800.0) -> bool:
    """Join the process group.  With explicit arguments: ``tcp://`` at
    ``coordinator_address`` (host:port), every process on this host
    (the dry run's launch).  With none: torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR/PORT, LOCAL_RANK, LOCAL_WORLD_SIZE) when it
    is set, a group of one included; otherwise a no-op (one process).
    Returns whether a group was joined; prints the backend chosen."""
    if coordinator_address is None and num_processes is None:
        if not all(k in os.environ for k in TORCHRUN_ENV):
            return False
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        me = int(os.environ["RANK"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    else:
        init_method = f"tcp://{coordinator_address}"
        world, me = int(num_processes), int(process_id)
        local_world = world
        os.environ.setdefault("LOCAL_RANK", str(me))
        os.environ.setdefault("LOCAL_WORLD_SIZE", str(world))
    backend = choose_backend(device, local_world)
    kw = {}
    dev = torch.device(device)
    if backend == "nccl":
        kw["device_id"] = torch.device(
            "cuda", local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(kw["device_id"])
    elif dev.type == "cuda":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=me,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _say(f"rank {me} of {world}: backend {backend} ({local_world} "
         f"rank(s) on this node, {torch.cuda.device_count()} CUDA "
         f"device(s)), device {rank_device(device)}")
    return True


def _say(line: str) -> None:
    """One line to stdout in one write, so ranks sharing a pipe do not
    interleave within it."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def rank_slice(n: int) -> Tuple[int, int]:
    """(lo, hi) of this rank's rows of a global batch of ``n``."""
    w = world_size()
    if n % w:
        raise ValueError(f"global batch {n} must divide over {w} ranks "
                         "(the data axis); pad it with "
                         "pad_batch_to_data_axis")
    per = n // w
    return rank() * per, (rank() + 1) * per


def local_rows(x):
    """This rank's rows of a global batch: a tensor, array or list, a
    dict of them (augmentation draws), or None."""
    if x is None or world_size() == 1:
        return x
    if isinstance(x, dict):
        return {k: local_rows(v) for k, v in x.items()}
    lo, hi = rank_slice(len(x))
    return x[lo:hi]


def pad_batch_to_data_axis(batch_size: int, ranks: Optional[int] = None
                           ) -> int:
    """Smallest batch size >= batch_size divisible by the ranks."""
    d = ranks or world_size()
    return -(-batch_size // d) * d


# ------------------------------------------------------------ collectives

def global_count(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over ranks, outside autograd (a count, a denominator);
    ``x`` itself with one rank."""
    if world_size() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


def mean_over_ranks(x) -> torch.Tensor:
    """Mean over ranks (a logged loss), outside autograd."""
    x = torch.as_tensor(x)
    if world_size() == 1:
        return x
    return global_count(x.float()) / world_size()


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over ranks that autograd differentiates: the backward pass
    sums the incoming gradients over ranks."""
    if world_size() == 1:
        return x
    import torch.distributed.nn.functional as dnn

    return dnn.all_reduce(x)


def _gather(x: torch.Tensor) -> torch.Tensor:
    w = world_size()
    dtype = torch.int64 if x.dtype == torch.bool else x.dtype
    buf = torch.zeros((w,) + tuple(x.shape), dtype=dtype, device=x.device)
    buf[rank()] = x
    dist.all_reduce(buf)
    return buf.reshape((w * x.shape[0],) + tuple(x.shape[1:])).to(x.dtype)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0; backward: the gradient summed over ranks,
    this rank's rows."""

    @staticmethod
    def forward(ctx, x):
        return _gather(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        n = g.shape[0] // world_size()
        return g[rank() * n:(rank() + 1) * n]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in rank order (the global
    batch); differentiable for float tensors."""
    if world_size() == 1:
        return x
    return _GatherRows.apply(x) if x.is_floating_point() else _gather(x)


def state_digest(tensors) -> str:
    """sha256 over the names and bytes of a state dict."""
    h = hashlib.sha256()
    for name, t in sorted(tensors.items()):
        h.update(name.encode())
        h.update(t.detach().reshape(-1).contiguous().cpu().view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def check_in_sync(tensors) -> str:
    """Raise unless every rank holds bit-identical ``tensors`` (the
    replicas of data parallelism must: identical averaged gradients,
    identical updates); returns the sha256.  The primary rank logs it."""
    digest = state_digest(tensors)
    if world_size() > 1:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        mine = torch.tensor(list(bytes.fromhex(digest)), dtype=torch.int64,
                            device=dev)
        rows = _gather(mine).reshape(world_size(), -1).cpu()
        if not bool((rows == rows[0]).all()):
            raise RuntimeError(
                "replicas out of sync: the ranks' parameters differ "
                f"({[bytes(r.tolist()).hex()[:16] for r in rows]})")
        if is_primary():
            _say(f"replicas in sync: the parameters of all {world_size()} "
                 f"ranks are bit-identical (sha256 {digest[:16]})")
    return digest


def average_gradients(params: Sequence[torch.Tensor]) -> None:
    """Mean over ranks of the gradients of parameters that DDP does not
    hold (the recognizer's aux proxies)."""
    if world_size() == 1:
        return
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad)
            p.grad /= world_size()


def wrap_ddp(model: torch.nn.Module, device) -> torch.nn.Module:
    """``model`` in DistributedDataParallel inside a process group, else
    itself.  Buffers are not broadcast: the BatchNorm running statistics
    come from all-reduced batch statistics, the same on every rank."""
    if not is_initialized():
        return model
    from torch.nn.parallel import DistributedDataParallel as DDP

    dev = torch.device(device)
    return DDP(model, device_ids=[dev.index] if dev.type == "cuda" else None,
               broadcast_buffers=False)


# ---------------------------------------------------------------- launch

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_argv(nproc: int, argv: List[str]) -> List[str]:
    """The command that runs ``python argv`` as ``nproc`` ranks on this
    host through torch's own launcher (``torchrun --standalone``)."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={nproc}", *argv]


def launch_if_multi_card(device, command: str,
                         argv: Optional[List[str]]) -> Optional[int]:
    """The trainers' rule, as the JAX commands train on every visible
    chip: started plainly (no torchrun environment) with a CUDA device
    and more than one visible card, start one rank per card running
    ``python -m effocr_torch <command> argv`` and return their exit code;
    otherwise None (train here)."""
    dev = torch.device(device)
    if (dev.type != "cuda" or dev.index is not None
            or any(k in os.environ for k in TORCHRUN_ENV)
            or torch.cuda.device_count() < 2):
        return None
    n = torch.cuda.device_count()
    print(f"{n} CUDA devices visible: one rank per device", flush=True)
    args = list(sys.argv[1:] if argv is None else argv)
    return subprocess.run(torchrun_argv(
        n, ["-m", "effocr_torch", command] + args)).returncode
