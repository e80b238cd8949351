"""Multi-process dry run and one data-parallel step on N ranks: the
port's counterpart of the JAX package's scripts/dryrun_multihost.py and
``__graft_entry__.dryrun_multichip``.

    python -m effocr_torch.core.dryrun [--nproc 2] [--device cpu|cuda]

starts ``--nproc`` processes on this host, each joining the process
group with explicit coordinator arguments (``initialize_multihost``),
runs one recognizer step (mobilenetv3_small_050 at 32 px, batch 16,
SupCon + the aux head, augmentation on) and one localizer step (yolov5n
on a 64 x 128 gray canvas, batch 8, augmentation on) through the
trainers, prints a digest of every rank's parameters, and checks that
the digests are bit-identical: ``dryrun_multihost OK``.  On one card the
ranks share it over gloo.

``run_ranks(specs, nproc, device)`` runs, on ``nproc`` spawned ranks,
one step of either trainer's step function (``make_train_step`` /
``make_detector_train_step``) per spec and returns each rank's loss (the
global batch's), gradients after DDP's averaging and buffers (the new
BatchNorm statistics); ``run_step(spec, device)`` does the same in this
process, on the whole batch when no group is joined.  A spec holds the
model (a module, pickled), its config, the global batch and its
augmentation draws; or (kind "loss") a detector family's raw outputs
for ``fcos_loss`` / ``rcnn_loss`` alone.
"""

from __future__ import annotations

import argparse
import copy
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from effocr_torch.core import distributed

N_PROC = 2


class GradRecorder:
    """An optimizer stand-in that keeps the gradients it is asked to step
    with and leaves the parameters alone."""

    def __init__(self, named: Dict[str, torch.Tensor]):
        self.named = named
        self.grads: Dict[str, torch.Tensor] = {}

    def zero_grad(self):
        for p in self.named.values():
            p.grad = None

    def step(self):
        self.grads = {k: p.grad.detach().cpu().clone()
                      for k, p in self.named.items() if p.grad is not None}


def _to(x, dev):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return torch.as_tensor(x).to(dev)


def _local_raw(x, b: int):
    """This rank's rows of a detector's raw outputs: every tensor whose
    leading axis is the batch, the shared anchors left whole."""
    if isinstance(x, dict):
        return {k: v if k == "anchors" else _local_raw(v, b)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_local_raw(v, b) for v in x]
    if torch.is_tensor(x) and x.dim() and x.shape[0] == b:
        return distributed.local_rows(x)
    return x


def run_loss(spec: Dict) -> Dict:
    """A family's loss on this rank's rows of the spec's raw outputs:
    {"loss", "parts"}, the means over ranks (the global batch's)."""
    from effocr_torch.models.fcos import fcos_loss
    from effocr_torch.models.rcnn import rcnn_loss

    fn = {"fcos": fcos_loss, "rcnn": rcnn_loss}[spec["loss"]]
    targets, mask = (torch.as_tensor(a) for a in spec["targets"])
    loss, parts = fn(_local_raw(spec["raw"], targets.shape[0]),
                     distributed.local_rows(targets),
                     distributed.local_rows(mask), num_classes=2)
    return {"loss": float(distributed.mean_over_ranks(loss)),
            "local_loss": float(loss),
            "parts": {k: float(distributed.mean_over_ranks(v))
                      for k, v in parts.items()}}


def run_step(spec: Dict, device="cpu") -> Dict:
    """One step of the spec's trainer step function on this rank's slice
    of the global batch: {"loss" (global), "local_loss", "grads",
    "buffers"}; with ``spec["profile"]`` a second, profiled step adds
    "step_ms" and the collectives' times."""
    from effocr_torch.core.device import use_full_f32

    if spec["kind"] == "loss":
        return run_loss(spec)
    use_full_f32()
    dev = distributed.rank_device(device)
    model = copy.deepcopy(spec["model"]).to(dev)
    net = distributed.wrap_ddp(model, dev)
    named = dict(model.named_parameters())
    aux = None
    if spec.get("aux") is not None:
        aux = spec["aux"].clone().to(dev).requires_grad_(True)
        named["aux"] = aux
    rec = GradRecorder(named)
    bank = spec["bank"]
    batch = [torch.as_tensor(a) for a in spec["batch"]]
    if bank:      # the bank on every rank, this rank's slice of idx
        batch = [_to(a, dev) for a in batch[:-1]] + [
            _to(distributed.local_rows(batch[-1]), dev)]
    else:
        batch = [_to(distributed.local_rows(a), dev) for a in batch]
    draws = _to(distributed.local_rows(spec.get("draws")), dev)
    if spec["kind"] == "recognizer":
        from effocr_torch.train.recognizer import make_train_step

        step = make_train_step(net, spec["cfg"], rec,
                               spec.get("classifier_mode", False), aux=aux,
                               bank_mode=bank)

        def once():
            return step(*batch, draws)
    else:
        from effocr_torch.train.localizer import make_detector_train_step

        step = make_detector_train_step(net, spec["cfg"], rec,
                                        getattr(model, "anchors", None),
                                        bank_mode=bank)

        def once():
            return step(*batch, draws)[0]
    loss = once()
    out = {"loss": float(distributed.mean_over_ranks(loss)),
           "local_loss": float(loss), "grads": rec.grads,
           "buffers": {k: v.detach().cpu().clone()
                       for k, v in model.named_buffers()}}
    if spec.get("profile"):
        out.update(_profiled(once, dev))
    return out


def _profiled(once, dev) -> Dict[str, float]:
    """Wall time of one more step and the time of its collectives
    (torch.profiler events named after all-reduce / gloo / nccl)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        once()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    step_ms = (time.perf_counter() - t0) * 1e3
    host = dev_ms = 0.0
    n = 0
    for ev in prof.key_averages():
        name = ev.key.lower()
        if not any(w in name for w in ("all_reduce", "allreduce", "gloo",
                                       "nccl")):
            continue
        n += ev.count
        # only the outermost ranges: c10d::allreduce_ (host) and the
        # nccl / gloo device kernels
        if name.startswith("c10d::allreduce"):
            host += ev.cpu_time_total / 1e3
        dev_ms += getattr(ev, "device_time_total",
                          getattr(ev, "cuda_time_total", 0.0)) / 1e3
    return {"step_ms": step_ms, "collective_host_ms": host,
            "collective_device_ms": dev_ms, "collective_events": n}


def _worker_env() -> Dict[str, str]:
    env = {k: v for k, v in os.environ.items()
           if k not in distributed.TORCHRUN_ENV
           and k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_workers(argvs: List[List[str]], timeout_s: float) -> List[str]:
    """Start one ``python -m effocr_torch.core.dryrun`` per argv and wait;
    if one fails or the time runs out, stop the others and raise."""
    env = _worker_env()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "effocr_torch.core.dryrun"] + a,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for a in argvs]
    outs: List[Optional[str]] = [None] * len(procs)
    try:
        deadline = time.monotonic() + timeout_s
        for i, p in enumerate(procs):
            outs[i], _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError("\n".join(
            f"--- rank {i} exit {procs[i].returncode}:\n{outs[i]}"
            for i in bad))
    return outs


def _rank_args(nproc: int, device: str, timeout_s: float) -> List[List[str]]:
    port = distributed.free_port()
    return [["--worker", str(r), "--nproc", str(nproc), "--port",
             str(port), "--device", device, "--timeout", str(timeout_s)]
            for r in range(nproc)]


def run_ranks(specs, nproc: int = N_PROC, device: str = "cpu",
              timeout_s: float = 300.0) -> List:
    """``run_step`` of a spec (or of each of a list of specs, in one
    launch) on ``nproc`` spawned ranks: one result (or list) per rank."""
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = os.path.join(tmp, "spec.pt")
        torch.save(specs, spec_path)
        argvs = [a + ["--step", spec_path, "--out",
                      os.path.join(tmp, f"rank{r}.pt")]
                 for r, a in enumerate(_rank_args(nproc, device, timeout_s))]
        _run_workers(argvs, timeout_s)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(nproc)]


def _dryrun_steps(device: str, run_dir: str) -> Dict[str, object]:
    """One recognizer and one localizer step through the trainers on this
    rank; returns their parameter digests and global losses."""
    from effocr_torch.core.config import (
        EncoderConfig,
        LocalizerConfig,
        LocalizerTrainConfig,
        RecognizerTrainConfig,
    )
    from effocr_torch.data.transforms import draw_augment
    from effocr_torch.models.factory import create_encoder, create_localizer
    from effocr_torch.train.localizer import LocalizerTrainer
    from effocr_torch.train.recognizer import RecognizerTrainer

    f32 = torch.float32
    rng = np.random.default_rng(0)
    b, size = 16, 32
    cfg = RecognizerTrainConfig(
        encoder=EncoderConfig(arch="mobilenetv3_small_050", image_size=size),
        batch_size=b, lang="en", aux_ce_weight=0.5)
    tr = RecognizerTrainer(cfg, create_encoder(
        "mobilenetv3_small_050", dtype=f32), os.path.join(run_dir, "rec"),
        device=device)
    tr.init_state(0)
    tr.aux = torch.zeros((4, tr.model.out_features), device=tr.device,
                         requires_grad=True)
    with torch.no_grad():
        tr.aux.normal_(generator=torch.Generator(tr.device).manual_seed(1))
    tr._build_optimizer(1)
    imgs = rng.integers(0, 255, (b, size, size, 3), np.uint8)
    targets = (np.arange(b) % 4).astype(np.int64)
    paired = np.zeros((b,), bool)
    gen = torch.Generator(device=tr.device).manual_seed(7)
    draws = draw_augment(gen, b, size, lang="en")
    rec_loss = tr._step_fn(*(_to(distributed.local_rows(a), tr.device)
                             for a in (imgs, targets, paired)),
                           distributed.local_rows(draws))

    lcfg = LocalizerTrainConfig(
        localizer=LocalizerConfig(arch="yolov5n", input_size=128,
                                  input_height=64, input_channels=1),
        batch_size=8, augment=True)
    lt = LocalizerTrainer(lcfg, create_localizer(
        "yolov5n", 2, in_channels=1, dtype=f32),
        os.path.join(run_dir, "loc"), total_steps=1, device=device)
    lt.init_state(0)
    limgs = rng.integers(0, 255, (8, 64, 128, 1), np.uint8)
    tg = np.zeros((8, 16, 5), np.float32)
    tg[..., 1:] = rng.uniform([8, 8, 4, 8], [120, 56, 16, 24], (8, 16, 4))
    tg[..., 0] = rng.integers(0, 2, (8, 16))
    mask = rng.uniform(size=(8, 16)) < 0.8
    loc_loss, _ = lt.train_step(limgs, tg, mask)
    return {"recognizer": distributed.state_digest(
        {**tr.model.state_dict(), "aux": tr.aux}),
        "localizer": distributed.state_digest(lt.model.state_dict()),
        "rec_loss": float(distributed.mean_over_ranks(rec_loss)),
        "loc_loss": float(distributed.mean_over_ranks(loc_loss))}


def dryrun(nproc: int = N_PROC, device: str = "cpu",
           timeout_s: float = 600.0) -> List[Dict[str, str]]:
    """Start ``nproc`` ranks, one recognizer and one localizer step each;
    raise unless every rank's parameters are bit-identical."""
    with tempfile.TemporaryDirectory() as tmp:
        argvs = [a + ["--run_dir", tmp]
                 for a in _rank_args(nproc, device, timeout_s)]
        outs = _run_workers(argvs, timeout_s)
    rows = []
    for out in outs:
        line = [ln for ln in out.splitlines()
                if ln.startswith("DRYRUN_DIGEST")]
        if not line:
            raise RuntimeError(f"a rank printed no digest:\n{out}")
        rows.append(dict(kv.split("=", 1) for kv in line[0].split()[1:]))
    for key in ("recognizer", "localizer"):
        if len({r[key] for r in rows}) != 1:
            raise AssertionError(f"{key} parameters differ across ranks: "
                                 f"{[r[key] for r in rows]}")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m effocr_torch.core.dryrun")
    p.add_argument("--nproc", type=int, default=N_PROC)
    p.add_argument("--device", default="cpu")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--worker", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--step", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--run_dir", default=None)
    args = p.parse_args(argv)
    if args.worker is None:
        rows = dryrun(args.nproc, args.device, args.timeout)
        for r, row in enumerate(rows):
            print(f"rank {r}: " + " ".join(f"{k}={v}" for k, v in
                                            row.items()))
        print(f"dryrun_multihost OK: {args.nproc} processes, params "
              "bit-identical after one recognizer and one localizer step")
        return 0
    torch.set_num_threads(2)
    distributed.initialize_multihost(
        coordinator_address=f"127.0.0.1:{args.port}",
        num_processes=args.nproc, process_id=args.worker,
        device=args.device, timeout_s=args.timeout)
    try:
        if args.step:
            specs = torch.load(args.step, weights_only=False)
            torch.save([run_step(s, args.device) for s in specs]
                       if isinstance(specs, list)
                       else run_step(specs, args.device), args.out)
        else:
            row = _dryrun_steps(args.device, args.run_dir)
            print("DRYRUN_DIGEST " + " ".join(
                f"{k}={v}" for k, v in row.items()), flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
