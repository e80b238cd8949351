"""Ahead-of-time export of the recognizer — ``python -m effocr_torch
export`` (the JAX package's cli/export.py, which writes serialized
StableHLO through ``jax.export``).

The encoder (or classifier) of a recognizer_dir, as ``model.json`` and
``enc_best.msgpack`` define it, is traced by ``torch.export.export`` at a
fixed batch on the given device and written by ``torch.export.save``
(default ``<recognizer_dir>/enc_best.pt2``): a program any PyTorch
runtime reloads with ``torch.export.load(path).module()`` without the
model code.  Parity is checked as the JAX command checks it: the
reloaded program against the eager model on 2 random batches at
rtol/atol 0.05; the largest difference is printed.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from effocr_torch.cli.infer import load_recognizer
from effocr_torch.core.device import resolve_device

EXPORTED = "enc_best.pt2"


def export_encoder(recognizer_dir: str, out_path: Optional[str] = None,
                   batch: int = 64, check: bool = True,
                   device: str = "cuda") -> str:
    """Export the recognizer's forward at [batch, size, size, channels]
    float32 NHWC on ``device`` (default cuda); returns the path written.
    With ``check`` the reloaded program is held to the eager model."""
    dev = resolve_device(device)
    out_path = out_path or os.path.join(recognizer_dir, EXPORTED)
    model, meta = load_recognizer(recognizer_dir)
    size, ch = meta.get("image_size", 224), meta.get("input_channels", 3)
    model = model.to(dev)
    spec = torch.zeros((batch, size, size, ch), dtype=torch.float32,
                       device=dev)
    with torch.no_grad():
        exported = torch.export.export(model, (spec,))
    torch.export.save(exported, out_path)

    if check:
        reloaded = torch.export.load(out_path).module()
        rng = np.random.default_rng(0)
        worst = 0.0
        for _ in range(2):
            x = torch.from_numpy(rng.normal(size=(batch, size, size, ch))
                                 .astype(np.float32)).to(dev)
            with torch.no_grad():
                got = reloaded(x).float().cpu().numpy()
                want = model(x).float().cpu().numpy()
            np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
            worst = max(worst, float(np.abs(got - want).max()))
        print(f"parity check passed (2 batches, rtol/atol 0.05); "
              f"max |reloaded - eager| {worst:.3g}")
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m effocr_torch export")
    p.add_argument("--recognizer_dir", required=True)
    p.add_argument("--out", default=None,
                   help=f"default: <recognizer_dir>/{EXPORTED}")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--no_check", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda unless cpu is asked for")
    args = p.parse_args(argv)
    path = export_encoder(args.recognizer_dir, args.out, args.batch,
                          check=not args.no_check, device=args.device)
    print(f"exported {path}")


if __name__ == "__main__":
    main()
