"""Recognizer retrieval visualization CLI (the JAX package's cli/viz.py).

    python -m effocr_torch viz --recognizer_dir rec --query_dir crops \
        --out_dir viz [--k 5] [--num 50] [--device cuda]

For each query crop (read through data/image_io.py with Pillow's RGB
conversion): embed on the device, retrieve the k nearest prototypes with
``PrototypeIndex.search``, and save [query | neighbours] as a PNG whose
name carries the match flag and the neighbours' code points, the JAX
command's names.  Adds ``--device`` (default cuda).
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob

import numpy as np
import torch

from effocr_torch.core.device import resolve_device, use_full_f32
from effocr_torch.data import image_io
from effocr_torch.interop.flax_bridge import flax_to_state_dict
from effocr_torch.interop.flax_msgpack import read_variables
from effocr_torch.kernels.image_ops import paired_transform_host
from effocr_torch.models.factory import create_encoder
from effocr_torch.retrieval.index import PrototypeIndex
from effocr_torch.train.checkpoint import best_checkpoint_path
from effocr_torch.utils.viz import save_knn_grid


def true_char(stem: str):
    """The ground-truth char of a crop file stem: the last 0x-prefixed
    part ({stem}_{annoid}_{hex} crops, PAIRED_{stem}_{annoid}_{hex}_{idx}
    tree files), or None."""
    hex_parts = [s for s in stem.split("_") if s.startswith("0x")]
    if hex_parts:
        try:
            return chr(int(hex_parts[-1], 16))
        except ValueError:
            pass
    return None


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m effocr_torch viz")
    p.add_argument("--recognizer_dir", type=str, required=True)
    p.add_argument("--query_dir", type=str, default=None,
                   help="directory of query crop PNGs")
    p.add_argument("--query_txt", type=str, default=None,
                   help="text file listing query image paths")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--num", type=int, default=50)
    p.add_argument("--seed", type=int, default=111,
                   help="query shuffle seed")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda unless cpu is asked for")
    args = p.parse_args(argv)
    if not (args.query_dir or args.query_txt):
        p.error("pass --query_dir or --query_txt")
    device = resolve_device(args.device)
    use_full_f32()

    with open(os.path.join(args.recognizer_dir, "model.json")) as f:
        meta = json.load(f)
    imsize = meta.get("image_size", 224)
    ch = meta.get("input_channels", 3)
    encoder = create_encoder(meta.get("arch", "convnext_tiny"),
                             in_channels=ch, image_size=imsize)
    encoder.load_state_dict(flax_to_state_dict(read_variables(
        best_checkpoint_path(args.recognizer_dir))), strict=True)
    encoder = encoder.to(device).eval()
    index = PrototypeIndex.load(args.recognizer_dir)

    if args.query_txt:
        with open(args.query_txt) as f:
            queries = f.read().split()
    else:
        queries = sorted(glob(os.path.join(args.query_dir, "*.png")))
    # n at random, with the JAX command's shuffle
    np.random.default_rng(args.seed).shuffle(queries)
    queries = queries[: args.num]
    for qp in queries:
        raw = image_io.read_rgb(qp)
        x = paired_transform_host(raw, imsize)
        if ch == 1:
            x = x.mean(axis=-1, keepdims=True)
        with torch.no_grad():
            emb = encoder(torch.from_numpy(x[None]).to(device)).float()
        _, idx = index.search(emb.cpu().numpy(), k=args.k, device=device)
        chars = [index.chars[i] for i in idx[0]]
        neighbors = []
        if index.thumbnails is not None:
            neighbors = [
                np.repeat(index.thumbnails[i][:, :, None], 3, axis=2)
                for i in idx[0]
            ]
        stem = os.path.splitext(os.path.basename(qp))[0]
        truth = true_char(stem)
        correct = (truth == chars[0]) if truth else None
        name = (f"{stem}_{correct}_nn_"
                f"{'-'.join(hex(ord(c)) for c in chars)}.png")
        save_knn_grid(raw, neighbors, os.path.join(args.out_dir, name),
                      correct=correct)
        print(f"{stem}: {''.join(chars)}")


if __name__ == "__main__":
    main()
