"""COCO split / combine / subset — ``python -m effocr_torch
coco-split|coco-combine|coco-subset`` (the JAX package's
cli/coco_tools.py)."""

from __future__ import annotations

import argparse

from effocr_torch.data.coco import (
    combine_coco_jsons,
    load_json,
    save_json,
    split_coco_json,
    subset_coco_json,
)


def main(cmd: str, argv=None):
    p = argparse.ArgumentParser(
        prog=f"python -m effocr_torch {cmd.replace('_', '-')}")
    if cmd == "coco_split":
        p.add_argument("--coco_json", required=True)
        p.add_argument("--out_prefix", required=True)
        p.add_argument("--train_frac", type=float, default=0.8)
        p.add_argument("--val_frac", type=float, default=0.1)
        p.add_argument("--seed", type=int, default=99)
        a = p.parse_args(argv)
        tr, va, te = split_coco_json(
            load_json(a.coco_json), a.train_frac, a.val_frac, a.seed
        )
        for name, obj in (("train", tr), ("val", va), ("test", te)):
            save_json(obj, f"{a.out_prefix}_{name}.json")
            print(f"{name}: {len(obj['images'])} images")
    elif cmd == "coco_combine":
        p.add_argument("--coco_json_a", required=True)
        p.add_argument("--coco_json_b", required=True)
        p.add_argument("--out", required=True)
        a = p.parse_args(argv)
        merged = combine_coco_jsons(
            load_json(a.coco_json_a), load_json(a.coco_json_b)
        )
        save_json(merged, a.out)
        print(f"combined: {len(merged['images'])} images")
    elif cmd == "coco_subset":
        p.add_argument("--coco_json", required=True)
        p.add_argument("--n", type=int, required=True)
        p.add_argument("--out", required=True)
        p.add_argument("--seed", type=int, default=0)
        a = p.parse_args(argv)
        sub = subset_coco_json(load_json(a.coco_json), a.n, a.seed)
        save_json(sub, a.out)
        print(f"subset: {len(sub['images'])} images")


if __name__ == "__main__":
    main("coco_split")
