"""Standalone prototype-index build from a training run directory —
``python -m effocr_torch build-index --run_dir RUN [--test]
[--mine_hardneg K] [--device cuda]`` (the JAX package's ``build-index``).

Rebuilds ref.npz/ref.txt from the run's enc_best.msgpack (written
atomically, so a live run can be harvested at any epoch) and its own
args_log.json; optionally reports test precision@1 and mines k-NN hard
negatives from the train split into hns.txt.
"""

from __future__ import annotations

import argparse
import json
import os

from effocr_torch.cli.common import (
    ann_stems,
    build_and_eval_index,
    default_render_indices,
    hardneg_queries,
)
from effocr_torch.core.config import EncoderConfig, RecognizerTrainConfig
from effocr_torch.core.device import resolve_device
from effocr_torch.data.folder import CharFolderDataset, split_indices
from effocr_torch.models.factory import create_encoder
from effocr_torch.train.recognizer import RecognizerTrainer


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m effocr_torch build-index")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda unless cpu is asked for")
    p.add_argument("--run_dir", type=str, required=True,
                   help="training run dir holding enc_best.msgpack + "
                        "args_log.json")
    p.add_argument("--root_dir_path", type=str, default=None,
                   help="dataset root (default: args_log.json value)")
    p.add_argument("--test", action="store_true", default=False,
                   help="also report kNN precision@1 on the test split")
    p.add_argument("--mine_hardneg", type=int, default=0, metavar="K",
                   help="also mine k-NN hard negatives from the train "
                        "split into <run_dir>/hns.txt")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    with open(os.path.join(args.run_dir, "args_log.json")) as f:
        a = json.load(f)
    if a.get("N_classes"):
        raise SystemExit("classifier-mode runs have no prototype index; "
                         "use class_map.json directly")

    ch = a.get("input_channels", 3)
    cfg = RecognizerTrainConfig(
        encoder=EncoderConfig(arch=a["auto_model"], image_size=a["imsize"],
                              input_channels=ch),
        batch_size=a["batch_size"], lang=a["lang"],
        temperature=a["temp"], m_per_class=a["m"],
        ref_source=a.get("ref_source", "render"),
        centroid_cap=a.get("centroid_cap", 32),
        finetune=a.get("finetune", False),
        pretrain=a.get("pretrain", False),
    )
    dataset = CharFolderDataset(args.root_dir_path or a["root_dir_path"])
    idx_train, _, idx_test = split_indices(
        dataset, ann_stems(a["train_ann_path"]),
        ann_stems(a["val_ann_path"]), ann_stems(a["test_ann_path"]),
        finetune=cfg.finetune, pretrain=cfg.pretrain,
    )
    render_ref_idx = default_render_indices(
        dataset, a["lang"], a.get("render_font_name")
    )

    trainer = RecognizerTrainer(
        cfg, create_encoder(a["auto_model"], in_channels=ch,
                            image_size=a["imsize"]), args.run_dir,
        classifier_mode=False, device=device,
    )
    trainer.load_best()

    index, acc = build_and_eval_index(
        trainer, dataset, render_ref_idx, cfg, idx_train,
        idx_test=idx_test, run_test=args.test,
    )
    print(f"ref index: {index.embeddings.shape[0]} rows "
          f"-> {os.path.join(args.run_dir, 'ref.npz')}")
    if acc is not None:
        print(f"Test precision@1: {acc}")

    if args.mine_hardneg:
        lines = trainer.infer_hardneg(dataset, hardneg_queries(dataset,
                                                               idx_train),
                                      index, k=args.mine_hardneg)
        print(f"hard negatives: {len(lines)} queries "
              f"-> {os.path.join(args.run_dir, 'hns.txt')}")


if __name__ == "__main__":
    main()
