"""Recognizer training CLI — ``python -m effocr_torch train-recognizer``.

Flag for flag the JAX package's ``train-recognizer``, plus ``--device``
(default cuda).  As the JAX command trains on every visible chip, this
one trains data-parallel (core/distributed.py) on every visible card
without a flag: under ``torchrun`` each rank joins the group from the
environment; started plainly with more than one visible CUDA device it
starts one rank per device itself; with one device nothing changes.
Only the primary rank writes the run directory: args_log.json, model.json,
enc_best.msgpack, ref.npz/ref.txt, hns.txt, class_map.json (classifier
mode), metrics.jsonl, and last.msgpack/last_meta.json for --resume.
``--adjacent_font_path`` is refused (it needs a font renderer).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from effocr_torch.cli.common import (
    ann_stems,
    build_and_eval_index,
    default_render_indices,
    hardneg_queries,
)
from effocr_torch.core import distributed
from effocr_torch.core.config import EncoderConfig, RecognizerTrainConfig
from effocr_torch.core.device import resolve_device
from effocr_torch.data.folder import CharFolderDataset, split_indices
from effocr_torch.models.factory import create_classifier, create_encoder
from effocr_torch.train import checkpoint as ckpt
from effocr_torch.train.recognizer import RecognizerTrainer


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m effocr_torch "
                                "train-recognizer")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda unless cpu is asked for")
    p.add_argument("--root_dir_path", type=str, required=True)
    p.add_argument("--train_ann_path", type=str, required=True)
    p.add_argument("--val_ann_path", type=str, required=True)
    p.add_argument("--test_ann_path", type=str, required=True)
    p.add_argument("--run_name", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-6)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--num_epochs", type=int, default=5)
    p.add_argument("--temp", type=float, default=0.1)
    p.add_argument("--m", type=int, default=4)
    p.add_argument("--imsize", type=int, default=224)
    p.add_argument("--input_channels", type=int, default=3, choices=[1, 3])
    p.add_argument("--hns_txt_path", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--resume", action="store_true", default=False,
                   help="continue from <run_name>/last.msgpack (written by "
                        "either package)")
    p.add_argument("--lang", type=str, default="jp", choices=["jp", "en"])
    p.add_argument("--finetune", action="store_true", default=False)
    p.add_argument("--pretrain", action="store_true", default=False)
    p.add_argument("--high_blur", action="store_true", default=False)
    p.add_argument("--epoch_viz_dir", type=str, default=None)
    p.add_argument("--infer_hardneg_k", type=int, default=8)
    p.add_argument("--N_classes", type=int, default=None)
    p.add_argument("--test_at_end", action="store_true", default=False)
    p.add_argument("--auto_model", type=str, default="convnext_tiny")
    p.add_argument("--num_passes", type=int, default=1)
    p.add_argument("--no_aug", action="store_true", default=False)
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=["constant", "cosine"])
    p.add_argument("--warmup_frac", type=float, default=0.0)
    p.add_argument("--min_lr_frac", type=float, default=0.0)
    p.add_argument("--aux_ce_weight", type=float, default=0.0)
    p.add_argument("--aux_ce_temp", type=float, default=0.07)
    p.add_argument("--aux_init", type=str, default="embed",
                   choices=["embed", "random"])
    p.add_argument("--aux_lr_mult", type=float, default=1.0)
    p.add_argument("--ref_source", type=str, default="render",
                   choices=["render", "centroid"])
    p.add_argument("--centroid_cap", type=int, default=32)
    p.add_argument("--adam_b2", type=float, default=0.999)
    p.add_argument("--crop_sim", type=float, default=0.0)
    p.add_argument("--paired_jitter", type=float, default=0.0)
    p.add_argument("--adjacent_font_path", type=str, default=None,
                   help="not supported by this package (needs a font "
                        "renderer): refused")
    p.add_argument("--data_device", type=str, default="stream",
                   choices=["stream", "resident"],
                   help="resident: the dataset lives on the device as a "
                        "gray uint8 bank; steps gather there")
    p.add_argument("--eval_period", type=int, default=1)
    p.add_argument("--render_font_name", type=str, default=None)
    p.add_argument("--wandb", action="store_true", default=False)
    args = p.parse_args(argv)

    device = resolve_device(args.device)   # fail before writing anything
    if args.adjacent_font_path:
        raise NotImplementedError(
            "--adjacent_font_path renders a glyph bank with a font library "
            "this package does not have (ROADMAP.md, queue 1 item 7)")
    rc = distributed.launch_if_multi_card(device, "train-recognizer", argv)
    if rc is not None:
        sys.exit(rc)
    distributed.initialize_multihost(device=device)
    try:
        train(args, distributed.rank_device(device))
    finally:
        distributed.shutdown()


def train(args, device) -> None:
    primary = distributed.is_primary()
    os.makedirs(args.run_name, exist_ok=True)
    if primary:
        with open(os.path.join(args.run_name, "args_log.json"), "w") as f:
            json.dump({k: v for k, v in vars(args).items()
                       if k != "device"}, f, indent=2)
    # model identity for the inference loaders; crop_geometry from the
    # tree's dataset_meta.json (trees without one are "tight")
    crop_geometry = "tight"
    meta_path = os.path.join(args.root_dir_path, "dataset_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            crop_geometry = json.load(f).get("crop_geometry", "tight")
    if primary:
        with open(os.path.join(args.run_name, "model.json"), "w") as f:
            json.dump({"arch": args.auto_model, "image_size": args.imsize,
                       "num_classes": args.N_classes,
                       "input_channels": args.input_channels,
                       "crop_geometry": crop_geometry}, f)

    cfg = RecognizerTrainConfig(
        encoder=EncoderConfig(
            arch=args.auto_model, image_size=args.imsize,
            num_classes=args.N_classes,
            input_channels=args.input_channels,
        ),
        batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, num_epochs=args.num_epochs,
        temperature=args.temp, m_per_class=args.m,
        num_passes=args.num_passes, lang=args.lang,
        finetune=args.finetune, pretrain=args.pretrain,
        high_blur=args.high_blur, no_aug=args.no_aug,
        hns_txt_path=args.hns_txt_path,
        infer_hardneg_k=args.infer_hardneg_k,
        lr_schedule=args.lr_schedule, warmup_frac=args.warmup_frac,
        min_lr_frac=args.min_lr_frac, aux_ce_weight=args.aux_ce_weight,
        aux_ce_temp=args.aux_ce_temp, aux_init=args.aux_init,
        aux_lr_mult=args.aux_lr_mult, ref_source=args.ref_source,
        centroid_cap=args.centroid_cap, eval_period_epochs=args.eval_period,
        adam_b2=args.adam_b2, crop_sim=args.crop_sim,
        paired_jitter=args.paired_jitter,
        adjacent_font_path=args.adjacent_font_path,
        data_device=args.data_device,
    )

    classifier_mode = args.N_classes is not None
    if classifier_mode:
        model = create_classifier(args.auto_model, args.N_classes,
                                  in_channels=args.input_channels,
                                  image_size=args.imsize)
    else:
        model = create_encoder(args.auto_model,
                               in_channels=args.input_channels,
                               image_size=args.imsize)

    dataset = CharFolderDataset(args.root_dir_path)
    idx_train, idx_val, idx_test = split_indices(
        dataset, ann_stems(args.train_ann_path),
        ann_stems(args.val_ann_path), ann_stems(args.test_ann_path),
        finetune=args.finetune, pretrain=args.pretrain,
    )
    render_ref_idx = default_render_indices(
        dataset, args.lang, args.render_font_name
    )

    if classifier_mode and primary:
        idx_to_class = {
            v: chr(int(k)) for k, v in dataset.class_to_idx.items()
        }
        with open(os.path.join(args.run_name, "class_map.json"), "w") as f:
            json.dump(idx_to_class, f, indent=2)

    trainer = RecognizerTrainer(
        cfg, model, args.run_name, classifier_mode=classifier_mode,
        device=device, use_wandb=args.wandb,
    )
    trainer.init_state(cfg.seed)
    if args.checkpoint:
        trainer.set_variables(ckpt.load_variables(args.checkpoint))

    hardnegs = None
    if args.hns_txt_path:
        with open(args.hns_txt_path) as f:
            hardnegs = f.read().split()

    best = trainer.fit(dataset, idx_train, idx_val, render_ref_idx,
                       hardnegs=hardnegs, resume=args.resume)
    print(f"Best val accuracy: {best}")

    trainer.load_best()
    if not classifier_mode:
        index, acc = build_and_eval_index(
            trainer, dataset, render_ref_idx, cfg, idx_train,
            idx_test=idx_test, run_test=args.test_at_end,
        )
        if acc is not None:
            print(f"Final test acc: {acc}")
        if args.infer_hardneg_k:
            trainer.infer_hardneg(dataset, hardneg_queries(dataset,
                                                           idx_train),
                                  index, k=args.infer_hardneg_k)
    elif args.test_at_end:
        acc = trainer.eval_classifier(dataset, idx_test)
        print(f"Final test acc: {acc}")


if __name__ == "__main__":
    main()
