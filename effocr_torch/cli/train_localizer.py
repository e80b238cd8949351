"""Localizer training CLI — ``python -m effocr_torch train-localizer``.

Flag for flag the JAX package's ``train-localizer``, plus ``--device``
(default cuda); every ``--arch`` of the registry trains (YOLO, FCOS,
R-CNN).  As the JAX command trains on every visible chip, this one
trains data-parallel (core/distributed.py) on every visible card without
a flag: under ``torchrun`` each rank joins the group from the
environment; started plainly with more than one visible CUDA device it
starts one rank per device itself; with one device nothing changes.
Every rank steps on its slice of each ``--batch_size`` global batch.
Only the primary rank writes the run directory: args_log.json,
model.json (with the fitted ``anchors``, null for FCOS and R-CNN, and
the ``trained_heights``), best_bbox_mAP.msgpack (Flax layout),
metrics.jsonl, and last.msgpack (this package's
train-state layout).  As in the JAX command, ``--resume`` restores
last.msgpack and then runs ``--num_epochs`` epochs from epoch 0.

Besides the JAX command's metrics it logs, per epoch, the steps, images,
canvas height and seconds (the device synchronised at the epoch's end),
and the peak device memory at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from effocr_torch.core import distributed
from effocr_torch.core.config import LocalizerConfig, LocalizerTrainConfig
from effocr_torch.core.device import resolve_device
from effocr_torch.data.coco import load_json
from effocr_torch.data.detection import DetectionDataset
from effocr_torch.eval.coco_map import coco_map
from effocr_torch.models.factory import create_localizer
from effocr_torch.train import checkpoint as ckpt
from effocr_torch.train.localizer import LocalizerTrainer, fit_anchors


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m effocr_torch "
                                "train-localizer")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda unless cpu is asked for")
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--train_coco", type=str, required=True)
    p.add_argument("--val_coco", type=str, required=True)
    p.add_argument("--test_coco", type=str, default=None,
                   help="held-out test split: evaluated once with the "
                        "best checkpoint after training")
    p.add_argument("--run_name", type=str, required=True)
    p.add_argument("--arch", type=str, default="yolov5s")
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--input_size", type=int, default=640)
    p.add_argument("--input_height", type=int, default=None,
                   help="rectangular training canvas height (stride-32 "
                        "multiple)")
    p.add_argument("--multi_height", type=str, default=None,
                   help="comma-separated canvas-height tiers (e.g. "
                        "'64,96') cycled per epoch")
    p.add_argument("--input_channels", type=int, default=3, choices=[1, 3],
                   help="1 = grayscale-native detector")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--eval_period", type=int, default=1,
                   help="epochs between evals")
    p.add_argument("--resume", action="store_true", default=False,
                   help="restore <run_name>/last.msgpack (written by this "
                        "package), then train --num_epochs epochs")
    p.add_argument("--init_ckpt", type=str, default=None,
                   help="warm-start model weights from a variables "
                        "msgpack (e.g. another run's "
                        "best_bbox_mAP.msgpack)")
    p.add_argument("--augment", action="store_true", default=False,
                   help="on-device train augmentation: flip + scale "
                        "jitter + photometric")
    p.add_argument("--aug_flip_p", type=float, default=0.5)
    p.add_argument("--aug_scale", type=float, default=0.25)
    p.add_argument("--aug_translate", type=float, default=0.1)
    p.add_argument("--fit_anchors", action="store_true", default=False,
                   help="k-means anchor priors from the train boxes "
                        "(letterbox space), recorded in model.json")
    p.add_argument("--data_device", type=str, default="stream",
                   choices=["stream", "resident"],
                   help="resident: letterbox the corpus once into a "
                        "device uint8 bank; steps ship indices only")
    p.add_argument("--wandb", action="store_true", default=False)
    args = p.parse_args(argv)

    device = resolve_device(args.device)   # fail before writing anything
    rc = distributed.launch_if_multi_card(device, "train-localizer", argv)
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
    # model identity for the inference loaders (cli/infer.py load_engine)
    if args.multi_height and args.input_height is None:
        args.input_height = max(
            int(h) for h in args.multi_height.split(","))

    anchors = None
    if args.fit_anchors:
        coco = load_json(args.train_coco)
        dims = {im["id"]: (im["width"], im["height"])
                for im in coco["images"]}
        h_ref = args.input_height or args.input_size
        wh = []
        for a in coco["annotations"]:
            w_img, h_img = dims[a["image_id"]]
            r = min(h_ref / h_img, args.input_size / w_img)
            wh.append((a["bbox"][2] * r, a["bbox"][3] * r))
        fitted = fit_anchors(np.asarray(wh, np.float32))
        anchors = tuple(
            tuple(float(v) for v in fitted[3 * i: 3 * i + 3].reshape(-1))
            for i in range(3))
        print(f"fitted anchors (letterbox px, P3/P4/P5): {anchors}")

    if primary:
        with open(os.path.join(args.run_name, "model.json"), "w") as f:
            json.dump({"arch": args.arch, "num_classes": args.num_classes,
                       "input_size": args.input_size,
                       "input_height": args.input_height,
                       "input_channels": args.input_channels,
                       "anchors": ([list(a) for a in anchors]
                                   if anchors else None),
                       "trained_heights": sorted(
                           int(h) for h in (
                               args.multi_height.split(",")
                               if args.multi_height
                               else [args.input_height
                                     or args.input_size]))},
                      f)

    cfg = LocalizerTrainConfig(
        localizer=LocalizerConfig(
            arch=args.arch, input_size=args.input_size,
            input_height=args.input_height,
            num_classes=args.num_classes,
            input_channels=args.input_channels,
        ),
        batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, num_epochs=args.num_epochs,
        eval_period_epochs=args.eval_period,
        augment=args.augment, aug_flip_p=args.aug_flip_p,
        aug_scale=args.aug_scale, aug_translate=args.aug_translate,
    )

    heights = ([int(h) for h in args.multi_height.split(",")]
               if args.multi_height else [args.input_height])
    train_sets = [
        DetectionDataset(args.train_coco, args.image_dir, args.input_size,
                         input_height=h, channels=args.input_channels)
        for h in heights
    ]
    eval_height = max(h or args.input_size for h in heights)
    val_ds = DetectionDataset(args.val_coco, args.image_dir, args.input_size,
                              input_height=eval_height,
                              channels=args.input_channels)

    steps_per_epoch = max(len(train_sets[0]) // args.batch_size, 1)
    total_steps = steps_per_epoch * args.num_epochs

    loc_kw = {"anchors": anchors} if anchors else {}
    model = create_localizer(args.arch, num_classes=args.num_classes,
                             in_channels=args.input_channels, **loc_kw)
    trainer = LocalizerTrainer(cfg, model, args.run_name, total_steps,
                               device=device, use_wandb=args.wandb)
    trainer.init_state(cfg.seed)
    if args.init_ckpt:
        trainer.set_variables(ckpt.load_variables(args.init_ckpt))
        print(f"warm-started weights from {args.init_ckpt}")
    if args.resume:
        trainer.resume()

    cuda = device.type == "cuda"
    step = 0
    for epoch in range(args.num_epochs):
        train_ds = train_sets[epoch % len(train_sets)]
        t0, n_steps = time.perf_counter(), 0
        if args.data_device == "resident":
            trainer.attach_bank(train_ds)
            t0 = time.perf_counter()          # the bank's upload is set-up
            order = np.arange(len(train_ds))
            np.random.default_rng(cfg.seed + epoch).shuffle(order)
            losses = (
                trainer.train_step_bank(train_ds,
                                        order[s: s + args.batch_size])
                for s in range(0, len(order) - args.batch_size + 1,
                               args.batch_size))
        else:
            losses = (
                trainer.train_step(imgs, tgts, masks)
                for imgs, tgts, masks, _ in train_ds.batches(
                    args.batch_size, seed=cfg.seed + epoch))
        for loss, parts in losses:
            if step % 50 == 0:          # the only host sync of the loop
                # the global batch's loss: the mean over ranks
                loss = float(distributed.mean_over_ranks(loss))
                parts = {k: float(distributed.mean_over_ranks(v))
                         for k, v in parts.items()}
                trainer.metrics.log({"train/loss": loss, **parts},
                                    step=step)
                print(f"epoch {epoch} step {step}: loss={loss:.4f}")
            step += 1
            n_steps += 1
        if cuda:
            torch.cuda.synchronize(device)
        trainer.metrics.log({"epoch/steps": n_steps,
                             "epoch/images": n_steps * args.batch_size,
                             "epoch/height": train_ds.input_height,
                             "epoch/seconds": time.perf_counter() - t0},
                            step=step)
        if (epoch + 1) % args.eval_period == 0:
            result = trainer.evaluate(
                (b[0], b[3]) for b in val_ds.batches(
                    args.batch_size, shuffle=False, drop_last=False))
            print(f"epoch {epoch}: {result}")
        trainer.save("last")
    if cuda:
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        trainer.metrics.log({"device/peak_gib": peak}, step=step)
    if distributed.world_size() > 1:
        distributed.check_in_sync(trainer.model.state_dict())

    if args.test_coco:
        test_ds = DetectionDataset(args.test_coco, args.image_dir,
                                   args.input_size, input_height=eval_height,
                                   channels=args.input_channels)
        # score the BEST checkpoint, not the last epoch
        best = ckpt.best_checkpoint_path(args.run_name, "best_bbox_mAP")
        if os.path.exists(best):
            trainer.set_variables(ckpt.load_variables(best))
        preds, gts = trainer.predict(
            (b[0], b[3]) for b in test_ds.batches(
                args.batch_size, shuffle=False, drop_last=False))
        test_result = coco_map(preds, gts, num_classes=args.num_classes)
        trainer.metrics.log(
            {f"test/{k}": v for k, v in test_result.items()})
        print(f"test: {test_result}")


if __name__ == "__main__":
    main()
