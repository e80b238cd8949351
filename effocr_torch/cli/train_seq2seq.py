"""Seq2seq (TrOCR-style) baseline train + eval CLI, the JAX package's
cli/train_seq2seq.py:

    python -m effocr_torch train-seq2seq --image_dir images \
        --train_coco train.json --val_coco val.json --run_name s2s \
        [--data_device resident] [--device cuda]

Every flag of the JAX command, plus ``--device`` (default cuda).  The
model starts from Flax's initializers (baselines/seq2seq.py
``init_params``, seed 0) and trains with ``optax.adamw(lr)``'s
arithmetic (train/optim.py AdamW, weight decay 1e-4 on every
parameter).  After each epoch the val split is decoded (greedy, or beam
search with ``--num_beams`` > 1) and the checkpoint with the lowest CER
so far is written as ``seq2seq_best.msgpack`` in Flax's format, which
the JAX package's ``load_variables`` reads (and this command's output
the other way round).  ``charset.json`` holds the JAX command's bytes.
Besides the JAX command's metrics, metrics.jsonl gets per epoch the
steps, images, seconds and mean loss (``epoch/*``) and the decode's
seconds (``val/seconds``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from effocr_torch.baselines.data import Seq2SeqDataset, charset_from_coco
from effocr_torch.baselines.seq2seq import (
    CharTokenizer,
    Seq2SeqOCR,
    beam_decode,
    greedy_decode,
    init_params,
    make_seq2seq_train_step,
)
from effocr_torch.core.device import resolve_device, upload, use_full_f32
from effocr_torch.eval.textline import textline_evaluation
from effocr_torch.interop.flax_bridge import state_dict_to_flax
from effocr_torch.train import checkpoint as ckpt
from effocr_torch.train.metrics import MetricsWriter
from effocr_torch.train.optim import AdamW


def decode(model, images, args):
    """Token rows [B, max_len - 1] on the host, greedy or beam."""
    if args.num_beams > 1:
        out = beam_decode(model, images, max_len=args.max_len,
                          beam_size=args.num_beams)
    else:
        out = greedy_decode(model, images, max_len=args.max_len)
    return out.cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m effocr_torch train-seq2seq")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda unless cpu is asked for")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--train_coco", required=True)
    p.add_argument("--val_coco", required=True)
    p.add_argument("--run_name", required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--num_epochs", type=int, default=20)
    p.add_argument("--max_len", type=int, default=64)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--img_h", type=int, default=64)
    p.add_argument("--img_w", type=int, default=512)
    p.add_argument("--num_beams", type=int, default=1,
                   help="beam width for eval decode (reference default 4); "
                        "1 = greedy")
    p.add_argument("--data_device", choices=["stream", "resident"],
                   default="stream",
                   help="resident: decode the corpus once into a "
                        "device-resident uint8 bank and ship int32 indices "
                        "per step")
    args = p.parse_args(argv)
    device = resolve_device(args.device)     # fail before writing anything
    use_full_f32()

    os.makedirs(args.run_name, exist_ok=True)
    charset = charset_from_coco([args.train_coco, args.val_coco])
    tok = CharTokenizer(charset)
    with open(os.path.join(args.run_name, "charset.json"), "w") as f:
        json.dump(tok.chars, f, ensure_ascii=False)

    model = init_params(Seq2SeqOCR(
        vocab_size=tok.vocab_size, img_h=args.img_h, img_w=args.img_w,
        dim=args.dim, max_len=args.max_len), 0).to(device)
    train_ds = Seq2SeqDataset(args.train_coco, args.image_dir, tok,
                              args.img_h, args.img_w, args.max_len)
    val_ds = Seq2SeqDataset(args.val_coco, args.image_dir, tok,
                            args.img_h, args.img_w, args.max_len)
    optimizer = AdamW([(list(model.parameters()), args.lr)])
    resident = args.data_device == "resident"
    step = make_seq2seq_train_step(model, optimizer, bank_mode=resident)
    metrics = MetricsWriter(args.run_name)

    if resident:
        bank = tuple(torch.from_numpy(a).to(device)
                     for a in train_ds.materialize())
        val_bank = torch.from_numpy(val_ds.materialize()[0]).to(device)

    best_cer = float("inf")
    it = 0
    for epoch in range(args.num_epochs):
        if resident:
            batch_iter = (
                (*bank, upload(torch.from_numpy(idx).long(), device))
                for idx, _ in train_ds.index_batches(args.batch_size,
                                                     seed=epoch))
        else:
            batch_iter = (
                tuple(upload(torch.from_numpy(a), device)
                      for a in (xs, ids, masks))
                for xs, ids, masks, _ in train_ds.batches(args.batch_size,
                                                          seed=epoch))
        model.train()
        t0, n_steps = time.perf_counter(), 0
        loss_sum = torch.zeros((), device=device)
        for batch in batch_iter:
            loss = step(*batch)
            loss_sum += loss
            if it % 50 == 0:
                metrics.log({"train/loss": float(loss)}, step=it)
                print(f"epoch {epoch} it {it}: loss={float(loss):.4f}")
            it += 1
            n_steps += 1
        mean_loss = float(loss_sum) / max(n_steps, 1)   # waits for the card
        seconds = time.perf_counter() - t0
        metrics.log({"epoch/steps": n_steps,
                     "epoch/images": n_steps * args.batch_size,
                     "epoch/seconds": seconds, "epoch/loss": mean_loss},
                    step=it)

        model.eval()
        pairs = []
        t0 = time.perf_counter()
        if resident:
            eval_iter = (
                (val_bank[upload(torch.from_numpy(idx).long(), device)],
                 texts)
                for idx, texts in val_ds.index_batches(
                    args.batch_size, shuffle=False, drop_last=False))
        else:
            eval_iter = (
                (upload(torch.from_numpy(xs), device), texts)
                for xs, _, _, texts in val_ds.batches(
                    args.batch_size, shuffle=False, drop_last=False))
        for xs, texts in eval_iter:
            for row, gt in zip(decode(model, xs, args), texts):
                pairs.append((gt, tok.decode(row)))
        acc, cer = textline_evaluation(pairs)
        metrics.log({"val/accuracy": acc, "val/cer": cer,
                     "val/seconds": time.perf_counter() - t0}, step=it)
        print(f"epoch {epoch}: acc={acc:.2f} cer={cer:.4f}")
        if cer <= best_cer:
            best_cer = cer
            ckpt.save_variables(
                state_dict_to_flax(model.state_dict()),
                os.path.join(args.run_name, "seq2seq_best.msgpack"))
    print(f"Best val CER: {best_cer}")


if __name__ == "__main__":
    main()
