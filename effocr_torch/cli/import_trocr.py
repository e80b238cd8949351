"""Import a published HF TrOCR checkpoint, evaluate and fine-tune it: the
JAX package's cli/import_trocr.py.

    python -m effocr_torch import-trocr --model_dir hf_ckpt [--check] \
        [--coco_json lines.json --image_dir imgs] \
        [--train_coco_json tr.json --val_coco_json va.json] [--device cuda]

Every flag of the JAX command, plus ``--device`` (default cuda).  The
checkpoint (or a raw fairseq ``--fairseq_pt``) becomes the npz artifact
both packages read (``trocr_tpu.npz`` by default, the JAX command's
name).  ``--check`` holds the converted model's teacher-forced logits to
baselines/trocr_hf_reference.py (the HF-layout weights under HF's names,
float64) at rtol/atol 2e-3, where the JAX command asks
``transformers.VisionEncoderDecoderModel``; it fails, never warns.
``--coco_json`` decodes COCO text lines (greedy, or beam search with
``--num_beams`` > 1) and scores them with eval/textline.py;
``--train_coco_json`` fine-tunes first (AdamW with ``optax.adamw(lr)``'s
arithmetic, the last partial batch dropped, greedy CER on the val split
after each epoch, the best checkpoint kept at ``cer <= best``).  Images
are read by data/image_io.py (Pillow's RGB conversion) and resized by
data/folder.py ``pil_bilinear_resize``; the tokenizer is
baselines/tokenizer.py.  Besides the JAX command's lines, it prints the
check's largest gap, each epoch's steps, images, seconds and mean loss,
and each decode's seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def _special_ids(model_dir: str, tok=None):
    """Resolve (decoder_start, eos, pad) for a checkpoint directory.

    HF diff-serializes configs (default-valued keys are left out of
    config.json, e.g. TrOCRConfig's decoder_start_token_id=2) and older
    checkpoints carry present-but-null keys; no ``or`` fallback, which
    would discard a legitimate token id 0.  Published TrOCR checkpoints
    start decoding with decoder_start_token_id=2 (</s>, the BART
    convention)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    dec = cfg.get("decoder") or {}

    def pick(*vals):
        for v in vals:
            if v is not None:
                return int(v)
        raise AssertionError("unreachable: last candidate is a literal")

    start = pick(cfg.get("decoder_start_token_id"),
                 dec.get("decoder_start_token_id"), 2)
    eos = pick(dec.get("eos_token_id"), cfg.get("eos_token_id"),
               getattr(tok, "eos_token_id", None) if tok else None,
               getattr(tok, "sep_token_id", None) if tok else None, 2)
    pad = pick(dec.get("pad_token_id"), cfg.get("pad_token_id"),
               getattr(tok, "pad_token_id", None) if tok else None, 1)
    return start, eos, pad


def load_line(path: str, size: int) -> np.ndarray:
    """uint8 [size, size, 3]: ``Image.open(path).convert("RGB").resize(
    (size, size), Image.BILINEAR)``."""
    from effocr_torch.data.folder import pil_bilinear_resize
    from effocr_torch.data.image_io import read_rgb

    return pil_bilinear_resize(read_rgb(path), size, size)


def check_against_reference(model_dir: str, params, spec, device) -> float:
    """The converted model's teacher-forced logits against the float64
    HF-layout reference on 2 seeded images and 8 ids (the JAX command's
    inputs); raises past rtol/atol 2e-3; returns the largest gap."""
    from effocr_torch.baselines.trocr_hf_reference import hf_reference_logits
    from effocr_torch.baselines.trocr_import import TrOCR, read_hf_state_dict

    with open(os.path.join(model_dir, "config.json")) as f:
        config = json.load(f)
    rng = np.random.default_rng(0)
    pix = rng.normal(
        size=(2, spec.image_size, spec.image_size, 3)).astype(np.float32)
    ids = rng.integers(3, spec.vocab_size, size=(2, 8)).astype(np.int64)
    ref = hf_reference_logits(read_hf_state_dict(model_dir), config, pix,
                              ids, device=device)
    model = TrOCR.from_flat(params, spec).to(device).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(pix).to(device),
                    torch.from_numpy(ids).to(device)).cpu().numpy()
    del model
    gap = float(np.abs(got - ref).max())
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
    return gap


def convert(model_dir: str, out_path: str, check: bool = False,
            fairseq_pt: str = None, device="cuda") -> str:
    from effocr_torch.baselines.trocr_import import (
        import_fairseq_checkpoint,
        import_hf_checkpoint,
        save_trocr_npz,
    )

    if fairseq_pt:
        # raw fairseq/unilm checkpoint: the renaming hop first, then HF ->
        # the flat params
        params, spec = import_fairseq_checkpoint(fairseq_pt)
    else:
        params, spec = import_hf_checkpoint(model_dir)
    save_trocr_npz(out_path, params, spec)
    n_params = sum(int(np.prod(v.shape)) for v in params.values())
    print(f"converted: {spec.enc_layers}L/{spec.enc_hidden}d encoder + "
          f"{spec.dec_layers}L/{spec.dec_hidden}d decoder, vocab "
          f"{spec.vocab_size}, {n_params / 1e6:.1f}M params -> {out_path}")

    if check:
        gap = check_against_reference(model_dir, params, spec,
                                      torch.device(device))
        print("torch parity check passed (teacher-forced logits, "
              "rtol/atol 2e-3)")
        print(f"check: max |logit diff| {gap:.6g} against the float64 "
              f"HF-layout reference (trocr_hf_reference) on {device}")
    return out_path


def _decode_rows(ids: np.ndarray, tok, eos: int, pad: int):
    out = []
    for row in ids:
        row = [int(i) for i in row]
        if eos in row:
            row = row[: row.index(eos)]
        out.append(tok.decode([i for i in row if i != pad],
                              skip_special_tokens=True))
    return out


def evaluate(npz_path: str, model_dir: str, coco_json: str, image_dir: str,
             batch: int = 8, max_len: int = 64, limit: int = 0,
             num_beams: int = 1, device="cuda"):
    """Decode COCO text lines with the imported model (greedy or beam) and
    score them with textline_evaluation (the reference's
    trocr/infer_trocr.py flow)."""
    from effocr_torch.baselines.tokenizer import load_tokenizer
    from effocr_torch.baselines.trocr_import import (
        TrOCR,
        load_trocr_npz,
        trocr_beam_decode,
        trocr_greedy_decode,
    )
    from effocr_torch.eval.textline import textline_evaluation

    device = torch.device(device)
    tok = load_tokenizer(model_dir)
    params, spec = load_trocr_npz(npz_path)
    model = TrOCR.from_flat(params, spec).to(device).eval()
    del params
    bos, eos, pad = _special_ids(model_dir, tok)

    with open(coco_json) as f:
        coco = json.load(f)
    pairs = []
    size = spec.image_size
    batch_pix, batch_gt = [], []
    images = [im for im in coco["images"] if im.get("text")]
    if limit:
        images = images[:limit]
    decode_s = [0.0]

    def flush():
        if not batch_pix:
            return
        pix = torch.from_numpy(np.stack(batch_pix)).to(device)
        t0 = time.perf_counter()
        if num_beams > 1:
            ids = trocr_beam_decode(
                model, pix, max_len=max_len, num_beams=num_beams,
                bos_id=int(bos), eos_id=int(eos), pad_id=int(pad))
        else:
            ids = trocr_greedy_decode(
                model, pix, max_len=max_len,
                bos_id=int(bos), eos_id=int(eos), pad_id=int(pad))
        ids = ids.cpu().numpy()
        decode_s[0] += time.perf_counter() - t0
        for gt, pred in zip(batch_gt, _decode_rows(ids, tok, int(eos),
                                                   int(pad))):
            pairs.append((gt, pred))
        batch_pix.clear()
        batch_gt.clear()

    for im in images:
        img = load_line(os.path.join(image_dir, im["file_name"]), size)
        # TrOCRProcessor semantics: rescale 1/255, normalize mean=std=0.5
        arr = (np.asarray(img, np.float32) / 255.0 - 0.5) / 0.5
        batch_pix.append(arr)
        batch_gt.append(im["text"])
        if len(batch_pix) == batch:
            flush()
    flush()

    acc, cer = textline_evaluation(pairs)
    print(f"n={len(pairs)} line_accuracy={acc:.4f} CER={cer:.4f}")
    print(f"decode: {len(pairs)} lines in {decode_s[0]:.3f} s "
          f"({'beam ' + str(num_beams) if num_beams > 1 else 'greedy'}, "
          f"batch {batch}, max_len {max_len}, {device})")
    return acc, cer


def finetune(npz_path: str, model_dir: str, train_coco: str, val_coco: str,
             image_dir: str, num_epochs: int = 10, batch: int = 8,
             lr: float = 5e-5, max_len: int = 64, out: str = None,
             seed: int = 0, device="cuda"):
    """Fine-tune imported TrOCR weights on COCO (line image, text) pairs,
    the reference's trocr/train_trocr.py (AdamW lr 5e-5, pad labels
    ignored, per-epoch CER, best checkpoint).  The corpus is uploaded
    once as uint8 pixel, label and mask banks; steps ship indices."""
    from effocr_torch.baselines.tokenizer import load_tokenizer
    from effocr_torch.baselines.trocr_import import (
        TrOCR,
        load_trocr_npz,
        make_trocr_finetune_step,
        save_trocr_npz,
        trocr_greedy_decode,
    )
    from effocr_torch.core.device import upload
    from effocr_torch.eval.textline import textline_evaluation
    from effocr_torch.train.optim import AdamW

    device = torch.device(device)
    tok = load_tokenizer(model_dir)
    params, spec = load_trocr_npz(npz_path)
    start, eos, pad = _special_ids(model_dir, tok)
    size = spec.image_size

    def materialize(coco_json):
        with open(coco_json) as f:
            coco = json.load(f)
        ims = [im for im in coco["images"] if im.get("text")]
        pix = np.zeros((len(ims), size, size, 3), np.uint8)
        labels = np.full((len(ims), max_len), pad, np.int32)
        gts = []
        for i, im in enumerate(ims):
            pix[i] = load_line(os.path.join(image_dir, im["file_name"]), size)
            ids = tok(im["text"], truncation=True,
                      max_length=max_len).input_ids
            labels[i, : len(ids)] = ids
            gts.append(im["text"])
        return pix, labels, labels != pad, gts

    tr_pix, tr_lab, tr_mask, _ = materialize(train_coco)
    va_pix, va_lab, va_mask, va_gt = materialize(val_coco)
    if len(tr_pix) == 0:
        raise ValueError(f"no images with text fields in {train_coco}")
    if batch > len(tr_pix):
        print(f"batch {batch} > {len(tr_pix)} train lines; "
              f"clamping to {len(tr_pix)}")
        batch = len(tr_pix)
    print(f"train {len(tr_pix)} lines, val {len(va_pix)} lines")

    model = TrOCR.from_flat(params, spec).to(device)
    del params
    optimizer = AdamW([(list(model.parameters()), lr)])
    step = make_trocr_finetune_step(model, optimizer, start, bank_mode=True)
    bank = (torch.from_numpy(tr_pix).to(device),
            torch.from_numpy(tr_lab.astype(np.int64)).to(device),
            torch.from_numpy(tr_mask).to(device))
    va_bank = torch.from_numpy(va_pix).to(device)

    def eval_cer():
        model.eval()
        pairs = []
        t0 = time.perf_counter()
        for s in range(0, len(va_pix), batch):
            idx = np.arange(s, min(s + batch, len(va_pix)))
            full = np.resize(idx, batch)      # pad the tail batch
            pix_f = model.normalize(
                va_bank[upload(torch.from_numpy(full).long(), device)])
            ids = trocr_greedy_decode(
                model, pix_f, max_len=max_len, bos_id=start,
                eos_id=eos, pad_id=pad).cpu().numpy()
            preds = _decode_rows(ids[: len(idx)], tok, eos, pad)
            pairs.extend((va_gt[gi], p) for gi, p in zip(idx, preds))
        secs = time.perf_counter() - t0
        model.train()
        print(f"greedy eval: {len(pairs)} val lines in {secs:.3f} s "
              f"(batch {batch}, max_len {max_len})")
        return textline_evaluation(pairs)

    out = out or npz_path.replace(".npz", "_ft.npz")
    rng = np.random.default_rng(seed)
    best_cer = float("inf")
    n = len(tr_pix)
    acc, cer = eval_cer()
    print(f"zero-shot: line_accuracy={acc:.4f} CER={cer:.4f}")
    for epoch in range(num_epochs):
        order = np.arange(n)
        rng.shuffle(order)
        losses = []
        t0 = time.perf_counter()
        for s in range(0, n - batch + 1, batch):
            idx = upload(torch.from_numpy(order[s : s + batch]).long(),
                         device)
            losses.append(step(*bank, idx))
        mean_loss = float(torch.stack(losses).double().mean()) \
            if losses else float("nan")             # waits for the card
        seconds = time.perf_counter() - t0
        print(f"epoch {epoch} train: steps={len(losses)} "
              f"images={len(losses) * batch} seconds={seconds:.3f} "
              f"mean_loss={mean_loss:.6f}")
        acc, cer = eval_cer()
        print(f"epoch {epoch}: loss={mean_loss:.4f} "
              f"line_accuracy={acc:.4f} CER={cer:.4f}")
        if cer <= best_cer:
            best_cer = cer
            save_trocr_npz(out, model.to_flat(), spec)
    print(f"best CER {best_cer:.4f} -> {out}")
    return best_cer


def main(argv=None):
    from effocr_torch.core.device import resolve_device, use_full_f32

    p = argparse.ArgumentParser(prog="python -m effocr_torch import-trocr",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda unless cpu is asked for")
    p.add_argument("--model_dir", default=None,
                   help="HF checkpoint dir (config.json + weights)")
    p.add_argument("--fairseq_pt", default=None,
                   help="raw fairseq/unilm TrOCR checkpoint (.pt): apply "
                        "the renaming hop (the reference's "
                        "trocr_fairseq_to_pytorch_chkpt.py role) before "
                        "the HF conversion; --model_dir is then only "
                        "needed for tokenizer-based eval/finetune")
    p.add_argument("--out", default=None,
                   help="default: <model_dir>/trocr_tpu.npz")
    p.add_argument("--check", action="store_true", default=False,
                   help="parity check after conversion, against the "
                        "float64 HF-layout reference")
    p.add_argument("--coco_json", default=None,
                   help="optional: evaluate on COCO lines after import "
                        "(the trocr/infer_trocr.py role; also the "
                        "--zero_shot equivalent)")
    p.add_argument("--image_dir", default=None)
    p.add_argument("--train_coco_json", default=None,
                   help="optional: fine-tune on COCO line pairs after "
                        "import (the trocr/train_trocr.py role)")
    p.add_argument("--val_coco_json", default=None)
    p.add_argument("--num_epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=5e-5,
                   help="reference default (trocr/train_trocr.py:73-74)")
    p.add_argument("--finetune_out", default=None,
                   help="default: <out>_ft.npz")
    p.add_argument("--eval_npz", default=None,
                   help="skip conversion and use this existing npz "
                        "artifact (e.g. a previous run's _ft.npz)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max_len", type=int, default=64)
    p.add_argument("--num_beams", type=int, default=4,
                   help="reference eval default (trocr/infer_trocr.py:107);"
                        " 1 = greedy")
    p.add_argument("--limit", type=int, default=0)
    args = p.parse_args(argv)
    if not args.model_dir and not (args.fairseq_pt or args.eval_npz):
        p.error("--model_dir is required (or --fairseq_pt / --eval_npz)")
    device = resolve_device(args.device)     # fail before writing anything
    use_full_f32()
    if args.out:
        out = args.out
    elif args.model_dir:
        out = os.path.join(args.model_dir, "trocr_tpu.npz")
    else:
        out = os.path.splitext(args.fairseq_pt)[0] + "_tpu.npz"
    if args.eval_npz:
        eval_npz = args.eval_npz      # evaluate an existing artifact
    else:
        convert(args.model_dir, out, check=args.check and not args.fairseq_pt,
                fairseq_pt=args.fairseq_pt, device=device)
        eval_npz = out
    if args.train_coco_json:
        if not (args.image_dir and args.val_coco_json):
            p.error("--train_coco_json requires --image_dir and "
                    "--val_coco_json")
        ft_out = args.finetune_out or eval_npz.replace(".npz", "_ft.npz")
        finetune(eval_npz, args.model_dir, args.train_coco_json,
                 args.val_coco_json, args.image_dir,
                 num_epochs=args.num_epochs, batch=args.batch, lr=args.lr,
                 max_len=args.max_len, out=ft_out, device=device)
        eval_npz = ft_out             # --coco_json scores the result
    if args.coco_json:
        if not args.image_dir:
            p.error("--coco_json requires --image_dir")
        evaluate(eval_npz, args.model_dir, args.coco_json, args.image_dir,
                 batch=args.batch, max_len=args.max_len, limit=args.limit,
                 num_beams=args.num_beams, device=device)


if __name__ == "__main__":
    main()
