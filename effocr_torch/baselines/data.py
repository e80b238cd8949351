"""Seq2seq line dataset: COCO (line image, text) pairs -> fixed canvas +
token batches (the JAX package's baselines/data.py), bit for bit on its
images without Pillow: the PNG decode is data/png.py (Pillow's RGB
conversion), the height-normalizing resize ``pil_bicubic_resize``
(``Image.resize``'s default filter), white right-padding to the
canvas."""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Tuple

import numpy as np

from effocr_torch.baselines.seq2seq import CharTokenizer
from effocr_torch.data import png
from effocr_torch.data.coco import load_json
from effocr_torch.data.folder import pil_bicubic_resize


class Seq2SeqDataset:
    def __init__(self, coco_json, image_dir: str, tokenizer: CharTokenizer,
                 img_h: int = 64, img_w: int = 512, max_len: int = 64):
        self.coco = (
            load_json(coco_json) if isinstance(coco_json, str) else coco_json
        )
        self.image_dir = image_dir
        self.tok = tokenizer
        self.img_h, self.img_w = img_h, img_w
        self.max_len = max_len
        self.entries = [
            (x["file_name"], x["text"]) for x in self.coco["images"]
        ]

    def __len__(self) -> int:
        return len(self.entries)

    def load(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, str]:
        name, text = self.entries[i]
        img = png.read_png(os.path.join(self.image_dir, name), 3)
        # aspect-preserving height-normalize, white-pad right
        h, w = img.shape[:2]
        nw = max(min(int(round(w * self.img_h / h)), self.img_w), 1)
        img = pil_bicubic_resize(img, nw, self.img_h)
        # uint8 out: Seq2SeqOCR.encode normalizes on device
        x = np.full((self.img_h, self.img_w, 3), 255, np.uint8)
        x[:, :nw] = img
        ids, mask = self.tok.encode(text, self.max_len)
        return x, ids, mask, text

    def materialize(self
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Decode the whole dataset once -> (images uint8 [N, H, W, 3],
        token ids int32 [N, max_len], masks bool [N, max_len]).

        Moved to the device once for a resident bank (--data_device
        resident): training then ships int32 indices only."""
        xs, ids, masks = [], [], []
        for i in range(len(self)):
            x, t_ids, t_mask, _ = self.load(i)
            xs.append(x)
            ids.append(t_ids)
            masks.append(t_mask)
        return np.stack(xs), np.stack(ids), np.stack(masks)

    def index_batches(self, batch_size: int, shuffle: bool = True,
                      seed: int = 0, drop_last: bool = True
                      ) -> Iterator[Tuple[np.ndarray, List[str]]]:
        """Index-only twin of batches() for resident-bank training:
        yields (int32 indices padded to batch_size by repeating index 0,
        the real rows' texts).

        CAUTION: unlike batches(), whose tail padding is zero-masked
        dummies (zero loss), the padded indices here reference REAL row 0
        — fine for eval (callers truncate to len(texts)), but a
        drop_last=False TRAINING loop over these batches would oversample
        row 0.  Keep drop_last=True for training (the default)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s in range(0, len(order), batch_size):
            idx = order[s : s + batch_size]
            if len(idx) < batch_size and drop_last:
                break
            texts = [self.entries[int(i)][1] for i in idx]
            if len(idx) < batch_size:
                idx = np.concatenate(
                    [idx, np.zeros((batch_size - len(idx),), order.dtype)]
                )
            yield idx.astype(np.int32), texts

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    List[str]]]:
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s in range(0, len(order), batch_size):
            idx = order[s : s + batch_size]
            if len(idx) < batch_size and drop_last:
                break
            xs, ids, masks, texts = [], [], [], []
            for i in idx:
                x, t_ids, t_mask, text = self.load(int(i))
                xs.append(x)
                ids.append(t_ids)
                masks.append(t_mask)
                texts.append(text)
            # pad the tensors to batch_size but report only the real texts,
            # so eval CER never double-counts wrapped images
            while len(xs) < batch_size:
                xs.append(np.zeros_like(xs[0]))
                ids.append(np.zeros_like(ids[0]))
                masks.append(np.zeros_like(masks[0]))
            yield (np.stack(xs), np.stack(ids), np.stack(masks), texts)


def charset_from_coco(coco_jsons) -> List[str]:
    chars = set()
    for cj in coco_jsons:
        coco = load_json(cj) if isinstance(cj, str) else cj
        for x in coco["images"]:
            chars.update(x["text"])
    return sorted(chars)
