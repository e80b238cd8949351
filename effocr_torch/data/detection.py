"""Detection dataset (the JAX package's data/detection.py): COCO line
images with char/word boxes -> fixed-shape letterboxed training batches.

Each image is read as Pillow's RGB conversion (data/image_io.py), reduced to
the truncating channel mean for 1-channel detectors, and letterboxed to
(input_height, input_size) by ``letterbox_host`` (OpenCV's bilinear
resize, byte for byte, as the JAX package letterboxes with cv2).  Boxes
follow into letterbox space as (cls, cx, cy, w, h) pixel targets at the
ROUNDED paste offsets, with a validity mask, at most ``max_targets`` per
image.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from effocr_torch.data import image_io
from effocr_torch.data.coco import load_json
from effocr_torch.kernels.image_ops import letterbox_host


class DetectionDataset:
    def __init__(
        self,
        coco_json: str | Dict,
        image_dir: str,
        input_size: int = 640,
        max_targets: int = 256,
        input_height: Optional[int] = None,
        channels: int = 3,
    ):
        """input_height: rectangular canvas (a stride-32 multiple);
        channels 1: images reduce to the truncating channel mean, the
        reduction of the inference host prep."""
        self.coco = (
            load_json(coco_json) if isinstance(coco_json, str) else coco_json
        )
        self.image_dir = image_dir
        self.input_size = input_size
        self.input_height = input_height or input_size
        self.max_targets = max_targets
        self.channels = channels
        self.annos_by_image: Dict[int, List] = {}
        for a in self.coco["annotations"]:
            self.annos_by_image.setdefault(a["image_id"], []).append(a)
        self.images = self.coco["images"]

    def __len__(self) -> int:
        return len(self.images)

    def path(self, i: int) -> str:
        return os.path.join(self.image_dir, self.images[i]["file_name"])

    def load(self, i: int, rgb: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict]:
        """-> (letterboxed uint8 image [H, W, C], targets [T, 5], mask
        [T], gt dict in letterbox space for eval).  ``rgb``: the image's
        RGB pixels when already decoded."""
        img = rgb if rgb is not None else image_io.read_rgb(self.path(i))
        if self.channels == 1:
            img = img.mean(axis=-1, keepdims=True).astype(np.uint8)
        lb, r, (dw, dh) = letterbox_host(img, (self.input_height,
                                               self.input_size))
        # the image content sits at the rounded offsets; targets use them
        top, left = int(round(dh - 0.1)), int(round(dw - 0.1))

        targets = np.zeros((self.max_targets, 5), np.float32)
        mask = np.zeros((self.max_targets,), bool)
        gt_boxes, gt_classes = [], []
        for t, a in enumerate(self.annos_by_image.get(self.images[i]["id"],
                                                      [])):
            if t >= self.max_targets:
                break
            bx, by, bw, bh = a["bbox"]
            cx = (bx + bw / 2) * r + left
            cy = (by + bh / 2) * r + top
            targets[t] = [a["category_id"], cx, cy, bw * r, bh * r]
            mask[t] = True
            gt_boxes.append(
                [cx - bw * r / 2, cy - bh * r / 2,
                 cx + bw * r / 2, cy + bh * r / 2]
            )
            gt_classes.append(a["category_id"])
        gt = {"boxes": np.asarray(gt_boxes, float).reshape(-1, 4),
              "classes": np.asarray(gt_classes, int)}
        return lb, targets, mask, gt

    def _load_many(self, indices):
        rgbs = image_io.read([self.path(i) for i in indices],
                             [3] * len(indices))
        return [self.load(i, rgb) for i, rgb in zip(indices, rgbs)]

    def materialize(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Decode + letterbox every image once: (canvases uint8 [N, H, W,
        C], targets [N, T, 5], masks [N, T]), the host half of the
        trainer's device-resident bank."""
        n = len(self)
        imgs = np.full(
            (n, self.input_height, self.input_size, self.channels),
            114, np.uint8,
        )
        tgts = np.zeros((n, self.max_targets, 5), np.float32)
        masks = np.zeros((n, self.max_targets), bool)
        for s in range(0, n, 256):
            for i, (x, t, m, _) in enumerate(
                    self._load_many(range(s, min(s + 256, n))), s):
                imgs[i], tgts[i], masks[i] = x, t, m
        return imgs, tgts, masks

    def batches(
        self, batch_size: int, shuffle: bool = True, seed: int = 0,
        drop_last: bool = True,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, List[Dict]]]:
        """(images, targets, masks, gts) batches in a seeded shuffled
        order; a short last batch is padded with 114 and no targets, and
        ``gts`` lists only its real images."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s in range(0, len(order), batch_size):
            idx = order[s: s + batch_size]
            if len(idx) < batch_size and drop_last:
                break
            imgs = np.full(
                (batch_size, self.input_height, self.input_size,
                 self.channels), 114, np.uint8,
            )
            tgts = np.zeros((batch_size, self.max_targets, 5), np.float32)
            masks = np.zeros((batch_size, self.max_targets), bool)
            gts = []
            for j, (x, t, m, gt) in enumerate(
                    self._load_many([int(i) for i in idx])):
                imgs[j], tgts[j], masks[j] = x, t, m
                gts.append(gt)
            yield imgs, tgts, masks, gts
