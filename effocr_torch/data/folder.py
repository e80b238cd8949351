"""Character-folder dataset: the <root>/<ord(char)>/*.png tree (the JAX
package's data/folder.py).

Renders (``0x<code>_...png``) get augmentation, ``PAIRED_<stem>_...``
crops cut from text lines get the plain transform; split membership
comes from the line-stem prefixes of the per-split COCO files, with the
same leakage asserts.  Each item is decoded once into a white-padded
uint8 square resized to the encoder's input size (``load_square``): the
decode is ``image_io.read`` (Pillow's RGB conversion), the resize
``pil_bilinear_resize``, a numpy copy of Pillow's ``Image.BILINEAR``
(data/imaging.py, with ``pil_bicubic_resize`` and the LANCZOS filter).
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from effocr_torch.data import image_io
from effocr_torch.data.imaging import (  # noqa: F401  (re-exported)
    pil_bicubic_resize,
    pil_bilinear_resize,
    pil_resize,
)
from effocr_torch.kernels.image_ops import (
    median_pad_square,
    normalize_imagenet,
)

def _stem(p: str) -> str:
    return os.path.splitext(os.path.basename(p))[0]


class CharFolderDataset:
    """Flat index over the char-folder tree.

    data:         list of (path, target)
    targets:      class index per item
    class_to_idx: str(ord(char)) -> class index
    """

    def __init__(self, root: str):
        self.root = root
        classes = sorted(
            (d for d in os.listdir(root)
             if os.path.isdir(os.path.join(root, d))),
            key=lambda d: int(d),
        )
        self.classes = classes
        self.class_to_idx: Dict[str, int] = {
            c: i for i, c in enumerate(classes)}
        self.data: List[Tuple[str, int]] = []
        for c in classes:
            t = self.class_to_idx[c]
            for p in sorted(glob(os.path.join(root, c, "*.png"))):
                self.data.append((p, t))
        self.targets = [t for _, t in self.data]
        # decoded-crop memo (see load_square); ~49 KB per 128-px entry
        self._cache: Dict[Tuple[int, int], np.ndarray] = {}
        self.cache_max_items = 300_000

    def __len__(self) -> int:
        return len(self.data)

    def char_for_target(self, target: int) -> str:
        return chr(int(self.classes[target]))

    def char_for_path(self, path: str) -> str:
        """The char of a render ('0x..._' prefix) or PAIRED crop
        ('..._0x..._idx' suffix) filename."""
        base = _stem(path)
        if base.startswith("0x"):
            return chr(int(base.split("_")[0], base=16))
        if base.startswith("PAIRED"):
            return chr(int(base.split("_")[-2], base=16))
        return base[0]

    # ------------------------------------------------------------- subsets
    def is_paired(self, idx: int) -> bool:
        return os.path.basename(self.data[idx][0]).startswith("PAIRED")

    def paired_indices_for_stems(self, stems: Sequence[str]) -> List[int]:
        """Indices of PAIRED crops whose source textline stem is in stems."""
        prefixes = tuple(f"PAIRED_{s}_" for s in stems)
        return [
            i for i, (p, _) in enumerate(self.data)
            if os.path.basename(p).startswith(prefixes)
        ]

    def render_indices(self, font_name: Optional[str] = None) -> List[int]:
        """Non-PAIRED (render) indices, optionally filtered to one font."""
        out = []
        for i, (p, _) in enumerate(self.data):
            if os.path.basename(p).startswith("PAIRED"):
                continue
            if font_name is not None and font_name not in p:
                continue
            out.append(i)
        return out

    # -------------------------------------------------------------- loading
    def load_square(self, idx: int, size: int = 224) -> np.ndarray:
        """uint8 [size, size, 3]: white-square-pad, then Pillow's bilinear
        resize.  Memoized: training re-reads every item every epoch."""
        cached = self._cache.get((idx, size))
        if cached is not None:
            return cached
        arr = median_pad_square(image_io.read_rgb(self.data[idx][0]))
        if arr.shape[0] != size:
            arr = pil_bilinear_resize(arr, size, size)
        if len(self._cache) < self.cache_max_items:
            self._cache[(idx, size)] = arr
        return arr

    def decode_all_gray(self, size: int = 224) -> np.ndarray:
        """uint8 [N, size, size] grayscale bank of every item in dataset
        order (truncating channel mean): the host half of the
        device-resident data path."""
        bank = np.empty((len(self.data), size, size), np.uint8)
        for i in range(len(self.data)):
            rgb = self.load_square(i, size)
            bank[i] = (
                rgb[..., 0].astype(np.uint16)
                + rgb[..., 1]
                + rgb[..., 2]
            ) // 3
        return bank

    def load_batch(self, indices: Sequence[int], size: int = 224,
                   num_workers: int = 16
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(images uint8 [N,size,size,3], targets [N], is_paired [N]),
        decoded on a thread pool."""
        if len(indices) >= 8 and num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            if not hasattr(self, "_pool"):
                self._pool = ThreadPoolExecutor(num_workers)
            imgs = np.stack(
                list(self._pool.map(lambda i: self.load_square(i, size),
                                    indices))
            )
        else:
            imgs = np.stack([self.load_square(i, size) for i in indices])
        targets = np.asarray([self.targets[i] for i in indices], np.int32)
        paired = np.asarray([self.is_paired(i) for i in indices], bool)
        return imgs, targets, paired


@torch.no_grad()
def embed_items(model: torch.nn.Module, dataset: CharFolderDataset,
                indices: Sequence[int], size: int, channels: int, device,
                batch_size: int = 128) -> np.ndarray:
    """float32 [len(indices), D] embeddings of dataset items under the
    plain transform: ``load_batch`` in zero-padded batches of
    ``batch_size``, the truncating channel mean for a gray model (as the
    inference host prep), ``normalize_imagenet``, the model in eval
    mode."""
    model.eval()
    embs = []
    for s in range(0, len(indices), batch_size):
        chunk = list(indices[s:s + batch_size])
        imgs, _, _ = dataset.load_batch(chunk, size)
        if channels == 1:
            imgs = imgs.mean(axis=-1, keepdims=True).astype(np.uint8)
        pad = batch_size - len(chunk)
        if pad:
            imgs = np.concatenate(
                [imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
        x = torch.from_numpy(imgs).to(device).float() / 255.0
        embs.append(model(normalize_imagenet(x)).float().cpu().numpy()
                    [:len(chunk)])
    return np.concatenate(embs)


def split_indices(
    dataset: CharFolderDataset,
    train_stems: Sequence[str],
    val_stems: Sequence[str],
    test_stems: Sequence[str],
    finetune: bool = False,
    pretrain: bool = False,
) -> Tuple[List[int], List[int], List[int]]:
    """Train/val/test index split with the reference's leakage asserts."""
    assert not (finetune and pretrain)
    assert not set(test_stems) & set(train_stems)
    assert not set(val_stems) & set(train_stems)

    paired_train = dataset.paired_indices_for_stems(train_stems)
    paired_val = dataset.paired_indices_for_stems(val_stems)
    paired_test = dataset.paired_indices_for_stems(test_stems)
    renders = dataset.render_indices()

    assert not set(paired_train) & set(paired_val)
    assert not set(paired_test) & set(paired_train)

    if finetune:
        idx_train = sorted(paired_train)
    elif pretrain:
        idx_train = sorted(renders)
    else:
        idx_train = sorted(renders + paired_train)
    return idx_train, sorted(paired_val), sorted(paired_test)
