"""Character-folder dataset: the <root>/<ord(char)>/*.png tree (the JAX
package's data/folder.py).

Renders (``0x<code>_...png``) get augmentation, ``PAIRED_<stem>_...``
crops cut from text lines get the plain transform; split membership
comes from the line-stem prefixes of the per-split COCO files, with the
same leakage asserts.  Each item is decoded once into a white-padded
uint8 square resized to the encoder's input size (``load_square``): the
decode is ``png.read`` (Pillow's RGB conversion), the resize
``pil_bilinear_resize``, a numpy copy of Pillow's ``Image.BILINEAR``
(``pil_bicubic_resize`` copies ``Image.BICUBIC`` the same way).
"""

from __future__ import annotations

import functools
import os
from glob import glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from effocr_torch.data import png
from effocr_torch.kernels.image_ops import (
    median_pad_square,
    normalize_imagenet,
)

# Pillow's fixed-point resampling precision (libImaging/Resample.c)
_PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's cubic convolution, a = -0.5."""
    a, x = -0.5, np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


# Pillow's filters: (kernel, support) by name
_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


@functools.lru_cache(maxsize=64)
def _pil_coeffs(in_size: int, out_size: int, kind: str = "bilinear"
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's resample weights along one axis (libImaging/Resample.c
    precompute_coeffs + normalize_coeffs_8bpc): output xx reads inputs
    ``start[xx] + j`` with integer weight ``weights[xx, j]``, j < ksize.
    The filter is widened by the scale on a downscale, each output's
    weights are summed in input order and normalised in float64, then
    rounded half away from zero to 22-bit fixed point."""
    kernel, support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ss = 1.0 / filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; the clamp at 0 makes it a floor
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(
        np.int64)
    x = xmin[:, None] + np.arange(ksize)
    k = np.where(x < xmax[:, None],
                 kernel((x - center[:, None] + 0.5) * ss), 0.0)
    total = k[:, 0].copy()
    for j in range(1, ksize):           # Pillow's order: ww += w
        total += k[:, j]
    k = np.where(total[:, None] != 0.0,
                 k / np.where(total == 0.0, 1.0, total)[:, None], k)
    w = k * (1 << _PRECISION_BITS)
    return xmin, np.where(w < 0, np.trunc(w - 0.5), np.trunc(w + 0.5))


def _pil_pass(x: np.ndarray, coeffs: Tuple[np.ndarray, np.ndarray],
              axis: int) -> np.ndarray:
    """One 8-bit pass along ``axis`` of [H, W, C]: Pillow's 32-bit integer
    sums, rounded at half and clipped to uint8, as Pillow does between
    and after its passes."""
    start, weights = coeffs
    src = np.ascontiguousarray(np.moveaxis(x, axis, 0), dtype=np.int32)
    last = src.shape[0] - 1
    shape = (-1,) + (1,) * (src.ndim - 1)
    acc = np.full((len(start),) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int32)
    for j in range(weights.shape[1]):
        acc += src[np.minimum(start + j, last)] * weights[:, j].astype(
            np.int32).reshape(shape)
    acc = np.moveaxis(acc >> _PRECISION_BITS, 0, axis)
    return np.clip(acc, 0, 255).astype(np.uint8)


def pil_resize(img: np.ndarray, out_w: int, out_h: int,
               kind: str = "bilinear") -> np.ndarray:
    """uint8 [H, W, C] -> [out_h, out_w, C], bit for bit
    ``Image.fromarray(img).resize((out_w, out_h), Image.BILINEAR)`` (or
    ``BICUBIC``): horizontal pass first, then vertical, each only when
    its size changes, clipped to uint8 between and after them."""
    h, w = img.shape[:2]
    if w != out_w:
        img = _pil_pass(img, _pil_coeffs(w, out_w, kind), 1)
    if h != out_h:
        img = _pil_pass(img, _pil_coeffs(h, out_h, kind), 0)
    return img


def pil_bilinear_resize(img: np.ndarray, out_w: int, out_h: int
                        ) -> np.ndarray:
    """``Image.resize(..., BILINEAR)`` (``pil_resize``)."""
    return pil_resize(img, out_w, out_h, "bilinear")


def pil_bicubic_resize(img: np.ndarray, out_w: int, out_h: int
                       ) -> np.ndarray:
    """``Image.resize(..., BICUBIC)``, the default filter of
    ``Image.resize`` (``pil_resize``)."""
    return pil_resize(img, out_w, out_h, "bicubic")


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
        arr = median_pad_square(png.read([self.data[idx][0]], [3])[0])
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
