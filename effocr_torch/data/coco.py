"""COCO-format utilities (the JAX package's data/coco.py): the skeleton,
entry builders, split/combine/subset and box helpers.

The character-crop writer ``extract_char_crops`` needs PIL, which this
package may not import; it raises and points at ROADMAP.md queue 1
item 7.
"""

from __future__ import annotations

import copy
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

COCO_JSON_SKELETON: Dict = {
    "info": {},
    "licenses": [],
    "images": [],
    "annotations": [],
    "categories": [
        {"id": 0, "name": "char", "supercategory": ""},
        {"id": 1, "name": "word", "supercategory": ""},
    ],
}


def create_coco_anno_entry(
    x: float, y: float, w: float, h: float,
    anno_id: int, image_id: int, category_id: int = 0,
) -> Dict:
    return {
        "id": anno_id,
        "image_id": image_id,
        "category_id": category_id,
        "bbox": [x, y, w, h],
        "area": w * h,
        "segmentation": [[x, y, x + w, y, x + w, y + h, x, y + h]],
        "iscrowd": 0,
    }


def create_coco_image_entry(
    file_name: str, height: int, width: int, image_id: int,
    text: Optional[str] = None,
) -> Dict:
    entry = {
        "id": image_id,
        "file_name": file_name,
        "height": height,
        "width": width,
    }
    if text is not None:
        entry["text"] = text
    return entry


# ------------------------------------------------------------ split/combine

def split_coco_json(
    coco: Dict, train_frac: float = 0.8, val_frac: float = 0.1, seed: int = 99
) -> Tuple[Dict, Dict, Dict]:
    """Random train/val/test split by image id (scripts/coco_split.py:9-42)."""
    images = coco["images"]
    ids = [im["id"] for im in images]
    rng = np.random.default_rng(seed)
    rng.shuffle(ids)
    n = len(ids)
    n_train = int(round(n * train_frac))
    n_val = int(round(n * val_frac))
    id_sets = (
        set(ids[:n_train]),
        set(ids[n_train : n_train + n_val]),
        set(ids[n_train + n_val :]),
    )
    outs = []
    for id_set in id_sets:
        out = copy.deepcopy(COCO_JSON_SKELETON)
        out["categories"] = copy.deepcopy(coco.get("categories", []))
        out["images"] = [im for im in images if im["id"] in id_set]
        out["annotations"] = [
            a for a in coco["annotations"] if a["image_id"] in id_set
        ]
        outs.append(out)
    return tuple(outs)


def combine_coco_jsons(a: Dict, b: Dict) -> Dict:
    """Merge two COCO sets, re-tagging ids of the second
    (scripts/coco_combine.py:10-39)."""
    out = copy.deepcopy(a)
    img_offset = 1 + max((im["id"] for im in a["images"]), default=-1)
    ann_offset = 1 + max((an["id"] for an in a["annotations"]), default=-1)
    for im in b["images"]:
        im = copy.deepcopy(im)
        old = im["id"]
        im["id"] = old + img_offset
        out["images"].append(im)
    for an in b["annotations"]:
        an = copy.deepcopy(an)
        an["id"] = an["id"] + ann_offset
        an["image_id"] = an["image_id"] + img_offset
        out["annotations"].append(an)
    return out


def subset_coco_json(coco: Dict, n: int, seed: int = 0) -> Dict:
    """Random n-image subset (scripts/coco_subset.py:8-14)."""
    rng = np.random.default_rng(seed)
    images = list(coco["images"])
    rng.shuffle(images)
    keep = images[:n]
    keep_ids = {im["id"] for im in keep}
    out = copy.deepcopy(coco)
    out["images"] = keep
    out["annotations"] = [
        a for a in coco["annotations"] if a["image_id"] in keep_ids
    ]
    return out


# ---------------------------------------------------------------- box helpers

def box_iom(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection over minimum area (format_effocr_recognizer_dataset.py:73-81)."""
    tl = np.maximum(a[:, :2], b[:, :2])
    br = np.minimum(a[:, 2:], b[:, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.minimum(area_a, area_b)


def clip_to_top_and_bottom(anno: Dict, lineheight: float, vertical: bool) -> Dict:
    """Extend bbox to full line extent (format_effocr_recognizer_dataset.py:112-118)."""
    x, y, w, h = anno["bbox"]
    anno = dict(anno)
    anno["bbox"] = [0, y, lineheight, h] if vertical else [x, 0, w, lineheight]
    return anno


# -------------------------------------------------------------- crop extract

def extract_char_crops(*args, **kwargs) -> int:
    """Per-char crops of text lines (the JAX package's PIL crop writer):
    not ported."""
    raise NotImplementedError(
        "extract_char_crops writes crops with PIL, which effocr_torch does "
        "not import; it waits with format-dataset (ROADMAP.md queue 1, "
        "item 7)")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def save_json(obj: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
