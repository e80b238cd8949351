"""COCO-format utilities (the JAX package's data/coco.py): the skeleton,
entry builders, split/combine/subset, box helpers and the character-crop
writer ``extract_char_crops`` (Pillow's crop rounding, each crop in its
page's mode, palette and transparency, through data/imaging.py).
"""

from __future__ import annotations

import copy
import json
import os
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

def extract_char_crops(
    coco: Dict,
    image_dir: str,
    crops_save_dir: str,
    cat_id: int = 0,
    spaces: bool = False,
    clip: bool = False,
) -> int:
    """Crop per-char images from text lines using reading-order-sorted
    annos; file names {image_stem}_{anno_id}_{charhex}.png, in the line
    image's mode.  Returns the crop count."""
    from effocr_torch.data import imaging

    os.makedirs(crops_save_dir, exist_ok=True)
    count = 0
    annos_by_image: Dict[int, List[Dict]] = {}
    for a in coco["annotations"]:
        if a["category_id"] == cat_id:
            annos_by_image.setdefault(a["image_id"], []).append(a)

    for coco_image in coco["images"]:
        image_id = coco_image["id"]
        image_name = coco_image["file_name"]
        width, height = coco_image["width"], coco_image["height"]
        vertical = width < height
        image_chars = coco_image["text"]
        image_stem = os.path.splitext(image_name)[0]
        if spaces:
            image_chars = image_chars.replace(" ", "")

        img_annos = annos_by_image.get(image_id, [])
        if clip:
            lineheight = height if not vertical else width
            img_annos = [
                clip_to_top_and_bottom(a, lineheight, vertical)
                for a in img_annos
            ]
        assert len(img_annos) == len(image_chars), (
            f"{len(img_annos)} != {len(image_chars)}; "
            f"{image_chars}; {image_stem}"
        )
        img_annos = sorted(
            img_annos, key=lambda a: a["bbox"][1] if vertical else a["bbox"][0]
        )
        img = imaging.open_image(os.path.join(image_dir, image_name))
        H, W = img.px.shape[:2]
        for char, anno in zip(image_chars, img_annos):
            x, y, w, h = anno["bbox"]
            crop = imaging.crop(
                img.px, (max(x, 0), max(y, 0), min(x + w, W), min(y + h, H)))
            imaging.save_image(os.path.join(
                crops_save_dir,
                f"{image_stem}_{anno['id']}_{hex(ord(char))}.png"),
                *img._replace(px=crop))
            count += 1
    return count


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def save_json(obj: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
