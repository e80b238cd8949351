"""Ultralytics YOLOv5 checkpoint import, the reference's localizer family
(the JAX package's interop/yolo_import.py).

The reference's localizer_dir ships ultralytics artifacts (``best.pt``).
Our YOLOv5 (models/yolo.py) is the same v6.0 module graph (6x6 stem, C3
3/6/9/3, SPPF, PAN, 3-scale anchor head), so a state-dict-level import is
exact.  ``best.pt`` is accepted as a plain state dict or as the full
ultralytics pickle of their Model class; the latter is read without the
ultralytics package by interop/torch_pickle.py (allowlist unpickler and a
walk of the module tree).  ``import-reference --localizer_pt best.pt
--out <dir>``.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from effocr_torch.models.import_weights import _conv, check_tree, sorted_tree

STRIDES = (8, 16, 32)

# our module name -> ultralytics layer index (yolov5 v6.0 yaml order)
_LAYER_MAP = {
    "stem": 0, "down1": 1, "c3_1": 2, "down2": 3, "c3_2": 4,
    "down3": 5, "c3_3": 6, "down4": 7, "c3_4": 8, "sppf": 9,
    "lat5": 10, "neck4": 13, "lat4": 14, "neck3": 17, "pan3": 18,
    "neck4b": 20, "pan4": 21, "neck5": 23,
}
_DETECT = 24


def _cba(sd: Mapping[str, Any], key: str
         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """ultralytics Conv (conv+bn+SiLU) -> (params, batch_stats)."""
    return (
        {"Conv_0": {"kernel": _conv(sd[f"{key}.conv.weight"])},
         "BatchNorm_0": {
             "scale": np.asarray(sd[f"{key}.bn.weight"], np.float32),
             "bias": np.asarray(sd[f"{key}.bn.bias"], np.float32)}},
        {"BatchNorm_0": {
            "mean": np.asarray(sd[f"{key}.bn.running_mean"], np.float32),
            "var": np.asarray(sd[f"{key}.bn.running_var"], np.float32)}},
    )


def _c3(sd: Mapping[str, Any], key: str
        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    p: Dict[str, Any] = {}
    s: Dict[str, Any] = {}
    for ours, theirs in (("ConvBnAct_0", "cv1"), ("ConvBnAct_1", "cv2"),
                         ("ConvBnAct_2", "cv3")):
        p[ours], s[ours] = _cba(sd, f"{key}.{theirs}")
    j = 0
    while f"{key}.m.{j}.cv1.conv.weight" in sd:
        mp: Dict[str, Any] = {}
        ms: Dict[str, Any] = {}
        mp["ConvBnAct_0"], ms["ConvBnAct_0"] = _cba(sd, f"{key}.m.{j}.cv1")
        mp["ConvBnAct_1"], ms["ConvBnAct_1"] = _cba(sd, f"{key}.m.{j}.cv2")
        p[f"m{j}"], s[f"m{j}"] = mp, ms
        j += 1
    return p, s


def detect_yolov5_variant(sd: Mapping[str, Any]) -> str:
    """Registry name from stem width + c3_1 depth."""
    stem = int(sd["model.0.conv.weight"].shape[0])
    widths = {16: 0.25, 32: 0.50, 48: 0.75}
    if stem not in widths:
        raise ValueError(f"unrecognized yolov5 stem width {stem}")
    depth = 0
    while f"model.2.m.{depth}.cv1.conv.weight" in sd:
        depth += 1
    names = {(0.25, 1): "yolov5n", (0.50, 1): "yolov5s", (0.75, 2): "yolov5m"}
    name = names.get((widths[stem], depth))
    if name is None:
        raise ValueError(
            f"unrecognized yolov5 variant (width {widths[stem]}, "
            f"c3_1 depth {depth})")
    return name


def convert_ultralytics_yolov5(sd: Mapping[str, Any]) -> Tuple[
        Dict[str, Any], Dict[str, Any],
        Tuple[Tuple[float, ...], ...], int]:
    """state dict -> (params, batch_stats, anchors_px, num_classes)."""
    sd = {k[6:] if k.startswith("model.model.") else k: v
          for k, v in sd.items()}           # hub checkpoints nest once more
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for ours, idx in _LAYER_MAP.items():
        key = f"model.{idx}"
        if f"{key}.cv3.conv.weight" in sd:  # C3 has cv3; Conv/SPPF do not
            params[ours], stats[ours] = _c3(sd, key)
        elif f"{key}.cv2.conv.weight" in sd:  # SPPF: cv1 + cv2
            p: Dict[str, Any] = {}
            s: Dict[str, Any] = {}
            p["ConvBnAct_0"], s["ConvBnAct_0"] = _cba(sd, f"{key}.cv1")
            p["ConvBnAct_1"], s["ConvBnAct_1"] = _cba(sd, f"{key}.cv2")
            params[ours], stats[ours] = p, s
        else:
            params[ours], stats[ours] = _cba(sd, key)

    na = None
    for i in range(3):
        w = np.asarray(sd[f"model.{_DETECT}.m.{i}.weight"], np.float32)
        b = np.asarray(sd[f"model.{_DETECT}.m.{i}.bias"], np.float32)
        params[f"detect{i}"] = {"kernel": _conv(w), "bias": b}

    anchors_buf = np.asarray(sd[f"model.{_DETECT}.anchors"], np.float32)
    na = anchors_buf.shape[1]
    no = params["detect0"]["bias"].shape[0] // na
    num_classes = no - 5
    # ultralytics stores anchors in grid (stride) units; ours are pixels
    anchors_px = tuple(
        tuple(float(v) for v in (anchors_buf[i] * STRIDES[i]).reshape(-1))
        for i in range(3)
    )
    return params, stats, anchors_px, num_classes


def import_ultralytics_localizer(
    pt_path: str,
    out_dir: str,
    input_size: int = 640,
    input_height: Optional[int] = None,
) -> str:
    """Ultralytics yolov5 checkpoint (.pt: a state dict or a full module
    pickle) -> our localizer_dir layout (best_bbox_mAP.msgpack + model.json
    with the anchors)."""
    import torch

    from effocr_torch.models.factory import create_localizer
    from effocr_torch.train import checkpoint as ckpt

    try:
        sd = torch.load(pt_path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "model" in sd and not any(
                k.startswith("model.") for k in sd):
            raise ValueError("full checkpoint dict")
        sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    except (pickle.UnpicklingError, RuntimeError, ValueError) as first_err:
        # rejected by weights_only, or a full checkpoint dict: the file is
        # a full ultralytics pickle (their Model class inside); extract
        # the tensors without the ultralytics package through the
        # allowlist unpickler.  Anything else (a corrupt zip, a truncated
        # stream, a failed numpy conversion) propagates with its own error
        from effocr_torch.interop.torch_pickle import (
            load_module_pickle_state_dict,
        )

        try:
            sd = load_module_pickle_state_dict(pt_path)
        except Exception as second_err:
            raise second_err from first_err

    name = detect_yolov5_variant(sd)
    params, stats, anchors, num_classes = convert_ultralytics_yolov5(sd)
    channels = int(np.shape(params["stem"]["Conv_0"]["kernel"])[2])
    model = create_localizer(name, num_classes=num_classes,
                             in_channels=channels, anchors=anchors)
    variables = sorted_tree({"params": params, "batch_stats": stats})
    check_tree(model, variables, "models/yolo.py")

    os.makedirs(out_dir, exist_ok=True)
    ckpt.save_variables(
        variables, ckpt.best_checkpoint_path(out_dir, "best_bbox_mAP"))
    with open(os.path.join(out_dir, "model.json"), "w") as f:
        json.dump({"arch": name, "num_classes": num_classes,
                   "input_size": input_size, "input_height": input_height,
                   "input_channels": channels,
                   "anchors": [list(a) for a in anchors],
                   "imported_from": os.path.abspath(pt_path)}, f)
    return out_dir
