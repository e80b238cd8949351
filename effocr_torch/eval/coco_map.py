"""COCO-style mAP (bbox) evaluation: a copy of the JAX package's
eval/coco_map.py (numpy only), pinned to it by a golden test
(tests/test_torch_io.py).

AP@[.5:.95:.05] with 101-point interpolation, greedy per-image matching
by score, averaged over classes; a class without ground truth has AP NaN
and leaves the mean.  The localizer trainer keeps its best checkpoint on
'bbox/AP'.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """xyxy [N,4] x [M,4] -> [N,M]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def _ap_from_matches(scores, matched, n_gt) -> float:
    """101-point interpolated AP for one class+IoU threshold."""
    if n_gt == 0:
        return np.nan
    order = np.argsort(-scores)
    matched = matched[order]
    tp = np.cumsum(matched)
    fp = np.cumsum(~matched)
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1)
    # precision envelope
    prec_interp = np.zeros_like(RECALL_POINTS)
    for i, r in enumerate(RECALL_POINTS):
        mask = recall >= r
        prec_interp[i] = precision[mask].max() if mask.any() else 0.0
    return float(prec_interp.mean())


def coco_map(
    predictions: Sequence[Dict],
    ground_truths: Sequence[Dict],
    num_classes: int = 2,
) -> Dict[str, float]:
    """predictions/ground_truths: one dict per image:
       {'boxes': [N,4] xyxy, 'classes': [N], 'scores': [N] (preds only)}.
    Returns {'bbox/AP': mAP@[.5:.95], 'bbox/AP50': ..., 'bbox/AP75': ...}.
    """
    aps = np.full((len(IOU_THRESHOLDS), num_classes), np.nan)
    for ci in range(num_classes):
        all_scores: List[np.ndarray] = []
        all_matched: List[np.ndarray] = []  # [T, n_pred] per image
        n_gt_total = 0
        for pred, gt in zip(predictions, ground_truths):
            p_sel = np.asarray(pred["classes"]) == ci
            g_sel = np.asarray(gt["classes"]) == ci
            p_boxes = np.asarray(pred["boxes"], float).reshape(-1, 4)[p_sel]
            p_scores = np.asarray(pred["scores"], float)[p_sel]
            g_boxes = np.asarray(gt["boxes"], float).reshape(-1, 4)[g_sel]
            n_gt_total += len(g_boxes)

            iou = _iou_matrix(p_boxes, g_boxes)
            order = np.argsort(-p_scores)
            matched_t = np.zeros((len(IOU_THRESHOLDS), len(p_boxes)), bool)
            for ti, thr in enumerate(IOU_THRESHOLDS):
                taken = np.zeros(len(g_boxes), bool)
                for pi in order:
                    if len(g_boxes) == 0:
                        break
                    cand = np.where(~taken & (iou[pi] >= thr))[0]
                    if len(cand):
                        best = cand[np.argmax(iou[pi][cand])]
                        taken[best] = True
                        matched_t[ti, pi] = True
            all_scores.append(p_scores)
            all_matched.append(matched_t)

        scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
        for ti in range(len(IOU_THRESHOLDS)):
            matched = (
                np.concatenate([m[ti] for m in all_matched])
                if all_matched else np.zeros(0, bool)
            )
            aps[ti, ci] = _ap_from_matches(scores, matched, n_gt_total)

    with np.errstate(invalid="ignore"):
        per_thr = np.nanmean(aps, axis=1)
    result = {
        "bbox/AP": float(np.nanmean(per_thr)),
        "bbox/AP50": float(per_thr[0]),
        "bbox/AP75": float(per_thr[5]),
    }
    return result
