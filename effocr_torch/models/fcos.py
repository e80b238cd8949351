"""Anchor-free (FCOS-style) detector, the PyTorch twin of the JAX package's
models/fcos.py.

The YOLO family's CSP + PAN trunk (models/yolo.py ``CSPTrunk``); each
cell of each level predicts (l, t, r, b) distances, a centerness logit
and class logits.  ``decode_fcos`` emits the YOLO decoded layout [B, A,
5+nc] (xywh, obj = centerness, class probabilities), so ``decode_and_nms``
and the engine take it unchanged.  ``forward`` takes NHWC images and
returns ``(decoded, raw)`` with raw grids [B, gh, gw, 5+nc] (float32), or
only ``raw`` with ``decode=False``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from effocr_torch.core import distributed
from effocr_torch.models.layers import Conv, ConvBnAct
from effocr_torch.models.yolo import CSPTrunk

STRIDES = (8, 16, 32)
# per-level max(ltrb) regression ranges (FCOS defaults, scaled down for
# character-size objects)
SIZE_RANGES = ((0.0, 64.0), (64.0, 128.0), (128.0, 1e8))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``); ``F.softplus`` returns x
    itself above 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def bce(logits: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits, ``softplus(x) - x t``."""
    return softplus(logits) - logits * t


class FCOS(CSPTrunk):
    """Returns (decoded [B, A, 5+nc], raw per-scale [B, H, W, 5+nc])."""

    def __init__(self, num_classes: int = 2, depth_multiple: float = 0.33,
                 width_multiple: float = 0.50, in_channels: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.no = 5 + num_classes
        self._build_trunk(in_channels, width_multiple, depth_multiple, dtype)
        w = self.w
        for i, f in enumerate((w(256), w(512), w(1024))):
            setattr(self, f"head{i}_a", ConvBnAct(f, w(256), 3, 1,
                                                  dtype=dtype))
            setattr(self, f"head{i}_out", Conv(w(256), self.no, 1,
                                               dtype=torch.float32))

    def forward(self, x: torch.Tensor, decode: bool = True):
        """x: [B, H, W, C] float images (NHWC, as in the JAX package)."""
        raw = []
        for i, feat in enumerate(self.trunk(x)):
            h = getattr(self, f"head{i}_a")(feat)
            y = getattr(self, f"head{i}_out")(h)           # [B, no, h, w]
            raw.append(y.permute(0, 2, 3, 1))
        if not decode:
            return raw
        return decode_fcos(raw), raw


def _centers(gh: int, gw: int, stride: int, device):
    cx = (torch.arange(gw, dtype=torch.float32, device=device) + 0.5) * stride
    cy = (torch.arange(gh, dtype=torch.float32, device=device) + 0.5) * stride
    return cx, cy


def decode_fcos(raw: Sequence[torch.Tensor],
                strides: Tuple[int, ...] = STRIDES) -> torch.Tensor:
    """Per-scale [B, H, W, 5+nc] -> [B, A, 5+nc] in the YOLO decoded
    layout (cx, cy, w, h, obj = centerness, class probabilities)."""
    outs: List[torch.Tensor] = []
    for y, stride in zip(raw, strides):
        b, gh, gw, no = y.shape
        y = y.float()
        cx, cy = _centers(gh, gw, stride, y.device)
        cx, cy = cx[None, None, :], cy[None, :, None]
        ltrb = softplus(y[..., :4]) * stride
        x0 = cx - ltrb[..., 0]
        y0 = cy - ltrb[..., 1]
        x1 = cx + ltrb[..., 2]
        y1 = cy + ltrb[..., 3]
        boxes = torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0],
                            dim=-1)
        out = torch.cat([boxes, torch.sigmoid(y[..., 4:5]),
                         torch.sigmoid(y[..., 5:])], dim=-1)
        outs.append(out.reshape(b, gh * gw, no))
    return torch.cat(outs, dim=1)


def fcos_loss(
    raw: Sequence[torch.Tensor],
    targets: torch.Tensor,
    target_mask: torch.Tensor,
    num_classes: int = 2,
    strides: Tuple[int, ...] = STRIDES,
    size_ranges: Tuple[Tuple[float, float], ...] = SIZE_RANGES,
    center_radius: float = 1.5,
    cls_gain: float = 1.0,
    box_gain: float = 1.0,
    ctr_gain: float = 1.0,
):
    """FCOS objective: BCE classes + GIoU boxes + BCE centerness (positives
    weighted 1, negatives 0.1), with center-sampled, size-range-bucketed
    assignment; each cell takes the smallest-area candidate ground truth
    (the first on ties; masked ground truths have area inf).

    targets [B, T, 5] = (cls, cx, cy, w, h) pixels; target_mask [B, T].
    Returns (loss, {"loss/box", "loss/obj", "loss/cls"}).  Inside a
    process group the batch sums are ``N * local_sum`` and the positive
    count is global, so the mean over ranks is the global batch's loss
    (core/distributed.py)."""
    targets = targets.float()
    b = targets.shape[0]
    gt_x0 = targets[..., 1] - targets[..., 3] / 2
    gt_y0 = targets[..., 2] - targets[..., 4] / 2
    gt_x1 = targets[..., 1] + targets[..., 3] / 2
    gt_y1 = targets[..., 2] + targets[..., 4] / 2
    inf = torch.tensor(float("inf"), device=targets.device)
    gt_area = torch.where(target_mask, targets[..., 3] * targets[..., 4],
                          inf)
    total_cls = total_box = total_ctr = total_pos = 0.0

    for y, stride, (lo, hi) in zip(raw, strides, size_ranges):
        _, gh, gw, no = y.shape
        y = y.float()
        cx, cy = _centers(gh, gw, stride, y.device)
        ccx = cx[None, :].expand(gh, gw).reshape(-1)[None, :, None]
        ccy = cy[:, None].expand(gh, gw).reshape(-1)[None, :, None]
        # distances [B, HW, T]
        l = ccx - gt_x0[:, None, :]
        t = ccy - gt_y0[:, None, :]
        r = gt_x1[:, None, :] - ccx
        bo = gt_y1[:, None, :] - ccy
        min_ltrb = torch.minimum(torch.minimum(l, t), torch.minimum(r, bo))
        max_ltrb = torch.maximum(torch.maximum(l, t), torch.maximum(r, bo))
        radius = center_radius * stride
        near_center = (
            ((ccx - targets[..., 1][:, None, :]).abs() < radius)
            & ((ccy - targets[..., 2][:, None, :]).abs() < radius))
        cand = ((min_ltrb > 0) & (max_ltrb >= lo) & (max_ltrb <= hi)
                & near_center & target_mask[:, None, :])
        # min-area gt per cell; torch.argmin (like jnp.argmin) returns the
        # first index among equal minima
        area = torch.where(cand, gt_area[:, None, :], inf)
        best = torch.argmin(area, dim=2, keepdim=True)        # [B, HW, 1]

        def take(arr):
            return torch.gather(arr, 2, best)[..., 0]

        pos = take(cand)
        tl, tt, tr, tb = take(l), take(t), take(r), take(bo)
        tcls = take(targets[..., 0].to(torch.int32)[:, None, :].expand(
            b, gh * gw, -1).long())

        yf = y.reshape(b, gh * gw, no)
        onehot = F.one_hot(tcls, num_classes).float() * pos[..., None]
        total_cls = total_cls + bce(yf[..., 5:], onehot).sum(-1).sum() / (
            gh * gw)

        # box GIoU at positives
        pl, pt, pr, pb = (softplus(yf[..., i]) * stride for i in range(4))
        inter = (torch.minimum(pl, tl) + torch.minimum(pr, tr)) * (
            torch.minimum(pt, tt) + torch.minimum(pb, tb))
        union = (pl + pr) * (pt + pb) + (tl + tr) * (tt + tb) - inter
        enclose = (torch.maximum(pl, tl) + torch.maximum(pr, tr)) * (
            torch.maximum(pt, tt) + torch.maximum(pb, tb))
        iou = inter / torch.clamp(union, min=1e-9)
        giou = iou - (enclose - union) / torch.clamp(enclose, min=1e-9)
        total_box = total_box + torch.where(pos, 1.0 - giou,
                                            torch.zeros_like(giou)).sum()

        # centerness
        ctr_t = torch.sqrt(
            torch.clamp(torch.minimum(tl, tr) / torch.clamp(
                torch.maximum(tl, tr), min=1e-9), 0, 1)
            * torch.clamp(torch.minimum(tt, tb) / torch.clamp(
                torch.maximum(tt, tb), min=1e-9), 0, 1))
        ctr_l = bce(yf[..., 4], torch.where(pos, ctr_t,
                                            torch.zeros_like(ctr_t)))
        total_ctr = total_ctr + torch.where(pos, ctr_l, ctr_l * 0.1).sum() \
            / (gh * gw)
        total_pos = total_pos + pos.sum()

    n_ranks = distributed.world_size()
    if n_ranks > 1:
        total_pos = distributed.global_count(total_pos)
        total_cls, total_box, total_ctr = (
            n_ranks * total_cls, n_ranks * total_box, n_ranks * total_ctr)
    npos = torch.clamp(torch.as_tensor(total_pos, dtype=torch.float32),
                       min=1.0)
    loss = (cls_gain * total_cls + ctr_gain * total_ctr) + \
        box_gain * total_box / npos
    metrics = {
        "loss/box": box_gain * total_box / npos,
        "loss/obj": ctr_gain * total_ctr,
        "loss/cls": cls_gain * total_cls,
    }
    return loss, metrics


def fcos_s(**kw):
    return FCOS(depth_multiple=0.33, width_multiple=0.50, **kw)


def fcos_n(**kw):
    return FCOS(depth_multiple=0.33, width_multiple=0.25, **kw)
