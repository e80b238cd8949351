"""Training losses (the JAX package's train/losses.py): SupCon for
metric learning, the cosine-classifier proxy cross-entropy, plain
cross-entropy for classifier mode, and the YOLOv5 detector loss.  All in
float32; the similarity matmuls are full float32 (the JAX package asks
for ``Precision.HIGHEST``), so TF32 must stay off (core/device.py).

Inside a process group of N ranks, each holding its slice of the global
batch, every loss is built so that its mean over ranks is the loss of
the global batch (core/distributed.py): SupCon over the all-gathered
batch, the same on every rank; a sum over the batch as ``N * local_sum
/ global_count``; a mean over equal slices as the local mean.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from effocr_torch.core import distributed
from effocr_torch.kernels.retrieval import l2_normalize


def supcon_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                temperature: float = 0.1,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Supervised contrastive loss over one batch view: cosine
    similarities over the batch, per-anchor mean log-probability over its
    positives, averaged over the anchors that have positives.

    embeddings [B, D] (unnormalised), labels [B] int, valid [B] bool
    (padding slots leave anchors, positives and denominators).  Inside a
    process group each rank passes its rows and the loss is that of the
    all-gathered global batch, on every rank; the gather's backward pass
    brings every term's gradient to the rank that holds the row."""
    if distributed.world_size() > 1:
        embeddings = distributed.gather_rows(embeddings.float())
        labels = distributed.gather_rows(labels)
        if valid is not None:
            valid = distributed.gather_rows(valid)
    b = embeddings.shape[0]
    dev = embeddings.device
    if valid is None:
        valid = torch.ones((b,), dtype=torch.bool, device=dev)
    z = l2_normalize(embeddings.float())
    sims = (z @ z.t()) / temperature
    eye = torch.eye(b, dtype=torch.bool, device=dev)
    pair_valid = valid[:, None] & valid[None, :] & ~eye
    pos = (labels[:, None] == labels[None, :]) & pair_valid
    sims = torch.where(pair_valid, sims, float("-inf"))
    logp = sims - torch.logsumexp(sims, dim=1, keepdim=True)
    n_pos = pos.sum(dim=1)
    per_anchor = torch.where(pos, logp, 0.0).sum(dim=1) / torch.clamp(
        n_pos, min=1)
    has_pos = (n_pos > 0) & valid
    return -torch.where(has_pos, per_anchor, 0.0).sum() / torch.clamp(
        has_pos.sum(), min=1)


def cosine_classifier_loss(embeddings: torch.Tensor, weights: torch.Tensor,
                           labels: torch.Tensor, temperature: float = 0.07,
                           valid: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """NormFace-style proxy cross-entropy: cross-entropy over the cosine
    similarities of each embedding to learnable class proxies [C, D]."""
    z = l2_normalize(embeddings.float())
    w = l2_normalize(weights.float())
    return cross_entropy_loss((z @ w.t()) / temperature, labels, valid)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None].long())[:, 0]
    if valid is None:
        # equal slices: the mean over ranks of the local means is the
        # global mean
        return nll.mean()
    count = distributed.global_count(valid.sum())
    return distributed.world_size() * torch.where(valid, nll, 0.0).sum() \
        / torch.clamp(count, min=1)


# ------------------------------------------------------------- yolo loss

def _bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits in the softplus form
    ``log(1 + e^x) - x t`` (gradient ``sigmoid(x) - t`` everywhere).
    ``torch.logaddexp(x, 0)`` is the softplus of ``jax.nn.softplus``;
    ``F.softplus`` returns x itself above 20."""
    return torch.logaddexp(logits, torch.zeros_like(logits)) - \
        logits * targets


def _ciou(box1: torch.Tensor, box2: torch.Tensor,
          eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU between xywh boxes [..., 4] (YOLOv5 box regression);
    the aspect term's weight ``alpha`` carries no gradient."""
    b1x, b1y, b1w, b1h = box1.unbind(-1)
    b2x, b2y, b2w, b2h = box2.unbind(-1)
    b1x1, b1x2 = b1x - b1w / 2, b1x + b1w / 2
    b1y1, b1y2 = b1y - b1h / 2, b1y + b1h / 2
    b2x1, b2x2 = b2x - b2w / 2, b2x + b2w / 2
    b2y1, b2y2 = b2y - b2h / 2, b2y + b2h / 2

    inter = torch.clamp(torch.minimum(b1x2, b2x2)
                        - torch.maximum(b1x1, b2x1), min=0) * \
        torch.clamp(torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1),
                    min=0)
    union = b1w * b1h + b2w * b2h - inter + eps
    iou = inter / union

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (b2x - b1x) ** 2 + (b2y - b1y) ** 2
    v = (4 / math.pi ** 2) * torch.square(
        torch.atan(b2w / (b2h + eps)) - torch.atan(b1w / (b1h + eps)))
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


@functools.lru_cache(maxsize=None)
def _anchor_grid_units(anc: Tuple[float, ...], stride: int,
                       device: torch.device) -> torch.Tensor:
    """[na, 2] anchor sizes in grid units, made once per device (a host
    tensor copied up every step would stall the host)."""
    return (torch.tensor(anc, dtype=torch.float32).reshape(-1, 2)
            / stride).to(device)


def yolo_loss(
    raw: Sequence[torch.Tensor],
    targets: torch.Tensor,
    target_mask: torch.Tensor,
    anchors: Sequence[Sequence[float]],
    strides: Sequence[int] = (8, 16, 32),
    num_classes: int = 2,
    box_gain: float = 0.05,
    obj_gain: float = 1.0,
    cls_gain: float = 0.5,
    anchor_t: float = 4.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """YOLOv5 loss with fixed-shape target assignment.

    raw: per-scale logits [B, gh, gw, na, 5+nc] (``model(x,
    decode=False)``); targets [B, T, 5] = (cls, cx, cy, w, h) in pixels of
    the input canvas; target_mask [B, T] bool.

    Each valid target whose w/h ratio to an anchor is under ``anchor_t``
    claims its centre cell and the two nearest neighbour cells (YOLOv5's
    g = 0.5) for that anchor.  A cell claimed by several targets goes to
    the highest target index (a scatter-max; candidates that are off the
    grid or rejected scatter -1 into cell (0, 0, 0, 0)).  Box loss 1 -
    CIoU over matched cells; objectness BCE against the detached CIoU
    clipped at 0, balanced (4.0, 1.0, 0.4) over the scales; class BCE
    over matched cells (none when ``num_classes`` is 1).  The loss is
    returned times B.  Inside a process group B is the global batch and
    the matched-cell counts are global (sums over ranks)."""
    balance = (4.0, 1.0, 0.4)
    n_ranks = distributed.world_size()
    b, t = targets.shape[:2]
    dev = targets.device
    total_box, total_obj, total_cls = 0.0, 0.0, 0.0
    t_idx = torch.arange(t, device=dev)

    for si, (y, anc, stride) in enumerate(zip(raw, anchors, strides)):
        _, gh, gw, na, _ = y.shape
        anc_wh = _anchor_grid_units(tuple(float(a) for a in anc), stride,
                                    dev)

        gxy = targets[..., 1:3] / stride              # [B,T,2] grid units
        gwh = targets[..., 3:5] / stride
        cls = targets[..., 0].to(torch.int64)

        # anchor match: max wh ratio < anchor_t        [B,T,na]
        r = gwh[:, :, None, :] / anc_wh[None, None, :, :]
        ratio = torch.maximum(r, 1.0 / torch.clamp(r, min=1e-9)).amax(-1)
        anc_ok = (ratio < anchor_t) & target_mask[:, :, None]

        # candidate cells: centre, x-neighbour, y-neighbour   [B,T,3]
        gxi, gyi = gxy[..., 0], gxy[..., 1]
        off_x = torch.where(torch.remainder(gxi, 1.0) < 0.5, -1.0, 1.0)
        off_y = torch.where(torch.remainder(gyi, 1.0) < 0.5, -1.0, 1.0)
        zero = torch.zeros_like(off_x)
        cell_x = torch.floor(gxi)[..., None] + torch.stack(
            [zero, off_x, zero], -1)
        cell_y = torch.floor(gyi)[..., None] + torch.stack(
            [zero, zero, off_y], -1)
        in_grid = (cell_x >= 0) & (cell_x < gw) & (cell_y >= 0) & \
            (cell_y < gh)
        cand_ok = anc_ok[:, :, :, None] & in_grid[:, :, None, :]  # [B,T,na,3]

        # scatter-max of the target index into the cell grid [B,gh,gw,na]
        shape = cand_ok.shape
        bb = torch.arange(b, device=dev)[:, None, None, None].expand(shape)
        aa = torch.arange(na, device=dev)[None, None, :, None].expand(shape)
        cy = cell_y[:, :, None, :].expand(shape).to(torch.int64)
        cx = cell_x[:, :, None, :].expand(shape).to(torch.int64)
        flat = ((bb * gh + cy) * gw + cx) * na + aa
        flat = torch.where(cand_ok, flat, 0).reshape(-1)
        flat_t = torch.where(cand_ok, t_idx[None, :, None, None].expand(
            shape), -1).reshape(-1)
        assign = torch.full((b * gh * gw * na,), -1, dtype=torch.int64,
                            device=dev)
        assign = assign.scatter_reduce(0, flat, flat_t, reduce="amax")
        assign = assign.reshape(b, gh, gw, na)

        matched = assign >= 0
        safe_t = torch.clamp(assign, min=0)
        bi = torch.arange(b, device=dev)[:, None, None, None]
        g_xy = gxy[bi, safe_t]                          # [B,gh,gw,na,2]
        g_wh = gwh[bi, safe_t]
        g_cls = cls[bi, safe_t]

        # predicted box per cell (YOLOv5 decode in grid units)
        ps = y.float()
        grid_x = torch.arange(gw, dtype=torch.float32, device=dev)[
            None, None, :, None].expand(ps.shape[:4])
        grid_y = torch.arange(gh, dtype=torch.float32, device=dev)[
            None, :, None, None].expand(ps.shape[:4])
        pxy = torch.sigmoid(ps[..., :2]) * 2.0 - 0.5
        pxy = pxy + torch.stack([grid_x, grid_y], -1)
        pwh = torch.square(torch.sigmoid(ps[..., 2:4]) * 2.0) * anc_wh
        pbox = torch.cat([pxy, pwh], -1)
        tbox = torch.cat([g_xy, g_wh], -1)

        iou = _ciou(pbox, tbox)
        n_matched = torch.clamp(distributed.global_count(matched.sum()),
                                min=1)
        box_l = n_ranks * torch.where(matched, 1.0 - iou, 0.0).sum() / \
            n_matched

        obj_t = torch.where(matched, torch.clamp(iou.detach(), min=0.0), 0.0)
        obj_l = _bce(ps[..., 4], obj_t).mean() * balance[si]

        if num_classes > 1:
            # (a class id out of range gives a zero row, as jax.nn.one_hot)
            one_hot = (g_cls[..., None] == torch.arange(
                num_classes, device=dev)).float()
            cls_bce = _bce(ps[..., 5:], one_hot)
            cls_l = n_ranks * torch.where(matched[..., None], cls_bce,
                                          0.0).sum() / (
                n_matched * num_classes)
        else:
            cls_l = 0.0

        total_box = total_box + box_l
        total_obj = total_obj + obj_l
        total_cls = total_cls + cls_l

    loss = box_gain * total_box + obj_gain * total_obj + cls_gain * total_cls
    parts = {
        "loss/box": box_gain * total_box,
        "loss/obj": obj_gain * total_obj,
        "loss/cls": cls_gain * total_cls,
    }
    return loss * (b * n_ranks), parts
