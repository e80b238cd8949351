"""Two-stage (Faster R-CNN-style) detector, the PyTorch twin of the JAX
package's models/rcnn.py.

- The YOLO family's CSP + PAN trunk (models/yolo.py ``CSPTrunk``), with
  1x1 laterals ``fpn{i}`` projecting the three levels to one FPN width.
- RPN: 3 anchors a cell (aspect 0.5 / 1 / 2) on strides 8 / 16 / 32,
  box-delta decode, per-level top-k, then class-agnostic greedy NMS over
  the candidates -> exactly ``num_proposals`` proposals an image with a
  validity mask.  The keep mask comes from the NMS kernel (``rpn_keep``).
- ROIAlign: 7 x 7 bins of 2 x 2 bilinear samples, each proposal sampled
  on its FPN level only (the JAX package samples every level and masks;
  the masked levels add exact zeros, so the sums are equal).
- Box head: 2-layer MLP -> softmax classes (+ background) and per-class
  box deltas.

``forward(x, decode=True)`` returns ``(decoded [B, P, 5+nc], aux)`` in the
YOLO decoded layout (xywh, obj, class probabilities), so
``decode_and_nms`` and the engine take it unchanged; ``decode=False``
returns ``aux`` (``rcnn_loss``'s input).  Every top-k is a stable sort:
ties go to the lower index, as ``lax.top_k`` orders them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from effocr_torch.kernels import cuda_nms
from effocr_torch.kernels.nms import NEG_INF, nms_mask
from effocr_torch.models.fcos import bce
from effocr_torch.models.layers import Conv, ConvBnAct, Dense
from effocr_torch.models.yolo import CSPTrunk

STRIDES = (8, 16, 32)
ANCHOR_SIZES = (32.0, 64.0, 128.0)        # one size per level
ANCHOR_ASPECTS = (0.5, 1.0, 2.0)          # h/w
DELTA_CLIP = 4.0                          # log-space wh delta clip
# float32 elements of one ROIAlign gather slice (4 corners and the blend
# each hold one): 512 MB
ROI_SLICE_ELEMS = 1 << 27


def level_anchors(gh: int, gw: int, stride: int, size: float,
                  device=None) -> torch.Tensor:
    """[gh*gw*3, 4] xyxy anchors for one level, cell-major / anchor-minor
    (the RPN head's [B, gh, gw, na*5] -> [B, gh*gw*na, 5] order)."""
    cx = (torch.arange(gw, dtype=torch.float32, device=device) + 0.5) * stride
    cy = (torch.arange(gh, dtype=torch.float32, device=device) + 0.5) * stride
    ccx = cx[None, :].expand(gh, gw)
    ccy = cy[:, None].expand(gh, gw)
    boxes = []
    for ar in ANCHOR_ASPECTS:
        w = size / math.sqrt(ar)
        h = size * math.sqrt(ar)
        boxes.append(torch.stack([ccx - w / 2, ccy - h / 2, ccx + w / 2,
                                  ccy + h / 2], dim=-1))
    return torch.stack(boxes, dim=2).reshape(-1, 4)


def apply_deltas(anchors: torch.Tensor, deltas: torch.Tensor
                 ) -> torch.Tensor:
    """R-CNN box-delta decode: anchors [..., N, 4] xyxy, deltas [..., N,
    4] (dx, dy, dw, dh) -> xyxy."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = anchors[..., 0] + aw / 2
    acy = anchors[..., 1] + ah / 2
    cx = deltas[..., 0] * aw + acx
    cy = deltas[..., 1] * ah + acy
    w = torch.exp(torch.clamp(deltas[..., 2], -DELTA_CLIP, DELTA_CLIP)) * aw
    h = torch.exp(torch.clamp(deltas[..., 3], -DELTA_CLIP, DELTA_CLIP)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def boxes_to_deltas(anchors: torch.Tensor, boxes: torch.Tensor
                    ) -> torch.Tensor:
    """Inverse of apply_deltas (regression targets); both xyxy."""
    aw = torch.clamp(anchors[..., 2] - anchors[..., 0], min=1e-6)
    ah = torch.clamp(anchors[..., 3] - anchors[..., 1], min=1e-6)
    acx = anchors[..., 0] + aw / 2
    acy = anchors[..., 1] + ah / 2
    bw = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-6)
    bh = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-6)
    bcx = boxes[..., 0] + bw / 2
    bcy = boxes[..., 1] + bh / 2
    return torch.stack([(bcx - acx) / aw, (bcy - acy) / ah,
                        torch.log(bw / aw), torch.log(bh / ah)], dim=-1)


def _clip_boxes(boxes: torch.Tensor, img_w: int, img_h: int
                ) -> torch.Tensor:
    return torch.stack([
        torch.clamp(boxes[..., 0], 0, img_w),
        torch.clamp(boxes[..., 1], 0, img_h),
        torch.clamp(boxes[..., 2], 0, img_w),
        torch.clamp(boxes[..., 3], 0, img_h),
    ], dim=-1)


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest, ties lower index
    first (``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def rpn_keep(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_thresh: float, kernel: str = "cuda") -> torch.Tensor:
    """Greedy-NMS keep mask [B, N] of unsorted candidates, in input order:
    kernels/nms.py ``nms_mask(presorted=False)``'s result.

    ``kernel="cuda"``: the candidates are stable-sorted by score,
    descending, invalid ones last (nms_mask's rank), the keep mask of the
    sorted boxes taken from kernels/cuda_nms.py ``nms_keep`` (the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors), and
    scattered back to input order.  ``kernel="plain"``: ``nms_mask``."""
    if kernel == "plain":
        return nms_mask(boxes, scores, valid, iou_thresh)
    if kernel != "cuda":
        raise ValueError(f"unknown NMS kernel {kernel!r}")
    key = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.argsort(-key, dim=-1, stable=True)
    sorted_boxes = torch.gather(boxes, 1, order[..., None].expand(
        *order.shape, 4)).contiguous()
    keep_sorted = cuda_nms.nms_keep(sorted_boxes,
                                    torch.gather(valid, 1, order),
                                    iou_thresh)
    return torch.zeros_like(valid).scatter_(1, order, keep_sorted)


def roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
              out: int = 7, strides: Tuple[int, ...] = STRIDES
              ) -> torch.Tensor:
    """Multi-level ROIAlign: feats per level [B, H, W, C] float32, boxes
    [B, P, 4] xyxy pixels -> [B, P, out, out, C].

    Each proposal's level comes from its scale (sqrt(area) < 64 -> P3,
    < 128 -> P4, else P5); its 2x-oversampled bilinear grid is sampled on
    that level only, in slices of proposals (ROI_SLICE_ELEMS), and 2 x 2
    average-pooled."""
    b, p = boxes.shape[:2]
    c = feats[0].shape[-1]
    s = out * 2
    boxes = boxes.reshape(b * p, 4)
    x0, y0, x1, y1 = boxes.unbind(-1)
    bw = torch.clamp(x1 - x0, min=1.0)
    bh = torch.clamp(y1 - y0, min=1.0)
    scale = torch.sqrt(bw * bh)
    lvl = (scale >= 64.0).to(torch.int64) + (scale >= 128.0).to(torch.int64)
    fx = (torch.arange(s, dtype=torch.float32, device=boxes.device) + 0.5) / s
    gx = x0[:, None] + fx[None, :] * bw[:, None]          # [M, s]
    gy = y0[:, None] + fx[None, :] * bh[:, None]
    image = torch.arange(b, device=boxes.device).repeat_interleave(p)
    result = torch.zeros((b * p, out, out, c), dtype=torch.promote_types(
        feats[0].dtype, boxes.dtype), device=boxes.device)
    per_slice = max(ROI_SLICE_ELEMS // (s * s * c), 1)
    for li, (feat, stride) in enumerate(zip(feats, strides)):
        rows = torch.nonzero(lvl == li)[:, 0]
        if rows.numel() == 0:
            continue
        _, h, w, _ = feat.shape
        flat = feat.reshape(-1, c)
        for r in rows.split(per_slice):
            xs = gx[r] / stride - 0.5
            ys = gy[r] / stride - 0.5
            x0i = torch.clamp(torch.floor(xs), 0, w - 1)
            y0i = torch.clamp(torch.floor(ys), 0, h - 1)
            x1i = torch.clamp(x0i + 1, 0, w - 1)
            y1i = torch.clamp(y0i + 1, 0, h - 1)
            wx = torch.clamp(xs - x0i, 0.0, 1.0)[:, None, :, None]
            wy = torch.clamp(ys - y0i, 0.0, 1.0)[:, :, None, None]
            base = (image[r] * (h * w))[:, None, None]

            def gather(yi, xi):
                idx = base + (yi[:, :, None] * w + xi[:, None, :]).long()
                return flat[idx.reshape(-1)].reshape(len(r), s, s, c)

            val = ((gather(y0i, x0i) * (1 - wx) + gather(y0i, x1i) * wx)
                   * (1 - wy)
                   + (gather(y1i, x0i) * (1 - wx) + gather(y1i, x1i) * wx)
                   * wy)
            result[r] = val.reshape(len(r), out, 2, out, 2, c).mean(
                dim=(2, 4))
    return result.reshape(b, p, out, out, c)


class FasterRCNN(CSPTrunk):
    """Two-stage detector; see the module docstring."""

    def __init__(self, num_classes: int = 2, depth_multiple: float = 0.33,
                 width_multiple: float = 0.50, num_proposals: int = 256,
                 pre_nms_topk: int = 256, rpn_nms_iou: float = 0.7,
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.num_proposals = num_proposals
        self.pre_nms_topk = pre_nms_topk
        self.rpn_nms_iou = rpn_nms_iou
        self._build_trunk(in_channels, width_multiple, depth_multiple, dtype)
        w = self.w
        fdim = w(256)
        for i, f in enumerate((w(256), w(512), w(1024))):
            setattr(self, f"fpn{i}", Conv(f, fdim, 1, dtype=dtype))
        na = len(ANCHOR_ASPECTS)
        self.rpn_conv = ConvBnAct(fdim, fdim, 3, 1, dtype=dtype)
        self.rpn_out = Conv(fdim, na * 5, 1, dtype=torch.float32)
        self.fc1 = Dense(49 * fdim, 1024, dtype=dtype)
        self.fc2 = Dense(1024, 1024, dtype=dtype)
        self.cls = Dense(1024, num_classes + 1, dtype=torch.float32)
        self.reg = Dense(1024, num_classes * 4, dtype=torch.float32)

    def _proposals(self, rpn_boxes, rpn_scores):
        """Detached candidates [B, K, 4] / [B, K] -> (proposals [B, P, 4],
        valid [B, P])."""
        degenerate = ((rpn_boxes[..., 2] - rpn_boxes[..., 0]) < 1.0) | (
            (rpn_boxes[..., 3] - rpn_boxes[..., 1]) < 1.0)
        keep = rpn_keep(rpn_boxes, rpn_scores, ~degenerate, self.rpn_nms_iou)
        key = torch.where(keep, rpn_scores,
                          torch.full_like(rpn_scores, float("-inf")))
        p_eff = min(self.num_proposals, rpn_boxes.shape[1])
        top, idx = stable_topk(key, p_eff)
        if p_eff < self.num_proposals:
            pad = self.num_proposals - p_eff
            top = F.pad(top, (0, pad), value=float("-inf"))
            idx = F.pad(idx, (0, pad))
        props = torch.gather(rpn_boxes, 1, idx[..., None].expand(
            *idx.shape, 4))
        return props, top > float("-inf")

    def forward(self, x: torch.Tensor, decode: bool = True):
        """x: [B, H, W, C] float images (NHWC, as in the JAX package)."""
        # record_function ranges name the stages in a torch.profiler trace
        # (chip_smoke.py --profile); ~1 us each when no profiler runs
        img_h, img_w = x.shape[1], x.shape[2]
        with record_function("rcnn/trunk"):
            fpn = [getattr(self, f"fpn{i}")(o)
                   for i, o in enumerate(self.trunk(x))]      # NCHW
        with record_function("rcnn/rpn"):
            rpn_raw, anchors, proposals, prop_valid = self._rpn(
                fpn, img_w, img_h)
        with record_function("rcnn/roi_align"):
            # float32 (float64 stays float64)
            feats = [f.permute(0, 2, 3, 1).to(torch.promote_types(
                f.dtype, torch.float32)) for f in fpn]
            rois = roi_align(feats, proposals)                # [B,P,7,7,C]
        with record_function("rcnn/box_head"):
            return self._box_head(rois, rpn_raw, anchors, proposals,
                                  prop_valid, img_w, img_h, decode)

    def _rpn(self, fpn, img_w, img_h):
        """RPN head over the FPN levels -> (raw [B, N_l, 5] per level,
        anchors per level, proposals [B, P, 4], valid [B, P])."""
        na = len(ANCHOR_ASPECTS)
        rpn_raw, anchors, cand_boxes, cand_scores = [], [], [], []
        for feat, stride, size in zip(fpn, STRIDES, ANCHOR_SIZES):
            b, _, gh, gw = feat.shape
            r = self.rpn_out(self.rpn_conv(feat))          # [B, na*5, h, w]
            r = r.permute(0, 2, 3, 1).reshape(b, gh * gw * na, 5)
            anc = level_anchors(gh, gw, stride, size, device=r.device)
            rpn_raw.append(r)
            anchors.append(anc)
            # per-level top-k proposal candidates
            boxes = _clip_boxes(apply_deltas(anc[None], r[..., 1:]), img_w,
                                img_h)
            sc, idx = stable_topk(r[..., 0], min(self.pre_nms_topk,
                                                 r.shape[1]))
            cand_boxes.append(torch.gather(boxes, 1, idx[..., None].expand(
                *idx.shape, 4)))
            cand_scores.append(sc)
        proposals, prop_valid = self._proposals(
            torch.cat(cand_boxes, dim=1).detach(),
            torch.cat(cand_scores, dim=1).detach())
        return rpn_raw, anchors, proposals, prop_valid

    def _box_head(self, rois, rpn_raw, anchors, proposals, prop_valid,
                  img_w, img_h, decode):
        bsz, p = rois.shape[:2]
        h = rois.reshape(bsz, p, -1).to(self.dtype)
        h = torch.relu(self.fc1(h))
        h = torch.relu(self.fc2(h))
        roi_cls = self.cls(h)
        roi_deltas = self.reg(h)

        aux: Dict[str, Any] = {
            "rpn_raw": rpn_raw, "anchors": anchors,
            "proposals": proposals, "prop_valid": prop_valid,
            "roi_cls": roi_cls, "roi_deltas": roi_deltas,
        }
        if not decode:
            return aux

        # decode into the YOLO [B, P, 5+nc] layout
        probs = torch.softmax(roi_cls, dim=-1)                # [B,P,nc+1]
        cls_probs = probs[..., 1:]
        best = torch.argmax(cls_probs, dim=-1)                # [B,P]
        deltas = torch.gather(
            roi_deltas.reshape(bsz, p, self.num_classes, 4), 2,
            best[..., None, None].expand(bsz, p, 1, 4))[..., 0, :]
        refined = _clip_boxes(apply_deltas(proposals, deltas), img_w, img_h)
        xywh = torch.stack([
            (refined[..., 0] + refined[..., 2]) / 2,
            (refined[..., 1] + refined[..., 3]) / 2,
            refined[..., 2] - refined[..., 0],
            refined[..., 3] - refined[..., 1],
        ], dim=-1)
        obj = (1.0 - probs[..., 0:1]) * prop_valid[..., None]
        # decode_and_nms's conf = obj * cls; normalised so that obj *
        # max(cls) is the best class's softmax probability
        denom = torch.clamp(1.0 - probs[..., 0:1], min=1e-9)
        decoded = torch.cat([xywh, obj, cls_probs / denom], dim=-1)
        return decoded, aux


# --------------------------------------------------------------------- loss

def _smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _pair_iou(boxes: torch.Tensor, gts: torch.Tensor, gmask: torch.Tensor
              ) -> torch.Tensor:
    """boxes [B, N, 4] (or [N, 4]), gts [B, T, 4] -> [B, N, T] IoU; masked
    ground truths get 0."""
    if boxes.dim() == 2:
        boxes = boxes[None]
    lt = torch.maximum(boxes[..., :, None, :2], gts[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], gts[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1], min=0.0)
    a2 = torch.clamp(gts[..., 2] - gts[..., 0], min=0.0) * torch.clamp(
        gts[..., 3] - gts[..., 1], min=0.0)
    iou = inter / torch.clamp(a1[..., :, None] + a2[..., None, :] - inter,
                              min=1e-9)
    return iou * gmask[..., None, :]


def _take_gt(gts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """gts [B, T, 4] at idx [B, N] -> [B, N, 4]."""
    return torch.gather(gts, 1, idx[..., None].expand(*idx.shape, 4))


def rcnn_loss(
    aux: Dict[str, Any],
    targets: torch.Tensor,
    target_mask: torch.Tensor,
    num_classes: int = 2,
    rpn_pos_iou: float = 0.7,
    rpn_neg_iou: float = 0.3,
    roi_pos_iou: float = 0.5,
    rpn_gain: float = 1.0,
    roi_gain: float = 1.0,
    box_gain: float = 2.0,
):
    """Faster R-CNN objective with fixed-shape assignment.

    targets [B, T, 5] = (cls, cx, cy, w, h) pixels; target_mask [B, T].
    RPN: BCE objectness (positive at IoU > 0.7 or as a ground truth's
    best anchor, the first on ties; negative at IoU < 0.3) + smooth-L1
    deltas at positives.  ROI head: softmax CE with background over the
    valid proposals + smooth-L1 class-specific deltas at positives (IoU >
    0.5).  Returns (loss, {"loss/box", "loss/obj", "loss/cls"}).  Every
    denominator is per image and the batch enters as a mean, so inside a
    process group of equal slices the mean over ranks of the local loss
    is the global batch's: no collective is needed."""
    targets = targets.float()
    gt_xyxy = torch.stack([
        targets[..., 1] - targets[..., 3] / 2,
        targets[..., 2] - targets[..., 4] / 2,
        targets[..., 1] + targets[..., 3] / 2,
        targets[..., 2] + targets[..., 4] / 2,
    ], dim=-1)                                                # [B,T,4]
    gt_cls = targets[..., 0].to(torch.int64)
    gmask = target_mask.float()

    # RPN
    anchors = torch.cat(aux["anchors"], dim=0)                # [A,4]
    rpn = torch.cat(aux["rpn_raw"], dim=1)            # [B,A,5]
    iou = _pair_iou(anchors, gt_xyxy, gmask)                  # [B,A,T]
    best_iou = iou.max(dim=2).values
    best_gt = torch.argmax(iou, dim=2)
    # per-gt argmax anchors are positive too (low-IoU small objects)
    gt_best_anchor = torch.argmax(iou, dim=1)                 # [B,T]
    force_pos = torch.zeros(best_iou.shape, dtype=torch.int64,
                            device=iou.device).scatter_add_(
        1, gt_best_anchor, (gmask > 0).to(torch.int64)) > 0
    pos = (best_iou > rpn_pos_iou) | force_pos
    neg = (best_iou < rpn_neg_iou) & ~pos
    obj_w = (pos | neg).float()
    rpn_obj = (bce(rpn[..., 0], pos.float()) * obj_w).sum(1) / torch.clamp(
        obj_w.sum(1), min=1.0)
    tgt = boxes_to_deltas(anchors[None], _take_gt(gt_xyxy, best_gt))
    rpn_box = (_smooth_l1(rpn[..., 1:] - tgt).sum(-1) * pos).sum(1) / \
        torch.clamp(pos.sum(1).float(), min=1.0)

    # ROI head
    props = aux["proposals"]                                  # [B,P,4]
    pvalid = aux["prop_valid"]
    iou = _pair_iou(props, gt_xyxy, gmask)                    # [B,P,T]
    best_iou = iou.max(dim=2).values
    best_gt = torch.argmax(iou, dim=2)
    pos = (best_iou > roi_pos_iou) & pvalid
    label = torch.where(pos, torch.gather(gt_cls, 1, best_gt) + 1,
                        torch.zeros_like(best_gt))
    logp = torch.log_softmax(aux["roi_cls"], dim=-1)
    ce = -torch.gather(logp, 2, label[..., None])[..., 0]
    vw = pvalid.float()
    roi_cls_l = (ce * vw).sum(1) / torch.clamp(vw.sum(1), min=1.0)
    tgt = boxes_to_deltas(props, _take_gt(gt_xyxy, best_gt))  # [B,P,4]
    d = aux["roi_deltas"].reshape(*props.shape[:2], num_classes, 4)
    d_sel = torch.gather(d, 2, torch.clamp(label - 1, min=0)[
        ..., None, None].expand(*label.shape, 1, 4))[..., 0, :]
    roi_box_l = (_smooth_l1(d_sel - tgt).sum(-1) * pos).sum(1) / \
        torch.clamp(pos.sum(1).float(), min=1.0)

    rpn_l = rpn_gain * (rpn_obj.mean() + box_gain * rpn_box.mean())
    roi_l = roi_gain * (roi_cls_l.mean() + box_gain * roi_box_l.mean())
    loss = rpn_l + roi_l
    metrics = {
        "loss/box": box_gain * (rpn_box.mean() + roi_box_l.mean()),
        "loss/obj": rpn_obj.mean(),
        "loss/cls": roi_cls_l.mean(),
    }
    return loss, metrics


def rcnn_s(**kw):
    return FasterRCNN(depth_multiple=0.33, width_multiple=0.50, **kw)


def rcnn_n(**kw):
    return FasterRCNN(depth_multiple=0.33, width_multiple=0.25, **kw)
