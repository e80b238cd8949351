"""Localizer (detector) training (the JAX package's train/localizer.py),
every detector family, on one device or data-parallel over the ranks of
a process group (core/distributed.py).

One step: uint8 canvases / 255 on the device -> (with ``cfg.augment``)
kernels/det_augment.py ``apply_detection_augment`` on draws from a
device generator seeded from (cfg.seed + 101, aug_step) -> forward in
train mode (BatchNorm on batch statistics; convolutions in the model's
dtype, the heads float32) -> the family's loss (``yolo_loss`` with
anchors, ``rcnn_loss`` for a two-stage model, else ``fcos_loss``) ->
backward -> ``clip_by_global_norm(10)`` + AdamW (train/optim.py) on one
warmup + cosine schedule.  The step returns device tensors: the host
syncs only where a caller reads them (a log line).

``attach_bank`` keeps a dataset on the device as a uint8 bank with its
targets and masks, one bank per dataset; ``train_step_bank`` gathers a
batch there from indices.

``evaluate`` decodes at conf 0.001 and IoU 0.45 (a low-confidence sweep
for COCO mAP, eval/coco_map.py); on a CUDA device its NMS keep masks come
from the CUDA kernel (kernels/cuda_nms.py), as do the R-CNN's RPN keep
masks in every step.  The best checkpoint on
bbox/AP (``>=``) goes to ``best_bbox_mAP.msgpack`` in the Flax layout,
which both packages' ``load_engine`` read; ``save``/``resume`` write and
read ``last.msgpack`` in the JAX package's train-state layout
(train/checkpoint.py: either package resumes the other's run).

Data parallel (the JAX trainer's ``mesh=`` path): the model runs in
``DistributedDataParallel``; ``train_step`` / ``train_step_bank`` take
the global batch (or its indices), every rank draws the augmentation of
the whole batch and keeps its contiguous slice, BatchNorm statistics and
the losses' denominators are global (models/layers.py, train/losses.py,
models/fcos.py), and the clip + AdamW run on the averaged gradients.
``evaluate`` runs on every rank and gives the one-rank AP; only the
primary rank writes files.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from effocr_torch.core import distributed
from effocr_torch.core.config import LocalizerTrainConfig
from effocr_torch.core.device import resolve_device, upload, use_full_f32
from effocr_torch.eval.coco_map import coco_map
from effocr_torch.interop.flax_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from effocr_torch.kernels.det_augment import (
    apply_detection_augment,
    draw_detection_augment,
)
from effocr_torch.kernels.yolo_decode import decode_and_nms
from effocr_torch.models.factory import init_params
from effocr_torch.models.fcos import fcos_loss
from effocr_torch.models.rcnn import rcnn_loss
from effocr_torch.train import checkpoint as ckpt
from effocr_torch.train.losses import yolo_loss
from effocr_torch.train.metrics import MetricsWriter
from effocr_torch.train.optim import AdamW, warmup_cosine_decay_schedule

def fit_anchors(boxes_wh: np.ndarray, n: int = 9, iters: int = 50,
                seed: int = 0) -> np.ndarray:
    """k-means anchor fitting over training box (w, h) pairs, 1 - IoU(wh,
    anchor) as the distance (YOLO autoanchor).  Returns [n, 2] anchors
    sorted by area (3 scale groups of 3 for the detect head)."""
    rng = np.random.default_rng(seed)
    boxes = np.asarray(boxes_wh, np.float64).reshape(-1, 2)
    boxes = boxes[(boxes > 1).all(axis=1)]
    anchors = boxes[rng.choice(len(boxes), size=n, replace=len(boxes) < n)]

    def iou_wh(a, b):
        inter = np.minimum(a[:, None, 0], b[None, :, 0]) * np.minimum(
            a[:, None, 1], b[None, :, 1]
        )
        union = (a[:, 0] * a[:, 1])[:, None] + (b[:, 0] * b[:, 1])[None, :]
        return inter / (union - inter + 1e-9)

    for _ in range(iters):
        assign = np.argmax(iou_wh(boxes, anchors), axis=1)
        for k in range(n):
            sel = boxes[assign == k]
            if len(sel):
                anchors[k] = np.median(sel, axis=0)
    order = np.argsort(anchors[:, 0] * anchors[:, 1])
    return anchors[order].astype(np.float32)


def aug_seed(seed: int, aug_step: int) -> int:
    """Seed of step ``aug_step``'s augmentation generator (the JAX
    trainer folds aug_step into PRNGKey(seed + 101))."""
    return ((seed + 101) * 1_000_003 + aug_step) % (1 << 62)


def make_detector_train_step(model: torch.nn.Module,
                             cfg: LocalizerTrainConfig, optimizer,
                             anchors, bank_mode: bool = False):
    """The step: (augment) -> forward -> loss -> backward ->
    ``optimizer.step()``; returns (loss, parts) as device tensors.  The
    loss by family, as in the JAX package: ``anchors`` given -> yolo_loss;
    a model with ``num_proposals`` (two-stage) -> rcnn_loss; otherwise
    fcos_loss.

    Stream mode: step(images [B,H,W,C] uint8 or float in [0, 1], targets
    [B,T,5], mask [B,T], draws).  Bank mode: step(bank_imgs, bank_targets,
    bank_masks, idx [B], draws), gathered on the bank's device.  ``draws``
    (draw_detection_augment) is used only with ``cfg.augment``."""
    # (the family is the wrapped module's when ``model`` is in DDP)
    two_stage = anchors is None and hasattr(
        getattr(model, "module", model), "num_proposals")
    nc = cfg.localizer.num_classes

    def loss_of(raw, targets, target_mask):
        if two_stage:
            return rcnn_loss(raw, targets, target_mask, num_classes=nc)
        if anchors is None:
            return fcos_loss(raw, targets, target_mask, num_classes=nc)
        return yolo_loss(raw, targets, target_mask, anchors, num_classes=nc,
                         box_gain=cfg.box_gain, obj_gain=cfg.obj_gain,
                         cls_gain=cfg.cls_gain,
                         anchor_t=cfg.anchor_match_thresh)

    def step(images, targets, target_mask, draws=None):
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
        if cfg.augment:
            images, targets, target_mask = apply_detection_augment(
                images, targets, target_mask, draws)
        model.train()
        optimizer.zero_grad()
        loss, parts = loss_of(model(images, decode=False), targets,
                              target_mask)
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() if torch.is_tensor(v) else v
                               for k, v in parts.items()}

    def step_bank(bank_imgs, bank_targets, bank_masks, idx, draws=None):
        return step(bank_imgs[idx], bank_targets[idx], bank_masks[idx],
                    draws)

    return step_bank if bank_mode else step


class LocalizerTrainer:
    def __init__(self, cfg: LocalizerTrainConfig, model: torch.nn.Module,
                 run_dir: str, total_steps: int, device="cuda",
                 use_wandb: bool = False):
        self.device = distributed.rank_device(resolve_device(device))
        use_full_f32()
        self.cfg = cfg
        self.anchors = getattr(model, "anchors", None)
        self.model = model.to(self.device)
        net = distributed.wrap_ddp(self.model, self.device)
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.metrics = MetricsWriter(run_dir, use_wandb=use_wandb)
        schedule = warmup_cosine_decay_schedule(
            0.0, cfg.lr, cfg.warmup_steps,
            max(total_steps, cfg.warmup_steps + 1))
        self.optimizer = AdamW([(list(self.model.parameters()), schedule)],
                               weight_decay=cfg.weight_decay,
                               max_grad_norm=10.0)
        self._step_fn = make_detector_train_step(
            net, cfg, self.optimizer, self.anchors)
        self._step_bank_fn = make_detector_train_step(
            net, cfg, self.optimizer, self.anchors, bank_mode=True)
        self._banks: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self.nms_kernel = "cuda" if self.device.type == "cuda" else "plain"
        self.best_ap = -1.0
        self._aug_step = 0

    # ----------------------------------------------------------------- init
    def init_state(self, seed: int) -> None:
        """Seeded random init of the model (factory.init_params)."""
        init_params(self.model, seed)

    @property
    def variables(self) -> Dict:
        """The model's Flax variables tree ({"params", "batch_stats"})."""
        return state_dict_to_flax(self.model.state_dict())

    def set_variables(self, variables: Dict) -> None:
        self.model.load_state_dict(flax_to_state_dict(variables),
                                   strict=True)

    # ----------------------------------------------------------------- step
    def _draws(self, b: int, h: int, w: int, c: int):
        """This rank's rows of the draws of a global batch of ``b``."""
        if not self.cfg.augment:
            return None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(aug_seed(self.cfg.seed, self._aug_step))
        self._aug_step += 1
        return distributed.local_rows(draw_detection_augment(
            gen, b, h, w, c, flip_p=self.cfg.aug_flip_p,
            scale=self.cfg.aug_scale, translate=self.cfg.aug_translate))

    def _upload(self, a) -> torch.Tensor:
        return upload(torch.as_tensor(a), self.device)

    def train_step(self, images, targets, target_mask):
        """One step on a host batch (the global batch: this rank's slice
        goes up); (loss, parts) stay on the device."""
        b, h, w, c = images.shape
        draws = self._draws(b, h, w, c)
        images, targets, target_mask = (
            self._upload(distributed.local_rows(a))
            for a in (images, targets, target_mask))
        return self._step_fn(images, targets, target_mask, draws)

    # ------------------------------------------------------ resident bank
    def attach_bank(self, dataset) -> Tuple[torch.Tensor, ...]:
        """The dataset's canvases, targets and masks on the device, made
        once per dataset (multi-height training rotates several)."""
        key = id(dataset)
        if key not in self._banks:
            self._banks[key] = tuple(
                torch.from_numpy(a).to(self.device)
                for a in dataset.materialize())
        return self._banks[key]

    def train_step_bank(self, dataset, indices):
        bi, bt, bm = self.attach_bank(dataset)
        _, h, w, c = bi.shape
        draws = self._draws(len(indices), h, w, c)
        idx = self._upload(distributed.local_rows(
            np.asarray(indices, np.int64)))
        return self._step_bank_fn(bi, bt, bm, idx, draws)

    # ----------------------------------------------------------------- eval
    @torch.no_grad()
    def infer(self, images) -> Tuple[np.ndarray, ...]:
        """(boxes, scores, classes, valid) of a batch of canvases, decoded
        at conf 0.001 / IoU 0.45 over max_nms, max_det from the config."""
        x = self._upload(images)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        self.model.eval()
        loc = self.cfg.localizer
        out = decode_and_nms(self.model(x)[0], conf_thresh=0.001,
                             iou_thresh=0.45, max_nms=loc.max_nms,
                             max_det=loc.max_det,
                             nms_kernel=self.nms_kernel)
        return tuple(t.cpu().numpy() for t in out)

    def predict(self, batches: Iterable[Tuple[np.ndarray, List[Dict]]]
                ) -> Tuple[List[Dict], List[Dict]]:
        """(predictions, ground truths), one dict each per real image."""
        preds, gts = [], []
        for images, gt_list in batches:
            boxes, scores, classes, valid = self.infer(images)
            for i in range(len(gt_list)):
                v = valid[i]
                preds.append({"boxes": boxes[i][v], "scores": scores[i][v],
                              "classes": classes[i][v]})
                gts.append(gt_list[i])
        return preds, gts

    def evaluate(self, batches: Iterable[Tuple[np.ndarray, List[Dict]]]
                 ) -> Dict[str, float]:
        """COCO bbox AP over (images, gt list) batches; keeps the best
        checkpoint (AP >= the best so far)."""
        preds, gts = self.predict(batches)
        result = coco_map(preds, gts,
                          num_classes=self.cfg.localizer.num_classes)
        self.metrics.log(result)
        if result["bbox/AP"] >= self.best_ap:
            self.best_ap = result["bbox/AP"]
            ckpt.save_variables(
                self.variables,
                ckpt.best_checkpoint_path(self.run_dir, "best_bbox_mAP"))
        return result

    # ------------------------------------------------------------ state
    def save(self, name: str = "last") -> None:
        """``<run_dir>/<name>.msgpack`` in the JAX package's train-state
        layout (its ``chain(clip_by_global_norm, adamw)``)."""
        ckpt.save_train_state(
            ckpt.train_state(self.model, self.optimizer, clip=True),
            os.path.join(self.run_dir, f"{name}.msgpack"))

    def resume(self, name: str = "last") -> bool:
        """Restore ``<run_dir>/<name>.msgpack`` (either package's, or this
        package's earlier layout); False when there is none."""
        path = os.path.join(self.run_dir, f"{name}.msgpack")
        if not os.path.exists(path):
            return False
        ckpt.restore_train_state(ckpt.load_train_state(path), self.model,
                                 self.optimizer, clip=True)
        return True
