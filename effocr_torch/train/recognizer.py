"""Recognizer training (the JAX package's train/recognizer.py): SupCon
metric learning (kNN mode, optionally with the auxiliary cosine-classifier
head) or cross-entropy (classifier mode), on one device or data-parallel
over the ranks of a process group (core/distributed.py).

One step: augmentation (data/transforms.py ``apply_augment`` on draws
from the epoch's generator) -> forward in train mode (BatchNorm on batch
statistics) -> loss -> backward -> AdamW (train/optim.py).  The encoder
computes in its ``dtype`` (bfloat16 by default) over float32 parameters;
autograd carries the gradient through the casts to the float32 master
copy.  Losses and retrieval are float32 with TF32 off.

``adjacent_font_path`` renders the AddAdjacentChars neighbour-glyph
bank (data/fonts.py) at the encoder's size on every rank, on its device;
the step composites it first (data/transforms.py ``_compose_adjacent``).

``data_device resident`` keeps the whole dataset on the device as a gray
uint8 bank [N, S, S] and gathers each batch there from int64 indices;
``stream`` decodes batches on the host and uploads them.

Per-epoch streams: epoch e samples with seed ``cfg.seed + e`` (numpy, as
the JAX trainer) and draws its augmentation from a ``torch.Generator``
seeded from (cfg.seed, e), so a run resumed after epoch e replays the
epochs an uninterrupted run would.

Data parallel (the JAX trainer's ``mesh=`` path): the model runs in
``DistributedDataParallel``; every rank draws the same global sampler
batch and the same augmentation draws and keeps its contiguous slice
(bank mode: each rank's bank on its own device, gathered with its slice
of the indices); SupCon is taken over the all-gathered batch and the
BatchNorm statistics over the global batch, so the step is the one-rank
step on the whole batch.  Evaluation, ``build_ref_index`` and
``infer_hardneg`` run on every rank and give the one-rank result; only
the primary rank writes files, the others wait at a barrier.

Artifacts: ``enc_best.msgpack`` (Flax layout, readable by the JAX
package), ``ref.npz``/``ref.txt``, ``hns.txt``, ``metrics.jsonl``, and
``last.msgpack`` + ``last_meta.json`` (the JAX package's train-state
layout, train/checkpoint.py: either package resumes the other's run).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from effocr_torch.core import distributed
from effocr_torch.core.config import RecognizerTrainConfig
from effocr_torch.core.device import resolve_device, upload, use_full_f32
from effocr_torch.data.folder import CharFolderDataset, embed_items
from effocr_torch.data.samplers import (
    HardNegativeClassSampler,
    NoReplacementMPerClassSampler,
    batch_iterator,
)
from effocr_torch.data.transforms import apply_augment, draw_augment
from effocr_torch.interop.flax_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from effocr_torch.kernels.image_ops import normalize_imagenet
from effocr_torch.kernels.retrieval import knn_topk, l2_normalize
from effocr_torch.models.factory import init_params
from effocr_torch.retrieval.index import PrototypeIndex
from effocr_torch.train import checkpoint as ckpt
from effocr_torch.train.losses import (
    cosine_classifier_loss,
    cross_entropy_loss,
    supcon_loss,
)
from effocr_torch.train.metrics import MetricsWriter
from effocr_torch.train.optim import (
    AdamW,
    scaled,
    warmup_cosine_decay_schedule,
)


def epoch_seed(seed: int, epoch: int) -> int:
    """Seed of epoch ``epoch``'s augmentation generator."""
    return (seed * 1_000_003 + epoch + 1) % (1 << 62)


def make_train_step(model: torch.nn.Module, cfg: RecognizerTrainConfig,
                    optimizer, classifier_mode: bool,
                    aux: Optional[torch.Tensor] = None,
                    bank_mode: bool = False,
                    adjacent_bank: Optional[torch.Tensor] = None
                    ) -> Callable:
    """The step: augment -> forward -> loss -> backward ->
    ``optimizer.step()``; returns the loss (a device scalar).

    ``aux``: the cosine-classifier proxies [C, D] (a leaf tensor the
    optimizer also steps), weighted by ``cfg.aux_ce_weight``; inside a
    process group its gradient is averaged over ranks (``model`` is then
    the DistributedDataParallel module, which averages its own), and
    every input is this rank's slice of the global batch.
    Stream mode: step(images_u8 [B,S,S,3], targets [B], is_paired [B],
    draws).  Bank mode: step(bank [N,S,S] uint8, bank_targets [N],
    bank_paired [N], idx [B], draws), gathered on the bank's device."""
    channels = cfg.encoder.input_channels

    def prepare(images_u8, is_paired, draws):
        if images_u8.dim() == 3:          # gray bank rows -> RGB
            images_u8 = images_u8[..., None].expand(-1, -1, -1, 3)
        return apply_augment(
            images_u8, is_paired, draws, lang=cfg.lang,
            high_blur=cfg.high_blur, no_aug=cfg.no_aug,
            crop_sim=cfg.crop_sim, paired_jitter=cfg.paired_jitter,
            out_channels=channels, adjacent_bank=adjacent_bank)

    def body(x, targets):
        model.train()
        optimizer.zero_grad()
        out = model(x)
        if classifier_mode:
            loss = cross_entropy_loss(out, targets)
        else:
            loss = supcon_loss(out, targets, cfg.temperature)
            if aux is not None:
                loss = loss + cfg.aux_ce_weight * cosine_classifier_loss(
                    out, aux, targets, cfg.aux_ce_temp)
        loss.backward()
        if aux is not None:
            distributed.average_gradients([aux])
        optimizer.step()
        return loss.detach()

    def step(images_u8, targets, is_paired, draws):
        return body(prepare(images_u8, is_paired, draws), targets)

    def step_bank(bank, bank_targets, bank_paired, idx, draws):
        return body(prepare(bank[idx], bank_paired[idx], draws),
                    bank_targets[idx])

    return step_bank if bank_mode else step


class RecognizerTrainer:
    def __init__(self, cfg: RecognizerTrainConfig, model: torch.nn.Module,
                 run_dir: str, classifier_mode: bool = False,
                 device="cuda", use_wandb: bool = False):
        self.device = distributed.rank_device(resolve_device(device))
        use_full_f32()
        self.cfg = cfg
        self.model = model.to(self.device)
        self._net = None            # the model, in DDP inside a group
        self.run_dir = run_dir
        self.classifier_mode = classifier_mode
        os.makedirs(run_dir, exist_ok=True)
        self.metrics = MetricsWriter(run_dir, use_wandb=use_wandb)
        self.use_aux = (not classifier_mode) and cfg.aux_ce_weight > 0
        self.aux: Optional[torch.Tensor] = None
        self.optimizer: Optional[AdamW] = None
        self._step_fn = None
        self.bank = None            # device-resident gray dataset
        self._bank_targets = None
        self._bank_paired = None
        self.initialized = False
        self.best_acc = -1.0
        # the AddAdjacentChars glyph bank, rendered on every rank and kept
        # on this rank's device
        self.adjacent_bank: Optional[torch.Tensor] = None
        if cfg.adjacent_font_path:
            from effocr_torch.data.fonts import render_adjacent_bank

            self.adjacent_bank = torch.from_numpy(render_adjacent_bank(
                cfg.adjacent_font_path, cfg.encoder.image_size,
                cfg.lang)).to(self.device)

    # ----------------------------------------------------------------- init
    def init_state(self, seed: int) -> None:
        """Seeded random init of the model (factory.init_params)."""
        init_params(self.model, seed)
        self.initialized = True

    @property
    def variables(self) -> Dict:
        """The model's Flax variables tree ({"params", "batch_stats"})."""
        return state_dict_to_flax(self.model.state_dict())

    def set_variables(self, variables: Dict) -> None:
        self.model.load_state_dict(flax_to_state_dict(variables),
                                   strict=True)
        self.initialized = True

    # ------------------------------------------------------------- schedule
    def _build_optimizer(self, total_steps: int) -> None:
        """AdamW over the model (and aux head) with a fresh state, and the
        step function, once the step count is known."""
        cfg = self.cfg
        if cfg.lr_schedule == "cosine":
            warmup = max(int(cfg.warmup_frac * total_steps), 0)
            lr = warmup_cosine_decay_schedule(
                0.0 if warmup else cfg.lr, cfg.lr, warmup,
                max(total_steps, 1), cfg.lr * cfg.min_lr_frac)
        else:
            lr = cfg.lr
        groups = [(list(self.model.parameters()), lr)]
        if self.use_aux:
            groups.append(([self.aux], scaled(lr, cfg.aux_lr_mult)))
        self.optimizer = AdamW(groups, b2=cfg.adam_b2,
                               weight_decay=cfg.weight_decay)
        if self._net is None:
            self._net = distributed.wrap_ddp(self.model, self.device)
        self._step_fn = make_train_step(
            self._net, cfg, self.optimizer, self.classifier_mode,
            aux=self.aux if self.use_aux else None,
            bank_mode=self.bank is not None,
            adjacent_bank=self.adjacent_bank)

    def _aux_random(self, n_classes: int, d: int) -> np.ndarray:
        g = torch.Generator().manual_seed(self.cfg.seed)
        return (torch.randn((n_classes, d), generator=g) * 0.02).numpy()

    def _init_aux(self, n_classes: int,
                  dataset: Optional[CharFolderDataset] = None,
                  seed_idx: Optional[Sequence[int]] = None) -> None:
        """Cosine-classifier proxies [C, D]: N(0, 0.02^2), and with
        aux_init "embed" the rows of the seeded classes replaced by the
        normalised embedding of one item each (seed_idx, by target)."""
        w = self._aux_random(n_classes, self.model.out_features)
        if (self.cfg.aux_init == "embed" and dataset is not None
                and seed_idx is not None):
            embs, labs = self.embed_indices(dataset, list(seed_idx))
            embs = embs / np.maximum(
                np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
            w[np.asarray(labs)] = embs
        self.aux = torch.tensor(w, dtype=torch.float32, device=self.device,
                                requires_grad=True)

    # ---------------------------------------------------------------- embed
    def attach_bank(self, dataset: CharFolderDataset) -> None:
        """Upload the dataset to the device once as a gray uint8 bank;
        training and eval then gather there from indices."""
        if self.bank is not None:
            return
        bank = dataset.decode_all_gray(self.cfg.encoder.image_size)
        self.bank = torch.from_numpy(bank).to(self.device)
        self._bank_targets = torch.tensor(dataset.targets, dtype=torch.long,
                                          device=self.device)
        self._bank_paired = torch.tensor(
            [dataset.is_paired(i) for i in range(len(dataset.data))],
            dtype=torch.bool, device=self.device)

    @torch.no_grad()
    def embed_indices(self, dataset: CharFolderDataset,
                      indices: Sequence[int], batch_size: int = 128
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Embeddings (float32) + labels of dataset items, plain transform,
        eval mode, in zero-padded batches of ``batch_size``: gathered from
        the bank when there is one, else ``folder.embed_items``."""
        ch = self.cfg.encoder.input_channels
        labels = np.asarray([dataset.targets[i] for i in indices], np.int32)
        if self.bank is None:
            return embed_items(self.model, dataset, indices,
                               self.cfg.encoder.image_size, ch, self.device,
                               batch_size), labels
        self.model.eval()
        embs = []
        for s in range(0, len(indices), batch_size):
            chunk = list(indices[s:s + batch_size])
            idx = torch.tensor(chunk + [0] * (batch_size - len(chunk)),
                               device=self.device)
            g = self.bank[idx].float() / 255.0
            x = g[..., None] if ch == 1 else g[..., None].expand(
                -1, -1, -1, 3)
            out = self.model(normalize_imagenet(x)).float().cpu().numpy()
            embs.append(out[:len(chunk)])
        return np.concatenate(embs), labels

    def class_centroids(self, dataset: CharFolderDataset,
                        indices: Sequence[int]
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """L2-normalised per-class mean embeddings over (capped) indices:
        (centroids [C', D], class targets [C'])."""
        cap = self.cfg.centroid_cap
        by_class: Dict[int, List[int]] = {}
        for i in indices:
            by_class.setdefault(dataset.targets[i], []).append(i)
        sel = [i for t in sorted(by_class) for i in by_class[t][:cap]]
        embs, labs = self.embed_indices(dataset, sel)
        embs = embs / np.maximum(
            np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
        targets = np.asarray(sorted(by_class), np.int32)
        pos = {int(t): j for j, t in enumerate(targets)}
        cents = np.zeros((len(targets), embs.shape[1]), np.float32)
        np.add.at(cents, [pos[int(t)] for t in labs], embs)
        cents /= np.maximum(
            np.linalg.norm(cents, axis=1, keepdims=True), 1e-12)
        return cents, targets

    # ----------------------------------------------------------------- eval
    def eval_knn(self, dataset: CharFolderDataset,
                 query_idx: Sequence[int], ref_idx: Sequence[int],
                 ref_emb: Optional[np.ndarray] = None,
                 ref_lab: Optional[np.ndarray] = None) -> float:
        """Precision@1 of query items against reference items (or the
        precomputed ``ref_emb``/``ref_lab``, e.g. class centroids)."""
        if len(query_idx) == 0:
            return 0.0
        if ref_emb is None:
            if len(ref_idx) == 0:
                return 0.0
            ref_emb, ref_lab = self.embed_indices(dataset, ref_idx)
        q_emb, q_lab = self.embed_indices(dataset, query_idx)
        ref = torch.from_numpy(np.asarray(ref_emb, np.float32)).to(
            self.device)
        _, nn_idx = knn_topk(torch.from_numpy(q_emb).to(self.device),
                             l2_normalize(ref), k=1)
        pred = np.asarray(ref_lab)[nn_idx.cpu().numpy()[:, 0]]
        return float((pred == q_lab).mean())

    def eval_classifier(self, dataset: CharFolderDataset,
                        indices: Sequence[int]) -> float:
        logits, labels = self.embed_indices(dataset, indices)
        return float((logits.argmax(-1) == labels).mean())

    # ------------------------------------------------------------------ fit
    def fit(self, dataset: CharFolderDataset, idx_train: Sequence[int],
            idx_val: Sequence[int], render_ref_idx: Sequence[int],
            hardnegs: Optional[Sequence[str]] = None,
            resume: bool = False) -> float:
        """Train ``cfg.num_epochs`` epochs, evaluating every
        ``eval_period_epochs`` and keeping the best checkpoint.  resume:
        restore last.msgpack + last_meta.json and continue from the
        recorded epoch."""
        cfg = self.cfg
        if not self.initialized:
            self.init_state(cfg.seed)
        if cfg.data_device == "resident":
            self.attach_bank(dataset)

        train_labels = [dataset.targets[i] for i in idx_train]

        def make_sampler(epoch):
            if hardnegs:
                return HardNegativeClassSampler(
                    train_labels, dataset.class_to_idx, hardnegs,
                    m=cfg.m_per_class, batch_size=cfg.batch_size,
                    num_passes=cfg.num_passes, seed=cfg.seed + epoch,
                )
            return NoReplacementMPerClassSampler(
                train_labels, m=cfg.m_per_class, batch_size=cfg.batch_size,
                num_passes=cfg.num_passes, seed=cfg.seed + epoch,
            )

        def evaluate():
            if self.classifier_mode:
                return self.eval_classifier(dataset, idx_val)
            if cfg.ref_source == "centroid":
                cents, targets = self.class_centroids(dataset, idx_train)
                return self.eval_knn(dataset, idx_val, [],
                                     ref_emb=cents, ref_lab=targets)
            return self.eval_knn(dataset, idx_val, render_ref_idx)

        steps_per_epoch = sum(
            1 for _ in batch_iterator(iter(make_sampler(0)), cfg.batch_size)
        )
        total_steps = steps_per_epoch * cfg.num_epochs
        if total_steps < 200:
            print(
                f"WARNING: only {total_steps} total optimizer steps "
                f"({steps_per_epoch}/epoch: m={cfg.m_per_class} x "
                f"{len(set(train_labels))} classes, num_passes="
                f"{cfg.num_passes}); from-scratch training needs hundreds "
                f"— raise --num_passes or --num_epochs"
            )
        if self.use_aux:
            first_of_class: Dict[int, int] = {}
            for i in idx_train:          # renders come first (sorted paths)
                first_of_class.setdefault(dataset.targets[i], i)
            self._init_aux(
                len(dataset.class_to_idx), dataset=dataset,
                seed_idx=[first_of_class[t] for t in sorted(first_of_class)],
            )
        self._build_optimizer(total_steps)

        start_epoch, step = 0, 0
        last_path = os.path.join(self.run_dir, "last.msgpack")
        meta_path = os.path.join(self.run_dir, "last_meta.json")
        if resume:
            if os.path.exists(last_path) and os.path.exists(meta_path):
                self._load_last(last_path)
                with open(meta_path) as f:
                    meta = json.load(f)
                start_epoch = int(meta["epoch"])
                step = int(meta["step"])
                self.best_acc = float(meta["best_acc"])
                self.metrics.log({"resumed_epoch": start_epoch}, step=step)
            elif os.path.exists(ckpt.best_checkpoint_path(self.run_dir)):
                raise FileNotFoundError(
                    f"--resume: no {last_path} / {meta_path}, but "
                    f"{self.run_dir} already holds a best checkpoint — "
                    "refusing to restart from scratch over it (point at "
                    "the right run_dir, or remove enc_best.msgpack to "
                    "really start over)"
                )
            else:
                print(f"--resume: nothing to restore in {self.run_dir}; "
                      "starting fresh")

        if start_epoch == 0:
            self.best_acc = evaluate()
            self.metrics.log({"val/accuracy": self.best_acc}, step=0)
            self._save_best()

        size = cfg.encoder.image_size
        cuda = self.device.type == "cuda"
        distributed.rank_slice(cfg.batch_size)   # the batch must divide
        for epoch in range(start_epoch, cfg.num_epochs):
            sampler = make_sampler(epoch)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(epoch_seed(cfg.seed, epoch))
            t0, n_steps = time.perf_counter(), 0
            for batch_local in batch_iterator(iter(sampler), cfg.batch_size):
                global_idx = [idx_train[i] for i in batch_local]
                draws = None if cfg.no_aug else draw_augment(
                    gen, len(global_idx), size, lang=cfg.lang,
                    high_blur=cfg.high_blur, crop_sim=cfg.crop_sim,
                    paired_jitter=cfg.paired_jitter,
                    adjacent=None if self.adjacent_bank is None
                    else tuple(self.adjacent_bank.shape[:2]))
                # this rank's rows of the global batch and of its draws
                global_idx = distributed.local_rows(global_idx)
                draws = distributed.local_rows(draws)
                if self.bank is not None:
                    idx = upload(torch.tensor(global_idx), self.device)
                    loss = self._step_fn(self.bank, self._bank_targets,
                                         self._bank_paired, idx, draws)
                else:
                    imgs, targets, paired = dataset.load_batch(global_idx,
                                                               size)
                    loss = self._step_fn(
                        upload(torch.from_numpy(imgs), self.device),
                        upload(torch.from_numpy(targets).long(),
                               self.device),
                        upload(torch.from_numpy(paired), self.device), draws)
                if step % 50 == 0:
                    self.metrics.log({"train/loss": float(
                        distributed.mean_over_ranks(loss))}, step=step)
                step += 1
                n_steps += 1
            if cuda:
                torch.cuda.synchronize(self.device)
            seconds = time.perf_counter() - t0
            self.metrics.log({"epoch/steps": n_steps,
                              "epoch/images": n_steps * cfg.batch_size,
                              "epoch/seconds": seconds}, step=step)
            if (epoch + 1) % max(cfg.eval_period_epochs, 1) == 0 or (
                epoch == cfg.num_epochs - 1
            ):
                acc = evaluate()
                self.metrics.log({"val/accuracy": acc}, step=step)
                if acc >= self.best_acc:
                    self.best_acc = acc
                    self._save_best()
            self._save_last(epoch, step, last_path, meta_path)
        if cuda:
            peak = torch.cuda.max_memory_allocated(self.device) / 2**30
            self.metrics.log({"device/peak_gib": peak}, step=step)
        if distributed.world_size() > 1:
            distributed.check_in_sync({**self.model.state_dict(), **(
                {"aux": self.aux} if self.aux is not None else {})})
        return self.best_acc

    def _state_layout(self) -> Dict:
        """The optax layout of this run's optimizer (checkpoint.py): the
        aux head at its own rate is a multi_transform."""
        return dict(aux=self.aux if self.use_aux else None,
                    multi=self.use_aux and self.cfg.aux_lr_mult != 1.0)

    def _save_last(self, epoch_done: int, step: int, last_path: str,
                   meta_path: str) -> None:
        """last.msgpack (the JAX package's train-state layout) and
        last_meta.json, written by the primary rank while the others
        wait."""
        ckpt.save_train_state(ckpt.train_state(
            self.model, self.optimizer, **self._state_layout()), last_path)
        if distributed.is_primary():
            with open(meta_path + ".tmp", "w") as f:
                json.dump({"epoch": epoch_done + 1, "step": step,
                           "best_acc": float(self.best_acc)}, f)
            os.replace(meta_path + ".tmp", meta_path)
        distributed.barrier()

    def _load_last(self, last_path: str) -> None:
        ckpt.restore_train_state(ckpt.load_train_state(last_path),
                                 self.model, self.optimizer,
                                 **self._state_layout())

    def _save_best(self) -> None:
        ckpt.save_variables(self.variables,
                            ckpt.best_checkpoint_path(self.run_dir))

    def load_best(self) -> None:
        self.set_variables(ckpt.load_variables(
            ckpt.best_checkpoint_path(self.run_dir)))

    # ------------------------------------------------------------ artifacts
    def build_ref_index(self, dataset: CharFolderDataset,
                        render_idx: Sequence[int],
                        thumbnail_size: int = 64,
                        centroid_idx: Optional[Sequence[int]] = None,
                        ) -> PrototypeIndex:
        """Embed the prototype set into ref.npz/ref.txt, with a gray
        thumbnail of each prototype.  ref_source "centroid": one row per
        class, the normalised mean embedding over centroid_idx (default
        the render set), thumbnail = the class's first render."""
        if self.cfg.ref_source == "centroid":
            src = centroid_idx if centroid_idx is not None else render_idx
            embs, targets = self.class_centroids(dataset, src)
            chars = [dataset.char_for_target(int(t)) for t in targets]
            first_render = {}
            for i in render_idx:
                first_render.setdefault(dataset.targets[i], i)
            thumbs = np.stack([
                dataset.load_square(
                    first_render.get(int(t), src[0]), thumbnail_size
                ).mean(-1).astype(np.uint8)
                for t in targets
            ]) if len(targets) else None
        else:
            embs, _ = self.embed_indices(dataset, render_idx)
            chars = [
                dataset.char_for_path(dataset.data[i][0]) for i in render_idx
            ]
            thumbs = np.stack([
                dataset.load_square(i, thumbnail_size).mean(-1)
                .astype(np.uint8)
                for i in render_idx
            ]) if render_idx else None
        index = PrototypeIndex(embs, chars, thumbnails=thumbs)
        if distributed.is_primary():
            index.save(self.run_dir)
        distributed.barrier()
        return index

    def infer_hardneg(self, dataset: CharFolderDataset,
                      query_idx: Sequence[int], index: PrototypeIndex,
                      k: int = 8) -> List[str]:
        """k-NN hard-negative strings, written to hns.txt."""
        q_emb, _ = self.embed_indices(dataset, query_idx)
        lines = index.decode(q_emb, k=k, device=self.device)
        if distributed.is_primary():
            with open(os.path.join(self.run_dir, "hns.txt"), "w") as f:
                f.write("\n".join(lines))
        distributed.barrier()
        return lines
