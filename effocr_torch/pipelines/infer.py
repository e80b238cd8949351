"""End-to-end OCR inference on text lines: lines -> boxes -> crops ->
embeddings -> text.  The PyTorch twin of the JAX package's
pipelines/infer.py ``EffOCRInference``.

Fused letterbox path (``crop_source letterbox``), per chunk of
``line_batch`` lines:

  host (prefetch worker):  native PNG decode + gray letterbox + sub-byte
                           pack straight into the canvas buffer
                           (native/preproc.cpp), one upload; or, under
                           ``transfer bucket``, raw-size lines in a small
                           padded bucket that the device letterboxes
  device (one stream):     unpack -> detector -> decode + greedy NMS (CUDA
                           kernel) -> per-line reading-order sort ->
                           crop-slot compaction -> ROI crops -> encoder
                           (run per ``encoder_sub_batch``) -> retrieval
                           (matmul + argmax, or the fused top-1 CUDA
                           kernel; argmax of the logits in classifier
                           mode) -> ONE packed result buffer, copied
                           back async
  host (consumer):         word boundaries + postprocess per line (jp:
                           the joined chars), optional spell check

Horizontal lines read left to right, vertical ones (``vertical``) top to
bottom.  Wide-line tiling splits extreme-aspect lines into tiles that
ride the fused path as ordinary lines and merges their decodes.

Data parallel (``devices=[...]``, the JAX engine's ``mesh=``): each
device holds a replica (its own copy of the weights) that runs the fused
chunk program on its ``line_batch / n`` lines with a crop cap of
``crop_batch // n``; the result is one packed segment per replica, read
segment by segment, and the lines a segment could not hold are
dispatched again.  No collectives.  The host issues the replicas one
after another without waiting, so replicas on distinct cards run
concurrently; replicas sharing a card run one after the other.

``crop_source original`` runs two programs per chunk instead: detect
(detector + decode + NMS) on the letterboxed canvas, then host glue cuts
each glyph's crop from the original image (the reference's crop
semantics) and ships the crops, padded to squares, for the paired
transform, the encoder and the retrieval on the device.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from effocr_torch import native
from effocr_torch.core.config import PipelineConfig
from effocr_torch.core.device import resolve_device, use_full_f32
from effocr_torch.data.coco import (
    COCO_JSON_SKELETON,
    create_coco_anno_entry,
    create_coco_image_entry,
)
from effocr_torch.data import png
from effocr_torch.data.png import png_header as _png_header
from effocr_torch.kernels import cuda_top1
from effocr_torch.kernels.image_ops import (
    dither_offsets,
    letterbox_device,
    letterbox_params,
    paired_transform_squares,
    quantize_2bit,
)
from effocr_torch.kernels.retrieval import knn_topk, l2_normalize
from effocr_torch.kernels.roi import crop_lines_to_squares
from effocr_torch.kernels.yolo_decode import decode_and_nms
from effocr_torch.pipelines.lang import (
    batch_word_ends,
    en_postprocess,
    en_preprocess,
    insert_spaces,
    jp_preprocess,
)
from effocr_torch.pipelines.tiling import TileKey, merge_tile_parts, plan_tiles
from effocr_torch.retrieval.index import PrototypeIndex
from effocr_torch.utils.profiling import StageTimer
from effocr_torch.utils.spell_check import default_dicts, visual_spell_checker

logger = logging.getLogger(__name__)

# padding byte for unused batch rows: 114 gray packed at each width
# (4-bit: 114|114 = 0x77; 2-bit: (114>>6) x4 = 0x55)
_PAD_BYTE = {2: 0x55, 4: 0x77, 8: 114}


class _LazyImage:
    """Deferred PNG decode: the shape comes from the IHDR so chunk
    planning never decodes; pixels decode in the prep worker.  8-bit gray
    and RGB non-interlaced PNGs go to the native decoder, every other PNG
    to data/png.py (Pillow's RGB conversion).  The channel rule is the
    JAX package's: a gray pipeline keeps one channel for native files and
    for any 8-bit gray PNG, and three (reduced to gray downstream) for
    the rest.  Other formats raise."""

    __slots__ = ("path", "_shape", "_arr", "_native")

    def __init__(self, path: str, gray: bool):
        self.path = path
        self._arr: Optional[np.ndarray] = None
        hdr = _png_header(path)
        if hdr is None:
            with open(path, "rb") as f:
                raise png.not_png_error(path, f.read(16))
        h, w, color_type, bit_depth, _ = hdr
        self._native = png.is_native(hdr)
        ch = 1 if gray and (self._native or (color_type == 0
                                             and bit_depth == 8)) else 3
        self._shape = (h, w, ch)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self._shape

    def load(self) -> np.ndarray:
        if self._arr is None:
            _materialize_batch([self])
        return self._arr


def _materialize_batch(chunk: List) -> List[np.ndarray]:
    """Decode a chunk's lazy images in one ``png.read`` call (one native
    batch for the files the native decoder takes); repeated paths share
    one _LazyImage and decode once."""
    todo = list({id(im): im for im in chunk
                 if isinstance(im, _LazyImage) and im._arr is None}.values())
    if todo:
        arrs = png.read([im.path for im in todo], [im.shape[2] for im in todo])
        for im, arr in zip(todo, arrs):
            im._arr = arr
    return [im.load() if isinstance(im, _LazyImage) else im for im in chunk]


def build_inference_coco(coco_boxes: Dict) -> Dict:
    """COCO-format prediction output: per-line image entries (with decoded
    text; no ``text`` key for a line that reads None, as the JAX engine
    writes it) and per-char box annotations in original-image
    coordinates."""
    coco = copy.deepcopy(COCO_JSON_SKELETON)
    anno_id = 0
    for image_id, (key, entry) in enumerate(coco_boxes.items()):
        coco["images"].append(create_coco_image_entry(
            os.path.basename(str(key)), entry["height"], entry["width"],
            image_id, text=entry["text"]))
        for cb in entry["chars"]:
            x, y, w, h = cb["bbox"]
            anno = create_coco_anno_entry(x, y, w, h, anno_id, image_id, 0)
            anno["text"] = cb["char"]
            coco["annotations"].append(anno)
            anno_id += 1
    return coco


def _to_host_async(tensors: Sequence[torch.Tensor]):
    """Start copying device tensors back to pinned host memory.  Returns
    (host tensors, event to wait on); CPU tensors come back as they are,
    with no event."""
    if not tensors[0].is_cuda:
        return list(tensors), None
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _copy_to(model, device):
    """A module's own copy on ``device``; any other callable as it is."""
    if isinstance(model, torch.nn.Module):
        return copy.deepcopy(model).to(device)
    return model


class _Replica:
    """One device's copy of the engine's models and prototype arrays."""

    __slots__ = ("device", "localizer", "encoder", "protos", "row_mask")

    def __init__(self, device, localizer, encoder, protos, row_mask):
        self.device = device
        self.localizer = localizer
        self.encoder = encoder
        self.protos = protos
        self.row_mask = row_mask

    def context(self):
        """The replica's device as the current CUDA device (the kernels
        launch on its current stream)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()


# crop_source original: float32 elements of one batch of padded crop
# squares on the device (1 GiB); a batch of large crops is split to fit
_SQUARES_BUDGET = 1 << 28


class EffOCRInference:
    """OCR engine: localizer + encoder + prototype index (or, in classifier
    mode, an encoder with a class head and its ``class_map``).

    ``localizer``: a callable NHWC float images -> (decoded [B, A, 5+nc],
    raw), e.g. models/yolo.py YOLOv5 with its weights.  ``encoder``: NHWC
    crops -> embeddings [N, D], or logits [N, classes] in classifier mode
    (models/factory.py ``Classifier``; pass ``class_map``, class index ->
    char, and no index).  ``device`` defaults to "cuda"; without a GPU
    pass device="cpu" (core/device.py).

    ``devices``: a list of devices to run data-parallel over (the JAX
    engine's ``mesh=``), one replica each, the same device more than once
    included; ``line_batch`` and ``crop_batch`` must divide by their
    number, and only the fused letterbox path shards.  The first is the
    engine's ``device``.
    """

    def __init__(self, config: PipelineConfig, localizer, encoder,
                 index: Optional[PrototypeIndex] = None, device="cuda",
                 class_map: Optional[Dict[int, str]] = None,
                 devices: Optional[Sequence] = None):
        c = config
        n_shards = len(devices) if devices else 1
        if n_shards > 1:
            # the JAX engine's assertions, with its messages
            if c.line_batch % n_shards:
                raise ValueError(
                    f"line_batch {c.line_batch} must divide over the data "
                    f"axis ({n_shards} shards)")
            if c.crop_batch % n_shards:
                raise ValueError(
                    f"crop_batch {c.crop_batch} must divide over the data "
                    f"axis ({n_shards} shards)")
            if c.crop_source != "letterbox":
                raise ValueError(
                    "mesh inference supports the fused letterbox path only")
        if devices:
            device = devices[0]
        if c.crop_source not in ("letterbox", "original"):
            raise ValueError(f"crop_source {c.crop_source!r}")
        if c.transfer not in ("canvas", "bucket"):
            raise ValueError(f"transfer {c.transfer!r}")
        if c.crop_source == "original" and c.input_channels != 3:
            # the JAX package fails here inside run(): median_pad_square's
            # 3-channel white fill and its 3-channel recognize program
            raise ValueError(
                "crop_source 'original' needs 3-channel models, got "
                f"input_channels {c.input_channels} (the JAX package's "
                "paired transform and recognize program take 3-channel "
                "crops only; ROADMAP.md, queue 3)")
        if index is None and class_map is None:
            raise ValueError("pass a PrototypeIndex, or a class_map for "
                             "classifier mode")
        if c.nms_kernel not in ("xla", "pallas", "cuda"):
            raise ValueError(f"nms_kernel {c.nms_kernel!r}")
        if c.retrieval_kernel not in ("xla", "pallas"):
            raise ValueError(f"retrieval_kernel {c.retrieval_kernel!r}")
        if c.retrieval_kernel == "pallas" and c.knn_k != 1:
            raise ValueError(f"retrieval_kernel 'pallas' is the fused top-1 "
                             f"kernel; knn_k {c.knn_k} needs retrieval_kernel "
                             "'xla'")
        if c.transfer_bits not in (2, 4, 8):
            raise ValueError(f"transfer_bits {c.transfer_bits}")
        if c.compute_dtype not in ("f32", "bf16"):
            raise ValueError(f"compute_dtype {c.compute_dtype!r}")
        self.config = config
        self.device = resolve_device(device)
        use_full_f32()
        # the TPU build's "pallas" NMS kernel is the CUDA kernel here
        self._nms_kernel = ("cuda" if c.nms_kernel in ("pallas", "cuda")
                            else "plain")
        # likewise its "pallas" top-1 retrieval kernel (K2)
        self._top1 = c.retrieval_kernel == "pallas"
        self.timer = StageTimer()

        def _prepare(m):
            if isinstance(m, torch.nn.Module):
                m = m.to(self.device).eval().requires_grad_(False)
                if c.compute_dtype == "bf16":
                    # bf16 params (BN stats included), as the JAX engine
                    # casts its variables; decode/NMS/retrieval stay f32
                    m = m.to(torch.bfloat16)
            return m

        self.localizer = _prepare(localizer)
        self.encoder = _prepare(encoder)
        # a shard's crop-slot capacity: the compaction, and so the encoder
        # batch, is per shard
        self._crop_cap = c.crop_batch // n_shards
        self.index = index
        self.class_map = class_map
        self.classifier_mode = class_map is not None
        if self.classifier_mode:
            hi = max(class_map, default=0) + 1
            raw = [class_map.get(i, "") for i in range(hi)]
        else:
            raw = list(index.chars) or [""]
        self._replicas = [_Replica(self.device, self.localizer, self.encoder,
                                   *self._replica_index(self.device))]
        for d in (devices or [])[1:]:
            d = resolve_device(d)
            self._replicas.append(_Replica(
                d, _copy_to(self.localizer, d), _copy_to(self.encoder, d),
                *self._replica_index(d)))
        # entries pre-reduced to their first character for the vectorised
        # decode in the consumer
        self._char_lookup = np.array([ch[0] if ch else "" for ch in raw],
                                     dtype=object)
        if c.out_quant == "u16":
            if len(self._char_lookup) >= (1 << 16):
                raise ValueError(
                    f"out_quant='u16' needs < 65536 prototype rows, got "
                    f"{len(self._char_lookup)}")
            if c.localizer.input_size > 4096:
                raise ValueError(
                    "out_quant='u16' boxes are 1/16-px fixed point: canvas "
                    f"must be <= 4096 px, got {c.localizer.input_size}")
        elif c.out_quant != "i32":
            raise ValueError(f"out_quant {c.out_quant!r}")

    def _replica_index(self, device):
        if self.classifier_mode:
            return None, None
        return self.index.device_arrays(device)

    def _cast_in(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16) if self.config.compute_dtype == "bf16" \
            else x

    def _classify(self, emb: torch.Tensor,
                  rep: Optional[_Replica] = None) -> torch.Tensor:
        """Embeddings [N, D] float32 -> top-1 prototype index [N]: the
        fused top-1 kernel on the L2-normalized embeddings (CUDA tensors;
        its plain version on CPU tensors), else matmul + top-k.  In
        classifier mode ``emb`` holds logits and the index is their
        argmax (the first maximal class).  ``rep``: the replica whose
        prototypes to use (default the first)."""
        rep = rep or self._replicas[0]
        if self.classifier_mode:
            return torch.argmax(emb, dim=1)
        if self._top1:
            _, idx = cuda_top1.top1(l2_normalize(emb), rep.protos,
                                    rep.row_mask)
            return idx
        _, idx = knn_topk(emb, rep.protos, k=self.config.knn_k,
                          row_mask=rep.row_mask)
        return idx[:, 0]

    def _detections(self, imgs: torch.Tensor,
                    rep: Optional[_Replica] = None):
        """Detector + decode + greedy NMS on float canvases [B, H, W, C]
        -> (boxes, scores, classes, valid), [B, max_det]."""
        c = self.config
        rep = rep or self._replicas[0]
        # record_function ranges name the stages in a torch.profiler trace
        # (chip_smoke.py --profile); they cost ~1 us when no profiler runs
        with record_function("ocr/detector"):
            decoded, _ = rep.localizer(self._cast_in(imgs))
        with record_function("ocr/decode_nms"):
            return decode_and_nms(
                decoded.float(),
                conf_thresh=c.localizer.conf_thresh,
                iou_thresh=c.localizer.iou_thresh,
                max_nms=c.localizer.max_nms,
                max_det=c.localizer.max_det,
                class_agnostic=c.localizer.class_agnostic,
                nms_kernel=self._nms_kernel,
            )

    # ------------------------------------------------------ device program
    @torch.inference_mode()
    def _ocr_from_canvas(self, imgs: torch.Tensor, content_meta: torch.Tensor,
                         rep: Optional[_Replica] = None) -> torch.Tensor:
        """Fused chunk body: canvas float images [B, H, W, C] -> one packed
        result buffer (n_chars | nn_idx | char boxes | word boxes | word
        validity), int16 carrying uint16 bits under out_quant "u16", int32
        under "i32".  content_meta [B, 4] int32: (top, left, new_h, new_w).
        ``rep``: the replica that runs it (default the first).
        """
        c = self.config
        dev = imgs.device
        rep = rep or self._replicas[0]
        boxes, scores, classes, valid = self._detections(imgs, rep)
        imgs = self._cast_in(imgs)
        b, m = valid.shape
        # reading-order key = left edge, or top edge for vertical lines
        center = boxes[..., 1] if c.vertical else boxes[..., 0]
        char_mask = valid & (classes == 0)
        n_chars = char_mask.sum(dim=1)

        # Line-major reading-order compaction: (1) per-line STABLE sort by
        # the 1/16-px-quantized left edge (invalid slots ride as int32 max
        # and land last); (2) crop slot t belongs to line
        # b(t) = searchsorted(csum, t, right), char j(t) = t - start(b(t)).
        invalid = torch.iinfo(torch.int32).max
        edge_q = torch.where(
            char_mask,
            torch.clamp(torch.round(center * 16.0), 0, (1 << 18) - 1)
            .to(torch.int32),
            torch.full((), invalid, dtype=torch.int32, device=dev),
        )
        row_order = torch.argsort(edge_q, dim=1, stable=True)
        boxes_sorted = torch.gather(boxes, 1,
                                    row_order[..., None].expand(b, m, 4))
        csum = torch.cumsum(n_chars, dim=0)
        t = torch.arange(min(self._crop_cap, b * m), device=dev)
        b_t = torch.searchsorted(csum, t, right=True)
        flat_valid = b_t < b
        flat_b = torch.clamp(b_t, max=b - 1)
        start = csum[flat_b] - n_chars[flat_b]
        j_t = torch.clamp(t - start, 0, m - 1)
        flat_boxes = boxes_sorted[flat_b, j_t]

        pad = c.box_pad
        rx0 = torch.round(flat_boxes[:, 0] - pad).to(torch.int32)
        rx1 = torch.round(flat_boxes[:, 2] + pad).to(torch.int32)
        ry0 = torch.round(flat_boxes[:, 1] - pad).to(torch.int32)
        ry1 = torch.round(flat_boxes[:, 3] + pad).to(torch.int32)
        if c.crop_geometry == "tight":
            # box-exact crops (encoders trained on unclipped paired crops)
            rects = torch.stack([rx0, ry0, rx1, ry1], dim=1)
        elif c.vertical:
            # the box's rows, the line's full content width
            left = content_meta[flat_b, 1]
            nw = content_meta[flat_b, 3]
            rects = torch.stack([left, ry0, left + nw, ry1], dim=1)
        else:
            top = content_meta[flat_b, 0]
            nh = content_meta[flat_b, 2]
            rects = torch.stack([rx0, top, rx1, top + nh], dim=1)

        # crop + encode per encoder_sub_batch: identical results to one
        # pass (crops are per slot), bounded peak memory
        n_slots = t.shape[0]
        sub = c.encoder_sub_batch
        if sub and n_slots > sub:
            if n_slots % sub:
                raise ValueError(f"crop slots {n_slots} not a multiple of "
                                 f"encoder_sub_batch {sub}")
        else:
            sub = n_slots
        window = min(c.localizer.input_size, c.crop_window)
        embs = []
        for s in range(0, n_slots, sub):
            with record_function("ocr/crop"):
                crops = self._cast_in(crop_lines_to_squares(
                    imgs, rects[s:s + sub], flat_b[s:s + sub],
                    flat_valid[s:s + sub], out_size=c.encoder.image_size,
                    window=window,
                ))  # the ROI crop computes in f32; re-cast for bf16 convs
            with record_function("ocr/encoder"):
                # float32 embeddings: exact retrieval margins
                embs.append(rep.encoder(crops).float())
        # one retrieval over every crop slot of the chunk
        with record_function("ocr/retrieval"):
            nn_idx = self._classify(torch.cat(embs), rep)

        if c.out_quant == "u16":
            def pack(x):   # 1/16-px fixed point
                return torch.clamp(torch.round(x * 16.0), 0,
                                   65535).to(torch.int32).reshape(-1)
        else:
            def pack(x):   # float32 bits, exact
                return x.contiguous().view(torch.int32).reshape(-1)
        parts = [n_chars.to(torch.int32), nn_idx.to(torch.int32),
                 pack(flat_boxes)]
        if c.lang == "en":
            # per-line word boxes, reading-order sorted (jp has no word
            # grouping: none are computed or shipped)
            word_mask = valid & (classes == 1)
            word_key = torch.where(word_mask, center,
                                   torch.full_like(center, float("inf")))
            worder = torch.argsort(word_key, dim=1,
                                   stable=True)[:, :c.max_words_per_line]
            nw = worder.shape[1]
            word_boxes = torch.gather(boxes, 1,
                                      worder[..., None].expand(b, nw, 4))
            word_valid = torch.gather(word_key, 1, worder) < float("inf")
            parts += [pack(word_boxes),
                      word_valid.reshape(-1).to(torch.int32)]
        buf = torch.cat(parts)
        if c.out_quant == "u16":
            # narrow to 16 bits through the int16 bit pattern (torch's
            # uint16 lacks CUDA ops); the host views the bytes as uint16
            return torch.where(buf >= 32768, buf - 65536, buf).to(
                torch.int16)
        return buf

    @torch.inference_mode()
    def _ocr_chunk(self, canvas_u8: torch.Tensor,
                   content_meta: torch.Tensor,
                   rep: Optional[_Replica] = None) -> torch.Tensor:
        """Canvas upload [B, H, W*bits/8, C] uint8 -> packed result.
        transfer_bits 4: two width-adjacent pixels per byte (hi nibble =
        even px), unpacked by nibble replication (v * 17); 2: four pixels
        per byte MSB-first, v * 85."""
        bits = self.config.transfer_bits
        b, h, wp, ch = canvas_u8.shape
        if bits == 4:
            pix = torch.stack([(canvas_u8 >> 4) * 17,
                               (canvas_u8 & 0x0F) * 17], dim=3)
            canvas_u8 = pix.reshape(b, h, wp * 2, ch)
        elif bits == 2:
            pix = torch.stack([((canvas_u8 >> s) & 0x3) * 85
                               for s in (6, 4, 2, 0)], dim=3)
            canvas_u8 = pix.reshape(b, h, wp * 4, ch)
        return self._ocr_from_canvas(canvas_u8.float() / 255.0, content_meta,
                                     rep)

    @torch.inference_mode()
    def _ocr_chunk_bucket(self, buckets_u8: torch.Tensor,
                          src_rect: torch.Tensor, dst_params: torch.Tensor,
                          content_meta: torch.Tensor, size_h: int,
                          rep: Optional[_Replica] = None) -> torch.Tensor:
        """Bucket transfer: raw-size lines [B, Hb, Wb, C] uint8 in a small
        padded bucket, letterboxed on the device onto the size_h x
        input_size canvas (kernels/image_ops.py letterbox_device), then
        the fused body."""
        with record_function("ocr/letterbox"):
            canvas = letterbox_device(
                buckets_u8.float() / 255.0, src_rect, dst_params, size_h,
                self.config.localizer.input_size)
        return self._ocr_from_canvas(canvas, content_meta, rep)

    @torch.inference_mode()
    def _detect(self, canvas_u8: torch.Tensor):
        """crop_source original, program 1: 8-bit canvases -> (boxes,
        classes, valid) [B, max_det]."""
        boxes, _, classes, valid = self._detections(canvas_u8.float() / 255.0)
        return boxes, classes, valid

    @torch.inference_mode()
    def _recognize_squares(self, squares_u8: torch.Tensor,
                           sides: torch.Tensor) -> torch.Tensor:
        """crop_source original, program 2: crops padded white to squares
        [N, S, S, 3] uint8 (crop n's side x side square at the top-left)
        -> the paired transform (the JAX package's paired_transform_host,
        here on the device) -> encoder -> index [N]."""
        with record_function("ocr/crop"):
            crops = paired_transform_squares(
                squares_u8.float() / 255.0, sides,
                self.config.encoder.image_size)
        with record_function("ocr/encoder"):
            emb = self.encoder(self._cast_in(crops)).float()
        with record_function("ocr/retrieval"):
            return self._classify(emb)

    # ------------------------------------------------------------------ run
    def run(
        self,
        images: Sequence[Union[str, np.ndarray]],
        return_coco: bool = False,
    ) -> Dict:
        """OCR a list of text-line images (PNG paths or HWC uint8 arrays).

        Returns {key: text} where key is the path (or list index).
        """
        c = self.config
        results: Dict = {}
        coco_boxes: Dict = {}
        keys = [img if isinstance(img, str) else i
                for i, img in enumerate(images)]
        # deferred decode: shapes from PNG headers, pixels in the worker;
        # repeated paths share one entry and decode once
        lazy: Dict[str, _LazyImage] = {}
        raws: List = []
        for img in images:
            if isinstance(img, str):
                if img not in lazy:
                    lazy[img] = _LazyImage(img, gray=c.input_channels == 1)
                raws.append(lazy[img])
            else:
                raws.append(np.asarray(img))

        # wide-line tiling: extreme-aspect lines become overlapping tiles
        # that ride the pipeline as ordinary lines; their decodes merge in
        # _finalize_tiled
        tile_ctx = None
        if c.tile_min_content_h > 0 and c.crop_source != "letterbox":
            logger.warning(
                "tile_min_content_h=%d ignored: wide-line tiling needs "
                "crop_source='letterbox' (got %r)",
                c.tile_min_content_h, c.crop_source,
            )
        elif c.tile_min_content_h > 0:
            raws, keys, tile_ctx = self._expand_tiles(raws, keys)

        # width-sorted chunking: lines of similar reading-axis length
        # share chunks so adaptive_width canvas tiers bind per chunk
        # (results are keyed)
        if c.chunk_sort == "width" and len(raws) > 1:
            ax = 0 if c.vertical else 1
            order = sorted(range(len(raws)), key=lambda i: raws[i].shape[ax],
                           reverse=True)
            raws = [raws[i] for i in order]
            keys = [keys[i] for i in order]

        # host prep + device issue of chunk k+1 run on one worker thread
        # (keeping the device queue in submission order) while the
        # consumer finishes chunk k
        pending = deque()

        def _pop_finish():
            with self.timer.stage("main/wait_prep"):
                handle = pending.popleft().result()
            self._finish_chunk(handle, results, coco_boxes, tile_ctx,
                               want_coco=return_coco)

        with self.timer.stage("main/run_wall"), \
                ThreadPoolExecutor(max_workers=1) as prep:
            for start in range(0, len(raws), c.line_batch):
                pending.append(prep.submit(
                    self._dispatch_chunk, raws[start:start + c.line_batch],
                    keys[start:start + c.line_batch]))
                if len(pending) >= max(c.prefetch_chunks, 1):
                    _pop_finish()
            while pending:
                _pop_finish()

        if tile_ctx:
            for parent, ctx in tile_ctx.items():
                if parent not in results:
                    logger.warning(
                        "tiled line %r: merged with %d/%d tiles decoded",
                        parent, len(ctx["parts"]), ctx["n"],
                    )
                    self._finalize_tiled(parent, ctx, results, coco_boxes)

        if return_coco:
            return results, build_inference_coco(coco_boxes)
        return results

    def _expand_tiles(self, raws, keys):
        """Replace each line whose letterboxed content would fall below
        tile_min_content_h px across (along, if vertical) by its tiles,
        keyed TileKey(parent key, tile index).  Returns (raws, keys,
        {parent key: merge context} or None)."""
        c = self.config
        size_w = c.localizer.input_size
        cap_h = c.localizer.input_height or size_w
        exp_raws, exp_keys, tile_ctx = [], [], {}
        for key, raw in zip(keys, raws):
            h, w = raw.shape[:2]
            if c.vertical:
                plan = plan_tiles(h, w, cap_h, size_w, c.tile_min_content_h,
                                  c.tile_overlap_factor)
            else:
                plan = plan_tiles(w, h, size_w, cap_h, c.tile_min_content_h,
                                  c.tile_overlap_factor)
            if not plan:
                exp_raws.append(raw)
                exp_keys.append(key)
                continue
            tile_ctx[key] = {"n": len(plan), "plan": plan, "h": h, "w": w,
                             "parts": {}}
            pix = raw.load() if isinstance(raw, _LazyImage) else raw
            for t, tile in enumerate(plan):
                sub = (pix[tile.start:tile.stop] if c.vertical
                       else pix[:, tile.start:tile.stop])
                exp_raws.append(np.ascontiguousarray(sub))
                exp_keys.append(TileKey(key, t))
        return exp_raws, exp_keys, tile_ctx or None

    def _chunk_canvas_height(self, chunk) -> int:
        """Smallest stride-32 canvas height holding every line's width-bound
        content height (PipelineConfig.adaptive_height), within the
        [adaptive_height_floor, adaptive_height_cap] trained range.
        Vertical lines read down the canvas height: always the full one."""
        c = self.config
        size_w = c.localizer.input_size
        cap = c.localizer.input_height or size_w
        if not c.adaptive_height or c.vertical:
            return cap
        if c.adaptive_height_cap:
            cap = min(cap, c.adaptive_height_cap)
        need = c.adaptive_height_floor or 32
        if c.adaptive_height_mode == "native":
            # tier nearest the tallest raw line: letterbox scale stays ~1
            hmax = max((raw.shape[0] for raw in chunk), default=cap)
            tier = max(32, int(np.round(hmax / 32.0)) * 32)
            return int(np.clip(tier, need, cap))
        for raw in chunk:
            h, w = raw.shape[:2]
            need = max(need, min(cap, int(np.ceil(h * size_w / w))))
        return min(cap, -(-need // 32) * 32)

    def _chunk_canvas_dims(self, chunk) -> Tuple[int, int]:
        """(canvas_h, canvas_w): the adaptive height tier plus, under
        adaptive_width, the reading axis (width, or height for vertical
        lines) trimmed to the chunk's content extent at the UNCHANGED
        letterbox scale (r is computed against the full canvas, so the
        decode is exact).  Bucket transfer and crop_source original keep
        the full canvas, as in the JAX package."""
        c = self.config
        full_w = c.localizer.input_size
        size_h = self._chunk_canvas_height(chunk)
        if (not c.adaptive_width or c.transfer == "bucket"
                or c.crop_source != "letterbox" or not chunk):
            return size_h, full_w
        stride = max(32, c.adaptive_width_stride)
        ax = 0 if c.vertical else 1
        need = 0
        for raw in chunk:
            h, w = raw.shape[:2]
            r = min(full_w / w, size_h / h)
            need = max(need, int(np.ceil(raw.shape[ax] * r)))
        # +32 slack keeps content off the trimmed edge
        trim = -(-(need + 32) // stride) * stride
        if c.vertical:
            return min(size_h, trim), full_w
        return size_h, min(full_w, trim)

    # ------------------------------------------------------------ host prep
    def _dispatch_chunk(self, chunk, chunk_keys):
        """Host decode + letterbox + pack, upload, and device issue of one
        chunk (runs on the prep worker)."""
        c = self.config
        gray_canvas = (c.input_channels == 1 and c.crop_source == "letterbox"
                       and c.transfer == "canvas")
        if gray_canvas and chunk and all(
                isinstance(im, _LazyImage) and im._arr is None
                and im._native for im in chunk):
            # fused native fast path: PNG decode -> gray letterbox -> pack
            # straight from file paths into the canvas buffer, one pass
            handle = self._dispatch_gray_decode_fused(chunk, chunk_keys)
            if handle is not None:
                return handle

        with self.timer.stage("prep/decode"):
            chunk = _materialize_batch(chunk)
        size_h, size_w = self._chunk_canvas_dims(chunk)
        if c.crop_source == "original":
            return self._dispatch_original(chunk, chunk_keys, size_h, size_w)
        if c.input_channels == 1:
            chans = {im.shape[-1] for im in chunk}
            if not gray_canvas or len(chans) > 1 or not chans <= {1, 3}:
                # truncating channel mean, as numpy does (the native gray
                # pass takes 1 or 3 channels, one kind per chunk)
                chunk = [im.mean(axis=-1, keepdims=True).astype(np.uint8)
                         if im.shape[-1] != 1 else im for im in chunk]
            if gray_canvas:
                return self._dispatch_gray_native(chunk, chunk_keys, size_h,
                                                  size_w)
        if c.transfer == "bucket":
            return self._dispatch_bucket(chunk, chunk_keys, size_h, size_w)
        return self._dispatch_rgb(chunk, chunk_keys, size_h, size_w)

    def _dispatch_gray_decode_fused(self, chunk, chunk_keys):
        """ONE native pass per image: PNG decode + gray letterbox +
        sub-byte pack, file path -> canvas row.  Returns None if any image
        fails native decode (the caller takes the two-step path)."""
        c = self.config
        size_h, size_w = self._chunk_canvas_dims(chunk)
        bits = c.transfer_bits
        buf = np.full((c.line_batch, size_h, size_w * bits // 8, 1),
                      _PAD_BYTE[bits], np.uint8)
        with self.timer.stage("prep/decode+letterbox"):
            res = native.decode_letterbox_gray_batch(
                [im.path for im in chunk], [im.shape[:2] for im in chunk],
                size_w, buf, out_h=size_h, pack_bits=bits,
            )
        if res is None:
            return None
        return self._launch(buf, chunk, chunk_keys, *res)

    def _dispatch_gray_native(self, chunk, chunk_keys, size_h, size_w):
        """Gray canvas from decoded arrays: one threaded native pass does
        RGB->gray, letterbox and sub-byte packing."""
        c = self.config
        bits = c.transfer_bits
        buf = np.full((c.line_batch, size_h, size_w * bits // 8, 1),
                      _PAD_BYTE[bits], np.uint8)
        with self.timer.stage("prep/letterbox+pack"):
            out, ratios, tops, lefts = native.letterbox_gray_batch(
                [np.ascontiguousarray(im) for im in chunk], size_w,
                out_h=size_h, pack_bits=bits,
            )
            buf[:len(chunk), :, :, 0] = out
        return self._launch(buf, chunk, chunk_keys, ratios, tops, lefts)

    def _rgb_canvas(self, chunk, size_h, size_w):
        """[line_batch, size_h, size_w, 3] uint8 letterboxed canvas (114
        gray padding) and the letterbox geometry (ratios, tops, lefts)."""
        lb = np.full((self.config.line_batch, size_h, size_w, 3), 114,
                     np.uint8)
        out, ratios, tops, lefts = native.letterbox_batch(
            [np.ascontiguousarray(im) for im in chunk], size_w, out_h=size_h)
        lb[:len(chunk)] = out
        return lb, ratios, tops, lefts

    def _dispatch_rgb(self, chunk, chunk_keys, size_h, size_w):
        """3-channel canvas: native letterbox, then numpy sub-byte pack."""
        c = self.config
        with self.timer.stage("prep/letterbox+pack"):
            lb, ratios, tops, lefts = self._rgb_canvas(chunk, size_h, size_w)
            if c.transfer_bits == 4:
                lb = (lb[:, :, 0::2] & 0xF0) | (lb[:, :, 1::2] >> 4)
            elif c.transfer_bits == 2:
                lv = quantize_2bit(lb, dither_offsets(size_h, size_w)[
                    :, :, None])
                lb = ((lv[:, :, 0::4] << 6) | (lv[:, :, 1::4] << 4)
                      | (lv[:, :, 2::4] << 2) | lv[:, :, 3::4]
                      ).astype(np.uint8)
        return self._launch(np.ascontiguousarray(lb), chunk, chunk_keys,
                            ratios, tops, lefts)

    def _letterbox_metas(self, chunk, ratios, tops, lefts):
        """Per-line letterbox geometry (the host finisher's inverse map)
        and the device's content_meta [line_batch, 4] int32: (top, left,
        new_h, new_w)."""
        metas = []
        meta_arr = np.zeros((self.config.line_batch, 4), np.int32)
        for i, im in enumerate(chunk):
            h, w = im.shape[:2]
            r = float(ratios[i])
            new_h, new_w = int(round(h * r)), int(round(w * r))
            metas.append(dict(h=h, w=w, r=r, top=int(tops[i]),
                              left=int(lefts[i]), new_h=new_h, new_w=new_w))
            meta_arr[i] = (int(tops[i]), int(lefts[i]), new_h, new_w)
        return metas, meta_arr

    def _launch(self, canvas: np.ndarray, chunk, chunk_keys, ratios, tops,
                lefts) -> Dict:
        """Upload one packed canvas, issue the chunk program, and start
        the result's copy back to pinned host memory."""
        metas, meta_arr = self._letterbox_metas(chunk, ratios, tops, lefts)
        with self.timer.stage("prep/h2d+dispatch"):
            outs = self._issue_shards(
                len(chunk), (canvas, meta_arr),
                lambda rep, cv, meta: self._ocr_chunk(cv, meta, rep))
        return dict(chunk=chunk, chunk_keys=chunk_keys, metas=metas,
                    fused_out=outs)

    def _issue_shards(self, n_lines: int, arrays, program):
        """Split the host arrays [line_batch, ...] into one slice of
        line_batch / n rows per replica, upload each to its replica's
        device and issue ``program(rep, *slices)`` there, without waiting,
        for the replicas that hold real lines; start each result's copy
        back to pinned host memory.  Returns [(host tensor, event)]."""
        per = self.config.line_batch // len(self._replicas)
        outs = []
        for d, rep in enumerate(self._replicas):
            if d and d * per >= n_lines:
                break
            with rep.context():
                out = program(rep, *(
                    torch.from_numpy(a[d * per:(d + 1) * per]).to(rep.device)
                    for a in arrays))
                (host,), event = _to_host_async([out])
            outs.append((host, event))
        return outs

    def _dispatch_bucket(self, chunk, chunk_keys, size_h, size_w):
        """Bucket transfer: each line goes into a bucket_hw bucket at its
        raw size (a line larger than the bucket is first letterboxed into
        it on the host, with 0 padding); the device letterboxes the
        buckets onto the canvas."""
        c = self.config
        bh, bw = c.bucket_hw
        buckets = np.zeros((c.line_batch, bh, bw, c.input_channels), np.uint8)
        src_rect = np.zeros((c.line_batch, 4), np.int32)
        dst_params = np.zeros((c.line_batch, 4), np.int32)
        metas = []
        with self.timer.stage("prep/letterbox+pack"):
            for i, raw in enumerate(chunk):
                h, w = raw.shape[:2]
                if h <= bh and w <= bw:
                    buckets[i, :h, :w] = raw
                    r0, sy, sx, sh, sw = 1.0, 0, 0, h, w
                else:
                    out, rr, tt, ll = native.letterbox_batch(
                        [np.ascontiguousarray(raw)], bw, pad_val=0, out_h=bh)
                    buckets[i] = out[0]
                    r0, sy, sx = float(rr[0]), int(tt[0]), int(ll[0])
                    sh, sw = int(round(h * r0)), int(round(w * r0))
                r1, (nw, nh), (top, _, left, _) = letterbox_params(
                    sh, sw, (size_h, size_w))
                src_rect[i] = (sy, sx, sh, sw)
                dst_params[i] = (top, left, nh, nw)
                metas.append(dict(h=h, w=w, r=r0 * r1, top=top, left=left,
                                  new_h=nh, new_w=nw))
        with self.timer.stage("prep/h2d+dispatch"):
            # the content lands where dst_params places it
            outs = self._issue_shards(
                len(chunk), (buckets, src_rect, dst_params),
                lambda rep, bk, sr, dp: self._ocr_chunk_bucket(
                    bk, sr, dp, dp, size_h, rep))
        return dict(chunk=chunk, chunk_keys=chunk_keys, metas=metas,
                    fused_out=outs)

    def _dispatch_original(self, chunk, chunk_keys, size_h, size_w):
        """crop_source original: the 8-bit RGB canvas (transfer_bits does
        not apply here, as in the JAX package) and the detect program; the
        consumer cuts the crops."""
        with self.timer.stage("prep/letterbox+pack"):
            lb, ratios, tops, lefts = self._rgb_canvas(chunk, size_h, size_w)
        metas, _ = self._letterbox_metas(chunk, ratios, tops, lefts)
        with self.timer.stage("prep/h2d+dispatch"):
            det = self._detect(torch.from_numpy(lb).to(self.device))
            det, event = _to_host_async(det)
        return dict(chunk=chunk, chunk_keys=chunk_keys, metas=metas,
                    detect_out=det, event=event)

    # -------------------------------------------------------- host finish
    def _finish_chunk(self, handle, results, coco_boxes, tile_ctx=None,
                      want_coco=True) -> None:
        if "fused_out" in handle:
            return self._finish_fused(handle, results, coco_boxes, tile_ctx,
                                      want_coco=want_coco)
        return self._finish_original(handle, results, coco_boxes,
                                     want_coco=want_coco)

    def _finish_fused(self, handle, results, coco_boxes, tile_ctx=None,
                      want_coco=True) -> None:
        """Decode one chunk's packed segments, one per replica's
        line_batch / n lines (the JAX engine's [n_shards, out_len]
        buffer), and re-dispatch the lines that overflowed a segment's
        crop cap."""
        chunk, keys, metas = (handle["chunk"], handle["chunk_keys"],
                              handle["metas"])
        ld = self.config.line_batch // len(self._replicas)
        left_chunk: List = []
        left_keys: List = []
        for d, (out, event) in enumerate(handle["fused_out"]):
            lo = d * ld
            with self.timer.stage("main/device_get"):
                if event is not None:
                    event.synchronize()
                buf = out.numpy()
                if buf.dtype == np.int16:
                    buf = buf.view(np.uint16)
            with self.timer.stage("main/postprocess"):
                leftover = self._finish_fused_segment(
                    buf, chunk[lo:lo + ld], keys[lo:lo + ld],
                    metas[lo:lo + ld], ld, results, coco_boxes, tile_ctx,
                    want_coco=want_coco)
            if leftover is not None:
                left_chunk.extend(leftover[0])
                left_keys.extend(leftover[1])
        if left_chunk:
            self._finish_chunk(self._dispatch_chunk(left_chunk, left_keys),
                               results, coco_boxes, tile_ctx,
                               want_coco=want_coco)

    def _finish_fused_segment(self, buf, chunk, chunk_keys, metas, nb,
                              results, coco_boxes, tile_ctx=None,
                              want_coco=True):
        """Decode one packed buffer (nb line slots, len(chunk) real
        lines).  Returns (lines, keys) to re-dispatch on crop-slot
        overflow, else None."""
        c = self.config
        n = len(chunk)
        cap = min(self._crop_cap, nb * c.localizer.max_det)
        u16 = buf.dtype == np.uint16

        def _unpack_boxes(seg, *shape):
            if u16:  # 1/16-px fixed point (out_quant "u16")
                return seg.astype(np.float32).reshape(*shape) * 0.0625
            return seg.view(np.float32).reshape(*shape)

        o = 0
        n_chars = buf[o:o + nb].astype(np.int64)
        o += nb
        nn_idx = buf[o:o + cap]
        o += cap
        flat_boxes = _unpack_boxes(buf[o:o + 4 * cap], cap, 4)
        o += 4 * cap
        en = c.lang == "en"
        if en:
            # the device-side [:, :max_words_per_line] slice caps at the
            # NMS max_det column count
            w = min(c.max_words_per_line, c.localizer.max_det)
            word_boxes = _unpack_boxes(buf[o:o + nb * w * 4], nb, w, 4)
            o += nb * w * 4
            word_valid = buf[o:o + nb * w].astype(bool).reshape(nb, w)
            o += nb * w
        if o != buf.shape[0]:
            raise ValueError(f"packed buffer holds {buf.shape[0]} entries, "
                             f"layout needs {o}")

        # crop slots hold a reading-order (line-major) prefix of the
        # chunk's chars: on overflow, spill the undecoded tail lines into a
        # fresh dispatch instead of truncating them
        csum = np.cumsum(n_chars[:n])
        leftover = None
        if n and csum[-1] > cap:
            first_bad = int(np.searchsorted(csum, cap, side="right"))
            if first_bad == 0:
                logger.warning(
                    "line %r has %d chars, more than crop_batch=%d; "
                    "truncating its decode (raise crop_batch)",
                    chunk_keys[0], int(n_chars[0]), cap,
                )
                n_chars[0] = cap
                first_bad = 1
            if first_bad < n:
                logger.warning(
                    "chunk overflow: %d chars > crop_batch=%d; "
                    "re-dispatching %d tail lines",
                    int(csum[-1]), cap, n - first_bad,
                )
                leftover = (chunk[first_bad:], chunk_keys[first_bad:])
                n = first_bad

        # one vectorised char decode for the whole segment; ids past the
        # lookup (a classifier's argmax over more logits than a sparse
        # class map names) decode to ""
        lookup = self._char_lookup
        total = int(csum[n - 1]) if n else 0
        idx_seg = nn_idx[:total]
        seg_chars = np.where(
            idx_seg < len(lookup),
            lookup[np.minimum(idx_seg, len(lookup) - 1)], "")

        if en and n:
            wend = batch_word_ends(
                flat_boxes[:, 2], n_chars[:n], word_boxes[:n, :, 0],
                word_valid[:n],
            )
            n_words = word_valid[:n].sum(axis=1)

        pos = 0
        for i in range(n):
            k = int(n_chars[i])
            boxes_i = flat_boxes[pos:pos + k]
            chars_i = seg_chars[pos:pos + k]
            pos += k

            if tile_ctx is not None and isinstance(chunk_keys[i], TileKey):
                # a tile of a wide line: keep its decode in parent
                # coordinates; the text is assembled at merge time
                self._stash_tile(chunk_keys[i], metas[i], boxes_i, chars_i,
                                 word_boxes[i][word_valid[i]]
                                 if en and k else None,
                                 tile_ctx, results, coco_boxes)
                continue

            text = "".join(chars_i.tolist()).strip() if k else ""
            if en and k:
                word_end_idx = wend[i, :int(n_words[i])]
                if c.anchor_margin is None:
                    out = insert_spaces(text, word_end_idx)
                else:
                    out = en_postprocess(
                        text, word_end_idx.tolist(),
                        boxes_i[:, 3] - boxes_i[:, 1], boxes_i[:, 3],
                        anchor_margin=c.anchor_margin,
                        anchor_multiplier=c.anchor_multiplier,
                    )
            else:
                out = text
            if c.spell_check and out:
                out = self._spell_check(out)
            results[chunk_keys[i]] = out

            if want_coco:
                coco_boxes[chunk_keys[i]] = self._coco_entry(
                    metas[i], boxes_i.tolist(), chars_i, out)
        return leftover

    @staticmethod
    def _coco_entry(meta, boxes, chars, text) -> Dict:
        """A line's COCO record: char boxes mapped back to original-image
        pixels through the letterbox geometry."""
        orig_boxes = []
        for bx, ch in zip(boxes, chars):
            x0 = max((bx[0] - meta["left"]) / meta["r"], 0.0)
            y0 = max((bx[1] - meta["top"]) / meta["r"], 0.0)
            x1 = min((bx[2] - meta["left"]) / meta["r"], meta["w"])
            y1 = min((bx[3] - meta["top"]) / meta["r"], meta["h"])
            orig_boxes.append({"bbox": [x0, y0, x1 - x0, y1 - y0],
                               "char": ch[0] if ch else ""})
        return {"width": meta["w"], "height": meta["h"], "text": text,
                "chars": orig_boxes}

    def _stash_tile(self, key, meta, boxes, chars, words, tile_ctx, results,
                    coco_boxes) -> None:
        """Keep one tile's chars, char boxes and word boxes (None: no
        words) in parent-line pixels; merge the line once its last tile
        is in."""
        ctx = tile_ctx[key.parent]
        ax = 1 if self.config.vertical else 0
        off = np.zeros(4, np.float32)
        off[[ax, ax + 2]] = ctx["plan"][key.index].start

        def to_parent(cb):
            ob = np.empty_like(cb, dtype=np.float32)
            ob[:, [0, 2]] = np.clip((cb[:, [0, 2]] - meta["left"]) / meta["r"],
                                    0, meta["w"])
            ob[:, [1, 3]] = np.clip((cb[:, [1, 3]] - meta["top"]) / meta["r"],
                                    0, meta["h"])
            return ob + off

        empty = np.zeros((0, 4), np.float32)
        ctx["parts"][key.index] = {
            "chars": chars,
            "boxes": to_parent(boxes) if len(boxes) else empty,
            "words": to_parent(words) if words is not None and len(words)
            else empty,
        }
        if len(ctx["parts"]) == ctx["n"]:
            self._finalize_tiled(key.parent, ctx, results, coco_boxes)

    def _finalize_tiled(self, parent, ctx, results, coco_boxes) -> None:
        """Merge a wide line's per-tile decodes (ownership spans + jitter
        dedup, pipelines/tiling.py) and run the line postprocess on the
        merged char and word stream in parent-pixel coordinates."""
        c = self.config
        empty = {"chars": [], "boxes": np.zeros((0, 4), np.float32),
                 "words": np.zeros((0, 4), np.float32)}
        parts = [ctx["parts"].get(t, empty) for t in range(ctx["n"])]
        cross = ctx["w"] if c.vertical else ctx["h"]
        margin = max(2.0, 0.05 * cross)
        chars, boxes, words = merge_tile_parts(parts, ctx["plan"],
                                               c.vertical, margin)
        text = "".join(x[0] for x in chars if x).strip()
        if c.lang == "en" and len(chars):
            _, word_end_idx = en_preprocess(boxes.tolist(), words.tolist(),
                                            vertical=c.vertical)
            out = en_postprocess(
                text, word_end_idx, (boxes[:, 3] - boxes[:, 1]).tolist(),
                boxes[:, 3].tolist(), anchor_margin=c.anchor_margin,
                anchor_multiplier=c.anchor_multiplier,
            )
        else:
            out = text
        if c.spell_check and out:
            out = self._spell_check(out)
        results[parent] = out
        coco_boxes[parent] = {
            "width": ctx["w"], "height": ctx["h"], "text": out,
            "chars": [{"bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]],
                       "char": ch[0] if ch else ""}
                      for b, ch in zip(boxes.tolist(), chars)],
        }

    def _spell_check(self, out: str) -> str:
        """Homoglyph spell check with the configured frequency dictionary
        (config.spell_check_dict; None = the small builtin list)."""
        worddict, vsim, abbrevs = default_dicts(
            self.config.spell_check_dict, self.config.homoglyphs_path)
        return visual_spell_checker(out, worddict, vsim, abbrevs)

    # ------------------------------------------------ crop_source original
    def _finish_original(self, handle, results, coco_boxes,
                         want_coco=True) -> None:
        """Host side of crop_source original: per line, reading order and
        word ends (lang.en_preprocess / jp_preprocess) of the detections,
        crops cut from the original image, then recognition of every crop
        of the chunk and the line postprocess."""
        c = self.config
        with self.timer.stage("main/device_get"):
            if handle["event"] is not None:
                handle["event"].synchronize()
            boxes, classes, valid = (t.numpy() for t in handle["detect_out"])
        lines, crops = [], []
        with self.timer.stage("main/crops"):
            for i, raw in enumerate(handle["chunk"]):
                v = valid[i]
                char_boxes = boxes[i][(classes[i] == 0) & v].tolist()
                word_boxes = boxes[i][(classes[i] == 1) & v].tolist()
                if c.lang == "en":
                    char_sorted, word_end_idx = en_preprocess(
                        char_boxes, word_boxes, vertical=c.vertical
                    ) if char_boxes else ([], [])
                else:
                    char_sorted = jp_preprocess(
                        char_boxes, vertical=c.vertical) if char_boxes else []
                    word_end_idx = []
                meta = handle["metas"][i]
                lines.append((handle["chunk_keys"][i], meta, char_sorted,
                              word_end_idx))
                crops += [self._original_crop(raw, b, meta)
                          for b in char_sorted]
        with self.timer.stage("main/recognize"):
            idx = self._recognize_crops(crops)
        lookup = self._char_lookup
        chars = np.where(idx < len(lookup),
                         lookup[np.minimum(idx, len(lookup) - 1)], "")
        pos = 0
        for key, meta, line_boxes, word_end_idx in lines:
            lc = chars[pos:pos + len(line_boxes)].tolist()
            pos += len(line_boxes)
            text = "".join(lc).strip() if lc else ""
            if c.lang == "en":
                out = en_postprocess(
                    text, word_end_idx, [b[3] - b[1] for b in line_boxes],
                    [b[3] for b in line_boxes],
                    anchor_margin=c.anchor_margin,
                    anchor_multiplier=c.anchor_multiplier,
                )
            else:
                out = text
            if c.spell_check and out:
                out = self._spell_check(out)
            results[key] = out
            if want_coco:
                coco_boxes[key] = self._coco_entry(meta, line_boxes, lc, out)

    def _original_crop(self, raw: np.ndarray, b, meta) -> np.ndarray:
        """One glyph's crop from the original image: the box (padded by
        box_pad along the reading axis) mapped back through the letterbox,
        x_orig = (x_canvas - left) / r, on the reading axis only ("line"
        geometry: the full line across it) or on both ("tight")."""
        c = self.config
        pad = c.box_pad

        def back(v, lo):
            return max(int(round((round(v) - lo) / meta["r"])), 0)

        if c.crop_geometry == "tight":
            crop = raw[back(b[1] - pad, meta["top"]):
                       back(b[3] + pad, meta["top"]),
                       back(b[0] - pad, meta["left"]):
                       back(b[2] + pad, meta["left"]), :]
        elif c.vertical:
            crop = raw[back(b[1] - pad, meta["top"]):
                       back(b[3] + pad, meta["top"]), :, :]
        else:
            crop = raw[:, back(b[0] - pad, meta["left"]):
                       back(b[2] + pad, meta["left"]), :]
        if crop.size == 0:
            crop = np.zeros((4, 4, 3), np.uint8)
        return crop

    def _recognize_crops(self, crops: List[np.ndarray]) -> np.ndarray:
        """Index [len(crops)] of each original-image crop: batches of at
        most crop_batch crops (fewer where their padded squares would pass
        the device budget), each padded white to the square of its
        largest side and recognized in one program."""
        c = self.config
        out = [np.zeros((0,), np.int64)]
        start = 0
        while start < len(crops):
            stop, side = start, 0
            while stop < len(crops) and stop - start < c.crop_batch:
                s = max(side, *crops[stop].shape[:2])
                if stop > start and (stop - start + 1) * s * s * 3 \
                        > _SQUARES_BUDGET:
                    break
                side, stop = s, stop + 1
            part = crops[start:stop]
            squares = np.full((len(part), side, side, 3), 255, np.uint8)
            sides = np.empty((len(part),), np.int64)
            for j, crop in enumerate(part):
                h, w = crop.shape[:2]
                squares[j, :h, :w] = crop
                sides[j] = max(h, w)
            idx = self._recognize_squares(
                torch.from_numpy(squares).to(self.device),
                torch.from_numpy(sides).to(self.device))
            out.append(idx.cpu().numpy().astype(np.int64))
            start = stop
        return np.concatenate(out)
