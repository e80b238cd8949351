"""Drive effocr_torch's main paths on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py [--profile] [--out DIR]

Phases (any failure exits non-zero; nothing is caught and reported ok):

1. setup: the card's name and power limit, torch/CUDA versions; build the
   native preprocessing library, the image decoders (native/imgdec.cpp),
   the glyph renderer (native/glyph.cpp) and the two CUDA kernel
   libraries (NMS, top-1 retrieval) in parallel.
2. K1 (csrc/nms.cu, the greedy-NMS keep-mask kernel) against its plain
   PyTorch version on the card, bit for bit: [512, 1024] boxes at IoU 0.25,
   a ragged N = 300, a tie-heavy batch, a 384-box cross-tile chain, N =
   2048 and 4096 with valid prefixes of mixed length at IoU 0.01 and 0.25,
   and integer boxes whose IoUs equal the threshold.  Then the K1 sweep:
   device time against B (120, 512) and valid prefix (64, 256, 1024).
3. K2 (csrc/top1.cu, the fused masked top-1 retrieval kernel) against its
   plain version: the jp path's shape [4096, 320] x [11051, 320] with ~1%
   of rows masked, a ragged C = 300 with N = 1, C in {127, 128, 129} with
   D in {4, 324}, duplicate prototypes
   (exact products: the tie rule), every row masked.  Scores within 1e-5,
   indices identical wherever the plain top-2 margin exceeds 1e-5 (and
   everywhere on the exact cases), all-masked rows exactly (0, -1e30).
   The kernel, the plain version and the library call (torch.matmul +
   mask + argmax) are timed by ``device_ms`` (CUDA events around calls
   queued behind a device-side wait: device time, host work excluded), as
   K1 is.
4. English slice: a seeded random-init artifact directory (yolov5s with the
   loc2k model.json, mobilenetv3_small_050 with the rec2k_mn_hn
   model.json, 90 random unit prototypes with rec2k_mn_hn's ref.txt),
   1024 synthetic gray line PNGs, and ``load_engine`` with
   BENCH_TRAINED.json's flags (paths swapped), through ``checked_runs``
   (below); K1 is then timed on the first NMS input of the path, and both
   models in float32 on the card are held against the CPU.
5. Japanese vertical slice: yolov5n with the loc_vert model.json,
   convnext_atto with the rec_knn6k3 model.json, 11,051 random unit
   prototypes with rec_knn6k3's ref.txt, 600 synthetic RGB vertical line
   PNGs, and ``load_engine`` with the jp_v3 benchmark's flags (paths
   swapped, plus ``--nms_kernel pallas``), through ``checked_runs``; K1
   and K2 are then timed on the first inputs of the path, and both models
   held against the CPU.
6. The other single-card paths, each through ``checked_runs``: a warm-up
   run with every K1 keep mask held bit for bit against nms_mask and
   every K2 result against top1_plain (margin rule), the timed run (K1's
   and K2's launch counts set to 0 before it and read after), then the
   engine's text against the same engine with plain NMS and top1_plain:
   - square: the en models on the square 640 x 640 canvas (a localizer
     model.json with no input_height) and crop_window 256, so crops take
     the general 2-D ROI window; 512 lines, both kernels;
   - original: ``--crop_source original`` on the jp artifacts with the
     jp_v3 flags; 240 RGB vertical lines;
   - tiling: BENCH_TRAINED.json's flags + ``--tile_min_h 24`` on 32 gray
     lines 6,000-8,000 px wide;
   - bucket: the en engine with transfer "bucket", bucket_hw (64, 1024),
     on 512 lines, most of them larger than the bucket;
   - classifier: mobilenetv3_small_050 + a 90-class head and a
     class_map.json from the en ref.txt; 256 lines;
   - serve: ``python -m effocr_torch serve --stdin --device cuda
     --spell_check`` in a subprocess, fed 128 paths; its answers must
     equal ``engine.run`` with the same flags over the batches the server
     logged, run in-process once with every K1 keep mask held bit for bit
     against nms_mask and once on plain NMS.
7. The training slice:
   - png: a palette, an RGBA, a 16-bit gray and an Adam7 PNG written from
     known pixels, read back by data/png.py and the engine's _LazyImage
     and held to Pillow's conversion rules; the en engine reads them (K1
     checked);
   - train: ``python -m effocr_torch train-recognizer --device cuda``
     with the en recipe of scripts/rebuild_r5.sh at full width
     (mobilenetv3_small_050, 128 px, 1 channel, batch 128, resident
     bank; depth cut to 2 epochs) on a synthetic 90-class char tree, then
     ``build-index --test --mine_hardneg 8``, then the en engine on the
     new recognizer over 512 lines (``checked_runs``); prints steps/s and
     images/s of epochs 2-3, the logged losses, val and test p@1 and peak
     device memory;
   - train_step_vs_cpu: one float32 make_train_step at full width on the
     card and on the CPU on the same batch and draws (loss, gradients,
     batch_stats within 1e-3), then the device time of each stage of the
     recipe's bf16 step;
   - build_index_from: ``infer --build_index_from`` on a copy of the
     trained dir without ref.npz, its rows held to build-index's render
     rows within 1e-5, then the en engine over 256 lines
     (``checked_runs``);
   - train_localizer: ``python -m effocr_torch train-localizer --device
     cuda`` with the en localizer recipe of scripts/northstar_en.sh at
     full width (yolov5s, 1024 wide, heights 64 and 96, 1 channel,
     fitted anchors, batch 16, resident bank; depth cut to 4 epochs,
     ``--eval_period 2``, ``--test_coco``) on 2,000 synthetic lines of
     phase train's glyphs; prints steps/s and images/s of the epochs
     after each height's first, the logged losses, AP / AP50 / AP75 of
     each evaluation and the test split, peak device memory and the
     fitted anchors.  In process, the best checkpoint on the val split
     twice: every K1 keep mask held bit for bit against nms_mask, then on
     plain NMS (equal AP dictionaries); K1 timed at that [16, 1024]
     input.  Then the en engine with the new localizer and phase train's
     recognizer over 256 held-out lines (``checked_runs``): CER and
     textline accuracy as ``infer --coco_json`` computes them;
   - loc_step_vs_cpu: one float32 localizer step at full width (augment
     on fixed draws) on the card and on the CPU (loss 1e-5 relative,
     gradients and batch_stats 1e-3 of the largest), then the device
     time of each stage of the recipe's bf16 step.
8. The other model families, each through ``checked_runs`` or with
   every K1 call checked inside the run:
   - xcit: BENCH_TRAINED.json's flags with a random xcit_small_12_p8_224
     recognizer (224 px crops, 784 tokens; 90 random prototypes) and the
     en localizer; one chunk of 512 lines (no run on plain NMS: the
     warm-up holds every K1 call bit for bit);
   - fcos / rcnn: the fcos_infer flags of scripts/chain_r5b.sh:29-39
     (1024 wide, gray, conf 0.3, IoU 0.25, 2-bit transfer, u16 output,
     ``--nms_kernel cuda``) with a random fcos_s / rcnn_s localizer
     (heads calibrated to read ~26 chars and ~5 words a line) and the en
     recognizer; 256 lines; the R-CNN's K1 calls split by site (its RPN
     at IoU 0.7, the decode at 0.25) and its RPN K1 timed at the path's
     first [512, N] input;
   - train_fcos / train_rcnn: ``train-localizer --arch fcos_s / rcnn_s``
     with the fcos_train recipe of scripts/chain_r5b.sh:21-27 (1024
     wide, heights 64 and 96, gray, batch 16, resident bank; depth cut to
     3 epochs of the first 500 of phase train_localizer's 2,000 train
     lines, one evaluation) on its val and test splits, run in
     this process with every K1 call checked; steps/s, images/s, losses,
     AP and peak memory;
   - train_xcit: ``train-recognizer`` with the en recipe's flags and
     xcit_small_12_p8_224 at 224 px (2 epochs of 10 passes) on phase
     train's tree,
     then ``build-index --test``;
   - family_steps_vs_cpu: one float32 step of each family (the XCiT
     recognizer at batch 16, FCOS and R-CNN at batch 4 x 96 x 1024) from
     the weights trained above, on the card and on the CPU: loss 1e-5
     relative, gradients and batch_stats 1e-3 of the largest.  The
     localizers' CPU step computes the stem in float64 (FAMILY_CPU_REF:
     the CPU's float32 sum of the stem's weight gradient rounds far more
     than the card's); the CPU's float32 step and a float64 one are
     logged beside it, each step's distance from the float64 one.  The
     R-CNN's RPN selection (stable sort, K1, top-k) on one device's
     candidates must give the other device's proposals bit for bit; when
     its free steps differ by more than 1e-3, the proposal slots that
     took another candidate and the box-head ReLU gates whose sign
     differs are counted and must be rounding ties (1e-4 of the largest
     score / pre-activation), and the CPU step with only those pinned to
     the card's must meet it at 1e-3.
9. Data parallelism on the one card (the JAX package's mesh paths):
   - data_parallel: ``load_engine --data_parallel`` with one visible card
     must print the JAX command's "single device visible; running
     unsharded"; then ``EffOCRInference(devices=[cuda:0, cuda:0])``, two
     replicas each on half of every chunk with half the crop cap, through
     ``checked_runs``: the en flags on 512 lines and the jp flags with K2
     on 240 lines, their lines/s beside the unsharded engine's in the
     same phase; text and COCO boxes bit for bit: the bfloat16 replicas
     on the fixed canvas against the unsharded engine on it at a
     replica's batch (line_batch / 2 lines, crop_batch / 2 slots), and
     float32 copies of the models on 2 replicas against them unsharded at
     the recipe's canvas and batch (cuDNN's bfloat16 detector
     convolutions round differently at half the batch: the bfloat16
     lines that differ at the recipe's batch are counted); then float32
     en models with
     a crop cap under the first replica's glyphs (its segment spills lines
     into a re-dispatch) on the fixed canvas, bit for bit with the
     unsharded engine at the replicas' crop cap; then
     ``knn_topk_sharded`` over 2 shards of the jp index at the jp path's
     K2 input against unsharded K2 (indices exact, scores 1e-5);
   - ddp_train: ``torchrun --nproc_per_node 2`` (``python -m
     torch.distributed.run --standalone``) of ``train-recognizer`` with
     phase train's recipe (1 epoch of 28 steps, 10 passes; no test
     split or hard-negative mining) and of
     ``train-localizer`` with phase train_localizer's (1 epoch, one
     evaluation; the first 160 lines of its train split), both ranks on
     cuda:0 over gloo; the ranks' log must
     name the backend and end with the trainer's check that both ranks'
     parameters are bit-identical; the localizer's best checkpoint is
     evaluated again here with every K1 mask checked, to the AP the ranks
     logged; then a 1-rank launch of ``train-recognizer``, on NCCL;
   - ddp_step_vs_single: one float32 step of the recognizer recipe and of
     yolov5s on 2 ranks sharing the card against 1 rank on the whole
     batch (loss 1e-5 relative, ranks bit-identical, new batch_stats
     1e-4 of the largest, gradients after DDP's averaging 1e-4 of the
     largest for yolov5s); the recognizer also in float64 on 2 ranks and
     on 1 (loss 1e-5, gradients and batch_stats 1e-4), its float32
     gradients held to twice the 1-rank float32 step's distance from the
     float64 step (2 vs 1, and 2 ranks vs float64); yolov5s also in
     float64 on 2 ranks and on 1 (the same tolerances; the detect head's
     input and the loss stay float32 in the model's code), with each
     float32 step's distance from it logged; and a profiled step on the
     ranks: wall time and all-reduce time.
10. Artifacts in and out (the importers, ``infer``'s auto-convert,
   ``export``), with interop/reference_writers.py writing the original
   EffOCR's formats:
   - interop_jp: the jp artifacts as a timm ``enc_best.pth`` (with and
     without DataParallel's ``module.``), a FAISS ``ref.index`` +
     ref.txt, and an ultralytics state dict and full module pickle;
     ``python -m effocr_torch import-reference`` (recognizer at 128 px),
     its main on the pickle, the state dict (same bytes), infer's hook on
     the second dir (same weights' bytes); every converted tree bit for
     bit the original's; then the jp_v3 flags with ``--crop_geometry
     tight`` on the imported dirs through ``checked_runs`` (600 lines):
     text identical to the original engine's on every line;
   - interop_en: the en recognizer (1 channel) as an ``enc_best.onnx``
     dir, imported at 128 px; one chunk of 512 lines on BENCH_TRAINED's
     flags, the en localizer as it is: text identical;
   - export: ``export_encoder`` of the jp recognizer at batch 64 on the
     card (reload parity, rtol/atol 0.05, its largest difference), the
     eager model against the reloaded program (kernel time, wall and
     host enqueue of a call);
   - import_encoder: the jp convnext_atto as an HF ConvNeXt dir,
     ``import-encoder`` (the tree bit for bit, equal to the trainer's
     weights after ``set_variables``), then ``train-recognizer
     --checkpoint`` at phase train's recipe (convnext_atto, 3 channels,
     1 epoch) in process: finite losses.
11. The tools and the seq2seq baseline:
   - tools: ``python -m effocr_torch infer`` (BENCH_TRAINED's flags,
     ``--nms_kernel pallas``) on the first 128 of phase
     train_localizer's 256 read lines
     with phase train's recognizer, in a subprocess with
     ``--output_localizer_results --compare_ocr --save_output``: every
     overlay equal to ``draw_boxes`` at inference_coco.json's boxes, the
     text equal to the same engine's in process (``checked_runs``, K1
     held), ``tesseract``'s presence logged; ``error-analysis`` on its
     results (the edits of the CER infer printed, category shares
     summing to 1);
     ``viz --k 5`` on 50 test crops of phase train's tree (each file's
     neighbours equal ``PrototypeIndex.search`` in process; p@1);
     ``device_trace`` around one en chunk of 512 lines (the Chrome trace
     names K1's two kernels; K1's launches counted from 0, each held bit
     for bit);
   - seq2seq: ``train-seq2seq --data_device resident`` at full width
     (the JAX command's defaults: dim 256, 6 + 4 blocks, 64 x 512
     canvas, max_len 64, batch 16, float32; depth cut to 2 epochs) on
     the first 1,000 of phase train_localizer's 2,000 train lines and its
     128 val lines: steps/s and
     images/s from the second epoch, epoch losses (falling), val CER and
     greedy lines/s by epoch; the best checkpoint's greedy and beam-4
     decode in process (lines/s, CER); one float32 step on the card
     against the CPU (loss 1e-5 relative, gradients 1e-3 of the
     largest); greedy tokens of 16 val lines on the card and the CPU
     identical but after a step whose CPU top-2 margin is under 1e-4.
   - trocr: ``import-trocr`` at the published trocr-base widths (ViT-base
     encoder, 384 px, 577 tokens; TrOCR decoder d_model 1024, 12 layers,
     vocab 50265; ~385M float32 parameters, the output projection a
     copy of the token embedding) from seeded weights written as
     model.safetensors + config.json + a byte-level BPE vocab.json +
     merges.txt counted from phase train_localizer's texts; ``--check``
     (against the float64 HF-layout reference), fine-tuning for 2 epochs
     of 128 train lines (batch 8, greedy val CER on 16 lines each epoch),
     then beam 4 on 16 read lines: the check's gap, steps/s and images/s
     of the second epoch, epoch losses (falling), CER, greedy and beam-4
     lines/s; from the fine-tuned npz, one float32 step at batch 2 on the
     card against the CPU (loss 1e-5 relative, gradients 1e-3 of the
     largest), teacher-forced logits of 4 val lines within 2e-3, and the
     card's greedy tokens where the CPU's argmax would first leave them
     only at a CPU top-2 margin under 2e-3 (counted); then the step at
     batch 8 timed and profiled (GEMM kernels against the rest, busy
     share, TFLOP/s of its matmuls from the shapes).
   - image_formats: JPEG, TIFF, BMP and GIF input on the machine without
     Pillow: every committed fixture of tests/torch_fixtures/images/
     (64 JPEG lines, one file per decoder branch, a 2550 x 3300 page as
     JPEG and group4 TIFF, the TIFF layouts: tiles, BigTIFF, separate
     planes, orientations, 4-bit and 16-bit samples) decoded and held to
     golden.npz (Pillow 12.1's RGB and L conversions, the JAX package's
     _LazyImage arrays, by SHA-256); host decode rates (the page on one
     thread and 8 copies as one batch, the group4 page, the page as 256 x
     256 Deflate tiles with predictor 2 written here, the lines one at a
     time and as one batch); ``infer
     --infer_over_img_dir`` with BENCH_TRAINED.json's flags on 256
     JPEG line paths and on the same lines as PNGs (identical text and
     COCO output, every K1 call held bit for bit; K1's launches counted
     from 0 around the JPEG run), the same engine timed on both lists
     (lines/s, host decode ms a chunk, header ms); 18 mixed .jpg / .tif
     / .bmp requests (a tiled, an orientation-6, a float (predictor 3)
     and an associated-alpha .tif among them) through ``serve``,
     answered as ``engine.run`` answers them (K1 checked in process);
     host decode rates of a float page with and without predictor 3.
   - fonts: the port's own glyph renderer (native/glyph.cpp: FreeType's
     v40 hinting, its Adobe engine for CFF and the gray rasterizer;
     fonts/: the sfnt and CFF readers, shaping, Pillow's text drawing)
     on the host with no Pillow or FreeType: the 90 en characters in the
     three committed DejaVu fonts through ``draw_single_char`` and
     ``draw_single_char_ascender`` at canvas 256 and both
     AddAdjacentChars banks against the JAX package's golden digests
     (tests/torch_fixtures/fonts/golden.npz), renders/s; the CFF
     fixtures (tests/torch_fixtures/fonts_cff/: a name-keyed serif and a
     65,535-glyph CID-keyed sans): the CID font's open time, the en
     characters in both and 90 CJK codepoints of the CID font, and their
     banks, against fonts_cff/golden.npz, renders/s per font; the jp
     make-corpus -> make-charset -> format-dataset chain on the CID font
     in the background process below, against its goldens; the bitmap
     fixtures (tests/torch_fixtures/fonts_bitmap/: EBLC / EBDT strikes,
     a strikes-only font, overlap-flagged glyphs, scaled component
     offsets): the en characters in the three fonts with outlines and
     their banks against fonts_bitmap/golden.npz, renders/s per font,
     the strike fonts swept over sizes 8-64 against the committed refused
     sizes, and ``format-dataset`` over the group 4 TIFF and palette PNG
     page fixtures (tests/torch_fixtures/mode_pages/) in two processes,
     against the JAX command's tree digests;
     ``make-corpus`` (512 en lines, noise 8, blur 1), ``make-charset
     --dedupe_renders`` and ``format-dataset`` as subprocesses of a
     background process started with the family phases, each output
     against the JAX commands' goldens; then, in that process,
     ``coco-split`` and ``train-recognizer --device cuda
     --adjacent_font_path`` (the en recipe, 1 epoch) on the rendered
     tree, beside the family phases' device work; in the phase itself,
     the renders and one ``apply_augment`` batch with the bank on the
     card against the CPU (the composite alone bit for bit, the full
     stack's error logged).  No kernel is on this path (``fonts`` 0 in
     the launch counts).
12. a ``kernels`` JSON line (launches per path under
   ``launches_by_path``; K1's ``train_localizer`` counts the evaluation's
   launches and the engine's; ``calls_by_iou`` splits the family paths'
   calls by site), then ``{"ok": true, "device": ...}`` last.

``--profile`` adds a torch.profiler run over one chunk of the en, jp,
square, xcit, fcos and rcnn paths: device time per engine stage (and per
R-CNN stage: trunk, RPN, ROIAlign, box head) and per kernel, and the
device busy share.

Needs a CUDA device, nvcc (sm_90a) and g++.  Writes its artifacts,
line images and results under build/chip_smoke/ in the checkout (the
results to ``--out DIR`` when given).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from effocr_torch import native
from effocr_torch.cli.infer import add_engine_args, load_engine
from effocr_torch.core import distributed
from effocr_torch.core.device import use_full_f32
from effocr_torch.core.dryrun import GradRecorder
from effocr_torch.interop.flax_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from effocr_torch.interop.flax_msgpack import write_variables
from effocr_torch.kernels import cuda_nms, cuda_top1
from effocr_torch.kernels.cuda_build import BUILD_DIR
from effocr_torch.kernels.nms import MAX_WH, nms_mask
from effocr_torch.kernels.retrieval import NEG_INF, top1_plain
from effocr_torch.models.factory import (
    create_classifier,
    create_encoder,
    create_localizer,
    init_params,
)
from effocr_torch.native import glyph, imgdec
from effocr_torch.retrieval.index import PrototypeIndex

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
R5 = os.path.join(ROOT, "bench_results", "r5", "runs")
N_LINES = 1024
N_JP_LINES = 600     # the size of the jp_v3 benchmark's eval split
SEED = 0
# detect-head bias offsets per scale, by output channel (4 = obj, 5 =
# class 0 "char", 6 = class 1 "word"), added after the heads are scaled to
# unit output spread: char candidates come from the stride-8 scale (the
# objectness offset sets how many pass conf_thresh), word candidates from
# the stride-32 one, none from stride 16.  The objectness offsets here
# and below are set for factory.init_params' draw (Flax's lecun_normal,
# truncated): ~26 chars per line on the en engine over 128 lines
DETECT_BIAS = {0: {4: -1.5, 5: 4.0, 6: -4.0},
               1: {4: -6.0},
               2: {4: 0.0, 5: -4.0, 6: 4.0}}
# the same for the jp vertical detector: char candidates from the stride-8
# scale only (jp decodes no word boxes); the objectness offset is set for
# ~29 chars per synthetic line after NMS at IoU 0.01, under the 34 crop
# slots per line of crop_batch 4096 / line_batch 120
JP_DETECT_BIAS = {0: {4: -2.8, 5: 4.0, 6: -4.0},
                  1: {4: -6.0},
                  2: {4: -6.0}}
# the en detector on the square 640 x 640 canvas: 20 x 20 stride-32 cells
# (not 3 x 32) would fill max_nms with word candidates at DETECT_BIAS, so
# their objectness drops; set for ~34 chars and ~16 words per line after
# NMS on 16 synthetic lines
SQUARE_DETECT_BIAS = {0: {4: -1.95, 5: 4.0, 6: -4.0},
                      1: {4: -6.0},
                      2: {4: -2.3, 5: -4.0, 6: 4.0}}
# K2: plain top-2 margins at or below this may flip the index under
# another summation order; scores must agree within it
K2_TOL = 1e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 SIMT ops/s
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# float32 operations per IoU test (2 min, 2 max, 2 sub, 2 clamp, mul,
# add, sub, add eps, div, compare); box areas are per box, not per pair
OPS_PER_PAIR = 14


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_ms(fn, reps=20, warmup=2, host_synced=False):
    """Device time of one call of fn(): CUDA events around ``reps`` calls
    queued behind a device-side wait (torch.cuda._sleep) that outlasts
    their enqueue, divided by ``reps``, after warm-up.  The device runs
    the calls back to back while the host is still ahead, so neither a
    wrapper's host work (checks, allocation, the ctypes call) nor an idle
    gap waiting for the host is counted.  The wait's length comes from the
    host time of one call; the timer checks that the first event was still
    pending when the last call had been queued, and otherwise doubles the
    wait and tries again.  A function that synchronizes with the host
    inside (``host_synced``: the plain NMS's fixpoint loop reads a flag
    each iteration) cannot be queued ahead: its time includes those
    syncs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wait_s = min(0.5, 2 * enqueue_s * reps + 0.002)
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(wait_s * 2e9))   # cycles at up to 2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead or host_synced:
            return start.elapsed_time(end) / reps
        wait_s *= 2
    raise RuntimeError("device_ms: the device-side wait never outlasted "
                       f"the enqueue of {reps} calls")


def kernel_split(fn, reps=10):
    """{kernel name: ms per call} of fn() from torch.profiler, or {} when
    the trace lost launches (each kernel must appear once per call): the
    split of a multi-kernel wrapper, beside device_ms's total."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if events and all(e.count == reps for e in events):
            return _short_names({e.key: e.self_device_time_total / 1e3 / reps
                                 for e in events})
    return {}


# ---------------------------------------------------------------- K1
def nms_bound_ms(valid: torch.Tensor):
    """Least time for the keep mask on these inputs: boxes + valid read
    once and keep written once, against the IoU tests this data needs
    (pairs among each image's valid boxes)."""
    b, n = valid.shape
    nv = valid.sum(dim=1).double()
    pairs = float((nv * (nv - 1) / 2).sum())
    t_bytes = b * n * (16 + 1 + 1) / HBM_BYTES_S * 1e3
    t_ops = pairs * OPS_PER_PAIR / F32_OPS_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def k1_case(name, boxes, valid, thr, timed=False):
    """Kernel vs plain on the card: keep masks must be identical."""
    kernel = cuda_nms.nms_kernel
    keep = kernel(boxes, valid, thr)
    ref = nms_mask(boxes, None, valid, thr, presorted=True)
    torch.cuda.synchronize()
    err = int((keep.int() - ref.int()).abs().max()) if keep.numel() else 0
    per_img = valid.sum(dim=1)
    log(f"K1 {name}: shape {tuple(valid.shape)} thr {thr} kept "
        f"{int(keep.sum())}/{int(valid.sum())} (valid per image: mean "
        f"{float(per_img.float().mean()):.1f}, max {int(per_img.max())}) "
        f"max|kernel-plain| {err}")
    if not torch.equal(keep, ref):
        raise AssertionError(f"K1 {name}: kernel and plain keep masks "
                             "differ")
    row = {"max_abs_err": err}
    if timed:
        row["ms"] = device_ms(lambda: kernel(boxes, valid, thr))
        row["ms_by_kernel"] = kernel_split(lambda: kernel(boxes, valid, thr))
        row["plain_ms"] = device_ms(
            lambda: nms_mask(boxes, None, valid, thr, presorted=True), reps=3,
            host_synced=True)
        row["bound_ms"], row["bound_by"] = nms_bound_ms(valid)
        log(f"K1 {name}: kernel {row['ms']:.4f} ms "
            f"{row['ms_by_kernel']}, plain {row['plain_ms']:.3f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}; device time)")
    return row


def _short_names(parts):
    """{kernel name: ms} with C++ signatures cut to the function name."""
    out = {}
    for k, v in parts.items():
        name = k.replace("(anonymous namespace)::", "").split("(")[0]
        name = name.split("<")[0].split("::")[-1] or k[:40]
        out[name] = round(out.get(name, 0.0) + v, 5)
    return out


def phase_k1_sweep(dev):
    """K1's device time against batch and valid prefix (N = 1024, the
    main paths' max_nms): B 120 at the jp threshold 0.01, B 512 at the
    en threshold 0.25, valid prefix per image 64, 256 or 1024.  Every
    cell is also held bit for bit against the plain version."""
    rng = np.random.default_rng(SEED + 5)
    rows = []
    for b, thr in ((120, 0.01), (512, 0.25)):
        boxes, valid = synthetic_presorted(rng, b, 1024, dev, all_valid=True)
        for prefix in (64, 256, 1024):
            v = valid.clone()
            v[:, prefix:] = False
            keep = cuda_nms.nms_kernel(boxes, v, thr)
            if not torch.equal(keep, nms_mask(boxes, None, v, thr,
                                              presorted=True)):
                raise AssertionError(f"K1 sweep B {b} prefix {prefix}: "
                                     "kernel and plain differ")
            ms = device_ms(lambda: cuda_nms.nms_kernel(boxes, v, thr))
            parts = kernel_split(lambda: cuda_nms.nms_kernel(boxes, v, thr))
            bound, by = nms_bound_ms(v)
            rows.append(dict(b=b, n=1024, prefix=prefix, thr=thr, ms=ms,
                             ms_by_kernel=parts,
                             bound_ms=bound, bound_by=by,
                             kept=int(keep.sum())))
    log("K1 sweep (device time: CUDA events behind a device-side wait; per "
        "kernel: torch.profiler; N = 1024):\n"
        "     B  prefix   thr    kept   kernel ms   bound ms  by   per kernel")
    for r in rows:
        log(f"  {r['b']:4d}  {r['prefix']:6d}  {r['thr']:4.2f}  "
            f"{r['kept']:6d}  {r['ms']:10.4f}  {r['bound_ms']:9.5f}  "
            f"{r['bound_by'][:3]}  {r['ms_by_kernel']}")
    return rows


def synthetic_presorted(rng, b, n, dev, tie_frac=0.0, all_valid=False):
    """Char-sized class-offset boxes on a 1024x96 canvas, valid prefix."""
    xy = rng.uniform(0, [1024, 96], (b, n, 2))
    wh = rng.uniform([6, 12], [48, 70], (b, n, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    boxes += (rng.uniform(size=(b, n, 1)) < 0.2) * MAX_WH   # class 1
    k = int(n * tie_frac)
    if k:
        boxes[:, 1:k + 1] = boxes[:, :k].copy()
    valid = np.ones((b, n), bool)
    if not all_valid:
        for i in range(b):
            valid[i, int(rng.integers(1, n + 1)):] = False
    return (torch.tensor(boxes, dtype=torch.float32, device=dev),
            torch.tensor(valid, device=dev))


def phase_k1(dev):
    rng = np.random.default_rng(SEED)
    rows = {}
    boxes, valid = synthetic_presorted(rng, 512, 1024, dev, all_valid=True)
    rows["synthetic_512x1024"] = k1_case("synthetic [512,1024] all valid",
                                         boxes, valid, 0.25, timed=True)
    boxes, valid = synthetic_presorted(rng, 64, 300, dev)
    rows["ragged"] = k1_case("ragged N=300", boxes, valid, 0.25)
    boxes, valid = synthetic_presorted(rng, 64, 1024, dev, tie_frac=0.3)
    rows["ties"] = k1_case("tie-heavy", boxes, valid, 0.25)
    n = 384
    chain = torch.tensor(np.stack([np.arange(n) * 2.5, np.zeros(n),
                                   np.arange(n) * 2.5 + 20.0,
                                   np.full(n, 20.0)], 1)[None],
                         dtype=torch.float32, device=dev)
    rows["chain"] = k1_case("cross-tile chain N=384", chain,
                            torch.ones(1, n, dtype=torch.bool, device=dev),
                            0.3)
    # past the earlier one-CTA-per-image design's N cap of 1,280, valid
    # prefixes of mixed length
    for b, n in ((16, 2048), (8, 4096)):
        boxes, valid = synthetic_presorted(rng, b, n, dev)
        for thr in (0.01, 0.25):
            rows[f"n{n}_thr{thr}"] = k1_case(f"N={n} B={b}", boxes, valid,
                                             thr)
    # integer boxes: IoUs equal to the threshold go to the exact division
    xy = rng.integers(0, 6, (8, 300, 2))
    grid = torch.tensor(np.concatenate([xy, xy + rng.integers(1, 5, xy.shape)],
                                       -1), dtype=torch.float32, device=dev)
    rows["near_threshold"] = k1_case(
        "integer grid (IoU == thr)", grid,
        torch.ones(8, 300, dtype=torch.bool, device=dev), 0.25)
    return rows


# ---------------------------------------------------------------- K2
def top1_bound_ms(n, d, mask):
    """Least time for the top-1 on these inputs: queries, prototypes and
    the mask read once, scores and indices written once, against the
    2*D operations of each (query, unmasked prototype) product."""
    c = mask.shape[0]
    t_bytes = ((n + c) * d * 4 + c + n * 8) / HBM_BYTES_S * 1e3
    t_ops = 2.0 * n * int(mask.sum()) * d / F32_OPS_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def top1_library(q, p, mask):
    """One PyTorch computation of the same function: cuBLAS SGEMM, the
    mask, argmax (the yardstick; the port never calls it)."""
    sims = torch.matmul(q, p.t())
    sims = torch.where(mask[None, :], sims, NEG_INF)
    return torch.argmax(sims, dim=1)


def k2_case(name, q, p, mask, exact=False, timed=False, wrapper=False):
    """Kernel vs plain on the card.  Scores within K2_TOL; indices equal
    wherever the plain top-2 margin exceeds K2_TOL (everywhere if
    ``exact``: products exact in float32).  ``wrapper``: through
    ``cuda_top1.top1``, which pads D to a multiple of 4."""
    kernel = cuda_top1.top1 if wrapper else cuda_top1.top1_kernel
    s, i = kernel(q, p, mask)
    rs, ri = top1_plain(q, p, mask)
    torch.cuda.synchronize()
    err = float((s - rs).abs().max())
    diff = i != ri
    if p.shape[0] > 1:
        sims = torch.where(mask[None, :], q @ p.t(), NEG_INF)
        top2 = torch.topk(sims, 2, dim=1).values
        unsure = top2[:, 0] - top2[:, 1] <= K2_TOL
    else:
        unsure = torch.zeros_like(diff)
    n_diff, n_unsure = int(diff.sum()), int(unsure.sum())
    log(f"K2 {name}: queries {tuple(q.shape)} prototypes {tuple(p.shape)} "
        f"masked {int((~mask).sum())}; max|score kernel-plain| {err:.3g}; "
        f"index differs at {n_diff} queries, {n_unsure} queries have a "
        f"plain top-2 margin <= {K2_TOL}")
    if not err <= K2_TOL:
        raise AssertionError(f"K2 {name}: scores differ by {err}")
    if exact and not (torch.equal(i, ri) and torch.equal(s, rs)):
        raise AssertionError(f"K2 {name}: exact case differs")
    if bool((diff & ~unsure).any()):
        raise AssertionError(f"K2 {name}: index differs at a query whose "
                             f"top-2 margin exceeds {K2_TOL}")
    row = {"max_abs_err": err, "index_differs": n_diff,
           "low_margin": n_unsure}
    if timed:
        row["ms"] = device_ms(lambda: kernel(q, p, mask))
        row["ms_by_kernel"] = kernel_split(lambda: kernel(q, p, mask))
        row["plain_ms"] = device_ms(lambda: top1_plain(q, p, mask))
        row["library_ms"] = device_ms(lambda: top1_library(q, p, mask))
        row["bound_ms"], row["bound_by"] = top1_bound_ms(
            q.shape[0], q.shape[1], mask)
        row["splits"] = kernel.splits(q.shape[0], p.shape[0])
        log(f"K2 {name}: {row['splits']} prototype splits; kernel "
            f"{row['ms']:.4f} ms {row['ms_by_kernel']}, plain "
            f"{row['plain_ms']:.4f} ms, library (matmul+mask+argmax) "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
    return row


def unit_rows(rng, n, d, dev):
    x = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                     device=dev)
    return x / x.norm(dim=1, keepdim=True)


def phase_k2(dev):
    rng = np.random.default_rng(SEED + 20)
    rows = {}
    q, p = unit_rows(rng, 4096, 320, dev), unit_rows(rng, 11051, 320, dev)
    mask = torch.tensor(rng.uniform(size=11051) >= 0.01, device=dev)
    rows["synthetic_4096x11051"] = k2_case(
        "synthetic [4096,320]x[11051,320], ~1% masked", q, p, mask,
        timed=True)
    rows["ragged"] = k2_case("ragged C=300, N=1", unit_rows(rng, 1, 320, dev),
                             unit_rows(rng, 300, 320, dev),
                             torch.ones(300, dtype=torch.bool, device=dev))
    # duplicate rows, quarter-step values: exact products, exact ties
    pd = torch.tensor(rng.integers(-2, 3, (3000, 320)) / 4,
                      dtype=torch.float32, device=dev)
    src = torch.tensor(rng.integers(0, 3000, 600), device=dev)
    pd[torch.tensor(rng.integers(0, 3000, 600), device=dev)] = pd[src]
    qd = pd[torch.tensor(rng.integers(0, 3000, 1000), device=dev)].clone()
    rows["duplicates"] = k2_case(
        "duplicate prototypes (tie rule)", qd, pd,
        torch.ones(3000, dtype=torch.bool, device=dev), exact=True)
    # C around one 128-prototype tile, D past the 32-deep ring stages
    for c in (127, 128, 129):
        for d in (4, 324):
            rows[f"c{c}_d{d}"] = k2_case(
                f"ragged C={c} D={d}", unit_rows(rng, 300, d, dev),
                unit_rows(rng, c, d, dev),
                torch.tensor(rng.uniform(size=c) >= 0.1, device=dev))
    # D = 6: the wrapper pads it to 8 (the JAX kernel takes any D)
    rows["d6"] = k2_case("D=6 through the padding wrapper",
                         unit_rows(rng, 700, 6, dev),
                         unit_rows(rng, 1500, 6, dev),
                         torch.tensor(rng.uniform(size=1500) >= 0.05,
                                      device=dev), wrapper=True)
    none = torch.zeros(11051, dtype=torch.bool, device=dev)
    rows["all_masked"] = k2_case("every row masked", q[:300], p, none,
                                 exact=True)
    s, i = cuda_top1.top1_kernel(q[:300], p, none)
    if not (bool((i == 0).all()) and bool((s == NEG_INF).all())):
        raise AssertionError("K2: all-masked queries must give (0, -1e30)")
    return rows


# ------------------------------------------------------------- slice
def write_png(path: str, img: np.ndarray) -> None:
    """8-bit non-interlaced PNG with filter 0 (stdlib zlib): grayscale
    (colour type 0) for [H, W], RGB (colour type 2) for [H, W, 3]."""
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    rows = img.reshape(h, -1)
    raw = np.zeros((h, rows.shape[1] + 1), np.uint8)
    raw[:, 1:] = rows

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def synth_line(rng, n=None) -> np.ndarray:
    """A printed-line-like gray image: dark strokes in glyph boxes, word
    gaps, line heights 36-72 px and ``n`` glyphs (default 4-70: widths
    ~90-3000 px)."""
    h = int(rng.integers(36, 73))
    n = int(rng.integers(4, 71)) if n is None else n
    gw = (h * rng.uniform(0.3, 0.7, n)).astype(int) + 2
    gap = np.where(rng.uniform(size=n) < 0.2, h // 2, max(2, h // 10))
    w = int(gw.sum() + gap.sum()) + 2 * (h // 4)
    img = np.full((h, w), 245, np.uint8)
    x = h // 4
    top, bot = h // 6, h - h // 6
    for g, sp in zip(gw, gap):
        for _ in range(int(rng.integers(2, 5))):
            if rng.uniform() < 0.5:   # vertical stroke
                x0 = x + int(rng.integers(0, max(1, g - 3)))
                img[top:bot, x0:x0 + max(2, h // 12)] = rng.integers(0, 60)
            else:                     # horizontal stroke
                y0 = int(rng.integers(top, bot - 2))
                img[y0:y0 + max(2, h // 14), x:x + g] = rng.integers(0, 60)
        x += int(g + sp)
    return img


def letterboxed(paths, channels, width, height):
    """Decode PNGs and letterbox them to a [N, height, width, C] canvas."""
    from effocr_torch.pipelines.infer import _png_header

    arrs, _ = native.decode_png_batch(
        paths, [_png_header(p)[:2] + (channels,) for p in paths])
    canvas, _, _, _ = native.letterbox_batch(arrs, width, out_h=height)
    return canvas


def scaled_detector(dev, loc, canvas, offsets_by_scale):
    """Activations of the random-init detector shrink layer by layer, so
    its raw outputs barely vary; each detect head's weights are rescaled
    so its outputs have unit spread on ``canvas`` before the bias offsets
    are added."""
    loc = loc.to(dev).eval()
    with torch.no_grad():
        raw = loc(torch.from_numpy(canvas).to(dev).float() / 255.0,
                  decode=False)
        for i, r in enumerate(raw):
            getattr(loc, f"detect{i}").weight /= r.float().std()
        loc = loc.cpu()
        for i, offsets in offsets_by_scale.items():
            bias = getattr(loc, f"detect{i}").bias.view(3, 7)
            for ch, v in offsets.items():   # v: one value or one per anchor
                bias[:, ch] += torch.as_tensor(v, dtype=bias.dtype)
    return loc


def raw_prototypes(n, d, seed):
    """The random rows an index of ``n`` prototypes is made from
    (PrototypeIndex normalizes them)."""
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def make_artifacts(dev, sample_paths):
    """Seeded random-init artifact dirs in the JAX package's format; the
    detect heads scaled on ``sample_paths`` letterboxed at the trained
    96x1024 canvas."""
    loc_dir = os.path.join(WORK, "loc")
    rec_dir = os.path.join(WORK, "rec")
    for d in (loc_dir, rec_dir):
        os.makedirs(d, exist_ok=True)
    shutil.copy(os.path.join(R5, "loc2k", "model.json"), loc_dir)
    shutil.copy(os.path.join(R5, "rec2k_mn_hn", "model.json"), rec_dir)
    with open(os.path.join(loc_dir, "model.json")) as f:
        loc_meta = json.load(f)
    loc = init_params(create_localizer(
        "yolov5s", 2, in_channels=1,
        anchors=tuple(tuple(a) for a in loc_meta["anchors"])), SEED)
    loc = scaled_detector(dev, loc, letterboxed(sample_paths, 1, 1024, 96),
                          DETECT_BIAS)
    write_variables(state_dict_to_flax(loc.state_dict()),
                    os.path.join(loc_dir, "best_bbox_mAP.msgpack"))
    enc = init_params(create_encoder("mobilenetv3_small_050", in_channels=1),
                      SEED + 1)
    write_variables(state_dict_to_flax(enc.state_dict()),
                    os.path.join(rec_dir, "enc_best.msgpack"))
    with open(os.path.join(R5, "rec2k_mn_hn", "ref.txt"), newline="") as f:
        chars = f.read().rstrip("\n").split("\n")
    PrototypeIndex(raw_prototypes(len(chars), 1024, SEED + 2),
                   chars).save(rec_dir)
    shutil.copy(os.path.join(R5, "rec2k_mn_hn", "ref.txt"), rec_dir)
    return loc_dir, rec_dir


def make_lines():
    d = os.path.join(WORK, "lines")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(SEED + 3)
    paths = []
    for i in range(N_LINES):
        p = os.path.join(d, f"{i:05d}.png")
        write_png(p, synth_line(rng))
        paths.append(p)
    return paths


def engine_flags(loc_dir, rec_dir):
    """BENCH_TRAINED.json's infer flags with the artifact dirs swapped."""
    with open(os.path.join(ROOT, "BENCH_TRAINED.json")) as f:
        flags = json.load(f)["flags"]
    swap = {"--localizer_dir": loc_dir, "--recognizer_dir": rec_dir}
    return [swap.get(flags[i - 1], f) if i else f
            for i, f in enumerate(flags)]


def engine_args(loc_dir, rec_dir, *extra):
    import argparse

    p = argparse.ArgumentParser()
    add_engine_args(p)
    # --device: cuda by default
    return p.parse_args(engine_flags(loc_dir, rec_dir) + list(extra))


def timed_run(engine, paths, res0, tag):
    """The timed run of a slice: both kernels' launch counts from 0, the
    stage timer and peak memory from here; its results must be those of
    the warm-up run ``res0``."""
    cuda_nms.nms_kernel.launches = cuda_top1.top1_kernel.launches = 0
    engine.timer.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = engine.run(paths)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = dict(results=results, wall=wall, lines_s=len(paths) / wall,
               k1_launches=cuda_nms.nms_kernel.launches,
               k2_launches=cuda_top1.top1_kernel.launches,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               chunks=-(-len(paths) // engine.config.line_batch),
               dispatches=engine.timer.counts["prep/h2d+dispatch"])
    # a line with chars but no word box reads None (en_postprocess's
    # contract, the JAX package's too); every line gets an entry
    missing = [p for p in paths if p not in results
               or not isinstance(results[p], (str, type(None)))]
    if missing:
        raise AssertionError(f"{tag}: {len(missing)} lines without a "
                             f"result, e.g. {missing[:3]}")
    run["no_words"] = sum(results[p] is None for p in paths)
    if results != res0:
        raise AssertionError(f"{tag}: warm and timed runs decoded "
                             "differently")
    log(f"{tag}: stage split of the timed run (host wall clock; prep/* = "
        "prefetch worker, main/* = consumer):\n" + engine.timer.report())
    return run


def phase_slice(dev, card, out_dir, profile=False):
    t0 = time.perf_counter()
    paths = make_lines()
    loc_dir, rec_dir = make_artifacts(dev, paths[:16])
    log(f"en: artifacts + {len(paths)} line PNGs written in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = load_engine(engine_args(loc_dir, rec_dir))
    c = engine.config
    log(f"en: line_batch {c.line_batch} crop_batch {c.crop_batch} "
        f"encoder_sub_batch {c.encoder_sub_batch} max_det "
        f"{c.localizer.max_det} max_nms {c.localizer.max_nms} nms_kernel "
        f"{c.nms_kernel} (-> {engine._nms_kernel}) out_quant {c.out_quant} "
        f"transfer_bits {c.transfer_bits} canvas {c.localizer.input_size}x"
        f"{c.localizer.input_height} tiers [{c.adaptive_height_floor}, "
        f"{c.adaptive_height_cap}]")
    run = checked_runs(engine, paths, "en")
    log(f"en: example result {os.path.basename(paths[0])} -> "
        f"{run['results'][paths[0]]!r:.60}")
    # the kernel on the first input the main path gave it
    k1_main = k1_case("main-path input", *run["k1_first"], timed=True)
    models_vs_cpu(engine, paths[:2])
    if profile:
        profile_run(engine, paths[:c.line_batch], card, out_dir, "en")
    out = report("en", run, card)
    out.update(k1_main=k1_main, paths=paths, loc_dir=loc_dir,
               rec_dir=rec_dir)
    return out


# ------------------------------------------------------ jp vertical slice
INK = (28, 22, 60)          # dark ink on cream paper, RGB
PAPER = (246, 240, 226)


def synth_vline(rng) -> np.ndarray:
    """A vertical printed-line-like RGB image: widths 40-64 px, heights
    300-1600 px, glyph-like groups of 2-5 strokes stacked top to bottom
    with small gaps (and a wider one now and then)."""
    w = int(rng.integers(40, 65))
    h = int(rng.integers(300, 1601))
    img = np.empty((h, w, 3), np.uint8)
    img[:] = PAPER
    left, right = w // 8, w - w // 8
    y = w // 4
    while True:
        g = int(w * rng.uniform(0.6, 0.9))
        if y + g > h - w // 4:
            break
        for _ in range(int(rng.integers(2, 6))):
            tone = rng.integers(0, 50)
            color = np.clip(np.asarray(INK) + tone, 0, 255).astype(np.uint8)
            if rng.uniform() < 0.5:   # vertical stroke
                x0 = int(rng.integers(left, max(left + 1, right - 3)))
                img[y:y + g, x0:x0 + max(2, w // 12)] = color
            else:                     # horizontal stroke
                y0 = y + int(rng.integers(0, max(1, g - 2)))
                img[y0:y0 + max(2, w // 14), left:right] = color
        y += g + (w // 2 if rng.uniform() < 0.1 else max(3, w // 8))
    return img


def make_vlines():
    d = os.path.join(WORK, "vlines")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(SEED + 13)
    paths = []
    for i in range(N_JP_LINES):
        p = os.path.join(d, f"{i:05d}.png")
        write_png(p, synth_vline(rng))
        paths.append(p)
    return paths


def make_jp_artifacts(dev, sample_paths):
    """Seeded random-init jp artifact dirs: yolov5n (loc_vert model.json,
    default anchors) with its detect heads scaled on ``sample_paths``
    letterboxed at the trained 96-wide, 640-tall canvas; convnext_atto
    (rec_knn6k3 model.json) with LayerScale ``gamma`` drawn from U(0.5,
    1.5) instead of Flax's 1e-6, so no block is near the identity; 11,051
    random unit prototypes of width 320 with rec_knn6k3's ref.txt."""
    loc_dir = os.path.join(WORK, "jp_loc")
    rec_dir = os.path.join(WORK, "jp_rec")
    for d in (loc_dir, rec_dir):
        os.makedirs(d, exist_ok=True)
    shutil.copy(os.path.join(R5, "loc_vert", "model.json"), loc_dir)
    shutil.copy(os.path.join(R5, "rec_knn6k3", "model.json"), rec_dir)
    loc = init_params(create_localizer("yolov5n", 2, in_channels=3),
                      SEED + 10)
    loc = scaled_detector(dev, loc, letterboxed(sample_paths, 3, 96, 640),
                          JP_DETECT_BIAS)
    write_variables(state_dict_to_flax(loc.state_dict()),
                    os.path.join(loc_dir, "best_bbox_mAP.msgpack"))
    enc = init_params(create_encoder("convnext_atto", in_channels=3),
                      SEED + 11)
    g = torch.Generator().manual_seed(SEED + 12)
    with torch.no_grad():
        for name, prm in enc.named_parameters():
            if name.endswith("gamma"):
                prm.copy_(0.5 + torch.rand(prm.shape, generator=g))
    write_variables(state_dict_to_flax(enc.state_dict()),
                    os.path.join(rec_dir, "enc_best.msgpack"))
    with open(os.path.join(R5, "rec_knn6k3", "ref.txt"), newline="") as f:
        chars = f.read().split("\n")     # no trailing newline: 11,051 rows
    PrototypeIndex(raw_prototypes(len(chars), 320, SEED + 14),
                   chars).save(rec_dir)
    shutil.copy(os.path.join(R5, "rec_knn6k3", "ref.txt"), rec_dir)
    return loc_dir, rec_dir


def jp_engine_args(loc_dir, rec_dir, *extra):
    """The jp_v3 benchmark's flag list, artifact paths swapped."""
    import argparse

    with open(os.path.join(ROOT, "bench_results", "r5",
                           "jp_v3.result.json")) as f:
        flags = json.load(f)["flags"]
    swap = {"--localizer_dir": loc_dir, "--recognizer_dir": rec_dir}
    flags = [swap.get(flags[i - 1], f) if i else f
             for i, f in enumerate(flags)]
    p = argparse.ArgumentParser()
    add_engine_args(p)
    return p.parse_args(flags + list(extra))   # --device: cuda by default


class Top1Check:
    """Stands in for cuda_top1.top1_kernel during one run: launches the
    kernel, keeps the first input of the path, and holds each result
    against top1_plain on the same queries."""

    def __init__(self, kernel, tag="jp"):
        self.kernel, self.tag = kernel, tag
        self.first = None
        self.calls = self.slots = self.differs = self.low_margin = 0
        self.max_err = 0.0

    def __call__(self, q, p, mask):
        s, i = self.kernel(q, p, mask)
        if self.first is None:
            self.first = (q.clone(), p, mask.clone())
        rs, ri = top1_plain(q, p, mask)
        sims = torch.where(mask[None, :], q @ p.t(), NEG_INF)
        top2 = torch.topk(sims, 2, dim=1).values
        unsure = top2[:, 0] - top2[:, 1] <= K2_TOL
        diff = i != ri
        if bool((diff & ~unsure).any()):
            raise AssertionError(f"K2 on the {self.tag} path: index differs "
                                 f"from top1_plain at a margin above "
                                 f"{K2_TOL}")
        self.calls += 1
        self.slots += q.shape[0]
        self.differs += int(diff.sum())
        self.low_margin += int(unsure.sum())
        self.max_err = max(self.max_err, float((s - rs).abs().max()))
        return s, i


def phase_jp(dev, card, out_dir, profile=False):
    t0 = time.perf_counter()
    paths = make_vlines()
    loc_dir, rec_dir = make_jp_artifacts(dev, paths[:16])
    log(f"jp: artifacts + {len(paths)} RGB vertical line PNGs written in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = load_engine(jp_engine_args(loc_dir, rec_dir,
                                        "--nms_kernel", "pallas"))
    c = engine.config
    log(f"jp: lang {c.lang} vertical {c.vertical} line_batch {c.line_batch}"
        f" crop_batch {c.crop_batch} max_det {c.localizer.max_det} max_nms "
        f"{c.localizer.max_nms} iou {c.localizer.iou_thresh} conf "
        f"{c.localizer.conf_thresh} nms_kernel {c.nms_kernel} (-> "
        f"{engine._nms_kernel}) retrieval_kernel {c.retrieval_kernel} "
        f"(top-1 kernel: {engine._top1}) out_quant {c.out_quant} "
        f"transfer_bits {c.transfer_bits} canvas {c.localizer.input_size} "
        f"wide x {c.localizer.input_height} tall, {c.input_channels} "
        f"channels, crop_geometry {c.crop_geometry}, {len(engine.index)} "
        "prototypes")
    run = checked_runs(engine, paths, "jp", k2=True)
    log(f"jp: example result {os.path.basename(paths[0])} -> "
        f"{run['results'][paths[0]]!r:.30}")
    # the kernels on the first inputs this path gave them
    k1_main = k1_case("jp main-path input", *run["k1_first"], timed=True)
    k2_main = k2_case("jp main-path input", *run["k2_first"], timed=True)
    k2_main["engine_differs"] = run["k2_differs"]
    k2_main["engine_low_margin"] = run["k2_low_margin"]
    k2_main["max_abs_err"] = max(k2_main["max_abs_err"], run["k2_max_err"])
    models_vs_cpu(engine, paths[:2])
    if profile:
        profile_run(engine, paths[:c.line_batch], card, out_dir, "jp")
    out = report("jp", run, card)
    out.update(k1_main=k1_main, k2_main=k2_main, paths=paths,
               loc_dir=loc_dir, rec_dir=rec_dir)
    return out


# ------------------------------------------ the other single-card paths
class NmsCheck:
    """Stands in for cuda_nms.nms_kernel during one run: launches the
    kernel, keeps the first input of the path, and holds every keep mask
    bit for bit against nms_mask on the same inputs.  With ``defer`` it
    keeps a device copy of each call's inputs and mask instead, and
    ``verify`` checks them after the run: no host sync inside the run,
    which a training phase times."""

    def __init__(self, kernel, tag, defer=False):
        self.kernel, self.tag, self.defer = kernel, tag, defer
        self.first = None
        self.calls = self.boxes = 0
        self.pending = []
        # launch sites told apart by threshold (the R-CNN path has two:
        # its RPN at IoU 0.7 and the decode's NMS): calls and first input
        self.by_thr, self.first_by_thr = {}, {}

    def __call__(self, boxes, valid, thr):
        keep = self.kernel(boxes, valid, thr)
        if self.first is None:
            self.first = (boxes.clone(), valid.clone(), thr)
        if thr not in self.first_by_thr:
            self.first_by_thr[thr] = (boxes.clone(), valid.clone(), thr)
        self.calls += 1
        self.by_thr[thr] = self.by_thr.get(thr, 0) + 1
        if self.defer:
            self.pending.append((boxes.clone(), valid.clone(), thr,
                                 keep.clone()))
        else:
            self._check(boxes, valid, thr, keep)
        return keep

    def _check(self, boxes, valid, thr, keep):
        if not torch.equal(keep, nms_mask(boxes, None, valid, thr,
                                          presorted=True)):
            raise AssertionError(f"K1 on the {self.tag} path: keep mask "
                                 "differs from nms_mask")
        self.boxes += int(valid.sum())

    def verify(self):
        """The deferred checks; returns the number of calls checked."""
        for case in self.pending:
            self._check(*case)
        n, self.pending = len(self.pending), []
        return n


@contextlib.contextmanager
def kernels_checked(tag, k2=False, defer=False):
    """K1 (and K2, when ``k2``) held against the plain versions on every
    call made inside the block (K1's checks after it, with ``defer``:
    ``NmsCheck.verify``); yields the two checks."""
    nms, top1 = cuda_nms.nms_kernel, cuda_top1.top1_kernel
    k1c, k2c = NmsCheck(nms, tag, defer), Top1Check(top1, tag)
    cuda_nms.nms_kernel = k1c
    if k2:
        cuda_top1.top1_kernel = k2c
    try:
        yield k1c, k2c
    finally:
        cuda_nms.nms_kernel, cuda_top1.top1_kernel = nms, top1


def nms_plain(boxes, valid, thr):
    """Stands in for cuda_nms.nms_kernel: nms_mask on the same inputs."""
    return nms_mask(boxes, None, valid, thr, presorted=True)


@contextlib.contextmanager
def plain_kernels(engine):
    """``engine`` on plain NMS and top1_plain inside the block: the
    engine's decode takes nms_mask, and every call that reaches
    cuda_nms.nms_kernel (an R-CNN's RPN) gets ``nms_plain``."""
    saved, nms, top1 = (engine._nms_kernel, cuda_nms.nms_kernel,
                        cuda_top1.top1_kernel)
    engine._nms_kernel, cuda_nms.nms_kernel = "plain", nms_plain
    cuda_top1.top1_kernel = top1_plain
    try:
        yield
    finally:
        engine._nms_kernel, cuda_nms.nms_kernel = saved, nms
        cuda_top1.top1_kernel = top1


def checked_runs(engine, paths, tag, k2=False, plain=True):
    """A warm-up run with K1 (and K2, when the path reaches it) held
    against the plain versions on every call, then the timed run
    (``timed_run``).  Then (``plain``) the same engine with plain NMS and
    top1_plain: its text must be identical apart from lines holding a
    slot where K2's index differed at a low margin."""
    t0 = time.perf_counter()
    with kernels_checked(tag, k2) as (k1c, k2c):
        res0, coco = engine.run(paths, return_coco=True)
    torch.cuda.synchronize()
    if k1c.calls == 0 or (k2 and k2c.calls == 0):
        raise AssertionError(f"{tag}: the warm-up run reached K1 "
                             f"{k1c.calls} and K2 {k2c.calls} times")
    log(f"{tag}: warm-up run {time.perf_counter() - t0:.2f} s; K1 held bit "
        f"for bit against nms_mask on {k1c.calls} calls ({k1c.boxes} valid "
        "boxes)" + (f"; K2 against top1_plain on {k2c.calls} calls, "
                    f"{k2c.slots} slots: index differs at {k2c.differs}, "
                    f"all within the {k2c.low_margin} slots whose plain "
                    f"top-2 margin is <= {K2_TOL}; max|score diff| "
                    f"{k2c.max_err:.3g}" if k2 else ""))
    run = timed_run(engine, paths, res0, tag)
    if run["k1_launches"] == 0 or (k2 and run["k2_launches"] == 0):
        raise AssertionError(f"{tag}: the timed run launched K1 "
                             f"{run['k1_launches']} and K2 "
                             f"{run['k2_launches']} times")
    n_diff = None
    if plain:
        with plain_kernels(engine):
            ref = engine.run(paths)
        n_diff = sum(ref[p] != run["results"][p] for p in ref)
    if plain and (set(ref) != set(run["results"]) or n_diff > k2c.differs):
        raise AssertionError(f"{tag}: {n_diff} lines differ with plain NMS "
                             f"and top1_plain ({k2c.differs} low-margin "
                             "index differences allow that many)")
    chars = [len(c) for c in _chars_per_line(coco)]
    run.update(mean_chars=float(np.mean(chars)), max_chars=max(chars),
               spilled=run["dispatches"] - run["chunks"],
               k1_checked=k1c.calls, plain_lines_differ=n_diff,
               k2_differs=k2c.differs, k2_low_margin=k2c.low_margin,
               k2_max_err=k2c.max_err, n_lines=len(paths),
               k1_calls_by_iou=k1c.by_thr, k1_first=k1c.first,
               k1_first_by_iou=k1c.first_by_thr, k2_first=k2c.first)
    return run


def report(tag, run, card, extra=""):
    log(f"{tag}: {run['n_lines']} lines in {run['wall']:.3f} s = "
        f"{run['lines_s']:.1f} lines/s ({card}); mean chars/line "
        f"{run['mean_chars']:.1f} (max {run['max_chars']}); "
        f"{run['dispatches']} dispatches for {run['chunks']} chunks "
        f"({run['spilled']} spilled); {run['no_words']} lines read None "
        f"(chars, no word box); K1 launches {run['k1_launches']}, K2 "
        f"launches {run['k2_launches']}; "
        + (f"{run['plain_lines_differ']} lines differ with plain NMS + "
           "top1_plain" if run["plain_lines_differ"] is not None
           else "no run on plain NMS")
        + f"; peak device memory "
        f"{run['peak_gib']:.2f} GiB{extra}")
    return {k: v for k, v in run.items()
            if k not in ("results", "k1_first", "k1_first_by_iou",
                         "k2_first")}


# the square canvas: the JAX default localizer (640 x 640, no
# input_height) with crop_window 256, so crops take the 2-D window;
# line_batch x max_det crop slots, so no chunk spills
SQUARE_FLAGS = ["--lang", "en", "--localizer_conf_thresh", "0.3",
                "--localizer_iou_thresh", "0.25", "--line_batch", "128",
                "--crop_batch", "12288", "--encoder_sub_batch", "2048",
                "--max_det", "96", "--max_words", "16", "--out_quant", "u16",
                "--transfer_bits", "4", "--nms_kernel", "pallas",
                "--retrieval_kernel", "pallas"]
N_SQUARE = 512


def phase_square(dev, card, paths, rec_dir, out_dir, profile=False):
    """The en models on the square 640 canvas: a localizer dir whose
    model.json has input_size 640 and no input_height (yolov5s, its heads
    scaled on the square canvas), the en recognizer."""
    import argparse

    loc_dir = os.path.join(WORK, "sq_loc")
    os.makedirs(loc_dir, exist_ok=True)
    with open(os.path.join(R5, "loc2k", "model.json")) as f:
        meta = json.load(f)
    meta = {k: meta[k] for k in ("arch", "num_classes", "input_channels",
                                 "anchors")}
    meta["input_size"] = 640
    with open(os.path.join(loc_dir, "model.json"), "w") as f:
        json.dump(meta, f)
    loc = init_params(create_localizer(
        "yolov5s", 2, in_channels=1,
        anchors=tuple(tuple(a) for a in meta["anchors"])), SEED + 30)
    loc = scaled_detector(dev, loc, letterboxed(paths[:16], 1, 640, 640),
                          SQUARE_DETECT_BIAS)
    write_variables(state_dict_to_flax(loc.state_dict()),
                    os.path.join(loc_dir, "best_bbox_mAP.msgpack"))
    p = argparse.ArgumentParser()
    add_engine_args(p)
    engine = load_engine(p.parse_args(
        ["--localizer_dir", loc_dir, "--recognizer_dir", rec_dir]
        + SQUARE_FLAGS))
    c = engine.config
    if c.localizer.input_height is not None or not (
            c.localizer.input_size > c.crop_window):
        raise AssertionError("square: the canvas does not take the 2-D "
                             "window")
    log(f"square: canvas {c.localizer.input_size} x {c.localizer.input_size}"
        f", crop_window {c.crop_window}, line_batch {c.line_batch}, "
        f"crop_batch {c.crop_batch}, encoder_sub_batch "
        f"{c.encoder_sub_batch}, nms {engine._nms_kernel}, top-1 kernel "
        f"{engine._top1}")
    run = checked_runs(engine, paths[:N_SQUARE], "square", k2=True)
    if profile:
        profile_run(engine, paths[:c.line_batch], card, out_dir, "square")
    return report("square", run, card)


N_ORIGINAL = 240


def phase_original(dev, card, vpaths, loc_dir, rec_dir):
    """crop_source original on the jp artifacts (3 channels) with the jp_v3
    flags + the NMS kernel: detect program, host crops from the original
    images, the recognize program through K2."""
    engine = load_engine(jp_engine_args(loc_dir, rec_dir, "--nms_kernel",
                                        "pallas", "--crop_source",
                                        "original"))
    c = engine.config
    log(f"original: crop_source {c.crop_source}, crop_geometry "
        f"{c.crop_geometry}, line_batch {c.line_batch}, crop_batch "
        f"{c.crop_batch}, canvas {c.localizer.input_size} wide x "
        f"{c.localizer.input_height} tall (8-bit: transfer_bits does not "
        "apply)")
    t0 = time.perf_counter()
    run = checked_runs(engine, vpaths[:N_ORIGINAL], "original", k2=True)
    return report("original", run, card,
                  f"; stage split of the timed run in the log above; phase "
                  f"{time.perf_counter() - t0:.1f} s")


N_WIDE = 32


def make_wide_lines():
    """Synthetic gray lines 6,000-8,000 px wide (cut to a drawn width)."""
    d = os.path.join(WORK, "wide")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(SEED + 33)
    paths = []
    for i in range(N_WIDE):
        target = int(rng.integers(6000, 8001))
        img = synth_line(rng, n=400)      # >= ~10,000 px at any height
        p = os.path.join(d, f"{i:05d}.png")
        write_png(p, img[:, :target])
        paths.append(p)
    return paths


def phase_tiling(dev, card, loc_dir, rec_dir):
    """BENCH_TRAINED.json's flags + --tile_min_h 24 on lines 6,000-8,000
    px wide: each letterboxes below 24 px of content height on the
    1024-wide canvas, so it rides the pipeline as overlapping tiles."""
    from effocr_torch.pipelines.infer import _png_header
    from effocr_torch.pipelines.tiling import plan_tiles

    paths = make_wide_lines()
    engine = load_engine(engine_args(loc_dir, rec_dir, "--tile_min_h", "24"))
    c = engine.config
    cap_h = c.localizer.input_height or c.localizer.input_size
    tiles = []
    for p in paths:
        h, w = _png_header(p)[:2]
        plan = plan_tiles(w, h, c.localizer.input_size, cap_h,
                          c.tile_min_content_h, c.tile_overlap_factor)
        tiles.append(len(plan) if plan else 1)
    if min(tiles) < 2:
        raise AssertionError("tiling: a wide line was not tiled")
    log(f"tiling: {len(paths)} lines, {sum(tiles)} tiles (per line "
        f"{min(tiles)}-{max(tiles)}), tile_min_content_h "
        f"{c.tile_min_content_h}")
    run = checked_runs(engine, paths, "tiling")
    out = report("tiling", run, card, f"; {sum(tiles)} tiles")
    out["tiles"] = sum(tiles)
    return out


N_BUCKET = 512


def phase_bucket(dev, card, paths, loc_dir, rec_dir):
    """The en engine with transfer "bucket", bucket_hw (64, 1024): lines
    ship at raw size in the bucket (those larger first letterboxed into
    it on the host) and the device letterboxes them onto the canvas.  The
    JAX CLI has no flag for it; the engine takes it from the config."""
    import dataclasses

    from effocr_torch.pipelines.infer import EffOCRInference, _png_header

    base = load_engine(engine_args(loc_dir, rec_dir))
    cfg = dataclasses.replace(base.config, transfer="bucket",
                              bucket_hw=(64, 1024))
    engine = EffOCRInference(cfg, base.localizer, base.encoder, base.index,
                             device=dev)
    paths = paths[:N_BUCKET]
    big = sum(1 for p in paths
              if _png_header(p)[0] > 64 or _png_header(p)[1] > 1024)
    if not 0 < big < len(paths):
        raise AssertionError(f"bucket: {big} of {len(paths)} lines exceed "
                             "the bucket")
    log(f"bucket: bucket_hw {cfg.bucket_hw}, {big} of {len(paths)} lines "
        "larger than the bucket (host pre-resize)")
    run = checked_runs(engine, paths, "bucket")
    out = report("bucket", run, card, f"; {big} lines past the bucket")
    out["past_bucket"] = big
    return out


N_CLASSIFIER = 256


def phase_classifier(dev, card, paths, loc_dir):
    """Classifier mode: mobilenetv3_small_050 + a 90-class float32 head
    (seeded), a class_map.json made from the en ref.txt, and the en
    localizer with BENCH_TRAINED.json's flags."""
    cls_dir = os.path.join(WORK, "cls_rec")
    os.makedirs(cls_dir, exist_ok=True)
    with open(os.path.join(R5, "rec2k_mn_hn", "model.json")) as f:
        meta = json.load(f)
    with open(os.path.join(R5, "rec2k_mn_hn", "ref.txt"), newline="") as f:
        chars = f.read().rstrip("\n").split("\n")
    meta["num_classes"] = len(chars)
    with open(os.path.join(cls_dir, "model.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(cls_dir, "class_map.json"), "w") as f:
        json.dump({str(i): ch for i, ch in enumerate(chars)}, f)
    cls = init_params(create_classifier("mobilenetv3_small_050", len(chars),
                                        in_channels=1), SEED + 40)
    write_variables(state_dict_to_flax(cls.state_dict()),
                    os.path.join(cls_dir, "enc_best.msgpack"))
    engine = load_engine(engine_args(loc_dir, cls_dir))
    if not engine.classifier_mode:
        raise AssertionError("classifier: the engine is not in classifier "
                             "mode")
    run = checked_runs(engine, paths[:N_CLASSIFIER], "classifier")
    known = set("".join(chars)) | {" "}
    bad = [t for t in run["results"].values() if t and set(t) - known]
    if bad:
        raise AssertionError(f"classifier: text outside the class map, "
                             f"e.g. {bad[:2]}")
    return report("classifier", run, card, f"; {len(chars)} classes")


N_SERVE = 128
SERVE_BATCH = 64


def phase_serve(dev, card, paths, loc_dir, rec_dir):
    """``python -m effocr_torch serve --stdin --device cuda --spell_check``
    with BENCH_TRAINED.json's flags, --line_batch 64 --max_latency_ms 50,
    in a subprocess fed N_SERVE paths in two waves: one batch, whose
    answers are awaited (the process's first batch pays its CUDA library
    start-up), then the rest at once, timed from the write to the last
    answer.  The server logs each batch it cut.  Over those same batches
    an in-process engine with the same flags runs once with K1 held bit
    for bit against nms_mask on every call (the inputs the served batches
    gave K1) and once on plain NMS; the served answers must equal both.
    These flags do not reach K2."""
    import argparse
    import threading

    with open(os.path.join(ROOT, "BENCH_TRAINED.json")) as f:
        flags = json.load(f)["flags"]
    swap = {"--localizer_dir": loc_dir, "--recognizer_dir": rec_dir}
    flags = [swap.get(flags[i - 1], f) if i else f
             for i, f in enumerate(flags)]
    flags += ["--spell_check", "--line_batch", str(SERVE_BATCH)]
    paths = paths[:N_SERVE]
    err_path = os.path.join(WORK, "serve_stderr.txt")
    answers = []
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "effocr_torch", "serve", "--stdin",
             "--device", "cuda", "--max_latency_ms", "50", *flags],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
            cwd=ROOT, text=True)
        watchdog = threading.Timer(300, proc.kill)
        watchdog.start()
        try:
            def send(batch):
                proc.stdin.write("\n".join(batch) + "\n")
                proc.stdin.flush()

            def receive(n):
                while n:
                    line = proc.stdout.readline()
                    if not line:
                        raise AssertionError("serve: stdout closed after "
                                             f"{len(answers)} answers")
                    if line.startswith("{"):
                        answers.append(json.loads(line))
                        n -= 1

            send(paths[:SERVE_BATCH])
            receive(SERVE_BATCH)
            first_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            send(paths[SERVE_BATCH:])
            proc.stdin.close()
            receive(len(paths) - SERVE_BATCH)
            warm_s = time.perf_counter() - t1
            proc.stdout.read()
            rc = proc.wait()
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    with open(err_path) as f:
        stderr = f.read()
    if rc != 0:
        raise AssertionError(f"serve exited {rc}: {stderr[-2000:]}")
    stats = [ln for ln in stderr.splitlines() if ln.startswith(
        ("served ", "serve: kernel launches"))]
    k1 = int(stats[-1].split("nms ")[1].split(",")[0])
    k2 = int(stats[-1].split("top1 ")[1])
    batches = [int(ln.rsplit(" ", 1)[1]) for ln in stderr.splitlines()
               if ln.startswith("serve: batch of ")]
    if sum(batches) != len(paths):
        raise AssertionError(f"serve: logged batches {batches} do not cover "
                             f"the {len(paths)} paths")
    if [a["path"] for a in answers] != paths:
        raise AssertionError(f"serve: {len(answers)} answers, not one per "
                             "path in order")
    p = argparse.ArgumentParser()
    add_engine_args(p)
    engine = load_engine(p.parse_args(flags))

    def over_batches():
        out, s = {}, 0
        for n in batches:
            out.update(engine.run(paths[s:s + n]))
            s += n
        return out

    with kernels_checked("serve") as (k1c, _):
        ref = over_batches()
    if k1c.calls == 0:
        raise AssertionError("serve: the in-process reference never "
                             "reached K1")
    with plain_kernels(engine):
        plain = over_batches()
    n_diff = sum(a["text"] != ref[a["path"]] for a in answers)
    n_plain = sum(a["text"] != plain[a["path"]] for a in answers)
    if n_diff or n_plain:
        raise AssertionError(f"serve: {n_diff} answers differ from "
                             f"engine.run, {n_plain} from engine.run on "
                             "plain NMS")
    if k1 == 0:
        raise AssertionError("serve: the server launched K1 0 times")
    lines_s = (len(paths) - SERVE_BATCH) / warm_s
    log(f"serve: {len(answers)} answers identical to engine.run (K1 held "
        f"bit for bit against nms_mask on {k1c.calls} calls, "
        f"{k1c.boxes} valid boxes) and to engine.run on plain NMS, over "
        f"the server's batches {batches}; second wave "
        f"{len(paths) - SERVE_BATCH} lines in {warm_s:.3f} s = "
        f"{lines_s:.1f} lines/s (write to last answer); first wave "
        f"{SERVE_BATCH} lines answered {first_s:.1f} s after start-up "
        f"began; {stats[0]} (serve_loop's clock, both waves); process "
        f"wall {wall:.1f} s; K1 launches {k1}, K2 launches {k2} ({card})")
    return dict(n_lines=len(answers), lines_s=lines_s, warm_wave_s=warm_s,
                first_wave_s=first_s, process_wall=wall, k1_launches=k1,
                k2_launches=k2, answers_differ=n_diff,
                plain_answers_differ=n_plain, batches=batches,
                k1_checked=k1c.calls)


# ------------------------------------------------------------ png (R1)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def write_png_any(path, px, depth, color_type, interlace=0, palette=None,
                  trns=None, row_filter=None):
    """A PNG of samples px [H, W, spp] at any bit depth and colour type
    (stdlib zlib): row k under filter k % 5 (every row under
    ``row_filter`` when given), Adam7 when ``interlace``."""
    spp = px.shape[2]
    bpp = max(1, depth * spp // 8)

    def pack(sub):
        h = sub.shape[0]
        if depth == 16:
            return sub.astype(">u2").reshape(h, -1).view(np.uint8)
        v = sub.reshape(h, -1).astype(np.uint8)
        if depth == 8:
            return v
        per = 8 // depth
        v = np.concatenate([v, np.zeros((h, (-v.shape[1]) % per),
                                        np.uint8)], 1)
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        return (v.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)

    def filtered(rows):
        out, prev = [], np.zeros(rows.shape[1], np.int32)
        for k, r in enumerate(rows.astype(np.int32)):
            ft = k % 5 if row_filter is None else row_filter
            a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])[:len(r)]
            c = np.concatenate([np.zeros(bpp, np.int32),
                                prev[:-bpp]])[:len(r)]
            b = prev
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred = [0, a, b, (a + b) // 2,
                    np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, b, c))][ft]
            out.append(bytes([ft]) + ((r - pred) & 255).astype(
                np.uint8).tobytes())
            prev = r
        return b"".join(out)

    if interlace:
        raw = b"".join(filtered(pack(px[y0::dy, x0::dx]))
                       for x0, y0, dx, dy in _ADAM7
                       if px[y0::dy, x0::dx].size)
    else:
        raw = filtered(pack(px))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", px.shape[1], px.shape[0],
                                      depth, color_type, 0, 0, interlace))
    if palette is not None:
        body += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        body += chunk(b"tRNS", trns)
    body += chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body)


def phase_png(dev, card, loc_dir, rec_dir):
    """R1 on the machine without PIL: a 4-bit palette PNG with tRNS, an
    RGBA, a 16-bit gray and an Adam7-interlaced RGB PNG, written from
    known line-like pixels, read back by data/png.py and by the engine's
    _LazyImage (both pipelines) and held to Pillow's conversion rules
    (palette lookup, alpha dropped, 16-bit gray clipped to 255); then the
    en engine reads the four files, K1 held bit for bit against
    nms_mask."""
    from effocr_torch.data import png
    from effocr_torch.pipelines.infer import _LazyImage

    d = os.path.join(WORK, "png")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(SEED + 50)
    cases = []
    base = synth_line(rng, n=20)
    pal = np.stack([np.linspace(0, 255, 16), np.linspace(40, 255, 16),
                    np.linspace(0, 230, 16)], 1).astype(np.uint8)
    idx = (base.astype(np.int32) * 15 + 127) // 255
    cases.append(("palette4_trns", dict(px=idx[..., None], depth=4,
                                        color_type=3, palette=pal,
                                        trns=bytes(range(0, 256, 32))),
                  pal[idx]))
    base = synth_line(rng, n=20)
    rgba = np.stack([base, 255 - (255 - base) // 2, base // 2 + 100,
                     rng.integers(0, 256, base.shape)], -1).astype(np.uint8)
    cases.append(("rgba8", dict(px=rgba, depth=8, color_type=6),
                  rgba[..., :3]))
    base = synth_line(rng, n=20)
    g16 = np.where(base > 200, rng.integers(256, 65536, base.shape),
                   base).astype(np.uint16)
    cases.append(("gray16", dict(px=g16[..., None], depth=16, color_type=0),
                  np.repeat(np.minimum(g16, 255)[..., None], 3,
                            -1).astype(np.uint8)))
    base = synth_line(rng, n=20)
    rgb = np.stack([base, 255 - (255 - base) // 2, base], -1).astype(
        np.uint8)
    cases.append(("adam7_rgb8", dict(px=rgb, depth=8, color_type=2,
                                     interlace=1), rgb))
    paths = []
    for name, kw, expect in cases:
        p = os.path.join(d, f"{name}.png")
        write_png_any(p, **kw)
        gray = (expect.astype(np.uint16).sum(-1, keepdims=True) // 3).astype(
            np.uint8)
        checks = {
            "read_png rgb": (png.read_png(p, 3), expect),
            "read_png gray": (png.read_png(p, 1), gray),
            "_LazyImage rgb": (_LazyImage(p, gray=False).load(), expect),
            # the JAX package's rule: 3 channels unless native or 8-bit
            # gray; the gray pipeline averages them downstream
            "_LazyImage gray": (_LazyImage(p, gray=True).load(), expect),
        }
        for what, (got, want) in checks.items():
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"png {name}: {what} differs from the "
                                     "pixels written (Pillow's rules)")
        log(f"png: {name} {expect.shape[1]}x{expect.shape[0]}: read_png "
            "(rgb, gray) and _LazyImage (rgb, gray pipeline) equal the "
            "pixels written under Pillow's rules")
        paths.append(p)
    page_ms = page_reads(d, rng, card)
    engine = load_engine(engine_args(loc_dir, rec_dir))
    cuda_nms.nms_kernel.launches = cuda_top1.top1_kernel.launches = 0
    with kernels_checked("png") as (k1c, _):
        res = engine.run(paths)
    k1 = cuda_nms.nms_kernel.launches
    if set(res) != set(paths) or k1c.calls == 0 or k1 == 0:
        raise AssertionError(f"png: {len(res)} results, K1 checked "
                             f"{k1c.calls} times, launched {k1}")
    log(f"png: the en engine read the 4 files ({k1c.calls} K1 calls held "
        f"bit for bit against nms_mask); e.g. {res[paths[2]]!r:.40} "
        f"({card})")
    return dict(k1_launches=k1, k2_launches=cuda_top1.top1_kernel.launches,
                files=[os.path.basename(p) for p in paths],
                page_read_ms=page_ms)


def page_reads(d, rng, card):
    """Host time of data/png.py on page-sized scans (US letter at 300 dpi,
    3300 x 2550) with every row Paeth-filtered, as libpng and Pillow
    usually write them: an RGBA 8-bit and a 16-bit gray page, each read
    back as RGB and held to Pillow's rules.  Best of 3 reads, ms."""
    from effocr_torch.data import png

    h, w = 3300, 2550
    page = (245 - rng.integers(0, 12, (h, w))).astype(np.uint8)
    for y in range(150, h - 150, 60):         # text-like dark rows
        cols = rng.random(w) < 0.3
        page[y:y + 30, cols] = rng.integers(0, 60, (30, int(cols.sum())))
    alpha = np.full((h, w), 255, np.uint8)
    g16 = page.astype(np.uint16) * 257
    cases = {
        "page_rgba8": (dict(px=np.stack([page, page, page // 2 + 100,
                                         alpha], -1), depth=8,
                            color_type=6),
                       np.stack([page, page, page // 2 + 100], -1)),
        "page_gray16": (dict(px=g16[..., None], depth=16, color_type=0),
                        np.repeat(np.minimum(g16, 255).astype(np.uint8)[
                            ..., None], 3, -1)),
    }
    out = {}
    for name, (kw, expect) in cases.items():
        p = os.path.join(d, f"{name}.png")
        write_png_any(p, row_filter=4, **kw)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = png.read_png(p, 3)
            times.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(got, expect):
            raise AssertionError(f"png {name}: read_png differs from the "
                                 "pixels written (Pillow's rules)")
        out[name] = min(times)
        log(f"png: {name} {w}x{h}, every row Paeth: read_png {min(times):.1f}"
            f" ms (best of 3; host CPU of the card's machine, {card}); "
            "pixels equal Pillow's rules")
    return out


# ---------------------------------------------------------- training
# the en recognizer recipe of scripts/rebuild_r5.sh:53-60, at full width;
# depth cut to 2 epochs (of 16)
TRAIN_FLAGS = ["--lang", "en", "--auto_model", "mobilenetv3_small_050",
               "--imsize", "128", "--input_channels", "1", "--batch_size",
               "128", "--lr", "1e-3", "--lr_schedule", "cosine",
               "--warmup_frac", "0.05", "--aux_ce_weight", "1.0",
               "--ref_source", "centroid", "--num_epochs", "2",
               "--num_passes", "20", "--paired_jitter", "0.1",
               "--infer_hardneg_k", "8", "--data_device", "resident",
               "--test_at_end"]
SPLIT_STEMS = {"train": [f"tr{k}" for k in range(4)],
               "val": ["va0", "va1"], "test": ["te0", "te1"]}
N_TRAIN_LINES = 512
N_ADHOC_LINES = 256


def synth_glyph(rng, h=44) -> np.ndarray:
    """A glyph-like gray image h tall: 2-4 dark strokes in a box."""
    w = int(h * rng.uniform(0.45, 0.8))
    img = np.full((h, w), 250, np.uint8)
    top, bot, left, right = h // 6, h - h // 6, w // 8, w - w // 8
    for _ in range(int(rng.integers(2, 5))):
        t = max(2, h // 12)
        if rng.uniform() < 0.5:
            x0 = int(rng.integers(left, max(left + 1, right - t)))
            y0, y1 = sorted(rng.integers(top, bot, 2))
            img[y0:max(y1, y0 + h // 3), x0:x0 + t] = rng.integers(0, 50)
        else:
            y0 = int(rng.integers(top, bot - t))
            x0, x1 = sorted(rng.integers(left, right, 2))
            img[y0:y0 + t, x0:max(x1, x0 + w // 3)] = rng.integers(0, 50)
    return img


def make_char_tree(chars):
    """A char-folder tree of synthetic glyphs, one class per char: two
    renders (NotoSerif-Regular, the en prototype font, and a bold
    variant) and PAIRED crops (shifted, noisy) of the train, val and test
    line stems, plus the three COCO split files."""
    root = os.path.join(WORK, "train")
    shutil.rmtree(root, ignore_errors=True)
    tree = os.path.join(root, "tree")
    rng = np.random.default_rng(SEED + 60)
    n = 0
    for ci, ch in enumerate(chars):
        d = os.path.join(tree, str(ord(ch)))
        os.makedirs(d)
        g = synth_glyph(rng)
        bold = np.minimum(g, np.roll(g, 1, axis=1))
        write_png(os.path.join(d, f"{hex(ord(ch))}_0_NotoSerif-Regular.png"),
                  g)
        write_png(os.path.join(d, f"{hex(ord(ch))}_1_DejaVuSans-Bold.png"),
                  np.repeat(bold[..., None], 3, -1))
        n += 2
        for stems in SPLIT_STEMS.values():
            for k, stem in enumerate(stems):
                dy, dx = rng.integers(-2, 3, 2)
                crop = np.roll(g, (dy, dx), axis=(0, 1)).astype(np.int32)
                crop = crop + rng.normal(0, 8, crop.shape).astype(np.int32)
                crop = np.clip(crop, 0, 255).astype(np.uint8)
                cut = crop[int(rng.integers(0, 3)):, :crop.shape[1]
                           - int(rng.integers(0, 3))]
                write_png(os.path.join(
                    d, f"PAIRED_{stem}_{ci}_{hex(ord(ch))}_{k}.png"), cut)
                n += 1
    splits = {}
    for split, stems in SPLIT_STEMS.items():
        p = os.path.join(root, f"{split}.json")
        with open(p, "w") as f:
            json.dump({"images": [{"id": i, "file_name": f"{s}.png"}
                                  for i, s in enumerate(stems)],
                       "annotations": []}, f)
        splits[split] = p
    return tree, splits, n


def run_cli(args, tag, timeout=900):
    """``python -m effocr_torch <args>`` in a subprocess from the checkout;
    its output goes to WORK/<tag>.log, and a failure raises.  This
    process's cached device memory is released first: the subprocess
    needs it (the xcit phase's engine leaves ~37 GiB cached)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "effocr_torch", *args],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    wall = time.perf_counter() - t0
    with open(os.path.join(WORK, f"{tag}.log"), "w") as f:
        f.write(out.stdout + "\n--- stderr ---\n" + out.stderr)
    if out.returncode != 0:
        raise AssertionError(f"{tag}: exit {out.returncode}: "
                             f"{out.stderr[-3000:]}")
    return out.stdout, wall


def _after(text, prefix):
    line = [ln for ln in text.splitlines() if ln.startswith(prefix)][-1]
    return float(line[len(prefix):])


def phase_train(dev, card, paths, loc_dir):
    """``python -m effocr_torch train-recognizer --device cuda`` with the
    en recipe at full width on a synthetic 90-class tree (depth cut to 3
    epochs), then ``build-index --test --mine_hardneg 8``, then the en
    engine on the new recognizer over N_TRAIN_LINES lines, K1 held
    against plain."""
    with open(os.path.join(R5, "rec2k_mn_hn", "ref.txt"), newline="") as f:
        chars = f.read().rstrip("\n").split("\n")
    t0 = time.perf_counter()
    tree, splits, n_items = make_char_tree(chars)
    log(f"train: synthetic tree of {len(chars)} classes, {n_items} PNGs "
        f"written in {time.perf_counter() - t0:.1f} s")
    run_dir = os.path.join(WORK, "train", "rec")
    stdout, wall = run_cli(
        ["train-recognizer", "--device", "cuda", "--root_dir_path", tree,
         "--train_ann_path", splits["train"], "--val_ann_path",
         splits["val"], "--test_ann_path", splits["test"], "--run_name",
         run_dir, *TRAIN_FLAGS], "train_recognizer")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    losses = [(r["step"], r["train/loss"]) for r in recs
              if "train/loss" in r]
    epochs = [r for r in recs if "epoch/steps" in r]
    timed = epochs[1:]                   # the first epoch is warm-up
    steps_s = sum(r["epoch/steps"] for r in timed) / sum(
        r["epoch/seconds"] for r in timed)
    images_s = sum(r["epoch/images"] for r in timed) / sum(
        r["epoch/seconds"] for r in timed)
    val = [r["val/accuracy"] for r in recs if "val/accuracy" in r]
    peak = [r["device/peak_gib"] for r in recs if "device/peak_gib" in r
            ] or [float("nan")]
    test_acc = _after(stdout, "Final test acc: ")
    if not all(np.isfinite(v) for _, v in losses) or len(losses) < 2:
        raise AssertionError(f"train: losses {losses}")
    if not losses[-1][1] < losses[0][1]:
        raise AssertionError(f"train: the last logged loss {losses[-1]} is "
                             f"not below the first {losses[0]}")
    log(f"train: train-recognizer exited 0 in {wall:.1f} s (process "
        f"wall, tree decode and evaluation included); epochs "
        f"{[round(r['epoch/seconds'], 3) for r in epochs]} s for "
        f"{[int(r['epoch/steps']) for r in epochs]} steps of 128 images; "
        f"timed epochs (2-3): {steps_s:.2f} optimizer steps/s = "
        f"{images_s:.1f} images/s ({card})")
    log(f"train: logged losses (step, loss) {losses}; val p@1 by eval "
        f"{val}; test p@1 {test_acc}; peak device memory {peak[-1]:.3f} "
        f"GiB ({card})")
    stdout, bwall = run_cli(["build-index", "--device", "cuda", "--run_dir",
                             run_dir, "--test", "--mine_hardneg", "8"],
                            "build_index")
    test_p1 = _after(stdout, "Test precision@1: ")
    with open(os.path.join(run_dir, "hns.txt")) as f:
        hns = f.read().split("\n")
    if len(hns) != len(chars) * len(SPLIT_STEMS["train"]) or any(
            len(h) != 8 for h in hns):
        raise AssertionError(f"build-index: {len(hns)} hard-negative lines")
    log(f"train: build-index --test --mine_hardneg 8 exited 0 in "
        f"{bwall:.1f} s: test p@1 {test_p1}, {len(hns)} hard-negative "
        "strings of 8")
    engine = load_engine(engine_args(loc_dir, run_dir))
    if len(engine.index) != len(chars):
        raise AssertionError(f"train: the engine's index has "
                             f"{len(engine.index)} rows")
    run = checked_runs(engine, paths[:N_TRAIN_LINES], "train")
    out = report("train", run, card, f"; recognizer trained here, "
                 f"{len(engine.index)} centroid prototypes")
    out.update(steps_s=steps_s, images_s=images_s, losses=losses,
               val_p1=val, test_p1=test_acc, build_index_test_p1=test_p1,
               peak_train_gib=peak[-1], train_wall_s=wall,
               epoch_seconds=[r["epoch/seconds"] for r in epochs],
               tree=tree, splits=splits, run_dir=run_dir, n_items=n_items)
    return out


def normal_init(model, seed):
    """Conv and Dense weights ~ N(0, 1/fan_in), untruncated, biases 0:
    the weights this check was set up on.  From factory.init_params'
    truncated lecun_normal (the distribution training starts from) this
    network's float32 backward lands ~1e-3 of the largest |g| from a
    float64 evaluation on either device (the card 1.0e-3 to 2.4e-3, the
    CPU 7e-4: input differences of 2e-6 from the augmentation move the
    gradients that much), at the floor of the check's tolerance; from
    these weights, 2e-4 to 6e-4."""
    from effocr_torch.models import layers

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (layers.Conv, layers.Dense)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               / m.weight[0].numel() ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def phase_train_step(dev, card, tree):
    """One make_train_step at full width (the en recipe: 128 px, batch
    128, bank mode, aux head, paired jitter) in float32 on the card and
    on the CPU, on the same batch and the same draws: loss, gradients
    (1e-3 of the largest |g|) and new batch_stats.  Then the device time
    of each stage of the recipe's bf16 step on the card."""
    import copy

    from effocr_torch.core.config import EncoderConfig, RecognizerTrainConfig
    from effocr_torch.data.folder import CharFolderDataset
    from effocr_torch.data.samplers import (
        NoReplacementMPerClassSampler,
        batch_iterator,
    )
    from effocr_torch.data.transforms import apply_augment, draw_augment
    from effocr_torch.train.losses import cosine_classifier_loss, supcon_loss
    from effocr_torch.train.optim import AdamW
    from effocr_torch.train.recognizer import make_train_step

    cfg = RecognizerTrainConfig(
        encoder=EncoderConfig(arch="mobilenetv3_small_050", image_size=128,
                              input_channels=1),
        batch_size=128, lang="en", lr=1e-3, paired_jitter=0.1,
        aux_ce_weight=1.0, data_device="resident")
    ds = CharFolderDataset(tree)
    bank = torch.from_numpy(ds.decode_all_gray(128))
    targets = torch.tensor(ds.targets)
    paired = torch.tensor([ds.is_paired(i) for i in range(len(ds))])
    t0 = time.perf_counter()
    batches = list(batch_iterator(iter(NoReplacementMPerClassSampler(
        ds.targets, m=4, batch_size=128, num_passes=20, seed=0)), 128))
    sampler_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    idx = torch.tensor(batches[0])
    draws = draw_augment(torch.Generator().manual_seed(SEED + 71), 128, 128,
                         lang="en", paired_jitter=0.1)
    base = normal_init(create_encoder("mobilenetv3_small_050",
                                      in_channels=1, dtype=torch.float32),
                       SEED + 70)
    aux0 = torch.randn((len(ds.classes), base.out_features),
                       generator=torch.Generator().manual_seed(SEED + 72)
                       ) * 0.02
    got = {}
    for where in ("cuda", "cpu"):
        model = copy.deepcopy(base).to(where)
        aux = aux0.clone().to(where).requires_grad_()
        named = dict(model.named_parameters())
        named["aux"] = aux
        rec = GradRecorder(named)
        step = make_train_step(model, cfg, rec, False, aux=aux,
                               bank_mode=True)
        loss = step(bank.to(where), targets.to(where), paired.to(where),
                    idx.to(where), {k: v.to(where) for k, v in draws.items()})
        got[where] = (float(loss), rec.grads,
                      {k: v.float().cpu() for k, v in
                       model.state_dict().items() if "running" in k})
    (lg, gg, sg), (lc, gc, sc) = got["cuda"], got["cpu"]
    gmax = max(float(g.abs().max()) for g in gc.values())
    gerr = max(float((gg[k] - gc[k]).abs().max()) for k in gc) / gmax
    smax = max(float(v.abs().max()) for v in sc.values())
    serr = max(float((sg[k] - sc[k]).abs().max()) for k in sc) / smax
    lerr = abs(lg - lc) / abs(lc)
    log(f"train_step_vs_cpu: float32 step at batch 128 x 128 px: loss card "
        f"{lg:.6f} CPU {lc:.6f} (rel {lerr:.3g}); max |grad diff| / max|g| "
        f"{gerr:.3g} over {len(gc)} tensors; max |batch_stats diff| / "
        f"max|stat| {serr:.3g} (tolerance 1e-3)")
    if not (lerr <= 1e-3 and gerr <= 1e-3 and serr <= 1e-3):
        raise AssertionError("train_step_vs_cpu: card and CPU disagree")

    # device time of each stage of the recipe's step (bf16 encoder), from
    # torch.profiler: kernels under each stage's range; backward's kernels
    # come from autograd's device thread, outside the ranges, so backward
    # is the rest of the device time
    from torch.profiler import ProfilerActivity, profile, record_function

    model = init_params(create_encoder("mobilenetv3_small_050",
                                       in_channels=1), SEED + 70).to(dev)
    aux = aux0.clone().to(dev).requires_grad_()
    opt = AdamW([(list(model.parameters()), 1e-3), ([aux], 1e-3)])
    bank_d, tgt_d, pair_d = bank.to(dev), targets.to(dev), paired.to(dev)
    idx_d = idx.to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 73)
    stages = ("augment", "forward", "loss", "optimizer")

    def one_step():
        with record_function("train/augment"):
            x = apply_augment(
                bank_d[idx_d][..., None].expand(-1, -1, -1, 3),
                pair_d[idx_d],
                draw_augment(gen, 128, 128, lang="en", paired_jitter=0.1),
                lang="en", paired_jitter=0.1, out_channels=1)
        y = tgt_d[idx_d]
        model.train()
        opt.zero_grad()
        with record_function("train/forward"):
            out = model(x)
        with record_function("train/loss"):
            loss = supcon_loss(out, y, 0.1) + 1.0 * cosine_classifier_loss(
                out, aux, y, 0.07)
        loss.backward()
        with record_function("train/optimizer"):
            opt.step()

    n_steps = 10
    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        one_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            one_step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda_ev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    # the ranges also appear on the device timeline as spans (first to
    # last kernel of the range, idle gaps included): not kernels
    kernels = [e for e in cuda_ev if not e.key.startswith("train/")]
    spans = {name: sum(e.self_device_time_total for e in cuda_ev
                       if e.key == f"train/{name}") / 1e3 / n_steps
             for name in stages}
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / n_steps
    times = {name: sum(e.device_time_total for e in events
                       if e.key == f"train/{name}"
                       and e.device_type == torch.autograd.DeviceType.CPU)
             / 1e3 / n_steps for name in stages}
    times["backward (the rest)"] = total - sum(times.values())
    launches = sum(e.count for e in kernels) / n_steps
    log(f"train_step_vs_cpu: one bf16 step of the recipe at batch 128 "
        f"({card}): {step_ms:.2f} ms wall (host clock, {n_steps} steps), "
        f"{total:.2f} ms of kernels in {launches:.0f} launches (busy share "
        f"{total / step_ms:.3f}, profiler on); kernel ms by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + "; device span of each range (idle gaps included): "
        + ", ".join(f"{k} {v:.3f}" for k, v in spans.items())
        + f"; host sampler {sampler_ms:.3f} ms per batch")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        ms = e.self_device_time_total / 1e3 / n_steps
        log(f"train_step_vs_cpu: kernel {ms:8.3f} ms/step "
            f"x{e.count // n_steps:<4d} {e.key[:100]}")
    times.update(total=total, wall=step_ms, launches=launches, spans=spans,
                 top_kernels={e.key[:100]: e.self_device_time_total / 1e3
                              / n_steps for e in top})
    return dict(loss_rel_err=lerr, grad_rel_err=gerr, stats_rel_err=serr,
                stage_ms=times, sampler_ms=sampler_ms)


def phase_build_index_from(dev, card, paths, loc_dir, run_dir, tree):
    """infer --build_index_from: a copy of the trained recognizer dir
    without ref.npz, and the tree's NotoSerif-Regular renders embedded
    into an ad-hoc index, against build-index's render rows (a copy of
    the run dir with ref_source render): rows within 1e-5, the same
    ref.txt.  Then the en engine on it over N_ADHOC_LINES lines, K1
    checked."""
    base = os.path.join(WORK, "train")
    rows = {}
    for name in ("rec_render", "rec_adhoc"):
        d = os.path.join(base, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(run_dir, d)
        for f in ("ref.npz", "ref.txt"):
            os.remove(os.path.join(d, f))
        rows[name] = d
    with open(os.path.join(rows["rec_render"], "args_log.json")) as f:
        a = json.load(f)
    a["ref_source"] = "render"
    with open(os.path.join(rows["rec_render"], "args_log.json"), "w") as f:
        json.dump(a, f)
    run_cli(["build-index", "--device", "cuda", "--run_dir",
             rows["rec_render"]], "build_index_render")
    engine = load_engine(engine_args(
        loc_dir, rows["rec_adhoc"], "--build_index_from", tree,
        "--render_font_name", "NotoSerif-Regular"))
    ref = PrototypeIndex.load(rows["rec_render"])
    got = PrototypeIndex.load(rows["rec_adhoc"])
    err = float(np.abs(got.embeddings - ref.embeddings).max())
    if got.chars != ref.chars or not err <= 1e-5:
        raise AssertionError(f"build_index_from: chars equal "
                             f"{got.chars == ref.chars}, max row diff {err}")
    log(f"build_index_from: ad-hoc index of {len(got)} renders equals "
        f"build-index's render rows (max |diff| {err:.3g}, tolerance 1e-5) "
        "and its ref.txt")
    run = checked_runs(engine, paths[:N_ADHOC_LINES], "build_index_from")
    out = report("build_index_from", run, card,
                 f"; ad-hoc index of {len(got)} renders")
    out["row_max_err"] = err
    return out


# ------------------------------------------------- localizer training
# the en localizer recipe of scripts/northstar_en.sh:52-56 at full width
# (yolov5s, gray, 1024 wide, heights 64 and 96, fitted anchors, batch 16,
# resident bank); depth cut to 4 epochs of 125, an evaluation every 2
LOC_TRAIN_FLAGS = ["--arch", "yolov5s", "--input_size", "1024",
                   "--multi_height", "64,96", "--input_channels", "1",
                   "--fit_anchors", "--batch_size", "16",
                   "--data_device", "resident", "--num_epochs", "4",
                   "--eval_period", "2"]
LOC_SPLITS = {"train": 2000, "val": 128, "test": 128, "read": 256}


_GLYPH_CACHE = {}


def loc_line(rng, glyphs, chars):
    """A line of the en glyph renders: 36-72 px high, 2-8 words of 1-7
    glyphs scaled to the line, shifted and noised.  Returns (gray image,
    char boxes, word boxes, text), boxes [x, y, w, h] in pixels."""
    from effocr_torch.kernels.image_ops import cv2_resize_linear

    h = int(rng.integers(36, 73))
    gh = h - 2 * (h // 8)
    x, pieces, cboxes, wboxes, words = h // 4, [], [], [], []
    for _ in range(int(rng.integers(2, 9))):
        x0, word = x, []
        for ci in rng.integers(0, len(chars), int(rng.integers(1, 8))):
            g = glyphs[ci]
            gw = max(4, int(round(g.shape[1] * gh / g.shape[0])))
            top = h // 8 + int(rng.integers(-1, 2))
            if (ci, gh) not in _GLYPH_CACHE:
                _GLYPH_CACHE[ci, gh] = cv2_resize_linear(g[..., None], gw, gh)
            pieces.append((x, top, _GLYPH_CACHE[ci, gh]))
            cboxes.append([x, top, gw, gh])
            word.append(chars[ci])
            x += gw + int(rng.integers(1, 4))
        wboxes.append([x0, min(b[1] for b in cboxes[-len(word):]),
                       cboxes[-1][0] + cboxes[-1][2] - x0, gh + 1])
        words.append("".join(word))
        x = cboxes[-1][0] + cboxes[-1][2] + h // 2
    img = np.full((h, x + h // 4), 245, np.int32)
    for px, py, g in pieces:
        img[py:py + g.shape[0], px:px + g.shape[1]] = g[..., 0]
    img = np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    return img, cboxes, wboxes, " ".join(words)


def make_loc_corpus(tree, chars):
    """Line PNGs of the NotoSerif glyph renders of ``tree`` (phase
    train's) and one COCO file per split: char boxes (category 0), word
    boxes (category 1), ``text``, ``width``, ``height``."""
    from effocr_torch.data import png

    root = os.path.join(WORK, "train_loc")
    shutil.rmtree(root, ignore_errors=True)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    glyphs = [png.read_png(os.path.join(
        tree, str(ord(c)), f"{hex(ord(c))}_0_NotoSerif-Regular.png"), 1)[
            ..., 0] for c in chars]
    rng = np.random.default_rng(SEED + 80)
    splits = {}
    for split, n in LOC_SPLITS.items():
        images, annos = [], []
        for i in range(n):
            img, cboxes, wboxes, text = loc_line(rng, glyphs, chars)
            name = f"{split}{i:05d}.png"
            write_png(os.path.join(img_dir, name), img)
            images.append({"id": i, "file_name": name, "width": img.shape[1],
                           "height": img.shape[0], "text": text})
            for cat, boxes in ((0, cboxes), (1, wboxes)):
                for b in boxes:
                    annos.append({"id": len(annos), "image_id": i,
                                  "bbox": [float(v) for v in b],
                                  "category_id": cat})
        splits[split] = os.path.join(root, f"{split}.json")
        with open(splits[split], "w") as f:
            json.dump({"images": images, "annotations": annos,
                       "categories": [{"id": 0, "name": "char"},
                                      {"id": 1, "name": "word"}]}, f)
    return img_dir, splits


def _loc_trainer(dev, run_dir, model_json, augment=False):
    from effocr_torch.core.config import LocalizerConfig, LocalizerTrainConfig
    from effocr_torch.train.localizer import LocalizerTrainer

    with open(model_json) as f:
        meta = json.load(f)
    cfg = LocalizerTrainConfig(localizer=LocalizerConfig(
        arch=meta["arch"], input_size=meta["input_size"],
        input_height=meta["input_height"],
        input_channels=meta["input_channels"]), augment=augment)
    model = create_localizer(meta["arch"], 2, in_channels=1, anchors=tuple(
        tuple(a) for a in meta["anchors"]))
    return LocalizerTrainer(cfg, model, run_dir, 1, device=dev)


def phase_train_localizer(dev, card, tree, rec_dir, out_dir):
    """``python -m effocr_torch train-localizer --device cuda`` with the
    en recipe at full width on a synthetic line corpus of phase train's
    glyphs (depth cut to 4 epochs), ``--test_coco`` included.  Then, in
    process, the best checkpoint on the val split twice: every K1 keep
    mask held bit for bit against nms_mask, and on plain NMS; the AP
    dictionaries must be equal.  Then the en engine with the new
    localizer and phase train's recognizer over the held-out lines
    (``checked_runs``): CER and textline accuracy as ``infer
    --coco_json`` computes them."""
    from effocr_torch.data.detection import DetectionDataset
    from effocr_torch.eval.coco_map import coco_map
    from effocr_torch.eval.textline import textline_evaluation
    from effocr_torch.train import checkpoint as ckpt

    with open(os.path.join(R5, "rec2k_mn_hn", "ref.txt"), newline="") as f:
        chars = f.read().rstrip("\n").split("\n")
    t0 = time.perf_counter()
    img_dir, splits = make_loc_corpus(tree, chars)
    log(f"train_localizer: {sum(LOC_SPLITS.values())} line PNGs of "
        f"{len(chars)} glyphs ({LOC_SPLITS}) written in "
        f"{time.perf_counter() - t0:.1f} s")
    run_dir = os.path.join(WORK, "train_loc", "loc")
    stdout, wall = run_cli(
        ["train-localizer", "--device", "cuda", "--image_dir", img_dir,
         "--train_coco", splits["train"], "--val_coco", splits["val"],
         "--test_coco", splits["test"], "--run_name", run_dir,
         *LOC_TRAIN_FLAGS], "train_localizer")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    losses = [(r["step"], r["train/loss"], r["loss/box"], r["loss/obj"],
               r["loss/cls"]) for r in recs if "train/loss" in r]
    epochs = [r for r in recs if "epoch/steps" in r]
    timed = epochs[2:]                # after each height's first epoch
    steps_s = sum(r["epoch/steps"] for r in timed) / sum(
        r["epoch/seconds"] for r in timed)
    images_s = sum(r["epoch/images"] for r in timed) / sum(
        r["epoch/seconds"] for r in timed)
    evals = [{k: r[k] for k in ("bbox/AP", "bbox/AP50", "bbox/AP75")}
             for r in recs if "bbox/AP" in r]
    test = [{k: r[f"test/{k}"] for k in ("bbox/AP", "bbox/AP50",
                                          "bbox/AP75")}
            for r in recs if "test/bbox/AP" in r][-1]
    peak = [r["device/peak_gib"] for r in recs if "device/peak_gib" in r][-1]
    anchors = [ln for ln in stdout.splitlines()
               if ln.startswith("fitted anchors")][-1]
    numbers = ([v for row in losses for v in row[1:]] + [steps_s, images_s,
               peak] + [v for e in evals + [test] for v in e.values()])
    if len(losses) < 2 or not all(np.isfinite(v) for v in numbers):
        raise AssertionError(f"train_localizer: losses {losses}, evals "
                             f"{evals}, test {test}")
    if not losses[-1][1] < losses[0][1]:
        raise AssertionError(f"train_localizer: the last logged loss "
                             f"{losses[-1]} is not below the first "
                             f"{losses[0]}")
    log(f"train_localizer: train-localizer exited 0 in {wall:.1f} s "
        f"(process wall, corpus letterbox and evaluation included); epochs "
        f"{[round(r['epoch/seconds'], 3) for r in epochs]} s at heights "
        f"{[int(r['epoch/height']) for r in epochs]}, "
        f"{int(epochs[0]['epoch/steps'])} steps of 16 each; epochs 3-"
        f"{len(epochs)} (after each height's first): {steps_s:.2f} "
        f"optimizer steps/s = {images_s:.1f} images/s ({card})")
    log(f"train_localizer: logged (step, loss, box, obj, cls) {losses}")
    log(f"train_localizer: val AP / AP50 / AP75 by evaluation {evals}; "
        f"test (best checkpoint) {test}; peak device memory {peak:.3f} GiB "
        f"({card}); {anchors}")

    best = ckpt.best_checkpoint_path(run_dir, "best_bbox_mAP")
    trainer = _loc_trainer(dev, os.path.join(WORK, "train_loc", "check"),
                           os.path.join(run_dir, "model.json"))
    trainer.set_variables(ckpt.load_variables(best))
    val_ds = DetectionDataset(splits["val"], img_dir, 1024, input_height=96,
                              channels=1)
    batches = [(b[0], b[3]) for b in val_ds.batches(
        16, shuffle=False, drop_last=False)]
    cuda_nms.nms_kernel.launches = 0
    t0 = time.perf_counter()
    with kernels_checked("train_localizer evaluation") as (k1c, _):
        preds, gts = trainer.predict(batches)
    eval_launches = cuda_nms.nms_kernel.launches
    ap_k1 = coco_map(preds, gts, num_classes=2)
    eval_s = time.perf_counter() - t0
    by_class = {}
    for c, name in ((0, "char"), (1, "word")):
        sel = [({"boxes": p["boxes"][p["classes"] == c],
                 "scores": p["scores"][p["classes"] == c],
                 "classes": np.zeros(int((p["classes"] == c).sum()), int)},
                {"boxes": g["boxes"][g["classes"] == c],
                 "classes": np.zeros(int((g["classes"] == c).sum()), int)})
               for p, g in zip(preds, gts)]
        by_class[name] = coco_map([a for a, _ in sel], [b for _, b in sel],
                                  num_classes=1)
    trainer.nms_kernel = "plain"
    ap_plain = coco_map(*trainer.predict(batches), num_classes=2)
    if ap_k1 != ap_plain or k1c.calls != len(batches):
        raise AssertionError(f"train_localizer: AP with K1 {ap_k1} vs plain "
                             f"NMS {ap_plain}; K1 calls {k1c.calls}")
    log(f"train_localizer: best checkpoint on the val split: K1 held bit "
        f"for bit against nms_mask on {k1c.calls} calls ({k1c.boxes} valid "
        f"boxes of {len(batches) * 1024}), {eval_launches} launches; AP "
        f"dictionary identical on plain NMS: {ap_k1} ({eval_s:.1f} s with "
        f"the checks and coco_map); by class: {by_class}")
    boxes, valid, thr = k1c.first
    k1_eval = k1_case("train_localizer evaluation [16, 1024]", boxes, valid,
                      thr, timed=True)

    engine = load_engine(engine_args(run_dir, rec_dir))
    with open(splits["read"]) as f:
        read = json.load(f)["images"]
    paths = [os.path.join(img_dir, im["file_name"]) for im in read]
    run = checked_runs(engine, paths, "train_localizer")
    pairs = [(im["text"], run["results"][p] or "")
             for im, p in zip(read, paths)]
    acc, cer = textline_evaluation(pairs)
    read_pairs = [(gt, run["results"][p]) for (gt, _), p in zip(pairs, paths)
                  if run["results"][p] is not None]
    cer_read = textline_evaluation(read_pairs)[1] if read_pairs else None
    out = report("train_localizer", run, card,
                 f"; localizer and recognizer trained here; CER {cer:.4f}, "
                 f"textline accuracy {acc:.2f}% on {len(pairs)} held-out "
                 f"synthetic lines (CER {cer_read} over the "
                 f"{len(read_pairs)} lines that read text)")
    for gt, got in pairs[:4]:
        log(f"train_localizer: {gt!r} -> {got!r}")
    if out_dir != WORK:     # the trained localizer, without its train state
        dst = os.path.join(out_dir, "train_localizer")
        os.makedirs(dst, exist_ok=True)
        for name in ("model.json", "best_bbox_mAP.msgpack", "metrics.jsonl",
                     "args_log.json"):
            shutil.copy(os.path.join(run_dir, name), dst)
    out.update(k1_launches=run["k1_launches"] + eval_launches,
               k1_eval_launches=eval_launches, k1_eval=k1_eval, cer=cer,
               textline_accuracy=acc, cer_read=cer_read,
               lines_read=len(read_pairs), ap_by_class=by_class,
               steps_s=steps_s, images_s=images_s,
               losses=losses, val_ap=evals, test_ap=test,
               peak_train_gib=peak, train_wall_s=wall, anchors=anchors,
               epoch_seconds=[r["epoch/seconds"] for r in epochs],
               run_dir=run_dir, img_dir=img_dir, splits=splits)
    return out


def phase_loc_step(dev, card, img_dir, splits, model_json):
    """One float32 step of the localizer recipe at full width (yolov5s,
    batch 16, 96 x 1024, 1 channel, augment on one fixed set of draws)
    on the card and on the CPU, on the same batch: loss within 1e-5
    relative, gradients within 1e-3 of the largest |g|, new batch_stats
    within 1e-3 of the largest.  Then the device time of each stage of
    the recipe's bf16 step on the card (torch.profiler)."""
    import copy

    from effocr_torch.data.detection import DetectionDataset
    from effocr_torch.kernels.det_augment import (
        apply_detection_augment,
        draw_detection_augment,
    )
    from effocr_torch.train.localizer import make_detector_train_step
    from effocr_torch.train.losses import yolo_loss

    ds = DetectionDataset(splits["test"], img_dir, 1024, input_height=96,
                          channels=1)
    imgs, tgts, masks, _ = next(ds.batches(16, shuffle=False))
    batch = [torch.from_numpy(a) for a in (imgs, tgts, masks)]
    draws = draw_detection_augment(torch.Generator().manual_seed(SEED + 81),
                                   16, 96, 1024, 1)
    t_cpu = _loc_trainer("cpu", os.path.join(WORK, "train_loc", "step"),
                         model_json, augment=True)
    base = init_params(_f32_copy(t_cpu.model, "cpu"), SEED + 82)
    got = {}
    for where in ("cuda", "cpu"):
        model = copy.deepcopy(base).to(where).train()
        rec = GradRecorder(dict(model.named_parameters()))
        step = make_detector_train_step(model, t_cpu.cfg, rec, model.anchors)
        t0 = time.perf_counter()
        loss, _ = step(*(a.to(where) for a in batch),
                       {k: v.to(where) for k, v in draws.items()})
        loss = float(loss)
        got[where] = (loss, rec.grads, time.perf_counter() - t0,
                      {k: v.float().cpu() for k, v in
                       model.state_dict().items() if "running" in k})
    (lg, gg, sg_s, sg), (lc, gc, sc_s, sc) = got["cuda"], got["cpu"]
    gmax = max(float(g.abs().max()) for g in gc.values())
    gerr = max(float((gg[k] - gc[k]).abs().max()) for k in gc) / gmax
    smax = max(float(v.abs().max()) for v in sc.values())
    serr = max(float((sg[k] - sc[k]).abs().max()) for k in sc) / smax
    lerr = abs(lg - lc) / abs(lc)
    log(f"loc_step_vs_cpu: float32 yolov5s step at batch 16 x 96 x 1024, "
        f"augment on: loss card {lg:.6f} CPU {lc:.6f} (rel {lerr:.3g}, "
        f"tolerance 1e-5); max |grad diff| / max|g| {gerr:.3g} over "
        f"{len(gc)} tensors; max |batch_stats diff| / max|stat| {serr:.3g} "
        f"(tolerance 1e-3); CPU step {sc_s:.1f} s")
    if not (lerr <= 1e-5 and gerr <= 1e-3 and serr <= 1e-3):
        raise AssertionError("loc_step_vs_cpu: card and CPU disagree")

    # the recipe's bf16 step split by stage: kernels under each range;
    # backward's kernels run on autograd's device thread, outside the
    # ranges, so backward is the rest of the device time
    from torch.profiler import ProfilerActivity, profile, record_function

    trainer = _loc_trainer(dev, os.path.join(WORK, "train_loc", "step"),
                           model_json, augment=True)
    trainer.init_state(SEED + 82)
    model, opt, cfg = trainer.model, trainer.optimizer, trainer.cfg
    bank = [a.to(dev) for a in batch]
    gen = torch.Generator(device=dev).manual_seed(SEED + 83)
    stages = ("augment", "forward", "loss", "optimizer")

    def one_step():
        with record_function("train/augment"):
            x, t, m = apply_detection_augment(
                bank[0].float() / 255.0, bank[1], bank[2],
                draw_detection_augment(gen, 16, 96, 1024, 1))
        model.train()
        opt.zero_grad()
        with record_function("train/forward"):
            raw = model(x, decode=False)
        with record_function("train/loss"):
            loss, _ = yolo_loss(raw, t, m, model.anchors, num_classes=2,
                                box_gain=cfg.box_gain, obj_gain=cfg.obj_gain,
                                cls_gain=cfg.cls_gain,
                                anchor_t=cfg.anchor_match_thresh)
        loss.backward()
        with record_function("train/optimizer"):
            opt.step()

    n_steps = 10
    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        one_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            one_step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda_ev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in cuda_ev if not e.key.startswith("train/")]
    spans = {name: sum(e.self_device_time_total for e in cuda_ev
                       if e.key == f"train/{name}") / 1e3 / n_steps
             for name in stages}
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / n_steps
    times = {name: sum(e.device_time_total for e in events
                       if e.key == f"train/{name}"
                       and e.device_type == torch.autograd.DeviceType.CPU)
             / 1e3 / n_steps for name in stages}
    times["backward (the rest)"] = total - sum(times.values())
    launches = sum(e.count for e in kernels) / n_steps
    log(f"loc_step_vs_cpu: one bf16 step of the recipe at batch 16 x 96 x "
        f"1024 ({card}): {step_ms:.2f} ms wall (host clock, {n_steps} "
        f"steps, profiler off), {total:.2f} ms of kernels in "
        f"{launches:.0f} launches (busy share {total / step_ms:.3f}); "
        "kernel ms by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + "; device span of each range (idle gaps included, not kernels): "
        + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        ms = e.self_device_time_total / 1e3 / n_steps
        log(f"loc_step_vs_cpu: kernel {ms:8.3f} ms/step "
            f"x{e.count // n_steps:<4d} {e.key[:100]}")
    times.update(total=total, wall=step_ms, launches=launches, spans=spans,
                 top_kernels={e.key[:100]: e.self_device_time_total / 1e3
                              / n_steps for e in top})
    return dict(loss_rel_err=lerr, grad_rel_err=gerr, stats_rel_err=serr,
                cpu_step_s=sc_s, stage_ms=times)


# ------------------------------------------ the other model families
# scripts/chain_r5b.sh:29-39 (the fcos_infer stage), paths swapped and K1
# named as this package names it; the xcit phase takes BENCH_TRAINED.json's
# flags instead
FAMILY_FLAGS = ["--lang", "en", "--localizer_conf_thresh", "0.3",
                "--localizer_iou_thresh", "0.25", "--adaptive_height",
                "--adaptive_width", "--chunk_sort", "width",
                "--encoder_sub_batch", "2048", "--line_batch", "512",
                "--crop_batch", "20480", "--max_det", "96", "--max_words",
                "16", "--nms_kernel", "cuda", "--transfer_bits", "2",
                "--out_quant", "u16"]
N_FAMILY_LINES = 256
# one chunk at BENCH_TRAINED's line_batch; XCiT encodes every crop slot
# of it (~19 s of device time at 20,480 slots), so its path skips the
# run on plain NMS (the warm-up holds every K1 call bit for bit)
N_XCIT_LINES = 512
XCIT_ARCH = "xcit_small_12_p8_224"
# chars and words a line the random detectors are calibrated to read (en
# engine thresholds, 16 sample lines)
CHARS_TARGET, WORDS_TARGET = 26.0, 5.0
# the fcos_train recipe of scripts/chain_r5b.sh:21-27 at full width (1024
# wide, heights 64 and 96, gray, batch 16, resident bank); depth cut to 3
# epochs of N_FAMILY_TRAIN_LINES lines (1,000 until the TIFF layouts
# joined image_formats), one evaluation
N_FAMILY_TRAIN_LINES = 500
FAMILY_TRAIN_FLAGS = ["--input_size", "1024", "--multi_height", "64,96",
                      "--input_channels", "1", "--batch_size", "16",
                      "--data_device", "resident", "--num_epochs", "3",
                      "--eval_period", "3"]


def _with(flags, **values):
    """``flags`` with the values of some ``--name value`` pairs
    replaced."""
    out = list(flags)
    for name, v in values.items():
        out[out.index(f"--{name}") + 1] = v
    return out


# train-recognizer with the en recipe's flags and XCiT at its 224 px;
# depth cut to 2 epochs of 10 sampler passes (the recipe's 20)
XCIT_TRAIN_FLAGS = _with(TRAIN_FLAGS, auto_model=XCIT_ARCH, imsize="224",
                         num_epochs="2", num_passes="10")


def family_engine_args(loc_dir, rec_dir):
    import argparse

    p = argparse.ArgumentParser()
    add_engine_args(p)
    return p.parse_args(["--localizer_dir", loc_dir, "--recognizer_dir",
                         rec_dir, *FAMILY_FLAGS])


def _kept_per_line(loc, x, cls_id):
    """Mean detections of class ``cls_id`` a line after the en engine's
    decode and NMS (conf 0.3, IoU 0.25, max_nms 1024, max_det 96)."""
    from effocr_torch.kernels.yolo_decode import decode_and_nms

    _, _, classes, valid = decode_and_nms(
        loc(x)[0], conf_thresh=0.3, iou_thresh=0.25, max_nms=1024,
        max_det=96, nms_kernel="cuda")
    return float(((classes == cls_id) & valid).sum(1).float().mean())


def _bisect(apply, measure, target, lo=-12.0, hi=12.0, iters=10):
    """The offset v in [lo, hi] where measure() (rising in v) after
    apply(v) meets ``target``; leaves it applied, returns (v, measure)."""
    for _ in range(iters):
        mid = (lo + hi) / 2
        apply(mid)
        lo, hi = (mid, hi) if measure() < target else (lo, mid)
    apply((lo + hi) / 2)
    return (lo + hi) / 2, measure()


def _unit_spread(weight, bias, out):
    """Rescale a head (weight [O, ...], bias [O]) so that its outputs
    ``out`` [..., O] get zero mean and unit spread; returns the new
    bias."""
    out = out.reshape(-1, out.shape[-1]).double()
    m, sd = out.mean(0).float(), out.std(0).float()
    weight /= sd.view(-1, *([1] * (weight.dim() - 1)))
    bias.copy_((bias - m) / sd)
    return bias.clone()


def calibrated_family_detector(dev, arch, canvas, seed):
    """A random FCOS or R-CNN localizer whose heads read chars and words.
    A random detector's activations shrink layer by layer, so each head
    (FCOS: per level; R-CNN: the class logits) is rescaled to unit spread
    on ``canvas``, then offsets are set by bisection so that the en engine
    reads ~CHARS_TARGET chars and ~WORDS_TARGET words a line: FCOS's
    chars from stride 8 (centerness offset), words from stride 32, none
    from stride 16; the R-CNN's background and word logits."""
    loc = init_params(create_localizer(arch, 2, in_channels=1),
                      seed).to(dev).eval()
    x = torch.from_numpy(canvas).to(dev).float() / 255.0
    with torch.no_grad():
        raw = loc(x, decode=False)
        if arch.startswith("fcos"):
            heads = [getattr(loc, f"head{i}_out") for i in range(3)]
            base = [_unit_spread(h.weight, h.bias, r)
                    for h, r in zip(heads, raw)]
            for lvl, offsets in ((0, {5: 4.0, 6: -4.0}), (1, {4: -8.0}),
                                 (2, {5: -4.0, 6: 4.0})):
                for ch, v in offsets.items():
                    heads[lvl].bias[ch] += v

            def ctr(lvl):
                def apply(v):
                    heads[lvl].bias[4] = base[lvl][4] + v
                return apply

            chars = _bisect(ctr(0), lambda: _kept_per_line(loc, x, 0),
                            CHARS_TARGET)
            words = _bisect(ctr(2), lambda: _kept_per_line(loc, x, 1),
                            WORDS_TARGET)
        else:
            head = loc.cls
            base = _unit_spread(head.weight, head.bias, raw["roi_cls"])

            def bg(v):
                head.bias[0] = base[0] - v

            def word(v):
                head.bias[2] = base[2] + v

            chars = _bisect(bg, lambda: _kept_per_line(loc, x, 0),
                            CHARS_TARGET)
            words = _bisect(word, lambda: _kept_per_line(loc, x, 1),
                            WORDS_TARGET)
    log(f"{arch}: heads calibrated on {len(canvas)} lines: offset "
        f"{chars[0]:.3f} -> {chars[1]:.1f} chars/line, offset "
        f"{words[0]:.3f} -> {words[1]:.1f} words/line")
    return loc.cpu()


def make_family_artifacts(dev, sample_paths):
    """Artifact dirs of the new families: fcos_s and rcnn_s localizers
    (loc2k_fcos's model.json, the R-CNN's with its arch swapped in)
    calibrated on ``sample_paths`` letterboxed at 96 x 1024, and an
    xcit_small_12_p8_224 recognizer at 224 px (rec2k_mn_hn's model.json
    with arch and size swapped) with 90 random unit prototypes of its 384
    dims and rec2k_mn_hn's ref.txt."""
    canvas = letterboxed(sample_paths, 1, 1024, 96)
    dirs = {}
    for i, arch in enumerate(("fcos_s", "rcnn_s")):
        d = dirs[arch] = os.path.join(WORK, f"loc_{arch}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(R5, "loc2k_fcos", "model.json")) as f:
            meta = json.load(f)
        meta["arch"] = arch
        with open(os.path.join(d, "model.json"), "w") as f:
            json.dump(meta, f)
        loc = calibrated_family_detector(dev, arch, canvas, SEED + 90 + i)
        write_variables(state_dict_to_flax(loc.state_dict()),
                        os.path.join(d, "best_bbox_mAP.msgpack"))
    d = dirs[XCIT_ARCH] = os.path.join(WORK, "rec_xcit")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(R5, "rec2k_mn_hn", "model.json")) as f:
        meta = json.load(f)
    meta.update(arch=XCIT_ARCH, image_size=224)
    with open(os.path.join(d, "model.json"), "w") as f:
        json.dump(meta, f)
    enc = init_params(create_encoder(XCIT_ARCH, in_channels=1,
                                     image_size=224), SEED + 92)
    write_variables(state_dict_to_flax(enc.state_dict()),
                    os.path.join(d, "enc_best.msgpack"))
    with open(os.path.join(R5, "rec2k_mn_hn", "ref.txt"), newline="") as f:
        chars = f.read().rstrip("\n").split("\n")
    protos = np.random.default_rng(SEED + 93).normal(size=(len(chars), 384))
    PrototypeIndex(protos.astype(np.float32), chars).save(d)
    shutil.copy(os.path.join(R5, "rec2k_mn_hn", "ref.txt"), d)
    return dirs


def phase_family(dev, card, tag, args, paths, out_dir, profile=False,
                 plain=True):
    """One new family through the en engine over ``paths``
    (``checked_runs``: every K1 keep mask, the R-CNN's RPN masks
    included, held bit for bit against nms_mask; the text against the
    engine on plain NMS).  The R-CNN's K1 launches are split by site (RPN
    at IoU 0.7, decode at the engine's IoU) and its RPN K1 timed at the
    path's first input."""
    engine = load_engine(args)
    c = engine.config
    log(f"{tag}: localizer {c.localizer.arch} {c.localizer.input_size} x "
        f"{c.localizer.input_height}, recognizer {c.encoder.arch} at "
        f"{c.encoder.image_size} px; line_batch {c.line_batch} crop_batch "
        f"{c.crop_batch} encoder_sub_batch {c.encoder_sub_batch} max_nms "
        f"{c.localizer.max_nms} transfer_bits {c.transfer_bits} out_quant "
        f"{c.out_quant} nms {engine._nms_kernel}")
    run = checked_runs(engine, paths, tag, plain=plain)
    extra = ""
    rpn = getattr(engine.localizer, "rpn_nms_iou", None)
    if rpn is not None:
        by = run["k1_calls_by_iou"]
        if not by.get(rpn) or not by.get(c.localizer.iou_thresh):
            raise AssertionError(f"{tag}: K1 calls by IoU {by}: both sites "
                                 "must launch it")
        boxes, valid, thr = run["k1_first_by_iou"][rpn]
        run["k1_rpn"] = k1_case(f"{tag} RPN {list(valid.shape)}", boxes,
                                valid, thr, timed=True)
        extra = (f"; K1 sites: RPN (IoU {rpn}) {by[rpn]} calls, decode "
                 f"(IoU {c.localizer.iou_thresh}) "
                 f"{by[c.localizer.iou_thresh]} calls per run")
    if profile:
        profile_run(engine, paths[:c.line_batch], card, out_dir, tag)
    return report(tag, run, card, extra)


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _coco_head(src, n, dst):
    """Writes the first ``n`` images of COCO file ``src`` and their
    annotations to ``dst``; returns ``dst``."""
    with open(src) as f:
        coco = json.load(f)
    keep = {im["id"] for im in coco["images"][:n]}
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "w") as f:
        json.dump({"images": [im for im in coco["images"]
                              if im["id"] in keep],
                   "annotations": [a for a in coco["annotations"]
                                   if a["image_id"] in keep],
                   "categories": coco.get("categories", [])}, f)
    return dst


def phase_train_family(dev, card, arch, img_dir, splits):
    """``train-localizer --device cuda --arch <arch>`` with the fcos_train
    recipe at full width on the first N_FAMILY_TRAIN_LINES of phase
    train_localizer's train lines, run in this process with every K1
    call (the evaluations'; the R-CNN's RPN in every step too) held bit
    for bit against nms_mask once the run has returned (``NmsCheck``
    with ``defer``: the timed epochs hold no check and no host sync of
    it); prints steps/s and images/s of the third epoch
    (the first at height 64 after its first), the logged losses, AP of
    the evaluation and the test split, and peak device memory."""
    import io

    from effocr_torch.cli import train_localizer

    tag = f"train_{arch.split('_')[0]}"
    run_dir = os.path.join(WORK, tag, "loc")
    shutil.rmtree(run_dir, ignore_errors=True)
    train = _coco_head(splits["train"], N_FAMILY_TRAIN_LINES,
                       os.path.join(WORK, tag, "train.json"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    cuda_nms.nms_kernel.launches = cuda_top1.top1_kernel.launches = 0
    with kernels_checked(tag, defer=True) as (k1c, _), \
            contextlib.redirect_stdout(out):
        train_localizer.main([
            "--device", "cuda", "--image_dir", img_dir, "--train_coco",
            train, "--val_coco", splits["val"], "--test_coco",
            splits["test"], "--run_name", run_dir, "--arch", arch,
            *FAMILY_TRAIN_FLAGS])
    k1_launches = cuda_nms.nms_kernel.launches
    k2_launches = cuda_top1.top1_kernel.launches
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    checked = k1c.verify()
    check_s = time.perf_counter() - t0
    with open(os.path.join(WORK, f"{tag}.log"), "w") as f:
        f.write(out.getvalue())
    recs = _metrics(run_dir)
    losses = [(r["step"], r["train/loss"], r["loss/box"], r["loss/obj"],
               r["loss/cls"]) for r in recs if "train/loss" in r]
    epochs = [r for r in recs if "epoch/steps" in r]
    timed = epochs[2:]
    steps_s = sum(r["epoch/steps"] for r in timed) / sum(
        r["epoch/seconds"] for r in timed)
    images_s = steps_s * 16
    evals = [{k: r[k] for k in ("bbox/AP", "bbox/AP50", "bbox/AP75")}
             for r in recs if "bbox/AP" in r]
    test = [{k: r[f"test/{k}"] for k in ("bbox/AP", "bbox/AP50",
                                          "bbox/AP75")}
            for r in recs if "test/bbox/AP" in r][-1]
    peak = [r["device/peak_gib"] for r in recs if "device/peak_gib" in r][-1]
    with open(os.path.join(run_dir, "model.json")) as f:
        meta = json.load(f)
    numbers = [v for row in losses for v in row[1:]] + [steps_s, peak] + [
        v for e in evals + [test] for v in e.values()]
    if (len(losses) < 2 or not all(np.isfinite(v) for v in numbers)
            or meta["anchors"] is not None or k1_launches == 0
            or not k1_launches == k1c.calls == checked):
        raise AssertionError(f"{tag}: losses {losses}, evals {evals}, test "
                             f"{test}, anchors {meta['anchors']}, K1 "
                             f"launches {k1_launches}, calls {k1c.calls}, "
                             f"checked {checked}")
    if not losses[-1][1] < losses[0][1]:
        raise AssertionError(f"{tag}: the last logged loss {losses[-1]} is "
                             f"not below the first {losses[0]}")
    log(f"{tag}: train-localizer --arch {arch} returned in {wall:.1f} s "
        f"(corpus letterbox and evaluations included); epochs "
        f"{[round(r['epoch/seconds'], 3) for r in epochs]} s at heights "
        f"{[int(r['epoch/height']) for r in epochs]}, "
        f"{int(epochs[0]['epoch/steps'])} steps of 16 each; epoch 3: "
        f"{steps_s:.2f} optimizer steps/s = {images_s:.1f} images/s "
        f"({card}; K1's inputs copied on the device in the run, checked "
        f"after it)")
    log(f"{tag}: logged (step, loss, box, obj, cls) {losses}")
    log(f"{tag}: val AP / AP50 / AP75 {evals}; test (best checkpoint) "
        f"{test}; peak device memory {peak:.3f} GiB ({card}); K1 launched "
        f"{k1_launches} times, K2 {k2_launches}; every K1 call held bit "
        f"for bit against nms_mask after the run ({checked} calls by IoU "
        f"{k1c.by_thr}, {k1c.boxes} valid boxes; {check_s:.1f} s); "
        f"model.json anchors {meta['anchors']}")
    return dict(k1_launches=k1_launches, k2_launches=k2_launches,
                k1_calls_by_iou=k1c.by_thr,
                steps_s=steps_s, images_s=images_s, losses=losses,
                val_ap=evals, test_ap=test, peak_train_gib=peak,
                train_wall_s=wall,
                epoch_seconds=[r["epoch/seconds"] for r in epochs],
                run_dir=run_dir)


def phase_train_xcit(dev, card, tree):
    """``train-recognizer --device cuda`` with the en recipe's flags and
    xcit_small_12_p8_224 at 224 px (2 epochs of 10 passes) on phase
    train's char tree, then ``build-index --test``."""
    run_dir = os.path.join(WORK, "train_xcit", "rec")
    splits = {k: os.path.join(os.path.dirname(tree), f"{k}.json")
              for k in ("train", "val", "test")}
    stdout, wall = run_cli(
        ["train-recognizer", "--device", "cuda", "--root_dir_path", tree,
         "--train_ann_path", splits["train"], "--val_ann_path",
         splits["val"], "--test_ann_path", splits["test"], "--run_name",
         run_dir, *XCIT_TRAIN_FLAGS], "train_xcit")
    recs = _metrics(run_dir)
    losses = [(r["step"], r["train/loss"]) for r in recs
              if "train/loss" in r]
    epochs = [r for r in recs if "epoch/steps" in r]
    steps_s = epochs[-1]["epoch/steps"] / epochs[-1]["epoch/seconds"]
    images_s = epochs[-1]["epoch/images"] / epochs[-1]["epoch/seconds"]
    val = [r["val/accuracy"] for r in recs if "val/accuracy" in r]
    peak = [r["device/peak_gib"] for r in recs if "device/peak_gib" in r][-1]
    test_acc = _after(stdout, "Final test acc: ")
    if len(losses) < 2 or not all(np.isfinite(v) for _, v in losses):
        raise AssertionError(f"train_xcit: losses {losses}")
    log(f"train_xcit: train-recognizer --auto_model {XCIT_ARCH} --imsize "
        f"224 exited 0 in {wall:.1f} s; epochs "
        f"{[round(r['epoch/seconds'], 3) for r in epochs]} s for "
        f"{[int(r['epoch/steps']) for r in epochs]} steps of 128 images; "
        f"epoch 2: {steps_s:.2f} optimizer steps/s = {images_s:.1f} "
        f"images/s ({card}); losses {losses}; val p@1 {val}; test p@1 "
        f"{test_acc}; peak device memory {peak:.3f} GiB")
    stdout, bwall = run_cli(["build-index", "--device", "cuda", "--run_dir",
                             run_dir, "--test"], "build_index_xcit")
    test_p1 = _after(stdout, "Test precision@1: ")
    log(f"train_xcit: build-index --test exited 0 in {bwall:.1f} s: test "
        f"p@1 {test_p1}")
    return dict(steps_s=steps_s, images_s=images_s, losses=losses,
                val_p1=val, test_p1=test_acc, build_index_test_p1=test_p1,
                peak_train_gib=peak, train_wall_s=wall, run_dir=run_dir,
                epoch_seconds=[r["epoch/seconds"] for r in epochs])


# the localizers' CPU reference computes these parts in float64: the stem
# convolution's weight gradient sums a near-constant page background
# against an upstream gradient that train-mode BatchNorm's backward makes
# sum to ~0; at trained weights the CPU's float32 sum of it rounds past
# 1e-3 of the largest |g| on some batches, while the card's float32 step
# stays near a float64 one (the witnesses ``_card_vs_cpu`` logs; the
# recognizer's case: REC_F32_GRAD_TOL)
FAMILY_CPU_REF = ("stem",)
# an R-CNN step's discrete decisions (proposal choice, box-head ReLU
# gates) that differ between the card and the CPU must be rounding ties:
# within this share of the largest |score| / |pre-activation|
RCNN_TIE = 1e-4


@contextlib.contextmanager
def _rcnn_probe(model, seen, pins=None):
    """Records an R-CNN step's RPN candidates and proposals (the inputs
    and outputs of ``model._proposals``) and its box head's
    pre-activations (the arguments of ``torch.relu``) into ``seen``.
    ``pins`` (the card step's record and a [B, P] mask of proposal
    slots): those slots take the card step's proposals, and every
    pre-activation whose sign differs from the card step's takes the
    card's gate, its |x| over the layer's largest |x| listed in
    ``seen["flips"]``; every other decision is this step's own."""
    proposals, relu = model._proposals, torch.relu
    seen.update(acts=[], flips=[])

    def keep(boxes, scores):
        props, valid = proposals(boxes, scores)
        if pins is not None:
            slots = pins["slots"].to(boxes.device)
            card_p, card_v = (t.to(boxes.device)
                              for t in pins["card"]["props"])
            props = torch.where(slots[..., None], card_p, props)
            valid = torch.where(slots, card_v, valid)
        seen["cand"] = (boxes.cpu(), scores.cpu())
        seen["props"] = (props.cpu(), valid.cpu())
        return props, valid

    def gate(x):
        xs = x.detach().float().cpu()
        seen["acts"].append(xs)
        if pins is None:
            return relu(x)
        card = pins["card"]["acts"][len(seen["acts"]) - 1]
        flip = (xs > 0) != (card > 0)
        seen["flips"] += (xs[flip].abs() / card.abs().max()).tolist()
        g = torch.where(flip, card > 0, xs > 0)
        return x * g.to(device=x.device, dtype=x.dtype)

    model._proposals = keep
    torch.relu = gate
    try:
        yield
    finally:
        model._proposals, torch.relu = proposals, relu


def _pick_scores(cand, props):
    """The score of the candidate each proposal slot took."""
    boxes, scores = cand
    hit = (boxes[:, :, None, :] == props[:, None, :, :]).all(-1)
    return torch.gather(scores, 1, hit.float().argmax(1))


def _rcnn_ties(tag, base, seen, gerr, rerun):
    """The R-CNN's RPN selection and gates, card against CPU.  The card's
    selection (stable sort, K1, top-k) fed the CPU step's candidates must
    give the CPU step's proposals bit for bit, and the CPU's selection
    fed the card's candidates the card's.  When the free steps' gradients
    differ by more than 1e-3 of the largest, the proposal slots that took
    another candidate and the gates whose sign differs are counted, with
    their margins; each must be a rounding tie (RCNN_TIE), and the CPU
    step with only those pinned to the card's (``rerun``) must meet the
    card at 1e-3."""
    card, cpu = seen["cuda"], seen["cpu"]
    for name, cand, want in (
            ("card selection on the CPU's candidates",
             [t.to("cuda") for t in cpu["cand"]], cpu["props"]),
            ("CPU selection on the card's candidates", card["cand"],
             card["props"])):
        got = [t.cpu() for t in base._proposals(*cand)]
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"family_steps_vs_cpu: {tag}: the {name} "
                                 "differs from that step's proposals")
    sc_card, sc_cpu = card["cand"][1], cpu["cand"][1]
    cand_spread = float((sc_card.sort(-1)[0] - sc_cpu.sort(-1)[0]).abs()
                        .max() / sc_cpu.abs().max())
    (pc, vc), (pu, vu) = card["props"], cpu["props"]
    dist = (pc - pu).abs().amax(-1)
    slots = (vc != vu) | (vc & vu & (dist > 0.5))
    shift = float(dist[vc & vu & ~slots].max())
    out = dict(selection_cross_checked=True, candidate_score_spread=
               cand_spread, proposal_shift_px=shift,
               differing_slots=int(slots.sum()), gate_flips=None,
               pinned_grad_rel_err=None)
    note = (f"{tag}: RPN selection bit for bit across devices on the same "
            f"candidates (both ways); candidate scores card vs CPU "
            f"{cand_spread:.3g} of the largest; proposals on the same "
            f"candidate moved {shift:.3g} px")
    if gerr <= 1e-3:
        log(f"family_steps_vs_cpu: {note}; nothing pinned")
        return out
    gaps = (_pick_scores(card["cand"], pc) - _pick_scores(cpu["cand"], pu)
            )[slots & vc & vu].abs() / sc_cpu.abs().max()
    pinned = {}
    grads = rerun(pinned, dict(card=card, slots=slots))
    flips = pinned["flips"]
    acts = max(float((a - c).abs().max() / c.abs().max())
               for a, c in zip(pinned["acts"], card["acts"]))
    out.update(gate_flips=len(flips), pinned_grad_rel_err=grads,
               pick_score_gaps=gaps.tolist(), gate_flip_margins=flips,
               preactivation_spread=acts)
    log(f"family_steps_vs_cpu: {note}; free steps {gerr:.3g} apart: "
        f"{int(slots.sum())} proposal slots took another candidate (pick "
        f"score gaps {[f'{g:.3g}' for g in gaps.tolist()]} of the largest "
        f"score), then, with those slots given the card's proposals, "
        f"{len(flips)} box-head gates of {sum(a.numel() for a in card['acts'])}"
        f" differ in sign (|x| {[f'{f:.3g}' for f in flips[:8]]} of the "
        f"layer's largest; pre-activations card vs CPU {acts:.3g}); with "
        f"only those pinned to the card's: {grads:.3g} (tolerance 1e-3)")
    if (cand_spread > RCNN_TIE or any(f > RCNN_TIE for f in flips)
            or grads > 1e-3):
        raise AssertionError(f"family_steps_vs_cpu: {tag}: the decisions "
                             "that differ are not rounding ties, or pinning "
                             "them leaves the steps apart")
    return out


def _card_vs_cpu(tag, base, step_of, batch, cpu_ref=None):
    """One float32 step of ``base`` (a CPU module) on the card and on the
    CPU on the same batch: loss within 1e-5 relative, gradients within
    1e-3 of the largest |g|, new batch_stats within 1e-3 of the largest.
    ``cpu_ref``: the module the CPU's step runs instead of ``base`` (a
    localizer with its stem in float64, FAMILY_CPU_REF); the CPU's
    float32 step of ``base`` and a float64 one are then run too, and the
    distances of the three steps from the float64 one logged.  An
    R-CNN's discrete decisions are checked across devices
    (``_rcnn_ties``)."""
    import copy

    rcnn = hasattr(base, "num_proposals")

    def to(a, where):
        if isinstance(a, dict):
            return {k: v.to(where) for k, v in a.items()}
        return a.to(where) if torch.is_tensor(a) else a

    def run(where, seen=None, pins=None, src=None):
        if src is None:
            src = base if where == "cuda" or cpu_ref is None else cpu_ref
        model = copy.deepcopy(src).to(where)
        rec = GradRecorder(dict(model.named_parameters()))
        t0 = time.perf_counter()
        with (_rcnn_probe(model, seen, pins) if rcnn
              else contextlib.nullcontext()):
            loss = step_of(model, rec)(*(to(a, where) for a in batch))
        loss = float(loss[0] if isinstance(loss, tuple) else loss)
        return (loss, rec.grads, time.perf_counter() - t0,
                {k: v.float().cpu() for k, v in
                 model.state_dict().items() if "running" in k})

    def grad_err(got, ref):
        gmax = max(float(g.abs().max()) for g in ref.values())
        return max(float((got[k] - ref[k]).abs().max()) for k in ref) / gmax

    seen = {"cuda": {}, "cpu": {}}
    (lg, gg, _, sg), (lc, gc, cpu_s, sc) = (run(w, seen[w])
                                            for w in ("cuda", "cpu"))
    gerr = grad_err(gg, gc)
    smax = max([float(v.abs().max()) for v in sc.values()] or [1.0])
    serr = max([float((sg[k] - sc[k]).abs().max()) for k in sc] or [0.0]
               ) / smax
    lerr = abs(lg - lc) / abs(lc)
    ref = "CPU" if cpu_ref is None else "CPU (stem in float64)"
    log(f"family_steps_vs_cpu: {tag}: loss card {lg:.6f} {ref} {lc:.6f} "
        f"(rel {lerr:.3g}, tolerance 1e-5); max |grad diff| / max|g| "
        f"{gerr:.3g} over {len(gc)} tensors, max |batch_stats diff| / "
        f"max|stat| {serr:.3g} (tolerance 1e-3); CPU step {cpu_s:.1f} s")
    out = dict(loss_rel_err=lerr, grad_rel_err=gerr, stats_rel_err=serr,
               cpu_step_s=cpu_s)
    if cpu_ref is not None:
        # the witnesses (logged, not held): the CPU's float32 step of
        # ``base`` and a float64 one
        gf = run("cpu", {}, src=base)[1]
        g64 = run("cpu", {}, src=_f64_copy(base))[1]
        worst = max(gc, key=lambda k: float((gf[k] - gc[k]).abs().max()))
        out.update(cpu_f32_vs_card=grad_err(gf, gg), cpu_f32_worst=worst,
                   **{f"{k}_vs_f64": grad_err(g, g64) for k, g in (
                       ("card", gg), ("cpu_f32", gf), ("reference", gc))})
        log(f"family_steps_vs_cpu: {tag}: the CPU's float32 step is "
            f"{out['cpu_f32_vs_card']:.3g} of the largest |g| from the "
            f"card's (from the reference most in {worst}); from a float64 "
            f"step: card "
            f"{out['card_vs_f64']:.3g}, CPU float32 "
            f"{out['cpu_f32_vs_f64']:.3g}, the reference "
            f"{out['reference_vs_f64']:.3g} (logged, not held)")
    if rcnn:
        out.update(_rcnn_ties(tag, base, seen, gerr, lambda into, pins:
                              grad_err(gg, run("cpu", into, pins)[1])))
        if out["pinned_grad_rel_err"] is not None:
            gerr = out["pinned_grad_rel_err"]
    if not (lerr <= 1e-5 and gerr <= 1e-3 and serr <= 1e-3):
        raise AssertionError(f"family_steps_vs_cpu: {tag}: card and CPU "
                             "disagree")
    return out


def phase_family_steps(dev, card, tree, loc_runs, xcit_run, img_dir,
                       splits):
    """One float32 step of each new family at full width on the card and
    on the CPU (``_card_vs_cpu``), from the weights trained in the phases
    before: the XCiT recognizer (bank step, batch 16 of 224 px, aux head,
    augmentation on fixed draws) and the FCOS and R-CNN localizers
    (batch 4 of 96 x 1024, no augmentation)."""
    from effocr_torch.core.config import (
        EncoderConfig,
        LocalizerConfig,
        LocalizerTrainConfig,
        RecognizerTrainConfig,
    )
    from effocr_torch.data.detection import DetectionDataset
    from effocr_torch.data.folder import CharFolderDataset
    from effocr_torch.data.transforms import draw_augment
    from effocr_torch.train import checkpoint as ckpt
    from effocr_torch.train.localizer import make_detector_train_step
    from effocr_torch.train.recognizer import make_train_step

    out = {}
    cfg = RecognizerTrainConfig(
        encoder=EncoderConfig(arch=XCIT_ARCH, image_size=224,
                              input_channels=1),
        batch_size=16, lang="en", paired_jitter=0.1, aux_ce_weight=1.0)
    ds = CharFolderDataset(tree)
    bank = torch.from_numpy(ds.decode_all_gray(224))
    targets = torch.tensor(ds.targets)
    paired = torch.tensor([ds.is_paired(i) for i in range(len(ds))])
    idx = torch.from_numpy(np.random.default_rng(SEED + 95).choice(
        len(ds), 16, replace=False))
    draws = draw_augment(torch.Generator().manual_seed(SEED + 96), 16, 224,
                         lang="en", paired_jitter=0.1)
    enc = create_encoder(XCIT_ARCH, in_channels=1, dtype=torch.float32,
                         image_size=224)
    enc.load_state_dict(flax_to_state_dict(ckpt.load_variables(
        os.path.join(xcit_run, "enc_best.msgpack"))))
    aux0 = torch.randn((len(ds.classes), enc.out_features),
                       generator=torch.Generator().manual_seed(SEED + 97)
                       ) * 0.02

    def xcit_step(model, rec):
        aux = aux0.clone().to(next(model.parameters()).device
                              ).requires_grad_()
        rec.named["aux"] = aux
        return make_train_step(model, cfg, rec, False, aux=aux,
                               bank_mode=True)

    out[XCIT_ARCH] = _card_vs_cpu(
        f"{XCIT_ARCH} recognizer, batch 16 x 224 px", enc, xcit_step,
        (bank, targets, paired, idx, draws))
    ds = DetectionDataset(splits["test"], img_dir, 1024, input_height=96,
                          channels=1)
    imgs, tgts, masks, _ = next(ds.batches(4, shuffle=False))
    batch = [torch.from_numpy(a) for a in (imgs, tgts, masks)]
    for arch, run_dir in loc_runs.items():
        lcfg = LocalizerTrainConfig(localizer=LocalizerConfig(
            arch=arch, input_size=1024, input_height=96, input_channels=1))
        model = create_localizer(arch, 2, in_channels=1,
                                 dtype=torch.float32)
        model.load_state_dict(flax_to_state_dict(ckpt.load_variables(
            ckpt.best_checkpoint_path(run_dir, "best_bbox_mAP"))))
        out[arch] = _card_vs_cpu(
            f"{arch} localizer, batch 4 x 96 x 1024", model,
            lambda m, rec: make_detector_train_step(m, lcfg, rec, None),
            (*batch, None), cpu_ref=_f64_stem(model, FAMILY_CPU_REF))
    return out


def profile_run(engine, paths, card, out_dir, tag):
    """torch.profiler over one chunk of ``paths``, prepared, issued and
    finished on this thread (the profiler records the CPU-side ranges of
    the thread it runs on): device time per engine stage (the
    record_function ranges of pipelines/infer.py), the top kernels, and
    the device busy share of the chunk's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from effocr_torch.pipelines.infer import _LazyImage

    chunk = [_LazyImage(p, gray=engine.config.input_channels == 1)
             for p in paths]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        handle = engine._dispatch_chunk(chunk, paths)
        engine._finish_fused(handle, {}, {}, want_coco=False)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    with open(os.path.join(out_dir, f"profile_table_{tag}.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=40))
    # device-side events: the kernels, plus one span per stage range
    dev_events = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in dev_events
               if not e.key.startswith(("ocr/", "rcnn/"))]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile {tag}: one chunk of {len(paths)} lines ({card}); wall "
        f"{wall_ms:.1f} ms (profiler on), device kernel time "
        f"{kernel_ms:.1f} ms in {sum(e.count for e in kernels)} kernel "
        f"launches, busy share {kernel_ms / wall_ms:.3f}")
    stage = ("ocr/", "rcnn/")
    spans = {e.key: e.device_time_total / 1e3 for e in dev_events
             if e.key.startswith(stage)}
    for e in sorted((e for e in events if e.key.startswith(stage)
                     and e.device_type == torch.autograd.DeviceType.CPU),
                    key=lambda e: -e.device_time_total):
        log(f"profile {tag}: stage {e.key:16s} kernels "
            f"{e.device_time_total / 1e3:8.2f}"
            f" ms  device span {spans.get(e.key, 0.0):8.2f} ms  host "
            f"{e.cpu_time_total / 1e3:8.2f} ms  x{e.count}  (kernels "
            "launched through ctypes are not attributed to a stage)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"profile {tag}: kernel {e.self_device_time_total / 1e3:8.2f} ms "
            f"x{e.count:<5d} {e.key[:90]}")
    # the hand-written kernels by name (their ctypes launches sit outside
    # the stage ranges)
    for name in ("nms_build_kernel", "nms_scan_kernel",
                 "top1_partial_kernel", "top1_combine_kernel"):
        ms = sum(e.self_device_time_total for e in kernels
                 if name in e.key) / 1e3
        n = sum(e.count for e in kernels if name in e.key)
        log(f"profile {tag}: {name} {ms:.3f} ms x{n}")


def _chars_per_line(coco):
    per = {im["id"]: [] for im in coco["images"]}
    for a in coco["annotations"]:
        per[a["image_id"]].append(a["text"])
    return list(per.values())


def models_vs_cpu(engine, two_paths):
    """Both models in float32, on the card vs on the CPU, on real inputs:
    2 lines letterboxed to the engine's canvas, and 16 crops of them (the
    canvas's top-left square resized to the encoder's input size)."""
    c = engine.config
    size = c.localizer.input_size
    x = torch.from_numpy(letterboxed(
        two_paths, c.input_channels, size,
        c.localizer.input_height or size)).float() / 255.0
    side = min(x.shape[1], x.shape[2])
    crops = torch.nn.functional.interpolate(
        x[:, :side, :side].permute(0, 3, 1, 2),
        size=(c.encoder.image_size,) * 2).permute(0, 2, 3, 1).repeat(
            8, 1, 1, 1)
    for name, model, inp, detector in (
        (c.localizer.arch, engine.localizer, x, True),
        (c.encoder.arch, engine.encoder, crops, False),
    ):
        gpu = _f32_copy(model, "cuda")
        cpu = _f32_copy(model, "cpu")
        with torch.no_grad():
            g = gpu(inp.cuda())
            r = cpu(inp)
        g = (g[0] if isinstance(g, tuple) else g).float().cpu()
        r = (r[0] if isinstance(r, tuple) else r).float()
        if detector:
            err = float((g[..., 4:] - r[..., 4:]).abs().max())
        else:
            err = float((g - r).abs().max() / r.abs().max())
        tol = 1e-3
        log(f"models: {name} float32 card vs CPU max |d| "
            f"{'prob' if detector else 'rel'} {err:.3g} (tolerance {tol})")
        if not err <= tol:
            raise AssertionError(f"{name}: card and CPU disagree ({err})")


def _f32_copy(model, device):
    import copy

    m = copy.deepcopy(model).to(device).float()
    for mod in m.modules():
        if hasattr(mod, "dtype") and mod.dtype == torch.bfloat16:
            mod.dtype = torch.float32
    return m.eval()


# ------------------------------------------------------- data parallelism
N_DP_EN = 512
N_DP_JP = 240
N_DDP_LOC_LINES = 160       # 10 steps of 16 for the localizer's DDP epoch
DDP_REC_PASSES = "10"       # 28 steps of 128 for the recognizer's (20: 56)
DP_STEP_TOL = 1e-4          # gradients and batch_stats, of the largest
# the recognizer's float32 gradients, of the largest (2 ranks vs 1, and
# each against its float64 step): the stem convolution's weight
# gradient sums a near-constant glyph background against an upstream
# gradient that BatchNorm's backward makes sum to ~0, so its float32
# rounding follows the summation order (batch split, threads,
# algorithm) at up to ~1e-3: 1 rank 2.45e-4 and 2 ranks 1.02e-3 from
# float64 on the card, 3.1e-4 / 6.4e-4 on the CPU by thread count; with
# the stem and the first two blocks in float64 (``_f64_stem``) the step
# is ~2e-6 from float64 (CPU), and 2 ranks are held to 1 at DP_STEP_TOL
REC_F32_GRAD_TOL = 2e-3


def _step_errors(ref, got):
    """(max |grad diff| / max|g|, max |batch_stats diff| / max|stat|)."""
    gmax = max(float(g.abs().max()) for g in ref["grads"].values())
    smax = max(float(v.abs().max()) for v in ref["buffers"].values())
    return (max(float((got["grads"][k] - g).abs().max())
                for k, g in ref["grads"].items()) / gmax,
            max(float((got["buffers"][k] - v).abs().max())
                for k, v in ref["buffers"].items()) / smax)


def _two_vs_one(one, two):
    """(loss rel, grads, batch_stats) of a 2-rank step against 1 rank."""
    return (abs(two["loss"] - one["loss"]) / abs(one["loss"]),
            *_step_errors(one, two))


def _f64_copy(model):
    """``model`` with float64 parameters, convolutions, BatchNorm and
    Dense layers: a float64 evaluation of its step."""
    import copy

    m = copy.deepcopy(model).double()
    for mod in m.modules():
        if hasattr(mod, "dtype"):
            mod.dtype = torch.float64
    return m


def _f64_stem(model, parts=("stem", "block0", "block1")):
    """``model`` whose ``parts`` (by default a mobilenetv3's stem and
    first two blocks) compute in float64, parameters float32: the
    rounding REC_F32_GRAD_TOL names taken out of its float32 step (and,
    for a CSPTrunk localizer's ``stem``, FAMILY_CPU_REF's)."""
    import copy

    m = copy.deepcopy(model)
    for name in parts:
        for mod in getattr(m, name).modules():
            if hasattr(mod, "dtype"):
                mod.dtype = torch.float64
    return m


SINGLE_MSG = "--data_parallel: single device visible; running unsharded"


def _replicated(engine, n=2, f32=False, **changes):
    """The engine's models, index and config (with ``changes``) as
    ``EffOCRInference(devices=[cuda:0] * n)``: n replicas on the card (n =
    1: unsharded).  ``f32``: float32 copies of the models (convolutions in
    float32, TF32 off)."""
    from effocr_torch.pipelines.infer import EffOCRInference

    loc, enc = engine.localizer, engine.encoder
    if f32:
        loc, enc = _f32_copy(loc, "cuda"), _f32_copy(enc, "cuda")
        changes["compute_dtype"] = "f32"
    cfg = dataclasses.replace(engine.config, **changes)
    return EffOCRInference(cfg, loc, enc, engine.index, device="cuda",
                           class_map=engine.class_map,
                           devices=[torch.device("cuda", 0)] * n)


def _coco_by_line(coco):
    """COCO output keyed by line, free of the order lines finished in."""
    out = {}
    for im in coco["images"]:
        anns = [{k: v for k, v in a.items() if k not in ("id", "image_id")}
                for a in coco["annotations"] if a["image_id"] == im["id"]]
        out[im["file_name"]] = json.dumps(
            [{k: v for k, v in im.items() if k != "id"}, anns],
            sort_keys=True)
    return out


def _differing(got, ref):
    """(lines whose text differs, lines whose COCO boxes differ)."""
    (rg, cg), (rr, cr) = got, ref
    if set(rg) != set(rr):
        raise AssertionError("the engines read different sets of lines")
    by_g, by_r = _coco_by_line(cg), _coco_by_line(cr)
    return (sum(rg[k] != v for k, v in rr.items()),
            sum(by_g[k] != by_r[k] for k in by_r))


def _same_output(tag, got, ref):
    """Text and COCO boxes bit for bit, line by line (the whole JSON too
    when no line spilled: the order is then the same)."""
    n_text, n_box = _differing(got, ref)
    if n_text or n_box:
        raise AssertionError(f"{tag}: {n_text} lines' text and {n_box} "
                             "lines' COCO boxes differ from the unsharded "
                             "engine")
    return json.dumps(got[1], sort_keys=True) == json.dumps(ref[1],
                                                            sort_keys=True)


def _timed_unsharded(engine, paths, tag, k2=False):
    """The unsharded engine's output (its first K2 input kept), then its
    lines/s in a second, timed run."""
    with kernels_checked(tag, k2) as (_, k2c):
        ref = engine.run(paths, return_coco=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(paths)
    torch.cuda.synchronize()
    return ref, len(paths) / (time.perf_counter() - t0), k2c.first


def _dp_path(card, engine, paths, tag, k2=False):
    """One path on 2 replicas: the recipe's engine through
    ``checked_runs`` beside the unsharded engine's lines/s.  Then bit for
    bit, text and COCO boxes: the replicas on the fixed canvas against
    the unsharded engine on it at a replica's batch (line_batch / 2
    lines, crop_batch / 2 slots), in the recipe's bfloat16; and float32
    copies of the models on 2 replicas against them unsharded, canvas
    and batch as the recipe has them.  (cuDNN's bfloat16 detector
    convolutions at batch line_batch / 2 round differently from those at
    line_batch, so the bfloat16 replicas and the unsharded engine at the
    recipe's batch may differ; the lines that do are counted.)"""
    ref, ref_lines_s, k2_in = _timed_unsharded(engine, paths,
                                               f"{tag} unsharded", k2)
    dp = _replicated(engine)
    run = checked_runs(dp, paths, tag, k2=k2)
    bf16_text, bf16_box = _differing(dp.run(paths, return_coco=True), ref)
    c, fixed = engine.config, dict(adaptive_height=False,
                                   adaptive_width=False)
    half = _replicated(engine, 1, line_batch=c.line_batch // 2,
                       crop_batch=c.crop_batch // 2, **fixed).run(
        paths, return_coco=True)
    whole16 = _same_output(f"{tag} bfloat16", _replicated(
        engine, **fixed).run(paths, return_coco=True), half)
    f32_ref = _replicated(engine, 1, f32=True).run(paths, return_coco=True)
    whole32 = _same_output(f"{tag} float32", _replicated(
        engine, f32=True).run(paths, return_coco=True), f32_ref)
    out = report(tag, run, card,
                 f"; 2 replicas on 1 card (correctness, not scaling); the "
                 f"unsharded engine {ref_lines_s:.1f} lines/s in this phase;"
                 f" text and COCO boxes bit for bit: bfloat16 replicas on "
                 f"the fixed canvas against the unsharded engine at "
                 f"{c.line_batch // 2} lines and {c.crop_batch // 2} slots "
                 f"(whole JSON equal: {whole16}), float32 models on the "
                 f"recipe's canvas and batch (whole JSON equal: {whole32}); "
                 f"bfloat16 at the recipe's batch: {bf16_text} lines' text "
                 f"and {bf16_box} lines' boxes differ from the unsharded "
                 "engine")
    out.update(unsharded_lines_s=ref_lines_s, bf16_lines_differ=bf16_text,
               bf16_boxes_differ=bf16_box)
    return out, k2_in


def phase_data_parallel(dev, card, sl, jp):
    """``EffOCRInference(devices=[cuda:0, cuda:0])``, two replicas on the
    one card, each on half of every chunk with half the crop cap
    (``_dp_path``): the en flags on N_DP_EN lines and the jp flags (K2)
    on N_DP_JP lines;
    then float32 en models with a crop cap under the first replica's
    glyphs (its segment spills lines into a re-dispatch) through
    ``checked_runs``, bit for bit with the unsharded float32 engine.
    ``load_engine --data_parallel`` with one card must print the JAX
    command's message and build an unsharded engine.  Then
    ``knn_topk_sharded`` over 2 shards of the jp index at the jp path's
    K2 input against unsharded K2: indices exact, scores 1e-5.  Lines/s
    of 2 replicas on 1 card measure that the layout is right, not
    scaling."""
    from effocr_torch.kernels.retrieval import knn_topk_sharded

    out = {}
    msg = io.StringIO()
    with contextlib.redirect_stdout(msg):
        en = load_engine(engine_args(sl["loc_dir"], sl["rec_dir"],
                                     "--data_parallel"))
    if SINGLE_MSG not in msg.getvalue() or len(en._replicas) != 1:
        raise AssertionError("data_parallel: load_engine with one card did "
                             f"not say {SINGLE_MSG!r}: {msg.getvalue()!r}")
    log(f"data_parallel: load_engine --data_parallel on 1 card printed "
        f"{SINGLE_MSG!r} and built an unsharded engine")
    paths = sl["paths"][:N_DP_EN]
    out["en"] = _dp_path(card, en, paths, "dp_en")[0]

    # a crop cap under the first replica's glyphs: its segment spills.
    # The spilled lines ride a dispatch of their own, whose adaptive
    # canvas is cut to them, so the canvas is fixed here (as it is
    # whenever a chunk's lines fill it); and the unsharded reference has
    # the replicas' crop-slot count (cuBLAS may round the retrieval
    # matmul differently at another row count), so it spills as well
    fixed = dict(adaptive_height=False, adaptive_width=False)
    probe = _replicated(en, 1, f32=True, **fixed).run(paths,
                                                      return_coco=True)
    chars = [len(c) for c in _chars_per_line(probe[1])]
    per = en.config.line_batch // 2
    first, second = sum(chars[:per]), sum(chars[per:2 * per])
    sub = en.config.encoder_sub_batch
    cap = max(sub, (first - 1) // sub * sub)
    f32_ref = _replicated(en, 1, f32=True, crop_batch=cap, **fixed).run(
        paths, return_coco=True)
    spill = _replicated(en, f32=True, crop_batch=2 * cap, **fixed)
    srun = checked_runs(spill, paths, "dp_spill")
    if srun["spilled"] < 1:
        raise AssertionError("dp_spill: no segment spilled")
    _same_output("dp_spill", spill.run(paths, return_coco=True), f32_ref)
    out["spill"] = report("dp_spill", srun, card,
                          f"; float32 models on the fixed 96 x 1024 canvas, "
                          f"crop cap {cap} a replica against {first} / "
                          f"{second} glyphs in the two halves of the chunk; "
                          "text and COCO boxes bit for bit with the "
                          "unsharded float32 engine at that crop cap")

    jeng = load_engine(jp_engine_args(jp["loc_dir"], jp["rec_dir"],
                                      "--nms_kernel", "pallas"))
    out["jp"], k2_in = _dp_path(card, jeng, jp["paths"][:N_DP_JP],
                                "dp_jp", k2=True)

    # the jp index over 2 shards at the path's K2 input
    q, p, mask = k2_in
    two = [torch.device("cuda", 0)] * 2
    cuda_top1.top1_kernel.launches = 0
    with kernels_checked("knn_topk_sharded", k2=True) as (_, k2c):
        s_sh, i_sh = knn_topk_sharded(q, p, two, k=1, row_mask=mask,
                                      normalize_queries=False)
    torch.cuda.synchronize()
    knn_launches = cuda_top1.top1_kernel.launches
    s_un, i_un = cuda_top1.top1(q, p, mask)
    same = torch.equal(i_sh[:, 0], i_un.long())
    err = float((s_sh[:, 0] - s_un).abs().max())
    if knn_launches != 2 or not same or err > K2_TOL:
        raise AssertionError(f"knn_topk_sharded: {knn_launches} K2 "
                             f"launches, indices equal {same}, max|score "
                             f"diff| {err:.3g}")
    sh_ms = device_ms(lambda: knn_topk_sharded(
        q, p, two, k=1, row_mask=mask, normalize_queries=False))
    un_ms = device_ms(lambda: cuda_top1.top1(q, p, mask))
    log(f"knn_topk_sharded: [{q.shape[0]}, {q.shape[1]}] x [{p.shape[0]}, "
        f"{p.shape[1]}] over 2 shards on cuda:0: indices equal to "
        f"unsharded K2, max|score diff| {err:.3g}; each shard's K2 held to "
        f"top1_plain ({k2c.calls} calls, {k2c.differs} low-margin index "
        f"differences); {sh_ms:.4f} ms sharded vs {un_ms:.4f} ms unsharded "
        f"({card})")
    out["knn_sharded"] = dict(k2_launches=knn_launches, max_abs_err=err,
                              ms=sh_ms, unsharded_ms=un_ms)
    out["k1_launches"] = sum(out[k]["k1_launches"]
                             for k in ("en", "spill", "jp"))
    out["k2_launches"] = out["jp"]["k2_launches"] + knn_launches
    out["k2_max_err"] = max(err, out["jp"]["k2_max_err"], k2c.max_err)
    return out


def run_torchrun(nproc, args, tag, timeout=900):
    """``torchrun --standalone --nproc_per_node nproc -m effocr_torch
    <args>`` from the checkout (``distributed.torchrun_argv``); its
    output goes to WORK/<tag>.log, and a failure raises."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run(
        distributed.torchrun_argv(nproc, ["-m", "effocr_torch", *args]),
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    with open(os.path.join(WORK, f"{tag}.log"), "w") as f:
        f.write(out.stdout + "\n--- stderr ---\n" + out.stderr)
    if out.returncode != 0:
        raise AssertionError(f"{tag}: exit {out.returncode}: "
                             f"{out.stderr[-3000:]}")
    return out.stdout, wall


def _ddp_log_checks(tag, stdout, backend, ranks):
    """The ranks' log: the backend the rule chose, and the trainer's
    check that every rank's parameters are bit-identical."""
    chosen = re.findall(r"rank (\d+) of (\d+): backend (\w+)", stdout)
    if sorted(chosen) != [(str(r), str(ranks), backend)
                          for r in range(ranks)]:
        raise AssertionError(f"{tag}: expected {ranks} ranks on {backend}, "
                             f"got {chosen}")
    sync = re.findall(r"replicas in sync: [^\n]*", stdout)
    if ranks > 1 and not sync:
        raise AssertionError(f"{tag}: no replica check in the log")
    return (f"{ranks} rank(s) on {backend}",
            sync[0] if sync else "1 rank")


def _epoch_rate(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    ep = [r for r in recs if "epoch/steps" in r]
    return (sum(r["epoch/steps"] for r in ep)
            / sum(r["epoch/seconds"] for r in ep)), recs


def phase_ddp_train(dev, card, train):
    """``torchrun --nproc_per_node 2`` of ``train-recognizer`` (phase
    train's en recipe, 1 epoch of 28 steps) and of ``train-localizer``
    (phase train_localizer's recipe on 160 lines, 1 epoch of 10 steps,
    one evaluation), both ranks
    on cuda:0 over gloo; each run must end with the trainer's check that
    both ranks' parameters are bit-identical.  The localizer run's best
    checkpoint is evaluated again in this process with every K1 mask held
    to nms_mask: the AP the ranks logged.  Then a 1-rank launch of
    ``train-recognizer``, which takes NCCL."""
    from effocr_torch.data.detection import DetectionDataset
    from effocr_torch.train import checkpoint as ckpt

    out = {}
    tr = train["train"]
    with open(os.path.join(tr["run_dir"], "metrics.jsonl")) as f:
        first = [r for r in map(json.loads, f) if "epoch/steps" in r][0]
    first_rate = first["epoch/steps"] / first["epoch/seconds"]
    # the recipe at 1 epoch, without the test split and the hard-negative
    # mining (phase train runs both)
    flags = _with(TRAIN_FLAGS, num_epochs="1", infer_hardneg_k="0",
                  num_passes=DDP_REC_PASSES)
    flags.remove("--test_at_end")
    rec_args = ["train-recognizer", "--device", "cuda", "--root_dir_path",
                tr["tree"], "--train_ann_path", tr["splits"]["train"],
                "--val_ann_path", tr["splits"]["val"], "--test_ann_path",
                tr["splits"]["test"], *flags]
    for tag, nproc, backend in (("ddp_recognizer", 2, "gloo"),
                                ("nccl_recognizer", 1, "nccl")):
        run_dir = os.path.join(WORK, "ddp", tag)
        stdout, wall = run_torchrun(nproc, rec_args + ["--run_name",
                                                       run_dir], tag)
        chosen, sync = _ddp_log_checks(tag, stdout, backend, nproc)
        steps_s, recs = _epoch_rate(run_dir)
        losses = [r["train/loss"] for r in recs if "train/loss" in r]
        val = [r["val/accuracy"] for r in recs if "val/accuracy" in r]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{tag}: losses {losses}")
        log(f"{tag}: {nproc} rank(s) exited 0 in {wall:.1f} s; {chosen}; "
            f"{sync}; epoch 1 (cuDNN warm-up included): {steps_s:.2f} "
            f"steps/s = {steps_s * 128:.1f} images/s ({card}); losses "
            f"{losses}; val p@1 {val}; one process (phase train): "
            f"{first_rate:.2f} steps/s in its first epoch, "
            f"{tr['steps_s']:.2f} in epochs 2-3")
        out[tag] = dict(steps_s=steps_s, wall_s=wall, losses=losses,
                        val_p1=val, backend=backend, ranks=nproc,
                        one_process_first_epoch_steps_s=first_rate)

    tl = train["train_localizer"]
    run_dir = os.path.join(WORK, "ddp", "ddp_localizer")
    sub = _coco_head(tl["splits"]["train"], N_DDP_LOC_LINES,
                     os.path.join(WORK, "ddp", "loc_train.json"))
    loc_args = ["train-localizer", "--device", "cuda", "--image_dir",
                tl["img_dir"], "--train_coco", sub,
                "--val_coco", tl["splits"]["val"], "--run_name", run_dir,
                *_with(LOC_TRAIN_FLAGS, num_epochs="1", eval_period="1")]
    stdout, wall = run_torchrun(2, loc_args, "ddp_localizer")
    chosen, sync = _ddp_log_checks("ddp_localizer", stdout, "gloo", 2)
    steps_s, recs = _epoch_rate(run_dir)
    logged = [{k: r[k] for k in ("bbox/AP", "bbox/AP50", "bbox/AP75")}
              for r in recs if "bbox/AP" in r]
    val_ds = DetectionDataset(tl["splits"]["val"], tl["img_dir"], 1024,
                              input_height=96, channels=1)
    trainer = _loc_trainer(dev, os.path.join(WORK, "ddp", "check"),
                           os.path.join(run_dir, "model.json"))
    trainer.set_variables(ckpt.load_variables(
        ckpt.best_checkpoint_path(run_dir, "best_bbox_mAP")))
    cuda_nms.nms_kernel.launches = 0
    with kernels_checked("ddp_localizer evaluation") as (k1c, _):
        ap = trainer.evaluate((b[0], b[3]) for b in val_ds.batches(
            16, shuffle=False, drop_last=False))
    k1_launches = cuda_nms.nms_kernel.launches
    ap = {k: ap[k] for k in logged[-1]}
    if len(logged) != 1 or ap != logged[-1] or k1_launches == 0:
        raise AssertionError(f"ddp_localizer: the ranks logged {logged}, "
                             f"one rank evaluates {ap} ({k1_launches} K1 "
                             "launches)")
    log(f"ddp_localizer: 2 ranks exited 0 in {wall:.1f} s; {chosen}; "
        f"{sync}; epoch 1 (height 64, cuDNN warm-up included): "
        f"{steps_s:.2f} steps/s = {steps_s * 16:.1f} images/s ({card}); "
        f"the ranks' AP {logged[-1]} equals one rank's evaluation of the "
        f"best checkpoint here, K1 held to nms_mask on {k1c.calls} calls")
    out["ddp_localizer"] = dict(steps_s=steps_s, wall_s=wall, ap=ap,
                                backend="gloo", ranks=2)
    out["k1_launches"] = k1_launches
    out["k2_launches"] = 0
    return out


def phase_ddp_steps(dev, card, train):
    """One float32 step of the en recognizer recipe (phase
    train_step_vs_cpu's batch and draws) and of yolov5s (phase
    loc_step_vs_cpu's) on 2 ranks sharing the card (gloo) against one
    rank on the whole batch on the card: loss 1e-5 relative, the new
    batch_stats 1e-4 of the largest, the ranks bit-identical; gradients
    after DDP's averaging 1e-4 of the largest for yolov5s.  The
    recognizer's float32 step on glyph images rounds at up to ~1e-3 by
    itself (REC_F32_GRAD_TOL), so it is also run on 2 ranks and on 1 in
    float64 (``_f64_copy``) and with its stem and first two blocks in
    float64 (``_f64_stem``): each pair must agree at 1e-5 / 1e-4 / 1e-4,
    which shows that 2 ranks compute the 1-rank step; its float32
    gradients are held to REC_F32_GRAD_TOL, 2 vs 1 and each against the
    float64 step.  A second,
    profiled step on the ranks gives the step's wall time and the time of
    its all-reduces."""
    from effocr_torch.core import dryrun
    from effocr_torch.core.config import EncoderConfig, RecognizerTrainConfig
    from effocr_torch.data.detection import DetectionDataset
    from effocr_torch.data.folder import CharFolderDataset
    from effocr_torch.data.samplers import (
        NoReplacementMPerClassSampler,
        batch_iterator,
    )
    from effocr_torch.data.transforms import draw_augment
    from effocr_torch.kernels.det_augment import draw_detection_augment

    ds = CharFolderDataset(train["train"]["tree"])
    idx = next(batch_iterator(iter(NoReplacementMPerClassSampler(
        ds.targets, m=4, batch_size=128, num_passes=20, seed=0)), 128))
    base = normal_init(create_encoder("mobilenetv3_small_050",
                                      in_channels=1, dtype=torch.float32),
                       SEED + 90)
    rec = dict(
        kind="recognizer", model=base, bank=True, profile=True,
        cfg=RecognizerTrainConfig(
            encoder=EncoderConfig(arch="mobilenetv3_small_050",
                                  image_size=128, input_channels=1),
            batch_size=128, lang="en", lr=1e-3, paired_jitter=0.1,
            aux_ce_weight=1.0, data_device="resident"),
        batch=(torch.from_numpy(ds.decode_all_gray(128)),
               torch.tensor(ds.targets),
               torch.tensor([ds.is_paired(i) for i in range(len(ds))]),
               torch.tensor(idx)),
        draws=draw_augment(torch.Generator().manual_seed(SEED + 91), 128,
                           128, lang="en", paired_jitter=0.1),
        aux=torch.randn((len(ds.classes), base.out_features),
                        generator=torch.Generator().manual_seed(SEED + 92))
        * 0.02)
    tl = train["train_localizer"]
    lds = DetectionDataset(tl["splits"]["test"], tl["img_dir"], 1024,
                           input_height=96, channels=1)
    imgs, tgts, masks, _ = next(lds.batches(16, shuffle=False))
    t_cpu = _loc_trainer("cpu", os.path.join(WORK, "ddp", "step"),
                         os.path.join(tl["run_dir"], "model.json"),
                         augment=True)
    loc = dict(
        kind="localizer", bank=False, profile=True, cfg=t_cpu.cfg,
        model=init_params(_f32_copy(t_cpu.model, "cpu"), SEED + 93),
        batch=(imgs, tgts, masks),
        draws=draw_detection_augment(torch.Generator().manual_seed(SEED + 94),
                                     16, 96, 1024, 1))
    rec64 = dict(rec, model=_f64_copy(base), aux=rec["aux"].double(),
                 profile=False)
    rec_st = dict(rec, model=_f64_stem(base), profile=False)
    loc64 = dict(loc, model=_f64_copy(loc["model"]), profile=False)
    t0 = time.perf_counter()
    ranks = dryrun.run_ranks([rec, loc, rec64, rec_st, loc64], 2,
                             device="cuda", timeout_s=600)
    ranks_s = time.perf_counter() - t0
    out = {}
    for i, (tag, spec) in enumerate((("recognizer", rec), ("yolov5s", loc))):
        one = dryrun.run_step(dict(spec, profile=False), device="cuda")
        got = [r[i] for r in ranks]
        lerr = abs(got[0]["loss"] - one["loss"]) / abs(one["loss"])
        gerr, serr = _step_errors(one, got[0])
        same = all(torch.equal(got[1]["grads"][k], got[0]["grads"][k])
                   for k in one["grads"]) and all(
            torch.equal(got[1]["buffers"][k], got[0]["buffers"][k])
            for k in one["buffers"])
        gtol, witness, w = DP_STEP_TOL, "", {}
        if tag == "recognizer":
            one64, one_st = (dryrun.run_step(x, device="cuda")
                             for x in (rec64, rec_st))
            two64, two_st = ([r[j] for r in ranks] for j in (2, 3))
            w = dict(f64=_two_vs_one(one64, two64[0]),
                     f64_stem=_two_vs_one(one_st, two_st[0]),
                     f32_one_vs_f64=_step_errors(one64, one)[0],
                     f32_two_vs_f64=_step_errors(one64, got[0])[0])
            gtol = REC_F32_GRAD_TOL
            same = same and all(torch.equal(t[1]["grads"][k],
                                            t[0]["grads"][k])
                                for t in (two64, two_st)
                                for k in one64["grads"])
            witness = (
                "; 2 ranks vs 1 (loss rel, grads, batch_stats; tolerance "
                "1e-5 / 1e-4 / 1e-4): float64 "
                + ", ".join(f"{v:.3g}" for v in w["f64"])
                + "; stem and first two blocks in float64 "
                + ", ".join(f"{v:.3g}" for v in w["f64_stem"])
                + f"; float32 gradients against the float64 step: 1 rank "
                f"{w['f32_one_vs_f64']:.3g}, 2 ranks "
                f"{w['f32_two_vs_f64']:.3g} (tolerance {gtol:.3g})")
            if not (all(lr <= 1e-5 and g <= DP_STEP_TOL and st <= DP_STEP_TOL
                        for lr, g, st in (w["f64"], w["f64_stem"]))
                    and w["f32_one_vs_f64"] <= gtol
                    and w["f32_two_vs_f64"] <= gtol):
                raise AssertionError(f"ddp_step_vs_single {tag}: the float64 "
                                     f"witnesses fail{witness}")
        if tag == "yolov5s":
            # the float64 witness (ROADMAP queue 3): is the float32 gap of
            # 2 ranks against 1 the rounding of the gradient sums?  (the
            # detect head's input and the loss stay float32 in the model's
            # code: models/yolo.py, train/losses.py)
            one64 = dryrun.run_step(loc64, device="cuda")
            two64 = [r[4] for r in ranks]
            w = dict(f64=_two_vs_one(one64, two64[0]),
                     f32_one_vs_f64=_step_errors(one64, one)[0],
                     f32_two_vs_f64=_step_errors(one64, got[0])[0])
            same = same and all(torch.equal(two64[1]["grads"][k],
                                            two64[0]["grads"][k])
                                for k in one64["grads"])
            witness = (
                "; float64: 2 ranks vs 1 (loss rel, grads, batch_stats; "
                "tolerance 1e-5 / 1e-4 / 1e-4) "
                + ", ".join(f"{v:.3g}" for v in w["f64"])
                + f"; float32 gradients against the float64 step: 1 rank "
                f"{w['f32_one_vs_f64']:.3g}, 2 ranks "
                f"{w['f32_two_vs_f64']:.3g}")
            lr64, g64, st64 = w["f64"]
            if not (lr64 <= 1e-5 and g64 <= DP_STEP_TOL
                    and st64 <= DP_STEP_TOL):
                raise AssertionError(f"ddp_step_vs_single {tag}: the float64 "
                                     f"witness fails{witness}")
        prof = {k: got[0][k] for k in ("step_ms", "collective_host_ms",
                                       "collective_device_ms",
                                       "collective_events")}
        log(f"ddp_step_vs_single {tag}: float32, 2 ranks on cuda:0 (gloo) "
            f"vs 1 rank on the whole batch: loss {got[0]['loss']:.6f} vs "
            f"{one['loss']:.6f} (rel {lerr:.3g}, tolerance 1e-5); max "
            f"|grad diff| / max|g| {gerr:.3g} (tolerance {gtol:.3g}), max "
            f"|batch_stats diff| / max|stat| {serr:.3g} (tolerance "
            f"{DP_STEP_TOL:.3g}){witness}; ranks bit-identical {same}; rank "
            f"0's profiled step {prof} ({card})")
        if not (lerr <= 1e-5 and gerr <= gtol and serr <= DP_STEP_TOL
                and same):
            raise AssertionError(f"ddp_step_vs_single {tag}: 2 ranks and 1 "
                                 "disagree")
        out[tag] = dict(loss_rel=lerr, grad_err=gerr, stats_err=serr,
                        grad_tol=gtol, **w, **prof)
    out["ranks_wall_s"] = ranks_s
    return out


# --------------------------------------------------------------- main
# -------------------------------------------- artifacts in and out
# the original EffOCR's formats, written from the jp and en artifacts by
# interop/reference_writers.py and read back by the importers
N_INTEROP_EN = 512      # one chunk of the en flags
IMPORT_FLAGS = ["--imsize", "128"]      # rec_knn6k3's / rec2k_mn_hn's size


def _read_chars(path):
    with open(path, newline="") as f:
        return f.read().rstrip("\n").split("\n")


def _reference_rec_dir(d, write_encoder, chars, protos):
    """A reference-format recognizer dir: the encoder file(s), a FAISS
    IndexFlatIP of ``protos`` (the rows the original index was made from:
    PrototypeIndex normalizes them on load in both packages, so the
    imported index is the original's bit for bit; its normalized rows
    would be normalized a second time, which moves 1 ulp) and ref.txt."""
    from effocr_torch.interop import reference_writers as w

    os.makedirs(d, exist_ok=True)
    write_encoder(d)
    w.write_faiss_flat(os.path.join(d, "ref.index"), protos)
    with open(os.path.join(d, "ref.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(chars) + "\n")


def _same_tree(tag, a, b, path=""):
    if set(a) != set(b):
        raise AssertionError(f"{tag}: keys differ at {path or '/'}: "
                             f"{sorted(set(a) ^ set(b))[:6]}")
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(tag, a[k], b[k], f"{path}/{k}")
        elif not (np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
                  and np.array_equal(a[k], b[k])):
            raise AssertionError(f"{tag}: {path}/{k} differs")


def _file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _interop_run(tag, card, original, imported, paths, k2):
    """The imported engine through ``checked_runs`` (no plain run: the
    comparison is the original engine's text), the original engine once
    on the same lines; the text must be identical line for line, and
    both engines' prototype rows bit for bit."""
    if not np.array_equal(original.index.embeddings,
                          imported.index.embeddings) or \
            original.index.chars != imported.index.chars:
        raise AssertionError(f"{tag}: the imported index is not the "
                             "original's")
    ref = original.run(paths)
    run = checked_runs(imported, paths, tag, k2=k2, plain=False)
    differ = [p for p in paths if run["results"][p] != ref[p]]
    if differ:
        raise AssertionError(
            f"{tag}: {len(differ)} of {len(paths)} lines read differently "
            f"from the original artifacts, e.g. {differ[0]}: "
            f"{run['results'][differ[0]]!r} vs {ref[differ[0]]!r}")
    out = report(tag, run, card, "; text identical to the original "
                 f"artifacts' on all {len(paths)} lines")
    out["identical_lines"] = len(paths)
    return out


def phase_interop_jp(dev, card, jp):
    """The jp artifacts in the reference's formats: convnext_atto as a
    timm ``enc_best.pth`` with DataParallel's ``module.`` (dir A) and
    without it (dir B), the 11,051 prototypes as a FAISS ``ref.index`` +
    ref.txt, yolov5n as an ultralytics state dict and as a full module
    pickle whose classes exist only while saving.  ``python -m
    effocr_torch import-reference`` converts dir A (at 128 px) and the
    pickle; the state dict converts to the same bytes; infer's hook
    converts dir B on first use (at its default 224 px: the weights'
    bytes are dir A's).  Then ``load_engine`` with the jp_v3 flags on dir
    A (the hook reuses its tpu_converted) and the imported localizer,
    ``--crop_geometry tight`` as the original model.json says (a
    reference artifact implies line geometry), through ``checked_runs``
    on the jp path's 600 lines: text identical to the original
    artifacts'."""
    from effocr_torch.cli import import_reference
    from effocr_torch.interop import reference_writers as w
    from effocr_torch.interop.flax_msgpack import read_variables
    from effocr_torch.interop.yolo_import import import_ultralytics_localizer
    from effocr_torch.models.import_weights import sorted_tree
    from effocr_torch.models.yolo import DEFAULT_ANCHORS

    d = os.path.join(WORK, "interop", "jp")
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    loc_vars = read_variables(os.path.join(jp["loc_dir"],
                                           "best_bbox_mAP.msgpack"))
    rec_vars = read_variables(os.path.join(jp["rec_dir"], "enc_best.msgpack"))
    sd = w.ultralytics_yolov5_state_dict(loc_vars["params"],
                                         loc_vars["batch_stats"],
                                         DEFAULT_ANCHORS)
    os.makedirs(d)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               os.path.join(d, "loc_state_dict.pt"))
    w.save_module_pickle(os.path.join(d, "best.pt"), sd, epoch=299)
    timm = w.timm_convnext_state_dict(rec_vars["params"])
    chars = _read_chars(os.path.join(jp["rec_dir"], "ref.txt"))
    protos = raw_prototypes(len(chars), 320, SEED + 14)
    for name, prefix in (("ref_a", "module."), ("ref_b", "")):
        _reference_rec_dir(
            os.path.join(d, name), lambda r, p=prefix: torch.save(
                {p + k: torch.from_numpy(v) for k, v in timm.items()},
                os.path.join(r, "enc_best.pth")), chars, protos)
    write_s = time.perf_counter() - t0
    ref_a, ref_b = os.path.join(d, "ref_a"), os.path.join(d, "ref_b")
    loc_dir = os.path.join(d, "loc")
    # two calls: with both flags the command writes both into --out, the
    # localizer's model.json over the recognizer's (as the JAX command)
    _, import_s = run_cli(["import-reference", "--recognizer_dir", ref_a,
                           *IMPORT_FLAGS], "import_reference")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        import_reference.main(["--localizer_pt", os.path.join(d, "best.pt"),
                               "--out", loc_dir, "--input_size", "96",
                               "--input_height", "640"])
    pickle_s = time.perf_counter() - t0
    conv_a = os.path.join(ref_a, "tpu_converted")
    _same_tree("interop_jp recognizer",
               read_variables(os.path.join(conv_a, "enc_best.msgpack")),
               sorted_tree(rec_vars))
    _same_tree("interop_jp localizer",
               read_variables(os.path.join(loc_dir,
                                           "best_bbox_mAP.msgpack")),
               sorted_tree(loc_vars))
    t0 = time.perf_counter()
    import_ultralytics_localizer(os.path.join(d, "loc_state_dict.pt"),
                                 os.path.join(d, "loc_sd"), 96, 640)
    sd_s = time.perf_counter() - t0
    if _file_bytes(os.path.join(d, "loc_sd", "best_bbox_mAP.msgpack")) != \
            _file_bytes(os.path.join(loc_dir, "best_bbox_mAP.msgpack")):
        raise AssertionError("interop_jp: the state dict and the full "
                             "pickle import to different bytes")
    # infer's hook on dir B: converted on first use, then reused
    log_buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log_buf):
        hooked = load_engine(jp_engine_args(loc_dir, ref_b))
    hook_s = time.perf_counter() - t0
    conv_b = os.path.join(ref_b, "tpu_converted")
    if "converting reference-format recognizer_dir" not in \
            log_buf.getvalue() or hooked.config.encoder.image_size != 224:
        raise AssertionError(f"interop_jp: infer's hook did not convert "
                             f"{ref_b}: {log_buf.getvalue()!r}")
    if _file_bytes(os.path.join(conv_b, "enc_best.msgpack")) != \
            _file_bytes(os.path.join(conv_a, "enc_best.msgpack")):
        raise AssertionError("interop_jp: the hook's conversion differs "
                             "from import-reference's")
    del hooked
    log(f"interop_jp: reference-format artifacts written in {write_s:.2f} "
        f"s; python -m effocr_torch import-reference (the recognizer) "
        f"exited 0 in {import_s:.2f} s of process wall; the full-pickle "
        f"localizer imported in {pickle_s:.2f} s (its main, in process), "
        f"the state dict in {sd_s:.2f} s to the same bytes; infer's hook "
        f"converted dir B in {hook_s:.2f} s (engine build included); trees "
        "bit for bit the originals'")
    original = load_engine(jp_engine_args(jp["loc_dir"], jp["rec_dir"],
                                          "--nms_kernel", "pallas"))
    log_buf = io.StringIO()
    with contextlib.redirect_stdout(log_buf):
        imported = load_engine(jp_engine_args(
            loc_dir, ref_a, "--nms_kernel", "pallas", "--crop_geometry",
            "tight"))
    if "converting" in log_buf.getvalue():
        raise AssertionError("interop_jp: the hook converted dir A again")
    out = _interop_run("interop_jp", card, original, imported, jp["paths"],
                       k2=True)
    out.update(write_s=write_s, import_cli_s=import_s,
               import_pickle_s=pickle_s, import_sd_s=sd_s, hook_s=hook_s)
    return out


def phase_interop_en(dev, card, sl):
    """The en recognizer (mobilenetv3_small_050, 1 channel) as an
    ``enc_best.onnx``-only reference dir (the protobuf writer) with its 90
    prototypes as a FAISS index, converted by import-reference's main at
    128 px; the en localizer is left as it is (1 channel; ultralytics
    models are 3-channel).  ``load_engine`` with BENCH_TRAINED's flags and
    ``--crop_geometry tight`` on one chunk of 512 lines through
    ``checked_runs``: text identical to the original artifacts'."""
    from effocr_torch.cli import import_reference
    from effocr_torch.interop import reference_writers as w
    from effocr_torch.interop.flax_msgpack import read_variables
    from effocr_torch.models.import_weights import sorted_tree

    d = os.path.join(WORK, "interop", "en")
    shutil.rmtree(d, ignore_errors=True)
    rec_vars = read_variables(os.path.join(sl["rec_dir"], "enc_best.msgpack"))
    chars = _read_chars(os.path.join(sl["rec_dir"], "ref.txt"))
    t0 = time.perf_counter()
    _reference_rec_dir(d, lambda r: w.write_onnx(
        os.path.join(r, "enc_best.onnx"), w.timm_mobilenetv3_state_dict(
            rec_vars["params"], rec_vars["batch_stats"])), chars,
        raw_prototypes(len(chars), 1024, SEED + 2))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        import_reference.main(["--recognizer_dir", d, *IMPORT_FLAGS])
    import_s = time.perf_counter() - t0
    _same_tree("interop_en recognizer", read_variables(os.path.join(
        d, "tpu_converted", "enc_best.msgpack")), sorted_tree(rec_vars))
    log(f"interop_en: enc_best.onnx ({os.path.getsize(os.path.join(d, 'enc_best.onnx'))} "
        f"bytes) + ref.index written in {write_s:.2f} s, imported in "
        f"{import_s:.2f} s (in process); the tree is the original's bit "
        "for bit")
    paths = sl["paths"][:N_INTEROP_EN]
    original = load_engine(engine_args(sl["loc_dir"], sl["rec_dir"]))
    imported = load_engine(engine_args(sl["loc_dir"], d, "--crop_geometry",
                                       "tight"))
    out = _interop_run("interop_en", card, original, imported, paths,
                       k2=False)
    out.update(write_s=write_s, import_s=import_s)
    return out


EXPORT_BATCH = 64


def forward_times(fn, reps=20):
    """A model call's times: its kernels' device time (torch.profiler,
    the sum over every kernel it launches) and their count, the wall
    time a call of ``reps`` back to back (CUDA events: host enqueue gaps
    included where the host is the slower side), and the host's enqueue
    time of a call.  (device_ms cannot time a forward whose enqueue
    outlasts its kernels: it cannot queue the calls ahead.)"""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    return dict(device_ms=sum(e.self_device_time_total for e in kernels)
                / 1e3 / reps,
                kernels=sum(e.count for e in kernels) // reps,
                wall_ms=start.elapsed_time(end) / reps, host_ms=host_ms)


def phase_export(dev, card, rec_dir):
    """``export`` of the jp recognizer (convnext_atto, 3 x 128 x 128) on
    the card at batch 64: the command's reload parity (2 random batches,
    rtol/atol 0.05) and its largest difference, then the eager model and
    the reloaded program timed by ``device_ms`` on one batch."""
    from effocr_torch.cli.export import export_encoder
    from effocr_torch.cli.infer import load_recognizer

    path = os.path.join(WORK, "interop", "enc_best.pt2")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        export_encoder(rec_dir, path, batch=EXPORT_BATCH, device="cuda")
    export_s = time.perf_counter() - t0
    worst = float(buf.getvalue().rsplit("max |reloaded - eager| ", 1)[1]
                  .split()[0])
    model, meta = load_recognizer(rec_dir)
    size, ch = meta["image_size"], meta["input_channels"]
    model = model.to(dev)
    program = torch.export.load(path).module()
    x = torch.rand((EXPORT_BATCH, size, size, ch), device=dev)
    with torch.no_grad():
        if not torch.equal(program(x), model(x)):
            gap = float((program(x) - model(x)).abs().max())
            log(f"export: reloaded vs eager differ by up to {gap:.3g} on a "
                "uniform batch")
        times = {name: forward_times(fn) for name, fn in (
            ("eager", lambda: model(x)), ("exported", lambda: program(x)))}
    log(f"export: torch.export of {os.path.basename(rec_dir)}'s encoder at "
        f"[{EXPORT_BATCH}, {size}, {size}, {ch}] on the card in "
        f"{export_s:.2f} s (trace, save, reload and parity); parity passed, "
        f"max |reloaded - eager| {worst:.3g}; {os.path.getsize(path)} "
        f"bytes; a call ({card}): " + "; ".join(
            f"{name} {t['device_ms']:.4f} ms of kernels in {t['kernels']} "
            f"launches, {t['wall_ms']:.4f} ms a call back to back, "
            f"{t['host_ms']:.4f} ms of host enqueue"
            for name, t in times.items()))
    return dict(export_s=export_s, max_abs_diff=worst,
                bytes=os.path.getsize(path), **{
                    f"{name}_{k}": v for name, t in times.items()
                    for k, v in t.items()})


def phase_import_encoder(dev, card, jp, train):
    """The jp convnext_atto as an HF ``ConvNextModel`` dir (config.json +
    model.safetensors, the port's writer), ``import-encoder`` (main, in
    process) to a variables msgpack equal to the original tree bit for
    bit, loaded by the recognizer trainer's own ``set_variables`` (the
    weights after load equal it), then ``train-recognizer --checkpoint``
    with phase train's recipe at 1 epoch (convnext_atto, 3 channels, no
    test split or hard-negative mining) in process: finite losses."""
    from types import SimpleNamespace

    from effocr_torch.cli import import_encoder, train_recognizer
    from effocr_torch.interop import reference_writers as w
    from effocr_torch.interop.flax_msgpack import read_variables
    from effocr_torch.models.import_weights import sorted_tree
    from effocr_torch.train.recognizer import RecognizerTrainer

    d = os.path.join(WORK, "interop", "hf")
    shutil.rmtree(d, ignore_errors=True)
    rec_vars = read_variables(os.path.join(jp["rec_dir"], "enc_best.msgpack"))
    w.write_hf_convnext_dir(d, rec_vars["params"], 128)
    out_path = os.path.join(d, "enc_init.msgpack")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        import_encoder.main(["--model_dir", d, "--out", out_path])
    import_s = time.perf_counter() - t0
    imported = read_variables(out_path)
    _same_tree("import_encoder", imported, sorted_tree(rec_vars))
    model = create_encoder("convnext_atto", in_channels=3, image_size=128)
    RecognizerTrainer.set_variables(SimpleNamespace(model=model), imported)
    _same_tree("import_encoder after load",
               sorted_tree(state_dict_to_flax(model.state_dict())), imported)
    tr = train["train"]
    run_dir = os.path.join(WORK, "interop", "warm_start")
    flags = _with(TRAIN_FLAGS, auto_model="convnext_atto",
                  input_channels="3", num_epochs="1", infer_hardneg_k="0")
    flags.remove("--test_at_end")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train_recognizer.main(
            ["--device", "cuda", "--root_dir_path", tr["tree"],
             "--train_ann_path", tr["splits"]["train"], "--val_ann_path",
             tr["splits"]["val"], "--test_ann_path", tr["splits"]["test"],
             "--run_name", run_dir, "--checkpoint", out_path, *flags])
    train_s = time.perf_counter() - t0
    steps_s, recs = _epoch_rate(run_dir)
    losses = [r["train/loss"] for r in recs if "train/loss" in r]
    val = [r["val/accuracy"] for r in recs if "val/accuracy" in r]
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"import_encoder: losses {losses}")
    log(f"import_encoder: HF dir -> variables in {import_s:.2f} s, equal to "
        f"the original tree and to the trainer's weights after load; "
        f"train-recognizer --checkpoint (1 epoch, in process) in "
        f"{train_s:.1f} s: {steps_s:.2f} steps/s ({card}), losses {losses},"
        f" val p@1 {val}")
    return dict(import_s=import_s, train_s=train_s, steps_s=steps_s,
                losses=losses, val_p1=val)


# ------------------------------------------------------------ the tools
N_VIZ = 50              # query crops of the viz phase (viz's --num)
TOOLS_CHUNK = 512       # device_trace's en chunk (BENCH_TRAINED's line_batch)
N_TOOLS_LINES = 128     # infer's overlays and comparators


def phase_tools(dev, card, sl, train):
    """The tools on phase train's recognizer and phase train_localizer's
    localizer and 256-line read split:

    - ``python -m effocr_torch infer`` (BENCH_TRAINED's flags, ``--nms_kernel
      pallas``) in a subprocess with ``--output_localizer_results D
      --compare_ocr --save_output S``: one overlay a line, read back through
      data/png.py, equal pixel for pixel to ``draw_boxes`` of the page at
      the boxes of S/inference_coco.json (so the outline lies at them);
      its text equal to the same engine's in process (``checked_runs``: K1
      held bit for bit on every call); whether ``tesseract`` is present;
    - ``error-analysis`` on S/inference_results.json against the read
      split: its edits are those of the CER infer printed (error-analysis
      divides by the cleaned and stripped ground-truth length, infer by
      the raw one, in both packages), its category shares sum to 1;
    - ``viz --k 5`` on 50 of the tree's test crops: each file's neighbour
      code points equal an in-process ``PrototypeIndex.search`` of the
      same embeddings; p@1 logged;
    - ``device_trace`` around one en chunk (512 lines, every K1 mask held
      bit for bit): the Chrome trace names K1's kernels, and K1's
      launches are counted from 0 there."""
    from effocr_torch.cli.viz import true_char
    from effocr_torch.data import png
    from effocr_torch.eval.textline import string_cleaner
    from effocr_torch.interop.flax_msgpack import read_variables
    from effocr_torch.kernels.image_ops import paired_transform_host
    from effocr_torch.utils.profiling import device_trace
    from effocr_torch.utils.viz import draw_boxes

    tl, tr = train["train_localizer"], train["train"]
    loc_dir, rec_dir = tl["run_dir"], tr["run_dir"]
    d = os.path.join(WORK, "tools")
    shutil.rmtree(d, ignore_errors=True)
    over, save = os.path.join(d, "overlays"), os.path.join(d, "out")
    # the first N_TOOLS_LINES of the localizer corpus's 256 read lines
    read_json = _coco_head(tl["splits"]["read"], N_TOOLS_LINES,
                           os.path.join(WORK, "tools_read.json"))
    stdout, infer_wall = run_cli(
        ["infer", *engine_flags(loc_dir, rec_dir), "--nms_kernel", "pallas",
         "--image_dir", tl["img_dir"], "--coco_json", read_json,
         "--output_localizer_results", over, "--compare_ocr",
         "--save_output", save, "--device", "cuda"], "tools_infer")
    infer_cer = float([ln for ln in stdout.splitlines() if ln.startswith(
        "EffOCR | ")][-1].rsplit("| CER = ", 1)[1])
    tesseract = shutil.which("tesseract")
    comparators = [ln for ln in stdout.splitlines()
                   if ln.startswith(("tesseract |", "gcv |", "baidu |"))]
    if bool(tesseract) != any(ln.startswith("tesseract") for ln in
                              comparators):
        raise AssertionError(f"tools: tesseract at {tesseract}, comparator "
                             f"lines {comparators}")
    with open(os.path.join(save, "inference_coco.json")) as f:
        icoco = json.load(f)
    with open(os.path.join(save, "inference_results.json")) as f:
        text = json.load(f)
    with open(read_json) as f:
        read = json.load(f)["images"]
    boxes_by_id = {}
    for a in icoco["annotations"]:
        x, y, w, h = a["bbox"]
        boxes_by_id.setdefault(a["image_id"], []).append([x, y, x + w,
                                                          y + h])
    n_boxes = 0
    for im in icoco["images"]:
        got = png.read_png(os.path.join(over, im["file_name"]), 3)
        want = draw_boxes(png.read_png(os.path.join(
            tl["img_dir"], im["file_name"]), 3),
            boxes_by_id.get(im["id"], []))
        if not np.array_equal(got, want):
            raise AssertionError(f"tools: overlay {im['file_name']} differs "
                                 "from its boxes outlined")
        n_boxes += len(boxes_by_id.get(im["id"], []))
    if sorted(os.listdir(over)) != sorted(im["file_name"] for im in read):
        raise AssertionError("tools: not one overlay a line")
    engine = load_engine(engine_args(loc_dir, rec_dir))
    paths = [os.path.join(tl["img_dir"], im["file_name"]) for im in read]
    run = checked_runs(engine, paths, "tools", plain=False)
    inproc = {os.path.basename(p): v for p, v in run["results"].items()}
    if inproc != text:
        raise AssertionError("tools: infer's text differs from the same "
                             "engine's in process")
    log(f"tools: infer --output_localizer_results --compare_ocr exited 0 "
        f"in {infer_wall:.1f} s (process wall): {len(read)} overlays "
        f"({n_boxes} boxes) equal to draw_boxes at inference_coco.json's "
        f"boxes; text equal to the engine's in process; CER {infer_cer}; "
        f"tesseract {'at ' + tesseract if tesseract else 'absent (skipped)'}"
        f"; comparator lines {comparators}")

    ea_json = os.path.join(d, "error_analysis.json")
    _, ea_wall = run_cli(["error-analysis", "--results",
                          os.path.join(save, "inference_results.json"),
                          "--coco_json", read_json, "--save_json", ea_json],
                         "tools_error_analysis")
    with open(ea_json) as f:
        ea = json.load(f)
    shares = sum(v[1] for v in ea["by_category"].values())
    # the same edits as infer's CER; the denominators differ in both
    # packages: textline_evaluation divides by the raw ground-truth
    # length, error-analysis by the cleaned and stripped one
    raw = sum(len(im["text"]) for im in read)
    clean = sum(len(string_cleaner(im["text"]).strip()) for im in read)
    if (abs(infer_cer * raw - ea["edits"]) > 1e-6
            or ea["cer"] != ea["edits"] / clean
            or (ea["edits"] and abs(shares - 1) > 1e-9)):
        raise AssertionError(f"tools: error-analysis {ea['edits']} edits / "
                             f"{clean} chars vs infer's CER {infer_cer} of "
                             f"{raw} chars; shares sum to {shares}")
    log(f"tools: error-analysis in {ea_wall:.1f} s: {ea['edits']} edits, "
        f"infer's (CER {infer_cer} of {raw} raw chars = {ea['cer']} of "
        f"{clean} cleaned ones), shares sum to {shares:.12f}: "
        + ", ".join(f"{k} {v[0]}" for k, v in ea["by_category"].items()))

    test_crops = tuple(f"PAIRED_{s}_" for s in SPLIT_STEMS["test"])
    queries = sorted(os.path.join(r, f) for r, _, fs in os.walk(tr["tree"])
                     for f in fs if f.startswith(test_crops))
    qtxt = os.path.join(d, "queries.txt")
    with open(qtxt, "w") as f:
        f.write("\n".join(queries))
    vdir = os.path.join(d, "viz")
    _, viz_wall = run_cli(["viz", "--recognizer_dir", rec_dir, "--query_txt",
                           qtxt, "--out_dir", vdir, "--k", "5", "--num",
                           str(N_VIZ), "--device", "cuda"], "tools_viz")
    with open(os.path.join(rec_dir, "model.json")) as f:
        meta = json.load(f)
    enc = create_encoder(meta["arch"], in_channels=meta["input_channels"],
                         image_size=meta["image_size"])
    enc.load_state_dict(flax_to_state_dict(read_variables(os.path.join(
        rec_dir, "enc_best.msgpack"))))
    enc = enc.to(dev).eval()
    index = PrototypeIndex.load(rec_dir)
    picked = list(queries)
    np.random.default_rng(111).shuffle(picked)
    names, hits = set(), 0
    for qp in picked[:N_VIZ]:
        x = paired_transform_host(png.read_png(qp, 3), meta["image_size"])
        if meta["input_channels"] == 1:
            x = x.mean(axis=-1, keepdims=True)
        with torch.no_grad():
            emb = enc(torch.from_numpy(x[None]).to(dev)).float()
        _, idx = index.search(emb.cpu().numpy(), k=5, device=dev)
        chars = [index.chars[i] for i in idx[0]]
        stem = os.path.splitext(os.path.basename(qp))[0]
        correct = true_char(stem) == chars[0]
        hits += correct
        names.add(f"{stem}_{correct}_nn_"
                  f"{'-'.join(hex(ord(c)) for c in chars)}_"
                  f"{'correct' if correct else 'incorrect'}.png")
    if set(os.listdir(vdir)) != names:
        raise AssertionError("tools: viz's files name other neighbours than "
                             "PrototypeIndex.search in process: "
                             f"{sorted(set(os.listdir(vdir)) ^ names)[:4]}")
    log(f"tools: viz --k 5 on {N_VIZ} of {len(queries)} test crops in "
        f"{viz_wall:.1f} s (process wall): every file's neighbours equal "
        f"PrototypeIndex.search in process; p@1 {hits / N_VIZ:.2f}")

    en = load_engine(engine_args(sl["loc_dir"], sl["rec_dir"]))
    chunk = sl["paths"][:TOOLS_CHUNK]
    en.run(chunk)                        # warm
    torch.cuda.synchronize()
    cuda_nms.nms_kernel.launches = 0
    with kernels_checked("tools device_trace") as (k1c, _):
        t0 = time.perf_counter()
        with device_trace(os.path.join(d, "trace")) as prof:
            en.run(chunk)
            torch.cuda.synchronize()
        trace_wall = time.perf_counter() - t0
    trace_launches = cuda_nms.nms_kernel.launches
    with open(prof.trace_path) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    k1_names = sorted(n for n in names if "nms_build_kernel" in n
                      or "nms_scan_kernel" in n)
    if trace_launches == 0 or k1c.calls != trace_launches or len(
            k1_names) < 2:
        raise AssertionError(f"tools: device_trace launches {trace_launches},"
                             f" checked {k1c.calls}, K1 names {k1_names}")
    log(f"tools: device_trace around one en chunk of {len(chunk)} lines: "
        f"{os.path.getsize(prof.trace_path)} bytes of Chrome trace in "
        f"{trace_wall:.2f} s (profiled), K1's kernels {k1_names} named; K1 "
        f"launches {trace_launches}, each held bit for bit")
    return dict(k1_launches=run["k1_launches"] + trace_launches,
                k2_launches=run["k2_launches"], infer_wall_s=infer_wall,
                infer_cer=infer_cer, overlays=len(read), boxes=n_boxes,
                tesseract=tesseract, comparators=comparators,
                error_analysis=ea, viz_p1=hits / N_VIZ, viz_wall_s=viz_wall,
                trace_bytes=os.path.getsize(prof.trace_path),
                trace_launches=trace_launches, lines_s=run["lines_s"])


# --------------------------------------------------- the seq2seq baseline
# train-seq2seq at the JAX command's defaults (full width: dim 256, 6 + 4
# blocks, 8 heads, patch 8, a 64 x 512 canvas, max_len 64, batch 16, lr
# 3e-4, float32), resident bank, greedy evaluation; depth cut to 2
# epochs (of 20) on the first 1,000 of the loc corpus's 2,000 train lines
# (63 steps each)
S2S_TRAIN_LINES = 1000
S2S_EPOCHS = 2
S2S_FLAGS = ["--num_epochs", str(S2S_EPOCHS), "--data_device", "resident"]
S2S_BATCH = 16
S2S_MARGIN = 1e-4       # a CPU top-2 logit margin below it is a near-tie


def _s2s_margins(model, images, tokens):
    """CPU top-2 logit margin of every greedy step [B, T - 1] of ``tokens``
    (the decode's own input: BOS + its output)."""
    from effocr_torch.baselines.seq2seq import BOS

    full = torch.cat([torch.full((tokens.shape[0], 1), BOS), tokens], 1)
    with torch.no_grad():
        logits = model.decode_logits(model.encode(images), full)
    top = torch.topk(logits[:, :-1], 2, dim=-1).values
    return (top[..., 0] - top[..., 1]).numpy()


def phase_seq2seq(dev, card, tl):
    """``python -m effocr_torch train-seq2seq --data_device resident`` at
    full width on phase train_localizer's corpus (the first
    S2S_TRAIN_LINES of its 2,000 train lines, val 128): steps/s and images/s from the second epoch on, the mean loss of
    each epoch (it must fall), val CER and greedy lines/s each epoch.
    Then, in process, seq2seq_best.msgpack on the val split: greedy and
    beam-4 decode (lines/s, CER; greedy's CER equals the best epoch's);
    ``seq2seq_step_vs_cpu``: one float32 step on the card and on the CPU
    from those weights on the same batch (loss 1e-5 relative, gradients
    1e-3 of the largest); greedy tokens of 16 val lines on the card and
    on the CPU identical except after a step whose CPU top-2 logit margin
    is under S2S_MARGIN (counted)."""
    from effocr_torch.baselines.data import Seq2SeqDataset
    from effocr_torch.baselines.seq2seq import (
        CharTokenizer,
        Seq2SeqOCR,
        beam_decode,
        greedy_decode,
        make_seq2seq_train_step,
    )
    from effocr_torch.eval.textline import textline_evaluation
    from effocr_torch.interop.flax_msgpack import read_variables

    run_dir = os.path.join(WORK, "seq2seq")
    shutil.rmtree(run_dir, ignore_errors=True)
    _, wall = run_cli(
        ["train-seq2seq", "--device", "cuda", "--image_dir", tl["img_dir"],
         "--train_coco", _coco_head(tl["splits"]["train"], S2S_TRAIN_LINES,
                                    os.path.join(WORK, "s2s_train.json")),
         "--val_coco", tl["splits"]["val"], "--run_name", run_dir,
         *S2S_FLAGS], "train_seq2seq")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    epochs = [r for r in recs if "epoch/steps" in r]
    evals = [r for r in recs if "val/cer" in r]
    timed = epochs[1:]
    steps_s = sum(r["epoch/steps"] for r in timed) / sum(
        r["epoch/seconds"] for r in timed)
    images_s = sum(r["epoch/images"] for r in timed) / sum(
        r["epoch/seconds"] for r in timed)
    losses = [r["epoch/loss"] for r in epochs]
    cers = [r["val/cer"] for r in evals]
    with open(tl["splits"]["val"]) as f:
        n_val = len(json.load(f)["images"])
    greedy_cli = [n_val / r["val/seconds"] for r in evals]
    if len(epochs) != S2S_EPOCHS or not all(np.isfinite(losses + cers)):
        raise AssertionError(f"seq2seq: epochs {epochs}, evals {evals}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"seq2seq: epoch losses {losses} do not fall")
    log(f"seq2seq: train-seq2seq exited 0 in {wall:.1f} s (process wall, "
        f"corpus decode and evaluation included); epochs "
        f"{[round(r['epoch/seconds'], 3) for r in epochs]} s of "
        f"{[int(r['epoch/steps']) for r in epochs]} steps of {S2S_BATCH}; "
        f"epochs 2-{len(epochs)}: {steps_s:.2f} steps/s = {images_s:.1f} "
        f"images/s ({card}); mean loss by epoch {losses}; val CER by epoch "
        f"{cers}; greedy decode in the CLI {[round(v, 1) for v in greedy_cli]}"
        f" lines/s")

    with open(os.path.join(run_dir, "charset.json")) as f:
        tok = CharTokenizer(json.load(f))
    variables = read_variables(os.path.join(run_dir, "seq2seq_best.msgpack"))

    def model_on(device):
        m = Seq2SeqOCR(vocab_size=tok.vocab_size)
        m.load_state_dict(flax_to_state_dict(variables), strict=True)
        return m.to(device).eval()

    card_model = model_on(dev)
    val_ds = Seq2SeqDataset(tl["splits"]["val"], tl["img_dir"], tok)
    val_imgs = torch.from_numpy(val_ds.materialize()[0])
    texts = [t for _, t in val_ds.entries]
    decoded = {}
    for name, fn in (("greedy", lambda x: greedy_decode(card_model, x)),
                     ("beam4", lambda x: beam_decode(card_model, x,
                                                     beam_size=4))):
        fn(val_imgs[:S2S_BATCH].to(dev))          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = [fn(val_imgs[s:s + S2S_BATCH].to(dev)).cpu()
                for s in range(0, len(texts), S2S_BATCH)]
        secs = time.perf_counter() - t0
        out = torch.cat(rows).numpy()
        cer = textline_evaluation([(gt, tok.decode(r))
                                   for gt, r in zip(texts, out)])[1]
        decoded[name] = dict(lines_s=len(texts) / secs, cer=cer, tokens=out)
    log(f"seq2seq: seq2seq_best.msgpack on {len(texts)} val lines in batches"
        f" of {S2S_BATCH} ({card}): greedy {decoded['greedy']['lines_s']:.1f}"
        f" lines/s, CER {decoded['greedy']['cer']:.4f} (the CLI's best epoch:"
        f" {min(cers):.4f}); "
        f"beam 4 {decoded['beam4']['lines_s']:.1f} lines/s, CER "
        f"{decoded['beam4']['cer']:.4f}")
    for gt, r in list(zip(texts, decoded["greedy"]["tokens"]))[:3]:
        log(f"seq2seq: {gt!r} -> greedy {tok.decode(r)!r}")

    # one float32 step at full width, card and CPU, same weights and batch
    train_ds = Seq2SeqDataset(tl["splits"]["train"], tl["img_dir"], tok)
    batch = [torch.from_numpy(np.stack(a)) for a in zip(
        *(train_ds.load(i)[:3] for i in range(S2S_BATCH)))]
    steps = []
    for device in (dev, torch.device("cpu")):
        m = model_on(device).train()
        rec = GradRecorder(dict(m.named_parameters()))
        loss = make_seq2seq_train_step(m, rec)(*(t.to(device)
                                                 for t in batch))
        steps.append((float(loss), rec.grads))
    (lc, gc), (lp, gp) = steps
    gmax = max(float(g.abs().max()) for g in gp.values())
    gerr = max(float((gc[k] - g).abs().max()) for k, g in gp.items()) / gmax
    lrel = abs(lc - lp) / abs(lp)
    log(f"seq2seq_step_vs_cpu: one float32 step at full width, batch "
        f"{S2S_BATCH}: loss {lc:.7f} (card) vs {lp:.7f} (CPU), rel "
        f"{lrel:.3g} (tolerance 1e-5); max |grad diff| / max|g| {gerr:.3g} "
        f"(tolerance 1e-3; {card})")
    if not (lrel <= 1e-5 and gerr <= 1e-3):
        raise AssertionError("seq2seq_step_vs_cpu: card and CPU disagree")

    cpu_model = model_on(torch.device("cpu"))
    x = val_imgs[:S2S_BATCH]
    t_cpu = greedy_decode(cpu_model, x)
    t_card = greedy_decode(card_model, x.to(dev)).cpu()
    margins = _s2s_margins(cpu_model, x, t_cpu)
    near, bad = 0, []
    for r in range(len(x)):
        diff = np.flatnonzero((t_cpu[r] != t_card[r]).numpy())
        if len(diff):
            if margins[r, diff[0]] < S2S_MARGIN:
                near += 1
            else:
                bad.append((r, int(diff[0]), float(margins[r, diff[0]])))
    log(f"seq2seq: greedy tokens of {len(x)} val lines, card vs CPU: "
        f"{len(x) - near - len(bad)} identical, {near} part after a step "
        f"whose CPU top-2 margin is < {S2S_MARGIN}, {len(bad)} otherwise "
        f"(smallest CPU margin on the path {float(margins.min()):.3g})")
    if bad:
        raise AssertionError(f"seq2seq: greedy tokens differ at clear "
                             f"margins: {bad}")
    return dict(k1_launches=0, k2_launches=0, steps_s=steps_s,
                images_s=images_s, epoch_losses=losses, val_cer=cers,
                greedy_cli_lines_s=greedy_cli, train_wall_s=wall,
                epoch_seconds=[r["epoch/seconds"] for r in epochs],
                greedy_lines_s=decoded["greedy"]["lines_s"],
                greedy_cer=decoded["greedy"]["cer"],
                beam4_lines_s=decoded["beam4"]["lines_s"],
                beam4_cer=decoded["beam4"]["cer"], step_loss_rel=lrel,
                step_grad_err=gerr, greedy_near_ties=near)


# the ViT-encoder TrOCR base model at the widths of
# microsoft/trocr-base-handwritten's config.json (ViT-base encoder: 768
# wide, 12 layers, 12 heads, MLP 3072, 384 px, patch 16; TrOCR decoder:
# d_model 1024, 12 layers, 16 heads, FFN 4096, vocab 50265, 512 learned
# positions, embedding LayerNorm, cross attention from 768), weights
# drawn from SEED; depth cut to 2 epochs of 128 train lines, 16 val
# lines, 16 read lines at beam 4 (the JAX command: 10 epochs, and
# phase train_localizer's 2,000 / 128 / 256)
TROCR_BASE = dict(enc_hidden=768, enc_layers=12, enc_heads=12, enc_mlp=3072,
                  image_size=384, patch=16, dec_hidden=1024, dec_layers=12,
                  dec_heads=16, dec_ffn=4096, vocab=50265, max_positions=512)
TROCR_SPLITS = {"train": 128, "val": 16, "read": 16}
TROCR_EPOCHS = 2
TROCR_MERGES = 300      # byte-level BPE merges counted from the corpus
TROCR_STEP_BATCH = 2    # the card-vs-CPU step
TROCR_CHECK_LINES = 4   # val lines of the card-vs-CPU logits and greedy
TROCR_LOGIT_TOL = 2e-3  # the --check tolerance, for card vs CPU logits
TROCR_MARGIN = 2e-3     # a CPU top-2 logit margin below it is a near-tie


def trocr_hf_state_dict(w, seed):
    """An HF VisionEncoderDecoder (ViT + TrOCR) state dict under HF's
    names, numpy float32: weights N(0, 0.02) (the configs'
    initializer_range / init_std), biases 0, LayerNorms at identity, the
    pooler's keys included, the output projection a copy of the token
    embedding (the published checkpoints tie them)."""
    rng = np.random.default_rng(seed)
    sd = {}
    f32 = np.float32

    def normal(*shape):
        return rng.standard_normal(shape, dtype=f32) * f32(0.02)

    def linear(name, n_out, n_in):
        sd[f"{name}.weight"] = normal(n_out, n_in)
        sd[f"{name}.bias"] = np.zeros(n_out, f32)

    def norm(name, n):
        sd[f"{name}.weight"] = np.ones(n, f32)
        sd[f"{name}.bias"] = np.zeros(n, f32)

    e, d, p = w["enc_hidden"], w["dec_hidden"], w["patch"]
    grid = (w["image_size"] // p) ** 2
    E = "encoder.embeddings"
    sd[f"{E}.cls_token"] = normal(1, 1, e)
    sd[f"{E}.position_embeddings"] = normal(1, grid + 1, e)
    sd[f"{E}.patch_embeddings.projection.weight"] = normal(e, 3, p, p)
    sd[f"{E}.patch_embeddings.projection.bias"] = np.zeros(e, f32)
    for i in range(w["enc_layers"]):
        L = f"encoder.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            linear(f"{L}.attention.attention.{name}", e, e)
        linear(f"{L}.attention.output.dense", e, e)
        norm(f"{L}.layernorm_before", e)
        norm(f"{L}.layernorm_after", e)
        linear(f"{L}.intermediate.dense", w["enc_mlp"], e)
        linear(f"{L}.output.dense", e, w["enc_mlp"])
    norm("encoder.layernorm", e)
    linear("encoder.pooler.dense", e, e)
    D = "decoder.model.decoder"
    tok = normal(w["vocab"], d)
    tok[1] = 0.0                                    # padding_idx 1
    sd[f"{D}.embed_tokens.weight"] = tok
    sd[f"{D}.embed_positions.weight"] = normal(w["max_positions"] + 2, d)
    norm(f"{D}.layernorm_embedding", d)
    for i in range(w["dec_layers"]):
        L = f"{D}.layers.{i}"
        for blk, kv in (("self_attn", d), ("encoder_attn", e)):
            linear(f"{L}.{blk}.q_proj", d, d)
            linear(f"{L}.{blk}.k_proj", d, kv)
            linear(f"{L}.{blk}.v_proj", d, kv)
            linear(f"{L}.{blk}.out_proj", d, d)
            norm(f"{L}.{blk}_layer_norm", d)
        linear(f"{L}.fc1", w["dec_ffn"], d)
        linear(f"{L}.fc2", d, w["dec_ffn"])
        norm(f"{L}.final_layer_norm", d)
    sd["decoder.output_projection.weight"] = tok.copy()
    return sd


def trocr_config(w):
    """config.json as HF writes it for trocr-base-handwritten: the
    default-valued decoder_start_token_id left out (diff-serialized)."""
    return {
        "architectures": ["VisionEncoderDecoderModel"],
        "model_type": "vision-encoder-decoder", "is_encoder_decoder": True,
        "pad_token_id": 1, "eos_token_id": 2, "tie_word_embeddings": False,
        "encoder": {
            "model_type": "vit", "hidden_size": w["enc_hidden"],
            "num_hidden_layers": w["enc_layers"],
            "num_attention_heads": w["enc_heads"],
            "intermediate_size": w["enc_mlp"], "hidden_act": "gelu",
            "layer_norm_eps": 1e-12, "image_size": w["image_size"],
            "patch_size": w["patch"], "num_channels": 3, "qkv_bias": True,
            "initializer_range": 0.02},
        "decoder": {
            "model_type": "trocr", "d_model": w["dec_hidden"],
            "decoder_layers": w["dec_layers"],
            "decoder_attention_heads": w["dec_heads"],
            "decoder_ffn_dim": w["dec_ffn"], "activation_function": "gelu",
            "vocab_size": w["vocab"],
            "max_position_embeddings": w["max_positions"],
            "layernorm_embedding": True, "scale_embedding": False,
            "use_learned_position_embeddings": True,
            "cross_attention_hidden_size": w["enc_hidden"],
            "init_std": 0.02, "bos_token_id": 0, "eos_token_id": 2,
            "pad_token_id": 1},
    }


def train_byte_bpe(texts, n_merges):
    """A byte-level BPE in RoBERTa's layout: vocab (<s> 0, <pad> 1, </s>
    2, <unk> 3, the 256 byte characters, the merged tokens, <mask> last)
    and ``n_merges`` merges, each the most frequent adjacent pair over the
    texts' GPT-2 pieces (ties to the smaller pair)."""
    from collections import Counter

    from effocr_torch.baselines.tokenizer import BYTE_CHAR, gpt2_split

    words = Counter(tuple(BYTE_CHAR[b] for b in piece.encode("utf-8"))
                    for t in texts for piece in gpt2_split(t))
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for wd, c in words.items():
            for pair in zip(wd, wd[1:]):
                pairs[pair] += c
        if not pairs:
            break
        best = min(pairs, key=lambda q: (-pairs[q], q))
        merges.append(best)
        joined = Counter()
        for wd, c in words.items():
            out, i = [], 0
            while i < len(wd):
                if i + 1 < len(wd) and (wd[i], wd[i + 1]) == best:
                    out.append(wd[i] + wd[i + 1])
                    i += 2
                else:
                    out.append(wd[i])
                    i += 1
            joined[tuple(out)] += c
        words = joined
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for b in range(256):
        vocab[BYTE_CHAR[b]] = len(vocab)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<mask>"] = len(vocab)
    return vocab, merges


def write_trocr_dir(d, w, texts, seed):
    """config.json, model.safetensors (the port's writer) and vocab.json +
    merges.txt (the tokenizer files of the ViT-encoder TrOCR
    checkpoints)."""
    from effocr_torch.interop.safetensors import save_file

    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(trocr_config(w), f, indent=1)
    sd = trocr_hf_state_dict(w, seed)
    save_file(sd, os.path.join(d, "model.safetensors"))
    vocab, merges = train_byte_bpe(texts, TROCR_MERGES)
    with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(d, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return sum(v.size for v in sd.values()), len(vocab), len(merges)


def trocr_fwd_flops(spec, mlp, ffn, t):
    """Matmul FLOPs (2 a multiply-add) of one image's teacher-forced
    forward over ``t`` tokens: the patch embedding, each encoder layer's
    q / k / v / o, scores, weighted sum and MLP over N + 1 tokens, each
    decoder layer's self attention, cross attention (k / v of the N + 1
    memory tokens from ``cross_hidden``) and FFN, and the output
    projection."""
    n = spec.n_patches + 1
    e, d, c, v = (spec.enc_hidden, spec.dec_hidden, spec.cross_hidden,
                  spec.vocab_size)
    enc = spec.n_patches * spec.patch ** 2 * 3 * e + spec.enc_layers * (
        4 * n * e * e + 2 * n * n * e + 2 * n * e * mlp)
    dec = spec.dec_layers * (
        4 * t * d * d + 2 * t * t * d + 2 * t * d * d + 2 * n * c * d
        + 2 * t * n * d + 2 * t * d * ffn) + t * d * v
    return 2 * enc, 2 * dec


def _trocr_batch(tok, coco_json, img_dir, n, size, max_len, pad):
    """uint8 pixels [n, size, size, 3], labels and masks of the first
    ``n`` lines of a COCO file, as the command builds them."""
    from effocr_torch.cli.import_trocr import load_line

    with open(coco_json) as f:
        ims = [im for im in json.load(f)["images"] if im.get("text")][:n]
    pix = np.stack([load_line(os.path.join(img_dir, im["file_name"]), size)
                    for im in ims])
    labels = np.full((n, max_len), pad, np.int64)
    for i, im in enumerate(ims):
        ids = tok(im["text"], truncation=True, max_length=max_len).input_ids
        labels[i, :len(ids)] = ids
    return pix, labels, labels != pad


def _float(text, pattern):
    return [float(x) for x in re.findall(pattern, text)]


def phase_trocr(dev, card, tl):
    """``python -m effocr_torch import-trocr`` on the card at the
    published trocr-base widths from seeded weights: the checkpoint
    directory (model.safetensors with the output projection, config.json
    without decoder_start_token_id, a byte-level BPE vocab.json +
    merges.txt of TROCR_MERGES merges counted from phase
    train_localizer's train texts), then the command with ``--check
    --train_coco_json --val_coco_json --coco_json --num_beams 4`` on
    TROCR_SPLITS of phase train_localizer's splits: the check's largest
    gap, steps/s and images/s from the second epoch, the mean loss by
    epoch (it must fall), zero-shot and per-epoch CER, greedy and beam-4
    lines/s.  Then, in process, from the fine-tuned npz: one float32
    fine-tune step at batch TROCR_STEP_BATCH on the card and on the CPU
    (loss 1e-5 relative, gradients 1e-3 of the largest); the card's greedy
    tokens of TROCR_CHECK_LINES val lines, the teacher-forced logits of
    start + those tokens on the card and the CPU (within
    TROCR_LOGIT_TOL), and the CPU's argmax at every step up to the EOS:
    where it first differs from the card's token (where a CPU greedy
    decode would leave the card's), the CPU top-2 margin must be under
    TROCR_MARGIN (counted).  Last, where the time of the command's step
    (batch 8, AdamW) goes: its wall time, its kernels under
    torch.profiler (GEMM and the rest, busy share) and the TFLOP/s of
    its matmuls (``trocr_fwd_flops``), and greedy decode's."""
    from effocr_torch.baselines.tokenizer import load_tokenizer
    from effocr_torch.baselines.trocr_import import (
        TrOCR,
        load_trocr_npz,
        make_trocr_finetune_step,
        trocr_greedy_decode,
    )
    from torch.profiler import ProfilerActivity, profile

    from effocr_torch.cli.import_trocr import _special_ids
    from effocr_torch.train.optim import AdamW

    w = TROCR_BASE
    root = os.path.join(WORK, "trocr")
    model_dir = os.path.join(root, "hf_ckpt")
    splits = {k: _coco_head(tl["splits"][k], n,
                            os.path.join(root, f"{k}.json"))
              for k, n in TROCR_SPLITS.items()}
    with open(tl["splits"]["train"]) as f:
        texts = [im["text"] for im in json.load(f)["images"]]
    t0 = time.perf_counter()
    n_params, n_vocab, n_merges = write_trocr_dir(model_dir, w, texts, SEED)
    tok = load_tokenizer(model_dir)
    for t in texts:
        ids = tok(t).input_ids
        if tok.decode(ids, skip_special_tokens=True) != t:
            raise AssertionError(f"trocr: the tokenizer does not round-trip "
                                 f"{t!r} ({ids})")
    log(f"trocr: checkpoint of {n_params / 1e6:.1f}M params, tokenizer of "
        f"{n_vocab} tokens ({n_merges} merges; {len(texts)} train texts "
        f"round-trip) written in {time.perf_counter() - t0:.1f} s")

    out, wall = run_cli(
        ["import-trocr", "--device", "cuda", "--model_dir", model_dir,
         "--check", "--train_coco_json", splits["train"], "--val_coco_json",
         splits["val"], "--image_dir", tl["img_dir"], "--coco_json",
         splits["read"], "--num_beams", "4", "--num_epochs",
         str(TROCR_EPOCHS)], "import_trocr")
    if "torch parity check passed" not in out:
        raise AssertionError("trocr: no parity check line")
    gap = _float(out, r"max \|logit diff\| (\S+)")[0]
    steps = _float(out, r"train: steps=(\d+)")
    images = _float(out, r"train: steps=\d+ images=(\d+)")
    secs = _float(out, r"train: steps=\d+ images=\d+ seconds=(\S+)")
    losses = _float(out, r"mean_loss=(\S+)")
    zero_cer = _float(out, r"zero-shot: line_accuracy=\S+ CER=(\S+)")[0]
    cers = _float(out, r"epoch \d+: loss=\S+ line_accuracy=\S+ CER=(\S+)")
    greedy = [float(n) / float(s) for n, s in re.findall(
        r"greedy eval: (\d+) val lines in (\S+) s", out)]
    beam_n, beam_s = [float(x) for x in re.search(
        r"decode: (\d+) lines in (\S+) s \(beam 4", out).groups()]
    read_acc, read_cer = [float(x) for x in re.search(
        r"n=\d+ line_accuracy=(\S+) CER=(\S+)", out).groups()]
    if len(losses) != TROCR_EPOCHS or not np.all(np.isfinite(
            losses + cers + [gap])):
        raise AssertionError(f"trocr: epochs {losses}, CER {cers}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"trocr: epoch losses {losses} do not fall")
    steps_s = sum(steps[1:]) / sum(secs[1:])
    images_s = sum(images[1:]) / sum(secs[1:])
    log(f"trocr: import-trocr exited 0 in {wall:.1f} s (process wall: "
        f"conversion, --check, corpus decode, fine-tune, evaluation); "
        f"--check max |logit diff| {gap:.3g} against the float64 reference "
        f"(tolerance 2e-3); epochs {secs} s of {[int(s) for s in steps]} "
        f"steps of 8; epochs 2-{len(steps)}: {steps_s:.3f} steps/s = "
        f"{images_s:.2f} images/s ({card}); mean loss by epoch {losses}; "
        f"CER zero-shot {zero_cer}, by epoch {cers}; greedy eval "
        f"{[round(g, 2) for g in greedy]} lines/s; beam 4 on "
        f"{int(beam_n)} read lines {beam_n / beam_s:.2f} lines/s, "
        f"line_accuracy {read_acc} CER {read_cer}")

    # card against CPU from the fine-tuned weights
    params, spec = load_trocr_npz(os.path.join(model_dir,
                                               "trocr_tpu_ft.npz"))
    start, eos, pad = _special_ids(model_dir, tok)
    cpu = torch.device("cpu")
    models = [(dev, TrOCR.from_flat(params, spec).to(dev)),
              (cpu, TrOCR.from_flat(params, spec))]
    del params
    pix, labels, mask = _trocr_batch(tok, splits["train"], tl["img_dir"],
                                     TROCR_STEP_BATCH, spec.image_size, 64,
                                     pad)
    steps_out = []
    for device, m in models:
        rec = GradRecorder(dict(m.named_parameters()))
        loss = make_trocr_finetune_step(m, rec, start)(
            *(torch.from_numpy(a).to(device) for a in (pix, labels, mask)))
        steps_out.append((float(loss), rec.grads))
        m.zero_grad(set_to_none=True)
    (lc, gc), (lp, gp) = steps_out
    del steps_out
    gmax = max(float(g.abs().max()) for g in gp.values())
    gerr = max(float((gc[k] - g).abs().max()) for k, g in gp.items()) / gmax
    lrel = abs(lc - lp) / abs(lp)
    del gc, gp
    log(f"trocr_step_vs_cpu: one float32 fine-tune step at full width, "
        f"batch {TROCR_STEP_BATCH}: loss {lc:.7f} (card) vs {lp:.7f} (CPU), "
        f"rel {lrel:.3g} (tolerance 1e-5); max |grad diff| / max|g| "
        f"{gerr:.3g} (tolerance 1e-3; {card})")
    if not (lrel <= 1e-5 and gerr <= 1e-3):
        raise AssertionError("trocr_step_vs_cpu: card and CPU disagree")

    vpix, _, _ = _trocr_batch(tok, splits["val"], tl["img_dir"],
                              TROCR_CHECK_LINES, spec.image_size, 64, pad)
    x = [m.normalize(torch.from_numpy(vpix).to(d)) for d, m in models]
    with torch.no_grad():
        tokens = trocr_greedy_decode(models[0][1], x[0], max_len=64,
                                     bos_id=start, eos_id=eos,
                                     pad_id=pad).cpu()
        full = torch.cat([torch.full((len(tokens), 1), start), tokens], 1)
        on_card, on_cpu = [m(xi, full.to(d)).cpu()
                           for (d, m), xi in zip(models, x)]
    lgap = float((on_card - on_cpu).abs().max())
    if not torch.allclose(on_card, on_cpu, rtol=TROCR_LOGIT_TOL,
                          atol=TROCR_LOGIT_TOL):
        raise AssertionError(f"trocr: teacher-forced logits, card vs CPU, "
                             f"max |diff| {lgap}")
    top = torch.topk(on_cpu[:, :-1], 2, dim=-1)
    margins = (top.values[..., 0] - top.values[..., 1]).numpy()
    cpu_next = on_cpu[:, :-1].argmax(-1).numpy()
    near, bad, n_steps = 0, [], 0
    for r, row in enumerate(tokens.numpy()):
        ends = np.flatnonzero(row == eos)
        last = int(ends[0]) + 1 if len(ends) else len(row)
        n_steps += last
        diff = np.flatnonzero(cpu_next[r, :last] != row[:last])
        if len(diff):
            t = int(diff[0])
            if margins[r, t] < TROCR_MARGIN:
                near += 1
            else:
                bad.append((r, t, float(margins[r, t])))
    log(f"trocr: {len(tokens)} val lines, card greedy ({n_steps} steps up "
        f"to EOS) vs the CPU: teacher-forced logits max |diff| {lgap:.3g} "
        f"(tolerance {TROCR_LOGIT_TOL}); {len(tokens) - near - len(bad)} "
        f"lines identical, {near} part after a step whose CPU top-2 margin "
        f"is < {TROCR_MARGIN}, {len(bad)} otherwise (smallest CPU margin "
        f"on the path {float(margins.min()):.3g}); "
        f"{[tok.decode(r.tolist(), skip_special_tokens=True) for r in tokens[:2]]}")
    if bad:
        raise AssertionError(f"trocr: greedy tokens differ at clear "
                             f"margins: {bad}")
    model = models[0][1]
    del models, x, on_card, on_cpu

    # where a step's time goes: the command's step (batch 8, AdamW) on
    # the card, timed by the host clock around synchronized steps, then
    # under torch.profiler; the float32 matmul work from the shapes
    enc_f, dec_f = trocr_fwd_flops(spec, model.enc.L[0].fc1_w.shape[1],
                                   model.dec.L[0].fc1_w.shape[1], 64)
    step_tflop = 3 * 8 * (enc_f + dec_f) / 1e12
    greedy_tflop = 8 * (enc_f + 63 * dec_f) / 1e12
    batch = [torch.from_numpy(a).to(dev) for a in _trocr_batch(
        tok, splits["train"], tl["img_dir"], 8, spec.image_size, 64, pad)]
    step = make_trocr_finetune_step(
        model.train(), AdamW([(list(model.parameters()), 5e-5)]), start)
    for _ in range(2):
        step(*batch)
    torch.cuda.synchronize()
    n_steps = 5
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step(*batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step(*batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / n_steps
    gemm = sum(e.self_device_time_total for e in kernels
               if "gemm" in e.key.lower()) / 1e3 / n_steps
    launches = sum(e.count for e in kernels) / n_steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"trocr: the fine-tune step at batch 8 ({card}): {step_ms:.1f} ms "
        f"wall ({n_steps} steps), {total:.1f} ms of kernels in "
        f"{launches:.0f} launches (busy share {total / step_ms:.3f}, "
        f"profiler on); GEMM kernels {gemm:.1f} ms ({gemm / total:.3f} of "
        f"the kernels), the rest {total - gemm:.1f} ms; {step_tflop:.2f} "
        f"TFLOP of matmuls a step (encoder {3 * 8 * enc_f / 1e12:.2f}, "
        f"decoder {3 * 8 * dec_f / 1e12:.2f}): {step_tflop / step_ms * 1e3:.1f}"
        f" TFLOP/s a step, {step_tflop / gemm * 1e3:.1f} in the GEMM "
        f"kernels (float32 peak 67); greedy decode of 8 lines "
        f"{greedy_tflop:.1f} TFLOP of matmuls (63 decoder passes), "
        f"{greedy_tflop * max(greedy) / 8:.1f} TFLOP/s at the CLI's best "
        f"{max(greedy):.2f} lines/s")
    for e in top:
        log(f"trocr: kernel {e.self_device_time_total / 1e3 / n_steps:8.2f}"
            f" ms/step x{e.count // n_steps:<4d} {e.key[:100]}")
    del model, step, batch
    return dict(k1_launches=0, k2_launches=0, params_m=n_params / 1e6,
                step_ms=step_ms, step_kernel_ms=total, step_gemm_ms=gemm,
                step_launches=launches, step_tflop=step_tflop,
                greedy_tflop=greedy_tflop,
                check_gap=gap, steps_s=steps_s, images_s=images_s,
                epoch_losses=losses, epoch_seconds=secs, zero_shot_cer=zero_cer,
                val_cer=cers, greedy_lines_s=greedy,
                beam4_lines_s=beam_n / beam_s, read_accuracy=read_acc,
                read_cer=read_cer, cli_wall_s=wall, step_loss_rel=lrel,
                step_grad_err=gerr, logits_gap=lgap, greedy_near_ties=near)


# ------------------------------------------------------- image formats
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "images")
N_FORMAT_LINES = 256     # distinct paths: the 64 fixture lines, 4 times
N_FORMAT_SERVE = 18      # the last two: a float and an RGBa .tif


def fixture_tools():
    """tests/torch_fixtures/make_images.py: the fixtures' digest and the
    TIFF / BMP writers (numpy and the standard library only; Pillow and
    JAX are imported only by its generator functions)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fixtures import make_images

    return make_images


def fixture_checks():
    """Every committed fixture, decoded by the port, against golden.npz:
    Pillow's RGB and L conversions and the JAX package's _LazyImage
    arrays (both channel rules), bit for bit by SHA-256 and shape; where
    Pillow refuses a conversion (LAB -> L), the same exception."""
    from effocr_torch.data import image_io
    from effocr_torch.pipelines.infer import _LazyImage

    mi = fixture_tools()
    golden = np.load(os.path.join(FIXTURES, "golden.npz"))
    names = sorted({k.split("|")[0] for k in golden.files})
    for name in names:
        p = os.path.join(FIXTURES, name)
        got = {}
        for kind, fn in (("rgb", image_io.read_rgb), ("l", image_io.read_l),
                         ("lazy_gray", lambda q: _LazyImage(q, True).load()),
                         ("lazy_rgb", lambda q: _LazyImage(q, False).load())):
            err = f"{name}|{kind}|error"
            try:
                got[kind] = fn(p)
            except Exception as e:  # noqa: BLE001 (held to the golden's)
                if err not in golden.files or type(e).__name__ != str(
                        golden[err]):
                    raise
                continue
            if err in golden.files:
                raise AssertionError(f"image_formats: {name} {kind} gives "
                                     f"pixels, Pillow {golden[err]}")
        for kind, a in got.items():
            if (tuple(golden[f"{name}|{kind}|shape"]) != a.shape
                    or not np.array_equal(mi.digest(a), golden[
                        f"{name}|{kind}|sha256"])):
                raise AssertionError(f"image_formats: {name} {kind} differs "
                                     "from its golden (Pillow / JAX)")
    return names


def decode_rates(names, card):
    """Host decode rates: the 2550 x 3300 gray JPEG page, its group4 TIFF
    and its L pixels as a tiled TIFF (256 x 256 Deflate tiles with
    predictor 2, written here and checked against the pixels) and as
    float samples (/ 255, 256 x 256 Deflate tiles without and with
    predictor 3, checked the same way) on one thread, 8 copies of the JPEG page as one threaded native batch (8
    threads), and the 64 fixture lines one file at a time and as one
    batch; best of 3, MP/s."""
    from effocr_torch.data import image_io, jpeg, tiff
    from effocr_torch.native import glyph, imgdec

    def best(fn, reps=3):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times)

    out = {}
    page = open(os.path.join(FIXTURES, "page", "page.jpg"), "rb").read()
    h, w, _ = jpeg.jpeg_header(page)
    t = best(lambda: imgdec.decode_jpeg(page, (h, w, 1)))
    out["page_jpeg_ms"], out["page_jpeg_mp_s"] = t * 1e3, h * w / t / 1e6
    page_path = os.path.join(FIXTURES, "page", "page.jpg")
    t = best(lambda: imgdec.decode_jpeg_batch([page_path] * 8,
                                              [(h, w, 1)] * 8, 8))
    out["page_jpeg_batch8_mp_s"] = 8 * h * w / t / 1e6
    g4 = open(os.path.join(FIXTURES, "page", "page_g4.tif"), "rb").read()
    t = best(lambda: tiff.decode(g4))
    out["page_g4_ms"], out["page_g4_mp_s"] = t * 1e3, h * w / t / 1e6
    # the page's L pixels as 256 x 256 Deflate tiles with predictor 2,
    # written by the fixtures' writer (numpy and zlib)
    gray = imgdec.decode_jpeg(page, (h, w, 1))[..., 0]
    t0 = time.perf_counter()
    tiled = fixture_tools().tiff_layout(gray, compression=8, predictor=2,
                                        tile=(256, 256))
    out["page_tiled_write_s"] = time.perf_counter() - t0
    px, mode, _ = tiff.decode(tiled)
    if mode != "L" or not np.array_equal(px, gray):
        raise AssertionError("image_formats: the tiled page does not decode "
                             "to the page's L pixels")
    t = best(lambda: tiff.decode(tiled))
    out["page_tiled_ms"], out["page_tiled_mp_s"] = t * 1e3, h * w / t / 1e6
    out["page_tiled_bytes"] = len(tiled)
    # the page as float samples (an archive master's), 256 x 256 Deflate
    # tiles with and without the floating-point predictor
    fpage = gray.astype(np.float32) * np.float32(1.0 / 255.0)
    for pred in (1, 3):
        data = fixture_tools().tiff_layout(fpage, bits=32, sample_format=3,
                                           compression=8, predictor=pred,
                                           tile=(256, 256))
        px, mode, _ = tiff.decode(data)
        if mode != "F" or not np.array_equal(px, fpage):
            raise AssertionError("image_formats: the float page does not "
                                 "decode to its samples")
        t = best(lambda: tiff.decode(data))
        out[f"page_float_pred{pred}_ms"] = t * 1e3
        out[f"page_float_pred{pred}_mp_s"] = h * w / t / 1e6
        out[f"page_float_pred{pred}_bytes"] = len(data)
    lines = [os.path.join(FIXTURES, n) for n in names
             if n.startswith("lines/")]
    shapes = [image_io.header(p)[:2] for p in lines]
    shapes = [(hh, ww, 1) for hh, ww in shapes]
    data = [open(p, "rb").read() for p in lines]
    mp = sum(hh * ww for hh, ww, _ in shapes) / 1e6

    def one_by_one():
        for d, s in zip(data, shapes):
            imgdec.decode_jpeg(d, s)

    t = best(one_by_one)
    out["lines_single_mp_s"] = mp / t
    out["lines_single_ms_per_line"] = t * 1e3 / len(lines)
    t = best(lambda: imgdec.decode_jpeg_batch(lines, shapes, 8))
    out["lines_batch_mp_s"] = mp / t
    out["lines_mp"] = mp
    log(f"image_formats: decode on the host (best of 3; {card}): gray JPEG "
        f"page {w}x{h} {out['page_jpeg_ms']:.1f} ms = "
        f"{out['page_jpeg_mp_s']:.1f} MP/s (one thread), 8 copies as one "
        f"8-thread batch {out['page_jpeg_batch8_mp_s']:.1f} MP/s; group4 "
        "TIFF page "
        f"{out['page_g4_ms']:.1f} ms = {out['page_g4_mp_s']:.1f} MP/s; the "
        f"page as 256 x 256 Deflate tiles with predictor 2 "
        f"({out['page_tiled_bytes']} bytes, written in "
        f"{out['page_tiled_write_s']:.2f} s) {out['page_tiled_ms']:.1f} ms "
        f"= {out['page_tiled_mp_s']:.1f} MP/s, equal to the page's L "
        "pixels; the page as float samples in 256 x 256 Deflate tiles "
        f"{out['page_float_pred1_ms']:.1f} ms = "
        f"{out['page_float_pred1_mp_s']:.1f} MP/s "
        f"({out['page_float_pred1_bytes']} bytes), with predictor 3 "
        f"{out['page_float_pred3_ms']:.1f} ms = "
        f"{out['page_float_pred3_mp_s']:.1f} MP/s "
        f"({out['page_float_pred3_bytes']} bytes), equal to its samples; "
        f"{len(lines)} JPEG lines ({mp:.2f} MP) one at a time "
        f"{out['lines_single_mp_s']:.1f} MP/s "
        f"({out['lines_single_ms_per_line']:.3f} ms a line), as one "
        f"8-thread batch {out['lines_batch_mp_s']:.1f} MP/s")
    return out


def _format_dirs(names):
    """The 64 fixture lines copied to N_FORMAT_LINES distinct .jpg paths,
    and the same lines as PNGs written from their decoded (golden-equal)
    pixels under the gray pipeline's channel rule."""
    from effocr_torch.pipelines.infer import _LazyImage

    d = os.path.join(WORK, "formats")
    shutil.rmtree(d, ignore_errors=True)
    jdir, pdir = os.path.join(d, "jpg"), os.path.join(d, "png")
    os.makedirs(jdir)
    os.makedirs(pdir)
    lines = [n for n in names if n.startswith("lines/")]
    pixels = {}
    for name in lines:
        px = _LazyImage(os.path.join(FIXTURES, name), gray=True).load()
        pixels[name] = px[..., 0] if px.shape[2] == 1 else px
    for k in range(N_FORMAT_LINES):
        name = lines[k % len(lines)]
        stem = f"{k:05d}_{os.path.basename(name)[:-4]}"
        shutil.copy(os.path.join(FIXTURES, name),
                    os.path.join(jdir, stem + ".jpg"))
        write_png(os.path.join(pdir, stem + ".png"), pixels[name])
    return jdir, pdir, pixels


def _cli_outputs(out_dir):
    """infer's inference_results.json and inference_coco.json, keyed by
    file stem (the two runs differ only in the extension)."""
    with open(os.path.join(out_dir, "inference_results.json")) as f:
        res = {os.path.splitext(k)[0]: v for k, v in json.load(f).items()}
    with open(os.path.join(out_dir, "inference_coco.json")) as f:
        coco = json.load(f)
    for im in coco["images"]:
        im["file_name"] = os.path.splitext(im["file_name"])[0]
    return res, coco


def _serve_requests(names, pixels):
    """N_FORMAT_SERVE requests: fixture JPEG lines and the same lines as
    TIFF (uncompressed strips; one in Deflate tiles with predictor 2, one
    stored rotated under orientation 6) and palette BMP files, then a
    line as float samples (Deflate tiles, predictor 3) and one as
    associated-alpha RGBA (LZW, part of it at alpha 128), written by the
    fixture generator's writers, which need no Pillow."""
    mi = fixture_tools()
    d = os.path.join(WORK, "formats", "serve")
    os.makedirs(d, exist_ok=True)
    lines = [n for n in names if n.startswith("lines/")]
    paths = []
    for k in range(N_FORMAT_SERVE - 2):
        name = lines[(7 * k) % len(lines)]
        px = pixels[name]
        kind = ("jpg", "tif", "bmp")[k % 3]
        p = os.path.join(d, f"r{k:02d}.{kind}")
        if kind == "jpg":
            shutil.copy(os.path.join(FIXTURES, name), p)
        elif kind == "tif":
            photo = 2 if px.ndim == 3 else 1
            if k == 1:      # tiled, Deflate with predictor 2
                data = mi.tiff_layout(px, photometric=photo, compression=8,
                                      predictor=2, tile=(64, 64))
            elif k == 4:    # stored rotated, orientation 6 turns it back
                data = mi.tiff_layout(
                    np.ascontiguousarray(np.rot90(px, 1)), photometric=photo,
                    compression=32773, rows_per_strip=16,
                    extra_tags={274: (3, [6])})
            else:
                data = mi.tiff_gray(px, order=">" if k % 2 else "<",
                                    rows_per_strip=16,
                                    extra_tags={262: (3, [photo])})
            with open(p, "wb") as f:
                f.write(data)
        else:
            g = px if px.ndim == 2 else (px.astype(np.uint16).sum(-1)
                                         // 3).astype(np.uint8)
            grey = b"".join(bytes([i, i, i, 0]) for i in range(256))
            with open(p, "wb") as f:
                f.write(mi.bmp_bytes(g.shape[1], g.shape[0], 8,
                                     mi.bmp_rows(g, 8), palette=grey))
        paths.append(p)
    for k, kind in ((N_FORMAT_SERVE - 2, "float"),
                    (N_FORMAT_SERVE - 1, "rgba")):
        px = pixels[lines[(7 * k) % len(lines)]]
        g = px if px.ndim == 2 else (px.astype(np.uint16).sum(-1)
                                     // 3).astype(np.uint8)
        if kind == "float":
            data = mi.tiff_layout(g.astype(np.float32) * 1.25 - 40.5, bits=32,
                                  sample_format=3, compression=8,
                                  predictor=3, tile=(64, 64))
        else:
            a = np.full(g.shape, 255, np.int64)
            a[:, :a.shape[1] // 3] = 128
            rgb = np.repeat(g[..., None].astype(np.int64), 3, -1)
            data = mi.tiff_layout(np.dstack([rgb * a[..., None] // 255, a]),
                                  photometric=2, compression=5,
                                  extra_tags={338: (3, [1])})
        p = os.path.join(d, f"r{k:02d}_{kind}.tif")
        with open(p, "wb") as f:
            f.write(data)
        paths.append(p)
    return paths


def _serve_formats(paths, loc_dir, rec_dir, card):
    """``serve --stdin --device cuda`` with BENCH_TRAINED.json's flags on
    the mixed requests; answers held to engine.run over the server's
    batches, K1 checked on every call."""
    import argparse

    flags = engine_flags(loc_dir, rec_dir) + ["--line_batch",
                                              str(N_FORMAT_SERVE)]
    proc = subprocess.run(
        [sys.executable, "-m", "effocr_torch", "serve", "--stdin",
         "--device", "cuda", "--max_latency_ms", "50", *flags],
        input="\n".join(paths) + "\n", capture_output=True, text=True,
        cwd=ROOT, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"image_formats serve exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    answers = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith("{")]
    if [a["path"] for a in answers] != paths:
        raise AssertionError("image_formats serve: not one answer per path "
                             "in order")
    batches = [int(ln.rsplit(" ", 1)[1]) for ln in proc.stderr.splitlines()
               if ln.startswith("serve: batch of ")]
    stats = [ln for ln in proc.stderr.splitlines()
             if ln.startswith("serve: kernel launches")]
    k1 = int(stats[-1].split("nms ")[1].split(",")[0])
    p = argparse.ArgumentParser()
    add_engine_args(p)
    engine = load_engine(p.parse_args(flags))
    ref, s = {}, 0
    with kernels_checked("image_formats serve") as (k1c, _):
        for n in batches:
            ref.update(engine.run(paths[s:s + n]))
            s += n
    n_diff = sum(a["text"] != ref[a["path"]] for a in answers)
    if s != len(paths) or n_diff or k1 == 0 or k1c.calls == 0:
        raise AssertionError(f"image_formats serve: {n_diff} answers differ "
                             f"from engine.run; batches {batches}; K1 "
                             f"launched {k1} times by the server")
    log(f"image_formats: serve answered {len(answers)} .jpg / .tif / .bmp "
        "requests (a tiled, an orientation-6, a float and an RGBa .tif "
        "among them) "
        f"identically to engine.run over its batches {batches} "
        f"(K1 held bit for bit on {k1c.calls} calls in process; the server "
        f"launched K1 {k1} times; {card})")
    return dict(n_requests=len(answers), batches=batches,
                server_k1_launches=k1, k1_checked=k1c.calls)


def phase_image_formats(dev, card, loc_dir, rec_dir):
    """JPEG, TIFF, BMP and GIF input where Pillow is not installed:
    1. every fixture of tests/torch_fixtures/images/ equals its golden
       (Pillow's conversions, the JAX _LazyImage arrays) bit for bit;
    2. ``infer --infer_over_img_dir`` with BENCH_TRAINED.json's flags on
       256 JPEG line paths (32 gray, 32 RGB 4:2:0 lines, 4 copies each,
       so that the whole script ends inside 1200 s), then on the same lines
       as PNGs written from their decoded pixels: identical text and
       COCO boxes; every K1 call of both runs held bit for bit against
       nms_mask; K1's launches counted from 0 around the JPEG run; both
       runs on one engine (``load_engine``'s, handed to the CLI), then
       timed on both lists (lines/s, host decode ms a chunk, header ms);
    3. 18 mixed .jpg / .tif / .bmp requests (a tiled, an orientation-6,
       a float and an RGBa .tif among them) through ``serve``, answered as
       engine.run answers them;
    and the host decode rates (``decode_rates``)."""
    from effocr_torch.cli import infer as infer_cli

    t0 = time.perf_counter()
    names = fixture_checks()
    log(f"image_formats: {len(names)} fixtures (JPEG, TIFF, BMP, GIF; "
        "lines, one per decoder branch and TIFF layout, a page) equal "
        "their goldens bit "
        "for bit: Pillow 12.1's RGB and L conversions and the JAX "
        f"_LazyImage arrays of both channel rules "
        f"({time.perf_counter() - t0:.1f} s)")
    rates = decode_rates(names, card)
    jdir, pdir, pixels = _format_dirs(names)
    flags = engine_flags(loc_dir, rec_dir)
    engine = load_engine(engine_args(loc_dir, rec_dir))
    outs, k1 = {}, {}
    cli_load = infer_cli.load_engine
    infer_cli.load_engine = lambda args: engine
    try:
        for tag, d in (("jpg", jdir), ("png", pdir)):
            out = os.path.join(WORK, "formats", f"out_{tag}")
            cuda_nms.nms_kernel.launches = 0
            cuda_top1.top1_kernel.launches = 0
            with kernels_checked(f"image_formats {tag}") as (k1c, _):
                infer_cli.main(flags + ["--image_dir", d,
                                        "--infer_over_img_dir",
                                        "--save_output", out])
            k1[tag] = (cuda_nms.nms_kernel.launches, k1c.calls)
            outs[tag] = _cli_outputs(out)
    finally:
        infer_cli.load_engine = cli_load
    (rj, cj), (rp, cp) = outs["jpg"], outs["png"]
    if len(rj) != N_FORMAT_LINES or rj != rp or cj != cp:
        raise AssertionError(
            f"image_formats: {len(rj)} JPEG results; "
            f"{sum(rj.get(k) != v for k, v in rp.items())} texts and "
            f"{'the same' if cj == cp else 'different'} COCO output against "
            "the PNG run")
    if k1["jpg"][0] == 0 or k1["jpg"][1] == 0:
        raise AssertionError(f"image_formats: K1 launched {k1['jpg']} on "
                             "the JPEG run")
    n_boxes = len(cj["annotations"])
    n_read = sum(v is not None for v in rj.values())
    log(f"image_formats: infer --infer_over_img_dir on {len(rj)} JPEG "
        f"lines and on their PNGs: identical text ({n_read} lines read) "
        f"and identical COCO output ({n_boxes} char boxes); K1 "
        f"launched {k1['jpg'][0]} times on the JPEG run, every call "
        f"({k1['jpg'][1]} on JPEG, {k1['png'][1]} on PNG) held bit for bit "
        "against nms_mask")
    lists = {tag: sorted(os.path.join(d, f) for f in os.listdir(d))
             for tag, d in (("jpg", jdir), ("png", pdir))}
    from effocr_torch.pipelines.infer import _LazyImage

    timing = {}
    for tag in ("jpg", "png"):       # the engine is warm from the CLI runs
        t1 = time.perf_counter()
        for p in lists[tag]:
            _LazyImage(p, gray=True)
        headers_ms = (time.perf_counter() - t1) * 1e3
        engine.timer.reset()
        t1 = time.perf_counter()
        engine.run(lists[tag])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        tm = engine.timer
        decode = sum(tm.totals[k] for k in ("prep/decode",
                                            "prep/letterbox+pack",
                                            "prep/decode+letterbox"))
        chunks = max(tm.counts["prep/h2d+dispatch"], 1)
        timing[tag] = dict(lines_s=len(lists[tag]) / wall, wall_s=wall,
                           headers_ms=headers_ms,
                           decode_letterbox_ms_per_chunk=decode * 1e3
                           / chunks, chunks=chunks,
                           stages={k: tm.totals[k] for k in tm.totals})
    log(f"image_formats: the en engine on {N_FORMAT_LINES} lines ({card}): "
        f"JPEG {timing['jpg']['lines_s']:.1f} lines/s, host decode + "
        f"letterbox {timing['jpg']['decode_letterbox_ms_per_chunk']:.1f} ms "
        f"a chunk (prep/decode, then prep/letterbox+pack); PNG "
        f"{timing['png']['lines_s']:.1f} lines/s, "
        f"{timing['png']['decode_letterbox_ms_per_chunk']:.1f} ms a chunk "
        "(the fused prep/decode+letterbox); after the CLI runs; the "
        f"headers of the {N_FORMAT_LINES} files (the engine's _LazyImage, "
        f"before the first chunk) {timing['jpg']['headers_ms']:.1f} ms for "
        f"JPEG, {timing['png']['headers_ms']:.1f} ms for PNG")
    serve = _serve_formats(_serve_requests(names, pixels), loc_dir, rec_dir,
                           card)
    return dict(n_fixtures=len(names), k1_launches=k1["jpg"][0],
                k2_launches=0, k1_checked=k1["jpg"][1] + k1["png"][1],
                png_run_k1_launches=k1["png"][0], n_lines=len(rj),
                n_char_boxes=n_boxes, decode=rates, timing=timing,
                serve=serve)


# ---------------------------------------------------------- glyph rendering
FONT_FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "fonts")
CFF_FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "fonts_cff")
N_AUG_BATCH = 64


def font_tools():
    """tests/torch_fixtures/make_fonts.py: the goldens' flags, character
    list and pipeline runner (numpy and the standard library only; Pillow
    and JAX are imported only by its generator)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fixtures import make_fonts

    return make_fonts


def cff_font_tools():
    """tests/torch_fixtures/make_cff_fonts.py: the CFF fonts' goldens
    (render cases, banks) and the jp pipeline runner (fontTools, Pillow
    and JAX are imported only by its generators)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fixtures import make_cff_fonts

    return make_cff_fonts


# The fonts phase's commands, in a process of its own started with the
# family phases: make-corpus -> make-charset -> format-dataset as
# ``python -m effocr_torch`` subprocesses (host work), the digests of
# their outputs, the same jp chain on the CID-keyed CFF font, then
# coco-split and ``train-recognizer --device cuda --adjacent_font_path``
# on the en tree (the flags in argv[4:]); one JSON line at the end.
FONT_PIPELINE = """
import json, os, shutil, subprocess, sys, time
root, work, font_dir, *train_flags = sys.argv[1:]
sys.path.insert(0, os.path.join(root, "tests"))
from torch_fixtures import make_fonts
walls = {}
def run(cmd, argv):
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "effocr_torch", cmd, *argv],
                         cwd=root, capture_output=True, text=True)
    walls[cmd] = time.perf_counter() - t0
    with open(os.path.join(work, cmd + ".log"), "w") as f:
        f.write(out.stdout + "--- stderr ---" + out.stderr)
    if out.returncode:
        sys.exit(f"{cmd}: exit {out.returncode}: {out.stderr[-3000:]}")
    return out.stdout
t0 = time.perf_counter()
digests = make_fonts.pipeline_outputs(work, font_dir, run)
seconds = time.perf_counter() - t0
# the jp chain on the CID-keyed CFF font alone
from torch_fixtures import make_cff_fonts
cff_work = os.path.join(work, "cff")
cff_fonts = os.path.join(cff_work, "fonts")
os.makedirs(cff_fonts)
shutil.copy(os.path.join(root, "tests", "torch_fixtures", "fonts_cff",
                         make_cff_fonts.CID), cff_fonts)
en_walls, walls = walls, {}
t1 = time.perf_counter()
cff_digests = make_cff_fonts.pipeline_outputs(cff_work, cff_fonts, run)
cff_seconds = time.perf_counter() - t1
cff_walls, walls = walls, en_walls
split = os.path.join(work, "split")
run("coco-split", ["--coco_json", os.path.join(work, "corpus", "corpus.json"),
                   "--out_prefix", split])
run("train-recognizer", ["--root_dir_path", os.path.join(work, "tree"),
                         "--train_ann_path", split + "_train.json",
                         "--val_ann_path", split + "_val.json",
                         "--test_ann_path", split + "_test.json",
                         "--run_name", os.path.join(work, "rec"),
                         *train_flags])
print(json.dumps({"digests": digests, "walls": walls, "seconds": seconds,
                  "cff_digests": cff_digests, "cff_walls": cff_walls,
                  "cff_seconds": cff_seconds,
                  "total_s": time.perf_counter() - t0}))
"""


def start_font_pipeline():
    """FONT_PIPELINE in the background over the committed fonts, training
    with the en recipe's flags cut to 1 epoch and the committed serif's
    neighbour-glyph bank; returns (process, work dir, font dir)."""
    mf = font_tools()
    work = os.path.join(WORK, "fonts")
    shutil.rmtree(work, ignore_errors=True)
    font_dir = os.path.join(work, "fonts")
    os.makedirs(font_dir)
    for fp in mf.font_files(FONT_FIXTURES):
        shutil.copy(fp, font_dir)
    serif = os.path.join(FONT_FIXTURES, mf.BANK_FONT)
    train = ["--device", "cuda", *_with(TRAIN_FLAGS, num_epochs="1"),
             "--adjacent_font_path", serif]
    proc = subprocess.Popen([sys.executable, "-c", FONT_PIPELINE, ROOT,
                             work, font_dir, *train], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, work, font_dir


def _metrics_rates(run_dir):
    recs = _metrics(run_dir)
    epochs = [r for r in recs if "epoch/steps" in r]
    steps = sum(r["epoch/steps"] for r in epochs)
    secs = sum(r["epoch/seconds"] for r in epochs)
    images = sum(r["epoch/images"] for r in epochs)
    val = [r["val/accuracy"] for r in recs if "val/accuracy" in r]
    losses = [(r["step"], r["train/loss"]) for r in recs
              if "train/loss" in r]
    return steps / secs, images / secs, val, losses, epochs


def phase_fonts_cff(card):
    """The CFF fixtures (name-keyed serif, 65,535-glyph CID-keyed sans)
    through the port's Adobe engine on the card's host: the CID font's
    open time (sfnt and CFF tables, the native face, one glyph rendered),
    every golden render (the 90 en characters in both fonts at canvas
    256, both draw functions; 90 CJK codepoints of the CID font) and the
    two banks against the JAX package's golden digests; renders/s per
    font."""
    from effocr_torch.data import fonts as F
    from effocr_torch.data.imaging import digest_image
    from effocr_torch.fonts import imagefont, sfnt

    mc = cff_font_tools()
    golden = np.load(os.path.join(CFF_FIXTURES, "golden.npz"))
    want = dict(zip(golden["render_keys"].tolist(),
                    golden["render_digests"].tolist()))
    cid = os.path.join(CFF_FIXTURES, mc.CID)
    t0 = time.perf_counter()
    first = imagefont.truetype(cid, 64).getmask2("\u4ee3")[0]
    open_s = time.perf_counter() - t0
    n_glyphs = sfnt.load(cid).num_glyphs
    if not first.any() or n_glyphs != 65535:
        raise AssertionError(f"fonts: the CID font opened with {n_glyphs} "
                             "glyphs or rendered nothing")
    bad, rates, n = [], {}, 0
    for name in mc.FONTS:
        font = F.truetype(os.path.join(CFF_FIXTURES, name), mc.CANVAS)
        cases = [c for c in mc.render_cases() if c[0] == name]
        t0 = time.perf_counter()
        for _, kind, cp in cases:
            fn = F.draw_single_char if kind == "single" else \
                F.draw_single_char_ascender
            img = fn(chr(cp), font, mc.CANVAS)
            got = "none" if img is None else digest_image(
                img, "L" if img.ndim == 2 else "RGB")
            if got != want[f"{name}|{kind}|{cp}"]:
                bad.append(f"{name} {kind} U+{cp:04X}")
        rates[name] = len(cases) / (time.perf_counter() - t0)
        n += len(cases)
    if bad or n != len(want):
        raise AssertionError(f"fonts: {len(bad)} of {n} CFF renders differ "
                             f"from the goldens (of {len(want)}): {bad[:8]}")
    t0 = time.perf_counter()
    for name, lang in mc.BANKS:
        b = F.render_adjacent_bank(os.path.join(CFF_FIXTURES, name),
                                   mc.BANK_SIZE, lang)
        if digest_image(b, "L") != str(golden[f"bank_{lang}"]):
            raise AssertionError(f"fonts: the {name} {lang} bank differs "
                                 "from its golden")
    bank_s = time.perf_counter() - t0
    log(f"fonts: CFF: the {n_glyphs}-glyph CID-keyed font opened and its "
        f"first glyph rendered in {open_s * 1000:.1f} ms; {n} renders "
        f"(the en characters in both CFF fonts, both draw functions, and "
        f"{len(mc.cjk_sample())} CJK codepoints of the CID font, at canvas "
        f"{mc.CANVAS}) and the serif en / CID jp banks ({bank_s:.2f} s) "
        f"equal Pillow 12.1's golden digests bit for bit; host renders/s "
        + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
        + f" ({card})")
    return {"cid_open_ms": open_s * 1000, "renders": n,
            "renders_per_s": rates, "bank_s": bank_s}


def bitmap_font_tools():
    """tests/torch_fixtures/make_bitmap_fonts.py and make_images.py: the
    strike, overlap and scaled-offset fonts' goldens and refused sizes,
    and the mode pages' format-dataset flags (fontTools, Pillow and JAX
    are imported only by their generators)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fixtures import make_bitmap_fonts, make_images

    return make_bitmap_fonts, make_images


# the mode pages format-dataset runs over on the card's host
CHIP_MODE_PAGES = ("g4", "palette")


def start_mode_pages():
    """``python -m effocr_torch format-dataset --spaces
    --clip_to_top_and_bottom`` over each of CHIP_MODE_PAGES, one process
    a page, started beside the family phases (as the font pipeline is)
    so that the fonts phase only reads their trees: {page: (work dir,
    process)}."""
    _, mi = bitmap_font_tools()
    work = os.path.join(WORK, "mode_pages")
    shutil.rmtree(work, ignore_errors=True)
    procs = {}
    for page in CHIP_MODE_PAGES:
        w = os.path.join(work, page)
        os.makedirs(w)
        procs[page] = (w, subprocess.Popen(
            [sys.executable, "-m", "effocr_torch", "format-dataset",
             *mi.mode_page_argv(page, w)], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def phase_fonts_bitmap(card, procs=None):
    """Bitmap strikes, overlap-flagged glyphs, scaled component offsets
    and every image mode in the dataset tools, on the card's host:
    1. every golden render of the three fixture fonts with outlines (the
       90 en characters, both draw functions, canvas 256) and their en / jp
       banks against the JAX package's golden digests; renders/s per font;
    2. the strike font and the strikes-only font swept over sizes 8-64:
       the sizes refused (FreeType hands back a strike's bitmaps there)
       equal the committed list, and the strikes-only font fails with
       "invalid pixel size" at every other size, as Pillow does;
    3. ``python -m effocr_torch format-dataset --spaces
       --clip_to_top_and_bottom`` over the group 4 bilevel TIFF and the
       palette PNG (tRNS) page fixtures, in the processes of
       ``start_mode_pages`` (``procs``; started here when not given):
       crops and tree equal the JAX command's golden digests."""
    from effocr_torch.data import fonts as F
    from effocr_torch.data.imaging import digest_image, digest_tree
    from effocr_torch.fonts import imagefont

    mb, mi = bitmap_font_tools()
    if procs is None:
        procs = start_mode_pages()

    golden = np.load(os.path.join(mb.OUT_DIR, "golden.npz"))
    want = dict(zip(golden["render_keys"].tolist(),
                    golden["render_digests"].tolist()))
    bad, rates, n = [], {}, 0
    for name in mb.FONTS:
        font = F.truetype(os.path.join(mb.OUT_DIR, name), mb.CANVAS)
        cases = [c for c in mb.render_cases() if c[0] == name]
        t0 = time.perf_counter()
        for _, kind, cp in cases:
            fn = F.draw_single_char if kind == "single" else \
                F.draw_single_char_ascender
            img = fn(chr(cp), font, mb.CANVAS)
            got = "none" if img is None else digest_image(
                img, "L" if img.ndim == 2 else "RGB")
            if got != want[f"{name}|{kind}|{cp}"]:
                bad.append(f"{name} {kind} U+{cp:04X}")
        rates[name] = len(cases) / (time.perf_counter() - t0)
        n += len(cases)
    for name, lang in mb.BANKS:
        b = F.render_adjacent_bank(os.path.join(mb.OUT_DIR, name),
                                   mb.BANK_SIZE, lang)
        if digest_image(b, "L") != str(golden[f"bank|{name}|{lang}"]):
            bad.append(f"bank {name} {lang}")
    if bad or n != len(want):
        raise AssertionError(f"fonts: {len(bad)} of {n} strike / overlap / "
                             f"scaled-offset renders or banks differ from "
                             f"the goldens (of {len(want)}): {bad[:8]}")

    t0 = time.perf_counter()
    sweep = {}
    for name in (mb.STRIKES_FONT, mb.STRIKES_ONLY):
        refused, failed = [], []
        for size in mb.SWEEP:
            try:
                imagefont.truetype(os.path.join(mb.OUT_DIR, name), size)
            except NotImplementedError:
                refused.append(size)
            except OSError as e:
                if "invalid pixel size" not in str(e):
                    raise
                failed.append(size)
        sweep[name] = (refused, failed)
        others = [s for s in mb.SWEEP if s not in mb.REFUSED_SIZES]
        if tuple(refused) != mb.REFUSED_SIZES or failed != (
                others if name == mb.STRIKES_ONLY else []):
            raise AssertionError(f"fonts: {name} refused sizes {refused} and "
                                 f"failed at {failed}; the committed list "
                                 f"is {mb.REFUSED_SIZES}")
    sweep_s = time.perf_counter() - t0

    pages = {}
    mode_golden = np.load(os.path.join(mi.MODE_PAGES_DIR, "golden.npz"))
    t_pages = time.perf_counter()
    for page, (w, proc) in procs.items():
        _, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"fonts: format-dataset over the {page} page "
                                 f"exited {proc.returncode}: {err[-2000:]}")
        for part in ("tree", "crops"):
            if digest_tree(os.path.join(w, part)) != str(
                    mode_golden[f"{page}|{part}"]):
                raise AssertionError(f"fonts: format-dataset over the {page} "
                                     f"page: its {part} differs from the JAX "
                                     "command's golden")
        pages[page] = len(os.listdir(os.path.join(w, "crops")))
    pages_s = time.perf_counter() - t_pages
    log(f"fonts: bitmap strikes, overlap flags, scaled offsets: {n} renders "
        f"(the en characters at canvas {mb.CANVAS}, both draw functions, in "
        f"{', '.join(mb.FONTS)}) and their en / jp banks equal Pillow 12.1's "
        f"golden digests bit for bit; host renders/s "
        + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
        + f"; sizes {mb.SWEEP.start}-{mb.SWEEP.stop - 1} swept in "
        f"{sweep_s:.2f} s: refused {sweep[mb.STRIKES_FONT][0]} (the "
        f"committed list), the strikes-only font 'invalid pixel size' at "
        f"the {len(sweep[mb.STRIKES_ONLY][1])} others; format-dataset "
        f"--spaces --clip_to_top_and_bottom over the "
        + ", ".join(f"{p} page ({k} crops)" for p, k in pages.items())
        + f" equals the JAX command's tree and crops (this phase waited "
        f"{pages_s:.1f} s for them and their digests) ({card})")
    return {"renders": n, "renders_per_s": rates, "sweep_s": sweep_s,
            "refused_sizes": sweep[mb.STRIKES_FONT][0],
            "mode_page_crops": pages, "mode_pages_s": pages_s}


def phase_fonts(dev, card, pipeline, mode_pages):
    """The port's own glyph renderer where neither Pillow nor FreeType is
    used:
    1. ``draw_single_char`` (canvas 256) and ``draw_single_char_ascender``
       of the 90 en characters in the three committed DejaVu fonts, and
       both AddAdjacentChars banks, equal the JAX package's (Pillow 12.1)
       golden digests bit for bit; renders/s on the host; then the CFF
       fixtures (``phase_fonts_cff``), the strike, overlap and
       scaled-offset fixtures and the mode pages (``phase_fonts_bitmap``)
       and, from the background process, the jp chain on the CID font
       against its goldens;
    2. ``make-corpus`` (512 en lines, noise 8, blur 1), ``make-charset
       --dedupe_renders`` and ``format-dataset`` through ``python -m
       effocr_torch`` (``pipeline``: start_font_pipeline's process, run
       in the background from the family phases on): the corpus JSON,
       charset file, line pixels, crops and the whole recognizer tree
       equal the JAX commands' goldens;
    3. ``train-recognizer --device cuda --adjacent_font_path`` (the en
       recipe's widths, 1 epoch) on that tree, by the same background
       process after ``coco-split``: steps/s, images/s, val p@1 (taken
       beside the family phases' device work);
    4. one ``apply_augment`` batch with the bank on the card against the
       same batch on the CPU, from the same draws: bit for bit with the
       composite alone (every other stage's mask off), and the full stack
       within its float32 error, logged."""
    from effocr_torch.data import fonts as F
    from effocr_torch.data.imaging import digest_image
    from effocr_torch.data.transforms import apply_augment, draw_augment

    mf = font_tools()
    golden = np.load(os.path.join(FONT_FIXTURES, "golden.npz"))
    want = dict(zip(golden["render_keys"].tolist(),
                    golden["render_digests"].tolist()))
    t0 = time.perf_counter()
    n = 0
    bad = []
    for fp in mf.font_files(FONT_FIXTURES):
        font = F.truetype(fp, mf.CANVAS)
        name = os.path.basename(fp)
        for c in mf.en_chars():
            for kind, fn in (("single", F.draw_single_char),
                             ("ascender", F.draw_single_char_ascender)):
                img = fn(c, font, mf.CANVAS)
                got = "none" if img is None else digest_image(
                    img, "L" if img.ndim == 2 else "RGB")
                n += 1
                if got != want[f"{name}|{kind}|{ord(c)}"]:
                    bad.append(f"{name} {kind} {c!r}")
    render_s = time.perf_counter() - t0
    if bad or n != len(want):
        raise AssertionError(f"fonts: {len(bad)} of {n} renders differ from "
                             f"the goldens (of {len(want)}): {bad[:8]}")
    serif = os.path.join(FONT_FIXTURES, mf.BANK_FONT)
    t0 = time.perf_counter()
    banks = {lang: F.render_adjacent_bank(serif, mf.BANK_SIZE, lang)
             for lang in ("en", "jp")}
    bank_s = time.perf_counter() - t0
    for lang, b in banks.items():
        if digest_image(b, "L") != str(golden[f"bank_{lang}"]):
            raise AssertionError(f"fonts: the {lang} bank differs from its "
                                 "golden")
    log(f"fonts: {n} renders (draw_single_char and "
        f"draw_single_char_ascender of {len(mf.en_chars())} en characters "
        f"at canvas {mf.CANVAS} in {len(mf.FONTS)} DejaVu fonts) and the en "
        f"{tuple(banks['en'].shape)} / jp {tuple(banks['jp'].shape)} banks "
        f"equal Pillow 12.1's golden digests bit for bit; host "
        f"{n / render_s:.1f} renders/s (first renders of each size "
        f"included), banks {bank_s:.2f} s ({card})")

    cff = phase_fonts_cff(card)
    bitmap = phase_fonts_bitmap(card, mode_pages)

    proc, work, _ = pipeline
    t0 = time.perf_counter()
    stdout, stderr = proc.communicate(timeout=900)
    waited = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"fonts: the pipeline exited {proc.returncode}:"
                             f" {stderr[-3000:]}")
    done = json.loads(stdout.strip().splitlines()[-1])
    res, walls = done["digests"], done["walls"]
    diff = [k for k, v in res.items() if v != str(golden[k])]
    if diff:
        raise AssertionError(f"fonts: {diff} differ from the JAX commands' "
                             "goldens")
    cff_golden = np.load(os.path.join(CFF_FIXTURES, "golden.npz"))
    diff = [k for k, v in done["cff_digests"].items()
            if v != str(cff_golden[k])]
    if diff:
        raise AssertionError(f"fonts: the CID font's jp chain: {diff} differ "
                             "from the JAX commands' goldens")
    cw = done["cff_walls"]
    n_cff_tree = sum(len(fs) for _, _, fs in os.walk(
        os.path.join(work, "cff", "tree")))
    log(f"fonts: the jp chain on the CID-keyed CFF font (make-corpus "
        f"{cw['make-corpus']:.1f} s, make-charset --dedupe_renders "
        f"{cw['make-charset']:.1f} s, format-dataset "
        f"{cw['format-dataset']:.1f} s; {done['cff_seconds']:.1f} s with "
        f"the digests, in the background): corpus.json, the charset file, "
        f"the line pixels, the crops and the {n_cff_tree}-file tree equal "
        f"the JAX commands' goldens")
    tree = os.path.join(work, "tree")
    n_tree = sum(len(fs) for _, _, fs in os.walk(tree))
    log(f"fonts: make-corpus (512 lines) {walls['make-corpus']:.1f} s, "
        f"make-charset --dedupe_renders {walls['make-charset']:.1f} s, "
        f"format-dataset {walls['format-dataset']:.1f} s (process walls; "
        f"{done['seconds']:.1f} s with the digests; the whole process, "
        f"training below included, {done['total_s']:.1f} s in the "
        f"background from the family phases on; this phase waited "
        f"{waited:.1f} s for it); "
        f"corpus.json, the charset file, the line pixels, the crops and "
        f"the {n_tree}-file tree equal the JAX commands' goldens")

    run_dir = os.path.join(work, "rec")
    wall = walls["train-recognizer"]
    steps_s, images_s, val, losses, epochs = _metrics_rates(run_dir)
    if not losses or not all(np.isfinite(v) for _, v in losses):
        raise AssertionError(f"fonts: train-recognizer losses {losses}")
    log(f"fonts: train-recognizer --device cuda --adjacent_font_path "
        f"{mf.BANK_FONT} on the rendered tree (after coco-split; in the "
        f"background, beside the family phases) exited 0 in {wall:.1f} s "
        f"(process wall): 1 epoch of {int(epochs[-1]['epoch/steps'])} "
        f"steps, {steps_s:.2f} optimizer steps/s = {images_s:.1f} images/s "
        f"(first epoch, warm-up included); val p@1 by eval {val}; losses "
        f"{losses} ({card})")

    rng = np.random.default_rng(SEED + 14)
    size = mf.BANK_SIZE
    x = rng.integers(0, 256, (N_AUG_BATCH, size, size, 3), np.uint8)
    x[:, :, : size // 3] = 255
    x = torch.from_numpy(x)
    paired = torch.from_numpy(rng.uniform(size=N_AUG_BATCH) < 0.3)
    bank = torch.from_numpy(banks["en"])
    draws = draw_augment(torch.Generator().manual_seed(SEED + 14),
                         N_AUG_BATCH, size, lang="en", paired_jitter=0.1,
                         adjacent=tuple(bank.shape[:2]))
    alone = {k: (torch.zeros_like(v) if k.endswith("_apply") else v)
             for k, v in draws.items()}
    errs = {}
    for tag, d in (("composite", alone), ("full", draws)):
        kw = dict(lang="en", paired_jitter=0.1, out_channels=3)
        cpu = apply_augment(x, paired, d, adjacent_bank=bank, **kw)
        gpu = apply_augment(x.to(dev), paired.to(dev),
                            {k: v.to(dev) for k, v in d.items()},
                            adjacent_bank=bank.to(dev), **kw).cpu()
        errs[tag] = float((gpu - cpu).abs().max())
    active = int((draws["adj_n"] > 0).sum())
    if errs["composite"] != 0.0:
        raise AssertionError(f"fonts: the bank composite differs on the card "
                             f"by {errs['composite']}")
    log(f"fonts: apply_augment with the en bank, {N_AUG_BATCH} x {size}^2 "
        f"({active} samples with neighbours): the composite alone equals "
        f"the CPU's bit for bit on the card; the full stack within "
        f"{errs['full']:.3g} of the CPU (float32)")
    return dict(k1_launches=0, k2_launches=0, n_renders=n,
                renders_s=n / render_s, walls=walls,
                pipeline_s=done["seconds"], background_s=done["total_s"],
                pipeline_wait_s=waited,
                train_wall_s=wall,
                steps_s=steps_s, images_s=images_s, val_p1=val,
                losses=losses, augment_err=errs, n_tree_files=n_tree,
                cff=dict(cff, jp_chain_s=done["cff_seconds"],
                         jp_chain_walls=done["cff_walls"],
                         n_tree_files=n_cff_tree),
                bitmap=bitmap)


def main(argv) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="chip_smoke.py")
    p.add_argument("--profile", action="store_true",
                   help="add a torch.profiler split of one chunk per slice")
    p.add_argument("--out", default=WORK,
                   help="directory for chip_smoke.json (and the profiler "
                        "tables)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    os.makedirs(WORK, exist_ok=True)
    os.makedirs(args.out, exist_ok=True)
    card = card_line()
    dev = torch.device("cuda")
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}"
        f"; {torch.cuda.get_device_name(0)}")
    use_full_f32()
    log("precision: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")

    # every library built at once, one compiler process each
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=5) as pool:
        builds = [pool.submit(native.build), pool.submit(imgdec.build),
                  pool.submit(glyph.build), pool.submit(cuda_nms.build),
                  pool.submit(cuda_top1.build)]
        libs = [f.result() for f in builds]
    log(f"build: {libs} in {time.perf_counter() - t0:.1f} s")
    background = []
    try:
        return _main_phases(args, card, dev, t_start, background)
    finally:
        for proc, *_ in background:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _main_phases(args, card, dev, t_start, background) -> int:
    for name in ("nms", "top1"):
        with open(os.path.join(BUILD_DIR, f"{name}_ptxas.txt")) as f:
            ptxas = [ln.strip() for ln in f
                     if "registers" in ln or "smem" in ln or "spill" in ln]
        log(f"build: ptxas {name}: " + " | ".join(ptxas))

    k1 = phase_k1(dev)
    k1_sweep = phase_k1_sweep(dev)
    k2 = phase_k2(dev)
    t0 = time.perf_counter()
    sl = phase_slice(dev, card, args.out, profile=args.profile)
    log(f"phase en: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    jp = phase_jp(dev, card, args.out, profile=args.profile)
    log(f"phase jp: {time.perf_counter() - t0:.1f} s")
    # the other single-card paths, each with its own launch counts
    t_more = time.perf_counter()
    en_loc, en_rec = sl["loc_dir"], sl["rec_dir"]
    more = {}
    for name, run_phase in (
        ("square", lambda: phase_square(dev, card, sl["paths"], en_rec,
                                        args.out, profile=args.profile)),
        ("original", lambda: phase_original(dev, card, jp["paths"],
                                            jp["loc_dir"], jp["rec_dir"])),
        ("tiling", lambda: phase_tiling(dev, card, en_loc, en_rec)),
        ("bucket", lambda: phase_bucket(dev, card, sl["paths"], en_loc,
                                        en_rec)),
        ("classifier", lambda: phase_classifier(dev, card, sl["paths"],
                                                en_loc)),
        ("serve", lambda: phase_serve(dev, card, sl["paths"], en_loc,
                                      en_rec)),
    ):
        t0 = time.perf_counter()
        more[name] = run_phase()
        more[name]["phase_s"] = time.perf_counter() - t0
        log(f"phase {name}: {more[name]['phase_s']:.1f} s")
    log(f"the six other paths: {time.perf_counter() - t_more:.1f} s")
    # the training slice: R1's formats, a recognizer trained here, its
    # step on the card against the CPU, the ad-hoc index
    t_train = time.perf_counter()
    train = {}
    t0 = time.perf_counter()
    train["png"] = phase_png(dev, card, en_loc, en_rec)
    train["png"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train["train"] = phase_train(dev, card, sl["paths"], en_loc)
    train["train"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train["train_step_vs_cpu"] = phase_train_step(dev, card,
                                                  train["train"]["tree"])
    train["train_step_vs_cpu"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train["build_index_from"] = phase_build_index_from(
        dev, card, sl["paths"], en_loc, train["train"]["run_dir"],
        train["train"]["tree"])
    train["build_index_from"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train["train_localizer"] = phase_train_localizer(
        dev, card, train["train"]["tree"], train["train"]["run_dir"],
        args.out)
    train["train_localizer"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tl = train["train_localizer"]
    train["loc_step_vs_cpu"] = phase_loc_step(
        dev, card, tl["img_dir"], tl["splits"],
        os.path.join(tl["run_dir"], "model.json"))
    train["loc_step_vs_cpu"]["phase_s"] = time.perf_counter() - t0
    for name, v in train.items():
        log(f"phase {name}: {v['phase_s']:.1f} s")
    log(f"the training phases: {time.perf_counter() - t_train:.1f} s")
    # the other model families: XCiT, FCOS and R-CNN through the en
    # engine, trained here, and one float32 step of each against the CPU
    t_fam = time.perf_counter()
    # the fonts phase's host pipeline (no card) runs from here, beside the
    # device-bound family phases
    background.append(start_font_pipeline())
    mode_pages = start_mode_pages()
    background.extend((proc, w) for w, proc in mode_pages.values())
    dirs = make_family_artifacts(dev, sl["paths"][:16])
    log(f"families: artifacts in {time.perf_counter() - t_fam:.1f} s")
    tl = train["train_localizer"]
    fam_paths = sl["paths"][:N_FAMILY_LINES]
    fam = {}
    for name, run_phase in (
        ("xcit", lambda: phase_family(
            dev, card, "xcit", engine_args(en_loc, dirs[XCIT_ARCH]),
            sl["paths"][:N_XCIT_LINES], args.out, profile=args.profile,
            plain=False)),
        ("fcos", lambda: phase_family(
            dev, card, "fcos", family_engine_args(dirs["fcos_s"], en_rec),
            fam_paths, args.out, profile=args.profile)),
        ("rcnn", lambda: phase_family(
            dev, card, "rcnn", family_engine_args(dirs["rcnn_s"], en_rec),
            fam_paths, args.out, profile=args.profile)),
        ("train_fcos", lambda: phase_train_family(
            dev, card, "fcos_s", tl["img_dir"], tl["splits"])),
        ("train_rcnn", lambda: phase_train_family(
            dev, card, "rcnn_s", tl["img_dir"], tl["splits"])),
        ("train_xcit", lambda: phase_train_xcit(dev, card,
                                                train["train"]["tree"])),
        ("family_steps_vs_cpu", lambda: phase_family_steps(
            dev, card, train["train"]["tree"],
            {"fcos_s": fam["train_fcos"]["run_dir"],
             "rcnn_s": fam["train_rcnn"]["run_dir"]},
            fam["train_xcit"]["run_dir"], tl["img_dir"], tl["splits"])),
    ):
        t0 = time.perf_counter()
        fam[name] = run_phase()
        fam[name]["phase_s"] = time.perf_counter() - t0
        log(f"phase {name}: {fam[name]['phase_s']:.1f} s")
    log(f"the family phases: {time.perf_counter() - t_fam:.1f} s")
    # data parallelism on the one card: engine replicas, DDP training
    t_dp = time.perf_counter()
    par = {}
    for name, run_phase in (
        ("data_parallel", lambda: phase_data_parallel(dev, card, sl, jp)),
        ("ddp_train", lambda: phase_ddp_train(dev, card, train)),
        ("ddp_step_vs_single", lambda: phase_ddp_steps(dev, card, train)),
    ):
        t0 = time.perf_counter()
        par[name] = run_phase()
        par[name]["phase_s"] = time.perf_counter() - t0
        log(f"phase {name}: {par[name]['phase_s']:.1f} s")
    log(f"the data-parallel phases: {time.perf_counter() - t_dp:.1f} s")
    # artifacts in and out: the reference's formats, export, import-encoder
    t_io = time.perf_counter()
    interop = {}
    for name, run_phase in (
        ("interop_jp", lambda: phase_interop_jp(dev, card, jp)),
        ("interop_en", lambda: phase_interop_en(dev, card, sl)),
        ("export", lambda: phase_export(dev, card, jp["rec_dir"])),
        ("import_encoder", lambda: phase_import_encoder(dev, card, jp,
                                                        train)),
    ):
        t0 = time.perf_counter()
        interop[name] = run_phase()
        interop[name]["phase_s"] = time.perf_counter() - t0
        log(f"phase {name}: {interop[name]['phase_s']:.1f} s")
    log(f"the interop phases: {time.perf_counter() - t_io:.1f} s")
    # the tools (infer's overlays and comparators, error-analysis, viz,
    # device_trace), the seq2seq baseline trained here and the TrOCR
    # import at trocr-base's widths
    t_tools = time.perf_counter()
    tools = {}
    for name, run_phase in (
        ("tools", lambda: phase_tools(dev, card, sl, train)),
        ("seq2seq", lambda: phase_seq2seq(dev, card,
                                          train["train_localizer"])),
        ("trocr", lambda: phase_trocr(dev, card, train["train_localizer"])),
        ("image_formats", lambda: phase_image_formats(dev, card, en_loc,
                                                      en_rec)),
        ("fonts", lambda: phase_fonts(dev, card, background[0],
                                      mode_pages)),
    ):
        t0 = time.perf_counter()
        tools[name] = run_phase()
        tools[name]["phase_s"] = time.perf_counter() - t0
        log(f"phase {name}: {tools[name]['phase_s']:.1f} s")
    log(f"the tools, seq2seq, trocr, image_formats and fonts phases: "
        f"{time.perf_counter() - t_tools:.1f} s")
    launched = {k: v for k, v in {**more, **train, **fam, **par,
                                  **interop, **tools}.items()
                if "k1_launches" in v}
    k1_by_path = {"en": sl["k1_launches"], "jp": jp["k1_launches"],
                  **{k: v["k1_launches"] for k, v in launched.items()}}
    k2_by_path = {"en": sl["k2_launches"], "jp": jp["k2_launches"],
                  **{k: v["k2_launches"] for k, v in launched.items()}}

    main_row = sl["k1_main"]
    err = max(r["max_abs_err"] for r in list(k1.values())
              + [main_row, jp["k1_main"], fam["rcnn"]["k1_rpn"]])
    k2_main = jp["k2_main"]
    k2_err = max([r["max_abs_err"] for r in list(k2.values()) + [k2_main]]
                 + [v["k2_max_err"] for v in list(more.values())
                    + [par["data_parallel"]] if "k2_max_err" in v])
    kernels = [{
        "name": "nms_keep_mask",
        "route": "cuda",
        "source": "effocr_torch/csrc/nms.cu",
        "replaces": "effocr_tpu/kernels/pallas_nms.py:51",
        "launches": sum(k1_by_path.values()),
        "launches_by_path": k1_by_path,
        "max_abs_err": err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "library_note": "no PyTorch call computes greedy NMS "
                        "(torchvision is not installed and is not a torch op)",
        "synthetic_512x1024": k1["synthetic_512x1024"],
        "jp_main_path": jp["k1_main"],
        "train_localizer_eval": train["train_localizer"]["k1_eval"],
        "rcnn_rpn_main_path": fam["rcnn"]["k1_rpn"],
        "calls_by_iou": {k: fam[k]["k1_calls_by_iou"]
                         for k in ("fcos", "rcnn", "train_fcos",
                                   "train_rcnn")},
        "data_parallel_by_run": {k: par["data_parallel"][k]["k1_launches"]
                                 for k in ("en", "spill", "jp")},
    }, {
        "name": "top1_retrieval",
        "route": "cuda",
        "source": "effocr_torch/csrc/top1.cu",
        "replaces": "effocr_tpu/kernels/pallas_retrieval.py:28",
        "launches": sum(k2_by_path.values()),
        "launches_by_path": k2_by_path,
        "max_abs_err": k2_err,
        "ms": k2_main["ms"],
        "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"],
        "bound_by": k2_main["bound_by"],
        "library_ms": k2_main["library_ms"],
        "library_note": "torch.matmul + mask + argmax on the same tensors",
        "synthetic_4096x11051": k2["synthetic_4096x11051"],
        "jp_main_path": k2_main,
        "data_parallel_by_run": {
            "jp": par["data_parallel"]["jp"]["k2_launches"],
            "knn_topk_sharded": par["data_parallel"]["knn_sharded"][
                "k2_launches"]},
        "knn_topk_sharded_2x": par["data_parallel"]["knn_sharded"],
    }]
    summary = dict(card=card,
                   en={k: v for k, v in sl.items()
                       if k not in ("k1_main", "paths")},
                   jp={k: v for k, v in jp.items()
                       if k not in ("k1_main", "k2_main", "paths")},
                   other_paths=more, training=train, families=fam,
                   data_parallel=par, interop=interop, tools=tools,
                   kernels=kernels, k1_sweep=k1_sweep,
                   total_s=time.perf_counter() - t_start)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)
    log(f"total: {summary['total_s']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
