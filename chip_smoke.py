"""Drive effocr_torch's main paths on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py [--profile] [--out DIR]

Phases (any failure exits non-zero; nothing is caught and reported ok):

1. setup: the card's name and power limit, torch/CUDA versions; build the
   native preprocessing library and the two CUDA kernel libraries (NMS,
   top-1 retrieval) in parallel.
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
   2048 synthetic gray line PNGs, and ``load_engine`` with
   BENCH_TRAINED.json's flags (paths swapped) run twice; the second run is
   timed.  K1's launch count is read around the timed run.  The kernel is
   then held against the plain version on the NMS inputs the main path
   produced, the engine's output with the kernel NMS against the same
   engine with plain-torch NMS, and both models in float32 on the card
   against the CPU.
5. Japanese vertical slice: yolov5n with the loc_vert model.json,
   convnext_atto with the rec_knn6k3 model.json, 11,051 random unit
   prototypes with rec_knn6k3's ref.txt, 600 synthetic RGB vertical line
   PNGs, and ``load_engine`` with the jp_v3 benchmark's flags (paths
   swapped, plus ``--nms_kernel pallas``) run twice; the second run is
   timed, with K1's and K2's launch counts read around it.  K1 and K2 are
   then held against their plain versions on the inputs this path gave
   them, the engine's text against the same engine with top1_plain
   (identical apart from crop slots whose plain top-2 margin is <= 1e-5),
   and both models in float32 on the card against the CPU.
6. The other single-card paths, each run twice (the second run timed,
   with K1's and K2's launch counts read around it); in the first run
   every K1 keep mask is held bit for bit against nms_mask and every K2
   result against top1_plain (margin rule); afterwards the engine's text
   against the same engine with plain NMS and top1_plain:
   - square: the en models on the square 640 x 640 canvas (a localizer
     model.json with no input_height) and crop_window 256, so crops take
     the general 2-D ROI window; 512 lines, both kernels;
   - original: ``--crop_source original`` on the jp artifacts with the
     jp_v3 flags; 240 RGB vertical lines;
   - tiling: BENCH_TRAINED.json's flags + ``--tile_min_h 24`` on 64 gray
     lines 6,000-8,000 px wide;
   - bucket: the en engine with transfer "bucket", bucket_hw (64, 1024),
     on 512 lines, most of them larger than the bucket;
   - classifier: mobilenetv3_small_050 + a 90-class head and a
     class_map.json from the en ref.txt; 256 lines;
   - serve: ``python -m effocr_torch serve --stdin --device cuda
     --spell_check`` in a subprocess, fed 200 paths; its answers must
     equal ``engine.run`` with the same flags over the batches the server
     logged, run in-process once with every K1 keep mask held bit for bit
     against nms_mask and once on plain NMS.
7. a ``kernels`` JSON line (launches per path under
   ``launches_by_path``), then ``{"ok": true, "device": ...}`` last.

``--profile`` adds a torch.profiler run over one chunk of the en, jp and
square paths: device time per engine stage and per kernel, and the device
busy share.

Needs a CUDA device, nvcc (sm_90a) and g++.  Writes its artifacts,
line images and results under build/chip_smoke/ in the checkout (the
results to ``--out DIR`` when given).
"""

from __future__ import annotations

import contextlib
import json
import os
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
from effocr_torch.core.device import use_full_f32
from effocr_torch.interop.flax_bridge import state_dict_to_flax
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
from effocr_torch.retrieval.index import PrototypeIndex

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
R5 = os.path.join(ROOT, "bench_results", "r5", "runs")
N_LINES = 2048
N_JP_LINES = 600     # the size of the jp_v3 benchmark's eval split
SEED = 0
# detect-head bias offsets per scale, by output channel (4 = obj, 5 =
# class 0 "char", 6 = class 1 "word"), added after the heads are scaled to
# unit output spread: char candidates come from the stride-8 scale (the
# objectness offset sets how many pass conf_thresh), word candidates from
# the stride-32 one, none from stride 16
DETECT_BIAS = {0: {4: -1.2, 5: 4.0, 6: -4.0},
               1: {4: -6.0},
               2: {4: 0.0, 5: -4.0, 6: 4.0}}
# the same for the jp vertical detector: char candidates from the stride-8
# scale only (jp decodes no word boxes); the objectness offset is set for
# ~30 chars per synthetic line after NMS at IoU 0.01, under the 34 crop
# slots per line of crop_batch 4096 / line_batch 120
JP_DETECT_BIAS = {0: {4: -2.6, 5: 4.0, 6: -4.0},
                  1: {4: -6.0},
                  2: {4: -6.0}}
# the en detector on the square 640 x 640 canvas: 20 x 20 stride-32 cells
# (not 3 x 32) would fill max_nms with word candidates at DETECT_BIAS, so
# their objectness drops; set for ~32 chars and ~16 words per line after
# NMS on 16 synthetic lines
SQUARE_DETECT_BIAS = {0: {4: -1.75, 5: 4.0, 6: -4.0},
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
    protos = np.random.default_rng(SEED + 2).normal(size=(len(chars), 1024))
    PrototypeIndex(protos.astype(np.float32), chars).save(rec_dir)
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


def engine_args(loc_dir, rec_dir, *extra):
    import argparse

    with open(os.path.join(ROOT, "BENCH_TRAINED.json")) as f:
        flags = json.load(f)["flags"]
    swap = {"--localizer_dir": loc_dir, "--recognizer_dir": rec_dir}
    flags = [swap.get(flags[i - 1], f) if i else f
             for i, f in enumerate(flags)]
    p = argparse.ArgumentParser()
    add_engine_args(p)
    return p.parse_args(flags + list(extra))   # --device: cuda by default


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
    log(f"slice: artifacts + {len(paths)} line PNGs written in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = load_engine(engine_args(loc_dir, rec_dir))
    c = engine.config
    log(f"slice: line_batch {c.line_batch} crop_batch {c.crop_batch} "
        f"encoder_sub_batch {c.encoder_sub_batch} max_det "
        f"{c.localizer.max_det} max_nms {c.localizer.max_nms} nms_kernel "
        f"{c.nms_kernel} (-> {engine._nms_kernel}) out_quant {c.out_quant} "
        f"transfer_bits {c.transfer_bits} canvas {c.localizer.input_size}x"
        f"{c.localizer.input_height} tiers [{c.adaptive_height_floor}, "
        f"{c.adaptive_height_cap}]")

    # warm-up run: capture the first NMS input the main path hands K1
    captured = {}
    kernel = cuda_nms.nms_kernel

    def capture(boxes, valid, thr):
        if not captured:
            captured.update(boxes=boxes.clone(), valid=valid.clone(),
                            thr=thr)
        return kernel(boxes, valid, thr)

    cuda_nms.nms_kernel = capture
    t0 = time.perf_counter()
    try:
        res0, coco = engine.run(paths, return_coco=True)
    finally:
        cuda_nms.nms_kernel = kernel
    torch.cuda.synchronize()
    log(f"slice: warm-up run {time.perf_counter() - t0:.2f} s")
    n_chars = [len(im_chars) for im_chars in _chars_per_line(coco)]
    mean_chars = float(np.mean(n_chars))

    run = timed_run(engine, paths, res0, "slice")
    results = run["results"]
    if run["k1_launches"] == 0:
        raise AssertionError("the main path launched the NMS kernel 0 times")
    log(f"slice: {len(paths)} lines in {run['wall']:.3f} s = "
        f"{run['lines_s']:.1f} lines/s ({card}); mean chars/line "
        f"{mean_chars:.1f} (min {min(n_chars)}, max {max(n_chars)}); "
        f"{run['dispatches']} dispatches for {run['chunks']} chunks; NMS "
        f"kernel launches {run['k1_launches']}, top-1 kernel launches "
        f"{run['k2_launches']} (not on this path); peak device memory "
        f"{run['peak_gib']:.2f} GiB")
    example = paths[0]
    log(f"slice: example result {os.path.basename(example)} -> "
        f"{results[example][:60]!r}")

    # the kernel on the inputs the main path gave it
    k1_main = k1_case("main-path input", captured["boxes"],
                      captured["valid"], captured["thr"], timed=True)

    # the same engine with plain-torch NMS must decode identically (one
    # chunk: chunk composition sets the canvas tiers)
    sub = paths[:c.line_batch]
    plain_engine = load_engine(engine_args(loc_dir, rec_dir,
                                           "--nms_kernel", "xla"))
    if plain_engine.run(sub) != engine.run(sub):
        raise AssertionError("kernel-NMS and plain-NMS engines differ")
    log(f"slice: {len(sub)} lines decode identically with plain-torch NMS")
    models_vs_cpu(engine, paths[:2])
    if profile:
        profile_run(engine, paths[:c.line_batch], card, out_dir, "en")
    return dict(lines_s=run["lines_s"], wall=run["wall"],
                launches=run["k1_launches"], k2_launches=run["k2_launches"],
                peak_gib=run["peak_gib"], mean_chars=mean_chars,
                n_lines=len(paths),
                spilled=run["dispatches"] - run["chunks"], k1_main=k1_main,
                paths=paths, loc_dir=loc_dir, rec_dir=rec_dir)


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
    protos = np.random.default_rng(SEED + 14).normal(size=(len(chars), 320))
    PrototypeIndex(protos.astype(np.float32), chars).save(rec_dir)
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

    # warm-up run: K2 checked against top1_plain on every chunk, the first
    # NMS and top-1 inputs of the path kept
    nms_captured = {}
    nms = cuda_nms.nms_kernel
    top1 = cuda_top1.top1_kernel
    check = Top1Check(top1)

    def capture(boxes, valid, thr):
        if not nms_captured:
            nms_captured.update(boxes=boxes.clone(), valid=valid.clone(),
                                thr=thr)
        return nms(boxes, valid, thr)

    cuda_nms.nms_kernel, cuda_top1.top1_kernel = capture, check
    t0 = time.perf_counter()
    try:
        res0, coco = engine.run(paths, return_coco=True)
    finally:
        cuda_nms.nms_kernel, cuda_top1.top1_kernel = nms, top1
    torch.cuda.synchronize()
    log(f"jp: warm-up run {time.perf_counter() - t0:.2f} s; K2 held "
        f"against top1_plain on {check.calls} chunks, {check.slots} crop "
        f"slots: index differs at {check.differs}, all within the "
        f"{check.low_margin} slots whose plain top-2 margin is <= {K2_TOL}; "
        f"max|score diff| {check.max_err:.3g}")
    if check.calls == 0:
        raise AssertionError("the jp path never reached the top-1 kernel")
    n_chars = [len(im_chars) for im_chars in _chars_per_line(coco)]
    mean_chars = float(np.mean(n_chars))

    run = timed_run(engine, paths, res0, "jp")
    results = run["results"]
    k1_launches, k2_launches = run["k1_launches"], run["k2_launches"]
    if k1_launches == 0 or k2_launches == 0:
        raise AssertionError(f"the jp path launched K1 {k1_launches} and K2 "
                             f"{k2_launches} times")
    spilled = run["dispatches"] - run["chunks"]
    log(f"jp: {len(paths)} lines in {run['wall']:.3f} s = "
        f"{run['lines_s']:.1f} lines/s ({card}); mean chars/line "
        f"{mean_chars:.1f} (min {min(n_chars)}, max {max(n_chars)}); "
        f"{run['dispatches']} dispatches for {run['chunks']} chunks "
        f"({spilled} spilled past crop_batch); K1 launches {k1_launches}, "
        f"K2 launches {k2_launches}; peak device memory "
        f"{run['peak_gib']:.2f} GiB")
    example = paths[0]
    log(f"jp: example result {os.path.basename(example)} -> "
        f"{results[example][:30]!r}")

    # the kernels on the inputs this path gave them
    k1_main = k1_case("jp main-path input", nms_captured["boxes"],
                      nms_captured["valid"], nms_captured["thr"], timed=True)
    k2_main = k2_case("jp main-path input", *check.first, timed=True)
    k2_main["engine_differs"] = check.differs
    k2_main["engine_low_margin"] = check.low_margin
    k2_main["max_abs_err"] = max(k2_main["max_abs_err"], check.max_err)

    # the same engine with top1_plain: identical text apart from lines
    # holding a slot where the kernel's index differs (low margin only)
    cuda_top1.top1_kernel = top1_plain
    try:
        plain_res = engine.run(paths)
    finally:
        cuda_top1.top1_kernel = top1
    n_diff = sum(plain_res[p] != results[p] for p in paths)
    log(f"jp: {len(paths)} lines with top1_plain: {n_diff} lines differ "
        f"(at most as many as the {check.differs} low-margin slots where "
        "K2's index differed may)")
    if n_diff > check.differs:
        raise AssertionError("top-1 kernel and top1_plain engines differ "
                             "beyond the low-margin slots")
    models_vs_cpu(engine, paths[:2])
    if profile:
        profile_run(engine, paths[:c.line_batch], card, out_dir, "jp")
    return dict(lines_s=run["lines_s"], wall=run["wall"],
                k1_launches=k1_launches, k2_launches=k2_launches,
                peak_gib=run["peak_gib"], mean_chars=mean_chars,
                n_lines=len(paths), spilled=spilled, k1_main=k1_main,
                k2_main=k2_main, plain_lines_differ=n_diff, paths=paths,
                loc_dir=loc_dir, rec_dir=rec_dir)


# ------------------------------------------ the other single-card paths
class NmsCheck:
    """Stands in for cuda_nms.nms_kernel during one run: launches the
    kernel and holds every keep mask bit for bit against nms_mask on the
    same inputs."""

    def __init__(self, kernel, tag):
        self.kernel, self.tag = kernel, tag
        self.calls = self.boxes = 0

    def __call__(self, boxes, valid, thr):
        keep = self.kernel(boxes, valid, thr)
        if not torch.equal(keep, nms_mask(boxes, None, valid, thr,
                                          presorted=True)):
            raise AssertionError(f"K1 on the {self.tag} path: keep mask "
                                 "differs from nms_mask")
        self.calls += 1
        self.boxes += int(valid.sum())
        return keep


@contextlib.contextmanager
def kernels_checked(tag, k2=False):
    """K1 (and K2, when ``k2``) held against the plain versions on every
    call made inside the block; yields the two checks."""
    nms, top1 = cuda_nms.nms_kernel, cuda_top1.top1_kernel
    k1c, k2c = NmsCheck(nms, tag), Top1Check(top1, tag)
    cuda_nms.nms_kernel = k1c
    if k2:
        cuda_top1.top1_kernel = k2c
    try:
        yield k1c, k2c
    finally:
        cuda_nms.nms_kernel, cuda_top1.top1_kernel = nms, top1


@contextlib.contextmanager
def plain_kernels(engine):
    """``engine`` on plain NMS and top1_plain inside the block."""
    saved, top1 = engine._nms_kernel, cuda_top1.top1_kernel
    engine._nms_kernel, cuda_top1.top1_kernel = "plain", top1_plain
    try:
        yield
    finally:
        engine._nms_kernel, cuda_top1.top1_kernel = saved, top1


def checked_runs(engine, paths, tag, k2=False):
    """A warm-up run with K1 (and K2, when the path reaches it) held
    against the plain versions on every call, then the timed run
    (``timed_run``).  Then the same engine with plain NMS and top1_plain:
    its text must be identical apart from lines holding a slot where
    K2's index differed at a low margin."""
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
    with plain_kernels(engine):
        plain = engine.run(paths)
    n_diff = sum(plain[p] != run["results"][p] for p in plain)
    if set(plain) != set(run["results"]) or n_diff > k2c.differs:
        raise AssertionError(f"{tag}: {n_diff} lines differ with plain NMS "
                             f"and top1_plain ({k2c.differs} low-margin "
                             "index differences allow that many)")
    chars = [len(c) for c in _chars_per_line(coco)]
    run.update(mean_chars=float(np.mean(chars)), max_chars=max(chars),
               spilled=run["dispatches"] - run["chunks"],
               k1_checked=k1c.calls, plain_lines_differ=n_diff,
               k2_differs=k2c.differs, k2_low_margin=k2c.low_margin,
               k2_max_err=k2c.max_err, n_lines=len(paths))
    return run


def report(tag, run, card, extra=""):
    log(f"{tag}: {run['n_lines']} lines in {run['wall']:.3f} s = "
        f"{run['lines_s']:.1f} lines/s ({card}); mean chars/line "
        f"{run['mean_chars']:.1f} (max {run['max_chars']}); "
        f"{run['dispatches']} dispatches for {run['chunks']} chunks "
        f"({run['spilled']} spilled); {run['no_words']} lines read None "
        f"(chars, no word box); K1 launches {run['k1_launches']}, K2 "
        f"launches {run['k2_launches']}; {run['plain_lines_differ']} lines "
        f"differ with plain NMS + top1_plain; peak device memory "
        f"{run['peak_gib']:.2f} GiB{extra}")
    return {k: v for k, v in run.items() if k != "results"}


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


N_WIDE = 64


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


N_SERVE = 200
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
    kernels = [e for e in dev_events if not e.key.startswith("ocr/")]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile {tag}: one chunk of {len(paths)} lines ({card}); wall "
        f"{wall_ms:.1f} ms (profiler on), device kernel time "
        f"{kernel_ms:.1f} ms in {sum(e.count for e in kernels)} kernel "
        f"launches, busy share {kernel_ms / wall_ms:.3f}")
    spans = {e.key: e.device_time_total / 1e3 for e in dev_events
             if e.key.startswith("ocr/")}
    for e in sorted((e for e in events if e.key.startswith("ocr/")
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


# --------------------------------------------------------------- main
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
    with ThreadPoolExecutor(max_workers=3) as pool:
        builds = [pool.submit(native.build), pool.submit(cuda_nms.build),
                  pool.submit(cuda_top1.build)]
        libs = [f.result() for f in builds]
    log(f"build: {libs} in {time.perf_counter() - t0:.1f} s")
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
    k1_by_path = {"en": sl["launches"], "jp": jp["k1_launches"],
                  **{k: v["k1_launches"] for k, v in more.items()}}
    k2_by_path = {"en": sl["k2_launches"], "jp": jp["k2_launches"],
                  **{k: v["k2_launches"] for k, v in more.items()}}

    main_row = sl["k1_main"]
    err = max(r["max_abs_err"] for r in list(k1.values())
              + [main_row, jp["k1_main"]])
    k2_main = jp["k2_main"]
    k2_err = max([r["max_abs_err"] for r in list(k2.values()) + [k2_main]]
                 + [v["k2_max_err"] for v in more.values()
                    if "k2_max_err" in v])
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
    }]
    summary = dict(card=card, lines_per_s=sl["lines_s"],
                   timed_wall_s=sl["wall"], n_lines=sl["n_lines"],
                   mean_chars_per_line=sl["mean_chars"],
                   peak_device_gib=sl["peak_gib"], spilled=sl["spilled"],
                   jp={k: v for k, v in jp.items()
                       if k not in ("k1_main", "k2_main", "paths")},
                   other_paths=more,
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
