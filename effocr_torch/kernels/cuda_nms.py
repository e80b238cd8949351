"""Greedy-NMS keep mask on Hopper: the wrapper of csrc/nms.cu.

Replaces the TPU kernel effocr_tpu/kernels/pallas_nms.py
(``pallas_nms_mask``).  The CUDA source is compiled with nvcc for sm_90a
into a shared library with a plain C interface on first use
(kernels/cuda_build.py, git-ignored ``csrc/build/``) and called through
ctypes on PyTorch's current stream.  Each call allocates the kernel's
triangular suppression mask as a scratch tensor (``scratch_words``; 36
MB at B = 512, N = 1024); the helpers below give its geometry, which the
CPU tests emulate.

``nms_keep`` is the entry the pipeline calls: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version,
kernels/nms.py ``nms_mask(presorted=True)``.  There is no fallback from
one to the other.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np
import torch

from effocr_torch.kernels.cuda_build import build_library
from effocr_torch.kernels.nms import nms_mask

# Largest N (boxes per image) the kernel takes: the scan keeps two
# N/64-word bitsets per image in shared memory, 4 images per CTA, which
# at N = 32,768 is 34 KB, under the 48 KB a launch gets without opting in.
MAX_N = 32768


def mask_words(n: int) -> int:
    """64-box blocks of an image of n boxes (W)."""
    return (n + 63) // 64


def mask_items(n: int) -> int:
    """Items (r, w), r <= w < W, of the triangular mask: W (W + 1) / 2,
    row-major by r, each one 64-bit word per row 64 r + b, b < 64."""
    w = mask_words(n)
    return w * (w + 1) // 2


def scratch_words(b: int, n: int) -> int:
    """64-bit words of scratch a launch needs: the masks of b images, then
    each image's per-block valid bits."""
    return b * mask_items(n) * 64 + b * mask_words(n)


def fast_test_bounds(iou_thresh: float) -> Tuple[float, float, bool]:
    """(lo, hi, fast) of the kernel's division-free IoU test: the float32
    threshold moved down and up by 2^-17 of itself, rounded to float32
    (so at least 2^-18 away), and whether the test applies (2^-60 <= thr
    <= 4, where neither lo * d nor hi * d under- or overflows for the
    kernel's d = union + 1e-7 in [1e-7, 1e30)).  csrc/nms.cu proves the
    test exact."""
    t = float(np.float32(iou_thresh))
    lo = float(np.float32(t * (1.0 - 2.0 ** -17)))
    hi = float(np.float32(t * (1.0 + 2.0 ** -17)))
    return lo, hi, 2.0 ** -60 <= t <= 4.0


def build() -> str:
    """Compile csrc/nms.cu (no FMA contraction: the keep mask is
    bit-identical to the plain version) unless an up-to-date library
    exists; returns the library path."""
    return build_library("nms.cu", "nms", ["-fmad=false"])


class NmsKernel:
    """The loaded kernel library and its launch count.

    ``launches`` rises by one per call that launches the kernel (its
    build and scan passes) and nowhere else, so a run can show that its
    NMS went through the kernel."""

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()

    def _load(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(build())
                lib.nms_mask_launch.argtypes = (
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                    + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
                lib.nms_mask_launch.restype = ctypes.c_int
                lib.nms_error_string.argtypes = [ctypes.c_int]
                lib.nms_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def __call__(self, boxes: torch.Tensor, valid: torch.Tensor,
                 iou_thresh: float) -> torch.Tensor:
        """Keep mask [B, N] bool for presorted boxes [B, N, 4] float32 and
        valid [B, N] bool, both contiguous on one CUDA device, N <=
        MAX_N."""
        if not (boxes.is_cuda and valid.is_cuda
                and boxes.device == valid.device):
            raise ValueError("the CUDA NMS kernel needs boxes and valid on "
                             f"one CUDA device, got {boxes.device} and "
                             f"{valid.device}")
        if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
            raise TypeError(f"need float32 boxes and bool valid, got "
                            f"{boxes.dtype} and {valid.dtype}")
        if (boxes.dim() != 3 or boxes.shape[2] != 4
                or valid.shape != boxes.shape[:2]):
            raise ValueError(f"need boxes [B, N, 4] and valid [B, N], got "
                             f"{tuple(boxes.shape)} and {tuple(valid.shape)}")
        if not (boxes.is_contiguous() and valid.is_contiguous()
                and boxes.data_ptr() % 16 == 0):
            raise ValueError("boxes and valid must be contiguous (boxes "
                             "16-byte aligned)")
        b, n = valid.shape
        if n > MAX_N:
            raise ValueError(f"N = {n} boxes per image is over the kernel's "
                             f"{MAX_N} (its scan keeps two N/64-word bitsets "
                             "per image in shared memory)")
        lib = self._load()
        keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
        scratch = torch.empty((scratch_words(b, n),), dtype=torch.int64,
                              device=boxes.device)
        lo, hi, fast = fast_test_bounds(iou_thresh)
        with torch.cuda.device(boxes.device):
            stream = torch.cuda.current_stream(boxes.device).cuda_stream
            err = lib.nms_mask_launch(boxes.data_ptr(), valid.data_ptr(),
                                      keep.data_ptr(), scratch.data_ptr(), b,
                                      n, float(iou_thresh), lo, hi, int(fast),
                                      stream)
        if err != 0:
            raise RuntimeError("NMS kernel launch failed: "
                               + lib.nms_error_string(err).decode())
        self.launches += 1
        return keep


nms_kernel = NmsKernel()


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor,
             iou_thresh: float) -> torch.Tensor:
    """Greedy-NMS keep mask [B, N] for presorted, class-offset boxes: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if boxes.is_cuda:
        return nms_kernel(boxes.contiguous(), valid.contiguous(), iou_thresh)
    return nms_mask(boxes, None, valid, iou_thresh, presorted=True)
