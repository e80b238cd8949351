"""Greedy-NMS keep mask on Hopper: the wrapper of csrc/nms.cu.

Replaces the TPU kernel effocr_tpu/kernels/pallas_nms.py
(``pallas_nms_mask``).  The CUDA source is compiled with nvcc for sm_90a
into a shared library with a plain C interface on first use
(kernels/cuda_build.py, git-ignored ``csrc/build/``) and called through
ctypes on PyTorch's current stream.

``nms_keep`` is the entry the pipeline calls: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version,
kernels/nms.py ``nms_mask(presorted=True)``.  There is no fallback from
one to the other.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from effocr_torch.kernels.cuda_build import build_library
from effocr_torch.kernels.nms import nms_mask

# H100: 227 KB of shared memory per block (232,448 bytes), less the
# kernel's static word
_SMEM_LIMIT = 232448 - 16


def build() -> str:
    """Compile csrc/nms.cu (no FMA contraction: the keep mask is
    bit-identical to the plain version) unless an up-to-date library
    exists; returns the library path."""
    return build_library("nms.cu", "nms", ["-fmad=false"])


class NmsKernel:
    """The loaded kernel library and its launch count.

    ``launches`` rises by one per kernel launch and nowhere else, so a run
    can show that its NMS went through the kernel."""

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()

    def _load(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(build())
                lib.nms_mask_launch.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_void_p,
                ]
                lib.nms_mask_launch.restype = ctypes.c_int
                lib.nms_mask_smem_bytes.argtypes = [ctypes.c_int]
                lib.nms_mask_smem_bytes.restype = ctypes.c_size_t
                lib.nms_error_string.argtypes = [ctypes.c_int]
                lib.nms_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def __call__(self, boxes: torch.Tensor, valid: torch.Tensor,
                 iou_thresh: float) -> torch.Tensor:
        """Keep mask [B, N] bool for presorted boxes [B, N, 4] float32 and
        valid [B, N] bool, both contiguous on one CUDA device."""
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
        lib = self._load()
        b, n = valid.shape
        if lib.nms_mask_smem_bytes(n) > _SMEM_LIMIT:
            raise ValueError(f"N = {n} boxes per image needs "
                             f"{lib.nms_mask_smem_bytes(n)} bytes of shared "
                             f"memory, over the {_SMEM_LIMIT} a block has")
        keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
        with torch.cuda.device(boxes.device):
            stream = torch.cuda.current_stream(boxes.device).cuda_stream
            err = lib.nms_mask_launch(boxes.data_ptr(), valid.data_ptr(),
                                      keep.data_ptr(), b, n,
                                      float(iou_thresh), stream)
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
