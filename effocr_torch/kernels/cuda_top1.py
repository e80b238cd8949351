"""Fused masked top-1 retrieval on Hopper: the wrapper of csrc/top1.cu.

Replaces the TPU kernel effocr_tpu/kernels/pallas_retrieval.py
(``pallas_top1``).  The CUDA source is compiled with nvcc for sm_90a into
a shared library with a plain C interface on first use
(kernels/cuda_build.py, git-ignored ``csrc/build/``) and called through
ctypes on PyTorch's current stream.

``top1`` is the entry the pipeline calls: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version,
kernels/retrieval.py ``top1_plain``.  There is no fallback from one to
the other.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from effocr_torch.kernels.cuda_build import build_library
from effocr_torch.kernels.retrieval import top1_plain


def build() -> str:
    """Compile csrc/top1.cu unless an up-to-date library exists; returns
    the library path."""
    return build_library("top1.cu", "top1")


class Top1Kernel:
    """The loaded kernel library and its launch count.

    ``launches`` rises by one per call that launches the kernel (its
    partial pass and, with more than one prototype split, the fold of the
    splits) and nowhere else, so a run can show that its retrieval went
    through the kernel."""

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()

    def _load(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(build())
                lib.top1_splits.argtypes = [ctypes.c_int, ctypes.c_int]
                lib.top1_splits.restype = ctypes.c_int
                lib.top1_launch.argtypes = (
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p] * 5)
                lib.top1_launch.restype = ctypes.c_int
                lib.top1_error_string.argtypes = [ctypes.c_int]
                lib.top1_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def splits(self, n: int, c: int) -> int:
        """The number of prototype splits (the grid's second axis) a
        launch on the current CUDA device uses for n queries and c
        prototypes."""
        lib = self._load()
        splits = lib.top1_splits(n, c)
        if splits < 0:
            raise RuntimeError("top-1 kernel planning failed: "
                               + lib.top1_error_string(-splits).decode())
        return splits

    def __call__(self, queries: torch.Tensor, prototypes: torch.Tensor,
                 row_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores [N] float32, indices [N] int32) for queries [N, D] and
        prototypes [C, D] float32, row_mask [C] bool, all contiguous on one
        CUDA device, D a multiple of 4."""
        dev = queries.device
        if not (queries.is_cuda and prototypes.device == dev
                and row_mask.device == dev):
            raise ValueError("the CUDA top-1 kernel needs queries, "
                             "prototypes and row_mask on one CUDA device, "
                             f"got {queries.device}, {prototypes.device} and "
                             f"{row_mask.device}")
        if (queries.dtype != torch.float32 or prototypes.dtype != torch.float32
                or row_mask.dtype != torch.bool):
            raise TypeError("need float32 queries and prototypes and a bool "
                            f"row_mask, got {queries.dtype}, "
                            f"{prototypes.dtype} and {row_mask.dtype}")
        if (queries.dim() != 2 or prototypes.dim() != 2
                or queries.shape[1] != prototypes.shape[1]
                or row_mask.shape != prototypes.shape[:1]):
            raise ValueError(
                f"need queries [N, D], prototypes [C, D] and row_mask [C], "
                f"got {tuple(queries.shape)}, {tuple(prototypes.shape)} and "
                f"{tuple(row_mask.shape)}")
        n, d = queries.shape
        c = prototypes.shape[0]
        if c == 0 or d % 4:
            raise ValueError(f"need C >= 1 prototypes and D % 4 == 0, got "
                             f"C = {c}, D = {d}")
        if not (queries.is_contiguous() and prototypes.is_contiguous()
                and row_mask.is_contiguous()
                and queries.data_ptr() % 16 == 0
                and prototypes.data_ptr() % 16 == 0):
            raise ValueError("queries, prototypes and row_mask must be "
                             "contiguous (the float rows 16-byte aligned)")
        lib = self._load()
        scores = torch.empty((n,), dtype=torch.float32, device=dev)
        idx = torch.empty((n,), dtype=torch.int32, device=dev)
        if n == 0:
            return scores, idx
        with torch.cuda.device(dev):
            splits = self.splits(n, c)
            part_s = torch.empty((splits, n), dtype=torch.float32, device=dev)
            part_i = torch.empty((splits, n), dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.top1_launch(
                queries.data_ptr(), prototypes.data_ptr(),
                row_mask.data_ptr(), n, c, d, splits, part_s.data_ptr(),
                part_i.data_ptr(), scores.data_ptr(), idx.data_ptr(), stream)
        if err != 0:
            raise RuntimeError("top-1 kernel launch failed: "
                               + lib.top1_error_string(err).decode())
        self.launches += 1
        return scores, idx


top1_kernel = Top1Kernel()


def pad_depth(queries: torch.Tensor, prototypes: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad the embedding width D of queries [N, D] and prototypes
    [C, D] up to a multiple of 4, the kernel's float4 row step.  The
    added products are +0.0, so every inner product is unchanged (the
    JAX kernel takes any D)."""
    pad = -queries.shape[1] % 4
    if pad:
        queries = torch.nn.functional.pad(queries, (0, pad))
        prototypes = torch.nn.functional.pad(prototypes, (0, pad))
    return queries, prototypes


def top1(queries: torch.Tensor, prototypes: torch.Tensor,
         row_mask: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [N], indices [N] int32) of the best inner-product prototype
    for L2-normalized queries: the CUDA kernel for CUDA tensors (any D:
    see ``pad_depth``), the plain version for CPU tensors."""
    if queries.is_cuda:
        if row_mask is None:
            row_mask = torch.ones(prototypes.shape[0], dtype=torch.bool,
                                  device=prototypes.device)
        q, p = pad_depth(queries.float(), prototypes.float())
        return top1_kernel(q.contiguous(), p.contiguous(),
                           row_mask.contiguous())
    return top1_plain(queries, prototypes, row_mask)
