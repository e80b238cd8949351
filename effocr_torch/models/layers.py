"""Shared building blocks, NCHW inside, matching the Flax numerics of the
JAX package's models/layers.py.

Flax modules there compute convolutions in ``dtype`` (bfloat16 by default,
even when the pipeline runs with ``compute_dtype f32``): inputs, kernels
and biases are cast to ``dtype``, the bias is added after the convolution
in that dtype, and BatchNorm and the activation run in float32 before the
result is cast back.  These modules do the same; their parameters stay
float32 and are cast at use.

Submodule names mirror the Flax scopes (``Conv_0``, ``BatchNorm_0``,
``reduce``, ``expand``) so interop/flax_bridge.py maps checkpoints by name.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from effocr_torch.core import distributed


def autopad(k: int, p: Optional[int] = None) -> int:
    return k // 2 if p is None else p


class Conv(nn.Module):
    """Flax ``nn.Conv`` counterpart: OIHW weight, optional bias added in
    the compute dtype after the convolution."""

    def __init__(self, in_features: int, features: int, kernel: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(features, in_features // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None,
                     self.stride, self.padding, 1, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).view(1, -1, 1, 1)
        return y


class Dense(nn.Module):
    """Flax ``nn.Dense`` counterpart ([out, in] weight, bias)."""

    def __init__(self, in_features: int, features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.weight.to(self.dtype).t()
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(dtype=float32)`` over the channel axis of NCHW
    input, with Flax's operation order
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.

    In eval mode it normalises with the running statistics.  In train
    mode (``module.train()``) it takes the batch statistics in float32
    with Flax's fast variance ``max(E[x^2] - E[x]^2, 0)`` (biased) and
    updates the running statistics as Flax does,
    ``ra = momentum * ra + (1 - momentum) * batch``, in place.  Inside
    a process group of more than one rank the batch statistics are those
    of the global batch (one all-reduce of the local sums and count), so
    N ranks normalise as one rank on the whole batch does;
    ``nn.SyncBatchNorm`` is not used for the three reasons below.
    ``nn.BatchNorm2d`` differs in all three (momentum meaning, unbiased
    running variance, two-pass variance)."""

    def __init__(self, features: int, eps: float, momentum: float = 0.9):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps
        self.momentum = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        # float32 (float64 stays float64: the steps' float64 evaluations)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            if distributed.world_size() > 1:
                mean, mean2 = self._global_moments(x, axes)
            else:
                mean, mean2 = x.mean(dim=axes), torch.square(x).mean(dim=axes)
            var = torch.clamp(mean2 - torch.square(mean), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var.detach())
        else:
            mean, var = (self.running_mean.to(x.dtype),
                         self.running_var.to(x.dtype))
        mul = torch.rsqrt(var + self.eps) * self.weight.to(x.dtype)
        bias = self.bias.to(x.dtype).view(shape)
        return (x - mean.view(shape)) * mul.view(shape) + bias

    @staticmethod
    def _global_moments(x: torch.Tensor, axes):
        """E[x] and E[x^2] over the global batch of a process group: the
        local sums and count in one all-reduce that autograd
        differentiates (core/distributed.py)."""
        c = x.shape[1]
        count = torch.full((1,), x.numel() / c, dtype=x.dtype,
                           device=x.device)
        sums = distributed.all_reduce_sum(torch.cat(
            [x.sum(dim=axes), torch.square(x).sum(dim=axes), count]))
        return sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=float32)`` over the last axis: float32
    statistics with the fast variance ``max(E[x^2] - E[x]^2, 0)`` (Flax's
    ``use_fast_variance=True`` default) and Flax's operation order
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.  Returns float32."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        mean2 = torch.square(x).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - torch.square(mean), min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x - mean) * mul + self.bias.float()


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> [B, C]."""
    return x.mean(dim=(1, 2))


class ConvBnAct(nn.Module):
    """Conv2D + BatchNorm (eps 1e-3) + activation (YOLOv5's ``Conv``)."""

    def __init__(self, in_features: int, features: int, kernel: int = 1,
                 stride: int = 1, groups: int = 1,
                 padding: Optional[int] = None, act: Callable = F.silu,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        p = autopad(kernel, padding)
        self.Conv_0 = Conv(in_features, features, kernel, stride, p, groups,
                           bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, eps=1e-3, momentum=0.97)
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.BatchNorm_0(self.Conv_0(x))).to(self.dtype)


class SqueezeExcite(nn.Module):
    """SE block (MobileNetV3 style, hard-sigmoid gate), all in ``dtype``."""

    def __init__(self, features: int, reduce_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.reduce = Conv(features, reduce_features, 1, dtype=dtype)
        self.expand = Conv(reduce_features, features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the mean accumulates in float32 and rounds to x's dtype, as
        # jnp.mean does for bfloat16
        s = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        s = torch.relu(self.reduce(s))
        s = self.expand(s)
        gate = torch.clamp(s + 3.0, 0.0, 6.0) / 6.0  # hard sigmoid
        return x * gate
