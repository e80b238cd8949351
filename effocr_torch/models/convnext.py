"""ConvNeXt encoder family, the PyTorch twin of the JAX package's
models/convnext.py.

Patchify stem, four stages of 7x7-depthwise + pointwise-MLP blocks with
LayerScale, downsampling between stages, and a global-pool head that
returns the LayerNorm-ed pooled embedding.  The public layout is NHWC and
so is the layout inside: convolutions see an NCHW view of the NHWC
tensor (channels-last memory), LayerNorm and the MLP act on the last axis
as the Flax modules do.  Numerics follow Flax: convolutions and Dense
layers in ``dtype`` (bfloat16 by default), LayerNorm in float32 (eps
1e-6), ``x * gamma`` in float32 (a bfloat16 activation times a float32
parameter), the residual sum in float32 cast back to ``dtype``, the
pooled mean and ``head_norm`` in float32.

Submodule names mirror the Flax scopes (``stem``, ``stem_norm``,
``downsample_norm{i}``, ``downsample{i}``, ``stage{i}_block{j}`` with
``dwconv``, ``LayerNorm_0``, ``mlp_up``, ``mlp_down``, ``gamma``,
``head_norm``) so interop/flax_bridge.py maps checkpoints by name.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from effocr_torch.models.layers import Conv, Dense, LayerNorm, global_avg_pool


def _conv_nhwc(conv: Conv, x: torch.Tensor, same: bool = False
               ) -> torch.Tensor:
    """Apply an NCHW ``Conv`` to an NHWC tensor.  ``same``: Flax's default
    "SAME" padding for a stride-s, kernel-k conv (low = total // 2)."""
    if same:
        k, s = conv.weight.shape[-1], conv.stride
        pads = []
        for size in (x.shape[2], x.shape[1]):   # W then H, F.pad order
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            x = F.pad(x, (0, 0, *pads))
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dwconv = Conv(dim, dim, 7, 1, 3, groups=dim, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(dim)
        self.mlp_up = Dense(dim, 4 * dim, dtype=dtype)
        self.mlp_down = Dense(4 * dim, dim, dtype=dtype)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.LayerNorm_0(_conv_nhwc(self.dwconv, x))
        # exact (erf) GELU, in the Dense output's dtype
        y = self.mlp_down(F.gelu(self.mlp_up(y)))
        y = y.float() * self.gamma.float()
        return (x.float() + y).to(self.dtype)


class ConvNeXt(nn.Module):
    """Returns pooled embeddings [B, dims[-1]] (float32)."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depths = tuple(depths)
        self.dtype = dtype
        f = in_channels
        for i, (depth, dim) in enumerate(zip(depths, dims)):
            if i == 0:
                self.stem = Conv(f, dim, 4, 4, dtype=dtype)
                self.stem_norm = LayerNorm(dim)
            else:
                setattr(self, f"downsample_norm{i}", LayerNorm(f))
                setattr(self, f"downsample{i}", Conv(f, dim, 2, 2,
                                                     dtype=dtype))
            for j in range(depth):
                setattr(self, f"stage{i}_block{j}",
                        ConvNeXtBlock(dim, dtype=dtype))
            f = dim
        self.head_norm = LayerNorm(f)
        self.out_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, C] float images (NHWC, as in the JAX package)."""
        x = x.to(self.dtype)
        for i, depth in enumerate(self.depths):
            if i == 0:
                x = self.stem_norm(_conv_nhwc(self.stem, x, same=True))
            else:
                x = getattr(self, f"downsample_norm{i}")(x)
                x = _conv_nhwc(getattr(self, f"downsample{i}"), x, same=True)
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
        return self.head_norm(global_avg_pool(x.float()))


def convnext_atto(**kw):
    return ConvNeXt(depths=(2, 2, 6, 2), dims=(40, 80, 160, 320), **kw)


def convnext_femto(**kw):
    return ConvNeXt(depths=(2, 2, 6, 2), dims=(48, 96, 192, 384), **kw)


def convnext_nano(**kw):
    return ConvNeXt(depths=(2, 2, 8, 2), dims=(80, 160, 320, 640), **kw)


def convnext_tiny(**kw):
    return ConvNeXt(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), **kw)


def convnext_small(**kw):
    return ConvNeXt(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768), **kw)
