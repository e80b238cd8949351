"""MobileNetV3-Small encoder, the PyTorch twin of the JAX package's
models/mobilenetv3.py.

Inverted-residual blocks with optional squeeze-excite and hard-swish.
``forward`` takes NHWC images and returns the pooled embedding: convs in
``dtype`` (bfloat16 by default), BatchNorm (eps 1e-5) and activations in
float32, then a float32 global average pool and float32 Dense head.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from effocr_torch.models.layers import BatchNorm, Conv, Dense, SqueezeExcite


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * (torch.clamp(x + 3.0, 0.0, 6.0) / 6.0)


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class BlockSpecMNV3(NamedTuple):
    kernel: int
    exp: int      # expansion features (at multiplier 1.0)
    out: int      # output features (at multiplier 1.0)
    se: bool
    act: str      # "relu" | "hswish"
    stride: int


# MobileNetV3-Small (paper Table 2)
SMALL_SPECS: Tuple[BlockSpecMNV3, ...] = (
    BlockSpecMNV3(3, 16, 16, True, "relu", 2),
    BlockSpecMNV3(3, 72, 24, False, "relu", 2),
    BlockSpecMNV3(3, 88, 24, False, "relu", 1),
    BlockSpecMNV3(5, 96, 40, True, "hswish", 2),
    BlockSpecMNV3(5, 240, 40, True, "hswish", 1),
    BlockSpecMNV3(5, 240, 40, True, "hswish", 1),
    BlockSpecMNV3(5, 120, 48, True, "hswish", 1),
    BlockSpecMNV3(5, 144, 48, True, "hswish", 1),
    BlockSpecMNV3(5, 288, 96, True, "hswish", 2),
    BlockSpecMNV3(5, 576, 96, True, "hswish", 1),
    BlockSpecMNV3(5, 576, 96, True, "hswish", 1),
)


class InvertedResidual(nn.Module):
    def __init__(self, in_features: int, spec: BlockSpecMNV3,
                 multiplier: float, dtype=torch.bfloat16):
        super().__init__()
        self.act = torch.relu if spec.act == "relu" else hard_swish
        exp_f = _make_divisible(spec.exp * multiplier)
        out_f = _make_divisible(spec.out * multiplier)
        self.has_expand = exp_f != in_features
        if self.has_expand:
            self.expand = Conv(in_features, exp_f, 1, bias=False, dtype=dtype)
            self.expand_bn = BatchNorm(exp_f, eps=1e-5)
        k, s = spec.kernel, spec.stride
        self.dw = Conv(exp_f, exp_f, k, s, k // 2, groups=exp_f, bias=False,
                       dtype=dtype)
        self.dw_bn = BatchNorm(exp_f, eps=1e-5)
        if spec.se:
            self.SqueezeExcite_0 = SqueezeExcite(
                exp_f, _make_divisible(exp_f / 4), dtype=dtype)
        self.has_se = spec.se
        self.project = Conv(exp_f, out_f, 1, bias=False, dtype=dtype)
        self.project_bn = BatchNorm(out_f, eps=1e-5)
        self.residual = s == 1 and in_features == out_f
        self.out_features = out_f
        self.dtype = dtype

    def forward(self, x):
        y = x
        if self.has_expand:
            y = self.act(self.expand_bn(self.expand(y))).to(self.dtype)
        y = self.act(self.dw_bn(self.dw(y))).to(self.dtype)
        if self.has_se:
            y = self.SqueezeExcite_0(y)
        y = self.project_bn(self.project(y)).to(self.dtype)
        return y + x if self.residual else y


class MobileNetV3Small(nn.Module):
    """Returns pooled embeddings [B, head_features]."""

    def __init__(self, multiplier: float = 0.5, head_features: int = 1024,
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        stem_f = _make_divisible(16 * multiplier)
        self.stem = Conv(in_channels, stem_f, 3, 2, 1, bias=False, dtype=dtype)
        self.stem_bn = BatchNorm(stem_f, eps=1e-5)
        f = stem_f
        for i, spec in enumerate(SMALL_SPECS):
            block = InvertedResidual(f, spec, multiplier, dtype=dtype)
            setattr(self, f"block{i}", block)
            f = block.out_features
        last_f = _make_divisible(576 * multiplier)
        self.last_conv = Conv(f, last_f, 1, bias=False, dtype=dtype)
        self.last_bn = BatchNorm(last_f, eps=1e-5)
        self.head = Dense(last_f, head_features, dtype=torch.float32)
        self.out_features = head_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, C] float images (NHWC, as in the JAX package)."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = hard_swish(self.stem_bn(self.stem(x))).to(self.dtype)
        for i in range(len(SMALL_SPECS)):
            x = getattr(self, f"block{i}")(x)
        x = hard_swish(self.last_bn(self.last_conv(x)))
        x = x.float().mean(dim=(2, 3))
        # timm conv_head equivalent (acts on pooled features)
        return hard_swish(self.head(x))


def mobilenetv3_small_050(**kw):
    return MobileNetV3Small(multiplier=0.5, **kw)


def mobilenetv3_small_100(**kw):
    return MobileNetV3Small(multiplier=1.0, **kw)
