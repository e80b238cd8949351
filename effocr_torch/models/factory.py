"""Model registry: every encoder and localizer the JAX package's
models/factory.py registers, under the same names.

``create_*`` default to bfloat16 compute, as the JAX factory does, and
return modules in eval mode (``module.train()`` puts BatchNorm on batch
statistics, as Flax's ``train=True`` does).  The transformer encoders
(ViT, XCiT) fix their token grid from ``image_size`` at construction;
the convolutional ones take any size.
``Classifier`` is an encoder with a float32 linear head (classifier
mode: logits out); ``ProjectionHead`` the optional metric head.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from effocr_torch.models import (
    convnext,
    fcos,
    layers,
    mobilenetv3,
    rcnn,
    vit,
    yolo,
)

ENCODER_REGISTRY: Dict[str, Callable] = {
    "convnext_atto": convnext.convnext_atto,
    "convnext_femto": convnext.convnext_femto,
    "convnext_nano": convnext.convnext_nano,
    "convnext_tiny": convnext.convnext_tiny,
    "convnext_small": convnext.convnext_small,
    "mobilenetv3_small_050": mobilenetv3.mobilenetv3_small_050,
    "mobilenetv3_small_100": mobilenetv3.mobilenetv3_small_100,
    "vit_tiny_patch16_224": vit.vit_tiny_patch16,
    "vit_small_patch16_224": vit.vit_small_patch16,
    "xcit_tiny_12_p8_224": vit.xcit_tiny_12_p8,
    "xcit_small_12_p8_224": vit.xcit_small_12_p8,
}

# encoders whose parameters depend on the input size (the token grid)
SIZED_ENCODERS = frozenset(n for n in ENCODER_REGISTRY
                           if n.startswith(("vit_", "xcit_")))

LOCALIZER_REGISTRY: Dict[str, Callable] = {
    "yolov5n": yolo.yolov5n,
    "yolov5s": yolo.yolov5s,
    "yolov5m": yolo.yolov5m,
    # anchor-free and two-stage families: the same decoded layout
    "fcos_n": fcos.fcos_n,
    "fcos_s": fcos.fcos_s,
    "rcnn_n": rcnn.rcnn_n,
    "rcnn_s": rcnn.rcnn_s,
}


class Classifier(nn.Module):
    """Encoder + float32 Dense head -> logits [B, num_classes].  The
    submodule names ``encoder`` and ``head`` are the Flax scopes of the
    JAX package's ``Classifier``, so its checkpoints map by name."""

    def __init__(self, encoder: nn.Module, num_classes: int):
        super().__init__()
        self.encoder = encoder
        self.head = layers.Dense(encoder.out_features, num_classes,
                                 dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.encoder(x))


class ProjectionHead(nn.Module):
    """Optional metric head (the JAX factory's ``ProjectionHead``): Dense
    -> LayerNorm -> exact GELU -> Dense without bias, all float32."""

    def __init__(self, in_features: int, hidden_dim: int = 512,
                 output_dim: int = 128):
        super().__init__()
        self.Dense_0 = layers.Dense(in_features, hidden_dim)
        self.LayerNorm_0 = layers.LayerNorm(hidden_dim)
        self.Dense_1 = layers.Dense(hidden_dim, output_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.LayerNorm_0(self.Dense_0(x)), approximate="none")
        return self.Dense_1(x)


def _lookup(registry: Dict[str, Callable], kind: str, name: str) -> Callable:
    if name not in registry:
        raise KeyError(f"unknown {kind} '{name}'; have {sorted(registry)}")
    return registry[name]


def create_encoder(name: str, in_channels: int = 3,
                   dtype: torch.dtype = torch.bfloat16,
                   image_size: int = 224) -> nn.Module:
    """``image_size`` sizes the token grid of the ViT / XCiT encoders
    (SIZED_ENCODERS); the others ignore it."""
    kw = {"image_size": image_size} if name in SIZED_ENCODERS else {}
    return _lookup(ENCODER_REGISTRY, "encoder", name)(
        in_channels=in_channels, dtype=dtype, **kw).eval()


def create_classifier(name: str, num_classes: int, in_channels: int = 3,
                      dtype: torch.dtype = torch.bfloat16,
                      image_size: int = 224) -> nn.Module:
    return Classifier(create_encoder(name, in_channels, dtype, image_size),
                      num_classes).eval()


def create_localizer(name: str, num_classes: int = 2, in_channels: int = 3,
                     dtype: torch.dtype = torch.bfloat16, **kw) -> nn.Module:
    return _lookup(LOCALIZER_REGISTRY, "localizer", name)(
        num_classes=num_classes, in_channels=in_channels, dtype=dtype,
        **kw).eval()


# Flax's lecun_normal: a standard normal truncated at +-2, divided by the
# truncated distribution's standard deviation, times 1/sqrt(fan_in)
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal draws, each one outside +-2 drawn again: the same
    values from a seed on every machine and torch version
    (``nn.init.trunc_normal_`` has changed its algorithm between torch
    releases)."""
    w = torch.randn(shape, generator=generator)
    out = w.abs() > 2.0
    while out.any():
        w[out] = torch.randn(int(out.sum()), generator=generator)
        out = w.abs() > 2.0
    return w


def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random init in place, with Flax's default distributions:
    conv and Dense weights lecun_normal (std 1/sqrt(fan_in), truncated at
    2 of the untruncated standard deviations), biases 0, BatchNorm and
    LayerNorm at identity, ConvNeXt's LayerScale ``gamma`` at its Flax
    init (1e-6); the transformers' ``cls`` and ``pos`` embeddings
    ``truncated_normal(0.02)`` (a standard normal truncated at +-2, times
    0.02, no rescale), XCA's ``temperature`` and the ``gamma1..3`` layer
    scales at 1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (layers.Conv, layers.Dense)):
                fan_in = m.weight[0].numel()
                w = _truncated_normal(m.weight.shape, g)
                m.weight.copy_(w / (_TRUNC_STD * fan_in ** 0.5))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, layers.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, convnext.ConvNeXtBlock):
                m.gamma.fill_(1e-6)
            elif isinstance(m, (vit.ViT, vit.XCiT)):
                for p in (m.cls, m.pos):
                    p.copy_(_truncated_normal(p.shape, g) * 0.02)
            elif isinstance(m, vit.XCA):
                m.temperature.fill_(1.0)
            if isinstance(m, (vit.XCiTBlock, vit.ClassAttentionBlock)):
                for name in ("gamma1", "gamma2", "gamma3"):
                    if hasattr(m, name):
                        getattr(m, name).fill_(1.0)
    return model
