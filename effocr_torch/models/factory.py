"""Model registry: the entries the ported inference paths load.

Names follow the JAX package's models/factory.py registry; only the
architectures of the ported inference paths (the pinned English and the
Japanese vertical configs) are here so far (ROADMAP.md lists the rest).
``create_*`` default to bfloat16 compute, as the JAX factory does, and
return modules in eval mode (``module.train()`` puts BatchNorm on batch
statistics, as Flax's ``train=True`` does).
``Classifier`` is an encoder with a float32 linear head (classifier
mode: logits out).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from effocr_torch.models import convnext, layers, mobilenetv3, yolo

ENCODER_REGISTRY: Dict[str, Callable] = {
    "convnext_atto": convnext.convnext_atto,
    "convnext_femto": convnext.convnext_femto,
    "convnext_nano": convnext.convnext_nano,
    "convnext_tiny": convnext.convnext_tiny,
    "convnext_small": convnext.convnext_small,
    "mobilenetv3_small_050": mobilenetv3.mobilenetv3_small_050,
}

LOCALIZER_REGISTRY: Dict[str, Callable] = {
    "yolov5n": yolo.yolov5n,
    "yolov5s": yolo.yolov5s,
    "yolov5m": yolo.yolov5m,
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


def _lookup(registry: Dict[str, Callable], kind: str, name: str) -> Callable:
    if name not in registry:
        raise KeyError(
            f"{kind} '{name}' is not ported to effocr_torch yet (have "
            f"{sorted(registry)}); ROADMAP.md lists the architectures still "
            "to port")
    return registry[name]


def create_encoder(name: str, in_channels: int = 3,
                   dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    return _lookup(ENCODER_REGISTRY, "encoder", name)(
        in_channels=in_channels, dtype=dtype).eval()


def create_classifier(name: str, num_classes: int, in_channels: int = 3,
                      dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    return Classifier(create_encoder(name, in_channels, dtype),
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
    init (1e-6)."""
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
    return model
