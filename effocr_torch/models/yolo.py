"""YOLOv5-style detector (the localizer), the PyTorch twin of the JAX
package's models/yolo.py.

CSP backbone + SPPF + PAN neck + 3-scale anchor head.  The public layout
is the JAX one: ``forward`` takes NHWC images and returns
``(decoded [B, A, 5+nc], raw)`` with raw grids ``[B, gh, gw, na, 5+nc]``
and A flattened in ``(gy, gx, anchor)`` order.  Inside, tensors are NCHW;
convolutions run in ``dtype`` (bfloat16 by default), BatchNorm and SiLU in
float32, and the detect head is a float32 convolution.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from effocr_torch.models.layers import Conv, ConvBnAct

DEFAULT_ANCHORS: Tuple[Tuple[float, ...], ...] = (
    (10, 13, 16, 30, 33, 23),       # P3/8
    (30, 61, 62, 45, 59, 119),      # P4/16
    (116, 90, 156, 198, 373, 326),  # P5/32
)
STRIDES = (8, 16, 32)


class Bottleneck(nn.Module):
    def __init__(self, in_features: int, features: int, shortcut: bool = True,
                 expansion: float = 0.5, dtype=torch.bfloat16):
        super().__init__()
        hidden = int(features * expansion)
        self.ConvBnAct_0 = ConvBnAct(in_features, hidden, 1, dtype=dtype)
        self.ConvBnAct_1 = ConvBnAct(hidden, features, 3, dtype=dtype)
        self.add = shortcut and in_features == features

    def forward(self, x):
        y = self.ConvBnAct_1(self.ConvBnAct_0(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions."""

    def __init__(self, in_features: int, features: int, n: int = 1,
                 shortcut: bool = True, dtype=torch.bfloat16):
        super().__init__()
        hidden = features // 2
        self.ConvBnAct_0 = ConvBnAct(in_features, hidden, 1, dtype=dtype)
        self.n = n
        for i in range(n):
            setattr(self, f"m{i}",
                    Bottleneck(hidden, hidden, shortcut, 1.0, dtype=dtype))
        self.ConvBnAct_1 = ConvBnAct(in_features, hidden, 1, dtype=dtype)
        self.ConvBnAct_2 = ConvBnAct(2 * hidden, features, 1, dtype=dtype)

    def forward(self, x):
        a = self.ConvBnAct_0(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        b = self.ConvBnAct_1(x)
        return self.ConvBnAct_2(torch.cat([a, b], dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 max pools.  PyTorch's
    max_pool2d pads with -inf, as Flax's ``padding="SAME"`` max_pool does."""

    def __init__(self, in_features: int, features: int, dtype=torch.bfloat16):
        super().__init__()
        hidden = in_features // 2
        self.ConvBnAct_0 = ConvBnAct(in_features, hidden, 1, dtype=dtype)
        self.ConvBnAct_1 = ConvBnAct(4 * hidden, features, 1, dtype=dtype)

    def forward(self, x):
        x = self.ConvBnAct_0(x)
        p1 = F.max_pool2d(x, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.ConvBnAct_1(torch.cat([x, p1, p2, p3], dim=1))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample, NCHW."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class CSPTrunk(nn.Module):
    """The CSP backbone + SPPF + PAN neck the YOLO, FCOS and R-CNN
    families share, under the Flax scope names (``stem``, ``down1``,
    ``c3_1`` ... ``neck5``).  ``trunk`` returns the three PAN outputs
    (strides 8, 16, 32; widths ``w(256)``, ``w(512)``, ``w(1024)``)."""

    def w(self, f: int) -> int:
        """Channel width ``f`` at this model's width multiple."""
        return int(math.ceil(f * self.width_multiple / 8) * 8)

    def _build_trunk(self, in_channels: int, width_multiple: float,
                     depth_multiple: float, dtype: torch.dtype) -> None:
        self.dtype = dtype
        self.width_multiple = width_multiple
        w = self.w

        def d(n):
            return max(round(n * depth_multiple), 1)

        def cba(i, f, k, s, p=None):
            return ConvBnAct(i, w(f), k, s, padding=p, dtype=dtype)

        def c3(i, f, n, sc):
            return C3(i, w(f), d(n), sc, dtype=dtype)

        # backbone
        self.stem = cba(in_channels, 64, 6, 2, p=2)            # /2
        self.down1 = cba(w(64), 128, 3, 2)                     # /4
        self.c3_1 = c3(w(128), 128, 3, True)
        self.down2 = cba(w(128), 256, 3, 2)                    # /8
        self.c3_2 = c3(w(256), 256, 6, True)
        self.down3 = cba(w(256), 512, 3, 2)                    # /16
        self.c3_3 = c3(w(512), 512, 9, True)
        self.down4 = cba(w(512), 1024, 3, 2)                   # /32
        self.c3_4 = c3(w(1024), 1024, 3, True)
        self.sppf = SPPF(w(1024), w(1024), dtype=dtype)
        # PAN neck
        self.lat5 = cba(w(1024), 512, 1, 1)
        self.neck4 = c3(2 * w(512), 512, 3, False)
        self.lat4 = cba(w(512), 256, 1, 1)
        self.neck3 = c3(2 * w(256), 256, 3, False)             # P3 out
        self.pan3 = cba(w(256), 256, 3, 2)
        self.neck4b = c3(2 * w(256), 512, 3, False)            # P4 out
        self.pan4 = cba(w(512), 512, 3, 2)
        self.neck5 = c3(2 * w(512), 1024, 3, False)            # P5 out

    def trunk(self, x: torch.Tensor):
        """x: [B, H, W, C] float images (NHWC) -> (o3, o4, o5), NCHW."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = self.down1(self.stem(x))
        x = self.c3_1(x)
        p3 = self.c3_2(self.down2(x))
        p4 = self.c3_3(self.down3(p3))
        x = self.c3_4(self.down4(p4))
        p5 = self.sppf(x)

        t5 = self.lat5(p5)
        n4 = self.neck4(torch.cat([_upsample2(t5), p4], dim=1))
        t4 = self.lat4(n4)
        o3 = self.neck3(torch.cat([_upsample2(t4), p3], dim=1))
        o4 = self.neck4b(torch.cat([self.pan3(o3), t4], dim=1))
        o5 = self.neck5(torch.cat([self.pan4(o4), t5], dim=1))
        return o3, o4, o5


class YOLOv5(CSPTrunk):
    """Returns (decoded [B, A, 5+nc], raw per-scale grids)."""

    def __init__(self, num_classes: int = 2, depth_multiple: float = 0.33,
                 width_multiple: float = 0.50,
                 anchors: Tuple[Tuple[float, ...], ...] = DEFAULT_ANCHORS,
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.anchors = tuple(tuple(float(v) for v in a) for a in anchors)
        self._build_trunk(in_channels, width_multiple, depth_multiple, dtype)
        w = self.w
        # detect head (float32 convolutions)
        self.na = len(self.anchors[0]) // 2
        self.no = 5 + num_classes
        for i, f in enumerate((w(256), w(512), w(1024))):
            setattr(self, f"detect{i}",
                    Conv(f, self.na * self.no, 1, dtype=torch.float32))

    def forward(self, x: torch.Tensor, decode: bool = True):
        """x: [B, H, W, C] float images (NHWC, as in the JAX package)."""
        raw = []
        for i, feat in enumerate(self.trunk(x)):
            y = getattr(self, f"detect{i}")(feat.float())  # [B, na*no, h, w]
            b, _, gh, gw = y.shape
            # NHWC before the reshape: A flattens as (gy, gx, anchor)
            raw.append(y.permute(0, 2, 3, 1).reshape(b, gh, gw, self.na,
                                                     self.no))
        if not decode:
            return raw
        return decode_predictions(raw, self.anchors), raw


def decode_predictions(
    raw: Sequence[torch.Tensor],
    anchors: Tuple[Tuple[float, ...], ...] = DEFAULT_ANCHORS,
    strides: Tuple[int, ...] = STRIDES,
) -> torch.Tensor:
    """Per-scale raw grids [B,H,W,na,5+nc] -> decoded [B, A, 5+nc] (xywh,
    obj, cls in pixel/probability space) — the YOLOv5 export transform:
    xy = (2*sig(t)-0.5+grid)*stride, wh = (2*sig(t))^2 * anchor.
    """
    outs: List[torch.Tensor] = []
    for y, anc, stride in zip(raw, anchors, strides):
        b, gh, gw, na, no = y.shape
        y = torch.sigmoid(y.float())
        gy, gx = torch.meshgrid(
            torch.arange(gh, dtype=torch.float32, device=y.device),
            torch.arange(gw, dtype=torch.float32, device=y.device),
            indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)[:, :, None, :]  # [gh, gw, 1, 2]
        anc_wh = torch.tensor(anc, dtype=torch.float32,
                              device=y.device).reshape(na, 2)
        xy = (y[..., :2] * 2.0 - 0.5 + grid) * stride
        wh = torch.square(y[..., 2:4] * 2.0) * anc_wh
        out = torch.cat([xy, wh, y[..., 4:]], dim=-1)
        outs.append(out.reshape(b, gh * gw * na, no))
    return torch.cat(outs, dim=1)


def yolov5n(**kw):
    return YOLOv5(depth_multiple=0.33, width_multiple=0.25, **kw)


def yolov5s(**kw):
    return YOLOv5(depth_multiple=0.33, width_multiple=0.50, **kw)


def yolov5m(**kw):
    return YOLOv5(depth_multiple=0.67, width_multiple=0.75, **kw)
