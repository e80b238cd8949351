"""Detection training augmentation on the device (the JAX package's
kernels/det_augment.py ``augment_detection_batch``), split in two as the
recognizer's augmentation is:

- ``draw_detection_augment(generator, ...)`` makes every random draw of
  one batch from a ``torch.Generator`` on the training device;
- ``apply_detection_augment(images, targets, mask, draws, ...)`` does the
  arithmetic, with no randomness of its own, so it can be held to the JAX
  function on draws made with ``jax.random`` from its 7 key splits.

Per sample: scale jitter in [1 - scale, 1 + scale] about the canvas
centre plus a translation of up to translate x (W, H), as a re-letterbox
of the canvas onto itself (``letterbox_device``: two interpolation
matmuls; content that falls off is cropped, vacated area is letterbox
gray); a horizontal flip; brightness and contrast jitter about 0.5 and
Gaussian noise.  The placement is rounded half to even (``torch.round``,
as ``jnp.round``) so boxes ride the pixels' geometry; boxes are clipped
to the canvas and those clipped below ``min_box_px`` on a side are
masked out.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from effocr_torch.kernels.image_ops import letterbox_device


def _reciprocal_f32(n: int) -> float:
    """1 / n rounded to float32 (exact as a Python float)."""
    return float(np.float32(1.0) / np.float32(n))


def draw_detection_augment(generator: torch.Generator, b: int, h: int,
                           w: int, channels: int, *, flip_p: float = 0.5,
                           scale: float = 0.25, translate: float = 0.1,
                           brightness: float = 0.2, contrast: float = 0.2,
                           noise_std: float = 0.02) -> Dict[str, torch.Tensor]:
    """Every random draw of one batch of ``b`` canvases [h, w, channels],
    on the generator's device, in ``augment_detection_batch``'s ranges."""
    dev = generator.device

    def u(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) * (
            hi - lo) + lo

    d = {
        "scale": u((b,), 1.0 - scale, 1.0 + scale),
        "tx": u((b,), -translate * w, translate * w),
        "ty": u((b,), -translate * h, translate * h),
        "flip": torch.rand((b,), generator=generator, device=dev) < flip_p,
        "brightness": u((b, 1, 1, 1), -brightness, brightness),
        "contrast": 1.0 + u((b, 1, 1, 1), -contrast, contrast),
    }
    if noise_std > 0:
        d["noise"] = torch.randn((b, h, w, channels), generator=generator,
                                 device=dev)
    return d


def apply_detection_augment(
    images: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor,
    draws: Dict[str, torch.Tensor],
    *,
    noise_std: float = 0.02,
    pad_val: float = 114.0 / 255.0,
    min_box_px: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """images [B, H, W, C] float32 in [0, 1]; targets [B, T, 5] (cls, cx,
    cy, w, h) in canvas pixels; mask [B, T] -> the augmented (images,
    targets, mask)."""
    b, h, w, _ = images.shape
    dev = images.device
    s = draws["scale"]
    nh = torch.round(h * s)
    nw = torch.round(w * s)
    ty = torch.round((h - nh) / 2.0 + draws["ty"])
    tx = torch.round((w - nw) / 2.0 + draws["tx"])

    # made on the device: a host tensor copied up would stall the host
    src_rect = torch.zeros((b, 4), dtype=torch.int32, device=dev)
    src_rect[:, 2], src_rect[:, 3] = h, w
    dst_params = torch.stack([ty, tx, nh, nw], 1).to(torch.int32)
    out = letterbox_device(images, src_rect, dst_params, h, w,
                           pad_val=pad_val)

    # boxes: p' = p * (n / size) + offset, the pixels' own mapping; the
    # ratio is n times the float32 reciprocal of the size, as XLA divides
    # by a constant and torch's CUDA kernel by a scalar (torch's CPU
    # division rounds the quotient itself: 1 ulp apart for h = 96)
    ry = (nh * _reciprocal_f32(h))[:, None]
    rx = (nw * _reciprocal_f32(w))[:, None]
    cx = targets[:, :, 1] * rx + tx[:, None]
    cy = targets[:, :, 2] * ry + ty[:, None]
    bw = targets[:, :, 3] * rx
    bh = targets[:, :, 4] * ry

    flip = draws["flip"]
    out = torch.where(flip[:, None, None, None], torch.flip(out, dims=[2]),
                      out)
    cx = torch.where(flip[:, None], w - cx, cx)

    x0 = torch.clamp(cx - bw / 2, 0.0, float(w))
    x1 = torch.clamp(cx + bw / 2, 0.0, float(w))
    y0 = torch.clamp(cy - bh / 2, 0.0, float(h))
    y1 = torch.clamp(cy + bh / 2, 0.0, float(h))
    new_t = torch.stack(
        [targets[:, :, 0], (x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0],
        dim=2,
    )
    new_mask = mask & (x1 - x0 >= min_box_px) & (y1 - y0 >= min_box_px)

    out = (out - 0.5) * draws["contrast"] + 0.5 + draws["brightness"]
    if noise_std > 0:
        out = out + noise_std * draws["noise"]
    return torch.clamp(out, 0.0, 1.0), new_t, new_mask
