"""Image preprocessing of the inference path (the JAX package's
kernels/image_ops.py): letterbox geometry, the host letterbox of detector
training (a numpy copy of OpenCV's uint8 bilinear resize, byte for
byte), the on-device letterbox of bucket transfer, ImageNet
normalisation, the 2-bit transfer quantiser, and the paired transform
(MedianPad square -> /255 -> bilinear resize without antialias ->
normalise) of crops cut from the original image.

Resizes are bilinear interpolation matrices (each row a 2-tap hat
function, samples past the edge clamped to it), applied as batched
float32 matmuls.  The sample positions are rounded as the JAX package's
compiled programs round them: XLA folds ``(i + 0.5) * ratio - 0.5`` into
one fused multiply-add (emulated here in float64, then rounded once) and
turns a division by the constant output size into a multiplication by
its float32 reciprocal.  A position off by one float32 ulp moves a weight
by up to ~3e-5 at 256-pixel windows, past the parity tolerance.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from effocr_torch.core.config import IMAGENET_MEAN, IMAGENET_STD


def letterbox_params(
    h: int, w: int, new_shape: Tuple[int, int] = (640, 640), scaleup: bool = True
) -> Tuple[float, Tuple[int, int], Tuple[int, int, int, int]]:
    """Compute (ratio, (new_w, new_h), (top, bottom, left, right)) padding
    (YOLOv5 letterbox with auto=False, scaleFill=False)."""
    r = min(new_shape[0] / h, new_shape[1] / w)
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = int(round(w * r)), int(round(h * r))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    dw /= 2
    dh /= 2
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    return r, new_unpad, (top, bottom, left, right)


# ---------------------------------------------------------------------------
# host letterbox: OpenCV's INTER_LINEAR on uint8, byte for byte
# ---------------------------------------------------------------------------

_COEF_ONE = 2048        # OpenCV's INTER_RESIZE_COEF_SCALE (11 bits)


def _cv_taps(src: int, dst: int, clamp: bool):
    """Source index and the two 11-bit weights of each output position,
    as OpenCV derives them: the position ``(d + 0.5) * scale - 0.5`` in
    float64 rounded to float32, its floor and float32 fraction, the
    weights ``1 - f`` and ``f`` times 2048 rounded half to even.
    ``clamp`` (the horizontal pass): positions left of 0 or at/past the
    last pixel take that pixel whole; ``edge`` marks the latter, which
    OpenCV computes as ``pixel * 2048``.  The vertical pass keeps the
    fraction and clamps only the row it reads."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    edge = s >= src - 1
    if clamp:
        f[s < 0] = 0.0
        s[s < 0] = 0
        f[edge] = 0.0
        s[edge] = src - 1
    a0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_ONE))
    a1 = np.rint(f * np.float32(_COEF_ONE))
    return s, a0.astype(np.int64), a1.astype(np.int64), edge


def cv2_resize_linear(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)``
    of a uint8 [H, W, C] image, byte for byte (OpenCV 4-5, x86), as
    [out_h, out_w, C].

    A shrink by exactly 2 on both axes is OpenCV's fast area path: the
    mean of each 2 x 2 block, ``(sum + 2) >> 2``.  Otherwise two
    fixed-point passes: rows, ``p0 * a0 + p1 * a1`` in int32 (weights of
    11 bits); then columns, in the arithmetic of OpenCV's SIMD loop, which
    it runs over the whole row: each row term shifted right by 4 and
    saturated to int16, multiplied by its 11-bit weight keeping the high
    16 bits, the two summed with int16 saturation, then ``(v + 2) >> 2``
    saturated to uint8.  This differs by up to 1 level from the exact
    rounding of ``INTER_LINEAR_EXACT``."""
    h, w, c = img.shape
    if min(h, w, out_h, out_w) < 1:
        raise ValueError(f"cannot resize {w} x {h} to {out_w} x {out_h}")
    x = img.astype(np.int64)
    if w == 2 * out_w and h == 2 * out_h:
        s = x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    sx, a0, a1, edge = _cv_taps(w, out_w, clamp=True)
    rows = (x[:, sx] * a0[None, :, None]
            + x[:, np.minimum(sx + 1, w - 1)] * a1[None, :, None])
    rows[:, edge] = x[:, sx[edge]] * _COEF_ONE
    sy, b0, b1, _ = _cv_taps(h, out_h, clamp=False)
    r0 = rows[np.clip(sy, 0, h - 1)]
    r1 = rows[np.clip(sy + 1, 0, h - 1)]

    def sat16(v):
        return np.clip(v, -32768, 32767)

    def mul_hi(r, b):
        return (sat16(r >> 4) * b[:, None, None]) >> 16

    v = sat16(mul_hi(r0, b0) + mul_hi(r1, b1))
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


def letterbox_host(
    im: np.ndarray,
    new_shape: Tuple[int, int] = (640, 640),
    color: int = 114,
    scaleup: bool = True,
) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """The JAX package's cv2 letterbox, byte for byte: uint8 HWC (or HW)
    in, (canvas [H, W, C] uint8, ratio, (dw, dh)) out.  The image is
    resized by ``cv2_resize_linear`` (skipped when its size is already
    the target) and padded with ``color`` at the rounded offsets."""
    if im.ndim == 2:
        im = im[:, :, None]
    h, w = im.shape[:2]
    r, new_unpad, (top, bottom, left, right) = letterbox_params(
        h, w, new_shape, scaleup)
    if (w, h) != new_unpad:
        im = cv2_resize_linear(im, new_unpad[0], new_unpad[1])
    out = np.full((im.shape[0] + top + bottom, im.shape[1] + left + right,
                   im.shape[2]), color, np.uint8)
    out[top:top + im.shape[0], left:left + im.shape[1]] = im
    dw = (new_shape[1] - new_unpad[0]) / 2
    dh = (new_shape[0] - new_unpad[1]) / 2
    return out, r, (dw, dh)


def _fma_positions(first: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """float32 ``first * ratio - 0.5`` rounded once, as a fused
    multiply-add rounds it (the product of two float32 values is exact in
    float64).  first [K] or [N, K], ratio [N] -> [N, K]."""
    return (first.double() * ratio.double()[:, None] - 0.5).float()


def _clamped_hat(pos: torch.Tensor, side: torch.Tensor,
                 offset: torch.Tensor | float, window: int) -> torch.Tensor:
    """[N, K, window] hat weights at the sample positions ``pos`` [N, K],
    clamped to [0, side - 1] (per row of ``side`` [N]) and then shifted by
    ``offset`` ([N] or a scalar)."""
    hi = torch.clamp(side[:, None] - 1.0, min=0.0)
    src = torch.minimum(torch.clamp(pos, min=0.0), hi)
    if isinstance(offset, torch.Tensor):
        offset = offset[:, None]
    src = offset + src
    s = torch.arange(window, dtype=torch.float32, device=pos.device)
    return torch.clamp(1.0 - torch.abs(src[:, :, None] - s[None, None, :]),
                       min=0.0)


def interp_matrix(side: torch.Tensor, out_size: int, window: int,
                  offset: torch.Tensor | float = 0.0) -> torch.Tensor:
    """[N, out_size, window] bilinear weights resampling [0, side) ->
    out_size, sample positions shifted by ``offset`` (per row of
    ``side``).  Columns at or past ``side`` get no weight."""
    dev = side.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    side = side.float()
    # side / out_size as XLA computes it: times the float32 reciprocal
    recip = torch.tensor(1.0 / out_size, dtype=torch.float32)
    return _clamped_hat(_fma_positions(i, side * recip.to(dev)), side,
                        offset, window)


def letterbox_device(images: torch.Tensor, src_rect: torch.Tensor,
                     dst_params: torch.Tensor, out_h: int, out_w: int,
                     pad_val: float = 114.0 / 255.0) -> torch.Tensor:
    """Per-image letterbox on the device by separable interpolation
    matmuls (bucket transfer: the host ships raw-size lines in a small
    padded bucket).

    images:     [B, Hb, Wb, C] float in [0, 1] (bucketed raw images).
    src_rect:   [B, 4] int (y0, x0, h, w) content rect inside the bucket.
    dst_params: [B, 4] int (top, left, new_h, new_w) placement on the
                canvas (host-computed with letterbox_params' rounding).
    Returns [B, out_h, out_w, C]; canvas pixels outside the placement get
    ``pad_val``.
    """
    b, hb, wb, _ = images.shape
    dev = images.device
    images = images.float()

    def axis_matrix(dst_size, src_size_total, d0, dn, s0, sn):
        # [B, dst_size, src_size_total]: canvas position -> source weight;
        # the ratio is a per-line division, as the compiled program does it
        d = torch.arange(dst_size, dtype=torch.float32, device=dev)[None, :]
        rel = _fma_positions(d - d0[:, None] + 0.5,
                             sn / torch.clamp(dn, min=1.0))
        w = _clamped_hat(rel, sn, s0, src_size_total)
        in_dst = (d >= d0[:, None]) & (d < d0[:, None] + dn[:, None])
        return torch.where(in_dst[:, :, None], w, torch.zeros((), device=dev))

    sr = src_rect.float()
    dp = dst_params.float()
    a_y = axis_matrix(out_h, hb, dp[:, 0], dp[:, 2], sr[:, 0], sr[:, 2])
    a_x = axis_matrix(out_w, wb, dp[:, 1], dp[:, 3], sr[:, 1], sr[:, 3])
    t = torch.einsum("bih,bhwc->biwc", a_y, images)
    out = torch.einsum("bjw,biwc->bijc", a_x, t)
    mass = torch.einsum("bi,bj->bij", a_y.sum(2), a_x.sum(2))
    return out + (1.0 - mass)[..., None] * pad_val


@functools.lru_cache(maxsize=None)
def _norm_consts(gray: bool, dtype: torch.dtype, device: torch.device):
    if gray:
        mean, std = [sum(IMAGENET_MEAN) / 3], [sum(IMAGENET_STD) / 3]
    else:
        mean, std = list(IMAGENET_MEAN), list(IMAGENET_STD)
    return (torch.tensor(mean, dtype=dtype).to(device),
            torch.tensor(std, dtype=dtype).to(device))


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """x in [0,1] NHWC -> ImageNet-normalized.  Single-channel input uses
    the channel-averaged constants (grayscale pipelines).  The constants
    are made once per device and dtype: a host->device copy per call
    would make the host wait for the device."""
    mean, std = _norm_consts(x.shape[-1] == 1, x.dtype, x.device)
    return (x - mean) / std


# 4x4 Bayer ordered-dither offsets for the 2-bit transfer, spanning one
# reconstruction step (the device unpacks level v to v*85); the native
# packer (native/preproc.cpp) uses the same matrix and formula.
_BAYER4 = np.array(
    [[0, 8, 2, 10], [12, 4, 14, 6], [3, 11, 1, 9], [15, 7, 13, 5]],
    np.int16,
)
_BAYER4_OFFSETS = (((_BAYER4 + 0.5) / 16.0 - 0.5) * 85.0).round().astype(
    np.int16
)


def dither_offsets(h: int, w: int) -> np.ndarray:
    """[h, w] int16 ordered-dither offsets (add, then quantize_2bit)."""
    reps = (-(-h // 4), -(-w // 4))
    return np.tile(_BAYER4_OFFSETS, reps)[:h, :w]


def quantize_2bit(img_u8: np.ndarray, d: np.ndarray) -> np.ndarray:
    """uint8 image + broadcastable dither offsets -> levels 0..3, each the
    nearest device reconstruction value v*85."""
    q = np.clip(img_u8.astype(np.int16) + d, 0, 255).astype(np.int32)
    return ((q * 3 + 128) >> 8).astype(np.uint8)


# ---------------------------------------------------------------------------
# MedianPad square + resize + normalize (the "paired transform")
# ---------------------------------------------------------------------------

def _median_border_color(img: np.ndarray) -> Tuple[int, ...]:
    """Median of the 4 border rows/cols."""
    h, w = img.shape[:2]
    rightb, leftb = img[:, w - 1, :], img[:, 0, :]
    topb, bottomb = img[0, :, :], img[h - 1, :, :]
    border = np.concatenate([rightb, leftb, topb, bottomb], axis=0)
    return tuple(int(v) for v in np.median(border, axis=0))


def median_pad_square(
    img: np.ndarray, override: Optional[Tuple[int, int, int]] = (255, 255, 255)
) -> np.ndarray:
    """Pad right/bottom to a square with override (or median-border)
    color; content stays at the top-left."""
    h, w = img.shape[:2]
    side = max(h, w)
    fill = override if override is not None else _median_border_color(img)
    out = np.empty((side, side, img.shape[2]), dtype=img.dtype)
    out[...] = np.asarray(fill, dtype=img.dtype)
    out[:h, :w] = img
    return out


def resize_matrix(sides: torch.Tensor, size: int,
                  window: int) -> torch.Tensor:
    """[N, size, window] weights of ``jax.image.resize(..., "linear",
    antialias=False)`` from [0, side) to ``size``, as it builds them: hat
    weights of the unclamped sample positions, each row divided by its
    sum (which folds the edge samples onto the edge pixel).  Columns at
    or past ``side`` get no weight; side == size gives the identity."""
    dev = sides.device
    i = torch.arange(size, dtype=torch.float32, device=dev) + 0.5
    side = sides.double()
    pos = _fma_positions(i, (side / size).float())        # [N, size]
    s = torch.arange(window, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - torch.abs(pos[:, :, None] - s), min=0.0)
    w = torch.where(s < side.float()[:, None, None], w, 0.0)
    total = w.sum(dim=2, keepdim=True)
    eps = float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (pos >= -0.5) & (pos <= side.float()[:, None] - 0.5)
    return torch.where(inside[:, :, None], w, 0.0)


def paired_transform_squares(squares: torch.Tensor, sides: torch.Tensor,
                             size: int) -> torch.Tensor:
    """The paired transform of a batch of padded squares: [N, S, S, C]
    float in [0, 1], square n holding its crop's side x side pad-to-square
    at the top-left (whatever lies past ``sides[n]`` gets no weight) ->
    [N, size, size, C] ImageNet-normalized."""
    a = resize_matrix(sides, size, squares.shape[1])
    t = torch.einsum("nis,nswc->niwc", a, squares.float())
    return normalize_imagenet(torch.einsum("njw,niwc->nijc", a, t))


def paired_transform_host(img: np.ndarray, size: int = 224) -> np.ndarray:
    """One HWC uint8 crop -> [size, size, 3] float32 ImageNet-normalized:
    pad to square (white), scale to [0, 1], bilinear resize without
    antialias, normalize."""
    sq = median_pad_square(img).astype(np.float32) / 255.0
    out = paired_transform_squares(torch.from_numpy(sq)[None],
                                   torch.tensor([sq.shape[0]]), size)
    return out[0].numpy()
