"""Character-crop extraction: box -> white-padded square -> out_size²
(the JAX package's kernels/roi.py ``crop_lines_to_squares``).

Bilinear resize of a dynamic window is two small batched matmuls with
per-crop interpolation matrices (each row a 2-tap hat function):

    crop[n] = A_y[n] @ window[n] @ A_x[n]^T

When the canvas fits the static window along one axis, only the other
axis needs dynamic indexing and one flat gather fetches all windows; the
static axis's start offset folds into its interpolation matrix:
``h <= window`` (horizontal rectangular canvases: a gather of columns)
and ``w <= window`` (vertical canvases: a gather of rows).  Otherwise
(square canvases larger than the window on both axes) each crop takes an
S x S window of the white-padded canvas, gathered as S rows of S pixels
through a strided view (no per-crop loop).  The matmuls run in full
float32 (TF32 off, core/device.py).
"""

from __future__ import annotations

import torch

from effocr_torch.kernels.image_ops import interp_matrix as _interp_matrix
from effocr_torch.kernels.image_ops import normalize_imagenet


def crop_lines_to_squares(
    images: torch.Tensor,
    rects: torch.Tensor,
    img_idx: torch.Tensor,
    valid: torch.Tensor,
    out_size: int = 224,
    window: int = 256,
    white: float = 1.0,
) -> torch.Tensor:
    """Extract normalized square crops from a batch of line images.

    images:  [B, H, W, C] float in [0,1] (letterboxed lines).
    rects:   [N, 4] int (x0, y0, x1, y1) pixel rects.
    img_idx: [N] int source line index for each crop.
    valid:   [N] bool; invalid slots produce all-white crops.

    Returns [N, out_size, out_size, C] ImageNet-normalized crops.
    """
    b, h, w, n_channels = images.shape
    dev = images.device
    rects = rects.to(torch.int64)
    x0 = torch.clamp(rects[:, 0], 0, w - 1)
    y0 = torch.clamp(rects[:, 1], 0, h - 1)
    # clamp the crop extent to the static window (an oversized rect loses
    # its far edge)
    x1 = torch.minimum(torch.maximum(rects[:, 2], x0 + 1),
                       torch.clamp(x0 + window, max=w))
    y1 = torch.minimum(torch.maximum(rects[:, 3], y0 + 1),
                       torch.clamp(y0 + window, max=h))
    cw = (x1 - x0).float()
    ch = (y1 - y0).float()
    side = torch.maximum(cw, ch)
    n = rects.shape[0]
    img_idx = img_idx.to(torch.int64)
    white_t = torch.full((), white, device=dev)
    ramp = torch.arange(window, device=dev)
    iy = ramp.float()

    if h <= window:
        # dynamic in x only: wins[n, i, j] = padded[b_n, i, x0_n + j]
        pad_x = torch.nn.functional.pad(
            images.float(), (0, 0, 0, window), value=white)   # [B,H,W+S,C]
        wp = w + window
        flat = pad_x.transpose(1, 2).reshape(b * wp, h * n_channels)
        row_idx = (img_idx * wp + x0)[:, None] + ramp
        cols = flat.index_select(0, row_idx.reshape(-1))
        wins = cols.reshape(n, window, h, n_channels).transpose(1, 2)
        rows = torch.arange(h, dtype=torch.float32, device=dev)
        y0f = y0.float()[:, None, None]
        in_content = (
            (rows[None, :, None] >= y0f)
            & (rows[None, :, None] < y0f + ch[:, None, None])
            & (iy[None, None, :] < cw[:, None, None])
        )  # [N, H, S]
        wins = torch.where(in_content[..., None], wins, white_t)
        # absolute row positions never exceed y0 + side - 1 < h + window
        wins = torch.nn.functional.pad(wins, (0, 0, 0, 0, 0, window),
                                       value=white)
        a_y = _interp_matrix(side, out_size, h + window, y0.float())
        a_x = _interp_matrix(side, out_size, window)
    elif w <= window:
        # dynamic in y only (vertical canvases): wins[n, i, j] =
        # padded[b_n, y0_n + i, j]
        pad_y = torch.nn.functional.pad(
            images.float(), (0, 0, 0, 0, 0, window), value=white)  # [B,H+S,W,C]
        hp = h + window
        flat = pad_y.reshape(b * hp, w * n_channels)
        row_idx = (img_idx * hp + y0)[:, None] + ramp
        wins = flat.index_select(0, row_idx.reshape(-1)).reshape(
            n, window, w, n_channels)                        # [N, S, W, C]
        cols = torch.arange(w, dtype=torch.float32, device=dev)
        x0f = x0.float()[:, None, None]
        in_content = (
            (iy[None, :, None] < ch[:, None, None])
            & (cols[None, None, :] >= x0f)
            & (cols[None, None, :] < x0f + cw[:, None, None])
        )  # [N, S, W]
        wins = torch.where(in_content[..., None], wins, white_t)
        # absolute column positions never exceed x0 + side - 1 < w + window
        wins = torch.nn.functional.pad(wins, (0, 0, 0, window), value=white)
        a_y = _interp_matrix(side, out_size, window)
        a_x = _interp_matrix(side, out_size, w + window, x0.float())
    else:
        # general 2-D window: wins[n, i, j] = padded[b_n, y0_n + i,
        # x0_n + j] of the canvas padded white by S right and below.  Row
        # k of a strided view of the flat canvas is the S-pixel run that
        # starts at pixel k (x0 + S <= W + S - 1: a run never crosses
        # into the next canvas row), so one gather of n * S runs fetches
        # every window.
        padded = torch.nn.functional.pad(
            images.float(), (0, 0, 0, window, 0, window),
            value=white).contiguous()                     # [B,H+S,W+S,C]
        hp, wp = h + window, w + window
        runs = padded.reshape(-1).as_strided(
            (b * hp * wp - window + 1, window * n_channels),
            (n_channels, 1))
        row_idx = ((img_idx * hp + y0)[:, None] + ramp) * wp + x0[:, None]
        wins = runs.index_select(0, row_idx.reshape(-1)).reshape(
            n, window, window, n_channels)                 # [N, S, S, C]
        in_content = ((iy[None, :, None] < ch[:, None, None])
                      & (iy[None, None, :] < cw[:, None, None]))  # [N,S,S]
        wins = torch.where(in_content[..., None], wins, white_t)
        a_y = _interp_matrix(side, out_size, window)
        a_x = a_y    # square target: the same mapping on both axes

    t = torch.einsum("nis,nswc->niwc", a_y, wins)        # rows
    crops = torch.einsum("njw,niwc->nijc", a_x, t)       # cols
    crops = torch.where(valid[:, None, None, None], crops, white_t)
    return normalize_imagenet(crops)
