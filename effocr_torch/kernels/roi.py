"""Character-crop extraction: box -> white-padded square -> out_size²
(the JAX package's kernels/roi.py ``crop_lines_to_squares``).

Bilinear resize of a dynamic window is two small batched matmuls with
per-crop interpolation matrices (each row a 2-tap hat function):

    crop[n] = A_y[n] @ window[n] @ A_x[n]^T

When the canvas fits the static window along one axis, only the other
axis needs dynamic indexing and one flat gather fetches all windows; the
static axis's start offset folds into its interpolation matrix.  Both
such branches are ported: ``h <= window`` (horizontal rectangular
canvases: a gather of columns) and ``w <= window`` (vertical canvases: a
gather of rows).  The general 2-D window (both axes larger than the
window) is not.  The matmuls run in full float32 (TF32 off,
core/device.py).
"""

from __future__ import annotations

import torch

from effocr_torch.kernels.image_ops import normalize_imagenet


def _interp_matrix(side: torch.Tensor, out_size: int, window: int,
                   offset: torch.Tensor | float = 0.0) -> torch.Tensor:
    """[N, out_size, window] bilinear weights resampling [0, side) ->
    out_size, sample positions shifted by ``offset`` (per crop)."""
    dev = side.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev)
    side = side[:, None]
    src = (i[None, :] + 0.5) * (side / out_size) - 0.5
    hi = torch.clamp(side - 1.0, min=0.0)
    src = torch.minimum(torch.clamp(src, min=0.0), hi)
    if isinstance(offset, torch.Tensor):
        offset = offset[:, None]
    src = offset + src
    s = torch.arange(window, dtype=torch.float32, device=dev)
    return torch.clamp(1.0 - torch.abs(src[:, :, None] - s[None, None, :]),
                       min=0.0)


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

    images:  [B, H, W, C] float in [0,1] (letterboxed lines), H <= window
             or W <= window.
    rects:   [N, 4] int (x0, y0, x1, y1) pixel rects.
    img_idx: [N] int source line index for each crop.
    valid:   [N] bool; invalid slots produce all-white crops.

    Returns [N, out_size, out_size, C] ImageNet-normalized crops.
    """
    b, h, w, n_channels = images.shape
    if h > window and w > window:
        raise NotImplementedError(
            f"canvas {h}x{w} larger than the crop window {window} on both "
            "axes: the general 2-D window branch of crop_lines_to_squares "
            "is not ported (ROADMAP.md)")
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
    else:
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

    t = torch.einsum("nis,nswc->niwc", a_y, wins)        # rows
    crops = torch.einsum("njw,niwc->nijc", a_x, t)       # cols
    crops = torch.where(valid[:, None, None, None], crops, white_t)
    return normalize_imagenet(crops)
