"""Diagnostic visualization: kNN retrieval grids and localizer box overlays
(the JAX package's utils/viz.py), without Pillow.

``save_knn_grid`` is Pillow's ``Image.resize`` (default filter, bicubic)
of each tile pasted into a white RGB strip, saved through the port's PNG
writer; ``draw_boxes`` is ``ImageDraw.rectangle``'s 1-px outline: float
corners truncated toward zero (C's ``(int)`` cast), the top and bottom
rows drawn in full, the sides between them with Pillow's line rule (the
end point left out, so a zero-height box also marks the pixel below
it), everything clipped to the image.  Both hold pixel for pixel against
Pillow (tests/test_torch_tools.py).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from effocr_torch.data import png
from effocr_torch.data.folder import pil_bicubic_resize

# ImageColor's RGB of the colour names the package draws with
_COLORS = {"red": (255, 0, 0)}


def _rgb(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W] or [H, W, 3] -> [H, W, 3] (gray replicated, as
    Pillow pastes an L image into an RGB one)."""
    a = np.asarray(img, np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in (1, 3):
        raise ValueError(f"expected a gray or RGB image, got {a.shape}")
    return np.repeat(a, 3, axis=2) if a.shape[2] == 1 else a


def save_knn_grid(
    query_img: np.ndarray,
    neighbor_imgs: Sequence[np.ndarray],
    save_path: str,
    correct: Optional[bool] = None,
    tile: int = 112,
) -> str:
    """Save [query | nn1 | nn2 | ...] horizontally; uint8 HWC inputs."""
    imgs = [query_img] + list(neighbor_imgs)
    canvas = np.full((tile, tile * len(imgs), 3), 255, np.uint8)
    for i, arr in enumerate(imgs):
        a = np.asarray(arr, np.uint8)
        a = a[..., None] if a.ndim == 2 else a
        canvas[:, i * tile:(i + 1) * tile] = _rgb(
            pil_bicubic_resize(a, tile, tile))
    root, ext = os.path.splitext(save_path)
    if correct is not None:
        save_path = f"{root}_{'correct' if correct else 'incorrect'}{ext}"
    return png.write(save_path, canvas)


def _ink(color: str, channels: int) -> np.ndarray:
    """Pillow's ImageColor.getcolor for an L, RGB or RGBA image."""
    rgb = _COLORS[color]
    if channels == 1:
        r, g, b = rgb
        return np.asarray([(r * 299 + g * 587 + b * 114) // 1000], np.uint8)
    return np.asarray(rgb + (255,) * (channels - 3), np.uint8)


def _point(img: np.ndarray, x: int, y: int, ink) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = ink


def _hline(img: np.ndarray, x0: int, y: int, x1: int, ink) -> None:
    """Pillow's hline: row y from x0 to x1 inclusive, clipped."""
    if 0 <= y < img.shape[0]:
        x0, x1 = max(x0, 0), min(x1, img.shape[1] - 1)
        if x0 <= x1:
            img[y, x0:x1 + 1] = ink


def _vline(img: np.ndarray, x: int, y0: int, y1: int, ink) -> None:
    """Pillow's line() with dx 0: |y1 - y0| points from y0 toward y1,
    y1 itself left out."""
    step = 1 if y1 >= y0 else -1
    for y in range(y0, y1, step):
        _point(img, x, y, ink)


def draw_boxes(
    image: np.ndarray,
    boxes: Sequence[Sequence[float]],
    save_path: Optional[str] = None,
    color: str = "red",
) -> np.ndarray:
    """Overlay xyxy boxes (1-px outline, Pillow's ``ImageDraw.rectangle``)
    on a copy of a uint8 [H, W] or [H, W, 3 | 4] image; saved as PNG when
    ``save_path`` is given."""
    img = np.array(image, np.uint8)
    ink = _ink(color, 1 if img.ndim == 2 else img.shape[2])
    ink = ink[0] if img.ndim == 2 else ink
    for b in boxes:
        fx0, fy0, fx1, fy1 = (float(v) for v in b[:4])
        if fx1 < fx0:
            raise ValueError("x1 must be greater than or equal to x0")
        if fy1 < fy0:
            raise ValueError("y1 must be greater than or equal to y0")
        x0, y0, x1, y1 = int(fx0), int(fy0), int(fx1), int(fy1)
        _hline(img, x0, y0, x1, ink)
        _hline(img, x0, y1, x1, ink)
        _vline(img, x1, y0 + 1, y1, ink)
        _vline(img, x0, y0 + 1, y1, ink)
    if save_path:
        png.write(save_path, img)
    return img
