"""Pillow's ``ImageFont.truetype`` / ``FreeTypeFont`` and
``ImageDraw.text`` / ``textbbox`` / ``textlength`` on numpy arrays, with
Pillow 12.1's numbers and pixels (raqm layout, FreeType 2.14):

- ``getmetrics``: the size's ascender and descender (FreeType moves
  them out to whole pixels for CFF fonts and for TrueType fonts whose
  ``head`` asks for integer ppem);
- ``getbbox`` / ``textbbox``: glyph control boxes in whole pixels and the
  pen line, relative to the anchor (Pillow's bounding_box_and_anchors);
- ``getlength`` (``textlength``): the sum of the shaped advances / 64;
- ``draw_text``: Pillow's getmask2 (glyph bitmaps combined into a mask
  as coverage over coverage; the fractional start, split off with
  ``math.modf``, rounded to 1/64 pixel) and draw_bitmap (each channel
  blended with Pillow's integer arithmetic), onto a uint8 [H, W] ("L")
  or [H, W, 3] ("RGB") array in place.

Anchors: horizontal ``l``/``m``/``r`` with ``a``/``t``/``m``/``s``/``b``
/``d``.  Glyphs come from native/glyph.cpp (hinted TrueType or CFF
outlines, FreeType's gray rasterizer); shaping from fonts/shaping.py.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from effocr_torch.fonts import sfnt, shaping
from effocr_torch.fonts.cff import div_fix
from effocr_torch.native import glyph as native


def _pixel(x: int) -> int:
    """Pillow's PIXEL(): 26.6 rounded to whole pixels."""
    return ((x + 32) & -64) >> 6


def _cdiv2(x: int) -> int:
    """C's x / 2 (rounds toward zero)."""
    return x // 2 if x >= 0 else -((-x) // 2)


def _over(t: np.ndarray, s: np.ndarray) -> np.ndarray:
    """A glyph's coverage ``s`` over the mask's ``t``, as Pillow combines
    overlapping glyphs: t + s - DIV255(t * s)."""
    t, s = t.astype(np.int32), s.astype(np.int32)
    x = t * s + 128
    return (t + s - (((x >> 8) + x) >> 8)).astype(np.uint8)


def _roundf(v) -> int:
    """C's roundf: half away from zero."""
    f = float(v)
    return int(math.floor(f + 0.5)) if f >= 0 else -int(math.floor(0.5 - f))


def _mul_fix(a: int, b: int) -> int:
    ab = a * b
    return (ab + 0x8000 + (-1 if ab < 0 else 0)) >> 16


@functools.lru_cache(maxsize=16)
def _face(path: str, mtime: float):
    return native.open_face(sfnt.load(path))


class GlyphCache:
    """Hinted outlines' pixel boxes and rendered bitmaps of one size."""

    def __init__(self, face, ppem: int):
        self.size = face.new_size(ppem)
        if self.size.error:
            raise OSError(f"the font program of {face.font.path} fails at "
                          f"{ppem} px (error {self.size.error})")
        self._cbox: Dict[int, Tuple[int, int, int, int]] = {}
        self._bitmap: Dict[int, Tuple[np.ndarray, int, int]] = {}
        self._outline: Dict[int, tuple] = {}

    def outline(self, gid: int):
        """(points, tags, contours, overlap) of the hinted glyph."""
        o = self._outline.get(gid)
        if o is None:
            o = self._outline[gid] = self.size.glyph(gid, hinted=True)
        return o

    def cbox(self, gid: int) -> Tuple[int, int, int, int]:
        """FT_Glyph_Get_CBox(FT_GLYPH_BBOX_PIXELS): (xMin, yMin, xMax,
        yMax) in pixels, floor / ceil of the outline's control box."""
        b = self._cbox.get(gid)
        if b is None:
            pts = self.outline(gid)[0]
            if len(pts) == 0:
                b = (0, 0, 0, 0)
            else:
                lo, hi = pts.min(0), pts.max(0)
                b = (int(lo[0]) >> 6, int(lo[1]) >> 6,
                     (int(hi[0]) + 63) >> 6, (int(hi[1]) + 63) >> 6)
            self._cbox[gid] = b
        return b

    def bitmap(self, gid: int) -> Tuple[np.ndarray, int, int]:
        """(uint8 [rows, width], bitmap_left, bitmap_top) of
        FT_LOAD_RENDER in FT_RENDER_MODE_NORMAL."""
        r = self._bitmap.get(gid)
        if r is None:
            pts, tags, cont, overlap = self.outline(gid)
            if len(pts) == 0:
                r = (np.zeros((0, 0), np.uint8), 0, 0)
            else:
                x0, y0, x1, y1 = self.cbox(gid)
                shifted = pts - np.array([x0 * 64, y0 * 64], np.int64)
                r = (native.render(shifted, tags, cont, x1 - x0, y1 - y0,
                                   overlap), x0, y1)
            self._bitmap[gid] = r
        return r


@functools.lru_cache(maxsize=64)
def _glyphs(path: str, mtime: float, ppem: int) -> GlyphCache:
    return GlyphCache(_face(path, mtime), ppem)


class FreeTypeFont:
    """``ImageFont.truetype(path, size)``: a TrueType font at ``size``
    pixels per em."""

    def __init__(self, path: str, size: int):
        if int(size) != size or size <= 0:
            raise ValueError(f"font size must be a positive integer: {size}")
        self.path = os.path.abspath(path)
        self.size = int(size)
        self.font = sfnt.load(self.path)
        self.font.check_size(self.size)
        mtime = os.path.getmtime(self.path)
        self.glyphs = _glyphs(self.path, mtime, self.size)
        f = self.font
        self.x_scale = div_fix(self.size << 6, f.units_per_em)
        self.y_scale = self.x_scale
        asc, desc = f.hhea_ascender, f.hhea_descender
        if f.os2_version is not None and f.fs_selection & 128:
            asc, desc = f.typo_ascender, f.typo_descender
        elif asc == 0 and desc == 0 and f.os2_version is not None:
            if f.typo_ascender or f.typo_descender:
                asc, desc = f.typo_ascender, f.typo_descender
            else:
                asc, desc = f.win_ascent, -f.win_descent
        self.ascender = _mul_fix(asc, self.y_scale)
        self.descender = _mul_fix(desc, self.y_scale)
        if f.head_flags & 8 or f.cff is not None:
            # tt_size_reset (integer ppem), or FT_Request_Metrics for CFF
            # (its grid-fitted metrics): ascender up, descender down to
            # whole pixels
            self.ascender = (self.ascender + 63) & -64
            self.descender = self.descender & -64
        self._shape_cache: Dict[str, list] = {}

    # ------------------------------------------------------------ layout
    def shape(self, text: str) -> list:
        r = self._shape_cache.get(text)
        if r is None:
            r = [(g.gid, g.x_adv, g.y_adv, g.x_off, g.y_off)
                 for g in shaping.shape(self.font, text, self.x_scale)]
            if len(self._shape_cache) < 65536:
                self._shape_cache[text] = r
        return r

    def getmetrics(self) -> Tuple[int, int]:
        return _pixel(self.ascender), -_pixel(self.descender)

    def getlength(self, text: str) -> float:
        return sum(g[1] for g in self.shape(text)) / 64

    def _box(self, text: str, anchor: Optional[str]):
        """bounding_box_and_anchors: (width, height, x_offset, y_offset)
        and the shaped glyphs."""
        glyphs = self.shape(text)
        position = x_min = x_max = y_min = y_max = 0
        for gid, xa, ya, xo, yo in glyphs:
            px = _pixel(position + xo)
            py = _pixel(yo)
            position += xa
            advanced = _pixel(position)
            if advanced > x_max:
                x_max = advanced
            b0, b1, b2, b3 = self.glyphs.cbox(gid)
            x_max = max(x_max, b2 + px)
            x_min = min(x_min, b0 + px)
            y_max = max(y_max, b3 + py)
            y_min = min(y_min, b1 + py)
        if anchor is None:
            anchor = "la"
        if len(anchor) != 2:
            raise ValueError("anchor must be a 2 character string")
        x_anchor = y_anchor = 0
        if glyphs:
            h, v = anchor
            if h == "l":
                x_anchor = 0
            elif h == "m":
                x_anchor = _pixel(_cdiv2(position))
            elif h == "r":
                x_anchor = _pixel(position)
            else:
                raise ValueError(f"bad anchor specified: {anchor}")
            if v == "a":
                y_anchor = _pixel(self.ascender)
            elif v == "t":
                y_anchor = y_max
            elif v == "m":
                y_anchor = _pixel(_cdiv2(self.ascender + self.descender))
            elif v == "s":
                y_anchor = 0
            elif v == "b":
                y_anchor = y_min
            elif v == "d":
                y_anchor = _pixel(self.descender)
            else:
                raise ValueError(f"bad anchor specified: {anchor}")
        return (x_max - x_min, y_max - y_min, -x_anchor + x_min,
                -(-y_anchor + y_max), glyphs, x_min, y_max)

    def getbbox(self, text: str, anchor: Optional[str] = None
                ) -> Tuple[int, int, int, int]:
        w, h, xo, yo = self._box(text, anchor)[:4]
        return xo, yo, xo + w, yo + h

    def getmask2(self, text: str, anchor: Optional[str] = None,
                 start: Tuple[float, float] = (0.0, 0.0)
                 ) -> Tuple[np.ndarray, Tuple[int, int]]:
        """(uint8 [height, width] mask, (x_offset, y_offset))."""
        w, h, xo, yo, glyphs, x_min, y_max = self._box(text, anchor)
        xs, ys = np.float32(start[0]), np.float32(start[1])
        w = int(np.float32(w) + np.float32(math.ceil(xs)))
        h = int(np.float32(h) + np.float32(math.ceil(ys)))
        mask = np.zeros((max(h, 0), max(w, 0)), np.uint8)
        if not glyphs or w == 0 or h == 0:
            return mask, (xo, yo)
        x = -x_min * 64 + _roundf(xs * np.float32(64))
        y = -y_max * 64 - _roundf(ys * np.float32(64))
        for gid, xa, ya, gxo, gyo in glyphs:
            px = _pixel(x + gxo)
            py = _pixel(y + gyo)
            bmp, left, top = self.glyphs.bitmap(gid)
            xx = px + left
            yy = -(py + top)
            rows, cols = bmp.shape
            if rows and cols:
                x0, x1 = max(0, -xx), min(cols, w - xx)
                y0, y1 = max(0, -yy), min(rows, h - yy)
                if x0 < x1 and y0 < y1:
                    dst = mask[yy + y0: yy + y1, xx + x0: xx + x1]
                    dst[...] = _over(dst, bmp[y0:y1, x0:x1])
            x += xa
            y += ya
        return mask, (xo, yo)


def truetype(path: str, size: int) -> FreeTypeFont:
    return FreeTypeFont(path, size)


def _blend(out: np.ndarray, mask: np.ndarray, ink: int) -> np.ndarray:
    """Pillow's BLEND(mask, out, ink): DIV255(out*(255-m) + ink*m)."""
    t = out.astype(np.int32) * (255 - mask.astype(np.int32)) \
        + ink * mask.astype(np.int32) + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def draw_bitmap(img: np.ndarray, xy: Tuple[int, int], mask: np.ndarray,
                ink: Union[int, Sequence[int]]) -> None:
    """``ImageDraw.draw_bitmap``: blend ``ink`` through ``mask`` at
    integer ``xy`` (clipped to the image), in place."""
    h, w = img.shape[:2]
    mh, mw = mask.shape
    x, y = xy
    x0, y0 = max(0, -x), max(0, -y)
    x1, y1 = min(mw, w - x), min(mh, h - y)
    if x0 >= x1 or y0 >= y1:
        return
    m = mask[y0:y1, x0:x1]
    region = img[y + y0: y + y1, x + x0: x + x1]
    if img.ndim == 2:
        region[...] = _blend(region, m, int(ink))
    else:
        inks = [ink] * img.shape[2] if isinstance(ink, (int, np.integer)) \
            else list(ink)
        for c in range(img.shape[2]):
            region[..., c] = _blend(region[..., c], m, int(inks[c]))


def draw_text(img: np.ndarray, xy: Tuple[float, float], text: str,
              fill: Union[int, Sequence[int]], font: FreeTypeFont,
              anchor: Optional[str] = None) -> None:
    """``ImageDraw.Draw(img).text(xy, text, fill, font=font,
    anchor=anchor)`` for single-line text, in place."""
    if "\n" in text:
        raise NotImplementedError(
            f"multiline text: {sfnt.ROADMAP}")
    coord = [int(xy[0]), int(xy[1])]
    start = (math.modf(xy[0])[0], math.modf(xy[1])[0])
    mask, offset = font.getmask2(text, anchor=anchor, start=start)
    draw_bitmap(img, (coord[0] + offset[0], coord[1] + offset[1]), mask,
                fill)


def textbbox(xy: Tuple[float, float], text: str, font: FreeTypeFont,
             anchor: Optional[str] = None):
    """``ImageDraw.textbbox``: the font's bbox moved to ``xy``."""
    b = font.getbbox(text, anchor)
    return (b[0] + xy[0], b[1] + xy[1], b[2] + xy[0], b[3] + xy[1])
