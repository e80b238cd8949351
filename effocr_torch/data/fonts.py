"""Font glyph rendering: the render half of the recognizer dataset (the
JAX package's data/fonts.py), with the port's own renderer
(fonts/imagefont.py) in place of Pillow and fontTools.

Images are numpy arrays: "L" uint8 [H, W], "RGB" uint8 [H, W, 3].  The
pixels are Pillow 12.1's for TrueType fonts with bytecode; other fonts
raise ``NotImplementedError`` naming the feature (fonts/sfnt.py).

- ``draw_single_char``: draw on a 4x canvas, crop to the ink box with
  fractional padding, invert to dark-on-white, pad the short side
  symmetrically with white, LANCZOS-resize to ``canvas_size``.
- ``draw_single_char_ascender``: x cropped to ink, y from 0 to the
  font's line height, so relative glyph height survives.
- ``get_unicode_coverage_from_ttf``, ``filter_recurring_hash`` (tofu /
  duplicate-render removal), ``render_chars`` (the ``<ord>/`` tree,
  names ``{hex(ord)}_{idx}_{font}.png``), ``render_signatures``,
  ``dedupe_render_identical``, ``render_adjacent_bank`` and
  ``paired_chars`` (the load-bearing ``PAIRED_`` prefix).
"""

from __future__ import annotations

import math
import os
from collections import defaultdict
from glob import glob
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from effocr_torch.data import imaging
from effocr_torch.fonts import imagefont, sfnt
from effocr_torch.fonts.imagefont import FreeTypeFont, truetype


def get_unicode_coverage_from_ttf(ttf_path: str
                                  ) -> Tuple[List[int], List[str]]:
    """Decimal codepoints + chars covered by a font's cmap (the union
    over its subtables)."""
    codepoints = sfnt.load(ttf_path).coverage()
    return codepoints, [chr(c) for c in codepoints]


class _InkCanvas:
    """``Image.new(mode, (w, h), 0)`` with one text drawn in full-strength
    ink (255 in every band) by ``ImageDraw.text``, without the canvas:
    Pillow's blend of ink 255 over 0 gives the mask value itself, so the
    canvas is the text's mask at its offset, clipped, and black
    elsewhere."""

    def __init__(self, w: int, h: int, xy, text: str, font: FreeTypeFont,
                 anchor: Optional[str] = None):
        self.w, self.h = w, h
        start = (math.modf(xy[0])[0], math.modf(xy[1])[0])
        self.mask, (ox, oy) = font.getmask2(text, anchor=anchor, start=start)
        self.x, self.y = int(xy[0]) + ox, int(xy[1]) + oy

    def window(self, x0: int, y0: int, x1: int, y1: int) -> np.ndarray:
        """The canvas over [y0, y1) x [x0, x1), black outside it."""
        out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)), np.uint8)
        mh, mw = self.mask.shape
        # the mask's part inside both the canvas and the window
        a0, b0 = max(self.x, 0, x0), max(self.y, 0, y0)
        a1 = min(self.x + mw, self.w, x1)
        b1 = min(self.y + mh, self.h, y1)
        if a0 < a1 and b0 < b1:
            out[b0 - y0: b1 - y0, a0 - x0: a1 - x0] = self.mask[
                b0 - self.y: b1 - self.y, a0 - self.x: a1 - self.x]
        return out

    def getbbox(self) -> Optional[Tuple[int, int, int, int]]:
        mh, mw = self.mask.shape
        b = imaging.getbbox(self.window(self.x, self.y, self.x + mw,
                                        self.y + mh))
        if b is None:
            return None
        return (b[0] + self.x, b[1] + self.y, b[2] + self.x, b[3] + self.y)


def _ink_canvas(w: int, h: int, xy, ch: str, font: FreeTypeFont,
                anchor: Optional[str] = None) -> Optional[_InkCanvas]:
    """None where Pillow's text drawing raises OSError."""
    try:
        return _InkCanvas(w, h, xy, ch, font, anchor)
    except OSError:
        return None


def draw_single_char(ch: str, font: FreeTypeFont, canvas_size: int,
                     padding: float = 0.0) -> Optional[np.ndarray]:
    """Centered glyph -> ink-cropped, inverted, white-square, uint8
    [canvas_size, canvas_size] (drawn on a 4x canvas)."""
    c = canvas_size * 4
    img = _ink_canvas(c, c, (c // 2, c // 2), ch, font, anchor="mm")
    if img is None:
        return None
    bbox = img.getbbox()
    if bbox is None:
        return None
    l, u, r, d = bbox
    if l >= r or u >= d:
        return None
    xpad, ypad = int(padding * (r - l)), int(padding * (d - u))
    y0, x0 = max(u - ypad, 0), max(l - xpad, 0)
    arr = img.window(x0, y0, min(r + xpad, c), min(d + ypad, c))
    arr = 255 - arr
    h, w = arr.shape
    side = max(h, w)
    sq = np.full((side, side), 255, dtype=np.uint8)
    if w > h:
        off = (side - h) // 2
        sq[off: off + h, :w] = arr
    else:
        off = (side - w) // 2
        sq[:h, off: off + w] = arr
    return imaging.resize(sq, (canvas_size, canvas_size), "lanczos")


def draw_single_char_ascender(ch: str, font: FreeTypeFont, canvas_size: int,
                              padding: float = 0.0) -> Optional[np.ndarray]:
    """English draw, uint8 RGB: x cropped to ink, y spans the font's line
    height (drawn white on a black 5x canvas, then inverted).  Not
    squared; the training transform pads to square."""
    c = canvas_size * 5
    img = _ink_canvas(c, c, (0, 0), ch, font)
    if img is None:
        return None
    bbox = img.getbbox()
    if bbox is None:
        return None
    x0, y0, x1, y1 = bbox
    ascent, descent = font.getmetrics()
    h = ascent + descent
    vdist, hdist = y1 - y0, x1 - x0
    x0 = x0 - hdist * padding
    x1 = x1 + hdist * padding
    h = h + vdist * padding
    # Image.crop: the box rounded with Python's round, black outside
    bx0, by0, bx1, by1 = (int(round(v)) for v in (x0, 0, x1, h))
    crop = img.window(bx0, by0, bx1, by1)
    return imaging.invert(np.repeat(crop[..., None], 3, axis=2))


def filter_recurring_hash(charset: Sequence[str], font: FreeTypeFont,
                          canvas_size: int, sample_size: int = 2000,
                          seed: int = 0) -> List[int]:
    """Hashes of renders appearing >2x in a sample (tofu boxes etc.)."""
    chars = list(charset)
    np.random.default_rng(seed).shuffle(chars)
    hash_count: dict = defaultdict(int)
    for c in chars[:sample_size]:
        img = draw_single_char(c, font, canvas_size)
        if img is not None:
            hash_count[hash(img.tobytes())] += 1
    return [h for h, n in hash_count.items() if n > 2]


def render_chars(font_paths: Sequence[str], unicode_chars: Sequence[str],
                 save_path: str, padding: float = 0.0,
                 draw_func: Callable = draw_single_char,
                 square: bool = False, canvas_size: int = 256) -> int:
    """Render covered chars per font into the <save_path>/<ord>/ PNG tree;
    file names ``{hex(ord)}_{idx}_{font_name}.png``."""
    os.makedirs(save_path, exist_ok=True)
    idx = 0
    wanted = set(unicode_chars)
    for font_path in font_paths:
        font_name = os.path.splitext(os.path.basename(font_path))[0]
        font = truetype(font_path, canvas_size)
        _, covered = get_unicode_coverage_from_ttf(font_path)
        covered = sorted(set(c for c in covered if c in wanted))
        filter_hashes = set(filter_recurring_hash(covered, font, canvas_size))
        for c in covered:
            img = draw_func(c, font, canvas_size, padding=padding)
            if img is None:
                continue
            if hash(img.tobytes()) in filter_hashes:
                continue
            name = os.path.join(save_path, str(ord(c)),
                                f"{hex(ord(c))}_{idx}_{font_name}.png")
            if square:
                img = imaging.resize(img, (64, 64))
            imaging.save_image(name, img)
            idx += 1
    return idx


def render_signatures(chars: Sequence[str], font_paths: Sequence[str],
                      canvas_size: int = 64
                      ) -> Dict[str, Tuple[Tuple[int, int], ...]]:
    """char -> tuple of (font index, raster hash) over fonts rendering it;
    equal signatures mean indistinguishable in every font."""
    sigs: Dict[str, list] = {c: [] for c in chars}
    want = set(chars)
    for fi, fp in enumerate(font_paths):
        font = truetype(fp, canvas_size)
        _, covered = get_unicode_coverage_from_ttf(fp)
        for c in sorted(want.intersection(covered)):
            img = draw_single_char(c, font, canvas_size)
            if img is not None:
                sigs[c].append((fi, hash(img.tobytes())))
    return {c: tuple(s) for c, s in sigs.items()}


def dedupe_render_identical(chars: Sequence[str], font_paths: Sequence[str],
                            canvas_size: int = 64, tol: float = 0.0
                            ) -> Tuple[List[str], List[Tuple[str, str]]]:
    """Drop charset entries indistinguishable from a kept entry in every
    COMMON font; returns (kept, [(dropped, kept_twin)]).  Two chars merge
    when they share >=1 rendering font and their renders match in all
    fonts covering both (``tol`` > 0: mean |a-b|/255 <= tol per common
    font).  Wider-coverage chars are kept first; chars no font renders
    are kept."""
    renders: List[Dict[str, np.ndarray]] = []
    want = set(chars)
    for fp in font_paths:
        font = truetype(fp, canvas_size)
        _, covered = get_unicode_coverage_from_ttf(fp)
        per = {}
        for c in sorted(want.intersection(covered)):
            img = draw_single_char(c, font, canvas_size)
            if img is not None:
                per[c] = img
        renders.append(per)

    coverage = {
        c: [fi for fi, per in enumerate(renders) if c in per] for c in chars
    }

    def _same(a: str, b: str) -> bool:
        common = [fi for fi in coverage[a] if fi in set(coverage[b])]
        if not common:
            return False
        for fi in common:
            ra, rb = renders[fi][a], renders[fi][b]
            if tol <= 0.0:
                if ra.tobytes() != rb.tobytes():
                    return False
            elif float(np.mean(np.abs(ra.astype(np.int16) - rb)) / 255.0
                       ) > tol:
                return False
        return True

    # candidate pairs, complete by construction: exact mode buckets by
    # raster; tolerant mode bounds mean|a-b| below by the L1 distance of
    # 4x4 mean-pooled thumbnails / 16
    cand: Dict[str, set] = {c: set() for c in chars}
    if tol <= 0.0:
        buckets: Dict[tuple, List[str]] = {}
        for fi, per in enumerate(renders):
            for c, r in per.items():
                buckets.setdefault((fi, hash(r.tobytes())), []).append(c)
        for cs in buckets.values():
            if len(cs) > 1:
                s = set(cs)
                for c in cs:
                    cand[c].update(s)
    else:
        pool = max(1, canvas_size // 4)
        lim = 16.0 * tol * 255.0
        for per in renders:
            cs = sorted(per)
            if len(cs) < 2:
                continue
            th = np.stack([
                per[c][: 4 * pool, : 4 * pool]
                .reshape(4, pool, 4, pool)
                .astype(np.float32)
                .mean(axis=(1, 3))
                .ravel()
                for c in cs
            ])
            step = 256
            for lo in range(0, len(cs), step):
                d = np.abs(th[lo: lo + step, None, :] - th[None, :, :]).sum(-1)
                for i, j in zip(*np.nonzero(d <= lim)):
                    a, b = cs[lo + i], cs[j]
                    if a != b:
                        cand[a].add(b)
                        cand[b].add(a)

    order = sorted(range(len(chars)),
                   key=lambda i: (-len(coverage[chars[i]]), i))
    rep: Dict[str, str] = {}
    kept_set: set = set()
    for i in order:
        c = chars[i]
        if not coverage[c]:
            kept_set.add(c)
            continue
        twin = next(
            (k for k in sorted(cand[c]) if k in kept_set and _same(c, k)),
            None)
        if twin is None:
            kept_set.add(c)
        else:
            rep[c] = twin
    kept = [c for c in chars if c not in rep]
    dropped = [(c, rep[c]) for c in chars if c in rep]
    return kept, dropped


# Neighbour-glyph sets of the reference's AddAdjacentChars augmentations;
# the jp string's duplicates weight the sampling distribution.
ADJACENT_CHARS_JP = "HOXELI代西岡光夫締西岡雪"
ADJACENT_CHARS_EN = (
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ.,"
)


def render_adjacent_bank(font_path: str, size: int, lang: str = "en"
                         ) -> np.ndarray:
    """Per-side neighbour-glyph bank for the AddAdjacentChars augmentation
    (data/transforms.py ``_compose_adjacent``): each glyph pre-rendered
    flush against the edge it peeks in from.

    Returns uint8 [V, N, size, size], white background, dark ink.  V =
    sides in order: en (l, r), bottom-anchored ("rb" / "lb" at y=size);
    jp (l, r, t, b), centred ("rm" / "lm" / "mb" / "mt" on the midlines).
    """
    chars = list(ADJACENT_CHARS_JP if lang == "jp" else ADJACENT_CHARS_EN)
    try:
        _, covered = get_unicode_coverage_from_ttf(font_path)
        cov = set(covered)
        kept = [c for c in chars if c in cov]
        if kept:
            chars = kept
    except Exception:
        pass  # the coverage probe is best-effort, as in the JAX package
    font = truetype(font_path, size)
    if lang == "jp":
        anchors = [("rm", (size, size // 2)), ("lm", (0, size // 2)),
                   ("mb", (size // 2, size)), ("mt", (size // 2, 0))]
    else:
        anchors = [("rb", (size, size)), ("lb", (0, size))]
    bank = np.full((len(anchors), len(chars), size, size), 255, np.uint8)
    for v, (anchor, xy) in enumerate(anchors):
        for i, c in enumerate(chars):
            imagefont.draw_text(bank[v, i], xy, c, 0, font, anchor=anchor)
    return bank


def paired_chars(dir_paths: Sequence[str], save_path: str, omit: str = "",
                 square: bool = False) -> int:
    """Copy real char crops into the tree as PAIRED_* files; the prefix
    selects the plain transform and the split membership downstream."""
    idx = 0
    for dir_path in dir_paths:
        for fpath in sorted(glob(os.path.join(dir_path, "*.png"))):
            stem = os.path.splitext(os.path.basename(fpath))[0]
            c = stem.split("_")[-1]
            if c.startswith("0x"):
                c = chr(int(c, base=16))
            if c in omit:
                continue
            dst = os.path.join(save_path, str(ord(c)),
                               f"PAIRED_{stem}_{idx}.png")
            if square:
                imaging.save_image(dst, *imaging.resize_picture(
                    imaging.open_image(fpath), (224, 224)))
            else:
                imaging.copy_image(fpath, dst)
            idx += 1
    return idx
