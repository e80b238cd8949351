"""Image fixtures for the port's decoders, and the writers that make them.

    python tests/torch_fixtures/make_images.py [--out DIR]

writes, from a fixed seed, with Pillow and numpy (and the JAX package for
the golden ``_LazyImage`` arrays), into ``tests/torch_fixtures/images/``:

- ``lines/g00.jpg`` .. ``g31.jpg``: 32 synthetic gray text lines as JPEG
  at quality 75, and ``c00.jpg`` .. ``c31.jpg``: 32 RGB lines (dark ink
  on cream paper) at 4:2:0;
- one file per decoder branch (``cases/``): progressive with restart
  markers, 4:4:4, 4:2:2, optimized Huffman tables, CMYK, odd sizes, a
  1x2-sampled file from ``baseline_jpeg``; TIFF group4, group3 2-D, LZW
  with predictor 2, PackBits, Deflate, JPEG, 16-bit gray, big-endian and
  MinIsWhite; BMP at 1, 4, 8 bits, RLE8, RLE4, 16, 24 and 32 bits and a
  V5 header; GIF in L, P, interlaced and with a local palette on a frame
  smaller than its screen;
- ``page/page.jpg`` and ``page/page_g4.tif``: a 2550 x 3300 gray page
  (US letter at 300 dpi) as JPEG and, thresholded, as group4 TIFF;
- ``cases/`` ``LAYOUT_FILES``, from a seed of their own (``--layouts``
  writes only these): TIFF tiles, BigTIFF, separate planes,
  orientations 2-8, 4-bit gray and palette, 16-bit RGB;
- ``samples/`` ``SAMPLE_FILES``, from a seed of their own (``--samples``
  writes only these): TIFF float (predictor 3 too), signed, 12 and
  32-bit samples, extra and associated alpha, PX / PA, 16-bit and
  extra-sample CMYK, YCbCr (one sample, 2x2 and 1x1), CIELab, and JPEG
  segments and CCITT strips and tiles cut inside their byte counts;
- ``golden.npz``: for every file, the SHA-256 digest and shape of
  Pillow's ``convert("RGB")`` and ``convert("L")`` and of the JAX
  package's ``_LazyImage(path, gray).load()`` for gray True and False;
  a conversion Pillow refuses (LAB -> L) is stored as its exception's
  name (``|error``).  Entries are only added: one that a regenerated
  file would change stops the script.

    python tests/torch_fixtures/make_images.py --mode_pages

writes only ``tests/torch_fixtures/mode_pages/`` (beside ``images/``,
whose listing the decoder tests pin): four sets of three en text lines rendered with
Pillow in DejaVu Sans, each with its COCO JSON (char boxes, cat 0, and
each line's ``text``): ``g4`` as group 4 bilevel TIFF, ``palette`` as a
palette PNG with ``tRNS``, ``i16`` as 16-bit gray (I;16) TIFF and ``la``
as gray + alpha PNG; and ``mode_pages/golden.npz``, the ``digest_tree`` of
the crops and the tree the JAX ``format-dataset --spaces
--clip_to_top_and_bottom`` writes over each (``mode_page_argv``).

The writers (``baseline_jpeg``, ``tiff_bytes``, ``tiff_layout``,
``bmp_bytes``, ``gif_bytes``) build files Pillow cannot write: any JPEG
sampling factors, any TIFF tag set and byte order, TIFF strips or tiles
(BigTIFF too) of 1 / 2 / 4 / 8 / 16-bit samples, interleaved or in
planes, under none, PackBits, LZW or Deflate with predictor 2 (numpy and
zlib only, so that chip_smoke.py writes with them where Pillow is not
installed), BMP headers, bitfields and RLE streams, GIF frames with
local palettes and offsets.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "images")
MODE_PAGES_DIR = os.path.join(HERE, "mode_pages")
SEED = 13
N_LINES = 32          # of each kind, gray and RGB
INK = (28, 22, 60)
PAPER = (246, 240, 226)


# ------------------------------------------------------------ content
def synth_line(rng, n=None) -> np.ndarray:
    """chip_smoke.py's printed-line-like gray image: dark strokes in glyph
    boxes, word gaps, heights 36-72 px, ``n`` glyphs (default 4-40)."""
    h = int(rng.integers(36, 73))
    n = int(rng.integers(4, 41)) if n is None else n
    gw = (h * rng.uniform(0.3, 0.7, n)).astype(int) + 2
    gap = np.where(rng.uniform(size=n) < 0.2, h // 2, max(2, h // 10))
    w = int(gw.sum() + gap.sum()) + 2 * (h // 4)
    img = np.full((h, w), 245, np.uint8)
    x = h // 4
    top, bot = h // 6, h - h // 6
    for g, sp in zip(gw, gap):
        for _ in range(int(rng.integers(2, 5))):
            if rng.uniform() < 0.5:
                x0 = x + int(rng.integers(0, max(1, g - 3)))
                img[top:bot, x0:x0 + max(2, h // 12)] = rng.integers(0, 60)
            else:
                y0 = int(rng.integers(top, bot - 2))
                img[y0:y0 + max(2, h // 14), x:x + g] = rng.integers(0, 60)
        x += int(g + sp)
    return img


def colour_line(gray: np.ndarray) -> np.ndarray:
    """A gray line as dark ink on cream paper, RGB."""
    t = (gray.astype(np.float32) / 245.0)[..., None]
    rgb = np.asarray(INK) * (1 - t) + np.asarray(PAPER) * t
    return np.clip(rgb, 0, 255).astype(np.uint8)


def textured(rng, h, w, noise=20.0) -> np.ndarray:
    """RGB with smooth structure and noise, so that quantisation, every
    subsampling filter and the range limit all matter."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(x / 5.0 + c) * np.cos(y / 7.0 - c)
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, noise, (h, w, 3)), 0,
                   255).astype(np.uint8)


def synth_page(rng, h=3300, w=2550) -> np.ndarray:
    """A gray page: synthetic text lines every 64 px within 150 px
    margins, on flat paper."""
    page = np.full((h, w), 245, np.uint8)
    y = 150
    while y + 72 < h - 150:
        line = synth_line(rng, n=int(rng.integers(30, 45)))[:, :w - 300]
        page[y:y + line.shape[0], 150:150 + line.shape[1]] = line
        y += 64
    return page


# ------------------------------------------------------ JPEG writer
def _bits_writer():
    out = bytearray()
    acc = [0, 0]          # value, bit count

    def put(v, n):
        for i in range(n - 1, -1, -1):
            acc[0] = (acc[0] << 1) | ((v >> i) & 1)
            acc[1] += 1
            if acc[1] == 8:
                out.append(acc[0])
                if acc[0] == 0xFF:
                    out.append(0)
                acc[0] = acc[1] = 0

    def flush():
        if acc[1]:
            put((1 << (8 - acc[1])) - 1, 8 - acc[1])
        return bytes(out)

    return put, flush


_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])


def _dct_matrix():
    c = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos(
        (2 * x + 1) * u * np.pi / 16) for x in range(8)] for u in range(8)])
    return c


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


def baseline_jpeg(img: np.ndarray, factors: Sequence[Tuple[int, int]],
                  q: int = 6) -> bytes:
    """A baseline JPEG (SOF0, JFIF) of uint8 [H, W] or [H, W, 3] (taken as
    YCbCr samples) with any sampling factors: each component box-averaged
    to its size, a flat quantization table of ``q``, 4-bit DC codes and
    8-bit AC codes (canonical tables built from the symbols used)."""
    img = img[..., None] if img.ndim == 2 else img
    hh, ww, nc = img.shape
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-ww // (8 * hmax)), -(-hh // (8 * vmax))
    dct = _dct_matrix()
    comps = []
    for c, (fh, fv) in enumerate(factors):
        sx, sy = hmax // fh, vmax // fv
        dw, dh = -(-ww * fh // hmax), -(-hh * fv // vmax)
        plane = img[..., c].astype(np.float64)
        pad = np.pad(plane, ((0, dh * sy - hh), (0, dw * sx - ww)), "edge")
        small = pad.reshape(dh, sy, dw, sx).mean((1, 3))
        bw, bh = (mcux * fh, mcuy * fv) if nc > 1 else (-(-dw // 8),
                                                         -(-dh // 8))
        full = np.pad(small, ((0, bh * 8 - dh), (0, bw * 8 - dw)), "edge")
        blocks = full.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128
        coef = dct @ blocks @ dct.T
        comps.append(np.round(coef / q).astype(np.int32).reshape(
            bh, bw, 64)[..., _ZIGZAG])
    order = []
    if nc == 1:
        for by in range(comps[0].shape[0]):
            for bx in range(comps[0].shape[1]):
                order.append((0, by, bx))
    else:
        for my in range(mcuy):
            for mx in range(mcux):
                for c, (fh, fv) in enumerate(factors):
                    for v in range(fv):
                        for h in range(fh):
                            order.append((c, my * fv + v, mx * fh + h))
    # symbols: DC categories, AC run/size bytes
    pred = [0] * nc
    events = []
    ac_syms = set()
    for c, by, bx in order:
        z = comps[c][by, bx]
        diff = int(z[0]) - pred[c]
        pred[c] = int(z[0])
        ev = [("dc", diff)]
        run = 0
        last = max([k for k in range(1, 64) if z[k]], default=0)
        for k in range(1, last + 1):
            if z[k] == 0:
                run += 1
                continue
            while run > 15:
                ev.append(("ac", 0xF0, 0))
                ac_syms.add(0xF0)
                run -= 16
            s = _category(int(z[k]))
            ev.append(("ac", (run << 4) | s, int(z[k])))
            ac_syms.add((run << 4) | s)
            run = 0
        if last < 63:
            ev.append(("ac", 0x00, 0))
            ac_syms.add(0)
        events.append(ev)
    ac_vals = sorted(ac_syms)
    ac_code = {s: i for i, s in enumerate(ac_vals)}
    put, flush = _bits_writer()

    def value_bits(v, s):
        return v if v >= 0 else v + (1 << s) - 1

    for ev in events:
        for e in ev:
            if e[0] == "dc":
                s = _category(e[1])
                put(s, 4)
                if s:
                    put(value_bits(e[1], s), s)
            else:
                put(ac_code[e[1]], 8)
                s = e[1] & 15
                if s:
                    put(value_bits(e[2], s), s)
    scan = flush()

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                            b"\x00\x00")
    out += seg(0xDB, bytes([0]) + bytes([q] * 64))
    out += seg(0xC0, struct.pack(">BHHB", 8, hh, ww, nc) + b"".join(
        bytes([c + 1, (f[0] << 4) | f[1], 0]) for c, f in enumerate(factors)))
    dc_bits = bytes([0, 0, 0, 12] + [0] * 12)
    out += seg(0xC4, bytes([0x00]) + dc_bits + bytes(range(12)))
    ac_bits = bytes([0] * 7 + [len(ac_vals)] + [0] * 8)
    out += seg(0xC4, bytes([0x10]) + ac_bits + bytes(ac_vals))
    out += seg(0xDA, bytes([nc]) + b"".join(bytes([c + 1, 0x00])
                                           for c in range(nc))
               + bytes([0, 63, 0]))
    return out + scan + b"\xff\xd9"


def drop_refinement_scans(data: bytes) -> bytes:
    """A progressive JPEG with its successive-approximation refinement
    scans (Ah > 0) removed: some coefficient bits are never sent."""
    out = bytearray(data[:2])
    pos = 2
    while pos < len(data):
        m = data[pos + 1]
        if m == 0xD9:
            return bytes(out) + b"\xff\xd9"
        seg = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        end = pos + 2 + seg
        if m == 0xDA:       # the scan runs to the next marker
            q = end
            while not (data[q] == 0xFF and data[q + 1] not in (0,)
                       and not 0xD0 <= data[q + 1] <= 0xD7):
                q += 1
            ns = data[pos + 4]
            ah = data[pos + 4 + 1 + 2 * ns + 2] >> 4
            if ah == 0:
                out += data[pos:q]
            pos = q
            continue
        out += data[pos:end]
        pos = end
    raise ValueError("no EOI")


# ------------------------------------------------------ TIFF writer
_TTYPE = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 7: "B", 11: "f", 16: "Q"}


def tiff_bytes(strips: Sequence[bytes], tags: Dict[int, Tuple[int, list]],
               order: str = "<", big: bool = False,
               tiled: bool = False) -> bytes:
    """A TIFF (or BigTIFF) of the given strips (``tiled``: tiles):
    ``tags`` maps tag -> (type, values) (RATIONAL, type 5: numerator,
    denominator, ...); StripOffsets and StripByteCounts (TileOffsets and
    TileByteCounts) are filled in."""
    e = order
    magic = (b"II" if e == "<" else b"MM") + struct.pack(e + "H",
                                                         43 if big else 42)
    head = magic + (struct.pack(e + "HHQ", 8, 0, 16) if big else
                    struct.pack(e + "I", 8))
    data = bytearray(head)
    offs = []
    for s in strips:
        offs.append(len(data))
        data += s
        if len(data) % 2:
            data += b"\0"
    tags = dict(tags)
    tags[324 if tiled else 273] = (16 if big else 4, offs)
    tags[325 if tiled else 279] = (16 if big else 4, [len(s) for s in strips])
    ifd_at = len(data)
    ent = 20 if big else 12
    inline = 8 if big else 4
    n = len(tags)
    extra_at = ifd_at + (8 if big else 2) + ent * n + (8 if big else 4)
    ifd = bytearray(struct.pack(e + ("Q" if big else "H"), n))
    extra = bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        raw = struct.pack(e + _TTYPE[typ] * len(vals), *vals)
        if len(raw) <= inline:
            field = raw.ljust(inline, b"\0")
        else:
            field = struct.pack(e + ("Q" if big else "I"),
                                extra_at + len(extra))
            extra += raw
            if len(extra) % 2:
                extra += b"\0"
        ifd += struct.pack(e + ("HHQ" if big else "HHI"), tag, typ,
                           len(vals) // (2 if typ == 5 else 1)) + field
    ifd += b"\0" * (8 if big else 4)
    data += ifd + extra
    if big:
        data[8:16] = struct.pack(e + "Q", ifd_at)
    else:
        data[4:8] = struct.pack(e + "I", ifd_at)
    return bytes(data)


def tiff_gray(img: np.ndarray, order="<", photometric=1, bits=8,
              extra_tags=None, rows_per_strip=None) -> bytes:
    """An uncompressed TIFF of one gray plane (8 or 16 bits) or RGB, its
    size in SHORT tags."""
    h, w = img.shape[:2]
    return tiff_layout(img, bits, photometric, order,
                       rows_per_strip=rows_per_strip, extra_tags={
                           256: (3, [w]), 257: (3, [h]), **(extra_tags or {})})


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW: MSB-first codes of 9-12 bits, a Clear first and when the
    table fills, libtiff's early code-width change."""
    out = bytearray()
    acc = nacc = 0

    def put(code, n):
        nonlocal acc, nacc
        acc = (acc << n) | code
        nacc += n
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    def reset():
        return {}, 258, 9

    table, free, nbits = reset()
    put(256, nbits)
    if not data:
        put(257, nbits)
        return bytes(out)
    ent = data[0]
    for c in data[1:]:
        code = table.get((ent, c))
        if code is not None:
            ent = code
            continue
        put(ent, nbits)
        table[(ent, c)] = free
        free += 1
        if free == 4094:
            put(256, nbits)
            table, free, nbits = reset()
        elif free > (1 << nbits) - 1:
            nbits += 1
        ent = c
    put(ent, nbits)
    free += 1
    if free == 4094:
        put(256, nbits)
        nbits = 9
    elif free > (1 << nbits) - 1:
        nbits += 1
    put(257, nbits)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def tiff_compress(raw: bytes, compression: int) -> bytes:
    """One strip or tile's bytes under compression 1 (none), 5 (LZW), 8
    / 32946 (Deflate) or 32773 (PackBits, literal runs)."""
    if compression == 1:
        return raw
    if compression == 5:
        return tiff_lzw(raw)
    if compression in (8, 32946):
        import zlib

        return zlib.compress(raw, 6)
    if compression == 32773:
        return b"".join(bytes([len(raw[i:i + 128]) - 1]) + raw[i:i + 128]
                        for i in range(0, len(raw), 128))
    raise ValueError(f"compression {compression}")


def pack_samples(a: np.ndarray, bits: int, order: str = "<") -> np.ndarray:
    """[rows, cols, spp] unsigned samples -> [rows, row bytes] uint8: 16
    and 32-bit in the byte order, 12-bit and 1 / 2 / 4-bit packed MSB
    first, each row padded to a byte."""
    rows = a.shape[0]
    if bits in (16, 32):
        return a.astype(f"{order}u{bits // 8}").view(np.uint8).reshape(
            rows, -1)
    if bits == 12:
        v = a.reshape(rows, -1).astype(np.uint16)
        n = v.shape[1]
        v = np.concatenate([v, np.zeros((rows, n % 2), np.uint16)], axis=1)
        p = v.reshape(rows, -1, 2)
        out = np.stack([p[..., 0] >> 4, (p[..., 0] & 15) << 4 | p[..., 1] >> 8,
                        p[..., 1] & 255], -1).astype(np.uint8)
        return out.reshape(rows, -1)[:, :(3 * n + 1) // 2]
    v = a.reshape(rows, -1).astype(np.uint8)
    if bits == 8:
        return v
    per = 8 // bits
    v = np.concatenate([v, np.zeros((rows, -v.shape[1] % per), np.uint8)],
                       axis=1)
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    return (v.reshape(rows, -1, per) << shifts).sum(-1).astype(np.uint8)


def float_predict(t: np.ndarray, bits: int, sample_format: int = 3
                  ) -> bytes:
    """libtiff's floating-point predictor (3) of [rows, cols, spp] samples
    of ``bits`` (16 / 32): each row's words as byte planes, most
    significant byte first (the same in either byte order), then each
    byte less the one ``spp`` bytes before it."""
    rows, cols, spp = t.shape
    size = bits // 8
    kind = "<" + "uif"[sample_format - 1] + str(size)
    le = np.ascontiguousarray(t.astype(kind)).view(np.uint8).reshape(
        rows, cols * spp, size)
    planes = le[..., ::-1].transpose(0, 2, 1).reshape(rows, -1)
    out = planes.copy()
    out[:, spp:] -= planes[:, :-spp]
    return out.tobytes()


def ycbcr_encoder(sub: Tuple[int, int], compression: int = 1):
    """``tiff_layout``'s ``encode`` for YCbCr subsampled ``sub`` =
    (horizontal, vertical): each segment's samples (Y, Cb, Cr) as blocks
    of h x v Y values, then the block's top-left Cb and Cr, the segment
    padded to whole blocks by repeating its edge."""
    sh, sv = sub

    def encode(t: np.ndarray) -> bytes:
        rows, cols = t.shape[:2]
        nby, nbx = -(-rows // sv), -(-cols // sh)
        t = np.pad(t, ((0, nby * sv - rows), (0, nbx * sh - cols), (0, 0)),
                   mode="edge").reshape(nby, sv, nbx, sh, 3)
        y = t[..., 0].transpose(0, 2, 1, 3).reshape(nby, nbx, sv * sh)
        blk = np.concatenate([y, t[:, 0, :, 0, 1:]], -1).astype(np.uint8)
        return tiff_compress(blk.tobytes(), compression)

    return encode


def tiff_layout(img: np.ndarray, bits: int = 8, photometric: int = 1,
                order: str = "<", big: bool = False, compression: int = 1,
                predictor: int = 1, planar: int = 1, tile=None,
                rows_per_strip=None, extra_tags=None, encode=None,
                sample_format=None) -> bytes:
    """A TIFF of ``img`` ([H, W] or [H, W, C] samples, each below
    2^bits) in strips of ``rows_per_strip`` rows or, with ``tile`` =
    (width, length), in tiles (the right and bottom edge tiles padded),
    each plane in turn under ``planar`` 2; horizontal differencing under
    ``predictor`` 2 (on the samples' unsigned words), libtiff's
    floating-point predictor under 3. ``sample_format`` (1 unsigned, 2
    signed, 3 IEEE float; None: no SampleFormat tag) is written once per
    sample. ``encode(samples [rows, cols, spp]) -> bytes`` replaces the
    packing and compression (CCITT or JPEG segments from Pillow)."""
    h, w = img.shape[:2]
    a = img if img.ndim == 3 else img[..., None]
    spp = a.shape[2]
    planes = [a] if planar == 1 else [a[..., k:k + 1] for k in range(spp)]
    tw, th = tile if tile else (w, rows_per_strip or h)
    pad = (1 << bits) // 3
    fmt = sample_format or 1
    segs = []
    for p in planes:
        for y in range(0, h, th):
            for x in range(0, w, tw):
                t = p[y:y + th, x:x + tw]
                if tile:
                    t = np.pad(t, ((0, th - t.shape[0]), (0, tw - t.shape[1]),
                                   (0, 0)), constant_values=pad)
                if encode is not None:
                    segs.append(encode(t))
                    continue
                if predictor == 3:
                    segs.append(tiff_compress(float_predict(t, bits, fmt),
                                              compression))
                    continue
                if fmt != 1 or bits in (12, 32):
                    # the samples' words, as unsigned integers
                    size = 1 if bits <= 8 else 2 if bits <= 16 else 4
                    kind = "uif"[fmt - 1] if bits != 12 else "u"
                    t = np.ascontiguousarray(t.astype(f"{kind}{size}")).view(
                        f"u{size}")
                else:
                    t = t.astype(np.uint16 if bits == 16 else np.uint8)
                if predictor == 2:
                    t = t.copy()
                    t[:, 1:] -= t[:, :-1].copy()
                segs.append(tiff_compress(
                    pack_samples(t, bits, order).tobytes(), compression))
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp])}
    if planar != 1:
        tags[284] = (3, [planar])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if sample_format is not None:
        tags[339] = (3, [sample_format] * spp)
    if tile:
        tags[322], tags[323] = (3, [tw]), (3, [th])
    else:
        tags[278] = (3, [th])
    tags.update(extra_tags or {})
    return tiff_bytes(segs, tags, order, big, tiled=bool(tile))


# ------------------------------------------------------- BMP writer
def bmp_bytes(w: int, h: int, bits: int, pixels: bytes, header: int = 40,
              palette: bytes = b"", compression: int = 0,
              masks: Sequence[int] = (), colors: int = 0,
              top_down: bool = False) -> bytes:
    """A BMP: file header, a ``header``-byte info header (12, 40, 108 or
    124; masks inside it from 52 bytes, after a 40-byte one otherwise),
    the palette as given (BGR0 entries, BGR for the 12-byte header), the
    pixel data as given."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, compression, len(pixels), 2835, 2835,
                           colors, 0)
        if header >= 52:
            m = list(masks) + [0] * (4 - len(masks))
            info += struct.pack("<IIII", *m)
        info = info.ljust(header, b"\0")
        if header == 40 and compression == 3:
            info += struct.pack("<III", *masks[:3])
    off = 14 + len(info) + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off)
            + info + palette + pixels)


def bmp_rows(idx: np.ndarray, bits: int) -> bytes:
    """Bottom-up rows of indices / BGR bytes, each padded to 4 bytes."""
    h = idx.shape[0]
    rows = []
    for y in range(h - 1, -1, -1):
        r = idx[y]
        if bits < 8:
            per = 8 // bits
            v = np.concatenate([r, np.zeros(-len(r) % per, np.uint8)])
            b = (v.reshape(-1, per) << np.arange(8 - bits, -1, -bits,
                                                  dtype=np.uint8)).sum(
                -1).astype(np.uint8).tobytes()
        else:
            b = np.ascontiguousarray(r).tobytes()
        rows.append(b + b"\0" * (-len(b) % 4))
    return b"".join(rows)


# ------------------------------------------------------- GIF writer
def gif_lzw(indices: np.ndarray, min_code: int) -> bytes:
    """GIF LZW of a flat index array, packed into data sub-blocks."""
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    codes: List[Tuple[int, int]] = []
    width, nxt = min_code + 1, clear + 2
    table = {bytes([i]): i for i in range(clear)}
    codes.append((clear, width))
    data = indices.astype(np.uint8).tobytes()
    cur = data[:1]
    for b in data[1:]:
        k = cur + bytes([b])
        if k in table:
            cur = k
            continue
        codes.append((table[cur], width))
        table[k] = nxt
        nxt += 1
        if nxt > (1 << width) and width < 12:
            width += 1
        if nxt >= 4093:
            codes.append((clear, width))
            table = {bytes([i]): i for i in range(clear)}
            width, nxt = min_code + 1, clear + 2
        cur = bytes([b])
    codes.append((table[cur], width))
    codes.append((eoi, width))
    out, acc, nbits = bytearray(), 0, 0
    for c, wd in codes:
        acc |= c << nbits
        nbits += wd
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 0xFF)
    blocks = b"".join(bytes([len(out[i:i + 255])]) + bytes(out[i:i + 255])
                      for i in range(0, len(out), 255))
    return bytes([min_code]) + blocks + b"\0"


def gif_bytes(screen: Tuple[int, int], frame: np.ndarray,
              at: Tuple[int, int] = (0, 0), global_pal: np.ndarray = None,
              local_pal: np.ndarray = None, transparency: int = None,
              interlace: bool = False) -> bytes:
    """A one-frame GIF89a: ``frame`` (indices [h, w]) at ``at`` (x, y) on a
    ``screen`` (w, h), with the palettes given ([2**k, 3] uint8)."""
    def table_bits(p):
        return int(np.log2(len(p))) - 1

    sw, sh = screen
    flags = 0
    if global_pal is not None:
        flags = 0x80 | 0x70 | table_bits(global_pal)
    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, flags, 0, 0)
    if global_pal is not None:
        out += global_pal.astype(np.uint8).tobytes()
    if transparency is not None:
        out += b"\x21\xf9\x04" + bytes([1, 0, 0, transparency, 0])
    fh, fw = frame.shape
    fl = 0x40 if interlace else 0
    if local_pal is not None:
        fl |= 0x80 | table_bits(local_pal)
    out += b"," + struct.pack("<HHHHB", at[0], at[1], fw, fh, fl)
    if local_pal is not None:
        out += local_pal.astype(np.uint8).tobytes()
    rows = frame
    if interlace:
        order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                np.arange(2, fh, 4), np.arange(1, fh, 2)])
        rows = frame[order]
    pal = local_pal if local_pal is not None else global_pal
    bits = max(2, table_bits(pal) + 1) if pal is not None else 8
    return out + gif_lzw(rows.reshape(-1), bits) + b";"


# ---------------------------------------------------------- fixtures
def _save(img, path, fmt, **kw) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    im = img if isinstance(img, Image.Image) else Image.fromarray(img)
    im.save(path, fmt, **kw)


def _write(path, data: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def make_files(out: str) -> List[str]:
    """Every fixture file, written under ``out``; their paths relative to
    it."""
    from PIL import Image

    rng = np.random.default_rng(SEED)
    names = []
    for i in range(N_LINES):
        g = synth_line(rng)
        _save(g, os.path.join(out, "lines", f"g{i:02d}.jpg"), "JPEG",
              quality=75)
        names.append(f"lines/g{i:02d}.jpg")
    for i in range(N_LINES):
        c = colour_line(synth_line(rng))
        _save(c, os.path.join(out, "lines", f"c{i:02d}.jpg"), "JPEG",
              quality=75, subsampling=2)
        names.append(f"lines/c{i:02d}.jpg")
    case = os.path.join(out, "cases")
    tex = textured(rng, 45, 77)
    gl = synth_line(rng, n=8)
    jpegs = {
        "progressive_rst.jpg": (tex, dict(progressive=True,
                                          restart_marker_blocks=3)),
        "s444.jpg": (tex, dict(subsampling=0, quality=90)),
        "s422.jpg": (tex, dict(subsampling=1, quality=60)),
        "optimized.jpg": (colour_line(gl), dict(optimize=True)),
        "odd_7x9.jpg": (tex[:9, :7], dict(subsampling=2)),
        "odd_gray_17x15.jpg": (gl[:15, :17], dict(quality=30)),
    }
    for name, (img, kw) in jpegs.items():
        _save(img, os.path.join(case, name), "JPEG", **kw)
        names.append(f"cases/{name}")
    _save(Image.fromarray(tex).convert("CMYK"), os.path.join(
        case, "cmyk.jpg"), "JPEG", quality=80)
    _write(os.path.join(case, "h1v2.jpg"),
           baseline_jpeg(tex, [(1, 2), (1, 1), (1, 1)]))
    names += ["cases/cmyk.jpg", "cases/h1v2.jpg"]
    bw = Image.fromarray(gl).point(lambda v: 255 if v > 128 else 0).convert(
        "1")
    tiffs = {
        "group4.tif": (bw, dict(compression="group4")),
        "group3_2d.tif": (bw, dict(compression="group3",
                                   tiffinfo={292: 1})),
        "lzw_pred.tif": (Image.fromarray(tex), dict(
            compression="tiff_lzw", tiffinfo={317: 2})),
        "packbits.tif": (Image.fromarray(gl), dict(compression="packbits")),
        "deflate.tif": (Image.fromarray(tex).convert("L"), dict(
            compression="tiff_adobe_deflate")),
        "jpeg.tif": (Image.fromarray(tex), dict(compression="jpeg")),
        "gray16.tif": (Image.fromarray((gl.astype(np.uint16) * 3)),
                       dict(compression="tiff_lzw")),
    }
    for name, (im, kw) in tiffs.items():
        _save(im, os.path.join(case, name), "TIFF", **kw)
        names.append(f"cases/{name}")
    _write(os.path.join(case, "mm_miniswhite.tif"),
           tiff_gray(255 - gl, order=">", photometric=0,
                     rows_per_strip=16))
    names.append("cases/mm_miniswhite.tif")
    idx = (gl // 16).astype(np.uint8)
    pal16 = bytes(b for i in range(16) for b in (i * 16, 255 - i * 9, i, 0))
    bmps = {
        "b1.bmp": Image.fromarray(gl).convert("1"),
        "b8.bmp": Image.fromarray(tex).quantize(40),
        "b24.bmp": Image.fromarray(tex),
        "b32_rgba.bmp": Image.fromarray(np.dstack([tex, tex[..., :1]])),
    }
    for name, im in bmps.items():
        _save(im, os.path.join(case, name), "BMP")
        names.append(f"cases/{name}")
    h, w = idx.shape
    _write(os.path.join(case, "b4.bmp"), bmp_bytes(
        w, h, 4, bmp_rows(idx, 4), palette=pal16))
    _write(os.path.join(case, "rle8.bmp"), bmp_bytes(
        12, 6, 8, rle8_stream(), palette=pal16 * 16, compression=1))
    c16 = ((tex[..., 0] >> 3).astype(np.uint16) << 11 | (
        tex[..., 1] >> 2).astype(np.uint16) << 5 | tex[..., 2] >> 3)
    _write(os.path.join(case, "b16_565.bmp"), bmp_bytes(
        tex.shape[1], tex.shape[0], 16, bmp_rows(c16.astype("<u2").view(
            np.uint8).reshape(tex.shape[0], -1), 8), compression=3,
        masks=(0xF800, 0x7E0, 0x1F)))
    _write(os.path.join(case, "v5_topdown.bmp"), bmp_bytes(
        tex.shape[1], tex.shape[0], 32, np.dstack(
            [tex[..., ::-1], tex[..., :1]]).tobytes(), header=124,
        compression=3, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
        top_down=True))
    names += ["cases/b4.bmp", "cases/rle8.bmp", "cases/b16_565.bmp",
              "cases/v5_topdown.bmp"]
    _save(Image.fromarray(gl), os.path.join(case, "gray.gif"), "GIF",
          interlace=False)
    _save(Image.fromarray(tex).quantize(60), os.path.join(case, "p.gif"),
          "GIF", interlace=False)
    _save(Image.fromarray(tex).quantize(60), os.path.join(
        case, "p_interlaced.gif"), "GIF", interlace=True)
    gpal = rng.integers(0, 256, (8, 3)).astype(np.uint8)
    lpal = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    frame = rng.integers(0, 16, (20, 30)).astype(np.uint8)
    _write(os.path.join(case, "local_palette_offset.gif"), gif_bytes(
        (50, 40), frame, at=(7, 5), global_pal=gpal, local_pal=lpal,
        transparency=3, interlace=True))
    names += ["cases/gray.gif", "cases/p.gif", "cases/p_interlaced.gif",
              "cases/local_palette_offset.gif"]
    page = synth_page(rng)
    _save(page, os.path.join(out, "page", "page.jpg"), "JPEG", quality=75)
    _save(Image.fromarray(page).point(lambda v: 255 if v > 128 else 0)
          .convert("1"), os.path.join(out, "page", "page_g4.tif"), "TIFF",
          compression="group4")
    names += ["page/page.jpg", "page/page_g4.tif"]
    return names + make_layout_files(out) + make_sample_files(out)


# the TIFF layouts archive scans come in, written by ``tiff_layout`` from
# a seed of their own, so that adding them left every other file as it was
LAYOUT_SEED = 31
LAYOUT_FILES = tuple(f"cases/{n}.tif" for n in (
    "tile_raw", "tile_lzw_pred_mm", "tile_deflate", "tile_jpeg_ycbcr",
    "bigtiff_strips", "bigtiff_tiles", "planar_rgb", "planar_rgb_pred_mm",
    "gray4", "gray4_miniswhite", "palette4", "rgb16", "rgb16_mm",
    *(f"orient{o}" for o in range(2, 9))))


def pillow_segment(t: np.ndarray, mode: str, tiffinfo=None,
                   **kw) -> Tuple[bytes, dict]:
    """The one strip of a TIFF Pillow writes of samples ``t`` [rows,
    cols, spp] in ``mode`` (``kw``: its save options; ``tiffinfo``: tags
    for its encoder, such as T4Options), and its tags."""
    import io

    from PIL import Image

    im = Image.fromarray(t[..., 0] if t.shape[2] == 1 else t)
    buf = io.BytesIO()
    im.convert(mode).save(buf, "TIFF",
                          tiffinfo={278: t.shape[0], **(tiffinfo or {})},
                          **kw)
    data = buf.getvalue()
    with Image.open(io.BytesIO(data)) as f:
        tags = dict(f.tag_v2)
    (off,), (cnt,) = tags[273], tags[279]
    return data[off:off + cnt], tags


def jpeg_tiled(img: np.ndarray, tile=(16, 16), mode: str = "YCbCr",
               **kw) -> bytes:
    """JPEG tiles sharing one ``JPEGTables`` (Pillow's libtiff encoder,
    one tile at a time): RGB samples as photometric YCbCr (``mode``
    YCbCr) or RGB, gray as MinIsBlack."""
    tags = []

    def encode(t):
        seg, tg = pillow_segment(t, mode, compression="jpeg")
        tags.append(tg)
        return seg

    photo = {"YCbCr": 6, "RGB": 2, "L": 1}[mode]
    tiff_layout(img, photometric=photo, compression=7, tile=tile,
                encode=encode)
    extra = {347: (7, list(tags[0][347]))}
    assert all(t[347] == tags[0][347] for t in tags), "JPEGTables differ"
    if mode == "YCbCr":
        extra[530] = (3, list(tags[0][530]))
    extra.update(kw.pop("extra_tags", {}))
    return tiff_layout(img, photometric=photo, compression=7, tile=tile,
                       encode=encode, extra_tags=extra, **kw)


def make_layout_files(out: str) -> List[str]:
    """``LAYOUT_FILES``, written under ``out``: tiles (raw, LZW with
    predictor 2 big-endian, Deflate, JPEG YCbCr), BigTIFF strips and
    tiles, separate planes with and without predictor 2, 4-bit gray in
    both photometrics, a 4-bit palette, 16-bit RGB in both byte orders,
    and orientations 2-8 of one gray line; each a few KB, 37 x 61 (the
    line 36-72 rows) so that edge tiles are padded."""
    rng = np.random.default_rng(LAYOUT_SEED)
    tex = textured(rng, 37, 61)
    gray = tex[..., 1]
    tex16 = (tex.astype(np.uint16) << 8) | rng.integers(0, 256, tex.shape,
                                                         np.uint16)
    cmap = list(rng.integers(0, 65536, 48))
    line = synth_line(rng, n=10)
    files = {
        "tile_raw": tiff_layout(gray, tile=(16, 16)),
        "tile_lzw_pred_mm": tiff_layout(tex, photometric=2, order=">",
                                        compression=5, predictor=2,
                                        tile=(32, 16)),
        "tile_deflate": tiff_layout(gray, compression=8, tile=(16, 32)),
        "tile_jpeg_ycbcr": jpeg_tiled(tex),
        "bigtiff_strips": tiff_layout(gray, big=True, compression=32773,
                                      rows_per_strip=8),
        "bigtiff_tiles": tiff_layout(tex, photometric=2, big=True,
                                     compression=5, predictor=2,
                                     tile=(16, 16)),
        "planar_rgb": tiff_layout(tex, photometric=2, planar=2,
                                  rows_per_strip=10),
        "planar_rgb_pred_mm": tiff_layout(tex, photometric=2, order=">",
                                          planar=2, compression=8,
                                          predictor=2, rows_per_strip=10),
        "gray4": tiff_layout(gray >> 4, bits=4, compression=5),
        "gray4_miniswhite": tiff_layout(gray >> 4, bits=4, photometric=0),
        "palette4": tiff_layout(gray >> 4, bits=4, photometric=3,
                                compression=32773,
                                extra_tags={320: (3, cmap)}),
        "rgb16": tiff_layout(tex16, bits=16, photometric=2, compression=5,
                             predictor=2, rows_per_strip=9),
        "rgb16_mm": tiff_layout(tex16, bits=16, photometric=2, order=">"),
    }
    for o in range(2, 9):
        files[f"orient{o}"] = tiff_layout(line, compression=5,
                                          rows_per_strip=16,
                                          extra_tags={274: (3, [o])})
    for name in LAYOUT_FILES:
        _write(os.path.join(out, name), files[name[6:-4]])
    return list(LAYOUT_FILES)


# the TIFF sample layouts Pillow 12.1 opens beyond 8 / 16-bit unsigned
# ones, written by ``tiff_layout`` from a seed of their own
SAMPLE_SEED = 47
SAMPLE_FILES = tuple(f"samples/{n}.tif" for n in (
    "float_lzw_pred3", "float_mm_deflate_pred3_tiles", "float_mm_raw",
    "float_miniswhite_planes", "int32_lzw_pred", "int32_mm_lzw",
    "int16_mm_raw", "uint32_tiles", "gray12_lzw", "gray16_miniswhite",
    "int8_deflate", "rgba_assoc_lzw", "rgba_unspecified", "rgbx_tiles",
    "rgbax_planes_tiles", "rgba16_assoc_mm", "pa_lzw", "px", "cmyk16_mm",
    "cmykxx", "ycbcr_gray", "lab_lzw", "lab_planes", "jpeg_cut_strip",
    "jpeg_cut_tile", "ycbcr_22_lzw", "ycbcr_11_tiles", "g4_cut_strips",
    "g4_cut_tile", "g3_2d_cut_strips"))


def cut_segment(data: bytes, frac: float) -> bytes:
    """A TIFF (``tiff_layout``'s) with its last strip or tile cut to
    ``frac`` of its bytes, the byte count saying so."""
    e = "<" if data[:2] == b"II" else ">"
    off = struct.unpack(e + "I", data[4:8])[0]
    n = struct.unpack(e + "H", data[off:off + 2])[0]
    tags = {}
    for i in range(n):
        p = off + 2 + 12 * i
        tag, typ, cnt = struct.unpack(e + "HHI", data[p:p + 8])
        size = struct.calcsize(_TTYPE[typ]) * cnt
        raw = data[p + 8:p + 8 + size] if size <= 4 else data[
            struct.unpack(e + "I", data[p + 8:p + 12])[0]:][:size]
        tags[tag] = (typ, list(struct.unpack(e + _TTYPE[typ] * cnt, raw)))
    tiled = 324 in tags
    offs, counts = tags.pop(324 if tiled else 273), tags.pop(
        325 if tiled else 279)
    segs = [data[o:o + c] for o, c in zip(offs[1], counts[1])]
    segs[-1] = segs[-1][:int(len(segs[-1]) * frac)]
    return tiff_bytes(segs, tags, e, tiled=tiled)


def make_sample_files(out: str) -> List[str]:
    """``SAMPLE_FILES``, written under ``out``, 23 x 41 (edge tiles
    padded): NaN, infinities and -0.0 among the float samples."""
    rng = np.random.default_rng(SAMPLE_SEED)
    hw = (23, 41)
    tex = textured(rng, *hw)
    fl = rng.normal(120, 140, hw).astype(np.float32)
    fl[0, :8] = [np.nan, np.inf, -np.inf, -0.0, 1e30, 254.99, 0.5, -3.7]

    def ints(lo, hi, c=None):
        return rng.integers(lo, hi, hw + ((c,) if c else ()), np.int64)

    alpha = np.concatenate([[0, 255, 1, 128], ints(0, 256)[0, 4:]])
    assoc = np.dstack([tex, ints(0, 256)])
    assoc[0, :, 3] = alpha
    assoc[..., :3] = assoc[..., :3] * assoc[..., 3:] // 255
    cmap = {320: (3, list(rng.integers(0, 65536, 768)))}

    def ex(*v):
        return {338: (3, list(v))}

    bw = (tex[..., 1] > 128).astype(np.uint8)

    def fax(name, info=None):
        return lambda t: pillow_segment(t * 255, "1", tiffinfo=info,
                                        compression=name)[0]

    files = {
        "float_lzw_pred3": tiff_layout(fl, bits=32, sample_format=3,
                                       compression=5, predictor=3),
        "float_mm_deflate_pred3_tiles": tiff_layout(
            fl, bits=32, sample_format=3, order=">", compression=8,
            predictor=3, tile=(16, 16)),
        "float_mm_raw": tiff_layout(fl, bits=32, sample_format=3, order=">",
                                    rows_per_strip=8),
        "float_miniswhite_planes": tiff_layout(
            fl, bits=32, sample_format=3, photometric=0, planar=2),
        "int32_lzw_pred": tiff_layout(ints(-2**31, 2**31), bits=32,
                                      sample_format=2, compression=5,
                                      predictor=2),
        "int32_mm_lzw": tiff_layout(ints(-300, 300), bits=32,
                                    sample_format=2, order=">",
                                    compression=5),
        "int16_mm_raw": tiff_layout(ints(-400, 400), bits=16,
                                    sample_format=2, order=">"),
        "uint32_tiles": tiff_layout(ints(0, 2**32), bits=32, tile=(16, 16)),
        "gray12_lzw": tiff_layout(ints(0, 4096), bits=12, compression=5),
        "gray16_miniswhite": tiff_layout(ints(0, 600), bits=16,
                                         photometric=0),
        "int8_deflate": tiff_layout(ints(-128, 128), sample_format=2,
                                    compression=8),
        "rgba_assoc_lzw": tiff_layout(assoc, photometric=2, compression=5,
                                      extra_tags=ex(1)),
        "rgba_unspecified": tiff_layout(np.dstack([tex, ints(0, 256)]),
                                        photometric=2),
        "rgbx_tiles": tiff_layout(np.dstack([tex, ints(0, 256)]),
                                  photometric=2, compression=32773,
                                  tile=(16, 16), extra_tags=ex(0)),
        "rgbax_planes_tiles": tiff_layout(
            np.dstack([tex, ints(0, 256, 2)]), photometric=2, planar=2,
            compression=8, tile=(16, 16), extra_tags=ex(2, 0)),
        "rgba16_assoc_mm": tiff_layout(
            (assoc.astype(np.uint16) << 8) | ints(0, 256, 4), bits=16,
            photometric=2, order=">", compression=5, predictor=2,
            extra_tags=ex(1)),
        "pa_lzw": tiff_layout(np.dstack([ints(0, 256), ints(0, 256)]),
                              photometric=3, compression=5,
                              extra_tags={**ex(2), **cmap}),
        "px": tiff_layout(np.dstack([ints(0, 256), ints(0, 256)]),
                          photometric=3, extra_tags={**ex(0), **cmap}),
        "cmyk16_mm": tiff_layout(ints(0, 65536, 4), bits=16, photometric=5,
                                 order=">", compression=8, predictor=2),
        "cmykxx": tiff_layout(ints(0, 256, 6), photometric=5,
                              compression=5, extra_tags=ex(0, 0)),
        "ycbcr_gray": tiff_layout(tex[..., 1], photometric=6,
                                  rows_per_strip=8),
        "lab_lzw": tiff_layout(ints(0, 256, 3), photometric=8,
                               compression=5),
        "lab_planes": tiff_layout(ints(0, 256, 3), photometric=8, planar=2,
                                  tile=(16, 16)),
        "jpeg_cut_strip": cut_segment(jpeg_tiled(tex, tile=(48, 32)), 0.4),
        "jpeg_cut_tile": cut_segment(jpeg_tiled(tex[..., 0], mode="L"),
                                     0.6),
        "ycbcr_22_lzw": tiff_layout(
            tex, photometric=6, compression=5, rows_per_strip=10,
            encode=ycbcr_encoder((2, 2), 5), extra_tags={530: (3, [2, 2])}),
        "ycbcr_11_tiles": tiff_layout(
            tex, photometric=6, compression=8, tile=(16, 16),
            extra_tags={530: (3, [1, 1])}),
        # CCITT segments cut inside their byte counts (the last strip or
        # tile at half its bytes), Pillow's encoder's data
        "g4_cut_strips": cut_segment(tiff_layout(
            bw, bits=1, compression=4, rows_per_strip=8,
            encode=fax("group4")), 0.5),
        "g4_cut_tile": cut_segment(tiff_layout(
            bw, bits=1, compression=4, tile=(16, 16),
            encode=fax("group4")), 0.5),
        "g3_2d_cut_strips": cut_segment(tiff_layout(
            bw, bits=1, compression=3, rows_per_strip=8,
            extra_tags={292: (4, [1])}, encode=fax("group3", {292: 1})),
            0.5),
    }
    for name in SAMPLE_FILES:
        _write(os.path.join(out, name), files[name[8:-4]])
    return list(SAMPLE_FILES)


def rle8_stream() -> bytes:
    """12 x 6 RLE8 pixels with every escape (bottom row first): encoded
    runs, an absolute run of odd length (word-padded), a delta (as Pillow
    reads it: two bytes skipped, then right and up), end-of-line after
    each row (Pillow's decoder clips runs past the row until one comes),
    and end-of-bitmap."""
    eol = [0, 0]
    s = [4, 7, 0, 3, 1, 2, 3, 0, 5, 9] + eol               # row 0
    s += [12, 200] + eol                                   # row 1
    s += [3, 40, 0, 2, 0, 0, 2, 0, 7, 41] + eol            # row 2: delta
    s += [0, 12] + list(range(100, 112)) + eol             # row 3
    s += [6, 1, 6, 2] + eol                                # row 4
    s += [5, 3] + eol                                      # row 5: EOL pads
    return bytes(s + [0, 1])


def rle4_stream() -> bytes:
    """10 x 4 RLE4 pixels: encoded runs of alternating nibbles, absolute
    runs of odd and even length, end-of-line padding, end-of-bitmap."""
    eol = [0, 0]
    s = [5, 0x12, 0, 5, 0x34, 0x56, 0x70, 0] + eol         # row 0
    s += [10, 0xAB] + eol                                  # row 1
    s += [0, 4, 0xCD, 0xEF, 3, 0x11] + eol                 # row 2: pad
    s += [2, 0x9F, 0, 6, 0x12, 0x34, 0x56, 0] + eol        # row 3
    return bytes(s + [0, 1])


def digest(a: np.ndarray) -> np.ndarray:
    return np.frombuffer(hashlib.sha256(
        np.ascontiguousarray(a).tobytes()).digest(), np.uint8)


def golden_arrays(path: str) -> Dict[str, np.ndarray]:
    """Pillow's RGB and L conversions and the JAX ``_LazyImage`` arrays of
    one file: {kind: array}."""
    from PIL import Image

    from effocr_tpu.pipelines.infer import _LazyImage

    out = {}
    with Image.open(path) as im:
        for kind, mode in (("rgb", "RGB"), ("l", "L")):
            try:
                out[kind] = np.asarray(im.convert(mode))
            except ValueError as err:       # LAB -> L
                out[kind] = type(err).__name__
    out["lazy_gray"] = _LazyImage(path, gray=True).load()
    out["lazy_rgb"] = _LazyImage(path, gray=False).load()
    return out


def golden_entry(name: str, arrays: Dict[str, np.ndarray]
                 ) -> Dict[str, np.ndarray]:
    out = {}
    for kind, a in arrays.items():
        if isinstance(a, str):
            out[f"{name}|{kind}|error"] = np.asarray(a)
            continue
        out[f"{name}|{kind}|sha256"] = digest(a)
        out[f"{name}|{kind}|shape"] = np.asarray(a.shape, np.int64)
    return out


# ---------------------------------------------------- mode pages
MODE_PAGES = ("g4", "palette", "i16", "la")
MODE_PAGE_FORMAT = ["--cat_id", "0", "--spaces", "--clip_to_top_and_bottom"]
_WORDS = ("Quick", "brown", "fox", "jumps", "over", "lazy", "dogs", "42",
          "times", "(again)", "&", "then", "7.5%", "more;", "WAX", "kept",
          "vigil,", "ZEBRA", "#19", "quiz!", "$80", "yes/no", "[x]", "hi?")


def render_mode_lines(seed: int, n: int = 3):
    """``n`` gray text lines (DejaVu Sans at 28 px): [(uint8 [h, w], text,
    [[x, y, w, h] per non-space char])]."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.truetype(os.path.join(HERE, "fonts", "DejaVuSans.ttf"),
                              28)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        words = [_WORDS[i] for i in rng.choice(len(_WORDS), 5, False)]
        text = " ".join(words)
        w = int(font.getlength(text)) + 16
        im = Image.new("L", (w, 40), 236)
        d = ImageDraw.Draw(im)
        x, boxes = 8.0, []
        for c in text:
            if c != " ":
                d.text((x, 4), c, fill=int(rng.integers(10, 60)), font=font)
                l, t, r, b = d.textbbox((x, 4), c, font=font)
                boxes.append([float(l), float(t), float(r - l),
                              float(b - t)])
            x += font.getlength(c)
        out.append((np.asarray(im), text, boxes))
    return out


def _mode_page_image(kind: str, gray: np.ndarray, rng):
    """(Pillow image, extension, save keywords) of one line in a page's
    mode."""
    from PIL import Image

    if kind == "g4":
        return (Image.fromarray(gray).point(lambda v: 255 if v > 140 else 0)
                .convert("1"), ".tif", {"compression": "group4"})
    if kind == "palette":
        levels = np.array([236, 180, 120, 60, 20], np.int64)
        idx = np.abs(gray[..., None].astype(np.int64) - levels).argmin(-1)
        im = Image.fromarray(idx.astype(np.uint8), "P")
        pal = [236, 230, 214, 170, 160, 190, 110, 90, 140, 50, 40, 90, 15,
               10, 40]
        im.putpalette(pal)
        return im, ".png", {"transparency": 0}
    if kind == "i16":
        v = gray.astype(np.int64) * 257 + rng.integers(0, 200, gray.shape)
        return (Image.fromarray(np.minimum(v, 65535).astype(np.uint16)),
                ".tif", {})
    alpha = np.where(gray < 200, 255, 96 + (gray % 64)).astype(np.uint8)
    return Image.merge("LA", (Image.fromarray(gray),
                              Image.fromarray(alpha))), ".png", {}


def make_mode_pages(out: str) -> None:
    """<out>/<page>/images/*, <out>/<page>/coco.json for each page."""
    for p, kind in enumerate(MODE_PAGES):
        d = os.path.join(out, kind)
        os.makedirs(os.path.join(d, "images"), exist_ok=True)
        rng = np.random.default_rng(100 + p)
        coco = {"images": [], "annotations": [],
                "categories": [{"id": 0, "name": "char"}]}
        for i, (gray, text, boxes) in enumerate(render_mode_lines(100 + p)):
            im, ext, kw = _mode_page_image(kind, gray, rng)
            name = f"{kind}_{i}{ext}"
            im.save(os.path.join(d, "images", name), **kw)
            coco["images"].append({"id": i + 1, "file_name": name,
                                   "width": gray.shape[1],
                                   "height": gray.shape[0], "text": text})
            for b in boxes:
                coco["annotations"].append({
                    "id": len(coco["annotations"]) + 1, "image_id": i + 1,
                    "category_id": 0, "bbox": b})
        with open(os.path.join(d, "coco.json"), "w") as f:
            json.dump(coco, f, indent=1)


def mode_page_argv(page: str, work: str, pages: str = None) -> List[str]:
    """``format-dataset`` flags over one mode page into ``work`` (crops/,
    tree/; an empty font dir and a charset dir of the page's characters
    made there)."""
    d = os.path.join(pages or MODE_PAGES_DIR, page)
    with open(os.path.join(d, "coco.json")) as f:
        chars = sorted({c for im in json.load(f)["images"]
                        for c in im["text"] if c != " "})
    fonts, charsets = os.path.join(work, "fonts"), os.path.join(
        work, "charsets_eng")
    os.makedirs(fonts, exist_ok=True)
    os.makedirs(charsets, exist_ok=True)
    with open(os.path.join(charsets, "eng_chars.txt"), "w") as f:
        f.write("\n".join(f"{ord(c)}\t{c}" for c in chars))
    return ["--image_dir", os.path.join(d, "images"), "--coco_jsons",
            os.path.join(d, "coco.json"), "--crops_save_dir",
            os.path.join(work, "crops"), "--font_dir", fonts,
            "--charset_dir", charsets, "--dataset_save_dir",
            os.path.join(work, "tree"), *MODE_PAGE_FORMAT]


def mode_page_goldens(out: str) -> None:
    """The JAX ``format-dataset`` over each page: <out>/golden.npz."""
    import tempfile

    from effocr_tpu.cli import format_dataset
    from effocr_torch.data.imaging import digest_tree

    golden = {}
    for page in MODE_PAGES:
        work = tempfile.mkdtemp()
        old = sys.argv
        sys.argv = ["format-dataset"] + mode_page_argv(page, work, out)
        try:
            format_dataset.main()
        finally:
            sys.argv = old
        golden[f"{page}|tree"] = np.array(digest_tree(os.path.join(work,
                                                                   "tree")))
        golden[f"{page}|crops"] = np.array(digest_tree(os.path.join(
            work, "crops")))
    np.savez(os.path.join(out, "golden.npz"), **golden)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=OUT)
    p.add_argument("--mode_pages", action="store_true",
                   help="write only the page fixtures in 1, P, I;16 and LA "
                        "(into --out, default tests/torch_fixtures/"
                        "mode_pages) and their golden.npz")
    p.add_argument("--layouts", action="store_true",
                   help="write only LAYOUT_FILES and add their entries to "
                        "golden.npz")
    p.add_argument("--samples", action="store_true",
                   help="write only SAMPLE_FILES and add their entries to "
                        "golden.npz")
    args = p.parse_args(argv)
    if args.mode_pages:
        out = MODE_PAGES_DIR if args.out == OUT else args.out
        make_mode_pages(out)
        mode_page_goldens(out)
        print(f"{len(MODE_PAGES)} mode pages -> {out}")
        return 0
    names = (make_layout_files(args.out) if args.layouts
             else make_sample_files(args.out) if args.samples
             else make_files(args.out))
    # entries are added, never rewritten: a file that decodes otherwise
    # than its golden entry says stops the script
    path = os.path.join(args.out, "golden.npz")
    golden = dict(np.load(path)) if os.path.exists(path) else {}
    for name in names:
        for key, v in golden_entry(name, golden_arrays(
                os.path.join(args.out, name))).items():
            if key in golden and not np.array_equal(golden[key], v):
                raise SystemExit(f"{key} differs from golden.npz")
            golden.setdefault(key, v)
    np.savez_compressed(path, **golden)
    total = sum(os.path.getsize(os.path.join(r, f))
                for r, _, fs in os.walk(args.out) for f in fs)
    print(f"{len(names)} files + golden.npz, {total} bytes in {args.out}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    sys.exit(main())
