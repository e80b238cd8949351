"""BMP reader: the pixels and mode Pillow 12's BMP plugin gives.

Headers ``BITMAPCOREHEADER`` (12 bytes), ``INFO`` (40, and 52 / 56 /
64), ``V4`` (108) and ``V5`` (124); bottom-up and top-down rows.

- 1, 4 and 8 bits: a palette (``P``), or, as Pillow decides, ``1`` for
  a two-entry black / white palette and ``L`` for a palette that is the
  grey ramp 0, 1, 2, ...;
- RLE8 and RLE4, with Pillow's reading of the escape codes: a delta
  skips two bytes and then reads its (right, up) pair, as Pillow's
  ``BmpRleDecoder`` does;
- 16 bits (5-5-5, or the 5-6-5 / 5-5-5 bitfields), 24 bits, and 32
  bits with any of Pillow's byte-aligned bitfield layouts (``RGBA``
  where the layout has an alpha mask, ``RGB`` otherwise).

Other depths, compressions (JPEG, PNG) and bitfield layouts raise
``NotImplementedError`` naming them.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from effocr_torch.native import imgdec

MAGIC = b"BM"

# bitfield layouts Pillow reads -> channel order of the masks' bytes
_MASKS_32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
    (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0),
}
_MASKS_16 = {(0xF800, 0x7E0, 0x1F): (5, 6, 5),
             (0x7C00, 0x3E0, 0x1F): (5, 5, 5)}


def refuse(what: str) -> NotImplementedError:
    return NotImplementedError(f"BMP uses {what}; {imgdec.ROADMAP_HINT}")


def _info(data: bytes) -> dict:
    if not data.startswith(MAGIC) or len(data) < 18:
        raise OSError("BMP: image file is truncated (file header)")
    offset = struct.unpack("<I", data[10:14])[0]
    hsize = struct.unpack("<I", data[14:18])[0]
    if hsize < 12:
        raise OSError(f"BMP: bad info header size {hsize}")
    hd = data[18:14 + hsize]
    if len(hd) < hsize - 4:
        raise OSError("BMP: image file is truncated (info header)")
    pos = 14 + hsize
    f = {"offset": offset, "header_size": hsize, "top_down": False,
         "compression": 0, "colors": 0}
    if hsize == 12:
        f["width"], f["height"], _, f["bits"] = struct.unpack("<HHHH", hd[:8])
        f["palette_padding"] = 3
    elif hsize in (40, 52, 56, 64, 108, 124):
        f["top_down"] = hd[7] == 0xFF
        w, hraw = struct.unpack("<II", hd[:8])
        f["width"] = w
        f["height"] = 2 ** 32 - hraw if f["top_down"] else hraw
        _, f["bits"], f["compression"] = struct.unpack("<HHI", hd[8:16])
        f["colors"] = struct.unpack("<I", hd[28:32])[0]
        f["palette_padding"] = 4
        if f["compression"] == 3:
            if len(hd) >= 48:
                n = 4 if len(hd) >= 52 else 3
                masks = struct.unpack("<" + "I" * n, hd[36:36 + 4 * n])
            else:
                masks = struct.unpack("<III", data[pos:pos + 12])
                pos += 12
            f["masks"] = tuple(masks) + (0,) * (4 - len(masks))
    else:
        raise refuse(f"an info header of {hsize} bytes")
    f["colors"] = f["colors"] or (1 << f["bits"])
    if offset == 14 + hsize and f["bits"] <= 8:
        f["offset"] = offset + 4 * f["colors"]
    f["palette_at"] = pos
    return f


def _mode(f: dict, data: bytes) -> Tuple[str, Optional[np.ndarray]]:
    bits, comp = f["bits"], f["compression"]
    if bits not in (1, 4, 8, 16, 24, 32):
        raise refuse(f"{bits} bits a pixel")
    if comp not in (0, 1, 2, 3):
        raise refuse({4: "JPEG compression", 5: "PNG compression"}.get(
            comp, f"compression {comp}"))
    if comp == 3:
        if bits == 32 and f["masks"] in _MASKS_32:
            return ("RGBA" if f["masks"][3] or not any(f["masks"])
                    else "RGB"), None
        if bits == 16 and f["masks"][:3] in _MASKS_16:
            return "RGB", None
        if bits == 24 and f["masks"][:3] == (0xFF0000, 0xFF00, 0xFF):
            return "RGB", None
        raise refuse(f"the bitfield layout {[hex(m) for m in f['masks']]} "
                     f"at {bits} bits")
    if comp in (1, 2) and bits != (8 if comp == 1 else 4):
        raise refuse(f"RLE{8 if comp == 1 else 4} at {bits} bits a pixel")
    if bits > 8:
        return "RGB", None
    colors, pad = f["colors"], f["palette_padding"]
    if not 0 < colors <= 65536:
        raise OSError(f"BMP: palette of {colors} colours")
    raw = data[f["palette_at"]:f["palette_at"] + pad * colors]
    if len(raw) < pad * colors:
        raise OSError("BMP: image file is truncated (palette)")
    pal = np.frombuffer(raw, np.uint8).reshape(colors, pad)[:, 2::-1]
    ramp = [0, 255] if colors == 2 else range(colors)
    if all((pal[i] == v).all() for i, v in enumerate(ramp)):
        if colors == 2:
            if comp:
                raise refuse("RLE with a black and white palette")
            return "1", None
        if bits != 8:
            raise refuse(f"a grey palette at {bits} bits a pixel")
        return "L", None
    return "P", np.ascontiguousarray(pal[:256])


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """Pillow's BmpRleDecoder: flat indices of ``w * h`` pixels, rows in
    file order."""
    out = bytearray()
    need, x, n = w * h, 0, len(data)
    while len(out) < need:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, w - x)) if x + count > w else count
            if rle4:
                pair = (byte >> 4, byte & 15)
                out += bytes(pair[i % 2] for i in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:             # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:             # end of bitmap
            break
        elif byte == 2:             # delta: Pillow reads 4 bytes
            if pos + 4 > n:
                break
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * w)
            x = len(out) % w
        else:                       # absolute run
            nb = byte // 2 if rle4 else byte
            run = data[pos:pos + nb]
            pos += nb
            if rle4:
                out += bytes(v for b in run for v in (b >> 4, b & 15))
            else:
                out += run
            if len(run) < nb:
                break
            x += byte
            pos += pos % 2          # word alignment, in file offsets
    if len(out) < need:
        raise OSError("BMP: not enough image data in the RLE stream")
    return np.frombuffer(bytes(out[:need]), np.uint8)


def bmp_header(data: bytes) -> Tuple[int, int, str]:
    """(h, w, Pillow's mode)."""
    f = _info(data)
    mode, _ = _mode(f, data)
    return f["height"], f["width"], mode


def decode(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """BMP bytes -> (pixels, mode, palette): uint8 [H, W] for ``1`` (0 /
    255), ``L`` and ``P`` (palette [n, 3], the file's n colours, as
    Pillow keeps them), [H, W, 3 | 4] for ``RGB`` /
    ``RGBA``."""
    f = _info(data)
    mode, palette = _mode(f, data)
    w, h, bits, comp = f["width"], f["height"], f["bits"], f["compression"]
    off = f["offset"]
    if comp in (1, 2):
        px = _rle(data, off, w, h, comp == 2).reshape(h, w)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        raw = data[off:off + stride * h]
        if len(raw) < stride * h:
            raise OSError("BMP: image file is truncated (pixel data)")
        rows = np.frombuffer(raw, np.uint8).reshape(h, stride)
        px = _unpack(rows, w, bits, f, mode)
    if not f["top_down"]:
        px = px[::-1]
    return np.ascontiguousarray(px), mode, palette


def _unpack(rows: np.ndarray, w: int, bits: int, f: dict, mode: str
            ) -> np.ndarray:
    if bits < 8:
        v = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, bits)
        idx = (v * (1 << np.arange(bits - 1, -1, -1, dtype=np.uint8))).sum(
            -1, dtype=np.uint8)[:, :w]
        return idx * np.uint8(255) if mode == "1" else idx
    if bits == 8:
        return rows[:, :w]
    if bits == 16:
        v = rows[:, :2 * w].copy().view("<u2").astype(np.uint32)
        rgb = _MASKS_16.get(f.get("masks", (0x7C00, 0x3E0, 0x1F))[:3])
        shifts = (rgb[1] + rgb[2], rgb[2], 0)
        return np.stack([((v >> s) & ((1 << b) - 1)) * 255 // ((1 << b) - 1)
                         for s, b in zip(shifts, rgb)], -1).astype(np.uint8)
    px = rows[:, :w * bits // 8].reshape(rows.shape[0], w, bits // 8)
    if bits == 24:
        return px[..., ::-1]
    masks = f.get("masks", (0xFF0000, 0xFF00, 0xFF, 0))
    if not any(masks):
        masks = (0xFF0000, 0xFF00, 0xFF, 0xFF000000)
    lanes = [m.bit_length() // 8 - 1 for m in masks[:4 if mode == "RGBA"
                                                   else 3]]
    return px[..., lanes]
