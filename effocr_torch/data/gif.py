"""GIF reader: the first frame, as Pillow 12 opens it.

The image has the logical screen's size (grown to hold the first frame
where the frame reaches past it, as ``Image.size`` reports).  The mode is
Pillow's: ``L`` when the frame's palette (local, else global) is absent
or is the grey ramp 0, 1, 2, ..., and ``P`` otherwise.  Pixels outside
the frame are the transparency index when the graphic control extension
gives one, else 0.  Interlaced frames are put back in row order.  The
LZW decoder is native (imgdec.cpp).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from effocr_torch.native import imgdec

MAGICS = (b"GIF87a", b"GIF89a")


def _palette(raw: bytes) -> Optional[np.ndarray]:
    """[n, 3] colour table (n entries, as Pillow keeps them), or None for
    the grey ramp (Pillow's ``_is_palette_needed`` is False: the image
    reads as L)."""
    p = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    if (p == np.arange(len(p), dtype=np.uint8)[:, None]).all():
        return None
    return p[:256].copy()


def _sub_blocks(data: bytes, pos: int) -> Tuple[bytes, int]:
    """The bytes of a chain of data sub-blocks, up to its terminator or
    the end of the file, and the position after it (past the end of the
    file when the chain is cut short)."""
    parts: List[bytes] = []
    while pos < len(data):
        n = data[pos]
        if n == 0:
            return b"".join(parts), pos + 1
        parts.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n
    return b"".join(parts), len(data) + 1


def _first_frame(data: bytes) -> dict:
    if data[:6] not in MAGICS or len(data) < 13:
        raise OSError("GIF: image file is truncated (screen descriptor)")
    sw, sh, flags = struct.unpack("<HHB", data[6:11])
    pos = 13
    gpal = None
    if flags & 128:
        size = 3 << ((flags & 7) + 1)
        if pos + size > len(data):
            raise OSError("GIF: image file is truncated (global palette)")
        gpal = _palette(data[pos:pos + size])
        pos += size
    transparency = None
    while pos < len(data):
        tag = data[pos]
        pos += 1
        if tag == 0x21:                       # extension
            if pos >= len(data):
                break
            label = data[pos]
            block, pos = _sub_blocks(data, pos + 1)
            if label == 0xF9 and len(block) >= 4 and block[0] & 1:
                transparency = block[3]
        elif tag == 0x2C:                     # image descriptor
            if pos + 9 > len(data):
                break
            x0, y0, w, h, fl = struct.unpack("<HHHHB", data[pos:pos + 9])
            pos += 9
            pal = gpal
            if fl & 128:
                size = 3 << ((fl & 7) + 1)
                if pos + size > len(data):
                    break
                pal = _palette(data[pos:pos + size])
                pos += size
            if pos >= len(data):
                break
            return {"screen": (max(sw, x0 + w), max(sh, y0 + h)),
                    "box": (x0, y0, w, h), "interlace": bool(fl & 64),
                    "palette": pal, "transparency": transparency,
                    "min_code": data[pos], "pos": pos + 1}
        elif tag == 0x3B:                     # trailer
            raise OSError("GIF: no image in the file")
        else:
            raise OSError(f"GIF: unknown block 0x{tag:02x}")
    raise OSError("GIF: image file is truncated (before the first frame)")


def transparency(data: bytes) -> Optional[int]:
    """Pillow's ``info["transparency"]`` of the first frame: the index
    its graphic control extension marks transparent, or None."""
    return _first_frame(data)["transparency"]


def gif_header(data: bytes) -> Tuple[int, int, str]:
    """(h, w, Pillow's mode) of the first frame."""
    f = _first_frame(data)
    (w, h) = f["screen"]
    return h, w, "L" if f["palette"] is None else "P"


def decode(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """GIF bytes -> (indices uint8 [H, W], mode, palette [n, 3] for
    ``P``, None for ``L``)."""
    f = _first_frame(data)
    sw, sh = f["screen"]
    x0, y0, w, h = f["box"]
    lzw, end = _sub_blocks(data, f["pos"])
    px = np.full((sh, sw), f["transparency"] or 0, np.uint8)
    idx = imgdec.gif_lzw(lzw, f["min_code"], w * h)
    if idx.size < w * h and end > len(data):
        # Pillow reads a frame the file ends inside as truncated, and one
        # whose codes end early (or that lacks only its trailer) as it is
        raise OSError("GIF: image file is truncated (image data)")
    frame = np.zeros(w * h, np.uint8)
    frame[:idx.size] = idx
    if idx.size < w * h:
        frame[idx.size:] = px[0, 0]
    frame = frame.reshape(h, w)
    if f["interlace"]:
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                np.arange(2, h, 4), np.arange(1, h, 2)])
        rows = np.empty_like(frame)
        rows[order] = frame
        frame = rows
    px[y0:y0 + h, x0:x0 + w] = frame
    mode = "L" if f["palette"] is None else "P"
    return px, mode, f["palette"]
