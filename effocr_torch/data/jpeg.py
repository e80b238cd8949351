"""JPEG reader: the pixels Pillow 12 gives through libjpeg-turbo.

``jpeg_header`` scans the markers up to the first frame (SOFn) without
decoding, as ``Image.open`` does, and gives (h, w, mode): ``L`` for one
component, ``RGB`` for three, ``CMYK`` for four.  ``decode`` runs the
native decoder (native/imgdec.cpp: islow IDCT, fancy upsampling, the
YCbCr -> RGB tables of libjpeg) and gives CMYK inverted, as Pillow reads
it (rawmode ``CMYK;I``, the Adobe convention, whatever the markers say).

Refused with ``NotImplementedError``, naming the feature: arithmetic
coding (SOF9-11, SOF13-15), lossless (SOF3, SOF7), hierarchical
(SOF5-7), precision other than 8 bits, YCCK (Adobe transform 2),
sampling factors other than 1x1 / 2x1 / 1x2 / 2x2, and a progressive
file whose scans leave coefficient bits unsent.  A truncated file raises
``OSError``, as Pillow does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from effocr_torch.native import imgdec

MAGIC = b"\xff\xd8\xff"

_MODES = {1: "L", 3: "RGB", 4: "CMYK"}
_REFUSED_SOF = {
    0xC3: "lossless coding (SOF3)",
    0xC5: "hierarchical coding (SOF5)",
    0xC6: "hierarchical progressive coding (SOF6)",
    0xC7: "hierarchical lossless coding (SOF7)",
    0xC9: "arithmetic coding (SOF9)",
    0xCA: "arithmetic coding, progressive (SOF10)",
    0xCB: "arithmetic coding, lossless (SOF11)",
    0xCD: "arithmetic coding, hierarchical (SOF13)",
    0xCE: "arithmetic coding, hierarchical progressive (SOF14)",
    0xCF: "arithmetic coding, hierarchical lossless (SOF15)",
}


def refuse(what: str) -> NotImplementedError:
    return NotImplementedError(f"JPEG uses {what}; {imgdec.ROADMAP_HINT}")


def jpeg_header(data: bytes) -> Tuple[int, int, str]:
    """(h, w, Pillow's mode) from the first SOFn of a JPEG stream.
    Raises for what the decoder refuses, where the frame header shows it
    (and for YCCK when the Adobe marker comes before the frame)."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("not a JPEG stream")
    pos, n = 2, len(data)
    adobe_transform = None
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        if m in (0x00, 0x01, 0xD8) or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        seg = int.from_bytes(data[pos + 2:pos + 4], "big")
        body = data[pos + 4:pos + 2 + seg]
        if m == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe_transform = body[11]
        if m in _REFUSED_SOF:
            raise refuse(_REFUSED_SOF[m])
        if m in (0xC0, 0xC1, 0xC2):
            if len(body) < 6:
                break
            prec, h, w, nc = (body[0], int.from_bytes(body[1:3], "big"),
                              int.from_bytes(body[3:5], "big"), body[5])
            if prec != 8:
                raise refuse(f"{prec}-bit precision")
            if nc not in _MODES:
                raise refuse(f"{nc} components")
            factors = [(body[7 + 3 * c] >> 4, body[7 + 3 * c] & 15)
                       for c in range(nc) if 8 + 3 * c <= len(body)]
            hmax = max(f[0] for f in factors)
            vmax = max(f[1] for f in factors)
            if nc > 1 and (hmax > 2 or vmax > 2 or any(
                    hmax % a or vmax % b for a, b in factors)):
                raise refuse("sampling factors " + ", ".join(
                    f"{a}x{b}" for a, b in factors))
            if nc == 4 and adobe_transform not in (None, 0):
                raise refuse(f"YCCK colour (Adobe transform "
                             f"{adobe_transform})")
            if h == 0:
                raise refuse("a DNL marker (height given after the first "
                             "scan)")
            return h, w, _MODES[nc]
        if m == 0xD9 or m == 0xDA:
            break
        pos += 2 + seg
    raise OSError("JPEG: image file is truncated (no frame header)")


def decode(data: bytes, where: str = "JPEG") -> Tuple[np.ndarray, str]:
    """JPEG bytes -> (pixels, mode): uint8 [H, W] for ``L``, [H, W, 3]
    for ``RGB``, [H, W, 4] for ``CMYK`` (inverted, as Pillow reads it)."""
    h, w, mode = jpeg_header(data)
    ch = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    px = imgdec.decode_jpeg(data, (h, w, ch), where=where)
    if mode == "CMYK":
        px = 255 - px
    return (px[..., 0] if ch == 1 else px), mode
