"""ctypes binding for the image decoders of imgdec.cpp: JPEG (the pixels
libjpeg-turbo gives Pillow, or its component planes for old-style JPEG
in TIFF) and the entropy codecs of TIFF (PackBits, LZW, CCITT, RLEW,
ThunderScan, ZSTD) and GIF (LZW).

The library is compiled with g++ on first use into ``libimgdec.so`` next
to its source (git-ignored), rebuilt when the source is newer, written
to a temporary file and renamed so that concurrent builders never load a
half-written library.  A failed build raises: there is no fallback.

A decoder's failure raises by its kind: ``NotImplementedError`` for a
feature the decoder refuses (it names the feature and ROADMAP.md),
``OSError`` for a truncated or corrupt file.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import List, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "imgdec.cpp")
_LIB = os.path.join(_HERE, "libimgdec.so")
_ERRLEN = 256

# status codes of imgdec.cpp
_CORRUPT, _TRUNCATED, _UNSUPPORTED, _IO = 1, 2, 3, 4

ROADMAP_HINT = "not decoded by effocr_torch (ROADMAP.md, queue 1)"

_lib = None
_lock = threading.Lock()


def build() -> str:
    """Compile libimgdec.so if it is missing or older than its source;
    returns its path.  Raises RuntimeError when it does not compile."""
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(
            _SRC):
        return _LIB
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", _SRC, "-o", tmp]
    try:
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(
                f"could not build the image decoders from {_SRC}: {e}") from e
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"could not build the image decoders from {_SRC}: "
                f"{e.stderr.strip()[-2000:]}") from e
        os.replace(tmp, _LIB)
        return _LIB
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int)
        sz, cp, ci = ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int
        lib.decode_jpeg.argtypes = [u8p, sz, ci, u8p, ci, ci, ci, cp, ci]
        lib.decode_jpeg.restype = ci
        lib.decode_jpeg_batch.argtypes = [
            ctypes.POINTER(cp), ci, ctypes.POINTER(u8p), i32p, i32p, i32p,
            ci, i32p, cp, ci]
        lib.decode_jpeg_batch.restype = None
        lib.packbits_decode.argtypes = [u8p, sz, u8p, sz]
        lib.packbits_decode.restype = ctypes.c_long
        lib.tiff_lzw_decode.argtypes = [u8p, sz, u8p, sz, cp, ci]
        lib.tiff_lzw_decode.restype = ctypes.c_long
        lib.ccitt_decode.argtypes = [u8p, sz, ci, ci, ci, ci, ci, u8p,
                                     ctypes.POINTER(ctypes.c_uint32), sz, cp,
                                     ci]
        lib.ccitt_decode.restype = ctypes.c_long
        lib.gif_lzw_decode.argtypes = [u8p, sz, ci, u8p, sz, cp, ci]
        lib.gif_lzw_decode.restype = ctypes.c_long
        lib.thunder_decode.argtypes = [u8p, sz, u8p, ci, ci, sz]
        lib.thunder_decode.restype = ctypes.c_long
        lib.zstd_decode.argtypes = [u8p, sz, u8p, sz, cp, ci]
        lib.zstd_decode.restype = ctypes.c_long
        _lib = lib
        return _lib


def _u8(a) -> "ctypes.POINTER(ctypes.c_uint8)":
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _src(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)


def _error(status: int, msg: str, where: str) -> Exception:
    """The exception for a decoder's status and message."""
    if status == _UNSUPPORTED:
        return NotImplementedError(f"{where}: {msg}; {ROADMAP_HINT}")
    if status == _TRUNCATED:
        return OSError(f"{where}: image file is truncated ({msg})")
    return OSError(f"{where}: {msg}")


def decode_jpeg(data: bytes, shape: Tuple[int, int, int], color: int = 0,
                where: str = "JPEG", segment: bool = False,
                first_scan: bool = False) -> np.ndarray:
    """JPEG bytes -> uint8 [h, w, ch].  ``ch`` is the file's own channel
    count (1 L, 3 RGB, 4 CMYK as stored), or 3 for an L file (replicated)
    or 1 for an RGB file (the truncating channel mean).  ``color``: 0 the
    file's colour space, 1 YCbCr whatever it says, 2 no conversion.
    ``segment``: the bytes are a TIFF strip or tile, which may end inside
    its scan (read as libjpeg reads the EOI libtiff puts there).
    ``first_scan``: nothing past the first scan is read."""
    lib = _load()
    out = np.empty(shape, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    src = _src(data)
    flags = color | (8 if segment else 0) | (32 if first_scan else 0)
    st = lib.decode_jpeg(_u8(src), len(data), flags,
                         _u8(out), shape[0], shape[1], shape[2], err,
                         _ERRLEN)
    if st:
        raise _error(st, err.value.decode(errors="replace"), where)
    return out


def decode_jpeg_batch(paths: Sequence[str],
                      shapes: Sequence[Tuple[int, int, int]],
                      num_threads: int = 8) -> List[np.ndarray]:
    """JPEG files -> uint8 [h, w, ch] each (``decode_jpeg``'s channel
    rule), read and decoded over a thread pool.  Raises for the first
    file that fails."""
    lib = _load()
    n = len(paths)
    if n == 0:
        return []
    u8pp = ctypes.POINTER(ctypes.c_uint8)
    outs = [np.empty(s, np.uint8) for s in shapes]
    ptrs = (u8pp * n)(*[_u8(o) for o in outs])
    hs = (ctypes.c_int * n)(*[s[0] for s in shapes])
    ws = (ctypes.c_int * n)(*[s[1] for s in shapes])
    chs = (ctypes.c_int * n)(*[s[2] for s in shapes])
    cpaths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    status = (ctypes.c_int * n)()
    errs = ctypes.create_string_buffer(_ERRLEN * n)
    lib.decode_jpeg_batch(cpaths, n, ptrs, hs, ws, chs, num_threads, status,
                          errs, _ERRLEN)
    for i in range(n):
        if status[i]:
            msg = errs.raw[i * _ERRLEN:(i + 1) * _ERRLEN].split(b"\0")[0]
            raise _error(status[i], msg.decode(errors="replace"), paths[i])
    return outs


def packbits(data: bytes, nbytes: int, where: str = "TIFF") -> np.ndarray:
    """PackBits bytes -> the first ``nbytes`` decoded bytes (fewer when
    the data ends early)."""
    out = np.zeros(max(nbytes, 1), np.uint8)
    got = _load().packbits_decode(_u8(_src(data)), len(data), _u8(out),
                                  nbytes)
    if got < 0:
        raise OSError(f"{where}: PackBits run past the strip")
    return out[:got]


def tiff_lzw(data: bytes, nbytes: int, where: str = "TIFF") -> np.ndarray:
    """TIFF LZW bytes -> at most ``nbytes`` decoded bytes."""
    out = np.zeros(max(nbytes, 1), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    got = _load().tiff_lzw_decode(_u8(_src(data)), len(data), _u8(out),
                                  nbytes, err, _ERRLEN)
    if got < 0:
        raise _error(-got, err.value.decode(errors="replace"), where)
    return out[:got]


def ccitt_state(width: int) -> np.ndarray:
    """A new codec state for ``ccitt`` over the segments of one image,
    ``width`` pixels wide: libtiff's run arrays and flags, zeroed."""
    return np.zeros(2 + 4 * (-(-(width + 1) // 32) * 32), np.uint32)


def ccitt(data: bytes, mode: int, t4_options: int, fill_order: int,
          out: np.ndarray, state: np.ndarray, where: str = "TIFF") -> bool:
    """One CCITT-coded strip or tile into ``out`` (uint8 [rows, width],
    C-contiguous; 1 where a black run lies) as libtiff decodes it: data
    that end early or go wrong give libtiff's rows, and the pixels it does
    not reach keep their values.  ``mode`` is the TIFF compression: 2
    modified Huffman, 3 T.4, 4 T.6, 32771 modified Huffman with rows on
    16-bit words (``t4_options``: the data's offset in the file, whose
    parity libtiff aligns against).  ``state``: ``ccitt_state(width)``,
    passed to each segment of the image in turn.  False where libtiff's
    decoder fails the segment."""
    rows, width = out.shape
    if not out.flags.c_contiguous or out.dtype != np.uint8:
        raise ValueError("ccitt: out must be C-contiguous uint8")
    err = ctypes.create_string_buffer(_ERRLEN)
    got = _load().ccitt_decode(
        _u8(_src(data)), len(data), mode, t4_options, fill_order, width,
        rows, _u8(out), state.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        state.size, err, _ERRLEN)
    if got < 0:
        raise _error(-got, err.value.decode(errors="replace"), where)
    return got == 1


def decode_jpeg_raw(data: bytes, size: Tuple[int, int], nbytes: int,
                    where: str = "TIFF old-style JPEG") -> np.ndarray:
    """A JPEG stream's component planes, as libjpeg's raw data output
    gives them: each component's samples [ceil(h * h_c / h_max),
    ceil(w * w_c / w_max)], flat, one after another (``nbytes`` in all),
    the stream read as a TIFF segment up to its first scan
    (``decode_jpeg``'s ``segment`` and ``first_scan``)."""
    lib = _load()
    out = np.empty(max(nbytes, 1), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    st = lib.decode_jpeg(_u8(_src(data)), len(data), 2 | 8 | 16 | 32,
                         _u8(out), size[0], size[1], nbytes, err, _ERRLEN)
    if st:
        raise _error(st, err.value.decode(errors="replace"), where)
    return out[:nbytes]


def thunderscan(data: bytes, rows: int, width: int, row_bytes: int,
                where: str = "TIFF") -> np.ndarray:
    """ThunderScan bytes -> ``rows`` rows of ``width`` 4-bit pixels, each
    ``row_bytes`` long (uint8 [rows * row_bytes]); OSError where libtiff's
    decoder fails (too few or too many pixels in a row)."""
    out = np.zeros(max(rows * row_bytes, 1), np.uint8)
    if not _load().thunder_decode(_u8(_src(data)), len(data), _u8(out),
                                  rows, width, row_bytes):
        raise OSError(f"{where}: ThunderScan data of another pixel count "
                      "than its rows")
    return out[:rows * row_bytes]


def zstd(data: bytes, nbytes: int, where: str = "TIFF") -> np.ndarray:
    """ZSTD bytes -> ``nbytes`` decoded bytes, as libtiff's ZSTD codec
    drives libzstd over one strip or tile: the first frame's bytes, until
    the segment is full; OSError where libzstd fails or the data end
    first."""
    out = np.zeros(max(nbytes, 1), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    got = _load().zstd_decode(_u8(_src(data)), len(data), _u8(out), nbytes,
                              err, _ERRLEN)
    if got < 0:
        raise _error(-got, err.value.decode(errors="replace"), where)
    if got < nbytes:
        raise OSError(f"{where}: ZSTD data end after {got} of {nbytes} "
                      "bytes")
    return out[:nbytes]


def gif_lzw(data: bytes, min_code_size: int, npixels: int,
            where: str = "GIF") -> np.ndarray:
    """GIF LZW bytes -> at most ``npixels`` palette indices."""
    out = np.zeros(max(npixels, 1), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    got = _load().gif_lzw_decode(_u8(_src(data)), len(data), min_code_size,
                                 _u8(out), npixels, err, _ERRLEN)
    if got < 0:
        raise _error(-got, err.value.decode(errors="replace"), where)
    return out[:got]

