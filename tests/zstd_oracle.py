"""libzstd as the tests' oracle: ctypes into the library Pillow ships
(pillow.libs, zstd 1.5.7), never imported by effocr_torch.

``compress(data, level, checksum=, window_log=, block=, stream=)``
writes frames as libzstd's streaming compressor does (``block``: one
frame per ``block`` bytes of input, concatenated; ``stream``: the input
given before the frame is ended, so that its header holds a window
descriptor and no content size); ``tiff_segment(data, occ)`` runs
``ZSTD_decompressStream`` as libtiff 4.7.1's tif_zstd.c ZSTDDecode runs
it over one strip or tile of ``occ`` bytes: the bytes, or None where
libtiff reports an error (libzstd's, or data that end before the
segment is full).
"""

from __future__ import annotations

import ctypes
import functools

from ft_oracle import _pillow_lib

ZSTD_c_compressionLevel = 100
ZSTD_c_windowLog = 101
ZSTD_c_checksumFlag = 201
ZSTD_e_continue, ZSTD_e_end = 0, 2


class _Buffer(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(_pillow_lib("zstd"))
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    lib.ZSTD_createCCtx.restype = vp
    lib.ZSTD_freeCCtx.argtypes = [vp]
    lib.ZSTD_CCtx_setParameter.argtypes = [vp, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_CCtx_setParameter.restype = sz
    lib.ZSTD_compressStream2.argtypes = [vp, ctypes.POINTER(_Buffer),
                                         ctypes.POINTER(_Buffer),
                                         ctypes.c_int]
    lib.ZSTD_compressStream2.restype = sz
    lib.ZSTD_createDStream.restype = vp
    lib.ZSTD_freeDStream.argtypes = [vp]
    lib.ZSTD_initDStream.argtypes = [vp]
    lib.ZSTD_initDStream.restype = sz
    lib.ZSTD_decompressStream.argtypes = [vp, ctypes.POINTER(_Buffer),
                                          ctypes.POINTER(_Buffer)]
    lib.ZSTD_decompressStream.restype = sz
    lib.ZSTD_isError.argtypes = [sz]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_getErrorName.argtypes = [sz]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_compressBound.argtypes = [sz]
    lib.ZSTD_compressBound.restype = sz
    lib.ZSTD_versionNumber.restype = ctypes.c_uint
    return lib


def version() -> int:
    return _lib().ZSTD_versionNumber()


def _frame(data: bytes, level: int, checksum: bool, window_log: int,
           stream: bool) -> bytes:
    lib = _lib()
    cctx = lib.ZSTD_createCCtx()
    try:
        for key, v in ((ZSTD_c_compressionLevel, level),
                       (ZSTD_c_checksumFlag, int(checksum)),
                       (ZSTD_c_windowLog, window_log)):
            if lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(cctx, key, v)):
                raise ValueError(f"zstd parameter {key} = {v}")
        cap = lib.ZSTD_compressBound(len(data)) + 64
        out = ctypes.create_string_buffer(cap)
        src = ctypes.create_string_buffer(data, len(data))
        ib = _Buffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        ob = _Buffer(ctypes.cast(out, ctypes.c_void_p), cap, 0)
        if stream:
            while ib.pos < ib.size:
                r = lib.ZSTD_compressStream2(cctx, ob, ib, ZSTD_e_continue)
                if lib.ZSTD_isError(r):
                    raise ValueError(lib.ZSTD_getErrorName(r).decode())
        while True:
            r = lib.ZSTD_compressStream2(cctx, ob, ib, ZSTD_e_end)
            if lib.ZSTD_isError(r):
                raise ValueError(lib.ZSTD_getErrorName(r).decode())
            if r == 0:
                return out.raw[:ob.pos]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def compress(data: bytes, level: int = 3, checksum: bool = False,
             window_log: int = 0, block: int = 0,
             stream: bool = False) -> bytes:
    """libzstd's frames of ``data`` (window_log 0: the level's)."""
    if not block:
        return _frame(data, level, checksum, window_log, stream)
    return b"".join(_frame(data[i:i + block], level, checksum, window_log,
                           stream)
                    for i in range(0, max(len(data), 1), block))


def tiff_segment(data: bytes, occ: int):
    """tif_zstd.c ZSTDDecode over one segment: ``occ`` bytes, or None."""
    lib = _lib()
    ds = lib.ZSTD_createDStream()
    try:
        lib.ZSTD_initDStream(ds)
        src = ctypes.create_string_buffer(data, max(len(data), 1))
        out = ctypes.create_string_buffer(max(occ, 1))
        ib = _Buffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        ob = _Buffer(ctypes.cast(out, ctypes.c_void_p), occ, 0)
        while True:
            r = lib.ZSTD_decompressStream(ds, ob, ib)
            if lib.ZSTD_isError(r):
                return None
            if not (r != 0 and ib.pos < ib.size and ob.pos < ob.size):
                break
        return out.raw[:occ] if ob.pos == occ else None
    finally:
        lib.ZSTD_freeDStream(ds)
