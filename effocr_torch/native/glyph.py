"""ctypes binding for glyph.cpp: TrueType outlines scaled and hinted as
FreeType 2.14 does by default (the v40 bytecode interpreter; composite
offsets scaled where SCALED_COMPONENT_OFFSET asks; the overlap flags
carried out as FT_OUTLINE_OVERLAP), CFF outlines through its default
Adobe engine (``CFFFace``), FreeType's gray rasterizer (with its 4x
oversampled pass for overlapping outlines), and Pillow's Gaussian blur.

The library is compiled with g++ on first use into ``libglyph.so`` next
to its source (git-ignored), rebuilt when the source is newer, written
to a temporary file and renamed so that concurrent builds never load a
half-written library.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "glyph.cpp")
_LIB = os.path.join(_HERE, "libglyph.so")

# error code of glyph.cpp that is not a program fault: buffers too small
_TOO_SMALL = -1

_lib = None
_lock = threading.Lock()


def build() -> str:
    """Compile libglyph.so if it is missing or older than its source;
    returns its path.  Raises RuntimeError when it does not compile."""
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(
            _SRC):
        return _LIB
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
    os.close(fd)
    # no -march=native and no FMA contraction: the blur's float
    # arithmetic must round as Pillow's C does
    cmd = ["g++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
           "-fPIC", _SRC, "-o", tmp]
    try:
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(
                f"could not build the glyph renderer from {_SRC}: {e}") from e
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"could not build the glyph renderer from {_SRC}: "
                f"{e.stderr.strip()[-2000:]}") from e
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _LIB


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.eg_face_new.restype = P
        lib.eg_face_new.argtypes = [P, L, P, I, P, I, P, I, I, I, I, P, I,
                                    P, I, P, I, I, I, I, I, I]
        lib.eg_face_free.argtypes = [P]
        lib.eg_size_new.restype = P
        lib.eg_size_new.argtypes = [P, I, ctypes.POINTER(I)]
        lib.eg_size_free.argtypes = [P]
        lib.eg_load.restype = I
        lib.eg_load.argtypes = [P, I, I, P, P, P, I, I, ctypes.POINTER(I),
                                ctypes.POINTER(I), ctypes.POINTER(L),
                                ctypes.POINTER(I)]
        lib.eg_render.argtypes = [P, P, P, I, I, I, I, I, P]
        lib.eg_cff_face_new.restype = P
        lib.eg_cff_face_new.argtypes = [P, L, I, P, I, P, P, I, P, P, P, P,
                                        P, I, I]
        lib.eg_cff_face_free.argtypes = [P]
        lib.eg_cff_size_new.restype = P
        lib.eg_cff_size_new.argtypes = [P, I]
        lib.eg_cff_size_free.argtypes = [P]
        lib.eg_cff_load.restype = I
        lib.eg_cff_load.argtypes = [P, I, I, P, P, P, I, I, ctypes.POINTER(I),
                                    ctypes.POINTER(I), P]
        lib.eg_gaussian_blur.argtypes = [P, I, I, I, ctypes.c_float]
        _lib = lib
        return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class Face:
    """One font's tables on the C++ side (fonts/sfnt.py ``Font``)."""

    def __init__(self, font):
        lib = _load()
        self._keep = []

        def arr(x, dt):
            a = np.ascontiguousarray(np.asarray(x, dt))
            if a.size == 0:
                a = np.zeros(1, dt)
            self._keep.append(a)
            return a

        glyf = arr(np.frombuffer(font.tables["glyf"], np.uint8), np.uint8)
        loca = arr(font.loca, np.uint32)
        adv = arr(font.advances, np.uint16)
        lsb = arr(font.lsbs, np.int16)
        cvt = arr(font.cvt, np.int16)
        fpgm = arr(np.frombuffer(font.fpgm, np.uint8), np.uint8)
        prep = arr(np.frombuffer(font.prep, np.uint8), np.uint8)
        # TT_Get_VMetrics without vmtx: OS/2 typo metrics, else hhea
        if font.os2_version is not None:
            v_asc, v_desc = font.typo_ascender, font.typo_descender
        else:
            v_asc, v_desc = font.hhea_ascender, font.hhea_descender
        self._lib = lib
        self.handle = lib.eg_face_new(
            _ptr(glyf), len(font.tables["glyf"]), _ptr(loca),
            font.num_glyphs, _ptr(adv), len(font.advances), _ptr(lsb),
            len(font.lsbs), font.units_per_em, v_asc, v_desc, _ptr(cvt),
            len(font.cvt), _ptr(fpgm), len(font.fpgm), _ptr(prep),
            len(font.prep), font.max_stack, font.max_storage,
            font.max_fdefs, font.max_idefs, font.max_twilight)
        self.font = font

    def __del__(self):
        if getattr(self, "handle", None):
            self._lib.eg_face_free(self.handle)
            self.handle = None

    def new_size(self, ppem: int) -> "Size":
        return Size(self, ppem)


class Size:
    """A face at ``ppem`` pixels, its font and CVT programs run."""

    def __init__(self, face: Face, ppem: int):
        err = ctypes.c_int(0)
        self.face = face
        self._lib = face._lib
        self.handle = self._lib.eg_size_new(face.handle, int(ppem),
                                            ctypes.byref(err))
        self.error = err.value
        self.ppem = int(ppem)

    def __del__(self):
        if getattr(self, "handle", None):
            self._lib.eg_size_free(self.handle)
            self.handle = None

    def glyph(self, gid: int, hinted: bool = True
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
        """(points int64 [N, 2] in 26.6, tags uint8 [N] (bit 0: on the
        curve), contour end indices int16 [C], FT_OUTLINE_OVERLAP) of
        glyph ``gid``."""
        cap_p, cap_c = 512, 64
        while True:
            xy = np.zeros((cap_p, 2), np.int64)
            tags = np.zeros(cap_p, np.uint8)
            cont = np.zeros(cap_c, np.int16)
            n_p, n_c, pp1 = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int64(0)
            overlap = ctypes.c_int(0)
            rc = self._lib.eg_load(self.handle, int(gid), int(hinted),
                                   _ptr(xy), _ptr(tags), _ptr(cont), cap_p,
                                   cap_c, ctypes.byref(n_p), ctypes.byref(n_c),
                                   ctypes.byref(pp1), ctypes.byref(overlap))
            if rc == _TOO_SMALL:
                cap_p, cap_c = max(cap_p, n_p.value), max(cap_c, n_c.value)
                continue
            if rc:
                raise OSError(f"glyph {gid} of {self.face.font.path} does not "
                              f"load (error {rc})")
            return (xy[: n_p.value].copy(), tags[: n_p.value].copy(),
                    cont[: n_c.value].copy(), bool(overlap.value))

    def outline(self, gid: int, hinted: bool = True
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``glyph`` without the overlap flag."""
        return self.glyph(gid, hinted)[:3]


# fd_params layout of eg_cff_face_new (CFF_FD_PARAMS int32 per FD)
CFF_FD_PARAMS = 64


def _fd_params(cff) -> np.ndarray:
    out = np.zeros((len(cff.privates), CFF_FD_PARAMS), np.int32)
    for i, p in enumerate(cff.privates):
        row = out[i]
        for base, vals, cap in ((0, p.blue_values, 14),
                                (15, p.other_blues, 10),
                                (26, p.family_blues, 14),
                                (41, p.family_other_blues, 10)):
            vals = vals[:cap]
            row[base] = len(vals)
            row[base + 1: base + 1 + len(vals)] = vals
        row[52:60] = [p.blue_scale, p.blue_shift, p.blue_fuzz,
                      p.language_group, p.default_width, p.nominal_width,
                      cff.top_upm, cff.sub_upm[i]]
    return out


class CFFFace:
    """One CFF font's charstrings, subroutines and Private values on the
    C++ side (fonts/cff.py ``CFF``)."""

    def __init__(self, font):
        lib = _load()
        c = font.cff

        def arr(x, dt):
            # eg_cff_face_new copies every array it is given
            a = np.ascontiguousarray(np.asarray(x, dt))
            return a if a.size else np.zeros(1, dt)

        data = np.frombuffer(c.data, np.uint8)
        cs = arr(c.charstrings.offsets, np.int64)
        gs = arr(c.gsubrs.offsets, np.int64)
        lsubrs = [p.subrs.offsets if p.subrs is not None and p.subrs.count
                  else np.zeros(0, np.int64) for p in c.privates]
        lsub = arr(np.concatenate(lsubrs), np.int64)
        lsub_n = arr([len(x) for x in lsubrs], np.int32)
        params = arr(_fd_params(c), np.int32)
        seac = arr(c.seac, np.int32)
        adv = arr(font.advances, np.uint16)
        fd = None if c.fd_of_glyph is None else arr(c.fd_of_glyph, np.uint8)
        self._lib = lib
        self.handle = lib.eg_cff_face_new(
            _ptr(data), len(c.data), c.num_glyphs, _ptr(cs), c.gsubrs.count,
            _ptr(gs), None if fd is None else _ptr(fd), len(c.privates),
            _ptr(lsub), _ptr(lsub_n), _ptr(params), _ptr(seac), _ptr(adv),
            len(font.advances), font.units_per_em)
        self.font = font

    def __del__(self):
        if getattr(self, "handle", None):
            self._lib.eg_cff_face_free(self.handle)
            self.handle = None

    def new_size(self, ppem: int) -> "CFFSize":
        return CFFSize(self, ppem)


class CFFSize:
    """A CFF face at ``ppem`` pixels (``Size``'s interface; no font
    program runs, so ``error`` is always 0)."""

    error = 0

    def __init__(self, face: CFFFace, ppem: int):
        self.face = face
        self._lib = face._lib
        self.handle = self._lib.eg_cff_size_new(face.handle, int(ppem))
        self.ppem = int(ppem)

    def __del__(self):
        if getattr(self, "handle", None):
            self._lib.eg_cff_size_free(self.handle)
            self.handle = None

    def load(self, gid: int, hinted: bool = True):
        """(points int64 [N, 2] in 26.6, tags uint8 [N] (1: on the curve,
        2: cubic control), contour ends int16 [C], (advance.x 26.6,
        linearHoriAdvance 16.16))."""
        cap_p, cap_c = 512, 64
        adv = np.zeros(2, np.int64)
        while True:
            xy = np.zeros((cap_p, 2), np.int64)
            tags = np.zeros(cap_p, np.uint8)
            cont = np.zeros(cap_c, np.int16)
            n_p, n_c = ctypes.c_int(0), ctypes.c_int(0)
            rc = self._lib.eg_cff_load(self.handle, int(gid), int(hinted),
                                       _ptr(xy), _ptr(tags), _ptr(cont),
                                       cap_p, cap_c, ctypes.byref(n_p),
                                       ctypes.byref(n_c), _ptr(adv))
            if rc == _TOO_SMALL:
                cap_p, cap_c = max(cap_p, n_p.value), max(cap_c, n_c.value)
                continue
            if rc:
                raise OSError(f"glyph {gid} of {self.face.font.path} does not "
                              f"load (error {rc})")
            return (xy[: n_p.value].copy(), tags[: n_p.value].copy(),
                    cont[: n_c.value].copy(), (int(adv[0]), int(adv[1])))

    def outline(self, gid: int, hinted: bool = True):
        return self.load(gid, hinted)[:3]

    def glyph(self, gid: int, hinted: bool = True):
        """``Size.glyph``'s interface: FreeType's CFF loader sets no
        overlap flag."""
        return self.load(gid, hinted)[:3] + (False,)


def open_face(font):
    """The native face of a parsed font: ``CFFFace`` for CFF outlines,
    else the TrueType ``Face``."""
    return CFFFace(font) if font.cff is not None else Face(font)


def render(points: np.ndarray, tags: np.ndarray, contours: np.ndarray,
           width: int, rows: int, overlap: bool = False) -> np.ndarray:
    """FreeType's gray rasterizer: the outline (26.6, bitmap coordinates,
    y up) into a top-down uint8 [rows, width] coverage bitmap; with
    ``overlap`` (FT_OUTLINE_OVERLAP), ft_smooth_raster_overlap's 4x
    oversampled pass."""
    lib = _load()
    out = np.zeros((rows, width), np.uint8)
    if rows == 0 or width == 0 or len(contours) == 0:
        return out
    if overlap and width * 4 > 0x7FFF:
        raise OSError("raster overflow: an overlapping outline "
                      f"{width} px wide")
    pts = np.ascontiguousarray(points, np.int64)
    tg = np.ascontiguousarray(tags, np.uint8)
    ct = np.ascontiguousarray(contours, np.int16)
    lib.eg_render(_ptr(pts), _ptr(tg), _ptr(ct), len(pts), len(ct),
                  int(width), int(rows), int(overlap), _ptr(out))
    return out


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """Pillow's ``ImageFilter.GaussianBlur(radius)`` (three extended box
    blurs per axis) on uint8 [H, W] or [H, W, C]."""
    lib = _load()
    out = np.ascontiguousarray(img, np.uint8).copy()
    h, w = out.shape[:2]
    ch = 1 if out.ndim == 2 else out.shape[2]
    lib.eg_gaussian_blur(_ptr(out), w, h, ch,
                         ctypes.c_float(np.float32(radius)))
    return out
