"""FreeType and HarfBuzz as the tests' oracles: ctypes into the libraries
Pillow ships (pillow.libs), never imported by effocr_torch.

``FTFace(path, ppem)`` loads glyphs with FreeType's flags and returns
outline points, rendered bitmaps and advances (and a CFF font's
ItalicAngle as FreeType parsed it), so each stage of the port's
renderer (fonts/, native/glyph.cpp) can be held to FreeType
2.14 exactly.  ``face_info(path)`` gives a face's flags and bitmap
strikes, ``set_size_error(path, ppem)`` what FT_Set_Pixel_Sizes
returns (Pillow's ``truetype`` raises when it is not 0), and
``FTFace.glyph_kind`` / ``outline_flags`` the glyph slot's format and
outline flags after FT_LOAD_DEFAULT.  ``FTFace.hb_shape`` runs HarfBuzz through its FreeType
font functions (HarfBuzz's default load flags, as raqm leaves them for
Pillow).
"""

from __future__ import annotations

import ctypes
import glob
import os

import numpy as np

FT_LOAD_DEFAULT = 0
FT_LOAD_NO_HINTING = 1 << 1
FT_LOAD_RENDER = 1 << 2
FT_FACE_FLAG_SCALABLE = 1 << 0
FT_FACE_FLAG_FIXED_SIZES = 1 << 1
FT_OUTLINE_OVERLAP = 0x40
# FT_Glyph_Format tags
GLYPH_FORMATS = {0x62697473: "bitmap", 0x6F75746C: "outline",
                 0x636F6D70: "composite", 0: "none"}


def _pillow_lib(stem: str) -> str:
    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    found = sorted(glob.glob(os.path.join(libs, f"lib{stem}-*.so*")))
    if not found:
        raise FileNotFoundError(f"no {stem} in {libs}")
    return found[0]


class _Vector(ctypes.Structure):
    _fields_ = [("x", ctypes.c_long), ("y", ctypes.c_long)]


class _Bitmap(ctypes.Structure):
    _fields_ = [("rows", ctypes.c_uint), ("width", ctypes.c_uint),
                ("pitch", ctypes.c_int),
                ("buffer", ctypes.POINTER(ctypes.c_ubyte)),
                ("num_grays", ctypes.c_ushort), ("pixel_mode", ctypes.c_ubyte),
                ("palette_mode", ctypes.c_ubyte), ("palette", ctypes.c_void_p)]


class _Outline(ctypes.Structure):
    _fields_ = [("n_contours", ctypes.c_ushort), ("n_points", ctypes.c_ushort),
                ("points", ctypes.POINTER(_Vector)),
                ("tags", ctypes.POINTER(ctypes.c_ubyte)),
                ("contours", ctypes.POINTER(ctypes.c_ushort)),
                ("flags", ctypes.c_int)]


class _GlyphSlot(ctypes.Structure):
    _fields_ = [("library", ctypes.c_void_p), ("face", ctypes.c_void_p),
                ("next", ctypes.c_void_p), ("glyph_index", ctypes.c_uint),
                ("generic", ctypes.c_void_p * 2),
                ("metrics", ctypes.c_long * 8),
                ("linearHoriAdvance", ctypes.c_long),
                ("linearVertAdvance", ctypes.c_long),
                ("advance", _Vector), ("format", ctypes.c_uint),
                ("bitmap", _Bitmap), ("bitmap_left", ctypes.c_int),
                ("bitmap_top", ctypes.c_int), ("outline", _Outline)]


class _SizeMetrics(ctypes.Structure):
    _fields_ = [("x_ppem", ctypes.c_ushort), ("y_ppem", ctypes.c_ushort),
                ("x_scale", ctypes.c_long), ("y_scale", ctypes.c_long),
                ("ascender", ctypes.c_long), ("descender", ctypes.c_long),
                ("height", ctypes.c_long), ("max_advance", ctypes.c_long)]


class _Size(ctypes.Structure):
    _fields_ = [("face", ctypes.c_void_p), ("generic", ctypes.c_void_p * 2),
                ("metrics", _SizeMetrics)]


class _Face(ctypes.Structure):
    _fields_ = [("num_faces", ctypes.c_long), ("face_index", ctypes.c_long),
                ("face_flags", ctypes.c_long), ("style_flags", ctypes.c_long),
                ("num_glyphs", ctypes.c_long),
                ("family_name", ctypes.c_char_p),
                ("style_name", ctypes.c_char_p),
                ("num_fixed_sizes", ctypes.c_int),
                ("available_sizes", ctypes.c_void_p),
                ("num_charmaps", ctypes.c_int), ("charmaps", ctypes.c_void_p),
                ("generic", ctypes.c_void_p * 2),
                ("bbox", ctypes.c_long * 4),
                ("units_per_EM", ctypes.c_ushort),
                ("ascender", ctypes.c_short), ("descender", ctypes.c_short),
                ("height", ctypes.c_short),
                ("max_advance_width", ctypes.c_short),
                ("max_advance_height", ctypes.c_short),
                ("underline_position", ctypes.c_short),
                ("underline_thickness", ctypes.c_short),
                ("glyph", ctypes.POINTER(_GlyphSlot)),
                ("size", ctypes.POINTER(_Size)),
                ("charmap", ctypes.c_void_p)]


class _PSFontInfo(ctypes.Structure):
    _fields_ = [("version", ctypes.c_char_p), ("notice", ctypes.c_char_p),
                ("full_name", ctypes.c_char_p),
                ("family_name", ctypes.c_char_p),
                ("weight", ctypes.c_char_p), ("italic_angle", ctypes.c_long),
                ("is_fixed_pitch", ctypes.c_ubyte),
                ("underline_position", ctypes.c_short),
                ("underline_thickness", ctypes.c_ushort)]


class _BitmapSize(ctypes.Structure):
    _fields_ = [("height", ctypes.c_short), ("width", ctypes.c_short),
                ("size", ctypes.c_long), ("x_ppem", ctypes.c_long),
                ("y_ppem", ctypes.c_long)]


class _HBInfo(ctypes.Structure):
    _fields_ = [("codepoint", ctypes.c_uint32), ("mask", ctypes.c_uint32),
                ("cluster", ctypes.c_uint32), ("var1", ctypes.c_uint32),
                ("var2", ctypes.c_uint32)]


class _HBPos(ctypes.Structure):
    _fields_ = [("x_advance", ctypes.c_int32), ("y_advance", ctypes.c_int32),
                ("x_offset", ctypes.c_int32), ("y_offset", ctypes.c_int32),
                ("var", ctypes.c_uint32)]


_ft = None
_hb = None
_library = None


def _freetype():
    global _ft, _library
    if _ft is None:
        # Pillow's extension loads the library with its own dependencies
        # (libpng, brotli) from pillow.libs; the same file then opens here
        from PIL import _imagingft  # noqa: F401

        _ft = ctypes.CDLL(_pillow_lib("freetype"))
        lib = ctypes.c_void_p()
        assert _ft.FT_Init_FreeType(ctypes.byref(lib)) == 0
        _library = lib
        _ft.FT_New_Face.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_long,
                                    ctypes.POINTER(ctypes.POINTER(_Face))]
        _ft.FT_Set_Pixel_Sizes.argtypes = [ctypes.POINTER(_Face),
                                           ctypes.c_uint, ctypes.c_uint]
        _ft.FT_Load_Glyph.argtypes = [ctypes.POINTER(_Face), ctypes.c_uint,
                                      ctypes.c_int32]
        _ft.FT_Get_Char_Index.argtypes = [ctypes.POINTER(_Face),
                                          ctypes.c_ulong]
        _ft.FT_Get_Char_Index.restype = ctypes.c_uint
        _ft.FT_Done_Face.argtypes = [ctypes.POINTER(_Face)]
    return _ft


def _harfbuzz():
    global _hb
    if _hb is None:
        _freetype()
        hb = ctypes.CDLL(_pillow_lib("harfbuzz"))
        P = ctypes.c_void_p
        hb.hb_ft_font_create_referenced.restype = P
        hb.hb_ft_font_create_referenced.argtypes = [P]
        hb.hb_buffer_create.restype = P
        hb.hb_buffer_add_utf8.argtypes = [P, ctypes.c_char_p, ctypes.c_int,
                                          ctypes.c_uint, ctypes.c_int]
        hb.hb_buffer_guess_segment_properties.argtypes = [P]
        hb.hb_shape.argtypes = [P, P, P, ctypes.c_uint]
        hb.hb_buffer_get_glyph_infos.restype = ctypes.POINTER(_HBInfo)
        hb.hb_buffer_get_glyph_infos.argtypes = [
            P, ctypes.POINTER(ctypes.c_uint)]
        hb.hb_buffer_get_glyph_positions.restype = ctypes.POINTER(_HBPos)
        hb.hb_buffer_get_glyph_positions.argtypes = [
            P, ctypes.POINTER(ctypes.c_uint)]
        hb.hb_buffer_destroy.argtypes = [P]
        hb.hb_font_destroy.argtypes = [P]
        _hb = hb
    return _hb


def _open(path: str):
    ft = _freetype()
    face = ctypes.POINTER(_Face)()
    assert ft.FT_New_Face(_library, path.encode(), 0,
                          ctypes.byref(face)) == 0
    return face


def face_info(path: str) -> dict:
    """``scalable``, ``fixed_sizes`` (the face flags) and ``strikes``, the
    available sizes' (x_ppem, y_ppem) in whole pixels."""
    face = _open(path)
    try:
        f = face.contents
        sizes = ctypes.cast(f.available_sizes, ctypes.POINTER(_BitmapSize))
        strikes = [(sizes[i].x_ppem >> 6, sizes[i].y_ppem >> 6)
                   for i in range(f.num_fixed_sizes)]
        return {"scalable": bool(f.face_flags & FT_FACE_FLAG_SCALABLE),
                "fixed_sizes": bool(f.face_flags & FT_FACE_FLAG_FIXED_SIZES),
                "strikes": strikes}
    finally:
        _ft.FT_Done_Face(face)


def set_size_error(path: str, ppem: int) -> int:
    """FT_Set_Pixel_Sizes(face, 0, ppem)'s error code (0: the size is
    set)."""
    face = _open(path)
    try:
        return _ft.FT_Set_Pixel_Sizes(face, 0, ppem)
    finally:
        _ft.FT_Done_Face(face)


class FTFace:
    """A FreeType face at ``ppem`` pixels (Pillow's FT_Set_Pixel_Sizes)."""

    def __init__(self, path: str, ppem: int):
        ft = _freetype()
        self.face = ctypes.POINTER(_Face)()
        assert ft.FT_New_Face(_library, path.encode(), 0,
                              ctypes.byref(self.face)) == 0
        assert ft.FT_Set_Pixel_Sizes(self.face, 0, ppem) == 0
        self.num_glyphs = self.face.contents.num_glyphs

    def __del__(self):
        if _ft is not None and self.face:
            _ft.FT_Done_Face(self.face)

    def metrics(self):
        m = self.face.contents.size.contents.metrics
        return (m.x_scale, m.y_scale, m.ascender, m.descender, m.height)

    def char_index(self, cp: int) -> int:
        return _ft.FT_Get_Char_Index(self.face, cp)

    def glyph_kind(self, gid: int) -> str:
        """The glyph slot's format after FT_LOAD_DEFAULT, Pillow's load:
        "bitmap" where a strike's bitmap is handed back, else
        "outline"."""
        assert _ft.FT_Load_Glyph(self.face, gid, FT_LOAD_DEFAULT) == 0
        fmt = self.face.contents.glyph.contents.format
        return GLYPH_FORMATS.get(fmt, hex(fmt))

    def outline_flags(self, gid: int, hinted: bool = True) -> int:
        """The loaded outline's flags (FT_OUTLINE_OVERLAP among them)."""
        flags = FT_LOAD_DEFAULT if hinted else FT_LOAD_NO_HINTING
        assert _ft.FT_Load_Glyph(self.face, gid, flags) == 0
        return self.face.contents.glyph.contents.outline.flags

    def outline(self, gid: int, hinted: bool = True):
        flags = FT_LOAD_DEFAULT if hinted else FT_LOAD_NO_HINTING
        assert _ft.FT_Load_Glyph(self.face, gid, flags) == 0
        o = self.face.contents.glyph.contents.outline
        n, c = o.n_points, o.n_contours
        pts = np.array([(o.points[i].x, o.points[i].y) for i in range(n)],
                       np.int64).reshape(n, 2)
        tags = np.array([o.tags[i] for i in range(n)], np.uint8)
        cont = np.array([o.contours[i] for i in range(c)], np.int64)
        return pts, tags, cont

    def advance(self, gid: int, hinted: bool = True):
        """(advance.x in 26.6, linearHoriAdvance in 16.16) of a glyph
        load."""
        flags = FT_LOAD_DEFAULT if hinted else FT_LOAD_NO_HINTING
        assert _ft.FT_Load_Glyph(self.face, gid, flags) == 0
        g = self.face.contents.glyph.contents
        return g.advance.x, g.linearHoriAdvance

    def italic_angle(self) -> int:
        """FT_Get_PS_Font_Info's italic_angle: a CFF Top DICT real as
        FreeType's cff_parse_real made it 16.16 (the one DICT real that
        FreeType reports for a CFF face)."""
        info = _PSFontInfo()
        _ft.FT_Get_PS_Font_Info.argtypes = [ctypes.POINTER(_Face),
                                            ctypes.POINTER(_PSFontInfo)]
        assert _ft.FT_Get_PS_Font_Info(self.face, ctypes.byref(info)) == 0
        return info.italic_angle

    def hb_shape(self, text: str):
        """[(glyph id, x_advance, y_advance, x_offset, y_offset)] in 26.6
        from hb_shape over hb_ft's font functions."""
        hb = _harfbuzz()
        font = hb.hb_ft_font_create_referenced(
            ctypes.cast(self.face, ctypes.c_void_p))
        buf = hb.hb_buffer_create()
        data = text.encode("utf-8")
        hb.hb_buffer_add_utf8(buf, data, len(data), 0, len(data))
        hb.hb_buffer_guess_segment_properties(buf)
        hb.hb_shape(font, buf, None, 0)
        n = ctypes.c_uint(0)
        info = hb.hb_buffer_get_glyph_infos(buf, ctypes.byref(n))
        pos = hb.hb_buffer_get_glyph_positions(buf, ctypes.byref(n))
        out = [(info[i].codepoint, pos[i].x_advance, pos[i].y_advance,
                pos[i].x_offset, pos[i].y_offset) for i in range(n.value)]
        hb.hb_buffer_destroy(buf)
        hb.hb_font_destroy(font)
        return out

    def bitmap(self, gid: int):
        """(uint8 [rows, width], left, top) of FT_LOAD_DEFAULT |
        FT_LOAD_RENDER, as Pillow renders a glyph for mode L."""
        assert _ft.FT_Load_Glyph(self.face, gid,
                                 FT_LOAD_DEFAULT | FT_LOAD_RENDER) == 0
        g = self.face.contents.glyph.contents
        b = g.bitmap
        out = np.zeros((b.rows, b.width), np.uint8)
        for r in range(b.rows):
            row = ctypes.string_at(ctypes.addressof(b.buffer.contents)
                                   + r * b.pitch, b.width)
            out[r] = np.frombuffer(row, np.uint8)
        return out, g.bitmap_left, g.bitmap_top
