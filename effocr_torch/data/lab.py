"""Pillow's LAB -> RGB conversion, bit for bit, in numpy.

``Image.convert("RGB")`` of a LAB image goes through ImageCms: a Little
CMS 2 transform from its built-in Lab profile (v2, D50) to its built-in
sRGB profile, perceptual intent, 8 bits in and out.  Little CMS drops
the Lab profile's identity stages, leaving Lab -> XYZ (D50), the inverse
of sRGB's colorant matrix (Rec. 709 primaries, D65 white adapted to D50
by Bradford) and sRGB's inverse tone curve (parametric type -4).  An
8-bit transform samples that pipeline, in float, at the nodes of a 33^3
grid of 16-bit words (``cmsStageSampleCLut16bit``) and interpolates the
pixels tetrahedrally in 16-bit fixed point (``TetrahedralInterp16``);
words become bytes as ``FROM_16_TO_8`` makes them.  This module does the
same, with Little CMS's float32 stage boundaries and its fast floor.

Pillow keeps a LAB pixel's a* and b* offset by 128 (Little CMS's 8-bit
Lab) and shows them signed (``np.asarray``, the TIFF's own bytes): the
pixels here are the shown ones.
"""

from __future__ import annotations

import functools

import numpy as np

_GRID = 33
_MAX_XYZ = 1.0 + 32767.0 / 32768.0   # MAX_ENCODEABLE_XYZ
_D50 = (0.9642, 1.0, 0.8249)
# sRGB's tone curve: IEC 61966-2.1, Little CMS's parametric type 4
_SRGB = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)


def _inverse(a):
    """cmsMAT3inverse, in its order of operations."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _matmul(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
             for j in range(3)] for i in range(3)]


def _matvec(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2]
            for i in range(3)]


def _srgb_to_xyz_d50():
    """cmsCreate_sRGBProfile's colorants: _cmsBuildRGB2XYZtransferMatrix
    for D65 and the Rec. 709 primaries, adapted to D50 (Bradford)."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    prim = [[xr, xg, xb], [yr, yg, yb],
            [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]
    coef = _matvec(_inverse(prim), [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    rgb2xyz = [[coef[k] * prim[i][k] for k in range(3)] for i in range(3)]
    cone = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
            [0.0389, -0.0685, 1.0296]]
    src = _matvec(cone, [(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0])
    dst = _matvec(cone, list(_D50))
    scale = [[dst[i] / src[i] if i == j else 0 for j in range(3)]
             for i in range(3)]
    bradford = _matmul(_inverse(cone), _matmul(scale, cone))
    return _matmul(bradford, rgb2xyz)


def _quick_word(v: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord(v * 65535): + 0.5, then Little CMS's fast
    floor (a 16.16 fixed-point read, rounded to nearest even)."""
    d = v.astype(np.float64) * 65535.0 + 0.5
    q = np.rint(d * 65536.0).astype(np.int64) >> 16
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, q))


@functools.lru_cache(maxsize=1)
def _clut() -> np.ndarray:
    """int64 [33^3 * 3]: the pipeline at every grid node (L, a, b in
    Little CMS's v4 16-bit encoding), as 16-bit RGB words."""
    inv = [[v * _MAX_XYZ for v in row] for row in _inverse(
        _srgb_to_xyz_d50())]
    g = np.floor(np.arange(_GRID) * 65535.0 / (_GRID - 1) + 0.5)
    nodes = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    f = nodes.astype(np.float32) / np.float32(65535.0)
    # Lab -> XYZ (EvaluateLab2XYZ, cmsLab2XYZ with D50)
    y = (f[:, 0].astype(np.float64) * 100.0 + 16.0) / 116.0
    x = y + 0.002 * (f[:, 1].astype(np.float64) * 255.0 - 128.0)
    z = y - 0.005 * (f[:, 2].astype(np.float64) * 255.0 - 128.0)

    def f_1(t):
        return np.where(t <= 24.0 / 116.0,
                        (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)

    xyz = np.stack([f_1(x) * _D50[0] / _MAX_XYZ, f_1(y) * _D50[1] / _MAX_XYZ,
                    f_1(z) * _D50[2] / _MAX_XYZ], -1).astype(np.float32)
    # the inverse colorant matrix (EvaluateMatrix: double sums)
    rgb = np.stack([sum(xyz[:, j].astype(np.float64) * inv[i][j]
                        for j in range(3)) for i in range(3)],
                   -1).astype(np.float32).astype(np.float64)
    # the inverse tone curve (DefaultEvalParametricFn, type -4)
    g_, a, b, c, d = _SRGB
    with np.errstate(invalid="ignore"):
        hi = (np.power(np.maximum(rgb, 0), 1.0 / g_) - b) / a
    out = np.where(rgb >= (a * d + b) ** g_, hi, rgb / c).astype(np.float32)
    return _quick_word(out).reshape(-1)


def _fixed_domain(a: np.ndarray) -> np.ndarray:
    return a + (a + 0x7FFF) // 0xFFFF


def _tetrahedral(w: np.ndarray) -> np.ndarray:
    """TetrahedralInterp16 of 16-bit words [N, 3] (L, a, b) -> [N, 3]:
    from the cell's first corner along the three axes in the order of
    their remainders, largest first, each step weighed by its axis's
    remainder."""
    table = _clut()
    fixed = [_fixed_domain(w[:, k].astype(np.int64) * (_GRID - 1))
             for k in range(3)]
    rest = np.stack([v & 0xFFFF for v in fixed], -1)
    stride = (3 * _GRID * _GRID, 3 * _GRID, 3)
    base = sum((v >> 16) * s for v, s in zip(fixed, stride))
    step = np.stack([np.where(w[:, k] == 0xFFFF, 0, stride[k])
                     for k in range(3)], -1)
    rx, ry, rz = rest.T
    # lcms's six cases, as axis orders (its ties break this way)
    order = np.select(
        [(rx >= ry) & (ry >= rz), (rx >= ry) & (rz >= rx),
         (rx >= ry), (rx >= rz), (ry >= rz)],
        [0, 1, 2, 3, 4], 5)
    axes = np.array([(0, 1, 2), (2, 0, 1), (0, 2, 1), (1, 0, 2), (1, 2, 0),
                     (2, 1, 0)])[order]
    rows = np.arange(len(w))
    out = np.empty((len(w), 3), np.int64)
    for ch in range(3):
        at = base + ch
        prev = table[at]
        acc = np.full(len(w), 0x8001, np.int64)
        for k in range(3):
            ax = axes[:, k]
            at = at + step[rows, ax]
            cur = table[at]
            acc += (cur - prev) * rest[rows, ax]
            prev = cur
        c0 = table[base + ch]
        out[:, ch] = (c0 + ((acc + (acc >> 16)) >> 16)) & 0xFFFF
    return out


def lab_to_rgb(px: np.ndarray) -> np.ndarray:
    """uint8 [..., 3] LAB pixels as ``np.asarray`` shows them -> uint8
    [..., 3] RGB, ``Image.convert("RGB")``."""
    flat = px.reshape(-1, 3) ^ np.array([0, 128, 128], np.uint8)
    out = np.empty((flat.shape[0], 3), np.uint8)
    for s in range(0, flat.shape[0], 1 << 20):      # bounded temporaries
        words = _tetrahedral(flat[s:s + (1 << 20)].astype(np.int64) * 257)
        out[s:s + (1 << 20)] = (words * 65281 + 8388608) >> 24
    return out.reshape(px.shape)
