"""Render augmentation on the device (the JAX package's data/transforms.py
``augment_batch``), split in two:

- ``draw_augment(generator, ...)`` makes every random draw of one batch
  (the per-sample parameters, the Bernoulli apply masks and the noise
  field) from a ``torch.Generator`` on the training device;
- ``apply_augment(images_u8, is_paired, draws, ...)`` does all the
  arithmetic, with no randomness of its own.

So the arithmetic can be held to the JAX function on draws made with
``jax.random`` from the same 19 key splits.  The components and their
probabilities are the JAX package's:

  crop_sim (p=crop_sim): warp a render to paired-crop geometry
  random affine (p=.7; en: translate .1 / scale .9-1.1, jp: .2 / .8-1.0,
      white fill)                                 -> separable matmul warp
  colour shift (p=.25): pixels >= 0.8 -> one random colour
  colour jitter (p=.5): brightness .5, contrast .3, saturation .3, hue .3
      (YIQ rotation)
  erode/dilate (p=.5, en only), rectangles {3,4}x{2,3}
  gaussian noise (p=.25, variance 10-150 on the uint8 scale)
  gaussian blur (p=.3; sigma U(.1, 2), 11 taps; high_blur U(1, 4), 15)
  grayscale (p=.2)
  paired crops: no augmentation, or (p=paired_jitter) a small affine
  ImageNet normalisation, after reducing to ``out_channels``

With ``adjacent_bank`` (uint8 [V, N, S, S] from data/fonts.py
``render_adjacent_bank``) the neighbour-glyph composite runs first:
slivers of adjacent glyphs at the crop edges (``_compose_adjacent``),
its draws made by ``draw_augment(..., adjacent=(V, N))``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from effocr_torch.kernels.image_ops import normalize_imagenet
from effocr_torch.kernels.morphology import dilate, erode

_MORPH_KERNELS = ((3, 2), (3, 3), (4, 2), (4, 3))
_YIQ_FROM_RGB = ((0.299, 0.587, 0.114),
                 (0.5959, -0.2746, -0.3213),
                 (0.2115, -0.5227, 0.3112))


def _affine_params(lang: str) -> Tuple[float, float, float]:
    return (0.1, 0.9, 1.1) if lang == "en" else (0.2, 0.8, 1.0)


def draw_augment(generator: torch.Generator, b: int, size: int,
                 lang: str = "en", high_blur: bool = False,
                 crop_sim: float = 0.0, paired_jitter: float = 0.0,
                 adjacent: Optional[Tuple[int, int]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Every random draw of one batch of ``b`` squares of side ``size``,
    on the generator's device, in the value ranges of ``augment_batch``
    (uniforms already scaled to [min, max); masks as bool).  ``adjacent``
    = (sides, glyphs) of a neighbour-glyph bank adds its draws: the
    number of sides (``_ADJ_PROBS``), a uniform per side whose rank picks
    the sides, and a glyph per side."""
    dev = generator.device

    def u(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=generator, device=dev) * (
            hi - lo) + lo

    def bern(p):
        return torch.rand((b,), generator=generator, device=dev) < p

    tmax, smin, smax = _affine_params(lang)
    d = {}
    if crop_sim > 0.0:
        d["crop_scale"] = u((b,), 0.45, 0.85)
        d["crop_apply"] = bern(crop_sim)
    d["scale"] = u((b,), smin, smax)
    d["tx"] = u((b,), -tmax, tmax)
    d["ty"] = u((b,), -tmax, tmax)
    d["affine_apply"] = bern(0.7)
    d["color"] = u((b, 1, 1, 3))
    d["shift_apply"] = bern(0.25)
    d["brightness"] = u((b, 1, 1, 1), 0.5, 1.5)
    d["contrast"] = u((b, 1, 1, 1), 0.7, 1.3)
    d["saturation"] = u((b, 1, 1, 1), 0.7, 1.3)
    d["hue"] = u((b,), -0.3, 0.3)
    d["jitter_apply"] = bern(0.5)
    if lang == "en":
        d["morph_apply"] = bern(0.5)
        d["morph_variant"] = torch.randint(0, 4, (b,), generator=generator,
                                           device=dev)
        d["morph_dilate"] = bern(0.5)
    d["noise_var"] = u((b, 1, 1, 1), 10.0, 150.0)
    d["noise"] = torch.randn((b, size, size, 3), generator=generator,
                             device=dev)
    d["noise_apply"] = bern(0.25)
    d["blur_sigma"] = u((b,), 1.0, 4.0) if high_blur else u((b,), 0.1, 2.0)
    d["blur_apply"] = bern(0.3)
    d["gray_apply"] = bern(0.2)
    if paired_jitter > 0.0:
        d["pj_scale"] = u((b,), 0.94, 1.06)
        d["pj_tx"] = u((b,), -0.05, 0.05)
        d["pj_ty"] = u((b,), -0.05, 0.05)
        d["pj_apply"] = bern(paired_jitter)
    if adjacent is not None:
        v, n = adjacent
        cum = torch.tensor(_ADJ_PROBS[lang], dtype=torch.float64,
                           device=dev).cumsum(0)
        pick = torch.rand((b,), generator=generator, device=dev,
                          dtype=torch.float64)
        d["adj_n"] = torch.clamp(torch.searchsorted(cum, pick, right=True),
                                 max=len(_ADJ_PROBS[lang]) - 1)
        d["adj_u"] = u((b, v))
        d["adj_glyph"] = torch.randint(0, n, (b, v), generator=generator,
                                       device=dev)
    return d


# the reference's categorical over how many sides get a neighbour
_ADJ_PROBS = {"jp": (0.7, 0.2, 0.05, 0.05, 0.0), "en": (0.5, 0.25, 0.25)}


@functools.lru_cache(maxsize=8)
def _unit_lut(device: torch.device) -> torch.Tensor:
    """uint8 value / 255 as float32, divided once on the host, so every
    device gets the same bits (CUDA divides by a scalar through its
    reciprocal, one ulp off the CPU's quotient)."""
    return (torch.arange(256, dtype=torch.float32) / 255.0).to(device)


def _to_unit(u8: torch.Tensor) -> torch.Tensor:
    return _unit_lut(u8.device)[u8.long()]


def _compose_adjacent(x: torch.Tensor, bank: torch.Tensor,
                      draws: Dict[str, torch.Tensor], lang: str
                      ) -> torch.Tensor:
    """AddAdjacentChars / AddAdjacentCharsEng: composite neighbour-glyph
    slivers at the crop edges (the JAX package's ``_compose_adjacent``).
    Per sample ``adj_n`` sides, chosen by the ranks of ``adj_u``, one
    glyph ``adj_glyph`` each, merged with min() (dark ink on white).
    Sides: l, r (en) or l, r, t, b (jp); each glyph of ``bank`` [V, N, S,
    S] sits flush against the edge it peeks in from."""
    b, size = x.shape[0], x.shape[1]
    v = bank.shape[0]
    if lang == "jp":
        offx = size // 10
        peek = [offx, offx, max(offx // 2, 1), max(offx // 2, 1)]
    else:
        offx = size // 8
        peek = [offx, offx]
    ranks = torch.argsort(torch.argsort(draws["adj_u"], dim=1), dim=1)
    active = ranks < draws["adj_n"][:, None]
    gidx = draws["adj_glyph"]
    for s_i in range(v):
        g = _to_unit(bank[s_i][gidx[:, s_i]])
        p = peek[s_i]
        sliver = torch.ones((b, size, size), dtype=torch.float32,
                            device=x.device)
        if s_i == 0:
            sliver[:, :, :p] = g[:, :, size - p:]
        elif s_i == 1:
            sliver[:, :, size - p:] = g[:, :, :p]
        elif s_i == 2:
            sliver[:, :p, :] = g[:, size - p:, :]
        else:
            sliver[:, size - p:, :] = g[:, :p, :]
        merged = torch.minimum(x, sliver[..., None])
        x = torch.where(active[:, s_i][:, None, None, None], merged, x)
    return x


def _affine_matrix(size: int, scale: torch.Tensor, tx: torch.Tensor,
                   ty: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample separable warp matrices A_y, A_x [B, S_dst, S_src]:
    inverse map about the centre, src = (dst - c - t) / scale + c."""
    s = torch.arange(size, dtype=torch.float32, device=scale.device)
    c = (size - 1) / 2.0

    def one_axis(sc, t):
        src = (s[None, :] - c - t[:, None]) / sc[:, None] + c
        return torch.clamp(1.0 - torch.abs(src[:, :, None]
                                           - s[None, None, :]), min=0.0)

    return one_axis(scale, ty), one_axis(scale, tx)


def _apply_affine(img: torch.Tensor, a_y: torch.Tensor, a_x: torch.Tensor,
                  fill: float = 1.0) -> torch.Tensor:
    """img [B, S, S, C]; white fill where the warp samples outside."""
    t = torch.einsum("bis,bswc->biwc", a_y, img)
    out = torch.einsum("bjw,biwc->bijc", a_x, t)
    mass = a_y.sum(2)[:, :, None] * a_x.sum(2)[:, None, :]
    return out + (1.0 - mass)[..., None] * fill


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device) -> torch.Tensor:
    """float32 constants, made once per device (a host->device copy per
    step would wait for the device)."""
    if name == "gray":
        t = torch.tensor([0.299, 0.587, 0.114])
    elif name == "yiq_from_rgb":
        t = torch.tensor(_YIQ_FROM_RGB, dtype=torch.float32)
    else:   # inverted in float32 on the CPU, as the JAX function does
        t = torch.linalg.inv(torch.tensor(_YIQ_FROM_RGB, dtype=torch.float32))
    return t.to(device)


def _rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * _const("gray", x.device), dim=-1, keepdim=True)


def _adjust_hue(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Hue rotation in YIQ space (delta in turns); per sample."""
    yiq_from_rgb = _const("yiq_from_rgb", x.device)
    rgb_from_yiq = _const("rgb_from_yiq", x.device)
    theta = (2.0 * math.pi * delta)[:, None, None, None]
    yiq = torch.einsum("bhwc,dc->bhwd", x, yiq_from_rgb)
    cos, sin = torch.cos(theta), torch.sin(theta)
    i = yiq[..., 1:2] * cos - yiq[..., 2:3] * sin
    q = yiq[..., 1:2] * sin + yiq[..., 2:3] * cos
    yiq = torch.cat([yiq[..., :1], i, q], dim=-1)
    return torch.einsum("bhwd,cd->bhwc", yiq, rgb_from_yiq)


def _separable_blur(x: torch.Tensor, sigma: torch.Tensor, ksize: int
                    ) -> torch.Tensor:
    """Per-sample gaussian blur by shifted adds, edge-padded; x [B,S,S,C],
    sigma [B]."""
    r = ksize // 2
    offs = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    taps = torch.exp(-0.5 * (offs[None, :] / sigma[:, None]) ** 2)
    taps = taps / torch.sum(taps, dim=1, keepdim=True)

    def pass_axis(y, axis):
        n = y.shape[axis]
        idx = torch.clamp(torch.arange(-r, n + r, device=y.device), 0, n - 1)
        yp = torch.index_select(y, axis, idx)
        out = torch.zeros_like(y)
        for j in range(ksize):
            out = out + yp.narrow(axis, j, n) * taps[:, j][:, None, None,
                                                            None]
        return out

    return pass_axis(pass_axis(x, 1), 2)


def _erode_dilate(x: torch.Tensor, variant: torch.Tensor,
                  do_dilate: torch.Tensor) -> torch.Tensor:
    """Per sample one of the four rectangles, eroded or dilated."""
    er = torch.stack([erode(x, kh, kw) for kh, kw in _MORPH_KERNELS])
    di = torch.stack([dilate(x, kh, kw) for kh, kw in _MORPH_KERNELS])
    rows = torch.arange(x.shape[0], device=x.device)
    return torch.where(do_dilate[:, None, None, None], di[variant, rows],
                       er[variant, rows])


def _select(apply: torch.Tensor, new: torch.Tensor, old: torch.Tensor
            ) -> torch.Tensor:
    return torch.where(apply[:, None, None, None], new, old)


def _to_channels(x: torch.Tensor, out_channels: int) -> torch.Tensor:
    """RGB float crops -> ``out_channels`` (mean over channels for 1)."""
    if out_channels == 1 and x.shape[-1] != 1:
        return torch.mean(x, dim=-1, keepdim=True)
    return x


def apply_augment(images_u8: torch.Tensor, is_paired: torch.Tensor,
                  draws: Dict[str, torch.Tensor], lang: str = "en",
                  high_blur: bool = False, no_aug: bool = False,
                  crop_sim: float = 0.0, paired_jitter: float = 0.0,
                  out_channels: int = 3,
                  adjacent_bank: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """uint8 [B, S, S, 3] white-padded squares -> normalised float32
    [B, S, S, out_channels].  Renders take the augmentation stack, paired
    crops (``is_paired``) the plain transform or the paired jitter;
    ``no_aug`` skips augmentation for everyone (``draws`` unused).
    ``adjacent_bank`` composites neighbour glyphs first, so the slivers
    ride through the rest of the stack."""
    x = _to_unit(images_u8)
    if no_aug:
        return normalize_imagenet(_to_channels(x, out_channels))
    plain = x
    b, size = x.shape[0], x.shape[1]

    if adjacent_bank is not None:
        x = _compose_adjacent(x, adjacent_bank, draws, lang)

    if crop_sim > 0.0:
        cs = draws["crop_scale"]
        off = (1.0 - cs) * (size / 2.0)
        zero = torch.zeros_like(cs)
        cs_tx, cs_ty = (zero, -off) if lang == "jp" else (-off, zero)
        b_y, b_x = _affine_matrix(size, cs, cs_tx, cs_ty)
        x = _select(draws["crop_apply"], _apply_affine(x, b_y, b_x), x)

    a_y, a_x = _affine_matrix(size, draws["scale"], draws["tx"] * size,
                              draws["ty"] * size)
    x = _select(draws["affine_apply"], _apply_affine(x, a_y, a_x), x)

    shifted = torch.where(x >= 0.8, draws["color"].expand_as(x), x)
    x = _select(draws["shift_apply"], shifted, x)

    j = torch.clamp(x * draws["brightness"], 0.0, 1.0)
    gray_mean = torch.mean(_rgb_to_gray(j), dim=(1, 2), keepdim=True)
    j = torch.clamp((j - gray_mean) * draws["contrast"] + gray_mean, 0.0, 1.0)
    j = torch.clamp(_rgb_to_gray(j) + (j - _rgb_to_gray(j))
                    * draws["saturation"], 0.0, 1.0)
    j = torch.clamp(_adjust_hue(j, draws["hue"]), 0.0, 1.0)
    x = _select(draws["jitter_apply"], j, x)

    if lang == "en":
        x = _select(draws["morph_apply"],
                    _erode_dilate(x, draws["morph_variant"],
                                  draws["morph_dilate"]), x)

    noise = draws["noise"] * torch.sqrt(draws["noise_var"]) / 255.0
    x = _select(draws["noise_apply"], torch.clamp(x + noise, 0.0, 1.0), x)

    sscale = size / 224.0
    blurred = _separable_blur(x, draws["blur_sigma"] * sscale,
                              15 if high_blur else 11)
    x = _select(draws["blur_apply"], blurred, x)

    x = _select(draws["gray_apply"], _rgb_to_gray(x).expand_as(x), x)

    paired_x = plain
    if paired_jitter > 0.0:
        p_y, p_x = _affine_matrix(size, draws["pj_scale"],
                                  draws["pj_tx"] * size,
                                  draws["pj_ty"] * size)
        paired_x = _select(draws["pj_apply"],
                           _apply_affine(plain, p_y, p_x), plain)
    x = torch.where(is_paired[:, None, None, None], paired_x, x)
    return normalize_imagenet(_to_channels(x, out_channels))
