"""effocr_torch's data layer against Pillow and the JAX package.

- data/png.py reads every PNG subformat (gray 1/2/4/8/16 bits, RGB 8/16,
  palette 1/2/4/8 with tRNS, gray + alpha and RGBA at 8/16, all five row
  filters, Adam7) exactly as ``Image.open(p).convert("RGB")`` does, the
  16-bit gray clip included; the gray pipeline's ``_LazyImage`` gives the
  JAX package's shape and pixels on one file of each; malformed JPEG,
  TIFF and BMP files raise with their format named, as in JAX, and WebP
  and arithmetic-coded JPEG are refused by name;
- ``pil_bilinear_resize`` equals Pillow's ``Image.BILINEAR`` bit for bit;
- ``CharFolderDataset`` (load_square, decode_all_gray, load_batch),
  ``split_indices``, the CLI glue (ann_stems, default_render_indices),
  the samplers copy, morphology and build-freq-dict equal the JAX
  package's exactly; ``apply_augment`` on draws made with ``jax.random``
  from augment_batch's key splits equals ``augment_batch`` within 1e-5.
"""

import functools
import json
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw, ImageFont

from effocr_tpu.cli import common as j_common
from effocr_tpu.data import folder as j_folder
from effocr_tpu.data import samplers as j_samplers
from effocr_tpu.data.transforms import augment_batch
from effocr_tpu.kernels import morphology as j_morph
from effocr_tpu.pipelines import infer as j_infer
from effocr_torch.cli import common
from effocr_torch.data import folder, png, samplers
from effocr_torch.data.transforms import apply_augment
from effocr_torch.kernels import morphology
from effocr_torch.pipelines import infer as t_infer

FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
CHARS = list("AXo")

# ------------------------------------------------------------ PNG writer
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_SPP = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pack_rows(px, depth):
    h = px.shape[0]
    if depth == 16:
        return px.astype(">u2").reshape(h, -1).view(np.uint8)
    v = px.reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return v
    per = 8 // depth
    v = np.concatenate([v, np.zeros((h, (-v.shape[1]) % per), np.uint8)], 1)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (v.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _filter_rows(rows, bpp, rng):
    """Each row under a random one of the five PNG filters."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for r in rows.astype(np.int32):
        ft = int(rng.integers(0, 5))
        shift = lambda v: np.concatenate(  # noqa: E731
            [np.zeros(bpp, np.int32), v[:-bpp]])[:len(v)]
        a, b, c = shift(r), prev, shift(prev)
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = [0, a, b, (a + b) // 2,
                np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))][ft]
        out.append(bytes([ft]) + ((r - pred) & 255).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def write_png(path, px, depth, color_type, interlace=0, palette=None,
              trns=None, seed=0):
    rng = np.random.default_rng(seed)
    h, w, spp = px.shape
    bpp = max(1, depth * spp // 8)
    if interlace:
        raw = b"".join(_filter_rows(_pack_rows(px[y0::dy, x0::dx], depth),
                                    bpp, rng)
                       for x0, y0, dx, dy in _ADAM7
                       if px[y0::dy, x0::dx].size)
    else:
        raw = _filter_rows(_pack_rows(px, depth), bpp, rng)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    comp = zlib.compress(raw, 6)
    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type,
                                      0, 0, interlace))
    if palette is not None:
        body += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        body += chunk(b"tRNS", trns)
    body += (chunk(b"IDAT", comp[:len(comp) // 2])
             + chunk(b"IDAT", comp[len(comp) // 2:]) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body)


_SUBFORMATS = [(ct, d, il) for ct, depths in ((0, (1, 2, 4, 8, 16)),
                                              (2, (8, 16)),
                                              (3, (1, 2, 4, 8)),
                                              (4, (8, 16)), (6, (8, 16)))
               for d in depths for il in (0, 1)]


def _subformat_png(tmp_path, ct, depth, interlace, seed):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(1, 26, 2))
    palette = trns = None
    if ct == 3:
        n = 1 << depth if depth < 8 else 200
        palette = rng.integers(0, 256, (n, 3))
        px = rng.integers(0, n, (h, w, 1))
        trns = bytes(rng.integers(0, 256, n // 2).astype(np.uint8))
    else:
        px = rng.integers(0, 1 << depth, (h, w, _SPP[ct]))
        if ct == 0 and depth == 16:
            px.flat[0], px.flat[-1] = 256, 1000   # clip to 255 in PIL
        if ct in (0, 2):
            trns = b"\x00\x05" * _SPP[ct]
    p = str(tmp_path / f"c{ct}_d{depth}_i{interlace}.png")
    write_png(p, px, depth, ct, interlace, palette, trns, seed)
    return p


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("ct,depth,interlace", _SUBFORMATS)
def test_png_reader_matches_pil(tmp_path, ct, depth, interlace):
    p = _subformat_png(tmp_path, ct, depth, interlace,
                       seed=ct * 100 + depth * 2 + interlace)
    im = Image.open(p)
    ref = np.asarray(im.convert("RGB"))
    got = png.read_png(p, 3)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    # the JAX package's gray-pipeline shape and pixels (_LazyImage, PIL
    # behind it); 8-bit gray and RGB without interlace take the native path
    jl, tl = j_infer._LazyImage(p, gray=True), t_infer._LazyImage(p,
                                                                  gray=True)
    assert tl.shape == jl.shape
    np.testing.assert_array_equal(tl.load(), jl.load())
    jl, tl = j_infer._LazyImage(p, gray=False), t_infer._LazyImage(
        p, gray=False)
    np.testing.assert_array_equal(tl.load(), jl.load())
    if ct == 0 and depth == 16:
        assert ref.max() == 255 and got.max() == 255


# SOF9 (arithmetic coding) of a 16 x 16 gray image
_SOF9 = b"\xff\xc9\x00\x0b\x08\x00\x10\x00\x10\x01\x01\x11\x00"


@pytest.mark.parametrize("data,name,refused", [
    (b"\xff\xd8\xff\xe0" + bytes(64), "JPEG", None),
    (b"II*\x00" + bytes(64), "TIFF", None),
    (b"BM" + bytes(64), "BMP", None),
    (b"RIFF\x40\x00\x00\x00WEBPVP8 " + bytes(64), "WebP", "WebP"),
    (b"\xff\xd8" + _SOF9 + bytes(64), "JPEG", "arithmetic coding"),
])
def test_non_png_raises_with_its_format(tmp_path, data, name, refused):
    """A malformed JPEG, TIFF or BMP file (magic bytes, then zeros)
    raises an error naming its format, in the port as in JAX (the port
    decodes these formats now); what the port still refuses, WebP and
    arithmetic-coded JPEG, raises NotImplementedError naming it and
    ROADMAP.md.  data/png.py keeps its PNG-only API and names the
    format."""
    p = str(tmp_path / "x.img")
    with open(p, "wb") as f:
        f.write(data)
    if refused:
        with pytest.raises(NotImplementedError, match=f"{refused}.*ROADMAP"):
            t_infer._LazyImage(p, gray=True)
    else:
        with pytest.raises(OSError, match=name):
            t_infer._LazyImage(p, gray=True)
        with pytest.raises(OSError):
            j_infer._LazyImage(p, gray=True)
    with pytest.raises((ValueError, NotImplementedError), match=name):
        png.read_png(p)


@pytest.mark.parametrize("channels", [1, 3])
def test_pil_bilinear_resize_matches_pillow(channels):
    rng = np.random.default_rng(channels)
    for side in (1, 2, 5, 31, 64, 97, 128, 200, 300):
        for out in (1, 7, 32, 64, 128, 224, 300):
            img = rng.integers(0, 256, (side, side + side % 3, channels),
                               np.uint8)
            src = img[..., 0] if channels == 1 else img
            ref = np.asarray(Image.fromarray(src).resize((out, out),
                                                         Image.BILINEAR))
            got = folder.pil_bilinear_resize(img, out, out)
            np.testing.assert_array_equal(got.reshape(ref.shape), ref,
                                          err_msg=f"{side} -> {out}")


# ----------------------------------------------------------- char tree
@pytest.fixture(scope="module")
def char_tree(tmp_path_factory):
    """tests/test_trainers.py's tree: per char one render and PAIRED crops
    of lines line0-line2, plus a palette render to reach data/png.py."""
    root = tmp_path_factory.mktemp("chars")
    font = ImageFont.truetype(FONT, 40)
    for c in CHARS:
        d = root / str(ord(c))
        d.mkdir()
        img = Image.new("RGB", (64, 64), (255, 255, 255))
        ImageDraw.Draw(img).text((12, 8), c, (0, 0, 0), font=font)
        img.save(d / f"{hex(ord(c))}_0_TestFont-Regular.png")
        img.convert("P").save(d / f"{hex(ord(c))}_1_Other-Regular.png")
        for li in range(3):
            img2 = Image.new("RGB", (60, 62), (255, 255, 255))
            ImageDraw.Draw(img2).text((10, 8), c, (20, 20, 20), font=font)
            img2.save(d / f"PAIRED_line{li}_{li}_{hex(ord(c))}_{li}.png")
    return str(root)


def test_char_folder_dataset_matches_jax(char_tree):
    ds, jds = folder.CharFolderDataset(char_tree), j_folder.CharFolderDataset(
        char_tree)
    assert ds.data == jds.data and ds.class_to_idx == jds.class_to_idx
    for i in range(len(ds)):
        assert ds.char_for_path(ds.data[i][0]) == jds.char_for_path(
            jds.data[i][0])
        assert ds.is_paired(i) == jds.is_paired(i)
    for size in (32, 64, 77):
        for i in range(len(ds)):
            np.testing.assert_array_equal(ds.load_square(i, size),
                                          jds.load_square(i, size))
    np.testing.assert_array_equal(ds.decode_all_gray(32),
                                  jds.decode_all_gray(32))
    idx = list(range(len(ds)))[::-1]
    for a, b in zip(ds.load_batch(idx, 48), jds.load_batch(idx, 48)):
        np.testing.assert_array_equal(a, b)
    assert ds.render_indices("Other") == jds.render_indices("Other")
    assert ds.paired_indices_for_stems(["line1"]) == \
        jds.paired_indices_for_stems(["line1"])
    for kw in ({}, {"finetune": True}, {"pretrain": True}):
        assert folder.split_indices(ds, ["line0"], ["line1"], ["line2"],
                                    **kw) == j_folder.split_indices(
            jds, ["line0"], ["line1"], ["line2"], **kw)
    for lang, name in (("en", None), ("jp", None), ("en", "Other")):
        assert common.default_render_indices(ds, lang, name) == \
            j_common.default_render_indices(jds, lang, name)


def test_ann_stems_match(tmp_path):
    p = str(tmp_path / "split.json")
    with open(p, "w") as f:
        json.dump({"images": [{"id": 0, "file_name": "a/line7.png"},
                              {"id": 1, "file_name": "x.y.png"}]}, f)
    assert common.ann_stems(p) == j_common.ann_stems(p) == ["a/line7", "x.y"]


def test_samplers_copy_matches():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 12, 200).tolist()
    for seed in (0, 5):
        a = list(samplers.NoReplacementMPerClassSampler(labels, 4, 16, 3,
                                                        seed))
        b = list(j_samplers.NoReplacementMPerClassSampler(labels, 4, 16, 3,
                                                          seed))
        assert a == b
        class_to_idx = {str(ord("a") + i): i for i in range(12)}
        hns = ["abcdefgh", "ijklabcd", "zzzzzzzz"]
        a = list(samplers.HardNegativeClassSampler(
            labels, class_to_idx, hns, m=2, batch_size=8, num_passes=2,
            seed=seed))
        b = list(j_samplers.HardNegativeClassSampler(
            labels, class_to_idx, hns, m=2, batch_size=8, num_passes=2,
            seed=seed))
        assert a == b
    assert list(samplers.batch_iterator(iter(range(10)), 4, False)) == \
        list(j_samplers.batch_iterator(iter(range(10)), 4, False))


@pytest.mark.parametrize("kh,kw", [(3, 2), (3, 3), (4, 2), (4, 3)])
def test_morphology_matches(kh, kw):
    x = np.random.default_rng(kh * 10 + kw).uniform(
        0, 1, (2, 9, 11, 3)).astype(np.float32)
    for t_op, j_op in ((morphology.erode, j_morph.erode),
                       (morphology.dilate, j_morph.dilate)):
        np.testing.assert_array_equal(
            t_op(torch.from_numpy(x), kh, kw).numpy(),
            np.asarray(j_op(jnp.asarray(x), kh, kw)))


def torch_draws(d):
    """A draws dict of JAX arrays as the torch tensors apply_augment takes."""
    return {k: torch.from_numpy(np.array(v)).long()
            if v.dtype == jnp.int32 else torch.from_numpy(np.array(v))
            for k, v in d.items()}


def jax_draws(key, b, size, lang="en", high_blur=False, crop_sim=0.0,
              paired_jitter=0.0):
    """The draws augment_batch makes from ``key``: the same 19-way split
    and sub-splits, shapes and ranges, Bernoulli masks included.  Traced
    inside the jit of the JAX call it is compared with, so that one
    program compiles per case."""
    keys = jax.random.split(key, 19)
    uni, bern = jax.random.uniform, jax.random.bernoulli
    tmax, smin, smax = (0.1, 0.9, 1.1) if lang == "en" else (0.2, 0.8, 1.0)
    d = {}
    if crop_sim > 0.0:
        d["crop_scale"] = uni(keys[15], (b,), minval=0.45, maxval=0.85)
        d["crop_apply"] = bern(keys[16], crop_sim, (b,))
    d["scale"] = uni(keys[0], (b,), minval=smin, maxval=smax)
    d["tx"] = uni(keys[1], (b,), minval=-tmax, maxval=tmax)
    d["ty"] = uni(keys[2], (b,), minval=-tmax, maxval=tmax)
    d["affine_apply"] = bern(keys[3], 0.7, (b,))
    d["color"] = uni(keys[4], (b, 1, 1, 3))
    d["shift_apply"] = bern(keys[12], 0.25, (b,))
    jk = jax.random.split(keys[5], 5)
    d["brightness"] = uni(jk[0], (b, 1, 1, 1), minval=0.5, maxval=1.5)
    d["contrast"] = uni(jk[1], (b, 1, 1, 1), minval=0.7, maxval=1.3)
    d["saturation"] = uni(jk[2], (b, 1, 1, 1), minval=0.7, maxval=1.3)
    d["hue"] = uni(jk[3], (b,), minval=-0.3, maxval=0.3)
    d["jitter_apply"] = bern(jk[4], 0.5, (b,))
    if lang == "en":
        d["morph_apply"] = bern(keys[6], 0.5, (b,))
        k1, k2, _ = jax.random.split(keys[7], 3)
        d["morph_variant"] = jax.random.randint(k1, (b,), 0, 4)
        d["morph_dilate"] = bern(k2, 0.5, (b,))
    d["noise_var"] = uni(keys[8], (b, 1, 1, 1), minval=10.0, maxval=150.0)
    d["noise"] = jax.random.normal(keys[13], (b, size, size, 3))
    d["noise_apply"] = bern(keys[9], 0.25, (b,))
    d["blur_sigma"] = (uni(keys[10], (b,), minval=1.0, maxval=4.0)
                       if high_blur else
                       uni(keys[10], (b,), minval=0.1, maxval=2.0))
    d["blur_apply"] = bern(keys[14], 0.3, (b,))
    d["gray_apply"] = bern(keys[11], 0.2, (b,))
    if paired_jitter > 0.0:
        pk = jax.random.split(keys[18], 4)
        d["pj_scale"] = uni(pk[0], (b,), minval=0.94, maxval=1.06)
        d["pj_tx"] = uni(pk[1], (b,), minval=-0.05, maxval=0.05)
        d["pj_ty"] = uni(pk[2], (b,), minval=-0.05, maxval=0.05)
        d["pj_apply"] = bern(pk[3], paired_jitter, (b,))
    return d


AUGMENT_CASES = [("en", False, 0.0, 0.0, 3), ("en", True, 0.6, 0.5, 1),
                 ("jp", False, 1.0, 1.0, 3), ("jp", True, 0.6, 0.5, 1)]


def _augment_inputs(lang, channels):
    rng = np.random.default_rng(len(lang) + channels)
    imgs = rng.integers(0, 256, (8, 24, 24, 3), np.uint8)
    imgs[:, :, :5] = 255
    paired = np.array([0, 1, 0, 0, 1, 0, 1, 0], bool)
    return imgs, paired, jax.random.PRNGKey(int(rng.integers(1 << 30)))


@functools.lru_cache(maxsize=1)
def _augment_refs():
    """{case index: (augment_batch, its draws)} for AUGMENT_CASES,
    and the no_aug output of the first, in one compiled JAX program (one
    compile per case costs twice as long)."""
    def run(*flat):
        out = {}
        for i, (lang, hb, cs, pj, ch) in enumerate(AUGMENT_CASES):
            x, p, k = flat[3 * i:3 * i + 3]
            out[str(i)] = (augment_batch(x, p, k, lang=lang, high_blur=hb,
                                    crop_sim=cs, paired_jitter=pj,
                                    out_channels=ch),
                      jax_draws(k, x.shape[0], x.shape[1], lang, hb, cs, pj))
        x, p, k = flat[:3]
        out["no_aug"] = augment_batch(x, p, k, no_aug=True,
                                      out_channels=AUGMENT_CASES[0][-1])
        return out

    flat = [jnp.asarray(a) for c in AUGMENT_CASES
            for a in _augment_inputs(c[0], c[-1])]
    return jax.jit(run)(*flat)


@pytest.mark.parametrize("lang,high_blur,crop_sim,paired_jitter,channels",
                         AUGMENT_CASES)
def test_apply_augment_matches_augment_batch(lang, high_blur, crop_sim,
                                             paired_jitter, channels):
    imgs, paired, _ = _augment_inputs(lang, channels)
    b, s = imgs.shape[:2]
    refs = _augment_refs()
    ref, draws = refs[str(AUGMENT_CASES.index(
        (lang, high_blur, crop_sim, paired_jitter, channels)))]
    got = apply_augment(
        torch.from_numpy(imgs), torch.from_numpy(paired), torch_draws(draws),
        lang=lang, high_blur=high_blur, crop_sim=crop_sim,
        paired_jitter=paired_jitter, out_channels=channels).numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (b, s, s, channels)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if lang != "en" or high_blur:
        return
    # no_aug: normalise only
    got = apply_augment(torch.from_numpy(imgs), torch.from_numpy(paired),
                        None, no_aug=True, out_channels=channels).numpy()
    np.testing.assert_allclose(got, np.asarray(refs["no_aug"]), rtol=0,
                               atol=1e-6)


def test_build_freq_dict_matches(tmp_path, monkeypatch):
    """``build-freq-dict`` of the port writes the JAX command's bytes on
    the same text and COCO inputs."""
    import sys

    from effocr_tpu.cli import build_freq_dict as j_bfd
    from effocr_torch.cli import build_freq_dict as t_bfd

    text = tmp_path / "book.txt"
    text.write_text("The cat's hat; the CAT sat.\nA dog, a cat: a hat!\n")
    coco = tmp_path / "c.json"
    coco.write_text(json.dumps({"images": [{"text": "Dog days, the end"},
                                           {"id": 2}]}))
    outs = []
    for name, main in (("torch", t_bfd.main), ("jax", j_bfd.main)):
        out = tmp_path / f"{name}.txt"
        argv = ["--out", str(out), "--text_files", str(text),
                "--coco_jsons", str(coco), "--merge_builtin", "--min_len",
                "2"]
        monkeypatch.setattr(sys, "argv", ["build-freq-dict", *argv])
        main()
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and b"cat " in outs[0]
