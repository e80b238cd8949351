"""Golden digests of the JAX package's glyph rendering, for the port's
renderer to be held to on a host without JAX or Pillow.

    python tests/torch_fixtures/make_fonts.py [--out FILE]

runs the JAX package (Pillow 12.1 through FreeType 2.14.1 and raqm) on
the committed DejaVu fonts in ``tests/torch_fixtures/fonts/`` and writes
``tests/torch_fixtures/fonts/golden.npz``:

- ``render_keys`` / ``render_digests``: for every font and each of the
  90 characters of the built-in en charsets (digits, letters,
  punctuation), the SHA-256 (``effocr_torch.data.imaging.digest_image``:
  mode, shape, pixels) of ``draw_single_char`` at canvas 256 and of
  ``draw_single_char_ascender`` at canvas 256;
- ``bank_en`` / ``bank_jp``: digests of ``render_adjacent_bank`` of
  DejaVuSerif at 128 px (chip_smoke.py's recognizer size);
- ``corpus_json``, ``corpus_images``: ``make-corpus`` of ``CORPUS_FLAGS``
  (512 en lines, seed 0, noise 8, blur 1) — the bytes of corpus.json and
  ``digest_tree`` of images/;
- ``charset``: the bytes' digest of ``make-charset`` with
  ``CHARSET_FLAGS`` (``--dedupe_renders``);
- ``dataset_tree``, ``dataset_crops``: ``digest_tree`` of the
  ``format-dataset`` tree and crops on that corpus and charset
  (``FORMAT_FLAGS``).

It needs Pillow and the JAX package, i.e. this host; chip_smoke.py's
``fonts`` phase reruns everything with the port and compares.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
FONT_DIR = os.path.join(HERE, "fonts")
FONTS = ("DejaVuSans.ttf", "DejaVuSansMono.ttf", "DejaVuSerif.ttf")
BANK_FONT = "DejaVuSerif.ttf"
BANK_SIZE = 128
CANVAS = 256
CORPUS_FLAGS = ["--n_lines", "512", "--lang", "en", "--seed", "0",
                "--noise_std", "8", "--blur_sigma", "1"]
CHARSET_FLAGS = ["--min_codepoint", "32", "--max_chars", "95",
                 "--dedupe_renders"]
FORMAT_FLAGS = ["--cat_id", "0", "--spaces", "--clip_to_top_and_bottom"]


def en_chars():
    from effocr_torch.data.builtin_charsets import english_charsets

    cs = english_charsets()
    return cs["digits"] + cs["letters"] + cs["punctuation"]


def file_digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def font_files(font_dir: str):
    return [os.path.join(font_dir, f) for f in FONTS]


def run_jax(module, argv):
    old = sys.argv
    sys.argv = [module.__name__] + list(argv)
    try:
        module.main()
    finally:
        sys.argv = old


def pipeline_outputs(work: str, font_dir: str, run) -> dict:
    """make-corpus, make-charset and format-dataset into ``work`` through
    ``run(command, argv)``; the digests of what they wrote."""
    from effocr_torch.data.imaging import digest_tree

    corpus = os.path.join(work, "corpus")
    run("make-corpus", ["--out_dir", corpus, "--font_dir", font_dir,
                        *CORPUS_FLAGS])
    charsets = os.path.join(work, "charsets_eng")
    run("make-charset", ["--font_dir", font_dir, "--out",
                         os.path.join(charsets, "eng_chars.txt"),
                         *CHARSET_FLAGS])
    run("format-dataset", ["--image_dir", os.path.join(corpus, "images"),
                           "--coco_jsons",
                           os.path.join(corpus, "corpus.json"),
                           "--crops_save_dir", os.path.join(work, "crops"),
                           "--font_dir", font_dir, "--charset_dir", charsets,
                           "--dataset_save_dir", os.path.join(work, "tree"),
                           *FORMAT_FLAGS])
    return {
        "corpus_json": file_digest(os.path.join(corpus, "corpus.json")),
        "corpus_images": digest_tree(os.path.join(corpus, "images")),
        "charset": file_digest(os.path.join(charsets, "eng_chars.txt")),
        "dataset_tree": digest_tree(os.path.join(work, "tree")),
        "dataset_crops": digest_tree(os.path.join(work, "crops")),
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(FONT_DIR, "golden.npz"))
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    from PIL import ImageFont

    from effocr_tpu.cli import format_dataset, make_charset, make_corpus
    from effocr_tpu.data import fonts as J
    from effocr_torch.data.imaging import digest_image

    keys, digests = [], []
    for fp in font_files(FONT_DIR):
        font = ImageFont.truetype(fp, size=CANVAS)
        name = os.path.basename(fp)
        for c in en_chars():
            for kind, fn in (("single", J.draw_single_char),
                             ("ascender", J.draw_single_char_ascender)):
                img = fn(c, font, CANVAS)
                keys.append(f"{name}|{kind}|{ord(c)}")
                digests.append("none" if img is None else digest_image(
                    np.asarray(img), img.mode))
    out = {"render_keys": np.array(keys), "render_digests": np.array(digests)}
    bank_font = os.path.join(FONT_DIR, BANK_FONT)
    for lang in ("en", "jp"):
        bank = J.render_adjacent_bank(bank_font, BANK_SIZE, lang)
        out[f"bank_{lang}"] = np.array(digest_image(bank, "L"))

    mods = {"make-corpus": make_corpus, "make-charset": make_charset,
            "format-dataset": format_dataset}
    work = tempfile.mkdtemp()
    try:
        # the fonts alone in a directory: format-dataset globs every file
        fonts = os.path.join(work, "fonts")
        os.makedirs(fonts)
        for fp in font_files(FONT_DIR):
            shutil.copy(fp, fonts)
        res = pipeline_outputs(work, fonts,
                               lambda cmd, argv: run_jax(mods[cmd], argv))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out.update({k: np.array(v) for k, v in res.items()})
    np.savez(args.out, **out)
    print(f"{len(keys)} renders, {len(out)} keys -> {args.out}")


if __name__ == "__main__":
    main()
