"""Synthetic text-line corpus generator (the JAX package's
``make-corpus``): renders labeled line images with per-char (cat 0) and
per-word (cat 1) COCO boxes plus a `text` field per image — the input
contract of format-dataset / train-localizer / infer.  Every corpus is
reproducible from a seed: the numpy and ``random.Random`` draws are the
JAX command's, in the same order, and the lines are drawn with the
port's own glyph renderer (fonts/imagefont.py), Pillow's pixels for
TrueType fonts with bytecode.

en: renders word-spaced text (builtin sample text or --text_file) with a
random font per line.  jp: renders char sequences sampled from a charset
(or the font's cmap coverage), horizontal or --vertical.
"""

from __future__ import annotations

import argparse
import json
import os
import random
from glob import glob

import numpy as np
from effocr_torch.data import imaging
from effocr_torch.fonts import imagefont

# Original sample text (not from the reference): plain English with a
# realistic word-frequency profile for spell-check / postprocess demos.
BUILTIN_TEXT = """
The morning train left the station before the first light touched the
river. Farmers carried baskets of apples and bread to the market square
while children ran along the dusty road. A cold wind moved through the
valley and the old mill turned slowly beside the water. The mayor read
the news aloud near the fountain and every merchant stopped to listen.
Prices of grain had fallen again and the harvest would be larger than
any year in recent memory. Sailors from the coast spoke of storms and
of ships lost near the northern rocks. In the evening the lamps were
lit one by one and the long street filled with quiet voices. A letter
arrived from the capital with word of the new railway line that would
cross the plain by spring. The teacher wrote the lesson on the board
and the small room smelled of chalk and cedar. Rain fell for three
days and the fields drank deeply before the sun returned. The baker
raised his prices and the town council met twice to argue about the
bridge. Nobody could remember a colder winter or a finer summer. The
clock above the courthouse struck nine and the square fell silent.
""".split()


def _load_words(args) -> list:
    if args.text_file:
        with open(args.text_file) as f:
            return f.read().split()
    return list(BUILTIN_TEXT)


def _charset_from_file(path: str) -> list:
    chars = []
    with open(path) as f:
        for row in f:
            row = row.rstrip("\n")
            if row:
                chars.append(row.split("\t")[-1])
    return chars


def _coverage(font_path: str) -> set:
    from effocr_torch.data.fonts import get_unicode_coverage_from_ttf

    _, chars = get_unicode_coverage_from_ttf(font_path)
    return set(chars)


def render_line_en(words, font, noise_std, blur_sigma, rng, margin=8):
    """White line image + char boxes (ink bbox) + word boxes + text."""
    ascent, descent = font.getmetrics()
    line_h = ascent + descent

    width = int(font.getlength(" ".join(words))) + 2 * margin
    img = np.full((line_h + 2 * margin, width, 3), 255, np.uint8)

    # text is rebuilt from the chars that actually produced ink, so the
    # `text` field matches the char annos one-to-one (the format-dataset
    # contract: extract_char_crops asserts len(annos) == len(chars))
    char_boxes, word_boxes, kept_words, x = [], [], [], float(margin)
    y = margin
    for word in words:
        kept = []
        for ch in word:
            bbox = imagefont.textbbox((x, y), ch, font)
            imagefont.draw_text(img, (x, y), ch, (0, 0, 0), font)
            if bbox[2] > bbox[0] and bbox[3] > bbox[1]:
                char_boxes.append((ch, bbox))
                kept.append(ch)
            x += font.getlength(ch)
        if kept:
            kept_words.append("".join(kept))
            boxes = [b for _, b in char_boxes[-len(kept):]]
            # word box = union of its char ink boxes
            word_boxes.append(
                (min(b[0] for b in boxes), min(b[1] for b in boxes),
                 max(b[2] for b in boxes), max(b[3] for b in boxes))
            )
        x += font.getlength(" ")
    img = _degrade(img, noise_std, blur_sigma, rng)
    return img, char_boxes, word_boxes, " ".join(kept_words)


def render_line_jp(chars, font, noise_std, blur_sigma, rng,
                   vertical=False, margin=8, gap=2):
    """CJK char run, horizontal or vertical; char boxes only."""
    size = font.size
    n = len(chars)
    if vertical:
        img = np.full((n * (size + gap) + 2 * margin, size + 2 * margin, 3),
                      255, np.uint8)
    else:
        img = np.full((size + 2 * margin, n * (size + gap) + 2 * margin, 3),
                      255, np.uint8)
    char_boxes = []
    pos = float(margin)
    for ch in chars:
        xy = (margin, pos) if vertical else (pos, margin)
        bbox = imagefont.textbbox(xy, ch, font)
        imagefont.draw_text(img, xy, ch, (0, 0, 0), font)
        if bbox[2] > bbox[0] and bbox[3] > bbox[1]:
            char_boxes.append((ch, bbox))
        pos += size + gap
    img = _degrade(img, noise_std, blur_sigma, rng)
    return img, char_boxes, [], "".join(c for c, _ in char_boxes)


def _degrade(img, noise_std, blur_sigma, rng):
    if blur_sigma > 0:
        img = imaging.gaussian_blur(img, rng.uniform(0, blur_sigma))
    if noise_std > 0:
        arr = np.asarray(img, np.float32)
        arr += rng.normal(0, noise_std, arr.shape)
        img = np.clip(arr, 0, 255).astype(np.uint8)
    return img


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m effocr_torch make-corpus")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--n_lines", type=int, default=400)
    p.add_argument("--lang", type=str, default="en", choices=["en", "jp"])
    p.add_argument("--vertical", action="store_true", default=False)
    p.add_argument("--font_dir", type=str, required=True,
                   help="TrueType fonts; a random font renders each line")
    p.add_argument("--charset_file", type=str, default=None,
                   help="tab-separated charset (char in last field); "
                        "jp default: the first font's cmap coverage")
    p.add_argument("--text_file", type=str, default=None)
    p.add_argument("--words_per_line", type=int, default=6)
    p.add_argument("--chars_per_line", type=int, default=12)
    p.add_argument("--font_size_min", type=int, default=28)
    p.add_argument("--font_size_max", type=int, default=44)
    p.add_argument("--noise_std", type=float, default=0.0)
    p.add_argument("--blur_sigma", type=float, default=0.0)
    p.add_argument("--max_charset", type=int, default=0,
                   help="cap the jp charset at N chars (0 = all)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    pyrng = random.Random(args.seed)
    image_dir = os.path.join(args.out_dir, "images")
    os.makedirs(image_dir, exist_ok=True)

    font_paths = sorted(
        f for f in glob(os.path.join(args.font_dir, "*"))
        if f.lower().endswith((".ttf", ".otf"))
    )
    assert font_paths, f"no fonts in {args.font_dir}"

    if args.lang == "en":
        words = _load_words(args)
        per_font_charset = None
    else:
        if args.charset_file:
            charset = [c for c in _charset_from_file(args.charset_file)
                       if ord(c) >= 0x100]
        else:
            charset = sorted(
                c for c in set().union(*(_coverage(f) for f in font_paths))
                if ord(c) >= 0x100  # CJK-ish only
            )
        if args.max_charset:
            idx = rng.permutation(len(charset))[: args.max_charset]
            charset = [charset[i] for i in sorted(idx)]
        # each line is rendered by ONE font: sample its chars from that
        # font's coverage so union charsets across fonts produce no tofu
        per_font_charset = {}
        for fp in font_paths:
            cov = _coverage(fp)
            per_font_charset[fp] = [c for c in charset if c in cov]
            assert per_font_charset[fp], f"{fp} covers none of the charset"

    images, annotations = [], []
    anno_id = 0
    fonts_cache = {}
    for li in range(args.n_lines):
        fp = font_paths[int(rng.integers(len(font_paths)))]
        size = int(rng.integers(args.font_size_min, args.font_size_max + 1))
        font = fonts_cache.get((fp, size))
        if font is None:
            font = fonts_cache[(fp, size)] = imagefont.truetype(fp, size)

        if args.lang == "en":
            n_words = max(1, args.words_per_line + int(rng.integers(-2, 3)))
            line_words = pyrng.choices(words, k=n_words)
            img, cbs, wbs, text = render_line_en(
                line_words, font, args.noise_std, args.blur_sigma, rng
            )
        else:
            n_chars = max(1, args.chars_per_line + int(rng.integers(-3, 4)))
            line_chars = pyrng.choices(per_font_charset[fp], k=n_chars)
            img, cbs, wbs, text = render_line_jp(
                line_chars, font, args.noise_std, args.blur_sigma, rng,
                vertical=args.vertical,
            )

        name = f"line{li:05d}.png"
        imaging.save_image(os.path.join(image_dir, name), img)
        images.append({
            "id": li, "file_name": name,
            "width": img.shape[1], "height": img.shape[0], "text": text,
        })
        for ch, (x0, y0, x1, y1) in cbs:
            annotations.append({
                "id": anno_id, "image_id": li, "category_id": 0,
                "bbox": [float(x0), float(y0),
                         float(x1 - x0), float(y1 - y0)],
                "area": float((x1 - x0) * (y1 - y0)), "iscrowd": 0,
            })
            anno_id += 1
        for (x0, y0, x1, y1) in wbs:
            annotations.append({
                "id": anno_id, "image_id": li, "category_id": 1,
                "bbox": [float(x0), float(y0),
                         float(x1 - x0), float(y1 - y0)],
                "area": float((x1 - x0) * (y1 - y0)), "iscrowd": 0,
            })
            anno_id += 1

    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": 0, "name": "char"},
                       {"id": 1, "name": "word"}],
        "info": {"description": f"synthetic {args.lang} corpus "
                                f"seed={args.seed}"},
        "licenses": [],
    }
    out_json = os.path.join(args.out_dir, "corpus.json")
    with open(out_json, "w") as f:
        json.dump(coco, f)
    n_chars_total = sum(1 for a in annotations if a["category_id"] == 0)
    print(f"{args.n_lines} lines, {n_chars_total} char boxes, "
          f"{anno_id - n_chars_total} word boxes -> {out_json}")


if __name__ == "__main__":
    main()
