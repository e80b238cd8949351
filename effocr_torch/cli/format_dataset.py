"""Dataset formatting CLI (the JAX package's ``format-dataset``): COCO
line annotations + fonts -> the recognizer's char-folder tree (crops,
font renders, charset file, dataset_meta.json).

The renders come from the port's own glyph renderer (data/fonts.py;
TrueType fonts with bytecode), the crops from data/coco.py
``extract_char_crops``; pixels, modes and file names are the JAX
command's.
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob

from effocr_torch.data.charsets import (
    harmonize_charset,
    load_charset_dir,
    save_charset,
)
from effocr_torch.data.coco import extract_char_crops, load_json
from effocr_torch.data.fonts import (
    draw_single_char,
    draw_single_char_ascender,
    paired_chars,
    render_chars,
)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m effocr_torch format-dataset")
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--coco_jsons", type=str, required=True,
                   help="comma-separated COCO JSON paths")
    p.add_argument("--crops_save_dir", type=str, required=True)
    p.add_argument("--cat_id", type=int, required=True)
    p.add_argument("--spaces", action="store_true", default=False)
    p.add_argument("--clip_to_top_and_bottom", action="store_true",
                   default=False)
    p.add_argument("--font_dir", type=str, default="./japan_font_files")
    p.add_argument("--charset_dir", type=str, default="./japan_charsets")
    p.add_argument("--dataset_save_dir", type=str, required=True)
    p.add_argument("--exclude_fonts", type=str, default=None)
    p.add_argument("--padding", type=float, default=0.05)
    p.add_argument("--square", action="store_true", default=False)
    args = p.parse_args(argv)

    os.makedirs(args.crops_save_dir, exist_ok=True)
    os.makedirs(args.dataset_save_dir, exist_ok=True)
    # the crop geometry, which train-recognizer stamps into model.json
    with open(os.path.join(args.dataset_save_dir, "dataset_meta.json"),
              "w") as f:
        json.dump({"crop_geometry": "line" if args.clip_to_top_and_bottom
                   else "tight"}, f)

    for cj in args.coco_jsons.split(","):
        coco = load_json(cj)
        n = extract_char_crops(
            coco, args.image_dir, args.crops_save_dir, cat_id=args.cat_id,
            spaces=args.spaces, clip=args.clip_to_top_and_bottom,
        )
        print(f"{cj}: {n} crops")

    font_files = sorted(glob(os.path.join(args.font_dir, "*")))
    if args.exclude_fonts:
        excl = args.exclude_fonts.split(",")
        font_files = [f for f in font_files
                      if not any(e in f for e in excl)]

    lang = "jp" if "japan" in args.charset_dir else "en"
    all_chars = load_charset_dir(args.charset_dir)
    full_charset = harmonize_charset(all_chars, lang)
    save_charset(full_charset, args.dataset_save_dir, lang)
    print(f"Len all chars: {len(full_charset)}")

    draw_func = (
        draw_single_char_ascender if "eng" in args.charset_dir
        else draw_single_char
    )
    n = render_chars(
        font_paths=font_files, unicode_chars=full_charset,
        save_path=args.dataset_save_dir, padding=args.padding,
        draw_func=draw_func, square=args.square,
    )
    print(f"{n} renders")
    n = paired_chars(
        dir_paths=args.crops_save_dir.split(","),
        save_path=args.dataset_save_dir, square=args.square,
    )
    print(f"{n} paired crops")


if __name__ == "__main__":
    main()
