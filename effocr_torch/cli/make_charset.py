"""Derive charset files from font cmap coverage (the JAX package's
``make-charset``): intersect (or union) the cmap coverage of the given
TrueType fonts and write the tab-separated ``NAME\\t<decimal
codepoint>\\t<char>`` format that format-dataset's --charset_dir reads.

    python -m effocr_torch make-charset --font_dir fonts \\
        --out charsets/coverage_unicodes.txt --min_codepoint 256

``--dedupe_renders`` renders every kept codepoint with the port's own
glyph renderer (data/fonts.py) and drops render-identical twins.
"""

from __future__ import annotations

import argparse
import os
from glob import glob


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m effocr_torch make-charset")
    p.add_argument("--font_dir", type=str, default=None,
                   help="directory of TrueType fonts")
    p.add_argument("--fonts", type=str, default=None,
                   help="comma-separated font paths (alternative)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--mode", type=str, default="union",
                   choices=["union", "intersection"],
                   help="combine coverage across fonts")
    p.add_argument("--min_codepoint", type=int, default=0,
                   help="drop codepoints below this (e.g. 256 for CJK-only)")
    p.add_argument("--max_chars", type=int, default=0,
                   help="cap the charset size (0 = all)")
    p.add_argument("--name", type=str, default=None,
                   help="first column tag (default: derived from --out)")
    p.add_argument("--dedupe_renders", action="store_true", default=False,
                   help="drop codepoints that render pixel-identically to "
                        "an earlier one in every given font (cross-script "
                        "clones, super/subscript twins)")
    p.add_argument("--dedupe_canvas", type=int, default=64,
                   help="render size for --dedupe_renders hashing")
    p.add_argument("--dedupe_tol", type=float, default=0.0,
                   help="also merge NEAR-identical renders: mean "
                        "|a-b|/255 <= tol in every common font "
                        "(0 = exact pixels only)")
    args = p.parse_args(argv)

    paths = []
    if args.font_dir:
        paths += sorted(
            f for f in glob(os.path.join(args.font_dir, "*"))
            if f.lower().endswith((".ttf", ".otf"))
        )
    if args.fonts:
        paths += [f for f in args.fonts.split(",") if f]
    assert paths, "no fonts given"

    from effocr_torch.data.fonts import get_unicode_coverage_from_ttf

    sets = []
    for fp in paths:
        _, chars = get_unicode_coverage_from_ttf(fp)
        sets.append(set(c for c in chars if ord(c) >= args.min_codepoint))
    combined = set.union(*sets) if args.mode == "union" else \
        set.intersection(*sets)
    chars = sorted(combined)
    if args.max_chars and len(chars) > args.max_chars:
        chars = chars[: args.max_chars]

    if args.dedupe_renders:
        from effocr_torch.data.fonts import dedupe_render_identical

        chars, dropped = dedupe_render_identical(
            chars, paths, canvas_size=args.dedupe_canvas,
            tol=args.dedupe_tol,
        )
        ex = (" (e.g. " + ", ".join(
            f"{d!r}=={k!r}" for d, k in dropped[:5]) + ")") if dropped else ""
        print(f"dedupe_renders: dropped {len(dropped)} render-identical "
              f"codepoints{ex}")

    name = args.name or os.path.splitext(os.path.basename(args.out))[0]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(f"{name}\t{ord(c)}\t{c}" for c in chars))
    print(f"{len(chars)} chars ({args.mode} of {len(paths)} fonts) "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
