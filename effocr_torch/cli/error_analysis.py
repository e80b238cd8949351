"""CER error breakdown over saved inference results.

    python -m effocr_torch error-analysis \
        --results out/inference_results.json --coco_json split_val.json

Buckets every edit in the corpus CER into case / space / substitution /
insertion / deletion, prints the confusion table, and says which lever
(case repair, word boxes, recognizer, detector) owns the residual.
Reads the {key: text} artifact `infer --save_output` writes; no device.
A copy of the JAX package's cli/error_analysis.py; ``--font_dir`` raises
(the render distances need a font library this package does not have).
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> None:
    from effocr_torch.eval.error_analysis import (
        analyze_pairs,
        confusion_render_distance,
    )

    p = argparse.ArgumentParser(prog="python -m effocr_torch error-analysis")
    p.add_argument("--results", type=str, required=True,
                   help="inference_results.json ({filename: text})")
    p.add_argument("--coco_json", type=str, required=True,
                   help="COCO file whose images carry 'text' ground truth")
    p.add_argument("--uncased", action="store_true", default=False)
    p.add_argument("--no_clean", action="store_true", default=False,
                   help="skip the quote-normalizing string_cleaner")
    p.add_argument("--top", type=int, default=15,
                   help="confusion pairs to print")
    p.add_argument("--font_dir", type=str, default=None,
                   help="corpus font directory: annotate each confusion "
                        "with its worst-case render distance across the "
                        "fonts (0 = pixel-identical codepoint twins, a "
                        "charset-ambiguity error no recognizer can fix — "
                        "see make-charset --dedupe_renders)")
    p.add_argument("--save_json", type=str, default=None)
    args = p.parse_args(argv)
    if args.font_dir:
        confusion_render_distance([], [])

    with open(args.results) as f:
        results = json.load(f)
    results = {os.path.basename(str(k)): v for k, v in results.items()}
    with open(args.coco_json) as f:
        coco = json.load(f)
    pairs = [
        (x["text"], results.get(x["file_name"]) or "")
        for x in coco["images"]
        if x.get("text") is not None and x["file_name"] in results
    ]
    if not pairs:
        raise SystemExit("no (gt, pred) pairs: check --results/--coco_json")

    bd = analyze_pairs(pairs, clean=not args.no_clean, uncased=args.uncased)
    s = bd.summary(top=args.top)
    print(f"lines: {s['n_lines']}  exact: {s['exact_line_accuracy']:.3f}  "
          f"CER: {s['cer']:.4f}  ({s['edits']} edits)")
    print("edits by category (count, share):")
    for k, (n, frac) in s["by_category"].items():
        print(f"  {k:22s} {n:6d}  {frac:5.1%}")
    f = s["imperfect_lines_fixable_by"]
    print(f"imperfect lines fixable by: case alone {f['case_alone']}, "
          f"spaces alone {f['spaces_alone']}, "
          f"substitutions alone {f['substitutions_alone']}")
    if s["top_confusions"]:
        print("top confusions (gt -> pred):")
        for c in s["top_confusions"]:
            print(f"  {c['gt']!r} -> {c['pred']!r}  x{c['count']}")
    if args.save_json:
        with open(args.save_json, "w") as fh:
            json.dump(s, fh, ensure_ascii=False, indent=1)
        print(f"saved {args.save_json}")


if __name__ == "__main__":
    main()
