"""Time effocr_torch's native JPEG decoder on the committed fixtures.

Decodes the 2550 x 3300 gray page (tests/torch_fixtures/images/page/
page.jpg) and the 64 fixture lines (tests/torch_fixtures/images/lines/*.jpg),
one file at a time on one thread, ``--reps`` times each, and prints one
JSON line: min and median ms of the page and of the 64 lines, MP/s at the
min, and a digest of the decoded pixels (two builds that decode alike
print the same digest).

``--root`` names the checkout whose ``effocr_torch`` is imported (and
whose ``native/libimgdec.so`` is built on first use), so that two trees
can be timed in turn on one machine, each in its own process:

    python3 scripts/jpeg_decode_times.py --root parent --label parent
    python3 scripts/jpeg_decode_times.py --root . --label change

The fixtures are read from this script's own checkout.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(HERE, "tests", "torch_fixtures", "images")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from effocr_torch.data import jpeg
    from effocr_torch.native import imgdec

    page = open(os.path.join(FIXTURES, "page", "page.jpg"), "rb").read()
    lines = [open(p, "rb").read() for p in
             sorted(glob.glob(os.path.join(FIXTURES, "lines", "*.jpg")))]
    if not lines:
        raise SystemExit("no fixture lines found under " + FIXTURES)
    jobs = {"page": [(page, jpeg.jpeg_header(page))],
            "lines": [(d, jpeg.jpeg_header(d)) for d in lines]}
    out = {"label": args.label,
           "root": os.path.abspath(args.root),
           "lib": os.path.abspath(imgdec._LIB)}
    digest = hashlib.sha256()
    for name, items in jobs.items():
        shapes = [(h, w, 1) for h, w, _ in (s for _, s in items)]
        for (d, _), s in zip(items, shapes):   # build, warm, and digest
            digest.update(imgdec.decode_jpeg(d, s).tobytes())
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for (d, _), s in zip(items, shapes):
                imgdec.decode_jpeg(d, s)
            times.append(time.perf_counter() - t0)
        mp = sum(h * w for h, w, _ in shapes) / 1e6
        out[f"{name}_min_ms"] = min(times) * 1e3
        out[f"{name}_median_ms"] = statistics.median(times) * 1e3
        out[f"{name}_mp_s"] = mp / min(times)
    out["pixels_sha256"] = digest.hexdigest()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
