"""Built-in charset generation (the JAX package's
data/builtin_charsets.py).

The reference ships tab-separated charset files (english_charsets/: digits,
letters, punctuation; japan_charsets/: JIS X 0213 / Adobe-Japan1 lists).
English charsets are fully derivable — this generates equivalent files so a
user can bootstrap without the reference's assets.  For Japanese, a
13,530-class CJK charset asset ships at
``effocr_torch/data/assets/jp_coverage_unicodes.txt`` (same format;
generated by ``make-charset`` as the union coverage >= U+0100 of four
OFL CJK fonts — Kosugi, Reggae One, Stick, Tanugo — plus DejaVu; the
charset used for the round-2 13,553-class jp end-to-end demo,
BENCH_ACCURACY.md).  ``jp_charset_path()`` returns its path; or point
--charset_dir at your own standards lists
(``NAME\\t<decimal codepoint>\\t<char>`` per line).
"""

from __future__ import annotations

import os
import string
from typing import Dict, List

EN_PUNCTUATION = list("!\"#$%&'()*+,-./:;?@[]_{}“”‘’")


def english_charsets() -> Dict[str, List[str]]:
    return {
        "digits": list(string.digits),
        "letters": list(string.ascii_letters),
        "punctuation": EN_PUNCTUATION,
    }


def write_charset_dir(save_dir: str, charsets: Dict[str, List[str]] = None
                      ) -> List[str]:
    """Write tab-separated charset files in the reference's format."""
    charsets = charsets or english_charsets()
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for name, chars in charsets.items():
        path = os.path.join(save_dir, f"{name}.txt")
        with open(path, "w") as f:
            f.write("\n".join(
                f"{name.upper()}\t{ord(c)}\t{c}" for c in chars
            ))
        paths.append(path)
    return paths


def jp_charset_path() -> str:
    """Path to the shipped 13,530-class CJK charset asset (the
    japan_charsets/ role; see module docstring for provenance)."""
    return os.path.join(os.path.dirname(__file__), "assets",
                        "jp_coverage_unicodes.txt")
