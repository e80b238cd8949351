"""Charset loading and harmonization (the JAX package's data/charsets.py):
tab-separated charset files whose last field is the char, and the
Japanese harmonization (digits, latin and extra chars added, problematic
variants removed)."""

from __future__ import annotations

import os
from glob import glob
from typing import Iterable, List, Sequence, Tuple

JP_DIGITS = list("0123456789")
JP_LATIN = list("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz")
JP_EXTRA = list("靑鄕查々〇、)(,.")
JP_REMOVE = list("ッョカヵㇽ") + [chr(0x2F852)]


def load_chars(path: str) -> List[List[str]]:
    """Parse a tab-separated charset file; rows like 'NAME\\t<dec>\\t<char>'."""
    with open(path) as f:
        uni = f.read().split("\n")
    return [u.split("\t") for u in uni]


def load_charset_dir(charset_dir: str) -> List[str]:
    """All chars (last tab field per row) across *.txt files in a dir."""
    all_chars: List[str] = []
    for csf in sorted(glob(os.path.join(charset_dir, "*"))):
        for row in load_chars(csf):
            c = row[-1]
            if c:
                all_chars.append(c)
    return all_chars


def harmonize_charset(all_chars: Iterable[str], lang: str) -> List[str]:
    """Sorted unique charset; jp gets digits/latin/extras added and variant
    kana removed."""
    if lang == "jp":
        full = set(all_chars) | set(JP_DIGITS) | set(JP_LATIN) | set(JP_EXTRA)
        full -= set(JP_REMOVE)
    else:
        full = set(all_chars)
    return sorted(full)


def save_charset(charset: Sequence[str], save_dir: str, lang: str) -> str:
    """Write full_charset_{lang}.txt as decimal codepoints, one per
    line."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"full_charset_{lang}.txt")
    with open(path, "w") as f:
        f.write("\n".join(str(ord(c)) for c in charset))
    return path


def load_saved_charset(path: str) -> List[str]:
    with open(path) as f:
        return [chr(int(line)) for line in f.read().split() if line]
