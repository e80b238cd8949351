"""CER error breakdown: attribute edit-distance errors to failure modes
(a copy of the JAX package's eval/error_analysis.py, pinned to it by
tests/test_torch_tools.py and tests/test_torch_fonts.py;
``confusion_render_distance`` renders with the port's own glyph
renderer, data/fonts.py).

The reference prints one aggregate CER (utils/eval_utils.py:25-70) and
incorrect lines; choosing the next accuracy lever (detector? recognizer?
space insertion? case repair?) means eyeballing diffs.  This module
aligns each (gt, pred) pair with a Levenshtein backtrace and buckets
every edit into: case-only substitutions (en_postprocess case-repair
territory), space insertions/deletions (word-box/space-insertion
territory), other substitutions with a confusion table (recognizer
territory — homoglyphs show up here), and insertions/deletions of
non-space chars (detector split/merge/miss territory).

Pure host-side analysis of prediction artifacts; pairs use the same
string_cleaner as textline_evaluation so the totals reconcile with the
reported CER.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from effocr_torch.eval.textline import string_cleaner


def align_ops(gt: str, pred: str) -> List[Tuple[str, str, str]]:
    """Levenshtein alignment (unit costs, matching textline_evaluation's
    edit_distance) with backtrace.

    Returns ops in gt order: ("match"|"sub", g, p), ("del", g, ""),
    ("ins", "", p).  Tie-break prefers sub over del over ins, which keeps
    aligned substitutions together for the confusion table.
    """
    n, m = len(gt), len(pred)
    # dp[i][j] = distance between gt[:i] and pred[:j]
    dp = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        dp[i][0] = i
    for j in range(m + 1):
        dp[0][j] = j
    for i in range(1, n + 1):
        gi = gt[i - 1]
        row, prev = dp[i], dp[i - 1]
        for j in range(1, m + 1):
            c = 0 if gi == pred[j - 1] else 1
            row[j] = min(prev[j - 1] + c, prev[j] + 1, row[j - 1] + 1)
    ops: List[Tuple[str, str, str]] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0:
            c = 0 if gt[i - 1] == pred[j - 1] else 1
            if dp[i][j] == dp[i - 1][j - 1] + c:
                ops.append(
                    ("match" if c == 0 else "sub", gt[i - 1], pred[j - 1])
                )
                i, j = i - 1, j - 1
                continue
        if i > 0 and dp[i][j] == dp[i - 1][j] + 1:
            ops.append(("del", gt[i - 1], ""))
            i -= 1
        else:
            ops.append(("ins", "", pred[j - 1]))
            j -= 1
    ops.reverse()
    return ops


@dataclass
class ErrorBreakdown:
    n_lines: int = 0
    n_exact: int = 0
    n_gt_chars: int = 0
    edits: int = 0
    case_subs: int = 0          # same letter, wrong case
    space_ins: int = 0          # spurious spaces in pred
    space_del: int = 0          # missing spaces in pred
    other_subs: int = 0         # recognizer confusions (incl. homoglyphs)
    char_ins: int = 0           # detector over-split / hallucination
    char_del: int = 0           # detector miss / merge
    confusions: Counter = field(default_factory=Counter)  # (gt, pred) -> n
    lines_case_only: int = 0    # imperfect lines fixed by case alone
    lines_space_only: int = 0   # ... by spaces alone
    lines_sub_only: int = 0     # ... by substitutions alone

    @property
    def cer(self) -> float:
        return self.edits / self.n_gt_chars if self.n_gt_chars else 0.0

    def summary(self, top: int = 15) -> Dict:
        e = max(self.edits, 1)
        return {
            "n_lines": self.n_lines,
            "exact_line_accuracy": (
                self.n_exact / self.n_lines if self.n_lines else 0.0
            ),
            "cer": self.cer,
            "edits": self.edits,
            "by_category": {
                "case_substitutions": [self.case_subs, self.case_subs / e],
                "space_insertions": [self.space_ins, self.space_ins / e],
                "space_deletions": [self.space_del, self.space_del / e],
                "other_substitutions": [
                    self.other_subs, self.other_subs / e
                ],
                "char_insertions": [self.char_ins, self.char_ins / e],
                "char_deletions": [self.char_del, self.char_del / e],
            },
            "imperfect_lines_fixable_by": {
                "case_alone": self.lines_case_only,
                "spaces_alone": self.lines_space_only,
                "substitutions_alone": self.lines_sub_only,
            },
            "top_confusions": [
                {"gt": g, "pred": p, "count": c}
                for (g, p), c in self.confusions.most_common(top)
            ],
        }


def confusion_render_distance(
    pairs: Sequence[Tuple[str, str]],
    font_paths: Sequence[str],
    canvas_size: int = 64,
) -> Dict[Tuple[str, str], float]:
    """(gt, pred) -> worst-case render distance across the corpus fonts.

    Distance per font = mean |render(gt) - render(pred)| / 255 over the
    canvas; the reported value is the MAX over fonts rendering both (a
    pair is only truly unanswerable if no font distinguishes it).  0.0
    means pixel-identical everywhere — a charset-ambiguity error, not a
    recognizer error (see data/fonts.dedupe_render_identical).  Pairs
    with no common font or multi-char entries get nan.
    """
    import numpy as _np

    from effocr_torch.data.fonts import (
        draw_single_char,
        get_unicode_coverage_from_ttf,
        truetype,
    )

    chars = sorted({c for p in pairs for c in p if len(c) == 1})
    renders: List[Dict[str, _np.ndarray]] = []
    for fp in font_paths:
        font = truetype(fp, canvas_size)
        _, covered = get_unicode_coverage_from_ttf(fp)
        per = {}
        for c in set(chars).intersection(covered):
            img = draw_single_char(c, font, canvas_size)
            if img is not None:
                per[c] = _np.asarray(img, _np.float32)
        renders.append(per)
    out: Dict[Tuple[str, str], float] = {}
    for g, p in pairs:
        dists = [
            float(_np.mean(_np.abs(per[g] - per[p]))) / 255.0
            for per in renders
            if g in per and p in per
        ]
        out[(g, p)] = max(dists) if dists else float("nan")
    return out


def analyze_pairs(
    pairs: Sequence[Tuple[str, str]],
    clean: bool = True,
    uncased: bool = False,
) -> ErrorBreakdown:
    """pairs: (gt, pred) per line, raw strings; `clean`/`uncased` mirror
    textline_evaluation so the aggregate CER here reconciles with it."""
    out = ErrorBreakdown()
    for gt, pred in pairs:
        if clean:
            gt, pred = string_cleaner(gt), string_cleaner(pred)
        if uncased:
            gt, pred = gt.lower(), pred.lower()
        gt, pred = gt.strip(), pred.strip()
        out.n_lines += 1
        out.n_gt_chars += len(gt)
        if gt == pred:
            out.n_exact += 1
            continue
        kinds = set()
        for op, g, p in align_ops(gt, pred):
            if op == "match":
                continue
            out.edits += 1
            if op == "sub":
                if g.lower() == p.lower():
                    out.case_subs += 1
                    kinds.add("case")
                elif g == " " or p == " ":
                    # space replaced by a char (or vice versa): count as
                    # the space error plus the char error it hides
                    out.space_del += g == " "
                    out.space_ins += p == " "
                    kinds.add("space")
                else:
                    out.other_subs += 1
                    out.confusions[(g, p)] += 1
                    kinds.add("sub")
            elif op == "ins":
                if p == " ":
                    out.space_ins += 1
                    kinds.add("space")
                else:
                    out.char_ins += 1
                    kinds.add("insdel")
            else:  # del
                if g == " ":
                    out.space_del += 1
                    kinds.add("space")
                else:
                    out.char_del += 1
                    kinds.add("insdel")
        if kinds == {"case"}:
            out.lines_case_only += 1
        elif kinds == {"space"}:
            out.lines_space_only += 1
        elif kinds == {"sub"}:
            out.lines_sub_only += 1
    return out
