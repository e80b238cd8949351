"""Reader for Hugging Face tokenizer files, without ``transformers`` or
``tokenizers``: the port's counterpart of
``AutoTokenizer.from_pretrained(model_dir)`` for what the TrOCR command
uses (``tok(text, truncation=True, max_length=n).input_ids``,
``tok.decode(ids, skip_special_tokens=True)``, ``eos_token_id``,
``sep_token_id``, ``pad_token_id``).

Two layouts are read:

- ``tokenizer.json`` (the ``tokenizers`` library's file), with the
  ``WordLevel`` and ``BPE`` models, no normalizer, the ``Split`` (string
  pattern, or GPT-2's regex; every behavior, and ``invert``),
  ``ByteLevel`` and ``Sequence`` pre-tokenizers, the
  ``TemplateProcessing``, ``RobertaProcessing`` and ``ByteLevel``
  post-processors, and the ``Fuse``, ``ByteLevel`` and ``BPEDecoder``
  decoders.  Special tokens come from its ``added_tokens`` and from
  ``tokenizer_config.json`` / ``special_tokens_map.json``.
- ``vocab.json`` + ``merges.txt`` alone: the RoBERTa byte-level BPE of
  the ViT-encoder TrOCR checkpoints, built as ``transformers`` builds
  ``RobertaTokenizerFast`` from them (``convert_slow_tokenizer.
  RobertaConverter``: BPE without an unknown token, ByteLevel
  pre-tokenizer and decoder, ``<s> A </s>``).

Anything else (a sentencepiece ``.model``, a ``Unigram`` or
``WordPiece`` model, another component) is refused with its type and
file named.

Semantics follow ``tokenizers`` 0.22 and ``transformers`` 4.57:
added tokens are split out of the text first (leftmost, then longest);
the GPT-2 pre-tokenizer regex is written out by Unicode category
(``\\p{L}``, ``\\p{N}`` and Oniguruma's ``\\s``, which Python's ``re``
does not have); truncation keeps room for the post-processor's tokens;
``decode`` maps ids through the added tokens, then the model's vocab
(unknown ids are dropped), skips the special ones when asked, and runs
the decoder (no decoder: tokens joined by spaces); transformers'
``clean_up_tokenization`` runs after it when ``tokenizer_config.json``
asks for it (4.57's default, when it says nothing, is off).
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# transformers' special-token attributes, in its order
SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "sep_token",
                 "pad_token", "cls_token", "mask_token")
# the defaults of the tokenizer classes whose files this module reads
_CLASS_DEFAULTS = {
    "Roberta": dict(bos_token="<s>", eos_token="</s>", unk_token="<unk>",
                    sep_token="</s>", pad_token="<pad>", cls_token="<s>",
                    mask_token="<mask>"),
    "GPT2": dict(bos_token="<|endoftext|>", eos_token="<|endoftext|>",
                 unk_token="<|endoftext|>"),
}
_CLASS_DEFAULTS["Bart"] = _CLASS_DEFAULTS["Roberta"]

GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
                r"|\s+(?!\S)|\s+")
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


class TokenizerFormatError(ValueError):
    """A tokenizer file this reader does not implement."""


def _refuse(kind: str, value, path: str):
    raise TokenizerFormatError(
        f"{path}: {kind} {value!r} is not supported by the port's tokenizer "
        "reader (effocr_torch/baselines/tokenizer.py)")


# ------------------------------------------------------------ byte level
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 bytes to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_CHAR = bytes_to_unicode()
CHAR_BYTE = {c: b for b, c in BYTE_CHAR.items()}


def _is_space(c: str) -> bool:
    """Oniguruma's Unicode ``\\s``: 0x09-0x0D, 0x85 and the Zs, Zl and Zp
    categories (Python's ``str.isspace`` adds 0x1C-0x1F)."""
    return c in "\t\n\x0b\x0c\r\x85" or unicodedata.category(c) in (
        "Zs", "Zl", "Zp")


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _is_other(c: str) -> bool:
    return not (_is_space(c) or _is_letter(c) or _is_number(c))


def gpt2_split(text: str) -> List[str]:
    """The pieces of GPT2_PATTERN's matches, left to right (the pattern
    matches every character, so nothing falls between them)."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        if c == "'":
            hit = next((s for s in _CONTRACTIONS
                        if text.startswith(s, i + 1)), None)
            if hit is not None:
                out.append(text[i:i + 1 + len(hit)])
                i += 1 + len(hit)
                continue
        # ' ?\p{L}+', ' ?\p{N}+', ' ?[^\s\p{L}\p{N}]+': an optional space
        j = i + 1 if c == " " and i + 1 < n else i
        cls = next((f for f in (_is_letter, _is_number, _is_other)
                    if f(text[j])), None)
        if cls is not None:
            k = j
            while k < n and cls(text[k]):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        # whitespace: \s+(?!\S) backs off one before a non-space, \s+ else
        k = i
        while k < n and _is_space(text[k]):
            k += 1
        if k == i:          # unreachable: every character is in a class
            raise AssertionError(f"unmatched character {c!r}")
        if k < n and k - i > 1:
            k -= 1
        out.append(text[i:k])
        i = k
    return out


# ------------------------------------------------------------- components
def _split_spans(text: str, pattern: str, behavior: str,
                 invert: bool) -> List[str]:
    """``tokenizers``' Split with a string pattern: the literal's matches
    (zero-width at every boundary for the empty string), then the
    behavior's merge of matches and gaps; empty pieces dropped."""
    marks, prev = [], 0
    for m in re.finditer(re.escape(pattern), text):
        s, e = m.span()
        if prev != s:
            marks.append(((prev, s), False))
        marks.append(((s, e), True))
        prev = e
    if prev != len(text):
        marks.append(((prev, len(text)), False))
    if invert:
        marks = [(o, not hit) for o, hit in marks]
    b = behavior.lower()
    pieces: List[List[int]] = []
    if b == "removed":
        pieces = [list(o) for o, hit in marks if not hit]
    elif b == "isolated":
        pieces = [list(o) for o, _ in marks]
    elif b in ("mergedwithprevious", "merged_with_previous"):
        last = False
        for o, hit in marks:
            if hit and not last and pieces:
                pieces[-1][1] = o[1]
            else:
                pieces.append(list(o))
            last = hit
    elif b in ("mergedwithnext", "merged_with_next"):
        last = False
        for o, hit in reversed(marks):
            if hit and not last and pieces:
                pieces[-1][0] = o[0]
            else:
                pieces.append(list(o))
            last = hit
        pieces.reverse()
    elif b == "contiguous":
        last = False
        for o, hit in marks:
            if hit == last and pieces:
                pieces[-1][1] = o[1]
            else:
                pieces.append(list(o))
            last = hit
    else:
        raise TokenizerFormatError(f"Split behavior {behavior!r}")
    return [text[s:e] for s, e in pieces if e > s]


def _pre_tokenizer(spec: Optional[dict], path: str):
    """A function from a list of pieces to a list of pieces."""
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_pre_tokenizer(s, path) for s in spec["pretokenizers"]]

        def run(pieces):
            for s in steps:
                pieces = s(pieces)
            return pieces
        return run
    if kind == "ByteLevel":
        prefix = bool(spec.get("add_prefix_space", True))
        use_regex = bool(spec.get("use_regex", True))

        def byte_level(pieces):
            out = []
            for p in pieces:
                if not p:
                    continue
                if prefix and not p.startswith(" "):
                    p = " " + p
                for w in (gpt2_split(p) if use_regex else [p]):
                    out.append("".join(BYTE_CHAR[b]
                                       for b in w.encode("utf-8")))
            return out
        return byte_level
    if kind == "Split":
        pat = spec["pattern"]
        behavior, invert = spec["behavior"], bool(spec.get("invert", False))
        if "String" in pat:
            literal = pat["String"]
            return lambda pieces: [q for p in pieces for q in _split_spans(
                p, literal, behavior, invert)]
        if pat.get("Regex") == GPT2_PATTERN and behavior.lower() == \
                "isolated" and not invert:
            return lambda pieces: [q for p in pieces for q in gpt2_split(p)]
        _refuse("Split pattern", pat, path)
    _refuse("pre_tokenizer", kind, path)


@dataclass
class PostProcessor:
    """The special-token ids put around one sequence."""
    before: List[int] = field(default_factory=list)
    after: List[int] = field(default_factory=list)

    @property
    def added(self) -> int:
        return len(self.before) + len(self.after)


def _post_processor(spec: Optional[dict], path: str) -> PostProcessor:
    if spec is None:
        return PostProcessor()
    kind = spec.get("type")
    if kind == "ByteLevel":          # offsets only
        return PostProcessor()
    if kind == "RobertaProcessing":
        return PostProcessor([int(spec["cls"][1])], [int(spec["sep"][1])])
    if kind == "TemplateProcessing":
        special = spec.get("special_tokens", {})
        pp, seen = PostProcessor(), False
        for piece in spec["single"]:
            if "Sequence" in piece:
                seen = True
                continue
            ids = [int(i) for i in special[piece["SpecialToken"]["id"]]["ids"]]
            (pp.after if seen else pp.before).extend(ids)
        return pp
    _refuse("post_processor", kind, path)


def _decoder(spec: Optional[dict], path: str):
    """A function from the token strings to the decoded text."""
    if spec is None:
        return lambda toks: " ".join(toks)
    kind = spec.get("type")
    if kind == "Fuse":
        return "".join
    if kind == "ByteLevel":
        def byte_level(toks):
            raw = bytearray()
            for t in toks:
                if all(c in CHAR_BYTE for c in t):
                    raw.extend(CHAR_BYTE[c] for c in t)
                else:                   # a token outside the byte map
                    raw.extend(t.encode("utf-8"))
            return raw.decode("utf-8", errors="replace")
        return byte_level
    if kind == "BPEDecoder":
        suffix = spec.get("suffix", "</w>")
        return lambda toks: "".join(
            t.replace(suffix, "" if i == len(toks) - 1 else " ")
            for i, t in enumerate(toks))
    _refuse("decoder", kind, path)


# ----------------------------------------------------------------- models
class WordLevelModel:
    def __init__(self, vocab: Dict[str, int], unk_token: Optional[str]):
        self.vocab = vocab
        self.unk_token = unk_token

    def tokenize(self, word: str) -> List[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        if self.unk_token in self.vocab:
            return [self.vocab[self.unk_token]]
        raise ValueError(f"WordLevel: {word!r} is not in the vocab and the "
                         "unknown token is missing")


class BPEModel:
    """``tokenizers``' BPE: characters (with the subword prefix and the
    end-of-word suffix), unknowns fused or not, byte fallback, then the
    merge of the lowest-ranked adjacent pair, leftmost first, until none
    is left."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]],
                 unk_token: Optional[str] = None,
                 continuing_subword_prefix: Optional[str] = None,
                 end_of_word_suffix: Optional[str] = None,
                 fuse_unk: bool = False, byte_fallback: bool = False,
                 ignore_merges: bool = False):
        self.vocab = vocab
        self.unk_token = unk_token
        self.prefix = continuing_subword_prefix
        self.suffix = end_of_word_suffix
        self.fuse_unk, self.byte_fallback = fuse_unk, byte_fallback
        self.ignore_merges = ignore_merges
        cut = len(self.prefix or "")
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, (a, b) in enumerate(merges):
            if a not in vocab or b not in vocab:
                raise ValueError(f"BPE merge ({a!r}, {b!r}): a part is not "
                                 "in the vocab")
            new = a + b[cut:]
            if new not in vocab:
                raise ValueError(f"BPE merge ({a!r}, {b!r}): {new!r} is not "
                                 "in the vocab")
            self.merges[(vocab[a], vocab[b])] = (rank, vocab[new])

    def tokenize(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        ids: List[int] = []
        unk: Optional[int] = None          # a pending (maybe fused) unknown
        for i, ch in enumerate(word):
            s = ch
            if i > 0 and self.prefix:
                s = self.prefix + s
            if i == len(word) - 1 and self.suffix:
                s = s + self.suffix
            if s in self.vocab:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(self.vocab[s])
                continue
            if self.byte_fallback:
                codes = [f"<0x{b:02X}>" for b in s.encode("utf-8")]
                if all(c in self.vocab for c in codes):
                    ids.extend(self.vocab[c] for c in codes)
                    continue
            if self.unk_token is not None:
                if self.unk_token not in self.vocab:
                    raise ValueError(f"BPE: unknown token "
                                     f"{self.unk_token!r} is not in the vocab")
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = self.vocab[self.unk_token]
        if unk is not None:
            ids.append(unk)
        while len(ids) > 1:
            best = None
            for p in range(len(ids) - 1):
                hit = self.merges.get((ids[p], ids[p + 1]))
                if hit is not None and (best is None or hit[0] < best[0]):
                    best = (hit[0], p, hit[1])
            if best is None:
                break
            _, p, new = best
            ids[p:p + 2] = [new]
        return ids


def _bpe_merges(raw) -> List[Tuple[str, str]]:
    out = []
    for m in raw:
        a, b = (m.split(" ", 1) if isinstance(m, str) else m)
        out.append((a, b))
    return out


# -------------------------------------------------------------- tokenizer
@dataclass
class AddedToken:
    content: str
    id: int
    special: bool = True
    lstrip: bool = False
    rstrip: bool = False
    single_word: bool = False


@dataclass
class Encoding:
    input_ids: List[int]


def _is_word_char(c: str) -> bool:
    return c.isalnum() or c == "_"


class Tokenizer:
    """What ``AutoTokenizer.from_pretrained`` gives the TrOCR command."""

    def __init__(self, model, pre_tokenize, post: PostProcessor,
                 decode_tokens, added: Sequence[AddedToken],
                 specials: Dict[str, Optional[str]], clean_up: bool = False,
                 model_max_length: Optional[int] = None):
        self.model = model
        self.pre_tokenize = pre_tokenize
        self.post = post
        self.decode_tokens = decode_tokens
        self.added = list(added)
        self.added_by_content = {a.content: a for a in self.added}
        self.added_by_id = {a.id: a for a in self.added}
        self.specials = specials
        self.clean_up_tokenization_spaces = clean_up
        self.model_max_length = model_max_length
        self.id_to_token = {i: t for t, i in model.vocab.items()}

    # -------------------------------------------------------- ids by name
    def token_to_id(self, token: Optional[str]) -> Optional[int]:
        if token is None:
            return None
        if token in self.added_by_content:
            return self.added_by_content[token].id
        return self.model.vocab.get(token)

    def _special_id(self, attr: str) -> Optional[int]:
        return self.token_to_id(self.specials.get(attr))

    eos_token_id = property(lambda self: self._special_id("eos_token"))
    sep_token_id = property(lambda self: self._special_id("sep_token"))
    pad_token_id = property(lambda self: self._special_id("pad_token"))
    bos_token_id = property(lambda self: self._special_id("bos_token"))
    unk_token_id = property(lambda self: self._special_id("unk_token"))
    cls_token_id = property(lambda self: self._special_id("cls_token"))

    # ------------------------------------------------------------ encode
    def _split_added(self, text: str
                     ) -> List[Tuple[str, Optional[AddedToken]]]:
        """Text pieces and the added tokens found between them: leftmost
        match first, the longest there; lstrip / rstrip take the
        neighbouring whitespace along."""
        cands = sorted(self.added, key=lambda a: -len(a.content))
        out, start, i = [], 0, 0
        while i < len(text) and cands:
            hit = None
            for a in cands:
                if a.content and text.startswith(a.content, i):
                    e = i + len(a.content)
                    if a.single_word and (
                            (i > 0 and _is_word_char(text[i - 1])) or
                            (e < len(text) and _is_word_char(text[e]))):
                        continue
                    hit = a
                    break
            if hit is None:
                i += 1
                continue
            s, e = i, i + len(hit.content)
            if hit.lstrip:
                while s > start and _is_space(text[s - 1]):
                    s -= 1
            if hit.rstrip:
                while e < len(text) and _is_space(text[e]):
                    e += 1
            if s > start:
                out.append((text[start:s], None))
            out.append((text[s:e], hit))
            start = i = e
        if start < len(text):
            out.append((text[start:], None))
        return out

    def encode(self, text: str, add_special_tokens: bool = True,
               truncation: bool = False,
               max_length: Optional[int] = None) -> List[int]:
        ids: List[int] = []
        for piece, tok in self._split_added(text):
            if tok is not None:
                ids.append(tok.id)
                continue
            for word in self.pre_tokenize([piece]):
                ids.extend(self.model.tokenize(word))
        added = self.post.added if add_special_tokens else 0
        if truncation:
            limit = max_length if max_length is not None \
                else self.model_max_length
            if limit is not None:
                if limit < added:
                    raise ValueError(f"max_length {limit} leaves no room: the "
                                     f"post-processor adds {added} tokens")
                ids = ids[:limit - added]
        if add_special_tokens:
            ids = self.post.before + ids + self.post.after
        return ids

    def __call__(self, text: str, truncation: bool = False,
                 max_length: Optional[int] = None,
                 add_special_tokens: bool = True) -> Encoding:
        return Encoding(self.encode(text, add_special_tokens, truncation,
                                    max_length))

    # ------------------------------------------------------------ decode
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: Optional[bool] = None) -> str:
        toks = []
        for i in ids:
            i = int(i)
            a = self.added_by_id.get(i)
            if a is not None:
                if not (skip_special_tokens and a.special):
                    toks.append(a.content)
                continue
            t = self.id_to_token.get(i)
            if t is None:
                continue
            if skip_special_tokens and t in self.added_by_content and \
                    self.added_by_content[t].special:
                continue
            toks.append(t)
        text = self.decode_tokens(toks)
        clean = (self.clean_up_tokenization_spaces
                 if clean_up_tokenization_spaces is None
                 else clean_up_tokenization_spaces)
        return clean_up_tokenization(text) if clean else text

    # -------------------------------------------------------------- load
    @classmethod
    def from_pretrained(cls, model_dir: str) -> "Tokenizer":
        return load_tokenizer(model_dir)


def clean_up_tokenization(s: str) -> str:
    """transformers' ``PreTrainedTokenizerBase.clean_up_tokenization``."""
    return (s.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


def _read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _content(v) -> Optional[str]:
    if isinstance(v, dict):
        return v.get("content")
    return v


def _class_defaults(tokenizer_class: Optional[str]) -> Dict[str, str]:
    for stem, d in _CLASS_DEFAULTS.items():
        if tokenizer_class and tokenizer_class.startswith(stem):
            return dict(d)
    return {}


def load_tokenizer(model_dir: str) -> Tokenizer:
    """The tokenizer of a checkpoint directory: ``tokenizer.json`` when
    it is there, else ``vocab.json`` + ``merges.txt`` as RoBERTa's
    byte-level BPE; anything else is refused."""
    cfg_path = os.path.join(model_dir, "tokenizer_config.json")
    cfg = _read_json(cfg_path) if os.path.exists(cfg_path) else {}
    tok_class = cfg.get("tokenizer_class")
    specials = _class_defaults(tok_class)
    extra: List[str] = []
    for attr in SPECIAL_ATTRS:
        if attr in cfg:
            specials[attr] = _content(cfg[attr])
    map_path = os.path.join(model_dir, "special_tokens_map.json")
    if os.path.exists(map_path):
        for attr, v in _read_json(map_path).items():
            if attr in SPECIAL_ATTRS:
                specials[attr] = _content(v)
            elif attr == "additional_special_tokens":
                extra = [_content(x) for x in v]
    extra += [_content(x) for x in cfg.get("additional_special_tokens") or []]
    clean_up = bool(cfg.get("clean_up_tokenization_spaces", False))
    max_len = cfg.get("model_max_length")
    max_len = int(max_len) if isinstance(max_len, int) and \
        max_len < 10 ** 12 else None

    tj = os.path.join(model_dir, "tokenizer.json")
    vj = os.path.join(model_dir, "vocab.json")
    mt = os.path.join(model_dir, "merges.txt")
    added: List[AddedToken] = []
    if os.path.exists(tj):
        spec = _read_json(tj)
        m = spec.get("model") or {}
        kind = m.get("type")
        if kind == "WordLevel":
            model = WordLevelModel(dict(m["vocab"]), m.get("unk_token"))
        elif kind == "BPE":
            if m.get("dropout"):
                _refuse("BPE dropout", m["dropout"], tj)
            model = BPEModel(
                dict(m["vocab"]), _bpe_merges(m["merges"]),
                unk_token=m.get("unk_token"),
                continuing_subword_prefix=m.get("continuing_subword_prefix"),
                end_of_word_suffix=m.get("end_of_word_suffix"),
                fuse_unk=bool(m.get("fuse_unk", False)),
                byte_fallback=bool(m.get("byte_fallback", False)),
                ignore_merges=bool(m.get("ignore_merges", False)))
        else:
            _refuse("model type", kind, tj)
        if spec.get("normalizer") is not None:
            _refuse("normalizer", spec["normalizer"].get("type"), tj)
        pre = _pre_tokenizer(spec.get("pre_tokenizer"), tj)
        post = _post_processor(spec.get("post_processor"), tj)
        dec = _decoder(spec.get("decoder"), tj)
        for a in spec.get("added_tokens") or []:
            added.append(AddedToken(
                a["content"], int(a["id"]), bool(a.get("special", False)),
                bool(a.get("lstrip", False)), bool(a.get("rstrip", False)),
                bool(a.get("single_word", False))))
    elif os.path.exists(vj) and os.path.exists(mt):
        vocab = _read_json(vj)
        with open(mt, encoding="utf-8") as f:
            # RobertaTokenizer drops the first line (the version header)
            # and the last (empty after the final newline)
            lines = f.read().split("\n")[1:-1]
        merges = [tuple(ln.split()) for ln in lines]
        model = BPEModel(vocab, [m for m in merges if len(m) == 2],
                         continuing_subword_prefix="", end_of_word_suffix="")
        if not tok_class:
            specials = _class_defaults("Roberta")
            for attr in SPECIAL_ATTRS:
                if attr in cfg:
                    specials[attr] = _content(cfg[attr])
        prefix = bool(cfg.get("add_prefix_space", False))
        pre = _pre_tokenizer({"type": "ByteLevel",
                              "add_prefix_space": prefix}, vj)
        dec = _decoder({"type": "ByteLevel"}, vj)
        post = PostProcessor([vocab.get(specials.get("cls_token"))],
                             [vocab.get(specials.get("sep_token"))])
        if None in post.before + post.after:
            raise TokenizerFormatError(
                f"{vj}: the cls / sep tokens {specials.get('cls_token')!r} / "
                f"{specials.get('sep_token')!r} are not in the vocab")
    else:
        models = [f for f in sorted(os.listdir(model_dir))
                  if f.endswith((".model", ".spm"))]
        what = (f"sentencepiece model {models[0]!r}" if models
                else "no tokenizer.json and no vocab.json + merges.txt")
        raise TokenizerFormatError(
            f"{model_dir}: {what}; the port's tokenizer reader "
            "(effocr_torch/baselines/tokenizer.py) reads tokenizer.json "
            "(WordLevel / BPE) or a byte-level BPE vocab.json + merges.txt")
    # transformers adds every named special token to the added vocabulary
    # (as special), at the next free id when the vocab lacks it; RoBERTa's
    # mask token takes the whitespace before it along
    by_content = {a.content: a for a in added}
    lstrip_mask = _class_defaults(tok_class or "Roberta").get("mask_token")
    for name in [specials.get(a) for a in SPECIAL_ATTRS] + extra:
        if name is None:
            continue
        if name in by_content:
            by_content[name].special = True
            continue
        tid = model.vocab.get(name)
        if tid is None:
            tid = max([*model.vocab.values(), *(a.id for a in added)]) + 1
        tok = AddedToken(name, tid, special=True, lstrip=(
            name == specials.get("mask_token") == lstrip_mask))
        added.append(tok)
        by_content[name] = tok
    return Tokenizer(model, pre, post, dec, added, specials,
                     clean_up, max_len)
