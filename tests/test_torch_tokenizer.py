"""effocr_torch's HF tokenizer reader (baselines/tokenizer.py) against the
``tokenizers`` library and ``transformers.AutoTokenizer``, on the CPU:

- the ByteLevel pre-tokenizer (GPT-2's regex by Unicode category) and
  every Split behavior, piece for piece, on seeded random strings;
- the char-level WordLevel tokenizer that the JAX package's
  ``test_cli_convert_and_evaluate`` writes;
- a byte-level BPE trained here with ``ByteLevelBPETokenizer``, saved as
  ``tokenizer.json`` (with the RoBERTa, ByteLevel and template
  post-processors) and as ``vocab.json`` + ``merges.txt`` (which
  transformers loads as ``RobertaTokenizerFast``);
- a BPE with an end-of-word suffix, a fused unknown token and the
  BPEDecoder;

ids (with truncation at several ``max_length``), ``decode(...,
skip_special_tokens=True/False)`` and the special ids identical, on
strings with accents, CJK, digits, contractions, runs of spaces and
newlines; and other formats refused with their type named.
"""

import json
import os
import random

import pytest

tokenizers = pytest.importorskip("tokenizers")
transformers = pytest.importorskip("transformers")

from tokenizers import (  # noqa: E402
    ByteLevelBPETokenizer,
    Tokenizer,
    decoders,
    normalizers,
    pre_tokenizers,
    processors,
)
from tokenizers.models import BPE, Unigram, WordLevel  # noqa: E402
from tokenizers.trainers import BpeTrainer  # noqa: E402
from transformers import AutoTokenizer, PreTrainedTokenizerFast  # noqa: E402

from effocr_torch.baselines import tokenizer as T  # noqa: E402

TEXTS = ["The quick brown fox's den, it's 1234 miles.",
         "héllo wörld, naïve café à Zürich", "東京都 中文 123 ٣½Ⅷ",
         "we're   here\n\nnow\tand then", "l'amour 'd' we've I'm you'll",
         "A-Z a.z! ? 0,5", "  leading and trailing  "]
PIECES = (list("abcdeé  \n\t'sre'vmlld0123٣½ⅧAZ.,!?-_中文字\xa0\x1c\x85 ")
          + ["'s", "'re", "  ", "fox", " the", "<s>", "</s>", "<mask>"])


def _strings(seed, n, max_len=20):
    rng = random.Random(seed)
    return (TEXTS + ["", " ", "\n", "'s", "a'", "  x"]
            + ["".join(rng.choice(PIECES) for _ in range(rng.randint(0, max_len)))
               for _ in range(n)])


def _ids(seed, n, hi):
    rng = random.Random(seed)
    return [[rng.randrange(0, hi) for _ in range(rng.randint(0, 12))]
            for _ in range(n)]


# ------------------------------------------------------- pre-tokenizers
@pytest.mark.parametrize("prefix", [False, True])
def test_byte_level_pretokenizer_matches_tokenizers(prefix):
    ref = pre_tokenizers.ByteLevel(add_prefix_space=prefix)
    mine = T._pre_tokenizer({"type": "ByteLevel",
                             "add_prefix_space": prefix}, "t")
    for s in _strings(1, 1500):
        assert mine([s]) == [p for p, _ in ref.pre_tokenize_str(s)], repr(s)


@pytest.mark.parametrize("behavior", ["removed", "isolated",
                                      "merged_with_previous",
                                      "merged_with_next", "contiguous"])
@pytest.mark.parametrize("invert", [False, True])
def test_split_pretokenizer_matches_tokenizers(behavior, invert):
    for pattern in ("", "b", "ab", " "):
        ref = pre_tokenizers.Split(pattern, behavior, invert=invert)
        spec = {"type": "Split", "pattern": {"String": pattern},
                "behavior": behavior, "invert": invert}
        mine = T._pre_tokenizer(spec, "t")
        for s in ["", "b", "abbcab b", "bb", "aab ab  ba", "abab", "c"] + \
                _strings(2, 60, 8):
            want = [p for p, _ in ref.pre_tokenize_str(s)]
            assert mine([s]) == want, (pattern, repr(s))


def test_gpt2_regex_split_is_the_byte_level_split():
    """A tokenizer.json that splits with GPT-2's regex in a Split (and
    ByteLevel without its own regex) reads as the ByteLevel one."""
    seq = pre_tokenizers.Sequence([
        pre_tokenizers.Split(tokenizers.Regex(T.GPT2_PATTERN), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    t = Tokenizer(WordLevel({"x": 0}, unk_token="x"))
    t.pre_tokenizer = seq
    spec = json.loads(t.to_str())["pre_tokenizer"]
    mine = T._pre_tokenizer(spec, "t")
    for s in _strings(3, 300):
        assert mine([s]) == [p for p, _ in seq.pre_tokenize_str(s)], repr(s)


# ------------------------------------------------------------ tokenizers
def _wordlevel_dir(d):
    """The JAX package's test_cli_convert_and_evaluate tokenizer."""
    from tokenizers.pre_tokenizers import Split
    from tokenizers.processors import TemplateProcessing

    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2}
    for i, c in enumerate("abcdefghij ".replace(" ", "▁") + "k"):
        vocab[c] = 3 + i
    t = Tokenizer(WordLevel(vocab, unk_token="<pad>"))
    t.pre_tokenizer = Split("", "isolated")
    t.post_processor = TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 2)])
    t.decoder = decoders.Fuse()
    PreTrainedTokenizerFast(
        tokenizer_object=t, pad_token="<pad>", bos_token="<s>",
        eos_token="</s>").save_pretrained(d)
    return d


SPECIALS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]


def _trained_bpe():
    bt = ByteLevelBPETokenizer()
    bt.train_from_iterator(TEXTS * 10, vocab_size=420, min_frequency=1,
                           special_tokens=SPECIALS)
    return bt


def _bpe_json_dir(d, post):
    bt = _trained_bpe()
    if post == "roberta":
        bt._tokenizer.post_processor = processors.RobertaProcessing(
            sep=("</s>", 2), cls=("<s>", 0))
    elif post == "template":
        bt._tokenizer.post_processor = processors.TemplateProcessing(
            single="<s> $A </s>", special_tokens=[("<s>", 0), ("</s>", 2)])
    PreTrainedTokenizerFast(
        tokenizer_object=bt._tokenizer, bos_token="<s>", eos_token="</s>",
        pad_token="<pad>", unk_token="<unk>", sep_token="</s>",
        cls_token="<s>", mask_token="<mask>").save_pretrained(d)
    return d


def _bpe_vocab_merges_dir(d, config=True):
    os.makedirs(d, exist_ok=True)
    _trained_bpe().save_model(d)
    if config:
        with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
            json.dump({"tokenizer_class": "RobertaTokenizer"}, f)
    return d


def _suffix_bpe_dir(d):
    t = Tokenizer(BPE(unk_token="[UNK]", end_of_word_suffix="</w>",
                      fuse_unk=True))
    t.pre_tokenizer = pre_tokenizers.Split(" ", "removed")
    t.decoder = decoders.BPEDecoder(suffix="</w>")
    t.train_from_iterator(
        [s for s in TEXTS if "東" not in s] * 5,
        BpeTrainer(vocab_size=200, special_tokens=["[UNK]", "[PAD]"],
                   end_of_word_suffix="</w>", min_frequency=1))
    PreTrainedTokenizerFast(tokenizer_object=t, unk_token="[UNK]",
                            pad_token="[PAD]").save_pretrained(d)
    return d


LAYOUTS = {
    "wordlevel": _wordlevel_dir,
    "bpe_json_roberta": lambda d: _bpe_json_dir(d, "roberta"),
    "bpe_json_bytelevel": lambda d: _bpe_json_dir(d, "bytelevel"),
    "bpe_json_template": lambda d: _bpe_json_dir(d, "template"),
    "bpe_vocab_merges": _bpe_vocab_merges_dir,
    "bpe_suffix_unk": _suffix_bpe_dir,
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ids_and_decode_match_transformers(layout, tmp_path):
    d = LAYOUTS[layout](str(tmp_path / layout))
    ref = AutoTokenizer.from_pretrained(d)
    mine = T.load_tokenizer(d)
    if layout == "bpe_vocab_merges":
        assert type(ref).__name__ == "RobertaTokenizerFast"
        assert sorted(os.listdir(d)) == ["merges.txt",
                                         "tokenizer_config.json",
                                         "vocab.json"]
    for attr in ("eos_token_id", "sep_token_id", "pad_token_id",
                 "bos_token_id", "unk_token_id"):
        assert getattr(mine, attr) == getattr(ref, attr), attr
    for i, s in enumerate(_strings(4, 300)):
        assert mine(s).input_ids == ref(s).input_ids, repr(s)
        n = 3 + i % 10
        assert (mine(s, truncation=True, max_length=n).input_ids
                == ref(s, truncation=True, max_length=n).input_ids), (
                    repr(s), n)
    hi = max(ref.get_vocab().values()) + 5
    named = [i for i in (ref.pad_token_id, ref.eos_token_id) if i is not None]
    for ids in _ids(5, 400, hi) + [named]:
        for skip in (True, False):
            assert (mine.decode(ids, skip_special_tokens=skip)
                    == ref.decode(ids, skip_special_tokens=skip)), (ids, skip)
    # round trip of the text the CLI labels with
    for s in TEXTS:
        ids = ref(s, truncation=True, max_length=64).input_ids
        assert mine.decode(ids, skip_special_tokens=True) == ref.decode(
            ids, skip_special_tokens=True)


def test_clean_up_tokenization_spaces_follows_the_config(tmp_path):
    """transformers 4.57 cleans up only when tokenizer_config.json says so
    (its default, when the key is missing, is off)."""
    d = _bpe_vocab_merges_dir(str(tmp_path / "v"))
    text = "it 's here , isn't it ? yes ."
    for value in (None, True, False):
        cfg = {"tokenizer_class": "RobertaTokenizer"}
        if value is not None:
            cfg["clean_up_tokenization_spaces"] = value
        with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
            json.dump(cfg, f)
        ref = AutoTokenizer.from_pretrained(d)
        mine = T.load_tokenizer(d)
        ids = ref(text).input_ids
        assert mine.decode(ids, skip_special_tokens=True) == ref.decode(
            ids, skip_special_tokens=True), value
        assert mine.clean_up_tokenization_spaces == bool(value)


def test_vocab_and_merges_alone_read_as_roberta(tmp_path):
    """Without tokenizer_config.json, vocab.json + merges.txt is RoBERTa's
    byte-level BPE (<s> A </s>): what transformers builds for a
    RobertaTokenizer directory."""
    bare = _bpe_vocab_merges_dir(str(tmp_path / "bare"), config=False)
    full = _bpe_vocab_merges_dir(str(tmp_path / "full"))
    ref = AutoTokenizer.from_pretrained(full)
    mine = T.load_tokenizer(bare)
    for s in TEXTS:
        assert mine(s).input_ids == ref(s).input_ids
    assert (mine.eos_token_id, mine.pad_token_id) == (2, 1)


def test_other_formats_are_refused(tmp_path):
    sp = tmp_path / "sp"
    sp.mkdir()
    (sp / "sentencepiece.bpe.model").write_bytes(b"\x00")
    with pytest.raises(T.TokenizerFormatError, match="sentencepiece"):
        T.load_tokenizer(str(sp))
    uni = tmp_path / "uni"
    uni.mkdir()
    t = Tokenizer(Unigram([("<unk>", 0.0), ("a", -1.0)], 0))
    t.save(str(uni / "tokenizer.json"))
    with pytest.raises(T.TokenizerFormatError,
                       match=r"model type 'Unigram'.*tokenizer.json|"
                             r"tokenizer.json.*model type 'Unigram'"):
        T.load_tokenizer(str(uni))
    t = Tokenizer(WordLevel({"a": 0}, unk_token="a"))
    t.pre_tokenizer = pre_tokenizers.Whitespace()
    t.save(str(uni / "tokenizer.json"))
    with pytest.raises(T.TokenizerFormatError, match="Whitespace"):
        T.load_tokenizer(str(uni))
    t = Tokenizer(WordLevel({"a": 0}, unk_token="a"))
    t.normalizer = normalizers.NFKC()
    t.save(str(uni / "tokenizer.json"))
    with pytest.raises(T.TokenizerFormatError, match="normalizer 'NFKC'"):
        T.load_tokenizer(str(uni))
