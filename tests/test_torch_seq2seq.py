"""effocr_torch's seq2seq baseline against the JAX package's, on the CPU at
the JAX tests' size (dim 64, 2 + 2 blocks, 4 heads, a 32 x 64 canvas,
max_len 12), with the same weights (bridged with interop/flax_bridge.py)
and inputs:

- ``CharTokenizer``: ids, masks and decodes identical;
- the forward (float and uint8 images): rtol 1e-4 / atol 1e-5; a canvas
  that is not a multiple of the patch is refused (the JAX model fails on
  it too);
- two ``optax.adamw`` steps against the port's AdamW: loss 1e-5
  relative, parameters 1e-4 of the largest (the key biases, whose
  gradient is rounding noise, within the 2 lr they can move); the bank
  step equals the stream step bit for bit;
- greedy and beam-4 tokens identical to JAX's on weights JAX overfit,
  and on a head of zeros, where every candidate ties (the first index
  wins in both);
- ``Seq2SeqDataset`` arrays bit for bit against JAX's (Pillow's) on PNGs
  wider, narrower and taller than the canvas, gray and palette ones
  included;
- ``train-seq2seq`` in both data modes on the JAX test's corpus:
  charset.json byte for byte, and each package loads the other's
  seq2seq_best.msgpack and decodes the same tokens.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from effocr_tpu.baselines import data as j_data
from effocr_tpu.baselines import seq2seq as j_s2s
from effocr_tpu.train import checkpoint as j_ckpt
from effocr_torch.baselines import data as t_data
from effocr_torch.baselines import seq2seq as t_s2s
from effocr_torch.interop.flax_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from effocr_torch.interop.flax_msgpack import read_variables
from effocr_torch.train.optim import AdamW

SIZE = dict(img_h=32, img_w=64, patch=8, dim=64, enc_depth=2, dec_depth=2,
            heads=4, max_len=12)
CHARS = list("abcd")
TEXTS = ["abca", "ddcb", "ba", "c", "abcd", "da"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(n=6, seed=0):
    rng = np.random.default_rng(seed)
    tok = t_s2s.CharTokenizer(CHARS)
    imgs = rng.integers(0, 256, (n, 32, 64, 3)).astype(np.uint8)
    enc = [tok.encode(t, SIZE["max_len"]) for t in TEXTS[:n]]
    return (tok, imgs, np.stack([e[0] for e in enc]),
            np.stack([e[1] for e in enc]))


def _models(vocab):
    jm = j_s2s.Seq2SeqOCR(vocab_size=vocab, **SIZE)
    tm = t_s2s.Seq2SeqOCR(vocab_size=vocab, **SIZE)
    return jm, tm


def _jax_params(jm, imgs, ids):
    return _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(imgs[:1]),
                       jnp.asarray(ids[:1, :-1]))["params"])


def _load(tm, params):
    tm.load_state_dict(flax_to_state_dict({"params": params}), strict=True)
    return tm


@pytest.fixture(scope="module")
def overfit():
    """(tokenizer, images [2, 32, 64, 3] float, texts, JAX-overfit params)
    of the JAX test's overfit case: Adam 1e-3 for 150 steps."""
    tok = j_s2s.CharTokenizer(CHARS)
    jm = j_s2s.Seq2SeqOCR(vocab_size=tok.vocab_size, **SIZE)
    images = np.random.default_rng(0).uniform(0, 1, (2, 32, 64, 3)).astype(
        np.float32)
    texts = ["abca", "ddcb"]
    ids = np.stack([tok.encode(t, 12)[0] for t in texts])
    masks = np.stack([tok.encode(t, 12)[1] for t in texts])
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(images),
                     jnp.asarray(ids[:, :-1]))["params"]
    tx = optax.adam(1e-3)
    state = {"params": params, "opt_state": tx.init(params)}
    step = j_s2s.make_seq2seq_train_step(jm, tx)
    for _ in range(150):
        state, _ = step(state, jnp.asarray(images), jnp.asarray(ids),
                        jnp.asarray(masks))
    return tok, images, texts, _np(state["params"])


# ------------------------------------------------------------ tokenizer
@pytest.mark.parametrize("charset,text,max_len", [
    ("abc ", "ab c", 16), ("x", "x" * 100, 8), ("abc", "azbyc", 6),
    ("cba", "", 4), ("日本語", "本日は語", 5)])
def test_tokenizer_matches_jax(charset, text, max_len):
    jt, tt = j_s2s.CharTokenizer(charset), t_s2s.CharTokenizer(charset)
    assert tt.chars == jt.chars and tt.vocab_size == jt.vocab_size
    for a, b in zip(tt.encode(text, max_len), jt.encode(text, max_len)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    ids = jt.encode(text, max_len)[0]
    assert tt.decode(ids[1:]) == jt.decode(ids[1:])
    assert tt.decode([3, 4, 0, 2, 3]) == jt.decode([3, 4, 0, 2, 3])


# -------------------------------------------------------------- forward
def test_forward_matches_jax():
    """Logits of float and uint8 images (the uint8 path divides by 255 on
    the device), rtol 1e-4 / atol 1e-5."""
    tok, imgs, ids, _ = _batch()
    jm, tm = _models(tok.vocab_size)
    params = _jax_params(jm, imgs, ids)
    _load(tm, params)
    # the bridge both ways: the port's tree is JAX's
    back = state_dict_to_flax(tm.state_dict())["params"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    fwd = jax.jit(lambda p, x, t: jm.apply({"params": p}, x, t))
    for x in (imgs, imgs.astype(np.float32) / 255.0):
        ref = np.asarray(fwd(params, jnp.asarray(x),
                             jnp.asarray(ids[:, :-1])))
        with torch.no_grad():
            got = tm(torch.from_numpy(x), torch.from_numpy(ids[:, :-1]))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_canvas_off_the_patch_grid_refused():
    with pytest.raises(ValueError, match="multiple of the patch"):
        t_s2s.Seq2SeqOCR(vocab_size=7, **dict(SIZE, img_h=30))
    jm = j_s2s.Seq2SeqOCR(vocab_size=7, **dict(SIZE, img_h=30))
    with pytest.raises(Exception):      # enc_pos sized by floor division
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 30, 64, 3)),
                jnp.zeros((1, 11), jnp.int32))


def test_init_draws_flax_distributions():
    """init_params: Dense / Conv kernels lecun_normal (truncated), the
    embedding N(0, 1 / dim), the positions truncated_normal(0.02), norms
    at identity, biases 0 (moments at the full width's sizes)."""
    m = t_s2s.init_params(t_s2s.Seq2SeqOCR(
        vocab_size=500, img_h=64, img_w=512, dim=256, enc_depth=1,
        dec_depth=1, heads=8, max_len=64), 0)
    e = m.tok_embed.embedding.detach().numpy()
    assert abs(e.std() * np.sqrt(256) - 1) < 0.02 and np.abs(e).max() > 3.5 \
        / np.sqrt(256)                  # untruncated
    for p in (m.enc_pos, m.dec_pos):
        p = p.detach().numpy()
        assert np.abs(p).max() <= 0.04 + 1e-7 and 0.015 < p.std() < 0.02
    w = m.dec0.self_q.weight.detach().numpy()
    assert abs(w.std() * np.sqrt(256) - 1) < 0.05 and np.abs(w).max() <= \
        2 / 0.87962566103423978 / np.sqrt(256) + 1e-6
    with torch.no_grad():
        assert float(m.dec0.self_q.bias.abs().max()) == 0.0
        assert float((m.enc_norm.weight - 1).abs().max()) == 0.0


# ----------------------------------------------------------------- step
def test_adamw_step_matches_optax():
    """Two steps of the port's train step (AdamW at optax.adamw's
    defaults) against the JAX package's with optax.adamw(1e-3): loss 1e-5
    relative, parameters 1e-4 of the largest (``_key_biases``: within
    2 lr of their start); then the bank step on the
    bank and indices equals the stream step on the gathered batch, bit
    for bit."""
    tok, imgs, ids, masks = _batch()
    jm, tm = _models(tok.vocab_size)
    params = _jax_params(jm, imgs, ids)
    tx = optax.adamw(1e-3)
    state = {"params": params, "opt_state": tx.init(params)}
    jstep = j_s2s.make_seq2seq_train_step(jm, tx)
    _load(tm, params)
    opt = AdamW([(list(tm.parameters()), 1e-3)])
    tstep = t_s2s.make_seq2seq_train_step(tm, opt)
    for i in range(2):
        sl = slice(3 * i, 3 * i + 3)
        state, jloss = jstep(state, jnp.asarray(imgs[sl]),
                             jnp.asarray(ids[sl]), jnp.asarray(masks[sl]))
        tloss = tstep(torch.from_numpy(imgs[sl]), torch.from_numpy(ids[sl]),
                      torch.from_numpy(masks[sl]))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    ref = flax_to_state_dict({"params": _np(state["params"])})
    init = flax_to_state_dict({"params": params})
    pmax = max(float(v.abs().max()) for v in ref.values())
    moved = max(float((v - init[k]).abs().max()) for k, v in ref.items())
    assert moved > 10 * 1e-4 * pmax         # the steps moved them
    noise = _key_biases(ref)
    sd = tm.state_dict()
    for k, v in ref.items():
        keep = ~noise[k]
        np.testing.assert_allclose(sd[k].numpy()[keep], v.numpy()[keep],
                                   rtol=0, atol=1e-4 * pmax, err_msg=k)
        # the key biases move by at most lr a step in both
        for got in (sd[k], v):
            assert np.abs((got - init[k]).numpy())[~keep].max(
                initial=0.0) <= 2 * 1e-3 * 1.01

    idx = np.asarray([4, 1, 3, 0])
    runs = []
    for bank in (False, True):
        m = _load(t_s2s.Seq2SeqOCR(vocab_size=tok.vocab_size, **SIZE),
                  params)
        o = AdamW([(list(m.parameters()), 1e-3)])
        step = t_s2s.make_seq2seq_train_step(m, o, bank_mode=bank)
        batch = (imgs, ids, masks, idx) if bank else (
            imgs[idx], ids[idx], masks[idx])
        loss = step(*map(torch.from_numpy, batch))
        runs.append((float(loss), m.state_dict()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def _key_biases(state):
    """{name: bool mask} of the key biases: softmax over the keys cancels
    a bias added to every key, so their gradient is 0 but for rounding,
    which Adam turns into +-lr steps of either sign."""
    out = {k: np.zeros(v.shape, bool) for k, v in state.items()}
    for k in out:
        if k.endswith(("self_k.bias", "cross_k.bias")):
            out[k][:] = True
        elif k.endswith("qkv.bias"):
            dim = len(out[k]) // 3
            out[k][dim:2 * dim] = True
    return out


# --------------------------------------------------------------- decode
def _decodes(jm, tm, params, images):
    x = jnp.asarray(images)
    jg = np.asarray(j_s2s.greedy_decode(jm, params, x, max_len=12))
    jb = np.asarray(j_s2s.beam_decode(jm, params, x, max_len=12,
                                      beam_size=4))
    _load(tm, params).eval()
    t = torch.from_numpy(images)
    tg = t_s2s.greedy_decode(tm, t, max_len=12).numpy()
    tb = t_s2s.beam_decode(tm, t, max_len=12, beam_size=4).numpy()
    return jg, jb, tg, tb


def test_decode_matches_jax_on_overfit_weights(overfit):
    tok, images, texts, params = overfit
    jm, tm = _models(tok.vocab_size)
    jg, jb, tg, tb = _decodes(jm, tm, params, images)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tb, jb)
    assert [tok.decode(r) for r in tg] == texts
    assert [tok.decode(r) for r in tb] == texts


def test_decode_ties_go_to_the_first_index(overfit):
    """A head of zeros: every logit ties, so greedy reads PAD (index 0)
    at every step and the beams take the lowest flat indices; both
    packages alike."""
    tok, images, _, params = overfit
    params = dict(params, head=jax.tree.map(np.zeros_like, params["head"]))
    jm, tm = _models(tok.vocab_size)
    jg, jb, tg, tb = _decodes(jm, tm, params, images)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tb, jb)
    assert (tg == t_s2s.PAD).all()


# -------------------------------------------------------------- dataset
def _corpus(root, specs, texts):
    """PNG lines of the given (h, w, mode) and a COCO dict."""
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    r = np.random.default_rng(0)
    coco = {"images": [], "annotations": [], "categories": []}
    for i, ((h, w, mode), t) in enumerate(zip(specs, texts)):
        arr = r.integers(0, 256, (h, w, 3)).astype(np.uint8)
        im = Image.fromarray(arr)
        if mode == "L":
            im = im.convert("L")
        elif mode == "P":
            im = im.quantize(16)
        im.save(os.path.join(img_dir, f"l{i}.png"))
        coco["images"].append({"id": i, "file_name": f"l{i}.png",
                               "text": t})
    return img_dir, coco


def test_dataset_matches_jax(tmp_path):
    """load / materialize / batches / index_batches bit for bit, on lines
    wider than the canvas (clipped to img_w), narrower (white-padded),
    taller (downscaled), a one-pixel-wide one, gray and palette."""
    specs = [(20, 50, "RGB"), (16, 400, "RGB"), (90, 40, "RGB"),
             (47, 1, "RGB"), (33, 81, "L"), (25, 70, "P")]
    img_dir, coco = _corpus(str(tmp_path), specs,
                            ["ab", "cd", "ad", "bc", "da", "abcd"])
    jds = j_data.Seq2SeqDataset(coco, img_dir, j_s2s.CharTokenizer(CHARS),
                                img_h=32, img_w=64, max_len=12)
    tds = t_data.Seq2SeqDataset(coco, img_dir, t_s2s.CharTokenizer(CHARS),
                                img_h=32, img_w=64, max_len=12)
    for a, b in zip(tds.materialize(), jds.materialize()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for kw in (dict(shuffle=False, drop_last=False), dict(seed=3)):
        for a, b in zip(tds.batches(4, **kw), jds.batches(4, **kw)):
            for x, y in zip(a[:3], b[:3]):
                np.testing.assert_array_equal(x, y)
            assert a[3] == b[3]
        for a, b in zip(tds.index_batches(4, **kw),
                        jds.index_batches(4, **kw)):
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
    assert t_data.charset_from_coco([coco]) == j_data.charset_from_coco(
        [coco])


# ------------------------------------------------------------------ CLI
@pytest.mark.parametrize("data_device", ["stream", "resident"])
def test_train_seq2seq_cli_crosses_packages(tmp_path, monkeypatch,
                                            data_device):
    """train-seq2seq on the JAX test's corpus in each package: the same
    charset.json bytes; each package's seq2seq_best.msgpack loads in the
    other and both decode the val lines to the same tokens."""
    from effocr_tpu.cli import train_seq2seq as j_cli
    from effocr_torch.__main__ import main as entry

    texts = ["ab", "cd", "ad", "bc", "da"]
    img_dir, coco = _corpus(str(tmp_path), [(20, 50, "RGB")] * 5, texts)
    cj = tmp_path / "corpus.json"
    cj.write_text(json.dumps(coco))
    flags = ["--image_dir", img_dir, "--train_coco", str(cj),
             "--val_coco", str(cj), "--batch_size", "2", "--num_epochs",
             "1", "--max_len", "8", "--dim", "32", "--img_h", "32",
             "--img_w", "64", "--data_device", data_device]
    runs = {pkg: tmp_path / pkg for pkg in ("jax", "port")}
    monkeypatch.setattr(sys, "argv", ["train-seq2seq", *flags,
                                      "--run_name", str(runs["jax"])])
    j_cli.main()
    monkeypatch.setattr(sys, "argv", [
        "effocr_torch", "train-seq2seq", *flags, "--run_name",
        str(runs["port"]), "--device", "cpu"])
    entry()
    charsets = [(runs[p] / "charset.json").read_bytes() for p in runs]
    assert charsets[0] == charsets[1]
    with open(runs["port"] / "metrics.jsonl") as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["epoch/steps"] for r in recs if "epoch/steps" in r] == [2]

    tok = j_s2s.CharTokenizer(json.loads(charsets[0]))
    size = dict(vocab_size=tok.vocab_size, img_h=32, img_w=64, dim=32,
                max_len=8)
    jm, tm = j_s2s.Seq2SeqOCR(**size), t_s2s.Seq2SeqOCR(**size)
    images = t_data.Seq2SeqDataset(coco, img_dir, t_s2s.CharTokenizer(
        tok.chars), 32, 64, 8).materialize()[0]
    template = jm.init(jax.random.PRNGKey(0), jnp.asarray(images[:1]),
                       jnp.zeros((1, 7), jnp.int32))
    for pkg in runs:
        path = str(runs[pkg] / "seq2seq_best.msgpack")
        j_params = j_ckpt.load_variables(template, path)["params"]
        _load(tm, read_variables(path)["params"]).eval()
        jt = np.asarray(j_s2s.greedy_decode(jm, j_params,
                                            jnp.asarray(images), max_len=8))
        tt = t_s2s.greedy_decode(tm, torch.from_numpy(images),
                                 max_len=8).numpy()
        np.testing.assert_array_equal(tt, jt, err_msg=pkg)
