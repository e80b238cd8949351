"""effocr_torch's TrOCR import (baselines/trocr_import.py,
baselines/trocr_hf_reference.py, cli/import_trocr.py) against the JAX
package's, on the CPU at the JAX tests' tiny configs (2 + 2 layers,
widths 32 / 48, 32 px images, vocab 16-37), the same numpy inputs:

- spec and flat params identical to ``convert_state_dict``'s for the
  three checkpoint layouts (equal widths, ``cross_attention_hidden_size``,
  ``enc_to_dec_proj`` + ``scale_embedding``); ``to_flat`` gives them back;
- logits against ``trocr_forward`` at rtol / atol 1e-4, and at
  ``t > max_positions`` (the position slice's start clamped as
  ``dynamic_slice_in_dim`` clamps it);
- greedy and beam-4 tokens identical to ``trocr_greedy_decode`` /
  ``trocr_beam_decode``, also on a head of zeros (every token ties);
- the fine-tune loss within 1e-5 relative, then two AdamW steps in bank
  mode against ``optax.adamw`` + ``make_trocr_finetune_step``: params
  within 1e-4 of the largest (the attention key biases, whose gradient
  is rounding noise, within the 2 lr a step can move them);
- the fairseq hop and a ``torch.save``d fairseq checkpoint (a foreign cfg
  object inside) bit for bit; the sinusoidal table exact;
- the npz read across packages both ways, bit for bit;
- ``_special_ids`` on the JAX test's three cases;
- ``trocr_hf_reference`` against ``VisionEncoderDecoderModel`` at 1e-5;
- the reference faults: a safetensors checkpoint without
  ``decoder.output_projection.weight`` (both packages raise) and a DeiT
  encoder (the JAX forward fails; the port refuses it up front);
- ``import-trocr`` end to end on ``--device cpu`` against the JAX
  ``convert`` / ``evaluate`` / ``finetune`` on the JAX test's fixtures:
  the same accuracy and CER printed, best CER below zero-shot.
"""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

transformers = pytest.importorskip("transformers")

from effocr_tpu.baselines import trocr_import as J  # noqa: E402
from effocr_tpu.cli import import_trocr as j_cli  # noqa: E402
from effocr_torch.baselines import trocr_import as P  # noqa: E402
from effocr_torch.baselines.trocr_hf_reference import (  # noqa: E402
    hf_reference_logits,
)
from effocr_torch.cli import import_trocr as p_cli  # noqa: E402
from effocr_torch.train.optim import AdamW  # noqa: E402
from test_trocr_import import (  # noqa: E402
    _FakeFairseqCfg,
    _hf_sd_to_fairseq,
    _make_hf_model,
)

LAYOUTS = {
    "equal": {},
    "cross_hidden": dict(enc_hidden=32, dec_hidden=48, cross_hidden=32),
    "proj_scale": dict(enc_hidden=32, dec_hidden=48, cross_hidden=None,
                       scale_embedding=True),
}


@pytest.fixture(scope="module")
def cases():
    """layout -> (HF model, config, state dict, JAX spec, JAX params)."""
    out = {}
    for name, kw in LAYOUTS.items():
        model, config = _make_hf_model(**kw)
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        spec = J.spec_from_state_dict(sd, config)
        out[name] = (model, config, sd, spec, J.convert_state_dict(sd, spec))
    return out


def _same_spec(tspec, jspec):
    return dataclasses.asdict(tspec) == dataclasses.asdict(jspec)


def _same_arrays(a, b):
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and np.array_equal(a[k], b[k]) for k in a)


def _inputs(spec, seed=0, b=2, t=7):
    rng = np.random.default_rng(seed)
    pix = rng.normal(size=(b, spec.image_size, spec.image_size, 3)).astype(
        np.float32)
    ids = rng.integers(3, spec.vocab_size, size=(b, t)).astype(np.int64)
    return pix, ids


def _port(sd, config):
    spec = P.spec_from_state_dict(sd, config)
    params = P.convert_state_dict(sd, spec)
    return spec, params, P.TrOCR.from_flat(params, spec).eval()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_spec_params_and_logits_match_jax(layout, cases):
    model, config, sd, jspec, jparams = cases[layout]
    spec, params, m = _port(sd, config)
    assert _same_spec(spec, jspec)
    assert _same_arrays(params, jparams)
    assert _same_arrays(m.to_flat(), jparams)
    if layout == "proj_scale":
        assert spec.has_enc_to_dec_proj and spec.scale_embedding
    pix, ids = _inputs(spec)
    want = np.asarray(J.trocr_forward(jparams, jspec, pix,
                                      ids.astype(np.int32)))
    with torch.no_grad():
        got = m(torch.from_numpy(pix), torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_positions_clamp_past_the_table(cases):
    """2 + t past the position table: JAX's dynamic_slice_in_dim moves
    the start back so the slice fits, and so does the port."""
    model, config, sd, jspec, jparams = cases["equal"]
    spec, params, m = _port(sd, config)
    pix, _ = _inputs(spec)
    mem_j = J.trocr_encode(jparams, jspec, pix)
    with torch.no_grad():
        mem = m.encode(torch.from_numpy(pix))
    for t in (spec.max_positions + 1, spec.max_positions + 2):
        ids = np.random.default_rng(t).integers(3, spec.vocab_size, (2, t))
        want = np.asarray(J.trocr_decode_logits(jparams, jspec, mem_j,
                                                ids.astype(np.int32)))
        with torch.no_grad():
            got = m.decode_logits(mem, torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="position table"):
        m.positions(spec.max_positions + 3)


@pytest.mark.parametrize("head", ["trained", "zeros"])
def test_greedy_and_beam_tokens_match_jax(head, cases):
    model, config, sd, jspec, jparams = cases["equal"]
    jparams = dict(jparams)
    if head == "zeros":         # every logit ties: the first index wins
        jparams["dec/out_proj_w"] = np.zeros_like(jparams["dec/out_proj_w"])
    m = P.TrOCR.from_flat(jparams, P.spec_from_state_dict(sd, config))
    rng = np.random.default_rng(7)
    pix = rng.normal(size=(4, jspec.image_size, jspec.image_size, 3)).astype(
        np.float32)
    ids = dict(bos_id=1, eos_id=2, pad_id=0)
    for max_len in (12, jspec.max_positions + 2):
        want = np.asarray(J.trocr_greedy_decode(jparams, jspec, pix,
                                                max_len=max_len, **ids))
        greedy = P.trocr_greedy_decode(m, torch.from_numpy(pix),
                                       max_len=max_len, **ids).numpy()
        np.testing.assert_array_equal(greedy, want)
        want = np.asarray(J.trocr_beam_decode(jparams, jspec, pix,
                                              max_len=max_len, num_beams=4,
                                              **ids))
        got = P.trocr_beam_decode(m, torch.from_numpy(pix), max_len=max_len,
                                  num_beams=4, **ids).numpy()
        np.testing.assert_array_equal(got, want)
    if head == "zeros":
        assert (greedy == 0).all()


def test_finetune_steps_match_optax(cases):
    model, config, sd, jspec, jparams = cases["equal"]
    lr = 1e-3
    rng = np.random.default_rng(0)
    bank_pix = rng.integers(0, 256, (4, jspec.image_size, jspec.image_size,
                                     3), dtype=np.uint8)
    labels = np.zeros((4, 9), np.int32)
    for i, row in enumerate([[1, 5, 6, 7, 8, 2], [1, 9, 10, 2],
                             [1, 4, 4, 4, 2], [1, 11, 2]]):
        labels[i, :len(row)] = row
    mask = labels != 0
    tx = optax.adamw(lr)
    pj = jax.tree.map(jnp.asarray, jparams)
    state = {"params": pj, "opt_state": tx.init(pj)}
    jstep = J.make_trocr_finetune_step(jspec, tx, 1, bank_mode=True)
    m = P.TrOCR.from_flat(jparams, P.spec_from_state_dict(sd, config))
    opt = AdamW([(list(m.parameters()), lr)])
    tstep = P.make_trocr_finetune_step(m, opt, 1, bank_mode=True)
    tbank = (torch.from_numpy(bank_pix), torch.from_numpy(labels).long(),
             torch.from_numpy(mask))
    for idx in ([0, 2], [3, 1]):
        state, jloss = jstep(state, bank_pix, labels, mask,
                             np.asarray(idx, np.int32))
        tloss = float(tstep(*tbank, torch.tensor(idx)))
        assert abs(tloss - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = jax.tree.map(np.asarray, state["params"])
    got = m.to_flat()
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k, v in want.items():
        err = float(np.abs(got[k] - v).max())
        limit = 2 * 2 * lr if re.search(r"k_b$", k) else 1e-4 * scale
        assert err <= limit, (k, err)


def test_fairseq_hop_and_checkpoint_bit_for_bit(cases, tmp_path):
    model, config, sd, jspec, jparams = cases["equal"]
    fs = _hf_sd_to_fairseq(sd)
    assert _same_arrays(P.fairseq_to_hf_state_dict(fs),
                        J.fairseq_to_hf_state_dict(fs))
    # sinusoidal decoder positions: the fairseq marker, no learned table
    fs_sin = {k: v for k, v in fs.items() if "embed_positions" not in k}
    fs_sin["decoder.embed_positions._float_tensor"] = np.zeros(1, np.float32)
    assert _same_arrays(P.fairseq_to_hf_state_dict(fs_sin),
                        J.fairseq_to_hf_state_dict(fs_sin))
    for n, d in ((10, 8), (514, 32), (7, 5)):
        a, b = P._fairseq_sinusoidal(n, d), J._fairseq_sinusoidal(n, d)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    path = str(tmp_path / "fairseq_trocr.pt")
    torch.save({"model": {k: torch.from_numpy(np.asarray(v))
                          for k, v in fs.items()},
                "cfg": _FakeFairseqCfg(), "args": None}, path)
    tp, tspec = P.import_fairseq_checkpoint(path)
    jp, js = J.import_fairseq_checkpoint(path)
    assert _same_spec(tspec, js) and tspec.activation == "relu"
    assert _same_arrays(tp, jp)


def test_npz_crosses_packages(cases, tmp_path):
    model, config, sd, jspec, jparams = cases["cross_hidden"]
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    J.save_trocr_npz(a, jparams, jspec)
    tp, ts = P.load_trocr_npz(a)
    assert _same_spec(ts, jspec) and _same_arrays(tp, jparams)
    P.save_trocr_npz(b, tp, ts)
    jp, js = J.load_trocr_npz(b)
    assert js == jspec and _same_arrays(jp, jparams)
    with np.load(b) as z:
        assert json.loads(bytes(z["__spec__"]).decode()) == \
            dataclasses.asdict(jspec)


def test_special_id_resolution(tmp_path):
    class FakeTok:
        eos_token_id = None
        sep_token_id = None
        pad_token_id = 0   # legitimate id 0

    for name, cfg, tok, want in (
            ("a", {"decoder": {}}, FakeTok(), (2, 2, 0)),
            ("b", {"decoder_start_token_id": None,
                   "decoder": {"eos_token_id": None,
                               "pad_token_id": None}}, None, (2, 2, 1)),
            ("c", {"decoder_start_token_id": 7,
                   "decoder": {"eos_token_id": 8, "pad_token_id": 9}},
             FakeTok(), (7, 8, 9))):
        d = tmp_path / name
        d.mkdir()
        (d / "config.json").write_text(json.dumps(cfg))
        assert p_cli._special_ids(str(d), tok) == want
        assert j_cli._special_ids(str(d), tok) == want


@pytest.mark.parametrize("layout,act", [("equal", "gelu"),
                                        ("cross_hidden", "gelu_new"),
                                        ("proj_scale", "relu")])
def test_hf_reference_matches_transformers(layout, act):
    model, config = _make_hf_model(**LAYOUTS[layout])
    model.config.decoder.activation_function = act
    model.decoder.model.decoder.layers[0].activation_fn = \
        transformers.activations.ACT2FN[act]
    model.decoder.model.decoder.layers[1].activation_fn = \
        transformers.activations.ACT2FN[act]
    config["decoder"]["activation_function"] = act
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    pix, ids = _inputs(J.spec_from_state_dict(sd, config), seed=3, t=9)
    with torch.no_grad():
        want = model(pixel_values=torch.from_numpy(pix).permute(0, 3, 1, 2),
                     decoder_input_ids=torch.from_numpy(ids)).logits.numpy()
    got = hf_reference_logits(sd, config, pix, ids)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the port's float32 model of those weights meets it at the check's
    # tolerance, with room to spare
    spec, params, m = _port(sd, config)
    with torch.no_grad():
        mine = m(torch.from_numpy(pix), torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(mine, got, rtol=1e-4, atol=1e-4)


def test_safetensors_without_output_projection_is_refused(tmp_path):
    """transformers 4.57's save_pretrained(safe_serialization=True) drops
    the output projection tied to the token embedding; the JAX importer
    raises KeyError on it, and so does the port, naming the key."""
    model, _ = _make_hf_model()
    d = tmp_path / "st"
    model.save_pretrained(d, safe_serialization=True)
    assert (d / "model.safetensors").exists()
    with pytest.raises(KeyError, match="decoder.output_projection.weight"):
        J.import_hf_checkpoint(str(d))
    with pytest.raises(KeyError, match="decoder.output_projection.weight"):
        P.import_hf_checkpoint(str(d))


def test_deit_encoder_fails_in_jax_and_is_refused_by_the_port():
    """trocr-small's DeiT encoder: its distillation token gives the
    position table 2 + N rows.  The JAX package infers a spec, then its
    forward fails to add 1 + N tokens to 2 + N positions; the port
    refuses the state dict with a message."""
    from transformers import (
        DeiTConfig,
        TrOCRConfig,
        VisionEncoderDecoderConfig,
        VisionEncoderDecoderModel,
    )

    ec = DeiTConfig(hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=64,
                    image_size=32, patch_size=16)
    dc = TrOCRConfig(d_model=32, decoder_layers=2, decoder_attention_heads=2,
                     decoder_ffn_dim=64, vocab_size=16,
                     max_position_embeddings=24)
    torch.manual_seed(0)
    m = VisionEncoderDecoderModel(
        VisionEncoderDecoderConfig.from_encoder_decoder_configs(ec, dc))
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    config = {"encoder": ec.to_dict(), "decoder": dc.to_dict()}
    assert sd["encoder.embeddings.position_embeddings"].shape[1] == 2 + 4
    spec = J.spec_from_state_dict(sd, config)
    params = J.convert_state_dict(sd, spec)
    with pytest.raises(TypeError, match="broadcast"):
        J.trocr_encode(params, spec, np.zeros((1, 32, 32, 3), np.float32))
    with pytest.raises(ValueError, match="DeiT"):
        P.spec_from_state_dict(sd, config)


# --------------------------------------------------------- the command
def _cli_fixture(tmp_path):
    """The JAX test's checkpoint (vocab 16, pytorch_model.bin), its
    char-level WordLevel tokenizer and six 'abc' line PNGs."""
    from PIL import Image
    from test_torch_tokenizer import _wordlevel_dir

    model, _ = _make_hf_model(vocab=16)
    model_dir = tmp_path / "hf_ckpt"
    model.save_pretrained(model_dir, safe_serialization=False)
    _wordlevel_dir(str(model_dir))
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    images = []
    for i in range(6):
        name = f"line{i}.png"
        Image.fromarray(rng.integers(0, 255, (24, 90, 3), dtype=np.uint8)
                        ).save(img_dir / name)
        images.append({"id": i, "file_name": name, "text": "abc"})
    coco = str(tmp_path / "eval.json")
    with open(coco, "w") as f:
        json.dump({"images": images, "annotations": [], "categories": []}, f)
    return str(model_dir), str(img_dir), coco


def _metrics(text, prefix):
    return [(float(a), float(c)) for a, c in re.findall(
        prefix + r".*?line_accuracy=([0-9.]+) CER=([0-9.]+)", text)]


def test_cli_matches_jax(tmp_path, capsys, monkeypatch):
    from effocr_torch import __main__ as entry

    model_dir, img_dir, coco = _cli_fixture(tmp_path)
    j_out, t_out = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j_cli.convert(model_dir, j_out, check=True)
    j_cli.evaluate(j_out, model_dir, coco, img_dir, batch=2, max_len=8,
                   num_beams=4)
    j_text = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", [
        "effocr_torch", "import-trocr", "--device", "cpu", "--model_dir",
        model_dir, "--out", t_out, "--check", "--coco_json", coco,
        "--image_dir", img_dir, "--batch", "2", "--max_len", "8"])
    entry.main()
    t_text = capsys.readouterr().out
    assert "torch parity check passed" in t_text
    gap = float(re.search(r"max \|logit diff\| (\S+)", t_text).group(1))
    assert gap < 1e-5
    assert _same_arrays(P.load_trocr_npz(t_out)[0], J.load_trocr_npz(j_out)[0])
    assert len(_metrics(j_text, "n=6")) == 1
    assert _metrics(t_text, "n=6") == _metrics(j_text, "n=6")
    assert re.search(r"decode: 6 lines in \S+ s \(beam 4", t_text)

    # fine-tune: a random tiny model must memorize the constant line and
    # beat zero-shot CER, epoch by epoch as JAX does
    j_best = j_cli.finetune(j_out, model_dir, coco, coco, img_dir,
                            num_epochs=10, batch=2, lr=5e-3, max_len=8)
    j_text = capsys.readouterr().out
    t_best = p_cli.finetune(t_out, model_dir, coco, coco, img_dir,
                            num_epochs=10, batch=2, lr=5e-3, max_len=8,
                            device="cpu")
    t_text = capsys.readouterr().out
    zero = _metrics(t_text, "zero-shot")
    assert zero == _metrics(j_text, "zero-shot")
    assert _metrics(t_text, r"epoch \d+:") == _metrics(j_text, r"epoch \d+:")
    j_loss = [float(x) for x in re.findall(r"loss=([0-9.]+)", j_text)]
    t_loss = [float(x) for x in re.findall(r"epoch \d+: loss=([0-9.]+)",
                                           t_text)]
    np.testing.assert_allclose(t_loss, j_loss, rtol=2e-3, atol=1e-3)
    assert t_best == j_best and t_best < min(zero[0][1], 0.5)
    assert re.search(r"epoch 0 train: steps=3 images=6 seconds=", t_text)
