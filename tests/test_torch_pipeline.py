"""The ported slice as a whole: effocr_torch's EffOCRInference against the
JAX engine on the fused letterbox path.

Both engines run the pinned English config scaled down: 1-channel gray
PNG input through the native fused decode, 4-bit transfer, u16 output
packing, the kernel NMS route (Pallas in interpret mode / the port's CUDA
route, plain on CPU tensors), adaptive height and width, width-sorted
chunks, line_batch 4, crop_batch 64, encoder_sub_batch 32.  Lines are
synthetic DejaVu renders (tests/test_pipeline_e2e.py).  Both engines get
the same localizer: an oracle that reads glyph and word boxes off the
canvas it is given (in numpy, through jax.pure_callback on the JAX side)
and adds a lower-scoring jittered duplicate of each glyph for NMS to
suppress, with exact score ties throughout.

Tolerances: with the tiny encoder, identical text and identical packed
u16 fields (n_chars, nn_idx, char boxes, valid word boxes); with a
bridged mobilenetv3_small_050 at 128 px in float32, identical nn_idx
wherever the JAX top-1 retrieval margin exceeds 1e-4.

The Japanese vertical slice (jp_v3's flags scaled down: ``lang jp``,
``vertical``, ``retrieval_kernel pallas``, 3-channel RGB PNG files, 4-bit
transfer, i32 output, a canvas 64 wide and 256 tall so the crop window
is 64 and the ROI crop takes its row-gather ``w <= window`` branch) runs
the same way with a vertical oracle (one box per ink row run) and the
JAX engine's Pallas top-1 kernel in interpret mode: identical text and
packed fields with the tiny encoder, in tight and line crop geometry;
identical n_chars and boxes, and nn_idx wherever the JAX margin exceeds
1e-4, with a narrow float32 ConvNeXt.  The ROI crop's three branches
are held to JAX at 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from PIL import Image

from effocr_tpu.core.config import (
    EncoderConfig as JEncoderConfig,
    LocalizerConfig as JLocalizerConfig,
    PipelineConfig as JPipelineConfig,
)
from effocr_tpu.kernels import pallas_retrieval
from effocr_tpu.kernels.roi import crop_lines_to_squares
from effocr_tpu.models.convnext import ConvNeXt as JConvNeXt
from effocr_tpu.models import create_encoder as j_encoder
from effocr_tpu.pipelines.infer import EffOCRInference as JEngine
from effocr_tpu.retrieval.index import PrototypeIndex as JIndex
from effocr_torch.core.config import (
    EncoderConfig,
    LocalizerConfig,
    PipelineConfig,
)
from effocr_torch.interop.flax_bridge import flax_to_state_dict
from effocr_torch.kernels.cuda_nms import nms_kernel
from effocr_torch.kernels.cuda_top1 import top1_kernel
from effocr_torch.kernels.roi import crop_lines_to_squares as t_crop
from effocr_torch.models.convnext import ConvNeXt
from effocr_torch.models.factory import create_encoder
from effocr_torch.models.layers import Dense
from effocr_torch.pipelines.infer import EffOCRInference
from effocr_torch.retrieval.index import PrototypeIndex
from test_pipeline_e2e import CHARS, make_line, render_char

A = 64          # oracle anchor slots per line
TEXTS = ["AbX oT", "kXobAkXobA bXoT", "bA X", "kXo bA", "ToXb", "XkXk ob",
         "oT kA", "bXkoTA Xo"]


class TinyEncoder(nn.Module):
    """8x8-avg-pooled gray, flattened, projected (test_pipeline_e2e's)."""

    @nn.compact
    def __call__(self, x, train: bool = False):
        g = jnp.mean(x, axis=-1, keepdims=True)
        g = nn.avg_pool(g, (8, 8), strides=(8, 8))
        return nn.Dense(64, use_bias=False)(g.reshape(g.shape[0], -1))


class TorchTinyEncoder(torch.nn.Module):
    """PyTorch twin of TinyEncoder (same NHWC flatten order)."""

    def __init__(self, in_features):
        super().__init__()
        self.Dense_0 = Dense(in_features, 64, bias=False)

    def forward(self, x):
        g = x.float().mean(-1, keepdim=True).permute(0, 3, 1, 2)
        g = torch.nn.functional.avg_pool2d(g, 8).permute(0, 2, 3, 1)
        return self.Dense_0(g.reshape(g.shape[0], -1))


def oracle_predictions(canvas):
    """[B, H, W, 1] canvas in [0,1] -> decoded [B, A, 7]: one box per
    connected ink column run (a glyph) with a jittered duplicate, and one
    box per word (runs separated by gaps > 0.3 x glyph height)."""
    canvas = np.asarray(canvas, np.float32)
    pred = np.zeros((canvas.shape[0], A, 7), np.float32)
    for b, img in enumerate(canvas[..., 0]):
        ink = img < 0.3
        cols = np.concatenate([[False], ink.any(0), [False]])
        edges = np.flatnonzero(cols[1:] != cols[:-1])
        glyphs = []
        for x0, x1 in zip(edges[0::2], edges[1::2]):
            rows = np.flatnonzero(ink[:, x0:x1].any(1))
            glyphs.append((float(x0), float(rows[0]), float(x1),
                           float(rows[-1] + 1)))
        if not glyphs:
            continue
        gap = 0.3 * max(g[3] - g[1] for g in glyphs)
        words, cur = [], [glyphs[0]]
        for g in glyphs[1:]:
            if g[0] - cur[-1][2] > gap:
                words.append(cur)
                cur = []
            cur.append(g)
        words.append(cur)
        slot = 0
        rows = []
        for x0, y0, x1, y1 in glyphs:
            rows.append([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0,
                         0.95, 0.99, 0.01])
            rows.append([(x0 + x1) / 2 + 1, (y0 + y1) / 2, x1 - x0, y1 - y0,
                         0.7, 0.99, 0.01])
        for w in words:
            x0, x1 = w[0][0], w[-1][2]
            y0, y1 = min(g[1] for g in w), max(g[3] for g in w)
            rows.append([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0,
                         0.9, 0.01, 0.99])
        for slot, r in enumerate(rows[:A]):
            pred[b, slot] = r
    return pred


class JaxOracle:
    def apply(self, variables, imgs, train=False):
        shape = jax.ShapeDtypeStruct((imgs.shape[0], A, 7), jnp.float32)
        return jax.pure_callback(oracle_predictions, shape,
                                 imgs.astype(jnp.float32)), None


def torch_oracle(imgs):
    return torch.from_numpy(oracle_predictions(imgs.float().numpy())), None


def _config(cls, loc_cls, enc_cls, **kw):
    base = dict(
        lang="en", input_channels=1, transfer_bits=4, out_quant="u16",
        adaptive_height=True, adaptive_height_floor=64,
        adaptive_height_cap=96, adaptive_width=True, chunk_sort="width",
        line_batch=4, crop_batch=64, encoder_sub_batch=32,
        crop_geometry="tight",
    )
    base.update(kw)
    return cls(
        localizer=loc_cls(input_size=512, input_height=96, input_channels=1,
                          conf_thresh=0.3, iou_thresh=0.25, max_nms=A,
                          max_det=32),
        encoder=enc_cls(arch="test", image_size=128, input_channels=1),
        **base)


@pytest.fixture(scope="module")
def line_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("lines")
    paths = []
    for i, text in enumerate(TEXTS):
        img, _, _ = make_line(text)
        gray = img.mean(axis=-1).astype(np.uint8)
        p = str(d / f"line{i}.png")
        Image.fromarray(gray, mode="L").save(p)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def tiny_parts():
    """TinyEncoder variables and glyph prototypes cut by the JAX crop
    kernel from single-glyph gray lines (the pipeline's tight crops)."""
    enc = TinyEncoder()
    variables = enc.init(jax.random.PRNGKey(3), jnp.zeros((1, 128, 128, 1)))
    crops = []
    for ch in CHARS:
        img, boxes, _ = make_line(ch)
        gray = img.mean(axis=-1, keepdims=True)[None].astype(np.float32)
        crops.append(crop_lines_to_squares(
            jnp.asarray(gray / 255.0), jnp.asarray([boxes[0]], jnp.int32),
            jnp.zeros((1,), jnp.int32), jnp.ones((1,), bool), out_size=128,
            window=256)[0])
    protos = np.asarray(enc.apply(variables, jnp.stack(crops)))
    return enc, variables, protos


def _record_buffers(engine, store):
    """Record each packed buffer the engine decodes, by its chunk keys."""
    orig = engine._finish_fused_segment

    def wrapped(buf, chunk, chunk_keys, *args, **kw):
        store[tuple(chunk_keys)] = (np.asarray(buf).copy(), len(chunk))
        return orig(buf, chunk, chunk_keys, *args, **kw)

    engine._finish_fused_segment = wrapped


def _fields(buf, n, cfg):
    nb, m = cfg.line_batch, cfg.localizer.max_det
    cap = min(cfg.crop_batch, nb * m)
    w = min(cfg.max_words_per_line, m)
    n_chars = buf[:nb]
    total = int(n_chars[:n].astype(np.int64).sum())
    nn_idx = buf[nb:nb + cap]
    boxes = buf[nb + cap:nb + 5 * cap].reshape(cap, 4)
    o = nb + 5 * cap
    wboxes = buf[o:o + nb * w * 4].reshape(nb, w, 4)
    wvalid = buf[o + nb * w * 4:].reshape(nb, w).astype(bool)
    return (n_chars[:n], nn_idx[:min(total, cap)],
            boxes[:min(total, cap)], wvalid[:n], wboxes[:n][wvalid[:n]])


def _run_both(line_paths, j_enc, j_vars, t_enc, protos, chars, **kw):
    jcfg = _config(JPipelineConfig, JLocalizerConfig, JEncoderConfig,
                   nms_kernel="pallas", **kw)
    tcfg = _config(PipelineConfig, LocalizerConfig, EncoderConfig,
                   nms_kernel="cuda", **kw)
    jeng = JEngine(jcfg, JaxOracle(), {}, j_enc, j_vars,
                   JIndex(protos, chars))
    teng = EffOCRInference(tcfg, torch_oracle, t_enc,
                           PrototypeIndex(protos, chars), device="cpu")
    jbufs, tbufs = {}, {}
    _record_buffers(jeng, jbufs)
    _record_buffers(teng, tbufs)
    return (jeng.run(line_paths), teng.run(line_paths), jbufs, tbufs,
            tcfg)


@pytest.mark.parametrize("crop_batch,sub", [(64, 32), (16, 8)])
def test_slice_matches_jax_tiny_encoder(line_paths, tiny_parts, crop_batch,
                                        sub):
    """crop_batch 16 < the chars of a chunk: lines spill into re-dispatched
    chunks on both engines."""
    enc, variables, protos = tiny_parts
    t_enc = TorchTinyEncoder(256)
    t_enc.load_state_dict(flax_to_state_dict(variables), strict=True)
    before = nms_kernel.launches
    jres, tres, jbufs, tbufs, cfg = _run_both(
        line_paths, enc, variables, t_enc, protos, CHARS,
        crop_batch=crop_batch, encoder_sub_batch=sub)
    assert nms_kernel.launches == before   # CPU tensors: plain version
    for i, p in enumerate(line_paths):
        assert tres[p] == jres[p] == TEXTS[i], (tres[p], jres[p], TEXTS[i])
    assert jbufs.keys() == tbufs.keys()
    if crop_batch == 16:
        assert len(tbufs) > 2, "expected overflow re-dispatches"
    for key in jbufs:
        (jb, n), (tb, tn) = jbufs[key], tbufs[key]
        assert jb.dtype == tb.dtype == np.uint16 and n == tn
        for a, b in zip(_fields(jb, n, cfg), _fields(tb, n, cfg)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bits", [8, 2])
def test_rgb_array_canvas_matches_jax(tiny_parts, bits):
    """3-channel pipeline fed HWC arrays: native letterbox, then the numpy
    pack (2-bit: Bayer-dithered) and the device unpack."""
    enc, variables, protos = tiny_parts
    t_enc = TorchTinyEncoder(256)
    t_enc.load_state_dict(flax_to_state_dict(variables), strict=True)
    imgs = [make_line(t)[0] for t in TEXTS[:4]]
    kw = dict(input_channels=3, transfer_bits=bits, crop_geometry="tight")
    jcfg = _config(JPipelineConfig, JLocalizerConfig, JEncoderConfig,
                   nms_kernel="pallas", **kw)
    tcfg = _config(PipelineConfig, LocalizerConfig, EncoderConfig,
                   nms_kernel="cuda", **kw)
    jres = JEngine(jcfg, JaxOracle(), {}, enc, variables,
                   JIndex(protos, CHARS)).run(imgs)
    tres = EffOCRInference(tcfg, torch_oracle, t_enc,
                           PrototypeIndex(protos, CHARS),
                           device="cpu").run(imgs)
    assert tres == jres == dict(enumerate(TEXTS[:4]))


def test_slice_matches_jax_mobilenet(line_paths):
    rng = np.random.default_rng(4)
    j_enc = j_encoder("mobilenetv3_small_050", dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda x: j_enc.init(jax.random.PRNGKey(5), x))(
            jnp.zeros((1, 128, 128, 1))))
    t_enc = create_encoder("mobilenetv3_small_050", in_channels=1,
                           dtype=torch.float32)
    t_enc.load_state_dict(flax_to_state_dict(variables), strict=True)
    protos = rng.normal(size=(89, 1024)).astype(np.float32)
    chars = [chr(0x21 + i) for i in range(89)]

    # record the JAX engine's embeddings to compute its top-1 margins
    embs = []

    class Recording:
        def apply(self, v, x, train=False):
            e = j_enc.apply(v, x, train=train)
            jax.debug.callback(lambda a: embs.append(np.asarray(a)), e,
                               ordered=True)
            return e

    _, _, jbufs, tbufs, cfg = _run_both(line_paths, Recording(), variables,
                                        t_enc, protos, chars)
    assert jbufs.keys() == tbufs.keys()
    pn = protos / np.linalg.norm(protos, axis=1, keepdims=True)
    n_cmp = 0
    for ci, key in enumerate(jbufs):
        (jb, n), (tb, _) = jbufs[key], tbufs[key]
        jf, tf = _fields(jb, n, cfg), _fields(tb, n, cfg)
        for a, b in zip(jf[:1] + jf[2:], tf[:1] + tf[2:]):
            np.testing.assert_array_equal(a, b)
        # chunks run in order; each ran 2 sub-batches of embeddings
        emb = np.concatenate(embs[2 * ci:2 * ci + 2])[:len(jf[1])]
        sims = (emb / np.linalg.norm(emb, axis=1, keepdims=True)) @ pn.T
        top2 = np.sort(sims, axis=1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 1e-4
        assert (np.argmax(sims, axis=1) == jf[1]).all()
        np.testing.assert_array_equal(jf[1][sure], tf[1][sure])
        n_cmp += int(sure.sum())
    assert n_cmp > 20, n_cmp


# ------------------------------------------------------------ jp vertical
VTEXTS = ["AbXoT", "kXobAkXo", "bAX", "TokXbA", "XkXkob", "oTk"]
INK, PAPER = (30, 20, 70), (250, 244, 228)    # dark blue ink, cream paper


@pytest.mark.parametrize("branch", ["w_le_window", "h_le_window",
                                    "general_2d"])
def test_roi_branches_match_jax(branch):
    """general_2d: a canvas larger than the window on both axes (the
    square-canvas branch), with rects on the right and bottom edges and
    rects wider than the window (their far edge is clamped)."""
    rng = np.random.default_rng(11)
    window = 64
    shape = {"w_le_window": (3, 256, 64, 3), "h_le_window": (3, 48, 300, 3),
             "general_2d": (3, 100, 90, 3)}[branch]
    imgs = rng.uniform(0, 1, shape).astype(np.float32)
    b, h, w, _ = shape
    n = 40
    x0 = rng.integers(-4, w - 2, n)
    y0 = rng.integers(-4, h - 2, n)
    # sides up to past the window and the canvas edge (clamped)
    rects = np.stack([x0, y0, x0 + rng.integers(1, 80, n),
                      y0 + rng.integers(1, 80, n)], 1).astype(np.int32)
    if branch == "general_2d":
        rects[:4, 2] = w                      # on the right edge
        rects[4:8, 3] = h + 5                 # past the bottom edge
        rects[8:12, 2] = rects[8:12, 0] + 90  # wider than the window
    img_idx = rng.integers(0, b, n).astype(np.int32)
    valid = rng.uniform(size=n) > 0.1
    ref = np.asarray(crop_lines_to_squares(
        jnp.asarray(imgs), jnp.asarray(rects), jnp.asarray(img_idx),
        jnp.asarray(valid), out_size=32, window=window))
    got = t_crop(torch.from_numpy(imgs), torch.from_numpy(rects),
                 torch.from_numpy(img_idx), torch.from_numpy(valid),
                 out_size=32, window=window).numpy()
    assert got.shape == ref.shape == (n, 32, 32, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def make_vline(text, char_h=40, pad=6):
    """RGB vertical line: glyphs stacked top to bottom, centred."""
    glyphs = [render_char(c, char_h).convert("L") for c in text]
    width = max(g.width for g in glyphs) + 2 * pad
    height = sum(g.height + pad for g in glyphs) + pad
    ink = np.full((height, width), 255, np.uint8)
    y = pad
    for g in glyphs:
        x = (width - g.width) // 2
        ink[y:y + g.height, x:x + g.width] = np.asarray(g)
        y += g.height + pad
    a = (ink.astype(np.float32) / 255.0)[..., None]
    rgb = a * np.asarray(PAPER, np.float32) + (1 - a) * np.asarray(
        INK, np.float32)
    return np.round(rgb).astype(np.uint8)


def vertical_oracle_predictions(canvas):
    """[B, H, W, 3] canvas in [0,1] -> decoded [B, A, 7]: one char box
    per ink row run (a glyph) plus a lower-scoring duplicate 1 px lower."""
    canvas = np.asarray(canvas, np.float32)
    pred = np.zeros((canvas.shape[0], A, 7), np.float32)
    for b, img in enumerate(canvas.mean(-1)):
        ink = img < 0.4
        rows = np.concatenate([[False], ink.any(1), [False]])
        edges = np.flatnonzero(rows[1:] != rows[:-1])
        out = []
        for y0, y1 in zip(edges[0::2], edges[1::2]):
            cols = np.flatnonzero(ink[y0:y1].any(0))
            x0, x1 = float(cols[0]), float(cols[-1] + 1)
            cx, cy, bw, bh = (x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0
            out.append([cx, cy, bw, bh, 0.95, 0.99, 0.01])
            out.append([cx, cy + 1, bw, bh, 0.7, 0.99, 0.01])
        for slot, r in enumerate(out[:A]):
            pred[b, slot] = r
    return pred


class JaxVerticalOracle:
    def apply(self, variables, imgs, train=False):
        shape = jax.ShapeDtypeStruct((imgs.shape[0], A, 7), jnp.float32)
        return jax.pure_callback(vertical_oracle_predictions, shape,
                                 imgs.astype(jnp.float32)), None


def torch_vertical_oracle(imgs):
    return torch.from_numpy(vertical_oracle_predictions(
        imgs.float().numpy())), None


def _jp_config(cls, loc_cls, enc_cls, **kw):
    base = dict(
        lang="jp", vertical=True, input_channels=3, transfer_bits=4,
        out_quant="i32", line_batch=4, crop_batch=64,
        retrieval_kernel="pallas", crop_geometry="tight",
    )
    base.update(kw)
    return cls(
        localizer=loc_cls(input_size=64, input_height=256, input_channels=3,
                          conf_thresh=0.3, iou_thresh=0.01, max_nms=A,
                          max_det=32),
        encoder=enc_cls(arch="test", image_size=128, input_channels=3),
        **base)


@pytest.fixture(scope="module")
def vline_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("vlines")
    paths = []
    for i, text in enumerate(VTEXTS):
        p = str(d / f"v{i}.png")
        Image.fromarray(make_vline(text), mode="RGB").save(p)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def jp_tiny_parts():
    """TinyEncoder variables and glyph prototypes: tight crops of single
    RGB glyphs cut by the JAX crop kernel."""
    enc = TinyEncoder()
    variables = enc.init(jax.random.PRNGKey(7), jnp.zeros((1, 128, 128, 3)))
    crops = []
    for ch in CHARS:
        img = make_vline(ch)[None].astype(np.float32) / 255.0
        ink = np.flatnonzero((img[0].mean(-1) < 0.4).any(1))
        cols = np.flatnonzero((img[0].mean(-1) < 0.4).any(0))
        box = [cols[0], ink[0], cols[-1] + 1, ink[-1] + 1]
        crops.append(crop_lines_to_squares(
            jnp.asarray(img), jnp.asarray([box], jnp.int32),
            jnp.zeros((1,), jnp.int32), jnp.ones((1,), bool), out_size=128,
            window=256)[0])
    protos = np.asarray(enc.apply(variables, jnp.stack(crops)))
    return enc, variables, protos


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """The JAX engine's Pallas top-1 kernel in interpret mode (the CPU
    backend runs Pallas only so, as tests/test_pallas_retrieval.py does)."""
    orig = pallas_retrieval.pallas_top1

    def interpret(*args, **kw):
        calls.append(1)
        return orig(*args, interpret=True, **kw)

    calls = []
    monkeypatch.setattr(pallas_retrieval, "pallas_top1", interpret)
    return calls


def _run_both_jp(paths, j_enc, j_vars, t_enc, protos, chars, **kw):
    jcfg = _jp_config(JPipelineConfig, JLocalizerConfig, JEncoderConfig,
                      nms_kernel="pallas", **kw)
    tcfg = _jp_config(PipelineConfig, LocalizerConfig, EncoderConfig,
                      nms_kernel="cuda", **kw)
    jeng = JEngine(jcfg, JaxVerticalOracle(), {}, j_enc, j_vars,
                   JIndex(protos, chars))
    teng = EffOCRInference(tcfg, torch_vertical_oracle, t_enc,
                           PrototypeIndex(protos, chars), device="cpu")
    jbufs, tbufs = {}, {}
    _record_buffers(jeng, jbufs)
    _record_buffers(teng, tbufs)
    return (jeng.run(paths), teng.run(paths), jbufs, tbufs, tcfg)


def _jp_fields(buf, n, cfg):
    """(n_chars, nn_idx, char boxes) of a jp packed i32 buffer: no word
    fields."""
    nb, m = cfg.line_batch, cfg.localizer.max_det
    cap = min(cfg.crop_batch, nb * m)
    assert buf.shape == (nb + 5 * cap,), buf.shape
    n_chars = buf[:nb]
    total = min(int(n_chars[:n].astype(np.int64).sum()), cap)
    return (n_chars[:n], buf[nb:nb + total],
            buf[nb + cap:nb + 5 * cap].reshape(cap, 4)[:total])


@pytest.mark.parametrize("geometry,crop_batch,extra", [
    ("tight", 64, {}),
    ("line", 64, {}),
    ("tight", 12, {"adaptive_width": True, "chunk_sort": "width"}),
])
def test_jp_vertical_slice_matches_jax_tiny_encoder(
        vline_paths, jp_tiny_parts, pallas_interpret, geometry, crop_batch,
        extra):
    """crop_batch 12 < the chars of a chunk: lines spill into
    re-dispatched chunks on both engines; adaptive_width trims the canvas
    height of vertical chunks and chunk_sort orders lines by height."""
    enc, variables, protos = jp_tiny_parts
    t_enc = TorchTinyEncoder(256)
    t_enc.load_state_dict(flax_to_state_dict(variables), strict=True)
    before = (nms_kernel.launches, top1_kernel.launches)
    jres, tres, jbufs, tbufs, cfg = _run_both_jp(
        vline_paths, enc, variables, t_enc, protos, CHARS,
        crop_geometry=geometry, crop_batch=crop_batch, **extra)
    assert pallas_interpret, "the JAX engine did not reach pallas_top1"
    # CPU tensors: the plain versions, no kernel launch
    assert (nms_kernel.launches, top1_kernel.launches) == before
    assert tres == jres
    if geometry == "tight":
        assert [tres[p] for p in vline_paths] == VTEXTS
    assert jbufs.keys() == tbufs.keys()
    if crop_batch == 12:
        assert len(tbufs) > 2, "expected overflow re-dispatches"
    for key in jbufs:
        (jb, n), (tb, tn) = jbufs[key], tbufs[key]
        assert jb.dtype == tb.dtype == np.int32 and n == tn
        for a, b in zip(_jp_fields(jb, n, cfg), _jp_fields(tb, n, cfg)):
            np.testing.assert_array_equal(a, b)


def test_jp_vertical_slice_matches_jax_convnext(vline_paths,
                                                pallas_interpret):
    """A narrow float32 ConvNeXt (one block per stage) with O(1)
    LayerScale, 40 random prototypes of width 32."""
    rng = np.random.default_rng(12)
    dims = dict(depths=(1, 1, 1, 1), dims=(8, 16, 16, 32))
    j_enc = JConvNeXt(dtype=jnp.float32, **dims)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda x: j_enc.init(jax.random.PRNGKey(8), x))(
            jnp.zeros((1, 128, 128, 3))))
    variables = {"params": jax.tree_util.tree_map_with_path(
        lambda p, x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if p[-1].key == "gamma" else x, variables["params"])}
    t_enc = ConvNeXt(in_channels=3, dtype=torch.float32, **dims)
    t_enc.load_state_dict(flax_to_state_dict(variables), strict=True)
    protos = rng.normal(size=(40, 32)).astype(np.float32)
    chars = [chr(0x3041 + i) for i in range(40)]    # hiragana rows

    embs = []

    class Recording:
        def apply(self, v, x, train=False):
            e = j_enc.apply(v, x, train=train)
            jax.debug.callback(lambda a: embs.append(np.asarray(a)), e,
                               ordered=True)
            return e

    _, _, jbufs, tbufs, cfg = _run_both_jp(vline_paths, Recording(),
                                           variables, t_enc, protos, chars)
    assert jbufs.keys() == tbufs.keys() and len(embs) == len(jbufs)
    pn = protos / np.linalg.norm(protos, axis=1, keepdims=True)
    n_cmp = 0
    for ci, key in enumerate(jbufs):
        (jb, n), (tb, _) = jbufs[key], tbufs[key]
        jf, tf = _jp_fields(jb, n, cfg), _jp_fields(tb, n, cfg)
        np.testing.assert_array_equal(jf[0], tf[0])
        np.testing.assert_array_equal(jf[2], tf[2])
        emb = embs[ci][:len(jf[1])]
        sims = (emb / np.linalg.norm(emb, axis=1, keepdims=True)) @ pn.T
        top2 = np.sort(sims, axis=1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 1e-4
        assert (np.argmax(sims, axis=1) == jf[1]).all()
        np.testing.assert_array_equal(jf[1][sure], tf[1][sure])
        n_cmp += int(sure.sum())
    assert n_cmp > 20, n_cmp
