"""The rest of single-card inference against the JAX package: the default
square canvas (the general 2-D ROI window), ``crop_source original``,
bucket transfer, wide-line tiling, classifier mode and spell check.

Both engines get the same inputs, weights and localizer: the canvas
oracles of tests/test_torch_pipeline.py (glyph and word boxes read off
the canvas each engine builds, with a jittered duplicate per glyph for
NMS to suppress), or the fixed predictions of the JAX package's own e2e
cases (tests/test_pipeline_e2e.py, tests/test_bucket_transfer.py).  The
encoder is the TinyEncoder of those tests at 224 px with glyph
prototypes from the JAX paired transform.

Tolerances: identical text (and the JAX case's expected text where it
has one); COCO boxes within 1e-4; the paired transform, the device
letterbox and the classifier's float32 logits within 1e-5 / 1e-5 /
1e-4; the median pad exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from effocr_tpu.core.config import (
    EncoderConfig as JEncoderConfig,
    LocalizerConfig as JLocalizerConfig,
    PipelineConfig as JPipelineConfig,
)
from effocr_tpu.kernels import image_ops as j_image_ops
from effocr_tpu.models import create_classifier as j_classifier
from effocr_tpu.models.factory import Classifier as JClassifier
from effocr_tpu.pipelines.infer import EffOCRInference as JEngine
from effocr_tpu.pipelines.tiling import plan_tiles
from effocr_tpu.retrieval.index import PrototypeIndex as JIndex
from effocr_torch.core.config import (
    EncoderConfig,
    LocalizerConfig,
    PipelineConfig,
)
from effocr_torch.interop.flax_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from effocr_torch.kernels import image_ops
from effocr_torch.models.factory import (
    Classifier,
    create_classifier,
    init_params,
)
from effocr_torch.pipelines.infer import EffOCRInference
from effocr_torch.retrieval.index import PrototypeIndex
from test_pipeline_e2e import (
    CHARS,
    StubLocalizer,
    make_decoded_predictions,
    make_line,
    make_vertical_line,
    to_letterbox_space,
)
from test_torch_pipeline import (
    JaxOracle,
    JaxVerticalOracle,
    TinyEncoder,
    TorchTinyEncoder,
    make_vline,
    torch_oracle,
    torch_vertical_oracle,
)

TEXTS = ["AbX oT", "kXo bA", "ToXb", "bA X"]
VTEXTS = ["AbXoT", "kXob", "TokXb"]


class TinyTorch(TorchTinyEncoder):
    """TorchTinyEncoder at 224 px: 28 x 28 pooled gray -> 64."""

    out_features = 64

    def __init__(self):
        super().__init__(28 * 28)


def torch_stub(decoded):
    """The PyTorch twin of test_pipeline_e2e's StubLocalizer."""
    decoded = torch.from_numpy(np.asarray(decoded, np.float32))
    return lambda imgs: (decoded[:imgs.shape[0]], None)


def _protos(enc, variables, crops):
    """Embeddings of crops through the JAX paired transform."""
    x = np.stack([j_image_ops.paired_transform_host(c) for c in crops])
    return np.asarray(enc.apply(variables, jnp.asarray(x)))


@pytest.fixture(scope="module")
def tiny():
    """TinyEncoder variables, its torch twin, and prototypes in the four
    crop geometries (horizontal line/tight, vertical line/tight)."""
    enc = TinyEncoder()
    variables = enc.init(jax.random.PRNGKey(3), jnp.zeros((1, 224, 224, 3)))
    t_enc = TinyTorch()
    t_enc.load_state_dict(flax_to_state_dict(variables), strict=True)
    h_line, h_tight, v_line, v_tight = [], [], [], []
    for ch in CHARS:
        img, boxes, _ = make_line(ch)
        x0, y0, x1, y1 = boxes[0]
        h_line.append(img[:, x0:x1])
        h_tight.append(img[y0:y1, x0:x1])
        v = make_vline(ch)
        ink = v.mean(-1) < 100
        rows, cols = np.flatnonzero(ink.any(1)), np.flatnonzero(ink.any(0))
        v_line.append(v[rows[0]:rows[-1] + 1])
        v_tight.append(v[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1])
    protos = {k: _protos(enc, variables, crops) for k, crops in (
        ("h_line", h_line), ("h_tight", h_tight), ("v_line", v_line),
        ("v_tight", v_tight))}
    return enc, variables, t_enc, protos


def _engines(tiny, jcfg, tcfg, jloc, tloc, protos, chars=CHARS):
    enc, variables, t_enc, _ = tiny
    return (JEngine(jcfg, jloc, {}, enc, variables, JIndex(protos, chars)),
            EffOCRInference(tcfg, tloc, t_enc, PrototypeIndex(protos, chars),
                            device="cpu"))


PAIR = ((JPipelineConfig, JLocalizerConfig, JEncoderConfig),
        (PipelineConfig, LocalizerConfig, EncoderConfig))


def _both(**kw):
    """The same config in both packages: (JAX config, port config)."""
    loc = kw.pop("localizer", {})
    return tuple(p(localizer=lc(**loc), encoder=ec(arch="test"), **kw)
                 for p, lc, ec in PAIR)


def _assert_coco_close(jc, tc):
    assert [im["text"] for im in jc["images"]] == [
        im["text"] for im in tc["images"]]
    assert len(jc["annotations"]) == len(tc["annotations"]) > 0
    for a, b in zip(jc["annotations"], tc["annotations"]):
        assert a["text"] == b["text"] and a["image_id"] == b["image_id"]
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=1e-4)


# ------------------------------------------------------- image ops
def test_median_pad_square_exact():
    rng = np.random.default_rng(21)
    for shape in ((1, 1, 3), (5, 17, 3), (30, 4, 3), (9, 9, 1), (2, 40, 1)):
        img = rng.integers(0, 256, shape, np.uint8)
        img[:, :2] = 7
        for override in ((255, 255, 255), (0, 10, 20), None):
            if override is not None and shape[2] == 1:
                override = override[:1]
            np.testing.assert_array_equal(
                image_ops.median_pad_square(img, override),
                j_image_ops.median_pad_square(img, override))
        assert image_ops._median_border_color(img) == \
            j_image_ops._median_border_color(img)


@pytest.mark.parametrize("size", [224, 128])
def test_paired_transform_matches_jax(size):
    """Crops with sides 1 to 300: upscales and downscales to ``size``."""
    rng = np.random.default_rng(size)
    worst = 0.0
    for h, w in ((1, 1), (1, 300), (300, 1), (7, 12), (224, 100), (128, 3),
                 (299, 301), (60, 45), (250, 256)):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        ref = j_image_ops.paired_transform_host(img, size)
        got = image_ops.paired_transform_host(img, size)
        assert got.shape == ref.shape == (size, size, 3)
        worst = max(worst, float(np.abs(got - ref).max()))
    assert worst <= 1e-5, worst


def test_letterbox_device_matches_jax():
    """Random content rects in a bucket placed at random on a canvas, as
    the JAX engine's compiled program computes them."""
    rng = np.random.default_rng(22)
    fn = jax.jit(j_image_ops.letterbox_device, static_argnums=(3, 4))
    worst = 0.0
    for _ in range(8):
        b, hb, wb, oh, ow = 4, 48, 300, 96, 512
        imgs = rng.uniform(0, 1, (b, hb, wb, 1)).astype(np.float32)
        sh, sw = rng.integers(1, hb + 1, b), rng.integers(1, wb + 1, b)
        src = np.stack([rng.integers(0, hb - sh + 1),
                        rng.integers(0, wb - sw + 1), sh, sw], 1)
        nh, nw = rng.integers(1, oh + 1, b), rng.integers(1, ow + 1, b)
        dst = np.stack([rng.integers(0, oh - nh + 1),
                        rng.integers(0, ow - nw + 1), nh, nw], 1)
        src, dst = src.astype(np.int32), dst.astype(np.int32)
        ref = np.asarray(fn(jnp.asarray(imgs), jnp.asarray(src),
                            jnp.asarray(dst), oh, ow))
        got = image_ops.letterbox_device(
            torch.from_numpy(imgs), torch.from_numpy(src),
            torch.from_numpy(dst), oh, ow).numpy()
        worst = max(worst, float(np.abs(got - ref).max()))
    assert worst <= 1e-5, worst


# ---------------------------------------------- default square engine
def test_default_square_engine_matches_jax(tiny):
    """PipelineConfig() as the JAX package defines it (640 x 640 canvas,
    crop_window 256: the general 2-D ROI window), cut to 4 lines a chunk
    and 64 crop slots."""
    jcfg = dataclasses.replace(JPipelineConfig(), line_batch=4, crop_batch=64)
    tcfg = dataclasses.replace(PipelineConfig(), line_batch=4, crop_batch=64)
    assert tcfg.localizer.input_height is None and tcfg.crop_window == 256
    imgs = [make_line(t)[0] for t in TEXTS + TEXTS[:2]]
    jeng, teng = _engines(tiny, jcfg, tcfg, JaxOracle(), torch_oracle,
                          tiny[3]["h_line"])
    (jres, jcoco), (tres, tcoco) = (jeng.run(imgs, return_coco=True),
                                    teng.run(imgs, return_coco=True))
    assert tres == jres
    assert [jres[i] for i in range(4)] == TEXTS
    _assert_coco_close(jcoco, tcoco)


# ------------------------------------------------- crop_source original
@pytest.mark.parametrize("case", ["en_line", "en_tight", "en_line_spell",
                                  "jp_line", "jp_tight"])
def test_crop_source_original_matches_jax(tiny, case):
    lang, geometry = case.split("_")[:2]
    spell = case.endswith("spell")
    if lang == "en":
        imgs = [make_line(t)[0] for t in TEXTS]
        locs = (JaxOracle(), torch_oracle)
        kw = dict(lang="en", localizer=dict(iou_thresh=0.25))
        protos = tiny[3]["h_" + geometry]
        want = TEXTS
    else:
        imgs = [make_vline(t) for t in VTEXTS]
        locs = (JaxVerticalOracle(), torch_vertical_oracle)
        kw = dict(lang="jp", vertical=True,
                  localizer=dict(input_size=64, input_height=256))
        protos = tiny[3]["v_" + geometry]
        # the toy encoder cannot tell every glyph apart in full-width
        # vertical crops (test_pipeline_e2e.py's tall vertical case)
        want = VTEXTS if geometry == "tight" else None
    jcfg, tcfg = _both(crop_source="original", crop_geometry=geometry,
                       line_batch=2, crop_batch=8, spell_check=spell,
                       transfer_bits=4, adaptive_width=True, **kw)
    jeng, teng = _engines(tiny, jcfg, tcfg, *locs, protos)
    # transfer_bits and adaptive_width do not apply to this path
    assert teng._chunk_canvas_dims(imgs) == jeng._chunk_canvas_dims(imgs)
    (jres, jcoco), (tres, tcoco) = (jeng.run(imgs, return_coco=True),
                                    teng.run(imgs, return_coco=True))
    assert tres == jres
    if want and not spell:
        assert [jres[i] for i in range(len(want))] == want
    _assert_coco_close(jcoco, tcoco)


def test_crop_source_original_refuses_gray(tiny):
    """Both packages refuse 1-channel models on this path: the JAX engine
    inside run (its paired transform pads with a 3-channel white), the
    port when the engine is built."""
    jcfg, tcfg = _both(crop_source="original", input_channels=1,
                       line_batch=2, crop_batch=8,
                       localizer=dict(input_channels=1, iou_thresh=0.25))
    img = make_line("AbX")[0]
    enc, variables, t_enc, protos = tiny
    jeng = JEngine(jcfg, JaxOracle(), {}, enc, variables,
                   JIndex(protos["h_line"], CHARS))
    with pytest.raises(ValueError, match="broadcast"):
        jeng.run([img])
    with pytest.raises(ValueError, match="3-channel"):
        EffOCRInference(tcfg, torch_oracle, t_enc,
                        PrototypeIndex(protos["h_line"], CHARS), device="cpu")


# ------------------------------------------------------ bucket transfer
def _bucket_case(tiny, big):
    """test_bucket_transfer.py's two cases: a line that fits the (96, 512)
    bucket as it is, and one upscaled 3x past it (pre-resized on the
    host with 0 padding)."""
    text = "XoT" if big else "AbX oT"
    img, boxes, words = make_line(text)
    if big:
        img = np.asarray(Image.fromarray(img).resize(
            (img.shape[1] * 3, img.shape[0] * 3)))
        boxes = [[v * 3 for v in b] for b in boxes]
        words = [[v * 3 for v in b] for b in words]
    h, w = img.shape[:2]
    r, _, (top, _, left, _) = j_image_ops.letterbox_params(h, w, (128, 512))

    def to_lb(bs):
        return [[b[0] * r + left, b[1] * r + top, b[2] * r + left,
                 b[3] * r + top] for b in bs]

    return text, img, make_decoded_predictions([to_lb(boxes)],
                                               [to_lb(words)], [None])


@pytest.mark.parametrize("big", [False, True], ids=["in_bucket", "oversize"])
def test_bucket_transfer_matches_jax(tiny, big):
    text, img, pred = _bucket_case(tiny, big)
    jcfg, tcfg = _both(lang="en", line_batch=1, crop_batch=32,
                       crop_window=128, transfer="bucket",
                       bucket_hw=(96, 512), adaptive_width=True,
                       localizer=dict(input_size=512, input_height=128,
                                      conf_thresh=0.35, iou_thresh=0.1,
                                      max_det=64, max_nms=64))
    jeng, teng = _engines(tiny, jcfg, tcfg, StubLocalizer(pred),
                          torch_stub(pred), tiny[3]["h_line"])
    assert teng._chunk_canvas_dims([img]) == jeng._chunk_canvas_dims(
        [img]) == (128, 512)
    jres, tres = jeng.run([img]), teng.run([img])
    assert tres == jres == {0: text}


def test_bucket_transfer_gray_lines_match_jax(tiny):
    """Gray pipeline, several lines a chunk, some past the bucket, with
    the canvas oracle (it reads the device-letterboxed canvas)."""
    jcfg, tcfg = _both(lang="en", input_channels=1, line_batch=3,
                       crop_batch=64, crop_window=128, transfer="bucket",
                       bucket_hw=(64, 320),
                       localizer=dict(input_size=512, input_height=96,
                                      input_channels=1, iou_thresh=0.25))
    imgs = [make_line(t)[0] for t in TEXTS + ["kXoT bAX kXo"]]
    jeng, teng = _engines(tiny, jcfg, tcfg, JaxOracle(), torch_oracle,
                          tiny[3]["h_line"])
    fits = [im.shape[0] <= 64 and im.shape[1] <= 320 for im in imgs]
    assert any(fits) and not all(fits)
    assert teng.run(imgs) == jeng.run(imgs)


# --------------------------------------------------------------- tiling
def test_wide_line_tiling_matches_jax(tiny):
    """test_pipeline_e2e.py's wide-line case: per-tile GT predictions."""
    text = "AbXoTk XoTkAb TkAbXo oTkAbX bAXoTk kToXbA AbXoTk XoTkAb"
    img, boxes, words = make_line(text)
    h, w = img.shape[:2]
    plan = plan_tiles(w, h, 640, 640, 48)
    assert plan and len(plan) >= 2
    tile_chars, tile_words = [], []
    for t in plan:
        tw = t.stop - t.start

        def in_tile(bs):
            return [[max(x0 - t.start, 0), y0, min(x1 - t.start, tw), y1]
                    for x0, y0, x1, y1 in bs
                    if min(x1 - t.start, tw) - max(x0 - t.start, 0) > 2]

        tile_chars.append(to_letterbox_space(in_tile(boxes), h, tw))
        tile_words.append(to_letterbox_space(in_tile(words), h, tw))
    pred = make_decoded_predictions(tile_chars, tile_words, [None] * len(plan))
    jcfg, tcfg = _both(lang="en", line_batch=len(plan),
                       crop_batch=64 * len(plan), tile_min_content_h=48,
                       localizer=dict(conf_thresh=0.35, iou_thresh=0.1,
                                      max_det=64, max_nms=64))
    jeng, teng = _engines(tiny, jcfg, tcfg, StubLocalizer(pred),
                          torch_stub(pred), tiny[3]["h_line"])
    (jres, jcoco), (tres, tcoco) = (jeng.run([img], return_coco=True),
                                    teng.run([img], return_coco=True))
    assert tres == jres == {0: text}
    assert tcoco["images"][0]["width"] == w
    _assert_coco_close(jcoco, tcoco)


def test_tall_vertical_tiling_matches_jax(tiny):
    """test_pipeline_e2e.py's tall vertical case (jp, y-axis tiles)."""
    text = "XoTk" * 11
    img, boxes = make_vertical_line(text)
    h, w = img.shape[:2]
    plan = plan_tiles(h, w, 640, 640, 48)
    assert plan and len(plan) >= 2
    tile_boxes = []
    for t in plan:
        th = t.stop - t.start
        tile_boxes.append(to_letterbox_space(
            [[x0, max(y0 - t.start, 0), x1, min(y1 - t.start, th)]
             for x0, y0, x1, y1 in boxes
             if min(y1 - t.start, th) - max(y0 - t.start, 0) > 2], th, w))
    pred = make_decoded_predictions(tile_boxes, [[]] * len(plan),
                                    [None] * len(plan), nc=1)
    protos = []
    for c in CHARS:
        vimg, vboxes = make_vertical_line(c)
        protos.append(vimg[vboxes[0][1]:vboxes[0][3], :])
    protos = _protos(tiny[0], tiny[1], protos)
    jcfg, tcfg = _both(lang="jp", vertical=True, line_batch=len(plan),
                       crop_batch=64 * len(plan), tile_min_content_h=48,
                       localizer=dict(num_classes=1, conf_thresh=0.35,
                                      iou_thresh=0.1, max_det=64, max_nms=64))
    jeng, teng = _engines(tiny, jcfg, tcfg, StubLocalizer(pred),
                          torch_stub(pred), protos)
    assert teng.run([img]) == jeng.run([img]) == {0: text}


def test_tiling_sorted_spilled_and_spell_checked_matches_jax(tiny):
    """Tiles are ordinary lines of a chunk: with chunk_sort width they
    sort among the other lines, a small crop_batch spills some into
    re-dispatched chunks, the merge runs without COCO output, and the
    merged text goes through the spell check."""
    wide = make_line("AbXoTk XoTkAb TkAbXo oTkAbX bAXoTk")[0]
    imgs = [wide] + [make_line(t)[0] for t in TEXTS]
    jcfg, tcfg = _both(lang="en", line_batch=4, crop_batch=24,
                       chunk_sort="width", tile_min_content_h=40,
                       spell_check=True,
                       localizer=dict(input_size=512, input_height=96,
                                      iou_thresh=0.25))
    jeng, teng = _engines(tiny, jcfg, tcfg, JaxOracle(), torch_oracle,
                          tiny[3]["h_line"])
    calls = []
    orig = teng._dispatch_chunk
    teng._dispatch_chunk = lambda *a: calls.append(len(a[0])) or orig(*a)
    tres, jres = teng.run(imgs), jeng.run(imgs)
    assert tres == jres and set(tres) == set(range(len(imgs)))
    n_tiles = len(plan_tiles(wide.shape[1], wide.shape[0], 512, 96, 40))
    assert n_tiles >= 2
    assert len(calls) > -(-(n_tiles + len(imgs) - 1) // 4), calls


# ------------------------------------------------------ classifier mode
def test_classifier_logits_match_jax():
    """mobilenetv3_small_050 + a 90-class head in float32: the port's
    state_dict converts to the nested Flax tree {encoder, head} of the
    JAX Classifier (same names, shapes and dtypes), converts back byte
    for byte, and the logits agree within 1e-4."""
    rng = np.random.default_rng(23)
    t_cls = init_params(create_classifier(
        "mobilenetv3_small_050", 90, in_channels=1, dtype=torch.float32), 6)
    sd = t_cls.state_dict()
    for k, v in sd.items():    # BatchNorm statistics and biases off zero
        if k.endswith("running_var"):
            v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)))
        elif k.endswith(("running_mean", "bias")):
            v.copy_(torch.from_numpy(rng.normal(0, 0.1, v.shape)))
    variables = state_dict_to_flax(sd)
    j_cls = j_classifier("mobilenetv3_small_050", 90, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda x: j_cls.init(jax.random.PRNGKey(6), x),
                            jax.ShapeDtypeStruct((1, 64, 64, 1), jnp.float32))

    def spec(tree):
        return jax.tree.map(lambda a: (a.shape, str(a.dtype)), tree)

    assert set(variables["params"]) == {"encoder", "head"}
    assert spec(variables) == spec(shapes)
    for k, v in flax_to_state_dict(variables).items():
        assert v.numpy().tobytes() == sd[k].numpy().tobytes(), k
    x = rng.uniform(-2, 2, (4, 64, 64, 1)).astype(np.float32)
    ref = np.asarray(jax.jit(j_cls.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = t_cls(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (4, 90)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_classifier_engine_matches_jax(tiny):
    """TinyEncoder + a 12-class head whose columns are glyph prototypes,
    with a sparse class_map: one class column the map leaves out and one
    past its largest key (both decode to "")."""
    enc, variables, _, protos = tiny
    p = protos["h_line"]
    cols = {1: 0, 3: 1, 4: 2, 6: 3, 8: 4}          # class -> glyph row
    kernel = np.zeros((64, 12), np.float32)
    for k, g in cols.items():
        kernel[:, k] = p[g] / np.linalg.norm(p[g])
    kernel[:, 7] = 1.001 * p[5] / np.linalg.norm(p[5])   # "k", unmapped
    kernel[:, 11] = 1.001 * p[2] / np.linalg.norm(p[2])  # "X", past the map
    class_map = {k: CHARS[g] for k, g in cols.items()}
    j_vars = {"params": {"encoder": variables["params"],
                         "head": {"kernel": kernel,
                                  "bias": np.zeros(12, np.float32)}}}
    t_cls = Classifier(TinyTorch(), 12)
    t_cls.load_state_dict(flax_to_state_dict(j_vars), strict=True)
    jcfg, tcfg = _both(lang="en", line_batch=4, crop_batch=64,
                       localizer=dict(input_size=512, input_height=96,
                                      iou_thresh=0.25))
    imgs = [make_line(t)[0] for t in TEXTS]
    jeng = JEngine(jcfg, JaxOracle(), {}, JClassifier(enc, 12), j_vars,
                   class_map=class_map)
    teng = EffOCRInference(tcfg, torch_oracle, t_cls, device="cpu",
                           class_map=class_map)
    jres, tres = jeng.run(imgs), teng.run(imgs)
    assert tres == jres
    # "k" and "X" read as classes the map does not name
    assert all("k" not in v and "X" not in v for v in tres.values())
    assert all(v for v in tres.values())
