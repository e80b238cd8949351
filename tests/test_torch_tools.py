"""effocr_torch's tools against the JAX package's, on the CPU:

- ``eval/error_analysis.py``: every case of tests/test_error_analysis.py
  but the font ones, and seeded random pairs (clean / uncased on and
  off): alignments and summaries equal; the ``error-analysis`` CLI's
  stdout and --save_json equal to the JAX CLI's; ``--font_dir`` raises;
- ``utils/comparators.py``: every case of tests/test_comparators.py on
  the same fake transports: the same requests (URL, body, headers) and
  results; Tesseract through a stand-in ``tesseract`` on PATH (the
  command line, the PNG it reads);
- ``data/png.py`` writer against Pillow's decode (gray, RGB, RGBA,
  1 x N, N x 1), ``read_png_l`` against ``convert("L")`` on every PNG
  subformat, ``pil_bicubic_resize`` bit for bit against
  ``Image.resize(BICUBIC)``;
- ``utils/viz.py``: ``draw_boxes`` pixel for pixel against the JAX one
  (``ImageDraw.rectangle``) with .5 corners, boxes off the image and
  zero-area boxes, and its refusals; ``save_knn_grid`` pixel for pixel;
- the ``viz`` CLI against the JAX CLI on one float32 recognizer dir:
  the same file names, the same pixels;
- ``infer --output_localizer_results --compare_ocr``: the port's run on
  the CPU, and the JAX CLI's overlay and comparator code on the port's
  results (its engine stubbed): the same overlays, the same comparator
  lines, the same page pixels sent (Pillow's L conversion);
- ``utils/profiling.py device_trace`` on a CPU op.
All exact: no tolerance.
"""

import base64
import io
import json
import os
import stat
import shutil
import sys
import urllib.parse
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from effocr_tpu.cli import error_analysis as j_ea_cli
from effocr_tpu.cli import infer as j_infer_cli
from effocr_tpu.cli import viz as j_viz_cli
from effocr_tpu.eval import error_analysis as j_ea
from effocr_tpu.models import create_encoder as j_encoder
from effocr_tpu.utils import comparators as j_cmp
from effocr_tpu.utils import viz as j_viz
from effocr_torch.cli import error_analysis as t_ea_cli
from effocr_torch.cli import infer as t_infer_cli
from effocr_torch.cli import viz as t_viz_cli
from effocr_torch.data import png
from effocr_torch.data.folder import pil_bicubic_resize
from effocr_torch.eval import error_analysis as t_ea
from effocr_torch.interop.flax_bridge import state_dict_to_flax
from effocr_torch.models.factory import create_encoder, init_params
from effocr_torch.retrieval.index import PrototypeIndex
from effocr_torch.train import checkpoint as ckpt
from effocr_torch.utils import comparators as t_cmp
from effocr_torch.utils import viz as t_viz
from effocr_torch.utils.profiling import device_trace
from test_torch_data import _SUBFORMATS, _subformat_png
from test_torch_train import _FlaxInitProxy, _loc_dir

F32 = torch.float32


# ------------------------------------------------------- error analysis
CASES = [
    [("Hello world", "hello world"), ("a b", "ab"), ("ab", "a b"),
     ("abc", "axc"), ("abc", "abxc"), ("abc", "ac"), ("same", "same")],
    [("The quick brown fox", "The quick brawn fax"),
     ("jumps over", "jumps ovr"), ("the lazy dog", "the lazy dog"),
     ("“quoted” text", '"quoted" text')],
    [("abcd e", "aXcde")],
    [("", ""), ("", "ab"), ("ab", ""), ("  a ", "A")],
]


def _random_pairs(seed):
    rng = np.random.default_rng(seed)
    alpha = list("abc XAB“”")
    return [("".join(rng.choice(alpha, rng.integers(0, 12))),
             "".join(rng.choice(alpha, rng.integers(0, 12))))
            for _ in range(60)]


@pytest.mark.parametrize("case", range(len(CASES) + 3))
@pytest.mark.parametrize("clean,uncased", [(True, False), (False, False),
                                           (True, True)])
def test_error_analysis_matches_jax(case, clean, uncased):
    pairs = CASES[case] if case < len(CASES) else _random_pairs(case)
    for gt, pred in pairs:
        assert t_ea.align_ops(gt, pred) == j_ea.align_ops(gt, pred)
    tb = t_ea.analyze_pairs(pairs, clean=clean, uncased=uncased)
    jb = j_ea.analyze_pairs(pairs, clean=clean, uncased=uncased)
    assert vars(tb) == vars(jb)
    assert tb.cer == jb.cer
    assert tb.summary(top=3) == jb.summary(top=3)
    assert json.dumps(tb.summary()) == json.dumps(jb.summary())


def test_error_analysis_cli_matches_jax(tmp_path, monkeypatch, capsys):
    pairs = CASES[0] + _random_pairs(7)
    coco = {"images": [{"id": i, "file_name": f"l{i}.png", "text": gt}
                       for i, (gt, _) in enumerate(pairs)]
            + [{"id": 999, "file_name": "no_text.png"}]}
    results = {f"/some/dir/l{i}.png": (pred or None)
               for i, (_, pred) in enumerate(pairs)}
    (tmp_path / "coco.json").write_text(json.dumps(coco))
    (tmp_path / "res.json").write_text(json.dumps(results))
    outs = {}
    for pkg, run in (("jax", j_ea_cli.main), ("port", t_ea_cli.main)):
        argv = ["--results", str(tmp_path / "res.json"), "--coco_json",
                str(tmp_path / "coco.json"), "--top", "4", "--save_json",
                str(tmp_path / f"{pkg}.json")]
        if pkg == "jax":
            monkeypatch.setattr(sys, "argv", ["error-analysis"] + argv)
            run()
        else:
            run(argv)
        out = capsys.readouterr().out
        outs[pkg] = (out.replace(f"{pkg}.json", ""),
                     (tmp_path / f"{pkg}.json").read_bytes())
    assert outs["port"] == outs["jax"]
    # --font_dir: each confusion's render distance across the committed
    # DejaVu fonts
    fonts = tmp_path / "fonts"
    fonts.mkdir()
    for name in ("DejaVuSans.ttf", "DejaVuSerif.ttf"):
        shutil.copy(os.path.join(os.path.dirname(__file__), "torch_fixtures",
                                 "fonts", name), fonts)
    pairs = pairs + [("Аб", "Ab"), ("lI", "Il"), ("Ж", "X")]
    coco["images"] = [{"id": i, "file_name": f"l{i}.png", "text": gt}
                      for i, (gt, _) in enumerate(pairs)]
    (tmp_path / "coco.json").write_text(json.dumps(coco))
    (tmp_path / "res.json").write_text(json.dumps(
        {f"l{i}.png": pred for i, (_, pred) in enumerate(pairs)}))
    for pkg, run in (("jax", j_ea_cli.main), ("port", t_ea_cli.main)):
        argv = ["--results", str(tmp_path / "res.json"), "--coco_json",
                str(tmp_path / "coco.json"), "--top", "30", "--font_dir",
                str(fonts), "--save_json", str(tmp_path / f"{pkg}.json")]
        if pkg == "jax":
            monkeypatch.setattr(sys, "argv", ["error-analysis"] + argv)
            run()
        else:
            run(argv)
        out = capsys.readouterr().out
        outs[pkg] = (out.replace(f"{pkg}.json", ""),
                     (tmp_path / f"{pkg}.json").read_bytes())
    assert outs["port"] == outs["jax"]
    assert "render-identical in every corpus font" in outs["port"][0]
    assert "render dist" in outs["port"][0]


# ---------------------------------------------------------- comparators
def _recording(reply):
    calls = []

    def transport(url, body, headers):
        calls.append((url, body, dict(headers)))
        return reply(url) if callable(reply) else reply

    return transport, calls


@pytest.mark.parametrize("case", ["gcv", "gcv_error", "baidu", "baidu_error",
                                  "token", "no_token"])
def test_comparator_protocols_match_jax(case):
    replies = {
        "gcv": {"responses": [{"fullTextAnnotation": {"text": "雪の朝\n"}}]},
        "gcv_error": {"responses": [{"error": {"code": 403}}]},
        "baidu": {"words_result": [{"words": "雪の"}, {"words": "朝"}]},
        "baidu_error": {"error_code": 17, "error_msg": "quota"},
        "token": {"access_token": "24.abcdef", "expires_in": 2592000},
        "no_token": {"error": "invalid_client"},
    }
    results = []
    for mod in (j_cmp, t_cmp):
        transport, calls = _recording(replies[case])
        call = {
            "gcv": lambda: mod.run_gcv(b"PNGDATA", "KEY 1/2", lang="ja",
                                       transport=transport),
            "baidu": lambda: mod.run_baidu(b"IMG", "T&K", lang="JAP",
                                           transport=transport),
            "token": lambda: mod.baidu_access_token("AK", "S K",
                                                    transport=transport),
        }[case.split("_")[0] if case != "no_token" else "token"]
        try:
            results.append((call(), calls))
        except RuntimeError as e:
            results.append((type(e).__name__ + str(e), calls))
    assert results[0] == results[1]


def test_compare_ocr_and_png_bytes_match_jax(monkeypatch):
    rng = np.random.default_rng(0)
    imgs = [np.full((32, 96), 255, np.uint8),
            rng.integers(0, 256, (20, 7, 3), np.uint8)]

    def reply(url):
        if "vision.googleapis" in url:
            return {"responses": [{"fullTextAnnotation": {"text": "hello\n"}}]}
        return {"words_result": [{"words": "hel"}, {"words": "lo"}]}

    outs = []
    for mod in (j_cmp, t_cmp):
        monkeypatch.setattr(mod, "tesseract_available", lambda: False)
        transport, calls = _recording(reply)
        out = mod.compare_ocr(imgs, ["hello", "help"], lang="eng",
                              gcv_api_key="K", baidu_access_token="T",
                              transport=transport)
        sent = []
        for url, body, _ in calls:
            if "vision" in url:
                content = json.loads(body)["requests"][0]["image"]["content"]
            else:
                content = urllib.parse.parse_qs(body.decode())["image"][0]
            sent.append(np.asarray(Image.open(io.BytesIO(
                base64.b64decode(content)))))
        outs.append((out, [u for u, _, _ in calls], sent))
    assert outs[0][:2] == outs[1][:2]
    for a, b in zip(outs[0][2], outs[1][2]):
        np.testing.assert_array_equal(a, b)
    img = (np.arange(32 * 32, dtype=np.uint8).reshape(32, 32) % 251)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(
        t_cmp.png_bytes(img)))), img)


def test_tesseract_runs_the_binary(tmp_path, monkeypatch):
    """A stand-in ``tesseract`` on PATH: the command pytesseract builds
    (``<png> stdout -l <lang> --psm 7``), on a PNG of the line."""
    log = tmp_path / "args.json"
    exe = tmp_path / "bin" / "tesseract"
    exe.parent.mkdir()
    exe.write_text(f"""#!{sys.executable}
import json, shutil, sys
if sys.argv[1:] == ["--version"]:
    print("tesseract 5.0.0"); sys.exit(0)
shutil.copy(sys.argv[1], {str(tmp_path / 'seen.png')!r})
json.dump(sys.argv[1:], open({str(log)!r}, "w"))
print("  a line  ")
""")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{exe.parent}{os.pathsep}"
                       f"{os.environ['PATH']}")
    assert t_cmp.tesseract_available()
    img = np.random.default_rng(0).integers(0, 256, (24, 80), np.uint8)
    assert t_cmp.run_tesseract(img, lang="jpn") == "a line"
    args = json.loads(log.read_text())
    assert args[1:] == ["stdout", "-l", "jpn", "--psm", "7"]
    assert args[0].endswith(".png")
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "seen.png")), img)
    out = t_cmp.compare_ocr([img], ["a line"], lang="eng")
    assert out == {"tesseract": (100.0, 0.0)}
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert not t_cmp.tesseract_available()


# ------------------------------------------------------- PNG and pixels
@pytest.mark.parametrize("shape", [(7, 5), (1, 9), (9, 1), (6, 4, 1),
                                   (5, 8, 3), (1, 1, 3), (3, 7, 4),
                                   (300, 2, 4)])
def test_png_writer_decodes_in_pillow(tmp_path, shape):
    img = np.random.default_rng(len(shape)).integers(0, 256, shape,
                                                     np.uint8)
    p = png.write(str(tmp_path / "sub" / "x.png"), img)
    got = np.asarray(Image.open(p))
    want = img[..., 0] if img.ndim == 3 and img.shape[2] == 1 else img
    np.testing.assert_array_equal(got, want)
    assert Image.open(p).mode == {1: "L", 3: "RGB", 4: "RGBA"}[
        1 if img.ndim == 2 else img.shape[2]]
    if img.ndim == 2 or img.shape[2] != 4:
        np.testing.assert_array_equal(png.read_png(p, 3), np.asarray(
            Image.open(p).convert("RGB")))
    with pytest.raises(ValueError):
        png.encode(img.astype(np.float32))


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("ct,depth,interlace", _SUBFORMATS)
def test_read_png_l_matches_pillow(tmp_path, ct, depth, interlace):
    p = _subformat_png(tmp_path, ct, depth, interlace,
                       seed=ct * 100 + depth * 2 + interlace)
    ref = np.asarray(Image.open(p).convert("L"))
    got = png.read_png_l(p)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("channels", [1, 3])
def test_pil_bicubic_resize_matches_pillow(channels):
    rng = np.random.default_rng(channels)
    sizes = [(1, 1), (1, 7), (7, 1), (5, 9), (31, 64), (20, 50), (97, 13),
             (64, 512), (200, 301)]
    outs = [(1, 1), (3, 5), (32, 64), (64, 37), (128, 7), (64, 512),
            (17, 300)]
    for h, w in sizes:
        for oh, ow in outs + [(h, 3), (64, max(1, round(w * 64 / h)))]:
            img = rng.integers(0, 256, (h, w, channels), np.uint8)
            im = Image.fromarray(img[..., 0] if channels == 1 else img)
            ref = np.asarray(im.resize((ow, oh), Image.BICUBIC))
            got = pil_bicubic_resize(img, ow, oh)
            np.testing.assert_array_equal(
                got[..., 0] if channels == 1 else got, ref,
                err_msg=f"{h}x{w} -> {oh}x{ow}")


def _boxes(rng, n):
    out = []
    for _ in range(n):
        c = rng.integers(-10, 30, 4) / 2.0
        c[2], c[3] = max(c[2], c[0]), max(c[3], c[1])
        if rng.random() < 0.2:
            c[2] = c[0]                  # zero width
        if rng.random() < 0.2:
            c[3] = c[1]                  # zero height
        out.append([float(v) for v in c])
    return out


@pytest.mark.parametrize("channels", [0, 3, 4])
def test_draw_boxes_matches_pillow(tmp_path, channels):
    """Corners on .5, boxes partly and wholly off the image, zero width and
    height, on gray (ink 76), RGB and RGBA images."""
    rng = np.random.default_rng(channels)
    for t in range(300):
        h, w = rng.integers(1, 20, 2)
        shape = (h, w) if channels == 0 else (h, w, channels)
        base = rng.integers(0, 256, shape).astype(np.uint8)
        boxes = _boxes(rng, int(rng.integers(1, 4)))
        np.testing.assert_array_equal(t_viz.draw_boxes(base, boxes),
                                      j_viz.draw_boxes(base, boxes),
                                      err_msg=str(boxes))
    ref = j_viz.draw_boxes(base, boxes, str(tmp_path / "j" / "o.png"))
    t_viz.draw_boxes(base, boxes, str(tmp_path / "t" / "o.png"))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "t" / "o.png")), ref)
    for bad in ([5, 5, 4, 6], [5.5, 5, 5.2, 6], [5, 5, 6, 4]):
        with pytest.raises(ValueError) as te:
            t_viz.draw_boxes(base, [bad])
        with pytest.raises(ValueError) as je:
            j_viz.draw_boxes(base, [bad])
        assert str(te.value) == str(je.value)


def test_save_knn_grid_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (37, 23, 3), np.uint8)
    nbrs = [np.repeat(rng.integers(0, 256, (64, 64, 1), np.uint8), 3, 2)
            for _ in range(3)]
    for correct in (True, False, None):
        a = j_viz.save_knn_grid(q, nbrs, str(tmp_path / "j" / "q.png"),
                                correct=correct)
        b = t_viz.save_knn_grid(q, nbrs, str(tmp_path / "t" / "q.png"),
                                correct=correct)
        assert os.path.basename(a) == os.path.basename(b)
        np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                      np.asarray(Image.open(b)))
    a = j_viz.save_knn_grid(q[..., 0], [], str(tmp_path / "j" / "g.png"))
    b = t_viz.save_knn_grid(q[..., 0], [], str(tmp_path / "t" / "g.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                  np.asarray(Image.open(b)))


# ------------------------------------------------------------ viz CLI
def test_viz_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """One float32 recognizer dir (mobilenetv3_small_050, 32 px, 1
    channel, 6 prototypes with thumbnails) and 8 query crops, 5 of them
    picked by the shuffle: the same file names (match flag, neighbour
    code points) and pixels."""
    rng = np.random.default_rng(0)
    rec = tmp_path / "rec"
    rec.mkdir()
    enc = init_params(create_encoder("mobilenetv3_small_050", in_channels=1,
                                     dtype=F32), 4)
    ckpt.save_variables(state_dict_to_flax(enc.state_dict()),
                        str(rec / "enc_best.msgpack"))
    (rec / "model.json").write_text(json.dumps({
        "arch": "mobilenetv3_small_050", "image_size": 32,
        "input_channels": 1}))
    queries = tmp_path / "q"
    queries.mkdir()
    imgs = [rng.integers(0, 256, (int(rng.integers(12, 40)),
                                  int(rng.integers(8, 30)), 3), np.uint8)
            for _ in range(8)]
    x = np.stack([t_viz_cli.paired_transform_host(im, 32).mean(
        -1, keepdims=True) for im in imgs])
    with torch.no_grad():
        emb = enc.eval()(torch.from_numpy(x)).numpy()
    # prototypes: 3 of the queries' own embeddings, 3 random rows
    protos = np.concatenate([emb[:3], rng.normal(size=(3, emb.shape[1]))])
    chars = ["a", "b", "c", "d", "e", "f"]
    PrototypeIndex(protos.astype(np.float32), chars, thumbnails=rng.integers(
        0, 256, (6, 64, 64), np.uint8)).save(str(rec))
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(queries / f"l{i}_{i}_{hex(97 + i % 4)}.png")
    # the JAX encoder in float32, without its eager init
    monkeypatch.setattr(j_viz_cli, "create_encoder", lambda a: _FlaxInitProxy(
        j_encoder(a, dtype=jnp.float32),
        lambda c: create_encoder(a, in_channels=c)))
    monkeypatch.setattr(t_viz_cli, "create_encoder", partial(create_encoder,
                                                             dtype=F32))
    flags = ["--recognizer_dir", str(rec), "--query_dir", str(queries),
             "--k", "3", "--num", "5"]
    monkeypatch.setattr(sys, "argv", ["viz", *flags, "--out_dir",
                                      str(tmp_path / "jax")])
    j_viz_cli.main()
    j_out = capsys.readouterr().out
    t_viz_cli.main([*flags, "--out_dir", str(tmp_path / "port"), "--device",
                    "cpu"])
    assert capsys.readouterr().out == j_out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 5
    assert any("_True_" in n for n in names) and any(
        "_False_" in n for n in names)
    for n in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / n)),
            np.asarray(Image.open(tmp_path / "jax" / n)))


# ------------------------------------------- infer overlays, comparators
class _StubEngine:
    """The JAX CLI's engine, answering with the port's results."""

    def __init__(self, results, coco):
        self.results, self.coco = results, coco

    def run(self, images, return_coco=False):
        return self.results, self.coco


def test_infer_overlays_and_comparators_match_jax(tmp_path, monkeypatch,
                                                  capsys):
    """``infer --output_localizer_results D --compare_ocr --gcv_api_key K
    --baidu_api_key A --baidu_secret_key S`` on the CPU (random yolov5n
    and float32 mobilenet dirs, conf 0.001), then the JAX CLI's own code
    for both flags on the port's results: the same overlay files, pixel
    for pixel, and the same comparator lines; the cloud requests carry
    the same pages (Pillow's L conversion, three PNG kinds)."""
    loc = _loc_dir(str(tmp_path))
    rec = tmp_path / "rec"
    rec.mkdir()
    enc = init_params(create_encoder("mobilenetv3_small_050", in_channels=1,
                                     dtype=F32), 2)
    ckpt.save_variables(state_dict_to_flax(enc.state_dict()),
                        str(rec / "enc_best.msgpack"))
    (rec / "model.json").write_text(json.dumps({
        "arch": "mobilenetv3_small_050", "image_size": 32,
        "input_channels": 1, "crop_geometry": "tight"}))
    rng = np.random.default_rng(1)
    PrototypeIndex(rng.normal(size=(3, enc.out_features)).astype(np.float32),
                   ["a", "b", "c"]).save(str(rec))
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    images = []
    for i, mode in enumerate(("L", "RGB", "P")):
        im = Image.fromarray(rng.integers(0, 256, (40, 150, 3), np.uint8))
        im = im.convert("L") if mode == "L" else (
            im.quantize(32) if mode == "P" else im)
        im.save(img_dir / f"line{i}.png")
        images.append({"id": i, "file_name": f"line{i}.png", "text": "abc"})
    coco = tmp_path / "coco.json"
    coco.write_text(json.dumps({"images": images, "annotations": []}))

    def reply(url):
        if "oauth" in url:
            return {"access_token": "tok"}
        if "vision" in url:
            return {"responses": [{"fullTextAnnotation": {"text": "abc\n"}}]}
        return {"words_result": [{"words": "ab"}]}

    sent = {}
    for name, mod in (("jax", j_cmp), ("port", t_cmp)):
        transport, sent[name] = _recording(reply)
        monkeypatch.setattr(mod, "_urllib_transport", transport)
        monkeypatch.setattr(mod, "tesseract_available", lambda: False)
    monkeypatch.setattr(t_infer_cli, "create_encoder",
                        lambda a, in_channels, **kw: create_encoder(
                            a, in_channels=in_channels, dtype=F32, **kw))
    flags = ["--recognizer_dir", str(rec), "--localizer_dir", loc, "--lang",
             "en", "--image_dir", str(img_dir), "--coco_json", str(coco),
             "--line_batch", "2", "--crop_batch", "64",
             "--localizer_conf_thresh", "0.001", "--max_det", "16",
             "--compare_ocr", "--gcv_api_key", "K", "--baidu_api_key", "A",
             "--baidu_secret_key", "S"]
    t_infer_cli.main([*flags, "--device", "cpu", "--save_output",
                      str(tmp_path / "out"), "--output_localizer_results",
                      str(tmp_path / "port")])
    t_lines = capsys.readouterr().out.splitlines()
    with open(tmp_path / "out" / "inference_results.json") as f:
        results = {str(img_dir / k): v for k, v in json.load(f).items()}
    with open(tmp_path / "out" / "inference_coco.json") as f:
        inference_coco = json.load(f)
    boxes = [a["bbox"] for a in inference_coco["annotations"]]
    assert len(boxes) >= 6 and any(b[0] % 1 for b in boxes)
    monkeypatch.setattr(j_infer_cli, "load_engine", lambda args: _StubEngine(
        results, inference_coco))
    monkeypatch.setattr(sys, "argv", ["infer", *flags,
                                      "--output_localizer_results",
                                      str(tmp_path / "jax")])
    j_infer_cli.main()
    j_lines = capsys.readouterr().out.splitlines()
    pick = ("gcv |", "baidu |")
    assert [ln for ln in t_lines if ln.startswith(pick)] == [
        ln for ln in j_lines if ln.startswith(pick)] and len(
        [ln for ln in t_lines if ln.startswith(pick)]) == 2
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 3
    for n in names:
        got = np.asarray(Image.open(tmp_path / "port" / n))
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(tmp_path / "jax" / n)))
        assert got.shape[2] == 3
    assert [u for u, _, _ in sent["port"]] == [u for u, _, _ in sent["jax"]]
    for (_, a, _), (_, b, _) in zip(sent["port"], sent["jax"]):
        if a.startswith(b"{"):
            a, b = (json.loads(x)["requests"][0]["image"]["content"]
                    for x in (a, b))
        else:
            a, b = (urllib.parse.parse_qs(x.decode()).get("image", [""])[0]
                    for x in (a, b))
        if a:
            np.testing.assert_array_equal(
                np.asarray(Image.open(io.BytesIO(base64.b64decode(a)))),
                np.asarray(Image.open(io.BytesIO(base64.b64decode(b)))))


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    with open(prof.trace_path) as f:
        trace = json.load(f)
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "trace")
    assert any("aten::mm" in ev.get("name", "")
               for ev in trace["traceEvents"])
