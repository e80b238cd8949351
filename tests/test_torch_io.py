"""effocr_torch I/O and copied modules against the JAX package.

- interop/flax_msgpack.py reads what ``flax.serialization.to_bytes``
  writes and writes the same bytes back;
- cli/infer.py ``load_engine`` on artifact directories the JAX side wrote
  (random-init yolov5s and mobilenetv3_small_050 with BENCH_TRAINED.json's
  flags; yolov5n and convnext_atto with the jp_v3 benchmark's flags and
  the 11,051-row rec_knn6k3 ref.txt) loads parameters equal to the Flax
  ones, and the jp engine's retrieval goes through ``top1_plain`` on the
  CPU;
- the modes that once raised build and run on the CPU: wide-line tiling,
  spell check, ``crop_source original`` (jp artifacts), classifier mode
  from a JAX-written classifier directory; ``--data_parallel`` with one
  visible device (the CPU) prints the JAX command's message and runs
  unsharded;
- golden checks pin each copied module (config, batching, lang, tiling,
  textline, coco_map, image_ops, spell_check, native
  decode/letterbox/pack bytes) to the original's outputs.
Tolerance: none (exact equality) throughout.
"""

import argparse
import dataclasses
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from effocr_tpu import native as j_native
from effocr_tpu.core import batching as j_batching
from effocr_tpu.core import config as j_config
from effocr_tpu.eval import coco_map as j_coco_map
from effocr_tpu.eval import textline as j_textline
from effocr_tpu.kernels import image_ops as j_image_ops
from effocr_tpu.models import create_encoder as j_encoder
from effocr_tpu.models import create_localizer as j_localizer
from effocr_tpu.pipelines import lang as j_lang
from effocr_tpu.pipelines import tiling as j_tiling
from effocr_tpu.retrieval.index import PrototypeIndex as JIndex
from effocr_tpu.train import checkpoint as j_ckpt
from effocr_torch import native
from effocr_torch.cli.infer import add_engine_args, load_engine
from effocr_torch.core import batching, config
from effocr_torch.eval import coco_map, textline
from effocr_torch.interop import flax_msgpack
from effocr_torch.interop.flax_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from effocr_torch.kernels import cuda_top1, image_ops
from effocr_torch.pipelines import lang, tiling
from effocr_torch.utils.profiling import StageTimer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5 = os.path.join(ROOT, "bench_results", "r5", "runs")


def test_flax_msgpack_round_trip():
    rng = np.random.default_rng(0)
    enc = j_encoder("mobilenetv3_small_050")
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda x: enc.init(jax.random.PRNGKey(0), x))(
            jnp.zeros((1, 32, 32, 1))))
    tree = {
        **variables,
        "extra": {"i8": rng.integers(-9, 9, (3, 5)).astype(np.int8),
                  "u16": np.arange(70000 % 300, dtype=np.uint16),
                  "f64": rng.normal(size=(2, 2)), "b": np.array([True]),
                  "scalar": np.float32(2.5), "count": 70000, "neg": -40,
                  "name": "x" * 40, "f": 0.25, "none": None},
    }
    blob = serialization.to_bytes(tree)
    back = flax_msgpack.unpackb(blob)
    assert flax_msgpack.packb(back) == blob
    restored = serialization.msgpack_restore(flax_msgpack.packb(back))
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(tree),
            jax.tree_util.tree_leaves_with_path(restored)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    # the bridge inverts exactly
    sd = flax_to_state_dict(variables)
    again = state_dict_to_flax(sd)
    for a, b in zip(jax.tree.leaves(variables), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def artifact_dirs(tmp_path_factory):
    """JAX-written localizer and recognizer directories (random init)."""
    root = tmp_path_factory.mktemp("artifacts")
    loc_dir, rec_dir = root / "loc", root / "rec"
    loc_dir.mkdir()
    rec_dir.mkdir()
    with open(os.path.join(R5, "loc2k", "model.json")) as f:
        loc_meta = json.load(f)
    loc = j_localizer("yolov5s", num_classes=2, anchors=tuple(
        tuple(a) for a in loc_meta["anchors"]))
    loc_vars = jax.jit(lambda x: loc.init(jax.random.PRNGKey(1), x))(
        jnp.zeros((1, 64, 256, 1)))
    j_ckpt.save_variables(loc_vars, str(loc_dir / "best_bbox_mAP.msgpack"))
    shutil.copy(os.path.join(R5, "loc2k", "model.json"), loc_dir)
    enc = j_encoder("mobilenetv3_small_050")
    enc_vars = jax.jit(lambda x: enc.init(jax.random.PRNGKey(2), x))(
        jnp.zeros((1, 128, 128, 1)))
    j_ckpt.save_variables(enc_vars, str(rec_dir / "enc_best.msgpack"))
    shutil.copy(os.path.join(R5, "rec2k_mn_hn", "model.json"), rec_dir)
    with open(os.path.join(R5, "rec2k_mn_hn", "ref.txt")) as f:
        chars = f.read().rstrip("\n").split("\n")
    protos = np.random.default_rng(3).normal(size=(len(chars), 1024))
    JIndex(protos.astype(np.float32), chars).save(str(rec_dir))
    return (str(loc_dir), str(rec_dir), jax.tree.map(np.asarray, loc_vars),
            jax.tree.map(np.asarray, enc_vars))


def _bench_flags(loc_dir, rec_dir):
    """BENCH_TRAINED.json's flag list with the artifact paths swapped."""
    with open(os.path.join(ROOT, "BENCH_TRAINED.json")) as f:
        flags = json.load(f)["flags"]
    return [loc_dir if f.endswith("loc2k") else rec_dir
            if f.endswith("rec2k_mn_hn") else f for f in flags]


def _args(loc_dir, rec_dir, *extra):
    p = argparse.ArgumentParser()
    add_engine_args(p)
    return p.parse_args(_bench_flags(loc_dir, rec_dir)
                        + ["--device", "cpu", *extra])


def test_load_engine_reads_jax_artifacts(artifact_dirs):
    loc_dir, rec_dir, loc_vars, enc_vars = artifact_dirs
    engine = load_engine(_args(loc_dir, rec_dir))
    for model, variables in ((engine.localizer, loc_vars),
                             (engine.encoder, enc_vars)):
        sd = model.state_dict()
        ref = flax_to_state_dict(variables)
        assert sd.keys() == ref.keys()
        for k in ref:
            assert torch.equal(sd[k], ref[k]), k
    # one leaf checked against the raw Flax layout: HWIO -> OIHW
    np.testing.assert_array_equal(
        engine.localizer.stem.Conv_0.weight.detach().numpy(),
        loc_vars["params"]["stem"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    jidx = JIndex.load(rec_dir)
    # rec2k_mn_hn/ref.txt: 90 rows, the last without a trailing newline
    assert engine.index.chars == jidx.chars and len(jidx.chars) == 90
    np.testing.assert_allclose(engine.index.embeddings, jidx.embeddings,
                               rtol=1e-6, atol=1e-7)
    c = engine.config
    assert (c.line_batch, c.crop_batch, c.encoder_sub_batch) == (
        512, 20480, 2048)
    assert (c.nms_kernel, c.out_quant, c.transfer_bits) == ("pallas", "u16",
                                                           4)
    assert engine._nms_kernel == "cuda"
    assert (c.localizer.input_size, c.localizer.input_height) == (1024, 96)
    assert (c.adaptive_height_floor, c.adaptive_height_cap) == (64, 96)
    assert c.crop_geometry == "tight" and c.encoder.image_size == 128


def test_infer_cli_main_on_cpu(artifact_dirs, tmp_path, capsys):
    """``python -m effocr_torch infer`` end to end on JAX-written artifacts
    (random weights: the text is meaningless, the path is not)."""
    from effocr_torch.cli.infer import main

    loc_dir, rec_dir, _, _ = artifact_dirs
    rng = np.random.default_rng(8)
    images = []
    for i, w in enumerate((300, 900)):
        Image.fromarray(rng.integers(0, 256, (48, w), np.uint8)).save(
            tmp_path / f"l{i}.png")
        images.append({"id": i, "file_name": f"l{i}.png", "text": "ab"})
    with open(tmp_path / "coco.json", "w") as f:
        json.dump({"images": images, "annotations": []}, f)
    main(_bench_flags(loc_dir, rec_dir) + [
        "--device", "cpu", "--line_batch", "2", "--image_dir",
                 str(tmp_path), "--coco_json", str(tmp_path / "coco.json"),
                 "--save_output", str(tmp_path / "out")])
    assert "EffOCR | Textline accuracy" in capsys.readouterr().out
    with open(tmp_path / "out" / "metrics.json") as f:
        metrics = json.load(f)
    assert metrics["n_lines"] == 2 and metrics["device"] == "cpu"
    with open(tmp_path / "out" / "inference_results.json") as f:
        assert set(json.load(f)) == {"l0.png", "l1.png"}


@pytest.mark.parametrize("flag", [["--data_parallel"],
                                  ["--data_parallel", "--build_index_from",
                                   "chars"]])
def test_load_engine_refuses_unported_paths(artifact_dirs, flag, capsys):
    """--data_parallel is ported: with one visible device (here the CPU)
    load_engine prints the JAX command's message and builds an unsharded
    engine (with --build_index_from beside it too)."""
    loc_dir, rec_dir, _, _ = artifact_dirs
    engine = load_engine(_args(loc_dir, rec_dir, *flag))
    assert ("--data_parallel: single device visible; running unsharded"
            in capsys.readouterr().out)
    assert len(engine._replicas) == 1
    assert engine._crop_cap == engine.config.crop_batch


def _gray_pngs(tmp_path, sizes, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i, (h, w) in enumerate(sizes):
        p = str(tmp_path / f"g{i}.png")
        Image.fromarray(rng.integers(0, 256, (h, w), np.uint8)).save(p)
        paths.append(p)
    return paths


def test_load_engine_runs_wide_line_tiling(artifact_dirs, tmp_path):
    """--tile_min_h with BENCH_TRAINED.json's flags on the CPU: a
    3,000 px line letterboxes below 20 px of content height and rides
    the pipeline as tiles, merged back under its own path."""
    loc_dir, rec_dir, _, _ = artifact_dirs
    engine = load_engine(_args(loc_dir, rec_dir, "--tile_min_h", "20",
                               "--line_batch", "4"))
    assert engine.config.tile_min_content_h == 20
    paths = _gray_pngs(tmp_path, [(48, 3000), (40, 300)], 10)
    lines = []
    orig = engine._dispatch_chunk
    engine._dispatch_chunk = lambda c, k: lines.extend(k) or orig(c, k)
    res = engine.run(paths)
    assert set(res) == set(paths) and all(isinstance(v, str)
                                           for v in res.values())
    tiles = [k for k in lines if isinstance(k, tiling.TileKey)]
    assert len(tiles) >= 2 and {t.parent for t in tiles} == {paths[0]}


def test_load_engine_runs_spell_check(artifact_dirs, tmp_path, monkeypatch):
    """--spell_check: every non-empty line goes through the port's copy
    of the spell checker with the builtin dictionary."""
    from effocr_torch.pipelines import infer as t_infer

    loc_dir, rec_dir, _, _ = artifact_dirs
    engine = load_engine(_args(loc_dir, rec_dir, "--spell_check",
                               "--line_batch", "2"))
    assert engine.config.spell_check
    seen = []
    check = t_infer.visual_spell_checker
    monkeypatch.setattr(t_infer, "visual_spell_checker",
                        lambda t, *a: seen.append(t) or check(t, *a))
    res = engine.run(_gray_pngs(tmp_path, [(48, 600), (44, 900)], 11))
    assert len(seen) == sum(1 for v in res.values() if v)
    assert engine._spell_check("tne") == "the"


def test_load_engine_runs_crop_source_original(jp_artifact_dirs, tmp_path):
    """--crop_source original with the jp_v3 flags (3-channel models) on
    the CPU: the detect program, crops cut from the original images, and
    the recognize program through top1_plain."""
    loc_dir, rec_dir, _, _ = jp_artifact_dirs
    engine = load_engine(_jp_args(loc_dir, rec_dir, "--crop_source",
                                  "original", "--line_batch", "2",
                                  "--crop_batch", "64"))
    assert engine.config.crop_source == "original"
    rng = np.random.default_rng(12)
    paths = []
    for i, h in enumerate((500, 380)):
        p = str(tmp_path / f"o{i}.png")
        Image.fromarray(rng.integers(0, 256, (h, 60, 3), np.uint8),
                        mode="RGB").save(p)
        paths.append(p)
    res, coco = engine.run(paths, return_coco=True)
    assert set(res) == set(paths) and all(isinstance(v, str)
                                           for v in res.values())
    assert [im["height"] for im in coco["images"]] == [500, 380]


def test_load_engine_reads_classifier_artifacts(tmp_path):
    """A recognizer dir in the JAX package's classifier format
    (``num_classes`` in model.json, the {encoder, head} checkpoint written
    by its checkpoint module, a sparse class_map.json) loads in classifier
    mode with Flax-equal parameters and runs on the CPU."""
    from effocr_torch.models.factory import (
        create_classifier,
        create_localizer,
        init_params,
    )

    loc_dir, rec_dir = tmp_path / "loc", tmp_path / "rec"
    loc_dir.mkdir()
    rec_dir.mkdir()
    loc = init_params(create_localizer("yolov5n", 2, in_channels=1), 13)
    j_ckpt.save_variables(state_dict_to_flax(loc.state_dict()),
                          str(loc_dir / "best_bbox_mAP.msgpack"))
    with open(loc_dir / "model.json", "w") as f:
        json.dump({"arch": "yolov5n", "num_classes": 2, "input_size": 256,
                   "input_height": 64, "input_channels": 1}, f)
    cls = init_params(create_classifier("mobilenetv3_small_050", 12,
                                        in_channels=1), 14)
    variables = state_dict_to_flax(cls.state_dict())
    assert set(variables["params"]) == {"encoder", "head"}
    j_ckpt.save_variables(variables, str(rec_dir / "enc_best.msgpack"))
    with open(rec_dir / "model.json", "w") as f:
        json.dump({"arch": "mobilenetv3_small_050", "image_size": 64,
                   "num_classes": 12, "input_channels": 1,
                   "crop_geometry": "tight"}, f)
    with open(rec_dir / "class_map.json", "w") as f:
        json.dump({"0": "a", "3": "b", "7": "c"}, f)
    p = argparse.ArgumentParser()
    add_engine_args(p)
    engine = load_engine(p.parse_args([
        "--recognizer_dir", str(rec_dir), "--localizer_dir", str(loc_dir),
        "--lang", "en", "--device", "cpu", "--line_batch", "2",
        "--crop_batch", "32"]))
    assert engine.classifier_mode and engine.index is None
    assert engine.class_map == {0: "a", 3: "b", 7: "c"}
    assert list(engine._char_lookup) == ["a", "", "", "b", "", "", "", "c"]
    sd = engine.encoder.state_dict()
    ref = flax_to_state_dict(variables)
    assert sd.keys() == ref.keys() and all(torch.equal(sd[k], ref[k])
                                           for k in ref)
    res = engine.run(_gray_pngs(tmp_path, [(48, 600), (40, 300)], 15))
    assert all(set(v) <= set("abc ") for v in res.values())


# the jp_v3 benchmark's flag list (bench_results/r5/jp_v3.result.json)
JP_V3_FLAGS = ["--lang", "jp", "--vertical", "--retrieval_kernel", "pallas",
               "--transfer_bits", "4", "--line_batch", "120", "--crop_batch",
               "4096"]


@pytest.fixture(scope="module")
def jp_artifact_dirs(tmp_path_factory):
    """JAX-written jp vertical artifacts: random-init yolov5n (loc_vert
    model.json), convnext_atto (rec_knn6k3 model.json), 11,051 random
    prototypes of width 320 with rec_knn6k3's ref.txt."""
    root = tmp_path_factory.mktemp("jp_artifacts")
    loc_dir, rec_dir = root / "loc", root / "rec"
    loc_dir.mkdir()
    rec_dir.mkdir()
    loc = j_localizer("yolov5n", num_classes=2)
    loc_vars = jax.jit(lambda x: loc.init(jax.random.PRNGKey(4), x))(
        jnp.zeros((1, 640, 96, 3)))
    j_ckpt.save_variables(loc_vars, str(loc_dir / "best_bbox_mAP.msgpack"))
    shutil.copy(os.path.join(R5, "loc_vert", "model.json"), loc_dir)
    enc = j_encoder("convnext_atto")
    enc_vars = jax.jit(lambda x: enc.init(jax.random.PRNGKey(5), x))(
        jnp.zeros((1, 128, 128, 3)))
    j_ckpt.save_variables(enc_vars, str(rec_dir / "enc_best.msgpack"))
    shutil.copy(os.path.join(R5, "rec_knn6k3", "model.json"), rec_dir)
    with open(os.path.join(R5, "rec_knn6k3", "ref.txt"), newline="") as f:
        n_rows = f.read().count("\n") + 1      # no trailing newline
    protos = np.random.default_rng(6).normal(size=(n_rows, 320))
    np.savez(str(rec_dir / "ref.npz"), embeddings=protos.astype(np.float32))
    shutil.copy(os.path.join(R5, "rec_knn6k3", "ref.txt"), rec_dir)
    return (str(loc_dir), str(rec_dir), jax.tree.map(np.asarray, loc_vars),
            jax.tree.map(np.asarray, enc_vars))


def _jp_args(loc_dir, rec_dir, *extra):
    p = argparse.ArgumentParser()
    add_engine_args(p)
    return p.parse_args(["--recognizer_dir", rec_dir, "--localizer_dir",
                         loc_dir, *JP_V3_FLAGS, "--device", "cpu", *extra])


def test_jp_index_reads_11051_rows(jp_artifact_dirs):
    """rec_knn6k3/ref.txt: 11,050 newlines and no trailing one, so 11,051
    rows in both packages (U+3000 and other whitespace rows kept)."""
    _, rec_dir, _, _ = jp_artifact_dirs
    from effocr_torch.retrieval.index import PrototypeIndex

    got, ref = PrototypeIndex.load(rec_dir), JIndex.load(rec_dir)
    assert len(got) == len(ref) == 11051
    assert got.chars == ref.chars
    np.testing.assert_allclose(got.embeddings, ref.embeddings, rtol=1e-6,
                               atol=1e-7)


def test_load_engine_builds_jp_vertical_engine(jp_artifact_dirs,
                                               monkeypatch, tmp_path):
    """jp_v3's flags on the CPU: Flax-equal parameters, the jp config, and
    a run over two RGB line PNGs (line_batch cut to 2, crop_batch to 64)
    whose retrieval is top1_plain, with a blacklisted char in its mask."""
    loc_dir, rec_dir, loc_vars, enc_vars = jp_artifact_dirs
    engine = load_engine(_jp_args(loc_dir, rec_dir))
    for model, variables in ((engine.localizer, loc_vars),
                             (engine.encoder, enc_vars)):
        sd = model.state_dict()
        ref = flax_to_state_dict(variables)
        assert sd.keys() == ref.keys()
        for k in ref:
            assert torch.equal(sd[k], ref[k]), k
    c = engine.config
    assert (c.lang, c.vertical, c.retrieval_kernel, c.knn_k) == (
        "jp", True, "pallas", 1)
    assert engine._top1 and engine._nms_kernel == "plain"
    assert (c.line_batch, c.crop_batch, c.transfer_bits, c.out_quant) == (
        120, 4096, 4, "i32")
    assert (c.localizer.input_size, c.localizer.input_height,
            c.input_channels) == (96, 640, 3)
    assert c.crop_geometry == "tight" and c.encoder.image_size == 128
    assert (c.localizer.max_det, c.localizer.max_nms) == (1000, 1024)
    assert len(engine.index) == 11051

    calls = []
    plain = cuda_top1.top1_plain

    def recording(q, p, mask):
        calls.append((q.shape, p.shape, mask.clone()))
        return plain(q, p, mask)

    monkeypatch.setattr(cuda_top1, "top1_plain", recording)
    blocked = engine.index.chars[7]
    engine = load_engine(_jp_args(loc_dir, rec_dir, "--line_batch", "2",
                                  "--crop_batch", "64", "--blacklist_chars",
                                  blocked))
    rng = np.random.default_rng(9)
    paths = []
    for i, h in enumerate((700, 420)):
        p = str(tmp_path / f"v{i}.png")
        Image.fromarray(rng.integers(0, 256, (h, 56, 3), np.uint8),
                        mode="RGB").save(p)
        paths.append(p)
    launches = cuda_top1.top1_kernel.launches
    res = engine.run(paths)
    assert set(res) == set(paths) and all(isinstance(v, str)
                                           for v in res.values())
    assert cuda_top1.top1_kernel.launches == launches
    assert len(calls) == 1
    (qs, ps, mask), = calls
    assert qs == (64, 320) and ps == (11051, 320)
    blocked_rows = [i for i, ch in enumerate(engine.index.chars)
                    if ch == blocked]
    assert not mask[blocked_rows].any() and int(mask.sum()) == (
        11051 - len(blocked_rows))


def test_load_engine_rejects_knn_k_with_top1_kernel(jp_artifact_dirs):
    from effocr_torch.pipelines.infer import EffOCRInference

    loc_dir, rec_dir, _, _ = jp_artifact_dirs
    engine = load_engine(_jp_args(loc_dir, rec_dir))
    cfg = dataclasses.replace(engine.config, knn_k=3)
    with pytest.raises(ValueError, match="knn_k"):
        EffOCRInference(cfg, engine.localizer, engine.encoder, engine.index,
                        device="cpu")


def test_config_and_batching_copies_match():
    for name in ("EncoderConfig", "LocalizerConfig", "PipelineConfig",
                 "RecognizerTrainConfig", "LocalizerTrainConfig"):
        assert (dataclasses.asdict(getattr(config, name)())
                == dataclasses.asdict(getattr(j_config, name)()))
    assert config.to_json(config.PipelineConfig()) == j_config.to_json(
        j_config.PipelineConfig())
    assert config.IMAGENET_MEAN == j_config.IMAGENET_MEAN
    assert config.IMAGENET_STD == j_config.IMAGENET_STD
    for n, m in ((0, 8), (7, 8), (20481, 2048)):
        assert batching.pad_to_multiple(n, m) == j_batching.pad_to_multiple(
            n, m)
    x = np.arange(6).reshape(2, 3)
    np.testing.assert_array_equal(batching.pad_axis_to(x, 5, 1, 9),
                                  j_batching.pad_axis_to(x, 5, 1, 9))
    items = [np.full((2, 2), i) for i in range(5)]
    for (a, ma), (b, mb) in [(batching.make_batches(items, 2),
                              j_batching.make_batches(items, 2))]:
        np.testing.assert_array_equal(np.stack(a), np.stack(b))
        np.testing.assert_array_equal(ma, mb)
    assert batching.bucket_size(70, [32, 64, 128]) == 128


def test_lang_copy_matches():
    rng = np.random.default_rng(4)
    chars = sorted(rng.uniform(0, 500, (12, 1)).tolist())
    cboxes = [[x[0], 5.0, x[0] + 12.0, 30.0] for x in chars]
    wboxes = [[cboxes[0][0] - 1, 0, 0, 0], [cboxes[5][0] - 1, 0, 0, 0],
              [cboxes[9][0] - 1, 0, 0, 0]]
    assert lang.en_preprocess(cboxes, wboxes) == j_lang.en_preprocess(
        cboxes, wboxes)
    assert lang.jp_preprocess(cboxes) == j_lang.jp_preprocess(cboxes)
    cb, wb = np.asarray(cboxes), np.asarray(wboxes)
    assert lang.word_end_indices(cb, wb) == j_lang.word_end_indices(cb, wb)
    wl = np.asarray([[w[0] for w in wboxes] + [0.0]] * 2)
    wv = np.array([[True, True, True, False]] * 2)
    n = np.array([12, 0])
    np.testing.assert_array_equal(
        lang.batch_word_ends(cb[:, 2], n, wl, wv),
        j_lang.batch_word_ends(cb[:, 2], n, wl, wv))
    text = "HELLOworld.x"
    assert lang.insert_spaces(text, [0, 5, 9]) == j_lang.insert_spaces(
        text, [0, 5, 9])
    h = rng.uniform(10, 30, 12).tolist()
    bt = rng.uniform(20, 40, 12).tolist()
    for margin in (None, 2.0):
        assert (lang.en_postprocess(text, [0, 5, 9], h, bt, margin)
                == j_lang.en_postprocess(text, [0, 5, 9], h, bt, margin))


def test_tiling_copy_matches():
    assert tiling.plan_tiles(4000, 40, 1024, 96, 60) == j_tiling.plan_tiles(
        4000, 40, 1024, 96, 60)
    plan = j_tiling.plan_tiles(4000, 40, 1024, 96, 60)
    assert plan and tiling.TileKey("k", 1) == j_tiling.TileKey("k", 1)
    parts = []
    for tile in plan:
        xs = np.arange(tile.start, tile.stop - 20, 30, dtype=np.float32)
        boxes = np.stack([xs, np.zeros_like(xs), xs + 18, xs * 0 + 30], 1)
        parts.append({"chars": ["a"] * len(xs), "boxes": boxes,
                      "words": boxes[::4]})
    got = tiling.merge_tile_parts(parts, plan, False, 4.0)
    ref = j_tiling.merge_tile_parts(parts, plan, False, 4.0)
    assert got[0] == ref[0]
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])


def test_spell_check_copy_matches():
    from effocr_tpu.utils import spell_check as j_spell
    from effocr_torch.utils import spell_check

    with pytest.warns(UserWarning):
        got = spell_check.default_dicts.__wrapped__()
    ref = j_spell.default_dicts.__wrapped__()
    assert got == ref and len(got[0]) > 400
    lines = ["Tne quick brovvn fox", "I0 dogs ran 1O miles", "Dr. Smith",
             "ca11 the offlce at 9am", "HELLO W0RLD", "J. Doe-Smith's b00k",
             "", "in tne rnain", "c0mpany/pr0ducts", "O0O 1l1"]
    for line in lines:
        assert spell_check.visual_spell_checker(line, *got) == \
            j_spell.visual_spell_checker(line, *ref), line
    for s in ("1l", "l0l", "a1b", "5s"):
        assert spell_check.majority_normalize(s, got[1]) == \
            j_spell.majority_normalize(s, ref[1])


def test_textline_copy_matches():
    pairs = [("Hello world", "Hel1o world"), ("“a”", '"a"'), ("abc", ""),
             ("Same", "Same")]
    for kw in ({}, {"no_spaces_in_eval": True}, {"norm_edit_distance": True},
               {"uncased": True}):
        assert textline.textline_evaluation(pairs, **kw) == \
            j_textline.textline_evaluation(pairs, **kw)
    assert textline.edit_distance("kitten", "sitting") == 3


def _random_detections(rng, n_img, nc, pred_classes):
    """Predictions and ground truths of ``n_img`` images: boxes near the
    ground truth (so some match at every IoU threshold) plus strays, tied
    scores, an image without predictions and one without ground truth;
    predictions only of ``pred_classes``."""
    preds, gts = [], []
    for i in range(n_img):
        n_gt = 0 if i == 1 else int(rng.integers(1, 7))
        xy = rng.uniform(0, 80, (n_gt, 2))
        g = np.concatenate([xy, xy + rng.uniform(4, 20, (n_gt, 2))], 1)
        g_cls = rng.integers(0, nc, n_gt)
        near = g + rng.normal(0, 1.5, g.shape)
        stray = rng.uniform(0, 90, (int(rng.integers(0, 4)), 2))
        stray = np.concatenate([stray, stray + 8], 1)
        p = np.concatenate([near, stray]) if i != 2 else np.zeros((0, 4))
        scores = np.round(rng.uniform(0, 1, len(p)), 1)   # ties
        p_cls = rng.choice(pred_classes, len(p))
        if i != 2:     # near boxes mostly carry their ground truth's class
            keep = rng.uniform(size=n_gt) < 0.8
            p_cls[:n_gt] = np.where(keep & np.isin(g_cls, pred_classes),
                                    g_cls, p_cls[:n_gt])
        preds.append({"boxes": p, "scores": scores, "classes": p_cls})
        gts.append({"boxes": g, "classes": g_cls})
    return preds, gts


@pytest.mark.parametrize("nc,pred_classes", [(2, [0, 1]), (3, [0, 2]),
                                             (1, [0])])
def test_coco_map_copy_matches(nc, pred_classes):
    """The same AP dictionary, NaN for NaN, on random detections: classes
    without ground truth or without predictions, images with neither."""
    rng = np.random.default_rng(nc)
    preds, gts = _random_detections(rng, 9, nc, pred_classes)
    if nc == 3:        # class 1: no ground truth anywhere -> AP NaN
        for g in gts:
            g["classes"] = np.where(g["classes"] == 1, 0, g["classes"])
    got = coco_map.coco_map(preds, gts, num_classes=nc)
    ref = j_coco_map.coco_map(preds, gts, num_classes=nc)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == ref[k] or (np.isnan(got[k]) and np.isnan(ref[k]))
    empty = coco_map.coco_map([{"boxes": np.zeros((0, 4)),
                                "scores": np.zeros(0), "classes": []}],
                              [{"boxes": np.zeros((0, 4)), "classes": []}],
                              num_classes=nc)
    ref_empty = j_coco_map.coco_map([{"boxes": np.zeros((0, 4)),
                                      "scores": np.zeros(0), "classes": []}],
                                    [{"boxes": np.zeros((0, 4)),
                                      "classes": []}], num_classes=nc)
    assert all(np.isnan(empty[k]) and np.isnan(ref_empty[k]) for k in ref)


def test_image_ops_copy_matches():
    for h, w, shape in ((60, 600, (96, 1024)), (300, 70, (64, 512))):
        assert image_ops.letterbox_params(h, w, shape) == \
            j_image_ops.letterbox_params(h, w, shape)
    x = np.random.default_rng(5).uniform(0, 1, (2, 4, 4, 1)).astype(
        np.float32)
    np.testing.assert_array_equal(
        image_ops.normalize_imagenet(torch.from_numpy(x)).numpy(),
        np.asarray(j_image_ops.normalize_imagenet(jnp.asarray(x))))
    img = np.random.default_rng(6).integers(0, 256, (8, 12, 3), np.uint8)
    d = image_ops.dither_offsets(8, 12)
    np.testing.assert_array_equal(d, j_image_ops.dither_offsets(8, 12))
    np.testing.assert_array_equal(
        image_ops.quantize_2bit(img, d[:, :, None]),
        j_image_ops.quantize_2bit(img, d[:, :, None]))


def test_native_copy_matches(tmp_path):
    rng = np.random.default_rng(7)
    imgs, paths, shapes = [], [], []
    for i, (h, w, ch) in enumerate([(60, 400, 1), (45, 900, 3),
                                    (70, 130, 1)]):
        im = rng.integers(0, 256, (h, w, ch), np.uint8)
        im[:, ::7] = 255
        p = str(tmp_path / f"{i}.png")
        Image.fromarray(im[..., 0] if ch == 1 else im).save(p)
        imgs.append(im)
        paths.append(p)
        shapes.append((h, w))
    got, gst = native.decode_png_batch(paths, [s + (1,) for s in shapes])
    ref, rst = j_native.decode_png_batch(paths, [s + (1,) for s in shapes])
    np.testing.assert_array_equal(gst, rst)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    for bits in (8, 4, 2):
        out = native.letterbox_gray_batch(got, 512, out_h=96, pack_bits=bits)
        ref = j_native.letterbox_gray_batch(got, 512, out_h=96,
                                            pack_bits=bits)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
        buf = np.zeros((3, 96, 512 * bits // 8), np.uint8)
        rbuf = np.zeros_like(buf)
        res = native.decode_letterbox_gray_batch(paths, shapes, 512, buf,
                                                 out_h=96, pack_bits=bits)
        rres = j_native.decode_letterbox_gray_batch(paths, shapes, 512, rbuf,
                                                    out_h=96, pack_bits=bits)
        np.testing.assert_array_equal(buf, rbuf)
        for a, b in zip(res, rres):
            np.testing.assert_array_equal(a, b)
    rgb = [np.ascontiguousarray(np.repeat(g, 3, -1)) if g.shape[2] == 1
           else g for g in got]
    for a, b in zip(native.letterbox_batch(rgb, 256, out_h=64),
                    j_native.letterbox_batch(rgb, 256, out_h=64)):
        np.testing.assert_array_equal(a, b)


def test_stage_timer():
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("a"):
            pass
    assert timer.counts["a"] == 3 and "a" in timer.report()
    timer.reset()
    assert not timer.totals


# ------------------------------------- the JAX-free data tools (copies)
def _coco_corpus(rng, n_images=23):
    from effocr_torch.data import coco

    out = {"info": {}, "licenses": [], "categories": list(
        coco.COCO_JSON_SKELETON["categories"]), "images": [],
        "annotations": []}
    anno_id = 0
    for i in range(n_images):
        out["images"].append(coco.create_coco_image_entry(
            f"l{i}.png", 48, int(rng.integers(100, 900)), i,
            text=None if i % 5 == 0 else "ab c"))
        for k in range(int(rng.integers(0, 4))):
            x, y, w, h = (float(v) for v in rng.uniform(0, 50, 4))
            out["annotations"].append(coco.create_coco_anno_entry(
                x, y, w, h, anno_id, i, k % 2))
            anno_id += 1
    return out


def test_coco_copy_matches():
    from effocr_tpu.data import coco as j_coco
    from effocr_torch.data import coco

    assert coco.COCO_JSON_SKELETON == j_coco.COCO_JSON_SKELETON
    assert coco.create_coco_anno_entry(1.5, 2, 3, 4.25, 7, 9, 1) == \
        j_coco.create_coco_anno_entry(1.5, 2, 3, 4.25, 7, 9, 1)
    for text in (None, "x y"):
        assert coco.create_coco_image_entry("a.png", 3, 4, 5, text) == \
            j_coco.create_coco_image_entry("a.png", 3, 4, 5, text)
    corpus = _coco_corpus(np.random.default_rng(0))
    for seed in (0, 99):
        assert coco.split_coco_json(corpus, 0.7, 0.2, seed) == \
            j_coco.split_coco_json(corpus, 0.7, 0.2, seed)
        assert coco.subset_coco_json(corpus, 9, seed) == \
            j_coco.subset_coco_json(corpus, 9, seed)
    other = _coco_corpus(np.random.default_rng(1), 6)
    assert coco.combine_coco_jsons(corpus, other) == \
        j_coco.combine_coco_jsons(corpus, other)
    rng = np.random.default_rng(2)
    a = np.sort(rng.uniform(0, 50, (6, 4)).reshape(6, 2, 2), 1).reshape(6, 4)
    b = np.sort(rng.uniform(0, 50, (6, 4)).reshape(6, 2, 2), 1).reshape(6, 4)
    np.testing.assert_array_equal(coco.box_iom(a, b), j_coco.box_iom(a, b))
    anno = corpus["annotations"][0]
    for vertical in (False, True):
        assert coco.clip_to_top_and_bottom(anno, 48.0, vertical) == \
            j_coco.clip_to_top_and_bottom(anno, 48.0, vertical)
    with pytest.raises(NotImplementedError, match="queue 1"):
        coco.extract_char_crops(corpus, "images", "crops")


def test_coco_tools_write_the_jax_bytes(tmp_path, monkeypatch, capsys):
    """coco-split / coco-combine / coco-subset: the JAX commands' files,
    byte for byte, and their printed lines."""
    from effocr_tpu.cli import coco_tools as j_tools
    from effocr_torch.cli import coco_tools

    src = tmp_path / "corpus.json"
    src.write_text(json.dumps(_coco_corpus(np.random.default_rng(3))))
    other = tmp_path / "other.json"
    other.write_text(json.dumps(_coco_corpus(np.random.default_rng(4), 5)))
    runs = {
        "coco_split": lambda o: ["--coco_json", str(src), "--out_prefix",
                                 str(o / "split"), "--seed", "7"],
        "coco_combine": lambda o: ["--coco_json_a", str(src),
                                   "--coco_json_b", str(other), "--out",
                                   str(o / "merged.json")],
        "coco_subset": lambda o: ["--coco_json", str(src), "--n", "8",
                                  "--out", str(o / "sub.json"), "--seed",
                                  "3"],
    }
    for cmd, argv in runs.items():
        mine, theirs = tmp_path / f"p_{cmd}", tmp_path / f"j_{cmd}"
        mine.mkdir()
        theirs.mkdir()
        coco_tools.main(cmd, argv(mine))
        said = capsys.readouterr().out
        monkeypatch.setattr(sys, "argv", [cmd] + argv(theirs))
        j_tools.main(cmd)
        assert said == capsys.readouterr().out.replace(str(theirs),
                                                       str(mine))
        names = sorted(os.listdir(theirs))
        assert sorted(os.listdir(mine)) == names and names
        for name in names:
            assert (mine / name).read_bytes() == (theirs / name).read_bytes()


def test_charsets_copies_match(tmp_path):
    from effocr_tpu.data import builtin_charsets as j_builtin
    from effocr_tpu.data import charsets as j_charsets
    from effocr_torch.data import builtin_charsets, charsets

    for name in ("JP_DIGITS", "JP_LATIN", "JP_EXTRA", "JP_REMOVE"):
        assert getattr(charsets, name) == getattr(j_charsets, name)
    assert builtin_charsets.english_charsets() == \
        j_builtin.english_charsets()
    for pkg, mod in (("p", builtin_charsets), ("j", j_builtin)):
        mod.write_charset_dir(str(tmp_path / pkg))
    for name in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    with open(j_builtin.jp_charset_path(), "rb") as f, \
            open(builtin_charsets.jp_charset_path(), "rb") as g:
        assert f.read() == g.read()
    for path in (str(tmp_path / "j"), os.path.dirname(
            j_builtin.jp_charset_path())):
        chars = charsets.load_charset_dir(path)
        assert chars == j_charsets.load_charset_dir(path)
        for lang in ("en", "jp"):
            assert charsets.harmonize_charset(chars, lang) == \
                j_charsets.harmonize_charset(chars, lang)
    full = charsets.harmonize_charset(chars, "jp")
    p = charsets.save_charset(full, str(tmp_path / "sp"), "jp")
    q = j_charsets.save_charset(full, str(tmp_path / "sj"), "jp")
    with open(p, "rb") as f, open(q, "rb") as g:
        assert f.read() == g.read()
    assert charsets.load_saved_charset(p) == j_charsets.load_saved_charset(q)
    assert charsets.load_chars(p) == j_charsets.load_chars(q)


def test_build_homoglyphs_writes_the_jax_bytes(tmp_path, monkeypatch,
                                               capsys):
    """build-homoglyphs on one index (clusters of near prototypes, two
    rows for some chars): the JAX command's file, byte for byte."""
    from effocr_tpu.cli import build_homoglyphs as j_homoglyphs
    from effocr_torch.cli import build_homoglyphs

    rng = np.random.default_rng(5)
    centers = rng.normal(size=(6, 32))
    chars = list("abcdefghijklmnopqrstuvwx") + list("abcd")
    emb = centers[np.arange(len(chars)) % 6] + 0.3 * rng.normal(
        size=(len(chars), 32))
    JIndex(emb.astype(np.float32), chars).save(str(tmp_path))
    for pkg, run in (("p", lambda a: build_homoglyphs.main(a)),
                     ("j", lambda a: (monkeypatch.setattr(
                         sys, "argv", ["build-homoglyphs"] + a),
                         j_homoglyphs.main()))):
        run(["--recognizer_dir", str(tmp_path), "--out",
             str(tmp_path / f"{pkg}.txt"), "--sim_thresh", "0.6",
             "--max_per_char", "3", "--block", "7"])
    said = capsys.readouterr().out.splitlines()
    mine = (tmp_path / "p.txt").read_bytes()
    assert mine == (tmp_path / "j.txt").read_bytes()
    assert len(mine.splitlines()) > 5
    assert said[0].replace("p.txt", "j.txt") == said[1]


def test_inference_coco_matches_jax_for_lines_without_text():
    """``build_inference_coco``: a line that reads None has no ``text``
    key in its image entry, as the JAX engine writes it (the port once
    wrote ``"text": null``; ROADMAP queue 3)."""
    from effocr_tpu.pipelines.infer import build_inference_coco as j_build
    from effocr_torch.pipelines.infer import build_inference_coco

    boxes = {"/a/l0.png": {"height": 40, "width": 300, "text": None,
                           "chars": [{"bbox": [1.5, 2.0, 9.25, 30.0],
                                      "char": "x"}]},
             "/a/l1.png": {"height": 40, "width": 120, "text": "ab c",
                           "chars": [{"bbox": [0.0, 0.0, 8.0, 20.0],
                                      "char": "a"},
                                     {"bbox": [9.0, 1.0, 7.0, 19.0],
                                      "char": "b"}]},
             "/a/l2.png": {"height": 40, "width": 60, "text": "",
                           "chars": []}}
    got = build_inference_coco(boxes)
    assert got == j_build(boxes)
    assert "text" not in got["images"][0] and got["images"][2]["text"] == ""
    assert json.dumps(got) == json.dumps(j_build(boxes))
