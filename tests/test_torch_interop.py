"""effocr_torch's artifact interchange against the JAX package, on the CPU:
the importers of the original EffOCR's formats, ``infer``'s auto-convert
hook and ``export``.

- the writers of interop/reference_writers.py (used by chip_smoke.py on
  the card) write the JAX tests' FAISS and ONNX bytes, byte for byte;
- FAISS reader (both layouts, the refusals) and ``ref.txt`` rows: exact;
- ``detect_timm_arch`` / ``detect_yolov5_variant``: the same names for
  every preset and the same refusals;
- every converter gives the JAX converter's tree exactly (the same keys,
  ``np.array_equal`` and dtype per leaf), on the seeded state dicts of
  tests/test_reference_import.py, tests/test_yolo_import.py and HF models
  of tests/test_import_encoder.py's configs;
- forwards in float32 of the port's model with the port's imported weights
  against the JAX model with JAX's, at rtol 1e-4 / atol 1e-5: one case per
  family (convnext_atto, mobilenetv3_small_050 and xcit_tiny_12_p8_224 at
  64 px, yolov5n's three head grids, HF ConvNeXt, HF ViT);
- directories: each package's conversion is the other's byte for byte
  (enc_best.msgpack, best_bbox_mAP.msgpack, model.json, ref.txt; ref.npz's
  arrays), and a ``tpu_converted`` made by one is reused by the other;
- pickles: the full-module extraction, ``ema`` before ``model``, "no
  parameters found", and pickles naming ``os.system`` / ``builtins.eval``
  that run nothing;
- the safetensors reader against the safetensors package and a
  ``save_pretrained`` file;
- ``python -m effocr_torch infer`` on a reference-format dir against the
  JAX command on the same dir and lines: the same text and COCO JSON;
- ``export_encoder(device="cpu")``: reload parity, and the exported
  program against the JAX encoder's forward at 1e-4;
- the command table: every command answers ``--help``.
"""

import io
import json
import os
import pickle
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effocr_tpu.interop import onnx_import as j_onnx
from effocr_tpu.interop import reference_artifacts as j_ref
from effocr_tpu.interop import torch_pickle as j_pickle
from effocr_tpu.interop import yolo_import as j_yolo
from effocr_tpu.models import factory as j_factory
from effocr_tpu.models import import_weights as j_iw
from effocr_tpu.models.convnext import ConvNeXt as JConvNeXt
from effocr_tpu.models.vit import ViT as JViT
from effocr_tpu.train import checkpoint as j_ckpt
from effocr_torch.interop import onnx_import, reference_artifacts as ref
from effocr_torch.interop import reference_writers as writers
from effocr_torch.interop import safetensors as st
from effocr_torch.interop import torch_pickle, yolo_import
from effocr_torch.interop.flax_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from effocr_torch.interop.flax_msgpack import read_variables
from effocr_torch.models import factory, import_weights
from effocr_torch.models.convnext import ConvNeXt
from effocr_torch.models.vit import ViT
from test_torch_pipeline import line_paths  # noqa: F401
from test_reference_import import (
    make_onnx_bytes,
    make_timm_convnext_sd,
    make_timm_mnv3_sd,
    make_timm_xcit_sd,
    write_faiss_flat as j_write_faiss,
)
from test_yolo_import import ANCHORS_GRID, NC, make_ultralytics_sd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = torch.float32
ATTO = ((2, 2, 6, 2), (40, 80, 160, 320))


def same_tree(a, b, path=""):
    """Exactly the same tree: keys, and per leaf values and dtype."""
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            same_tree(a[k], b[k], f"{path}/{k}")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), f"{path}/{k}"


def _unit(rng, n, d):
    emb = rng.normal(size=(n, d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _forward(model, variables, x):
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


# ------------------------------------------------------------ writers, faiss
def test_writers_write_the_jax_tests_bytes(tmp_path):
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(7, 5)).astype(np.float32)
    for metric in (0, 1):
        for legacy in (False, True):
            a, b = tmp_path / "a.index", tmp_path / "b.index"
            writers.write_faiss_flat(str(a), emb, metric, legacy)
            j_write_faiss(str(b), emb, metric, legacy)
            assert a.read_bytes() == b.read_bytes()
    inits = {"net.x.weight": emb, "shape": np.arange(3, dtype=np.int64)}
    nodes = [("MatMul", ["x", "onnx::MatMul_1"], ["h"]),
             ("Add", ["h", "x.bias"], ["y"])]
    assert writers.onnx_bytes(inits, nodes) == make_onnx_bytes(inits, nodes)


@pytest.mark.parametrize("legacy", [False, True])
def test_faiss_reader_matches_jax(tmp_path, legacy):
    emb = np.random.default_rng(1).normal(size=(17, 12)).astype(np.float32)
    for metric in (0, 1):
        p = str(tmp_path / f"ref{metric}.index")
        writers.write_faiss_flat(p, emb, metric, legacy)
        got, name = ref.read_faiss_flat_index(p)
        want, j_name = j_ref.read_faiss_flat_index(p)
        assert name == j_name == ("ip", "l2")[metric]
        assert np.array_equal(got, want) and np.array_equal(got, emb)


def test_faiss_refusals_match_jax(tmp_path, timm_mnv3):
    bad = tmp_path / "bad.index"
    bad.write_bytes(b"IwFl" + b"\x00" * 64)
    for reader in (ref.read_faiss_flat_index, j_ref.read_faiss_flat_index):
        with pytest.raises(ValueError, match="fourcc"):
            reader(str(bad))
    # an L2 index in a reference dir, and a ref.txt whose rows are not
    # the index's: both importers refuse them
    src = tmp_path / "src"
    _reference_dir(src, timm_mnv3, 3, 1024)
    rng = np.random.default_rng(2)
    for rows, metric, match in ((3, 1, "L2 index"), (4, 0, "ref.txt rows")):
        writers.write_faiss_flat(str(src / "ref.index"),
                                 _unit(rng, rows, 1024), metric)
        for imp, out in ((ref.import_reference_recognizer_dir, "p"),
                         (j_ref.import_reference_recognizer_dir, "j")):
            with pytest.raises(ValueError, match=match):
                imp(str(src), str(tmp_path / out))


def test_ref_txt_rows_match_jax(tmp_path):
    p = tmp_path / "ref.txt"
    p.write_text("a\n \nb\n　\nxy\n\n一\n", encoding="utf-8")
    assert ref.load_reference_ref_txt(str(p)) == \
        j_ref.load_reference_ref_txt(str(p)) == \
        ["a", " ", "b", "　", "x", "一"]


# ---------------------------------------------------------------- detection
def _convnext_keys(depths, dims):
    """The keys and shapes detect_timm_arch reads, without the weights."""
    sd = {"stem.0.weight": np.empty((dims[0], 3, 4, 4), np.float32)}
    for i, (depth, d) in enumerate(zip(depths, dims)):
        for j in range(depth):
            sd[f"stages.{i}.blocks.{j}.conv_dw.weight"] = np.empty(
                (d, 1, 7, 7), np.float32)
    return sd


def _xcit_keys(dim, depth, heads):
    sd = {"cls_token": np.empty((1, 1, dim), np.float32)}
    for k in (0, 2, 4):
        sd[f"patch_embed.proj.{k}.0.weight"] = np.empty((1,), np.float32)
    for i in range(depth):
        sd[f"blocks.{i}.attn.temperature"] = np.empty((heads, 1, 1))
    return sd


def _detect_cases():
    cases = [_convnext_keys(depths, dims)
             for depths, dims in import_weights.CONVNEXT_PRESETS]
    cases += [{"conv_stem.weight": np.empty((w, 3, 3, 3))} for w in (8, 16)]
    cases += [_xcit_keys(384, 12, 8), _xcit_keys(192, 12, 4)]
    return cases


def test_detect_timm_arch_matches_jax():
    names = [ref.detect_timm_arch(sd) for sd in _detect_cases()]
    assert names == [j_ref.detect_timm_arch(sd) for sd in _detect_cases()]
    assert len(set(names)) == 9
    bad = [_convnext_keys((2, 2, 6, 2), (40, 80, 160, 322)),
           {"conv_stem.weight": np.empty((12, 3, 3, 3))},
           _xcit_keys(384, 11, 8), {"head.weight": np.empty(3)}]
    for sd in bad:
        with pytest.raises(ValueError) as mine:
            ref.detect_timm_arch(sd)
        with pytest.raises(ValueError) as theirs:
            j_ref.detect_timm_arch(sd)
        assert str(mine.value) == str(theirs.value)


def test_detect_yolov5_variant_matches_jax():
    for width, depth, name in ((16, 1, "yolov5n"), (32, 1, "yolov5s"),
                               (48, 2, "yolov5m"), (24, 1, None),
                               (16, 3, None)):
        sd = {"model.0.conv.weight": np.empty((width, 3, 6, 6))}
        for j in range(depth):
            sd[f"model.2.m.{j}.cv1.conv.weight"] = np.empty(1)
        if name:
            assert yolo_import.detect_yolov5_variant(sd) == name == \
                j_yolo.detect_yolov5_variant(sd)
            continue
        with pytest.raises(ValueError) as mine:
            yolo_import.detect_yolov5_variant(sd)
        with pytest.raises(ValueError) as theirs:
            j_yolo.detect_yolov5_variant(sd)
        assert str(mine.value) == str(theirs.value)


# --------------------------------------------------------------- converters
def _hf_convnext(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32), **kw):
    from transformers import ConvNextConfig, ConvNextModel

    torch.manual_seed(0)
    return ConvNextModel(ConvNextConfig(depths=list(depths),
                                        hidden_sizes=list(dims),
                                        num_channels=3, **kw)).eval()


def _hf_vit():
    from transformers import ViTConfig, ViTModel

    torch.manual_seed(0)
    return ViTModel(ViTConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=128, image_size=32, patch_size=16,
        layer_norm_eps=1e-6)).eval()


def _sd_np(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _converted(family):
    """(port tree, JAX tree, the state dict) of one converter on one
    seeded state dict."""
    rng = np.random.default_rng(7)
    if family == "convnext":
        sd = make_timm_convnext_sd(rng, *ATTO)
        return ({"params": ref.convert_timm_convnext(sd)},
                {"params": j_ref.convert_timm_convnext(sd)}, sd)
    if family == "mobilenetv3":
        sd = make_timm_mnv3_sd(rng, multiplier=0.5, head=1024)
        pick = ("params", "batch_stats")
        return (dict(zip(pick, ref.convert_timm_mobilenetv3(sd))),
                dict(zip(pick, j_ref.convert_timm_mobilenetv3(sd))), sd)
    if family == "xcit":
        sd = make_timm_xcit_sd(rng, dim=192, depth=12, heads=4, cls_depth=2,
                               hidden=16)
        pick = ("params", "batch_stats")
        return (dict(zip(pick, ref.convert_timm_xcit(sd, 64))),
                dict(zip(pick, j_ref.convert_timm_xcit(sd, 64))), sd)
    if family == "yolov5":
        sd = make_ultralytics_sd(rng)
        mine = yolo_import.convert_ultralytics_yolov5(sd)
        theirs = j_yolo.convert_ultralytics_yolov5(sd)
        assert mine[2:] == theirs[2:]
        return ({"params": mine[0], "batch_stats": mine[1]},
                {"params": theirs[0], "batch_stats": theirs[1]}, sd)
    if family == "hf_convnext":
        sd = _sd_np(_hf_convnext())
        args = ((1, 1, 2, 1), (8, 16, 24, 32))
        return ({"params": import_weights.convert_hf_convnext(sd, *args)},
                {"params": j_iw.convert_hf_convnext(sd, *args)}, sd)
    sd = _sd_np(_hf_vit())
    return ({"params": import_weights.convert_hf_vit(sd, 2)},
            {"params": j_iw.convert_hf_vit(sd, 2)}, sd)


FAMILIES = ["convnext", "mobilenetv3", "xcit", "yolov5", "hf_convnext",
            "hf_vit"]


@pytest.mark.parametrize("family", FAMILIES)
def test_converter_gives_jax_tree(family):
    mine, theirs, _ = _converted(family)
    same_tree(mine, theirs)


def test_yolov5_anchors_in_pixels():
    _, _, sd = _converted("yolov5")
    *_, anchors, nc = yolo_import.convert_ultralytics_yolov5(sd)
    assert nc == NC
    for i, stride in enumerate((8, 16, 32)):
        np.testing.assert_array_equal(np.reshape(anchors[i], (3, 2)),
                                      ANCHORS_GRID[i] * stride)


def _models(family):
    """(port model, JAX model, input [2, H, W, 3]) in float32."""
    x = np.random.default_rng(8).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    if family in ("convnext", "mobilenetv3", "xcit"):
        name = {"convnext": "convnext_atto",
                "mobilenetv3": "mobilenetv3_small_050",
                "xcit": "xcit_tiny_12_p8_224"}[family]
        kw = {"image_size": 64} if family == "xcit" else {}
        return (factory.create_encoder(name, dtype=F32, **kw),
                j_factory.create_encoder(name, dtype=jnp.float32, **kw), x)
    if family == "yolov5":
        anchors = tuple(tuple(a * s for a in np.ravel(g))
                        for g, s in zip(ANCHORS_GRID, (8, 16, 32)))
        return (factory.create_localizer("yolov5n", NC, dtype=F32,
                                         anchors=anchors),
                j_factory.create_localizer("yolov5n", num_classes=NC,
                                           anchors=anchors,
                                           dtype=jnp.float32), x)
    if family == "hf_convnext":
        kw = dict(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32))
        return ConvNeXt(dtype=F32, **kw), JConvNeXt(
            dtype=jnp.float32, **kw), x
    kw = dict(patch=16, dim=32, depth=2, heads=2)
    return (ViT(image_size=32, dtype=F32, **kw),
            JViT(image_size=32, dtype=jnp.float32, **kw), x[:, :32, :32])


@pytest.mark.parametrize("family", FAMILIES)
def test_imported_forward_matches_jax(family):
    mine, theirs, _ = _converted(family)
    tm, jm, x = _models(family)
    if family == "yolov5":
        with torch.no_grad():
            tm.load_state_dict(flax_to_state_dict(mine), strict=True)
            got = [g.numpy() for g in tm(torch.from_numpy(x), decode=False)]
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False,
                                             decode=False))(theirs, x)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-5)
        return
    got = _forward(tm, mine, x)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        theirs, x))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# -------------------------------------------------------------- directories
# Every JAX-side directory conversion here converts one encoder,
# mobilenetv3_small_050 (3 channels, head 1024) at the importers' default
# 224 px, and one localizer, yolov5n on a 64 x 256 canvas: the JAX
# importers check the tree against an eager init of the module, which
# compiles its operations on first use at each shape.
@pytest.fixture(scope="module")
def timm_mnv3():
    return make_timm_mnv3_sd(np.random.default_rng(10), multiplier=0.5,
                             head=1024)


def _reference_dir(root, sd, n_rows, dim, module_prefix=False, onnx=False):
    root.mkdir()
    if onnx:
        writers.write_onnx(str(root / "enc_best.onnx"), sd)
    else:
        pre = "module." if module_prefix else ""
        torch.save({pre + k: torch.from_numpy(np.asarray(v))
                    for k, v in sd.items()}, root / "enc_best.pth")
    emb = _unit(np.random.default_rng(9), n_rows, dim)
    writers.write_faiss_flat(str(root / "ref.index"), emb)
    chars = list("abc 　de")[:n_rows]
    (root / "ref.txt").write_text("\n".join(chars) + "\n", encoding="utf-8")
    return chars


def _same_files(a, b):
    """Two converted dirs: the same enc_best.msgpack and ref.txt bytes,
    model.json (but for the source path), ref.npz's arrays."""
    for name in ("enc_best.msgpack", "ref.txt"):
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name
    metas = []
    for d in (a, b):
        with open(os.path.join(d, "model.json")) as f:
            metas.append(json.load(f))
        metas[-1].pop("imported_from")
    assert metas[0] == metas[1]
    # ref.npz: each package's PrototypeIndex normalizes the rows it is
    # given (torch's and XLA's float32 sums): to ~1 ulp, as
    # test_torch_io.py holds the index
    x, y = np.load(os.path.join(a, "ref.npz")), np.load(
        os.path.join(b, "ref.npz"))
    assert set(x) == set(y) == {"embeddings"}
    np.testing.assert_allclose(x["embeddings"], y["embeddings"], rtol=1e-6,
                               atol=1e-7)


def test_reference_dir_conversion_is_jax_conversion(tmp_path, timm_mnv3):
    """Each package converts a reference dir (timm ``enc_best.pth``; with
    and without DataParallel's ``module.`` in the port) into the same
    files, and each package's loader reads the other's."""
    from effocr_tpu.retrieval.index import PrototypeIndex as JIndex
    from effocr_torch.retrieval.index import PrototypeIndex

    chars = _reference_dir(tmp_path / "src", timm_mnv3, 6, 1024,
                           module_prefix=True)
    _reference_dir(tmp_path / "plain", timm_mnv3, 6, 1024)
    theirs = j_ref.import_reference_recognizer_dir(str(tmp_path / "src"),
                                                   str(tmp_path / "j"))
    for src in ("src", "plain"):
        mine = ref.import_reference_recognizer_dir(str(tmp_path / src),
                                                   str(tmp_path / f"p{src}"))
        _same_files(mine, theirs)
    assert PrototypeIndex.load(theirs).chars == JIndex.load(mine).chars \
        == chars
    params, stats = j_ref.convert_timm_mobilenetv3(timm_mnv3)
    same_tree(read_variables(os.path.join(theirs, "enc_best.msgpack")),
              {"params": params, "batch_stats": stats})
    jm = j_factory.create_encoder("mobilenetv3_small_050")
    init = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                          jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))
    restored = j_ckpt.load_variables(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), init),
        os.path.join(mine, "enc_best.msgpack"))
    same_tree(jax.tree.map(np.asarray, restored),
              {"params": params, "batch_stats": stats})


@pytest.mark.parametrize("first", ["port", "jax"])
def test_converted_dir_reused_by_the_other_package(tmp_path, capsys, first,
                                                   timm_mnv3):
    """infer's hook: a ``tpu_converted`` made by one package is found and
    reused by the other's (nothing is converted again), and the hook is
    idempotent."""
    src = tmp_path / "src"
    _reference_dir(src, timm_mnv3, 5, 1024)
    hooks = [ref.maybe_convert_reference_dir,
             j_ref.maybe_convert_reference_dir]
    if first == "jax":
        hooks.reverse()
    out = hooks[0](str(src))
    assert out == str(src / "tpu_converted")
    assert "converting reference-format recognizer_dir" in \
        capsys.readouterr().out
    stamp = os.stat(os.path.join(out, "enc_best.msgpack")).st_mtime_ns
    for hook in hooks + hooks:
        assert hook(str(src)) == out
        assert hook(out) == out
    assert capsys.readouterr().out == ""
    assert os.stat(os.path.join(out, "enc_best.msgpack")).st_mtime_ns == stamp


def test_one_channel_encoder_imports_in_the_port_only(tmp_path):
    """The port reads the input channels off the stem; the JAX importer
    checks against a 3-channel module and refuses a 1-channel one."""
    m = factory.init_params(factory.create_encoder(
        "mobilenetv3_small_050", in_channels=1), 12)
    v = state_dict_to_flax(m.state_dict())
    sd = writers.timm_mobilenetv3_state_dict(v["params"], v["batch_stats"])
    src = tmp_path / "src"
    _reference_dir(src, sd, 4, 1024, onnx=True)
    out = ref.import_reference_recognizer_dir(str(src))
    same_tree(read_variables(os.path.join(out, "enc_best.msgpack")), v)
    with open(os.path.join(out, "model.json")) as f:
        assert json.load(f)["input_channels"] == 1
    with pytest.raises(ValueError, match="does not match"):
        j_ref.import_reference_recognizer_dir(str(src), str(tmp_path / "j"))


LOC_CANVAS = ["--input_size", "256", "--input_height", "64"]


def _jax_localizer_dir(sd, out):
    """What the JAX package's import_ultralytics_localizer writes, from
    its converter and checkpoint writer; its module check (an eager Flax
    init of yolov5n, which compiles every operation on first use) is
    left out."""
    params, stats, anchors, nc = j_yolo.convert_ultralytics_yolov5(sd)
    os.makedirs(out)
    j_ckpt.save_variables({"params": jax.tree.map(jnp.asarray, params),
                           "batch_stats": jax.tree.map(jnp.asarray, stats)},
                          os.path.join(out, "best_bbox_mAP.msgpack"))
    return {"arch": j_yolo.detect_yolov5_variant(sd), "num_classes": nc,
            "input_size": 256, "input_height": 64, "input_channels": 3,
            "anchors": [list(a) for a in anchors]}


def test_localizer_dir_conversion_is_jax_conversion(tmp_path):
    """import_ultralytics_localizer from a plain state dict and from a
    full module pickle: the JAX package's bytes and model.json, and the
    JAX loader reads the file to the JAX converter's tree."""
    sd = make_ultralytics_sd(np.random.default_rng(13))
    plain = tmp_path / "sd.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, plain)
    full = tmp_path / "best.pt"
    writers.save_module_pickle(str(full), sd, epoch=3)
    want_meta = _jax_localizer_dir(sd, str(tmp_path / "j"))
    with open(tmp_path / "j" / "best_bbox_mAP.msgpack", "rb") as f:
        want = f.read()
    for pt in (plain, full):
        out = yolo_import.import_ultralytics_localizer(
            str(pt), str(tmp_path / pt.stem), input_size=256,
            input_height=64)
        with open(os.path.join(out, "best_bbox_mAP.msgpack"), "rb") as f:
            assert f.read() == want
        with open(os.path.join(out, "model.json")) as f:
            meta = json.load(f)
        assert meta.pop("imported_from") == str(pt)
        assert meta == want_meta
    jm = j_factory.create_localizer("yolov5n", num_classes=NC)
    init = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                          jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    restored = j_ckpt.load_variables(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), init),
        os.path.join(out, "best_bbox_mAP.msgpack"))
    params, stats, _, _ = j_yolo.convert_ultralytics_yolov5(sd)
    same_tree(jax.tree.map(np.asarray, restored),
              {"params": params, "batch_stats": stats})


def test_import_reference_cli_with_both_flags_writes_both_into_out(
        tmp_path, timm_mnv3, capsys):
    """``import-reference --recognizer_dir R --localizer_pt P --out O``
    writes the recognizer and then the localizer into O, the localizer's
    model.json over the recognizer's, as the JAX command does
    (effocr_tpu/cli/import_reference.py:34-55: both calls take
    ``args.out``; ROADMAP queue 3).  Separate calls keep both."""
    from effocr_torch.cli import import_reference

    _reference_dir(tmp_path / "src", timm_mnv3, 3, 1024)
    pt = tmp_path / "sd.pt"
    torch.save({k: torch.from_numpy(v) for k, v in make_ultralytics_sd(
        np.random.default_rng(14)).items()}, pt)
    out = tmp_path / "out"
    import_reference.main(["--recognizer_dir", str(tmp_path / "src"),
                           "--localizer_pt", str(pt), "--out", str(out)])
    said = capsys.readouterr().out
    assert f"recognizer converted -> {out}" in said
    assert f"localizer converted -> {out}" in said
    with open(out / "model.json") as f:
        assert json.load(f)["arch"] == "yolov5n"
    assert (out / "enc_best.msgpack").exists() and \
        (out / "best_bbox_mAP.msgpack").exists()
    with pytest.raises(SystemExit, match="requires --out"):
        import_reference.main(["--localizer_pt", str(pt)])


# --------------------------------------------------------------------- onnx
def test_onnx_initializer_roundtrip(tmp_path):
    rng = np.random.default_rng(21)
    sd = {"net.conv_stem.weight": rng.normal(size=(8, 3, 3, 3)).astype(
        np.float32), "module.net.bn1.weight": np.ones(8, np.float32),
          "module.head.bias": np.zeros(4, np.float32),
          "shape_const": np.arange(4, dtype=np.int64)}
    p = tmp_path / "enc_best.onnx"
    p.write_bytes(writers.onnx_bytes(sd))
    got = onnx_import.onnx_to_state_dict(str(p))
    same_tree(got, j_onnx.onnx_to_state_dict(str(p)))
    assert set(got) == {"conv_stem.weight", "bn1.weight", "head.bias"}
    assert np.array_equal(got["conv_stem.weight"], sd["net.conv_stem.weight"])


def test_onnx_matmul_weight_recovery(tmp_path):
    rng = np.random.default_rng(22)
    w = rng.normal(size=(12, 7)).astype(np.float32)
    b = rng.normal(size=12).astype(np.float32)
    inits = {"onnx::MatMul_123": np.ascontiguousarray(w.T),
             "net.blocks.0.mlp.fc1.bias": b}
    nodes = [("MatMul", ["x", "onnx::MatMul_123"], ["h"]),
             ("Add", ["h", "net.blocks.0.mlp.fc1.bias"], ["y"])]
    p = tmp_path / "enc_best.onnx"
    p.write_bytes(writers.onnx_bytes(inits, nodes))
    got = onnx_import.onnx_to_state_dict(str(p))
    same_tree(got, j_onnx.onnx_to_state_dict(str(p)))
    assert np.array_equal(got["blocks.0.mlp.fc1.weight"], w)
    # an anonymous float matrix nothing names: refused by both
    p.write_bytes(writers.onnx_bytes({"onnx::MatMul_9": w}))
    for reader in (onnx_import.onnx_to_state_dict, j_onnx.onnx_to_state_dict):
        with pytest.raises(ValueError, match="could not attribute"):
            reader(str(p))


def test_onnx_only_dir_through_infer_hook(tmp_path, timm_mnv3):
    """An ``enc_best.onnx``-only dir (timm mobilenetv3, 3 channels)
    converts through infer's hook in both packages to the same files."""
    a, b = tmp_path / "a", tmp_path / "b"
    _reference_dir(a, timm_mnv3, 4, 1024, onnx=True)
    _reference_dir(b, timm_mnv3, 4, 1024, onnx=True)
    mine = ref.maybe_convert_reference_dir(str(a))
    theirs = j_ref.maybe_convert_reference_dir(str(b))
    assert (mine, theirs) == (str(a / "tpu_converted"),
                              str(b / "tpu_converted"))
    _same_files(mine, theirs)


# ------------------------------------------------------------------ pickles
@pytest.fixture()
def saved_only_module():
    """A module of classes that exist only while the checkpoint is
    written (as the ultralytics package is absent where it is read)."""
    import types

    mod = types.ModuleType("fake_ultra_models")

    class Conv(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 4, 3, bias=False)
            self.bn = torch.nn.BatchNorm2d(4)

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = torch.nn.Sequential(Conv(), Conv())

    for cls in (Conv, Model):
        cls.__module__, cls.__qualname__ = mod.__name__, cls.__name__
        setattr(mod, cls.__name__, cls)
    sys.modules[mod.__name__] = mod
    try:
        yield Model
    finally:
        sys.modules.pop(mod.__name__, None)


def test_full_pickle_extraction_matches_jax(tmp_path, saved_only_module):
    torch.manual_seed(0)
    m = saved_only_module().half()
    for bn in (m.model[0].bn, m.model[1].bn):
        bn.running_mean.normal_()
    want = {k: v.float().numpy() for k, v in m.state_dict().items()
            if "num_batches_tracked" not in k}
    ema = saved_only_module().half()
    torch.save({"model": m, "epoch": 3}, tmp_path / "best.pt")
    torch.save({"model": m, "ema": ema, "epoch": 3}, tmp_path / "last.pt")
    del sys.modules["fake_ultra_models"]
    got = torch_pickle.load_module_pickle_state_dict(str(tmp_path / "best.pt"))
    same_tree(got, j_pickle.load_module_pickle_state_dict(
        str(tmp_path / "best.pt")))
    same_tree(got, want)
    # an unstripped checkpoint: ema before model, as ultralytics loads it
    got = torch_pickle.load_module_pickle_state_dict(str(tmp_path / "last.pt"))
    same_tree(got, {k: v.float().numpy() for k, v in ema.state_dict().items()
                    if "num_batches_tracked" not in k})
    same_tree(torch_pickle.load_module_pickle_state_dict(
        str(tmp_path / "last.pt"), root_key="model"), want)


def test_checkpoint_dict_without_module_tree_refused(tmp_path):
    pt = tmp_path / "full.pt"
    torch.save({"model": {"not": "a state dict"}, "epoch": 3}, pt)
    for imp in (yolo_import.import_ultralytics_localizer,
                j_yolo.import_ultralytics_localizer):
        with pytest.raises(ValueError, match="no parameters found"):
            imp(str(pt), str(tmp_path / "loc"))


class _Payload:
    """Pickles as a call of ``target(arg)``."""

    def __init__(self, target, arg):
        self.target, self.arg = target, arg

    def __reduce__(self):
        return self.target, (self.arg,)


@pytest.mark.parametrize("target", ["os.system", "builtins.eval"])
def test_malicious_pickle_runs_nothing(tmp_path, target):
    """A ``best.pt`` whose REDUCE names ``os.system`` or ``builtins.eval``
    loads as inert stubs: the command does not run, no file appears, and
    the import fails only for want of parameters."""
    import builtins

    marker = tmp_path / "pwned"
    if target == "os.system":
        payload = _Payload(os.system, f"touch {marker}")
    else:
        payload = _Payload(builtins.eval,
                           f"open({str(marker)!r}, 'w').close()")
    pt = tmp_path / "best.pt"
    torch.save({"model": payload, "epoch": 1}, pt)
    with pytest.raises(ValueError, match="no parameters found"):
        torch_pickle.load_module_pickle_state_dict(str(pt))
    with pytest.raises(ValueError, match="no parameters found"):
        yolo_import.import_ultralytics_localizer(str(pt), str(tmp_path / "l"))
    assert not marker.exists()
    assert not (tmp_path / "l" / "model.json").exists()


@pytest.mark.parametrize("route", ["load_from_bytes", "legacy_header"])
def test_malicious_nested_pickle_runs_nothing(tmp_path, route):
    """Two routes by which torch's loaders would unpickle again with the
    plain ``pickle`` module: a REDUCE of ``torch.storage._load_from_bytes``
    on bytes that hold a second pickle, and a legacy-format (non-zip) file,
    whose header records torch reads with ``pickle_module.load``.  The
    inner pickle names ``os.system``; it must not run.  (Only the port is
    loaded here: the JAX package is not held to this rule.)"""
    marker = tmp_path / "pwned"
    inner = pickle.dumps(_Payload(os.system, f"touch {marker}"))
    pt = tmp_path / "best.pt"
    if route == "load_from_bytes":
        torch.save({"model": _Payload(torch.storage._load_from_bytes, inner),
                    "epoch": 1}, pt)
    else:
        pt.write_bytes(inner)
    with pytest.raises(RuntimeError, match="magic number"):
        torch_pickle.load_module_pickle_state_dict(str(pt))
    with pytest.raises(RuntimeError, match="magic number"):
        yolo_import.import_ultralytics_localizer(str(pt), str(tmp_path / "l"))
    assert not marker.exists()
    assert not (tmp_path / "l" / "model.json").exists()


def test_legacy_storages_still_load(tmp_path):
    """What the allowlist keeps: a legacy-format save, and a tensor nested
    as ``_load_from_bytes`` bytes inside a zip save, both read back."""
    rng = np.random.default_rng(31)
    m = torch.nn.Conv2d(3, 4, 3)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(rng.normal(size=(4, 3, 3, 3))))
    want = {k: v.numpy() for k, v in m.state_dict().items()}
    legacy = tmp_path / "legacy.pt"
    torch.save({"model": m}, legacy, _use_new_zipfile_serialization=False)
    same_tree(torch_pickle.load_module_pickle_state_dict(str(legacy)), want)
    buf = io.BytesIO()
    torch.save(m.weight.detach(), buf, _use_new_zipfile_serialization=False)
    got = torch_pickle._load_from_bytes(buf.getvalue())
    assert np.array_equal(got.numpy(), want["weight"])
    nested = tmp_path / "nested.pt"
    torch.save({"w": _Payload(torch.storage._load_from_bytes,
                              buf.getvalue())}, nested)
    obj = torch.load(nested, weights_only=False,
                     pickle_module=torch_pickle._PickleModule)
    assert np.array_equal(obj["w"].numpy(), want["weight"])


# -------------------------------------------------------------- safetensors
def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as t_load, save_file as t_save

    rng = np.random.default_rng(30)
    tensors = {"f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(
        np.float32)), "f16": torch.randn(4, 2).half(),
        "bf16": torch.randn(6, 3).bfloat16(), "i64": torch.arange(5),
        "scalar": torch.tensor(2.5)}
    t_save(tensors, str(tmp_path / "m.safetensors"), metadata={"k": "v"})
    got = st.load_file(str(tmp_path / "m.safetensors"))
    want = t_load(str(tmp_path / "m.safetensors"))
    assert set(got) == set(want)
    for k, v in want.items():
        w = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    no_bf16 = {k: v for k, v in tensors.items() if k != "bf16"}
    t_save(no_bf16, str(tmp_path / "n.safetensors"))
    same_tree(st.load_file(str(tmp_path / "n.safetensors")),
              np_load(str(tmp_path / "n.safetensors")))
    # the port's writer, read back by the package
    st.save_file({k: v.numpy() for k, v in no_bf16.items()},
                 str(tmp_path / "o.safetensors"))
    same_tree(np_load(str(tmp_path / "o.safetensors")),
              {k: v.numpy() for k, v in no_bf16.items()})


def test_import_encoder_reads_save_pretrained(tmp_path):
    """import_hf_encoder on ``save_pretrained`` dirs of an HF ViT (the
    vit_tiny_patch16_224 preset at 32 px; model.safetensors, then
    pytorch_model.bin): the JAX package's variables, and the CLI writes
    its bytes; an HF ConvNeXt dir from the port's writer reads back to
    the tree it was written from."""
    from transformers import ViTConfig, ViTModel

    torch.manual_seed(0)
    hf = ViTModel(ViTConfig(hidden_size=192, num_hidden_layers=12,
                            num_attention_heads=3, intermediate_size=768,
                            image_size=32, patch_size=16,
                            layer_norm_eps=1e-6)).eval()
    hf.save_pretrained(tmp_path / "st", safe_serialization=True)
    hf.save_pretrained(tmp_path / "bin", safe_serialization=False)
    jv, jname, jsize = j_iw.import_hf_encoder(str(tmp_path / "st"))
    for d in ("st", "bin"):
        v, name, size = import_weights.import_hf_encoder(str(tmp_path / d))
        assert (name, size) == (jname, jsize) == ("vit_tiny_patch16_224", 32)
        same_tree(v, jax.tree.map(np.asarray, dict(jv)))
    from effocr_torch.cli.import_encoder import main

    main(["--model_dir", str(tmp_path / "st"), "--out",
          str(tmp_path / "enc_init.msgpack")])
    j_ckpt.save_variables(jv, str(tmp_path / "j.msgpack"))
    assert (tmp_path / "enc_init.msgpack").read_bytes() == \
        (tmp_path / "j.msgpack").read_bytes()
    # the port's HF ConvNeXt writer, read back
    enc = factory.init_params(factory.create_encoder("convnext_atto"), 3)
    tree = import_weights.sorted_tree(
        state_dict_to_flax(enc.state_dict()))
    writers.write_hf_convnext_dir(str(tmp_path / "w"), tree["params"], 64)
    got, name, size = import_weights.import_hf_encoder(str(tmp_path / "w"))
    assert (name, size) == ("convnext_atto", 64)
    same_tree(got, tree)


# --------------------------------------------------------------- end to end
@pytest.fixture(scope="module")
def reference_artifacts(tmp_path_factory):
    """A reference-format recognizer dir and an ultralytics yolov5n
    ``best.pt``.  The recognizer: an ONNX timm mobilenetv3_small_050 at
    its seeded init (the JAX tests' random state dicts map every input to
    one embedding), and a FAISS index whose rows are its float32
    embeddings of the glyph renders of ``GLYPHS``, so each crop reads as
    the glyph it is nearest to.  The localizer: a full pickle whose detect
    heads have zero weights.  ``infer`` runs the localizer in bfloat16 in
    both packages, and XLA's and torch's bfloat16 convolutions round
    differently; the heads' outputs are their biases exactly (0 x any
    trunk value), so the boxes are one fixed grid in both packages (chars
    from the stride-8 anchor 0, words from the stride-32 anchor 0 at a
    higher score, so max_det keeps them; equal scores within a kind,
    which both keep in index order)."""
    from test_pipeline_e2e import render_char

    root = tmp_path_factory.mktemp("reference")
    loc = factory.create_localizer("yolov5n", 2, in_channels=3)
    factory.init_params(loc, 20)
    with torch.no_grad():
        for i in range(3):
            head = getattr(loc, f"detect{i}")
            head.weight.zero_()
            head.bias.view(3, 7)[:] = torch.tensor([0.0] * 4 + [-8.0] * 3)
        loc.detect0.bias.view(3, 7)[0, 4:] = torch.tensor([3.0, 4.0, -4.0])
        loc.detect2.bias.view(3, 7)[0, 4:] = torch.tensor([4.0, -4.0, 4.0])
    v = state_dict_to_flax(loc.state_dict())
    writers.save_module_pickle(str(root / "best.pt"),
                               writers.ultralytics_yolov5_state_dict(
                                   v["params"], v["batch_stats"],
                                   loc.anchors), epoch=9)
    enc = factory.init_params(factory.create_encoder(
        "mobilenetv3_small_050", dtype=F32), 3).eval()
    v = state_dict_to_flax(enc.state_dict())
    rec = root / "rec"
    rec.mkdir()
    writers.write_onnx(str(rec / "enc_best.onnx"),
                       writers.timm_mobilenetv3_state_dict(
                           v["params"], v["batch_stats"]))
    glyphs = np.stack([np.asarray(render_char(ch).resize((224, 224)),
                                  np.float32) / 255 for ch in GLYPHS])
    with torch.no_grad():
        emb = enc(torch.from_numpy(glyphs)).numpy()
    writers.write_faiss_flat(str(rec / "ref.index"), emb)
    (rec / "ref.txt").write_text("\n".join(GLYPHS) + "\n", encoding="utf-8")
    return root


GLYPHS = "AbXoTk"


def _record_retrieval(monkeypatch):
    """Record, for each retrieval of the port's engine, the crops of its
    valid slots and their embeddings as the retrieval reads them."""
    from effocr_torch.pipelines import infer as pipe

    crops, seen = [], []
    crop = pipe.crop_lines_to_squares
    classify = pipe.EffOCRInference._classify

    def crop_rec(imgs, rects, b, valid, **kw):
        out = crop(imgs, rects, b, valid, **kw)
        crops.append(out[valid])
        return out

    def classify_rec(self, emb, rep=None):
        x = torch.cat(crops)
        crops.clear()
        seen.append((x, emb[:len(x)]))
        return classify(self, emb, rep)

    monkeypatch.setattr(pipe, "crop_lines_to_squares", crop_rec)
    monkeypatch.setattr(pipe.EffOCRInference, "_classify", classify_rec)
    return seen


def test_infer_cli_on_reference_dir_matches_jax(reference_artifacts,
                                                line_paths, tmp_path,
                                                monkeypatch, capsys):
    """``python -m effocr_torch import-reference --localizer_pt best.pt``
    and ``infer --recognizer_dir <reference dir>`` (the hook converts on
    first use) on the CPU against the JAX ``infer`` on its own copy of the
    reference dir and the converted localizer: the same text and COCO
    JSON on the synthetic lines.

    The text is the imported encoder's and the index's: both commands
    build their recognizer in float32 here (their default is bfloat16
    convolutions, whose rounding differs between XLA and torch by more
    than a random encoder's margins), several glyphs are read, and every
    crop's top-1 cosine leads its runner-up by far more than the two
    packages' cosines of that crop differ."""
    from functools import partial

    from effocr_tpu.cli import infer as j_infer
    from effocr_torch.__main__ import main as entry
    from effocr_torch.cli import infer as t_infer

    monkeypatch.setattr(t_infer, "create_encoder",
                        partial(factory.create_encoder, dtype=F32))
    monkeypatch.setattr(j_infer, "create_encoder",
                        partial(j_factory.create_encoder, dtype=jnp.float32))
    seen = _record_retrieval(monkeypatch)
    image_dir = os.path.dirname(line_paths[0])
    images = [{"id": i, "file_name": os.path.basename(p), "text": "x"}
              for i, p in enumerate(line_paths)]
    coco = tmp_path / "coco.json"
    coco.write_text(json.dumps({"images": images, "annotations": []}))
    outs = {}
    for pkg in ("port", "jax"):
        work = tmp_path / pkg
        shutil.copytree(reference_artifacts, work)
        flags = ["--recognizer_dir", str(work / "rec"), "--localizer_dir",
                 str(tmp_path / "port" / "loc"), "--lang", "en",
                 "--image_dir", image_dir, "--coco_json", str(coco),
                 "--line_batch", "4", "--crop_batch", "256",
                 "--localizer_conf_thresh", "0.3",
                 "--localizer_iou_thresh", "0.25", "--max_det", "64",
                 "--max_words", "16", "--save_output", str(work / "out")]
        if pkg == "port":
            monkeypatch.setattr(sys, "argv", [
                "effocr_torch", "import-reference", "--localizer_pt",
                str(work / "best.pt"), "--out", str(work / "loc"),
                *LOC_CANVAS])
            entry()
            assert "localizer converted" in capsys.readouterr().out
            monkeypatch.setattr(sys, "argv", ["effocr_torch", "infer",
                                              *flags, "--device", "cpu"])
            entry()
        else:
            monkeypatch.setattr(sys, "argv", ["infer"] + flags)
            j_infer.main()
        assert "converting reference-format recognizer_dir" in \
            capsys.readouterr().out
        with open(work / "out" / "inference_results.json") as f:
            text = json.load(f)
        with open(work / "out" / "inference_coco.json") as f:
            outs[pkg] = (text, json.load(f))
    text, coco_out = outs["port"]
    assert text == outs["jax"][0]
    assert coco_out == outs["jax"][1]
    assert len(coco_out["annotations"]) > 10 * len(line_paths)
    assert len(set("".join(text.values())) - {" "}) >= 3
    # margins: the port's retrieval cosines against the JAX float32
    # encoder's (its own converted weights) on the same crops
    protos = np.load(tmp_path / "port" / "rec" / "tpu_converted" /
                     "ref.npz")["embeddings"]
    jm = j_factory.create_encoder("mobilenetv3_small_050", dtype=jnp.float32)
    j_vars = read_variables(str(tmp_path / "jax" / "rec" / "tpu_converted" /
                                "enc_best.msgpack"))
    j_fwd = jax.jit(lambda x: jm.apply(j_vars, x, train=False))

    def cosines(emb):
        emb = np.asarray(emb, np.float64)
        return emb / np.linalg.norm(emb, axis=1, keepdims=True) @ protos.T

    margin, gap = np.inf, 0.0
    for crops, emb in seen:
        cos = cosines(emb.numpy())
        top2 = np.sort(cos, axis=1)[:, -2:]
        margin = min(margin, float((top2[:, 1] - top2[:, 0]).min()))
        gap = max(gap, float(np.abs(
            cos - cosines(j_fwd(crops.numpy()))).max()))
    print(f"{sum(len(c) for c, _ in seen)} crops: smallest top-1 margin "
          f"{margin:.3g}, largest port-JAX cosine difference {gap:.3g}")
    assert margin > 20 * gap


# ------------------------------------------------------------------ export
def test_export_reload_parity_and_jax_forward(tmp_path, capsys):
    """export_encoder on the CPU: the reloaded program against the eager
    model (largest |diff| printed; 0 in float32 on this host), and the
    exported float32 program against the JAX encoder's forward at 1e-4."""
    from effocr_torch.cli.export import EXPORTED, export_encoder

    sd = make_timm_convnext_sd(np.random.default_rng(40), *ATTO)
    src = tmp_path / "src"
    _reference_dir(src, sd, 3, 320)
    out_dir = ref.import_reference_recognizer_dir(str(src), image_size=64)
    path = export_encoder(out_dir, batch=2, device="cpu")
    assert path == os.path.join(out_dir, EXPORTED)
    log = capsys.readouterr().out
    assert "parity check passed" in log
    worst = float(log.rsplit("max |reloaded - eager| ", 1)[1].split()[0])
    assert worst <= 1e-6
    # a float32 program against the JAX float32 forward
    model = factory.create_encoder("convnext_atto", dtype=F32)
    model.load_state_dict(flax_to_state_dict(read_variables(
        os.path.join(out_dir, "enc_best.msgpack"))), strict=True)
    x = np.random.default_rng(41).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    program = torch.export.export(model, (torch.from_numpy(x),))
    torch.export.save(program, str(tmp_path / "f32.pt2"))
    with torch.no_grad():
        got = torch.export.load(str(tmp_path / "f32.pt2")).module()(
            torch.from_numpy(x)).numpy()
    jm = j_factory.create_encoder("convnext_atto", dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": j_ref.convert_timm_convnext(sd)}, x))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_export_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    from effocr_torch.cli.export import main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--recognizer_dir", str(tmp_path)])


# ------------------------------------------------------------- command table
def test_command_table_names_the_ported_commands():
    """All 20 of the JAX package's commands route; NOT_PORTED is empty."""
    from effocr_torch import __main__ as entry

    jax_cmds = __import__("effocr_tpu.__main__", fromlist=["main"])
    with open(jax_cmds.__file__) as f:
        src = f.read()
    j_names = set(n for n in (line.split('"')[1] for line in src.splitlines()
                              if line.strip().startswith('"') and ":" in line
                              and "effocr_tpu.cli" in line))
    mine = set(entry.COMMANDS)
    assert mine == j_names
    assert len(mine) == 20
    assert entry.NOT_PORTED == ()
    for name, module in entry.COMMANDS.items():
        assert os.path.exists(os.path.join(
            ROOT, *module.split(".")) + ".py"), name


@pytest.mark.parametrize("name", ["infer", "serve", "train-recognizer",
                                  "train-localizer", "build-index",
                                  "build-freq-dict", "build-homoglyphs",
                                  "import-reference", "import-encoder",
                                  "export", "coco-split", "coco-combine",
                                  "coco-subset", "error-analysis", "viz",
                                  "train-seq2seq", "import-trocr",
                                  "make-corpus", "make-charset",
                                  "format-dataset"])
def test_every_command_answers_help(name, monkeypatch, capsys):
    """``python -m effocr_torch <name> --help`` through the routing table:
    usage printed, exit 0."""
    from effocr_torch import __main__ as entry

    monkeypatch.setattr(sys, "argv", ["effocr_torch", name, "--help"])
    with pytest.raises(SystemExit) as done:
        entry.main()
    assert done.value.code == 0
    assert "usage:" in capsys.readouterr().out


def test_unknown_command_names_what_is_missing(monkeypatch, capsys):
    """An unknown command prints the usage with every command, and no
    'not ported' list (every command of the JAX package routes)."""
    from effocr_torch import __main__ as entry

    monkeypatch.setattr(sys, "argv", ["effocr_torch", "make-corpora"])
    with pytest.raises(SystemExit) as done:
        entry.main()
    assert done.value.code == 1
    out = capsys.readouterr().out
    assert "import-reference" in out and "make-corpus" in out
    assert "format-dataset" in out and "not ported" not in out
