"""effocr_torch stands alone: no JAX, no Flax, nothing of effocr_tpu.

In a fresh interpreter where importing ``jax``, ``flax``, ``optax``,
``msgpack``, ``PIL``, ``pytesseract``, ``cv2``, ``safetensors``,
``transformers``, ``tokenizers``, ``sentencepiece``, ``regex``, ``timm``,
``onnx``, ``onnxruntime``, ``faiss``, ``fontTools``, ``freetype``,
``zstandard``, ``pyzstd`` or ``backports.zstd`` fails, every module of
effocr_torch (the training slice's data, train and CLI modules included)
and chip_smoke.py (imported, not run) must import, the artifact
importers must read what the port's writers write (FAISS, ONNX,
safetensors, a full module pickle), the glyph renderer must draw text
and write a make-corpus line and the TIFF reader decode ZSTD and LZMA
files without loading any shared library named like FreeType,
HarfBuzz, raqm or Pillow's bundled libraries (libzstd among them), and no
``effocr_tpu`` module may get loaded.  Entry points with the
default device (the engine, ``serve``'s engine loading) must raise when
CUDA is absent instead of running on the CPU.
"""

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARD = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys
    for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "PIL",
                 "pytesseract", "cv2", "safetensors", "transformers", "timm",
                 "onnx", "onnxruntime", "faiss", "tokenizers",
                 "sentencepiece", "regex", "fontTools", "freetype",
                 "zstandard", "pyzstd", "backports.zstd"):
        sys.modules[name] = None
    import effocr_torch
    # Python modules only: the built native libraries sit in the tree too
    names = [m.name for m in pkgutil.walk_packages(
        effocr_torch.__path__, "effocr_torch.")
        if importlib.util.find_spec(m.name).origin.endswith(".py")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    # the importers, on what the writers write
    import os, tempfile
    import numpy as np
    from effocr_torch.interop import reference_artifacts as ref
    from effocr_torch.interop import reference_writers as w
    from effocr_torch.interop.flax_bridge import state_dict_to_flax
    from effocr_torch.interop.yolo_import import import_ultralytics_localizer
    from effocr_torch.models import factory, import_weights
    d = tempfile.mkdtemp()
    enc = factory.create_encoder("mobilenetv3_small_050")
    v = state_dict_to_flax(enc.state_dict())
    os.makedirs(d + "/rec")
    w.write_onnx(d + "/rec/enc_best.onnx", w.timm_mobilenetv3_state_dict(
        v["params"], v["batch_stats"]))
    w.write_faiss_flat(d + "/rec/ref.index", np.eye(2, 1024, dtype="f4"))
    open(d + "/rec/ref.txt", "w").write("a" + chr(10) + "b")
    assert ref.maybe_convert_reference_dir(d + "/rec").endswith(
        "tpu_converted")
    cnx = state_dict_to_flax(factory.create_encoder(
        "convnext_atto").state_dict())
    w.write_hf_convnext_dir(d + "/hf", cnx["params"], 64)
    assert import_weights.import_hf_encoder(d + "/hf")[1] == "convnext_atto"
    loc = factory.create_localizer("yolov5n")
    v = state_dict_to_flax(loc.state_dict())
    w.save_module_pickle(d + "/best.pt", w.ultralytics_yolov5_state_dict(
        v["params"], v["batch_stats"], loc.anchors))
    import_ultralytics_localizer(d + "/best.pt", d + "/loc")
    # the TrOCR import: an HF tokenizer's vocab.json + merges.txt, and a
    # fairseq pickle read through the allowlist
    import json, torch
    from effocr_torch.baselines.tokenizer import load_tokenizer
    from effocr_torch.baselines import trocr_import
    os.makedirs(d + "/tok")
    json.dump({"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "a": 4, "b": 5,
               "ab": 6}, open(d + "/tok/vocab.json", "w"))
    open(d + "/tok/merges.txt", "w").write("#version: 0.2" + chr(10)
                                           + "a b" + chr(10))
    tok = load_tokenizer(d + "/tok")
    assert tok("ab").input_ids == [0, 6, 2], tok("ab").input_ids
    assert tok.decode([0, 6, 4, 2], skip_special_tokens=True) == "aba"
    torch.save({"model": {"decoder.embed_tokens.weight": torch.zeros(1)}},
               d + "/fs.pt")
    try:
        trocr_import.import_fairseq_checkpoint(d + "/fs.pt")
    except ValueError as e:
        assert "no encoder.deit" in str(e), e
    else:
        raise AssertionError("a non-fairseq pickle was accepted")
    # the glyph renderer: text, a corpus line, no font library loaded
    from effocr_torch.cli import make_corpus
    from effocr_torch.data import fonts as F
    fdir = os.path.join("tests", "torch_fixtures", "fonts")
    font = F.truetype(os.path.join(fdir, "DejaVuSerif.ttf"), 32)
    assert F.draw_single_char("g", font, 32).shape == (32, 32)
    make_corpus.main(["--out_dir", d + "/corpus", "--font_dir", fdir,
                      "--n_lines", "2", "--blur_sigma", "1"])
    # the TIFF codecs with decoders of their own (ZSTD) or the standard
    # library's (LZMA)
    from effocr_torch.data import tiff
    cdir = os.path.join("tests", "torch_fixtures", "images", "compressions")
    for name in ("zstd_pred2.tif", "lzma.tif"):
        with open(os.path.join(cdir, name), "rb") as f:
            assert tiff.decode(f.read())[0].shape == (23, 41), name
    with open("/proc/self/maps") as f:
        maps = f.read().lower()
    for lib in ("freetype", "harfbuzz", "raqm", "pillow.libs"):
        assert lib not in maps, lib
    for name in ("safetensors", "transformers", "timm", "onnx",
                 "onnxruntime", "faiss", "tokenizers", "sentencepiece",
                 "regex", "fontTools", "freetype", "PIL", "zstandard",
                 "pyzstd", "backports.zstd"):
        assert sys.modules[name] is None, name
    leaked = sorted(k for k in sys.modules if k.startswith("effocr_tpu"))
    assert not leaked, leaked
    print(len(names))
""")


def test_port_imports_without_jax_or_reference_package():
    out = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 50


def test_no_advice_to_run_the_jax_package():
    """No message of the port tells a user to run ``effocr_tpu`` (the GPU
    machine has no JAX)."""
    offenders = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "effocr_torch")):
        for name in files:
            if name.endswith((".py", ".cpp", ".cu", ".h")):
                path = os.path.join(dirpath, name)
                with open(path, encoding="utf-8") as f:
                    if "-m effocr_tpu" in f.read():
                        offenders.append(path)
    assert not offenders


def test_default_device_raises_without_cuda():
    import torch

    from effocr_torch.core.config import PipelineConfig
    from effocr_torch.core.device import resolve_device
    from effocr_torch.pipelines.infer import EffOCRInference
    from effocr_torch.retrieval.index import PrototypeIndex
    import numpy as np

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    index = PrototypeIndex(np.eye(3, dtype=np.float32), list("abc"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EffOCRInference(PipelineConfig(), lambda x: x, lambda x: x, index)
    # the serve CLI loads its engine on the default device: it raises
    # before reading any artifact
    from effocr_torch.cli.serve import main as serve_main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--stdin", "--recognizer_dir", "missing",
                    "--localizer_dir", "missing", "--lang", "en"])
    assert resolve_device("cpu").type == "cpu"
