"""effocr_torch stands alone: no JAX, no Flax, nothing of effocr_tpu.

In a fresh interpreter where importing ``jax``, ``flax``, ``optax``,
``msgpack``, ``PIL``, ``pytesseract``, ``cv2``, ``safetensors``,
``transformers``, ``timm``, ``onnx``, ``onnxruntime`` or ``faiss`` fails, every module of
effocr_torch (the training slice's data, train and CLI modules included)
and chip_smoke.py (imported, not run) must import, the artifact
importers must read what the port's writers write (FAISS, ONNX,
safetensors, a full module pickle), and no ``effocr_tpu`` module may get
loaded.  Entry points with the
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
                 "onnx", "onnxruntime", "faiss"):
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
    for name in ("safetensors", "transformers", "timm", "onnx",
                 "onnxruntime", "faiss"):
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
