"""effocr_torch stands alone: no JAX, no Flax, nothing of effocr_tpu.

In a fresh interpreter where importing ``jax`` or ``flax`` fails, every
module of effocr_torch and chip_smoke.py (imported, not run) must import,
and no ``effocr_tpu`` module may get loaded.  Entry points with the
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
    for name in ("jax", "jaxlib", "flax", "msgpack", "PIL", "cv2"):
        sys.modules[name] = None
    import effocr_torch
    # Python modules only: the built native libraries sit in the tree too
    names = [m.name for m in pkgutil.walk_packages(
        effocr_torch.__path__, "effocr_torch.")
        if importlib.util.find_spec(m.name).origin.endswith(".py")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    leaked = sorted(k for k in sys.modules if k.startswith("effocr_tpu"))
    assert not leaked, leaked
    print(len(names))
""")


def test_port_imports_without_jax_or_reference_package():
    out = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


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
