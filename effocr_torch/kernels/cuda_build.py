"""Build a CUDA source of ``csrc/`` into a shared library with a plain C
interface (nvcc, sm_90a), for the ctypes wrappers of the kernels.

Libraries go to the git-ignored ``csrc/build/`` and are rebuilt when the
source is newer; nvcc's ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside each one as ``<name>_ptxas.txt``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return nvcc


def build_library(source: str, name: str, flags: Sequence[str] = ()) -> str:
    """Compile ``csrc/<source>`` for sm_90a into ``csrc/build/
    libeffocr_<name>.so`` unless an up-to-date one exists; returns its
    path.  Raises RuntimeError with nvcc's output when the build fails."""
    src = os.path.join(CSRC, source)
    lib = os.path.join(BUILD_DIR, f"libeffocr_{name}.so")
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build into a temp file and rename: a concurrent loader never sees a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", *flags, "-Xptxas", "-v", "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp, src]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stderr}{res.stdout}")
        with open(os.path.join(BUILD_DIR, f"{name}_ptxas.txt"), "w") as f:
            f.write(res.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib
