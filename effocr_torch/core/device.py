"""Device selection and float32 precision for the port's entry points.

Entry points take an explicit ``device`` that defaults to ``"cuda"``; a
CUDA request on a machine without a visible GPU raises instead of running
on the CPU, so a CPU run only ever happens when the caller asked for it.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def use_full_f32() -> None:
    """Turn TF32 off for float32 matmuls and cuDNN convolutions.

    The JAX reference computes the ROI-crop einsums, the retrieval matmul
    and the f32 detect head in full float32; TF32 (cuDNN's default for
    convolutions) keeps ~10 mantissa bits and would move retrieval
    margins and box decodes.  bf16 convolutions are unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device`` without making the host wait for the
    device (pinned memory, an asynchronous copy); a CPU device takes it
    as it is."""
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
