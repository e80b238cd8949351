"""External-OCR comparator hooks (the JAX package's utils/comparators.py).

Tesseract, Google Cloud Vision and Baidu, as the reference compares
against them.  The cloud hooks build the REST request and parse the
response exactly as the JAX package does, through an injectable
``transport`` (the default urllib transport is only touched when none
is given), with credentials from arguments or the environment, never
from the source.  Tesseract runs the ``tesseract`` binary itself on a
PNG from the port's writer (``tesseract <png> stdout -l <lang> --psm
7``, the command pytesseract builds), since pytesseract imports Pillow;
where the binary is absent it is skipped, as in the JAX package.
"""

from __future__ import annotations

import base64
import json as _json
import os
import shutil
import subprocess
import tempfile
import urllib.parse
import urllib.request
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from effocr_torch.data import png

# transport(url, body_bytes, headers) -> decoded-JSON dict.  Injectable so
# the request/response protocol is unit-testable without network access.
Transport = Callable[[str, bytes, Dict[str, str]], dict]


def _urllib_transport(url: str, body: bytes, headers: Dict[str, str]) -> dict:
    req = urllib.request.Request(url, data=body, headers=headers)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return _json.loads(resp.read().decode("utf-8"))


def tesseract_available() -> bool:
    """Whether a ``tesseract`` binary is on PATH and answers --version."""
    exe = shutil.which("tesseract")
    if exe is None:
        return False
    try:
        return subprocess.run([exe, "--version"], capture_output=True,
                              timeout=30).returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False


def run_tesseract(image: np.ndarray, lang: str = "eng",
                  psm: int = 7) -> str:
    """Single-text-line Tesseract OCR (psm 7 = treat as one line) of a
    uint8 image, written as PNG to a temporary file."""
    with tempfile.TemporaryDirectory() as d:
        path = png.write(os.path.join(d, "line.png"),
                         np.asarray(image, np.uint8))
        out = subprocess.run(
            [shutil.which("tesseract") or "tesseract", path, "stdout",
             "-l", lang, "--psm", str(psm)],
            capture_output=True, check=True, timeout=300)
    return out.stdout.decode("utf-8").strip()


def run_gcv(
    image_bytes: bytes,
    api_key: str,
    lang: str = "ja",
    transport: Optional[Transport] = None,
) -> str:
    """Google Cloud Vision document OCR: an ``images:annotate`` request
    with DOCUMENT_TEXT_DETECTION and the language hint, reading
    ``fullTextAnnotation.text`` back."""
    body = _json.dumps({
        "requests": [{
            "image": {"content": base64.b64encode(image_bytes).decode()},
            "features": [{"type": "DOCUMENT_TEXT_DETECTION"}],
            "imageContext": {"languageHints": [lang]},
        }]
    }).encode("utf-8")
    url = ("https://vision.googleapis.com/v1/images:annotate?key="
           + urllib.parse.quote(api_key))
    out = (transport or _urllib_transport)(
        url, body, {"Content-Type": "application/json"})
    resp = out.get("responses", [{}])[0]
    if "error" in resp:
        raise RuntimeError(f"GCV error: {resp['error']}")
    return resp.get("fullTextAnnotation", {}).get("text", "")


def baidu_access_token(
    api_key: str,
    secret_key: str,
    transport: Optional[Transport] = None,
) -> str:
    """OAuth client-credentials exchange for the Baidu OCR API."""
    url = ("https://aip.baidubce.com/oauth/2.0/token?"
           + urllib.parse.urlencode({
               "grant_type": "client_credentials",
               "client_id": api_key, "client_secret": secret_key}))
    out = (transport or _urllib_transport)(url, b"", {})
    if "access_token" not in out:
        raise RuntimeError(f"Baidu token exchange failed: {out}")
    return out["access_token"]


def run_baidu(
    image_bytes: bytes,
    access_token: str,
    request_url: str = "https://aip.baidubce.com/rest/2.0/ocr/v1/accurate_basic",
    lang: str = "JAP",
    transport: Optional[Transport] = None,
) -> str:
    """Baidu accurate_basic OCR: a form-encoded POST of the base64 image
    and language_type, the ``words_result`` words joined back."""
    params = urllib.parse.urlencode({
        "image": base64.b64encode(image_bytes).decode(),
        "language_type": lang,
    }).encode("utf-8")
    url = f"{request_url}?access_token={urllib.parse.quote(access_token)}"
    out = (transport or _urllib_transport)(
        url, params, {"content-type": "application/x-www-form-urlencoded"})
    if "error_code" in out:
        raise RuntimeError(f"Baidu OCR error: {out}")
    return "".join(x["words"] for x in out.get("words_result", []))


def png_bytes(image: np.ndarray) -> bytes:
    """An image array as PNG bytes for the cloud hooks."""
    return png.encode(np.asarray(image, np.uint8))


def compare_ocr(
    images: Sequence[np.ndarray],
    gts: Sequence[str],
    lang: str = "eng",
    gcv_api_key: Optional[str] = None,
    baidu_access_token: Optional[str] = None,
    transport: Optional[Transport] = None,
) -> Dict[str, Tuple[float, float]]:
    """Run the available comparators over (image, gt) pairs; returns
    {name: (accuracy, cer)} by textline_evaluation.  Tesseract runs when
    its binary exists, the cloud comparators when their credentials are
    given."""
    from effocr_torch.eval.textline import textline_evaluation

    cloud_lang = {"eng": "en", "jpn": "ja"}.get(lang, lang)
    out: Dict[str, Tuple[float, float]] = {}
    if tesseract_available():
        pairs = [(gt, run_tesseract(im, lang=lang))
                 for im, gt in zip(images, gts)]
        out["tesseract"] = textline_evaluation(pairs)
    if gcv_api_key:
        pairs = [(gt, run_gcv(png_bytes(im), gcv_api_key, lang=cloud_lang,
                              transport=transport).strip())
                 for im, gt in zip(images, gts)]
        out["gcv"] = textline_evaluation(pairs)
    if baidu_access_token:
        pairs = [(gt, run_baidu(png_bytes(im), baidu_access_token,
                                lang="JAP" if lang == "jpn" else "ENG",
                                transport=transport).strip())
                 for im, gt in zip(images, gts)]
        out["baidu"] = textline_evaluation(pairs)
    return out
