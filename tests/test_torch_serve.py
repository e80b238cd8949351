"""``python -m effocr_torch serve``: the continuous-batching loop of
cli/serve.py on the torch engine, held against the JAX package's.

The JAX package's serve_loop and the port's run on the same engines
(tests/test_serve.py's FakeEngine), requests and fake clock: request
order, the latency flush driven by poll ticks and bad-item isolation
give the same emitted (key, text) pairs and engine batches; each
package's _watch_requests gates the same directory on a stable size.
One run feeds each loop its own CPU engine (the JAX engine and the port
on the same weights): identical text.  The CLI answers paths on stdin
from a subprocess with the same texts as an in-process engine built from
the same flags, and logs each batch it cut.
"""

import argparse
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from effocr_tpu.cli import serve as j_serve
from effocr_tpu.core.config import (
    LocalizerConfig as JLocalizerConfig,
    PipelineConfig as JPipelineConfig,
)
from effocr_tpu.pipelines.infer import EffOCRInference as JEngine
from effocr_tpu.retrieval.index import PrototypeIndex as JIndex
from effocr_torch.cli.infer import add_engine_args, load_engine
from effocr_torch.cli.serve import _watch_requests, serve_loop
from effocr_torch.interop.flax_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from effocr_torch.interop.flax_msgpack import write_variables
from effocr_torch.models.factory import (
    create_encoder,
    create_localizer,
    init_params,
)
from effocr_torch.pipelines.infer import EffOCRInference
from effocr_torch.retrieval.index import PrototypeIndex
from test_serve import FakeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both_loops(make_engine, requests, **kw):
    """Each package's serve_loop on its own engine from ``make_engine``
    and the same requests (a callable, fresh for each run): the
    (key, text) pairs each emitted, and each engine."""
    out = []
    for loop in (j_serve.serve_loop, serve_loop):
        engine, emitted = make_engine(), []
        served = loop(engine, requests(), lambda k, t: emitted.append((k, t)),
                      stats_out=None, **kw)
        out.append((served, emitted, engine))
    return out


def test_serve_loop_batches_and_order():
    reqs = [(f"k{i}", f"path{i}") for i in range(5)]
    (js, jem, jeng), (ts, tem, teng) = _both_loops(
        FakeEngine, lambda: iter(reqs), batch_size=2)
    assert ts == js == 5 and teng.batches == jeng.batches == [2, 2, 1]
    assert tem == jem
    assert [k for k, _ in tem] == [f"k{i}" for i in range(5)]


def test_serve_loop_isolates_bad_items():
    class Flaky(FakeEngine):
        def run(self, imgs):
            if any(im == "bad" for im in imgs):
                raise OSError("cannot decode")
            return super().run(imgs)

    reqs = [("k0", "p0"), ("k1", "bad"), ("k2", "p2")]
    (js, jem, jeng), (ts, tem, teng) = _both_loops(
        Flaky, lambda: iter(reqs), batch_size=3)
    assert ts == js == 3 and tem == jem
    assert dict(tem) == {"k0": "text-p0", "k1": "", "k2": "text-p2"}
    assert teng.batches == jeng.batches == [1, 1]   # re-ran item by item


def test_serve_loop_latency_flush():
    clock = [0.0]

    def requests():
        clock[0] = 0.0
        yield ("a", "pa")
        clock[0] += 0.03
        yield None                # 0.03 s: under the 0.05 s cap
        clock[0] += 0.03
        yield None                # 0.06 s: past it -> flush [1]
        yield ("b", "pb")
        yield ("c", "pc")         # batch_size 2 -> flush [2]

    (js, jem, jeng), (ts, tem, teng) = _both_loops(
        FakeEngine, requests, batch_size=2, max_latency_s=0.05,
        now=lambda: clock[0])
    assert ts == js == 3 and teng.batches == jeng.batches == [1, 2]
    assert tem == jem and [k for k, _ in tem] == ["a", "b", "c"]


def test_watch_requests_stable_size_gating(tmp_path):
    """Each package's watcher on its own copy of one directory: a file is
    yielded once its size holds across two polls (a file still growing
    waits), other extensions never; both yield the same names."""
    got = []
    for name, watch in (("jax", j_serve._watch_requests),
                        ("torch", _watch_requests)):
        d = tmp_path / name
        d.mkdir()
        (d / "a.png").write_bytes(b"x" * 10)
        (d / "notes.txt").write_bytes(b"skip")
        seen, ticks = [], 0
        for item in watch(str(d), poll_s=0.01):
            if item is None:
                ticks += 1
                if ticks == 1:
                    assert seen == []
                    (d / "a.png").write_bytes(b"x" * 20)
                if ticks >= 6:
                    break
            else:
                seen.append(os.path.relpath(item[0], d))
        got.append(seen)
    assert got[1] == got[0] == ["a.png"]


def test_serve_loop_on_a_cpu_engine():
    """Each package's loop on its own engine (the canvas oracle and tiny
    encoder of tests/test_torch_pipeline.py, the same weights and
    prototypes): both emit the same (key, text) pairs in request order,
    and the port's are what its ``engine.run`` returns."""
    from test_pipeline_e2e import CHARS, make_line
    from test_torch_pipeline import (
        JaxOracle,
        TinyEncoder,
        TorchTinyEncoder,
        torch_oracle,
    )

    from effocr_torch.core.config import LocalizerConfig, PipelineConfig

    rng = np.random.default_rng(30)
    j_enc = TinyEncoder()
    j_vars = j_enc.init(jax.random.PRNGKey(1), jnp.zeros((1, 224, 224, 3)))
    t_enc = TorchTinyEncoder(28 * 28)
    t_enc.load_state_dict(flax_to_state_dict(j_vars), strict=True)
    protos = rng.normal(size=(6, 64)).astype(np.float32)
    loc = dict(input_size=256, input_height=64, iou_thresh=0.25, max_nms=64,
               max_det=32)
    kw = dict(lang="en", line_batch=2, crop_batch=32)
    engines = {
        j_serve.serve_loop: lambda: JEngine(
            JPipelineConfig(localizer=JLocalizerConfig(**loc), **kw),
            JaxOracle(), {}, j_enc, j_vars, JIndex(protos, CHARS)),
        serve_loop: lambda: EffOCRInference(
            PipelineConfig(localizer=LocalizerConfig(**loc), **kw),
            torch_oracle, t_enc, PrototypeIndex(protos, CHARS),
            device="cpu"),
    }
    imgs = [make_line(t)[0] for t in ("AbX oT", "kXo", "bA X", "ToX b",
                                      "oT")]
    emitted = {}
    for loop, make in engines.items():
        engine, out = make(), []
        served = loop(engine, ((f"r{i}", im) for i, im in enumerate(imgs)),
                      lambda k, t: out.append((k, t)), batch_size=2,
                      stats_out=None)
        assert served == 5
        emitted[loop] = out
    assert emitted[serve_loop] == emitted[j_serve.serve_loop]
    ref = engine.run(imgs)
    assert emitted[serve_loop] == [(f"r{i}", ref[i]) for i in range(5)]
    assert any(t for _, t in emitted[serve_loop])


def _artifacts(root):
    """Random-init gray yolov5n + mobilenetv3_small_050 directories in the
    JAX package's format, with 12 random prototypes."""
    loc_dir, rec_dir = root / "loc", root / "rec"
    loc_dir.mkdir()
    rec_dir.mkdir()
    loc = init_params(create_localizer("yolov5n", 2, in_channels=1), 31)
    # objectness and char-class biases up so random features pass the
    # confidence threshold somewhere
    with torch.no_grad():
        loc.detect0.bias.view(3, 7)[:, 4:6] += 3.0
    write_variables(state_dict_to_flax(loc.state_dict()),
                    str(loc_dir / "best_bbox_mAP.msgpack"))
    with open(loc_dir / "model.json", "w") as f:
        json.dump({"arch": "yolov5n", "num_classes": 2, "input_size": 256,
                   "input_height": 64, "input_channels": 1}, f)
    enc = init_params(create_encoder("mobilenetv3_small_050", 1), 32)
    write_variables(state_dict_to_flax(enc.state_dict()),
                    str(rec_dir / "enc_best.msgpack"))
    with open(rec_dir / "model.json", "w") as f:
        json.dump({"arch": "mobilenetv3_small_050", "image_size": 64,
                   "num_classes": None, "input_channels": 1,
                   "crop_geometry": "tight"}, f)
    rng = np.random.default_rng(33)
    PrototypeIndex(rng.normal(size=(12, 1024)).astype(np.float32),
                   list("abcdefghijkl")).save(str(rec_dir))
    return str(loc_dir), str(rec_dir)


def test_serve_cli_answers_stdin(tmp_path):
    """``python -m effocr_torch serve --stdin --device cpu`` in a
    subprocess: one JSON line per path, in order, with the texts of an
    in-process engine loaded from the same flags."""
    loc_dir, rec_dir = _artifacts(tmp_path)
    rng = np.random.default_rng(34)
    paths = []
    for i, w in enumerate((300, 520, 180)):
        p = str(tmp_path / f"s{i}.png")
        img = np.full((40, w), 240, np.uint8)
        img[8:32, 10:w - 10:7] = rng.integers(0, 60)
        Image.fromarray(img).save(p)
        paths.append(p)
    flags = ["--recognizer_dir", rec_dir, "--localizer_dir", loc_dir,
             "--lang", "en", "--device", "cpu", "--line_batch", "2",
             "--crop_batch", "64", "--spell_check"]
    out = subprocess.run(
        [sys.executable, "-m", "effocr_torch", "serve", "--stdin",
         "--max_latency_ms", "50", *flags],
        input="\n".join(paths) + "\n", cwd=ROOT, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    answers = [json.loads(ln) for ln in out.stdout.splitlines()
               if ln.startswith("{")]
    assert [a["path"] for a in answers] == paths
    assert "served 3 lines" in out.stderr
    batches = [int(ln.rsplit(" ", 1)[1]) for ln in out.stderr.splitlines()
               if ln.startswith("serve: batch of ")]
    assert sum(batches) == 3 and max(batches) <= 2
    p = argparse.ArgumentParser()
    add_engine_args(p)
    ref = load_engine(p.parse_args(flags)).run(paths)
    assert [a["text"] for a in answers] == [ref[p] for p in paths]
