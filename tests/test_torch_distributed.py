"""effocr_torch's data-parallel training (core/distributed.py) against the
JAX package's mesh, on the CPU: N gloo ranks, each a process of its own
on a free port, compute what one rank computes on the whole batch, and
what JAX computes on a 2-device mesh (tests/conftest.py gives JAX 8 host
devices).

- ``initialize_multihost``: the cases of tests/test_distributed.py with
  torchrun's environment in place of the TPU pod's, and the backend rule;
- one recognizer step (mobilenetv3_small_050 at 64 px, 1 channel,
  batch 8, m 2, bank mode, augmentation and the aux head on) on 2 ranks against JAX's ``make_train_step`` on the 2-device mesh
  and the 1-rank port: loss 1e-5 relative; gradients after DDP's
  averaging and the new batch_stats 1e-4 of the largest;
- one yolov5n step (augmentation on) the same way: gradients 2e-3 of the
  largest against JAX's mesh step and 1e-4 against a float64 evaluation
  and against 1 rank; loss 1e-5 relative;
- FCOS and R-CNN losses on 2 ranks with the positives split unevenly
  against 1 rank on the whole batch: 1e-6 relative; the whole steps:
  loss 1e-5, gradients 1e-4 of the largest;
- ``train-recognizer`` / ``train-localizer`` (float32 models) on 2 ranks
  (torchrun's environment) against 1 process: the final parameters
  within 2e-4 (the JAX package's bound for its mesh,
  tests/test_trainers.py), the Adam
  moments within 1e-4 of the largest, the logged losses 1e-4;
- the two-process dry run: digests bit-identical.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effocr_tpu.core.config import EncoderConfig as JEncoderConfig
from effocr_tpu.core.config import RecognizerTrainConfig as JTrainConfig
from effocr_tpu.core.mesh import make_mesh
from effocr_tpu.train.localizer import make_detector_train_step as j_det_step
from effocr_tpu.train.recognizer import make_train_step as j_make_step
from effocr_torch.core import distributed, dryrun
from effocr_torch.core.config import EncoderConfig, RecognizerTrainConfig
from effocr_torch.interop.flax_bridge import flax_to_state_dict
from effocr_torch.models.factory import (
    create_encoder,
    create_localizer,
    init_params,
)
from effocr_torch.train import checkpoint as ckpt
from test_torch_data import char_tree, jax_draws, torch_draws  # noqa: F401
from test_torch_localizer import (  # noqa: F401
    H,
    W,
    _bank,
    _cfgs,
    _dump,
    _f64_conv_step,
    _models,
    _write_corpus,
    jax_det_draws,
    torch_det_draws,
)
from test_torch_train import (  # noqa: F401
    _capture_grads,
    _np,
    _seeded_vars,
    _split_files,
    _step_models,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mesh2():
    return make_mesh(jax.devices("cpu")[:2], model=1)


# ------------------------------------------------------ initialize_multihost
@pytest.fixture
def init_calls(monkeypatch):
    for k in distributed.TORCHRUN_ENV + ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    return calls


def test_initialize_multihost_noop_on_single_process(init_calls):
    """No torchrun environment -> no-op."""
    assert distributed.initialize_multihost(device="cpu") is False
    assert init_calls == []


def test_initialize_multihost_noop_on_partial_environment(init_calls,
                                                          monkeypatch):
    """A LOCAL_RANK alone (no WORLD_SIZE / MASTER_ADDR) -> still a no-op."""
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("RANK", "0")
    assert distributed.initialize_multihost(device="cpu") is False
    assert init_calls == []


def test_initialize_multihost_joins_from_torchrun_env(init_calls,
                                                      monkeypatch):
    """torchrun's environment -> env:// with its world size and rank; on
    the CPU the backend is gloo."""
    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
                     LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="29511").items():
        monkeypatch.setenv(k, v)
    assert distributed.initialize_multihost(device="cpu") is True
    [(backend, kw)] = init_calls
    assert backend == "gloo" and kw["init_method"] == "env://"
    assert (kw["world_size"], kw["rank"]) == (2, 1)


def test_initialize_multihost_explicit_args(init_calls):
    """Explicit coordinator / rank always initialise, whatever the env."""
    assert distributed.initialize_multihost(
        coordinator_address="127.0.0.1:1234", num_processes=2,
        process_id=1, device="cpu") is True
    [(backend, kw)] = init_calls
    assert backend == "gloo" and kw["init_method"] == "tcp://127.0.0.1:1234"
    assert (kw["world_size"], kw["rank"]) == (2, 1)


@pytest.mark.parametrize("device,ranks,cards,backend", [
    ("cuda", 2, 2, "nccl"), ("cuda", 1, 1, "nccl"), ("cuda", 2, 1, "gloo"),
    ("cuda", 8, 4, "gloo"), ("cpu", 2, 0, "gloo")])
def test_backend_rule(monkeypatch, device, ranks, cards, backend):
    """NCCL when every rank has a card of its own, else gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert distributed.choose_backend(device, ranks) == backend


def test_rank_slices_and_padding():
    assert distributed.rank_slice(8) == (0, 8)
    assert distributed.pad_batch_to_data_axis(7, 2) == 8
    assert distributed.pad_batch_to_data_axis(8, 4) == 8


# ------------------------------------------------------------ step parity
def _compare(ref, got, gtol, stol, what):
    gmax = max(float(g.abs().max()) for g in ref["grads"].values())
    assert ref["grads"].keys() == got["grads"].keys()
    for k, g in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][k].double().numpy(),
                                   g.double().numpy(), rtol=0,
                                   atol=gtol * gmax, err_msg=f"{what} {k}")
    if ref["buffers"]:
        smax = max(float(v.abs().max()) for v in ref["buffers"].values())
        for k, v in ref["buffers"].items():
            np.testing.assert_allclose(got["buffers"][k].numpy(),
                                       v.numpy(), rtol=0, atol=stol * smax,
                                       err_msg=f"{what} {k}")


def _ranks_agree(ranks):
    """Every rank ends with the same loss, gradients and statistics."""
    r0 = ranks[0]
    for r in ranks[1:]:
        assert r["loss"] == r0["loss"]
        for k in r0["grads"]:
            assert torch.equal(r["grads"][k], r0["grads"][k]), k
        for k in r0["buffers"]:
            assert torch.equal(r["buffers"][k], r0["buffers"][k]), k


def test_recognizer_step_two_ranks_matches_jax_mesh():
    rng = np.random.default_rng(1)
    arch, b, size, n_cls = "mobilenetv3_small_050", 8, 64, 4
    cfg_kw = dict(batch_size=b, m_per_class=2, lang="en", crop_sim=0.5,
                  paired_jitter=0.5, aux_ce_weight=1.0)
    jcfg = JTrainConfig(encoder=JEncoderConfig(arch=arch, image_size=size,
                                               input_channels=1), **cfg_kw)
    tcfg = RecognizerTrainConfig(encoder=EncoderConfig(
        arch=arch, image_size=size, input_channels=1), **cfg_kw)
    jm, tm = _step_models(arch, 1)
    variables, dim = _seeded_vars(arch, 1, 3, tm)
    w = rng.normal(size=(n_cls, dim)).astype(np.float32)
    bank_u8 = rng.integers(0, 256, (12, size, size), np.uint8)
    bank_u8[:, :, :12] = 255
    bank_t = rng.integers(0, n_cls, 12).astype(np.int32)
    bank_p = rng.uniform(size=12) < 0.4
    idx = rng.permutation(12)[:b].astype(np.int32)
    key = jax.random.PRNGKey(11)

    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "aux": {"w": jnp.asarray(w)}}
    state["opt_state"] = _capture_grads().init(
        {"model": state["params"], "aux": state["aux"]})
    jstep = j_make_step(jm, jcfg, _capture_grads(), False, mesh=_mesh2(),
                        use_aux=True, bank_mode=True)
    new, jloss = jstep(state, bank_u8, bank_t, bank_p, idx, key)
    draws = jax.jit(lambda k: jax_draws(k, b, size, "en", False, 0.5,
                                        0.5))(key)
    jgrads = _np(new["opt_state"]["g"])
    ref = {"grads": {**flax_to_state_dict({"params": jgrads["model"]}),
                     "aux": torch.from_numpy(np.array(jgrads["aux"]["w"]))},
           "buffers": flax_to_state_dict(
               {"batch_stats": _np(new["batch_stats"])})}

    tm.load_state_dict(flax_to_state_dict(variables))
    spec = dict(kind="recognizer", model=tm, cfg=tcfg, bank=True,
                batch=(bank_u8, bank_t.astype(np.int64), bank_p,
                       idx.astype(np.int64)),
                draws=torch_draws(draws), aux=torch.from_numpy(w))
    one = dryrun.run_step(spec)
    two = dryrun.run_ranks(spec, 2, timeout_s=TIMEOUT)
    _ranks_agree(two)
    for got, what in ((one, "1 rank"), (two[0], "2 ranks")):
        np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)
        _compare(ref, got, 1e-4, 1e-4, f"{what} vs JAX mesh")
    np.testing.assert_allclose(two[0]["loss"], one["loss"], rtol=1e-5)
    _compare(one, two[0], 1e-4, 1e-4, "2 ranks vs 1")


@pytest.mark.parametrize("channels", [1])
def test_localizer_step_two_ranks_matches_jax_mesh(channels):
    rng = np.random.default_rng(channels)
    jcfg, tcfg = _cfgs(channels, augment=True)
    jm, tm, variables = _models(channels)
    bank, tg, mk = _bank(rng, 6, channels)
    idx = np.asarray([4, 1, 5, 0], np.int32)
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "opt_state": _capture_grads().init(variables["params"])}
    jstep = j_det_step(jm, jcfg, _capture_grads(), jm.anchors, mesh=_mesh2(),
                       bank_mode=True)
    new, jloss, _ = jstep(state, bank, tg, mk, idx, np.int32(2))
    key = jax.random.fold_in(jax.random.PRNGKey(jcfg.seed + 101), 2)
    draws = torch_det_draws(jax.jit(lambda k: jax_det_draws(
        k, 4, H, W, channels, jcfg.aug_flip_p, jcfg.aug_scale,
        jcfg.aug_translate))(key))
    jref = {"grads": flax_to_state_dict(
        {"params": _np(new["opt_state"]["g"])}),
        "buffers": flax_to_state_dict(
            {"batch_stats": _np(new["batch_stats"])})}
    batch = (torch.from_numpy(bank), torch.from_numpy(tg),
             torch.from_numpy(mk), torch.from_numpy(idx).long(), draws)
    f64 = {"grads": _f64_conv_step(variables, tcfg, channels, *batch),
           "buffers": {}}

    tm.load_state_dict(flax_to_state_dict(variables))
    spec = dict(kind="localizer", model=tm, cfg=tcfg, bank=True,
                batch=(bank, tg, mk, idx.astype(np.int64)), draws=draws)
    one = dryrun.run_step(spec)
    two = dryrun.run_ranks(spec, 2, timeout_s=TIMEOUT)
    _ranks_agree(two)
    for got, what in ((one, "1 rank"), (two[0], "2 ranks")):
        np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)
        _compare(jref, got, 2e-3, 1e-4, f"{what} vs JAX mesh")
        _compare(f64, got, 1e-4, 0, f"{what} vs float64")
    np.testing.assert_allclose(two[0]["loss"], one["loss"], rtol=1e-5)
    _compare(one, two[0], 1e-4, 1e-4, "2 ranks vs 1")


@pytest.mark.parametrize("arch", ["fcos_n", "rcnn_n"])
def test_family_losses_two_ranks_uneven_positives(arch):
    """Rank 0's two images hold 12 targets, rank 1's one: per-rank
    denominators would weigh them apart.  The loss on the same raw
    outputs (the model's, in train mode) split over 2 ranks against 1
    rank: 1e-6 relative, its parts too; then a whole step, where the
    BatchNorm sums' order moves the R-CNN's proposals (queue 3 of the
    roadmap): loss 1e-5 relative, gradients and statistics 1e-4."""
    from effocr_torch.core.config import LocalizerConfig, LocalizerTrainConfig

    rng = np.random.default_rng(5)
    b, h, w = 4, 64, 128
    imgs = rng.integers(0, 255, (b, h, w, 1), np.uint8)
    tg = np.zeros((b, 8, 5), np.float32)
    mk = np.zeros((b, 8), bool)
    for i, n in enumerate((6, 6, 1, 0)):
        cx = rng.uniform(12, w - 12, n)
        cy = rng.uniform(16, h - 16, n)
        tg[i, :n] = np.stack([rng.integers(0, 2, n), cx, cy,
                              rng.uniform(6, 20, n), rng.uniform(10, 28, n)],
                             1)
        mk[i, :n] = True
    cfg = LocalizerTrainConfig(localizer=LocalizerConfig(
        arch=arch, input_size=w, input_height=h, input_channels=1),
        batch_size=b)
    model = init_params(create_localizer(arch, 2, in_channels=1,
                                         dtype=torch.float32), 4)
    with torch.no_grad():
        raw = model.train()(torch.from_numpy(imgs).float() / 255.0,
                            decode=False)
    specs = [dict(kind="loss", loss=arch[:4], raw=raw, targets=(tg, mk)),
             dict(kind="localizer", model=model, cfg=cfg, bank=False,
                  batch=(imgs, tg, mk), draws=None)]
    one = [dryrun.run_step(s) for s in specs]
    two = dryrun.run_ranks(specs, 2, timeout_s=TIMEOUT)
    assert two[0][0]["local_loss"] != two[1][0]["local_loss"]
    assert (two[0][0]["loss"], two[0][0]["parts"]) == (
        two[1][0]["loss"], two[1][0]["parts"])
    np.testing.assert_allclose(two[0][0]["loss"], one[0]["loss"], rtol=1e-6)
    for k, v in one[0]["parts"].items():
        np.testing.assert_allclose(two[0][0]["parts"][k], v, rtol=1e-6,
                                   err_msg=k)
    _ranks_agree([r[1] for r in two])
    np.testing.assert_allclose(two[0][1]["loss"], one[1]["loss"], rtol=1e-5)
    _compare(one[1], two[0][1], 1e-4, 1e-4, f"{arch} 2 ranks vs 1")


# ------------------------------------------------------------- the CLIs
# the CLIs with float32 models (the JAX package's mesh tests use float32;
# in bfloat16 each rank's weight gradients round on their own)
F32_CLI = """
import functools, sys, torch
from effocr_torch.cli import train_localizer, train_recognizer
for mod, name in ((train_recognizer, "create_encoder"),
                  (train_localizer, "create_localizer")):
    setattr(mod, name, functools.partial(getattr(mod, name),
                                         dtype=torch.float32))
{"train-recognizer": train_recognizer,
 "train-localizer": train_localizer}[sys.argv[1]].main(sys.argv[2:])
"""


def _f32_cli(monkeypatch, command, args):
    """One process, in this one."""
    from effocr_torch.cli import train_localizer, train_recognizer

    mod, name = {"train-recognizer": (train_recognizer, "create_encoder"),
                 "train-localizer": (train_localizer, "create_localizer")}[
        command]
    monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                     dtype=torch.float32))
    mod.main(args)


def _ranks_cli(tmp_path, command, args, nproc=2):
    """``nproc`` ranks started by torchrun, as the CLIs start them."""
    script = os.path.join(str(tmp_path), "f32_cli.py")
    with open(script, "w") as f:
        f.write(F32_CLI)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        distributed.torchrun_argv(nproc, [script, command] + args),
        capture_output=True, text=True, timeout=TIMEOUT, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


def _flat(tree, prefix=""):
    """{path: array} of the numeric leaves of a train state."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, np.ndarray) and v.dtype.kind == "f":
            out[f"{prefix}{k}"] = v
    return out


def _compare_runs(single, ranks, ptol=2e-4, mtol=1e-4):
    a = ckpt.load_train_state(os.path.join(single, "last.msgpack"))
    b = ckpt.load_train_state(os.path.join(ranks, "last.msgpack"))
    pa, pb = _flat(a["model"]), _flat(b["model"])
    assert pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_allclose(pb[k], pa[k], rtol=0, atol=ptol,
                                   err_msg=k)
    ma, mb = _flat(a["opt"]["mu"]), _flat(b["opt"]["mu"])
    big = max(float(np.abs(v).max()) for v in ma.values())
    for k in ma:
        np.testing.assert_allclose(mb[k], ma[k], rtol=0, atol=mtol * big,
                                   err_msg=k)
    recs = []
    for d in (single, ranks):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            recs.append([json.loads(ln) for ln in f])
    return pa, pb, recs


def test_train_recognizer_two_ranks_matches_one(char_tree,  # noqa: F811
                                                tmp_path, monkeypatch):
    """The JAX package's mesh test's recipe (convnext_atto at 64 px,
    batch 6, m 2, one epoch, lr 1e-3, no augmentation): the parameters
    move ~1e-3 a step, 5x the tolerance."""
    tr, va, te = _split_files(str(tmp_path))
    args = ["--device", "cpu", "--root_dir_path", char_tree,
            "--train_ann_path", tr, "--val_ann_path", va,
            "--test_ann_path", te, "--auto_model", "convnext_atto",
            "--imsize", "64", "--batch_size", "6", "--m", "2",
            "--num_epochs", "1", "--lr", "1e-3", "--no_aug", "--lang", "en",
            "--data_device", "resident", "--infer_hardneg_k", "2"]
    single = str(tmp_path / "one")
    _f32_cli(monkeypatch, "train-recognizer", args + ["--run_name", single])
    ranks = str(tmp_path / "two")
    _ranks_cli(tmp_path, "train-recognizer", args + ["--run_name", ranks])
    pa, _, (ra, rb) = _compare_runs(single, ranks)
    init = init_params(create_encoder("convnext_atto", dtype=torch.float32),
                       RecognizerTrainConfig().seed).state_dict()
    moved = max(float(np.abs(pa[k] - init[k].numpy()).max()) for k in pa
                if k in init)
    assert moved > 1e-3
    va_a = [r["val/accuracy"] for r in ra if "val/accuracy" in r]
    va_b = [r["val/accuracy"] for r in rb if "val/accuracy" in r]
    assert va_a == va_b
    np.testing.assert_allclose(
        [r["train/loss"] for r in rb if "train/loss" in r],
        [r["train/loss"] for r in ra if "train/loss" in r], rtol=1e-4)
    for name in ("ref.npz", "ref.txt", "hns.txt", "enc_best.msgpack"):
        assert os.path.exists(os.path.join(ranks, name)), name
    with open(os.path.join(single, "hns.txt")) as f, \
            open(os.path.join(ranks, "hns.txt")) as g:
        assert f.read() == g.read()


def test_train_localizer_two_ranks_matches_one(tmp_path, monkeypatch):
    root = str(tmp_path)
    coco = _write_corpus(root, 10, seed=3)
    train = _dump({"images": coco["images"][:8], "annotations": [
        a for a in coco["annotations"] if a["image_id"] < 8]},
        os.path.join(root, "train.json"))
    val = _dump({"images": coco["images"][8:], "annotations": [
        a for a in coco["annotations"] if a["image_id"] >= 8]},
        os.path.join(root, "val.json"))
    args = ["--device", "cpu", "--image_dir", os.path.join(root, "images"),
            "--train_coco", train, "--val_coco", val, "--arch", "yolov5n",
            "--input_size", "128", "--input_height", "64",
            "--input_channels", "1", "--batch_size", "4", "--num_epochs",
            "2", "--lr", "2e-3", "--data_device", "resident", "--augment",
            "--eval_period", "2"]
    single = os.path.join(root, "one")
    _f32_cli(monkeypatch, "train-localizer", args + ["--run_name", single])
    ranks = os.path.join(root, "two")
    _ranks_cli(tmp_path, "train-localizer", args + ["--run_name", ranks])
    _, _, (ra, rb) = _compare_runs(single, ranks)
    for key in ("train/loss", "loss/box", "loss/obj", "loss/cls"):
        np.testing.assert_allclose([r[key] for r in rb if key in r],
                                   [r[key] for r in ra if key in r],
                                   rtol=1e-4, err_msg=key)
    aps = [[r["bbox/AP50"] for r in recs if "bbox/AP50" in r]
           for recs in (ra, rb)]
    assert len(aps[0]) == 1 and aps[0] == aps[1]


def test_two_process_dryrun():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "effocr_torch.core.dryrun", "--nproc", "2",
         "--device", "cpu"], capture_output=True, text=True, timeout=TIMEOUT,
        env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dryrun_multihost OK" in proc.stdout, proc.stdout
