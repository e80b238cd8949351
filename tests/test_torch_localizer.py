"""effocr_torch's localizer training against the JAX package, on the CPU
at small sizes (yolov5n, canvases of 64 x 128, a few targets), with the
same inputs and weights (bridged with interop/flax_bridge.py):

- ``letterbox_host`` (numpy) against ``cv2.resize(INTER_LINEAR)`` +
  ``copyMakeBorder``: sides 1-300 up and down, exact 2x shrinks, 1 and 3
  channels; bytes, ratio and (dw, dh) identical;
- ``DetectionDataset`` ``load`` / ``materialize`` / ``batches`` identical
  on PNGs written by PIL (gray, RGB, palette), 1 and 3 channels, more
  annotations than ``max_targets``, an image with none;
- ``apply_detection_augment`` on draws made with ``jax.random`` from
  ``augment_detection_batch``'s 7 key splits: pixels 1e-5, boxes 1e-4,
  masks identical wherever a clipped side is more than 1e-3 from
  ``min_box_px``;
- ``yolo_loss``: loss and parts 1e-5 relative, the gradient of every raw
  grid within 1e-5 of the largest;
- ``clip_by_global_norm(10)`` + AdamW against the optax chain, 20 steps
  with gradient norms above and below 10: 1e-6 relative;
- ``fit_anchors`` identical;
- one ``make_detector_train_step`` against the JAX step (stream and bank,
  with and without augment on the JAX key's draws): loss 1e-5, new
  batch_stats within 1e-4 of the largest value, gradients within 2e-3 of
  the largest |g| of JAX's and within 1e-4 of a float64-convolution
  evaluation of the same step (JAX's own float32 step strays up to
  1.3e-3 from it);
- ``LocalizerTrainer``: four bank steps at an lr that moves the weights
  more than 1e-3 from init: losses within 2e-3 relative of JAX's trainer
  (a control whose optimizer never steps misses by more than 3e-2), the
  update's cosine with JAX's >= 0.95 and its norm within 1%; ``evaluate``'s
  AP dictionary equal to JAX's on the same weights, best_bbox_mAP.msgpack
  written; ``save``/``resume`` bit for bit; ``--resume`` across packages
  both ways (the JAX trainer's last.msgpack written back bit for bit, a
  resumed step held to the other package's at the trainer test's
  tolerances);
- the CLI: ``train-localizer --device cpu`` (fit_anchors, multi_height,
  resident and stream, augment, test_coco, init_ckpt): model.json equal
  to the JAX command's, the best checkpoint loaded by both packages'
  ``load_engine``, the same text from both engines.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from effocr_tpu.cli import infer as j_infer_cli
from effocr_tpu.core.config import LocalizerConfig as JLocConfig
from effocr_tpu.core.config import LocalizerTrainConfig as JTrainConfig
from effocr_tpu.data.detection import DetectionDataset as JDataset
from effocr_tpu.kernels.det_augment import augment_detection_batch
from effocr_tpu.kernels.image_ops import letterbox_host as j_letterbox
from effocr_tpu.models import create_localizer as j_localizer
from effocr_tpu.train import losses as j_losses
from effocr_tpu.train import checkpoint as j_ckpt
from effocr_tpu.train.localizer import LocalizerTrainer as JTrainer
from effocr_tpu.train.localizer import fit_anchors as j_fit_anchors
from effocr_tpu.train.localizer import make_detector_train_step as j_step
from effocr_torch.cli import infer as t_infer_cli
from effocr_torch.core.config import LocalizerConfig, LocalizerTrainConfig
from effocr_torch.data.detection import DetectionDataset
from effocr_torch.interop.flax_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from effocr_torch.kernels.det_augment import apply_detection_augment
from effocr_torch.kernels.image_ops import cv2_resize_linear, letterbox_host
from effocr_torch.models.factory import (
    create_encoder,
    create_localizer,
    init_params,
)
from effocr_torch.retrieval.index import PrototypeIndex
from effocr_torch.train import checkpoint as ckpt
from effocr_torch.train.localizer import (
    LocalizerTrainer,
    fit_anchors,
    make_detector_train_step,
)
from effocr_torch.train.losses import yolo_loss
from effocr_torch.train.optim import AdamW, warmup_cosine_decay_schedule
from test_torch_train import (  # noqa: F401
    _capture_grads,
    _engine_args,
    _flat,
    _FlaxInitProxy,
    _GradRecorder,
    _np,
    _skip_flax_init,
    _two_threads,
)

F32 = torch.float32
H, W = 64, 128


# ------------------------------------------------------------ letterbox
@pytest.mark.parametrize("channels", [1, 3])
def test_letterbox_host_matches_cv2(channels):
    """The resize against cv2 on random sizes 1-300 (a fifth of them
    exact 2x shrinks, OpenCV's area path), then the letterbox against
    the JAX package's cv2 letterbox at canvases wider, taller and
    smaller than the image."""
    rng = np.random.default_rng(channels)
    for t in range(300):
        if t % 5 == 0:
            oh, ow = (int(v) for v in rng.integers(1, 151, 2))
            h, w = 2 * oh, 2 * ow
        else:
            h, w, oh, ow = (int(v) for v in rng.integers(1, 301, 4))
        img = rng.integers(0, 256, (h, w, channels), np.uint8)
        ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(
            cv2_resize_linear(img, ow, oh), ref.reshape(oh, ow, channels),
            err_msg=f"{w}x{h} -> {ow}x{oh}")
    for t in range(200):
        h, w = (int(v) for v in rng.integers(1, 301, 2))
        shape = [(64, 128), (96, 1024), (32, 32), (max(h // 2, 1),
                                                   max(w // 2, 1)),
                 (h, w)][t % 5]
        img = rng.integers(0, 256, (h, w, channels), np.uint8)
        try:
            ref = j_letterbox(img, shape)
        except cv2.error:             # a side rounds to 0: both refuse
            with pytest.raises(ValueError):
                letterbox_host(img, shape)
            continue
        got = letterbox_host(img, shape)
        assert got[1:] == ref[1:]
        np.testing.assert_array_equal(got[0], ref[0])
    gray = rng.integers(0, 256, (30, 50), np.uint8)      # 2-D input
    np.testing.assert_array_equal(letterbox_host(gray, (64, 128))[0],
                                  j_letterbox(gray[..., None], (64, 128))[0])


# --------------------------------------------------------------- corpus
def _line(rng, n_words=3):
    """A gray line image with dark glyph boxes: (image, char boxes, word
    boxes) in pixels [x, y, w, h]."""
    h = int(rng.integers(20, 40))
    x, chars, words = 4, [], []
    for _ in range(n_words):
        x0 = x
        for _ in range(int(rng.integers(2, 5))):
            gw = int(rng.integers(h // 3, h // 2 + 2))
            chars.append([x, 3, gw, h - 6])
            x += gw + 2
        words.append([x0, 3, x - 2 - x0, h - 6])
        x += h // 2
    img = np.full((h, x + 4), 240, np.uint8)
    for cx, cy, cw, ch in chars:
        img[cy + 2:cy + ch - 2, cx + 1:cx + cw - 1] = rng.integers(0, 60)
    return img, chars, words


def _write_corpus(root, n, seed=0, modes=("L", "RGB", "P")):
    """n line PNGs written by PIL (modes cycling gray, RGB, palette) and
    their COCO: char boxes (category 0), word boxes (category 1),
    ``text``, ``width`` and ``height``; image 1 has no annotations."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    images, annos = [], []
    for i in range(n):
        img, chars, words = _line(rng)
        name = f"line{i}.png"
        rgb = np.stack([img, np.roll(img, 1, 1), img // 2 + 100], -1)
        mode = modes[i % len(modes)]
        pil = Image.fromarray(img) if mode == "L" else Image.fromarray(rgb)
        if mode == "P":
            pil = pil.convert("P")
        pil.save(os.path.join(root, "images", name))
        images.append({"id": i, "file_name": name, "width": img.shape[1],
                       "height": img.shape[0], "text": "ab cd ef"})
        if i == 1:
            continue
        for cat, boxes in ((0, chars), (1, words)):
            for b in boxes:
                annos.append({"id": len(annos), "image_id": i, "bbox": b,
                              "category_id": cat})
    return {"images": images, "annotations": annos}


def _dump(coco, path):
    with open(path, "w") as f:
        json.dump(coco, f)
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loc"))
    coco = _write_corpus(root, 10)
    return root, os.path.join(root, "images"), coco


def _assert_same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
        else:
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


@pytest.mark.parametrize("channels,height,max_targets", [(1, 32, 256),
                                                         (3, None, 5)])
def test_detection_dataset_matches_jax(corpus, channels, height,
                                       max_targets):
    _, image_dir, coco = corpus
    kw = dict(input_size=W, input_height=height, channels=channels,
              max_targets=max_targets)
    ds, jds = DetectionDataset(coco, image_dir, **kw), JDataset(
        coco, image_dir, **kw)
    for i in range(len(ds)):
        _assert_same(ds.load(i), jds.load(i))
    assert ds.load(1)[2].sum() == 0
    if max_targets == 5:
        assert ds.load(0)[2].all()      # capped: more annotations than 5
    _assert_same(ds.materialize(), jds.materialize())
    for kw2 in ({"batch_size": 4, "seed": 3},
                {"batch_size": 4, "shuffle": False, "drop_last": False}):
        got, ref = list(ds.batches(**kw2)), list(jds.batches(**kw2))
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_same(g[:3], r[:3])
            assert len(g[3]) == len(r[3])
            _assert_same(g[3], r[3])


# -------------------------------------------------------------- augment
def jax_det_draws(key, b, h, w, c, flip_p, scale, translate):
    """The draws augment_detection_batch makes from ``key`` (brightness
    and contrast 0.2, noise on), under the names draw_detection_augment
    uses; traced into the program it is compared with."""
    k_s, k_tx, k_ty, k_f, k_b, k_c, k_n = jax.random.split(key, 7)
    uni = jax.random.uniform
    return {
        "scale": uni(k_s, (b,), minval=1.0 - scale, maxval=1.0 + scale),
        "tx": uni(k_tx, (b,), minval=-translate * w, maxval=translate * w),
        "ty": uni(k_ty, (b,), minval=-translate * h, maxval=translate * h),
        "flip": jax.random.bernoulli(k_f, flip_p, (b,)),
        "brightness": uni(k_b, (b, 1, 1, 1), minval=-0.2, maxval=0.2),
        "contrast": 1.0 + uni(k_c, (b, 1, 1, 1), minval=-0.2, maxval=0.2),
        "noise": jax.random.normal(k_n, (b, h, w, c)),
    }


def torch_det_draws(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _targets(rng, b, t, h, w):
    tg = np.zeros((b, t, 5), np.float32)
    tg[..., 0] = rng.integers(0, 2, (b, t))
    tg[..., 1] = rng.uniform(0, w, (b, t))
    tg[..., 2] = rng.uniform(0, h, (b, t))
    tg[..., 3] = rng.uniform(1, w / 3, (b, t))
    tg[..., 4] = rng.uniform(1, h / 1.5, (b, t))
    return tg, rng.uniform(size=(b, t)) < 0.8


@pytest.mark.parametrize("channels,flip_p,scale,translate", [
    (1, 0.5, 0.25, 0.1), (3, 1.0, 0.25, 0.1), (1, 0.0, 0.6, 0.4)])
def test_apply_detection_augment_matches_jax(channels, flip_p, scale,
                                             translate):
    """Flip on (p 1), off (p 0) and mixed; the third case's scale and
    translation push content past the canvas (crop overflow)."""
    rng = np.random.default_rng(channels)
    b, t = 6, 12
    x = rng.uniform(0, 1, (b, H, W, channels)).astype(np.float32)
    tg, mk = _targets(rng, b, t, H, W)
    key = jax.random.PRNGKey(int(flip_p * 10) + channels)
    (ji, jt, jm), draws = jax.jit(lambda x, tg, mk, key: (
        augment_detection_batch(x, tg, mk, key, flip_p=flip_p, scale=scale,
                                translate=translate),
        jax_det_draws(key, b, H, W, channels, flip_p, scale, translate)))(
            x, tg, mk, key)
    ti, tt, tm = apply_detection_augment(
        torch.from_numpy(x), torch.from_numpy(tg), torch.from_numpy(mk),
        torch_det_draws(draws))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                               atol=1e-4)
    jt = np.asarray(jt)
    clear = (np.abs(jt[..., 3] - 2.0) > 1e-3) & (np.abs(jt[..., 4] - 2.0)
                                                 > 1e-3)
    np.testing.assert_array_equal(tm.numpy()[clear], np.asarray(jm)[clear])
    flips = np.asarray(draws["flip"])
    assert flips.all() if flip_p == 1.0 else (not flips.any()
                                              if flip_p == 0.0 else True)
    if translate == 0.4:                 # some boxes cropped away
        assert (np.asarray(jm) < mk).any()


# ----------------------------------------------------------------- loss
ANCHORS = ((10, 13, 16, 30, 33, 23), (30, 61, 62, 45, 59, 119),
           (116, 90, 156, 198, 373, 326))


def _loss_case(nc, seed=0):
    """Raw grids for a 64 x 128 canvas at B = 2, and targets covering the
    tie rule (two targets on one cell), edge cells, masked targets and
    anchor-ratio rejections."""
    rng = np.random.default_rng(seed)
    raw = [rng.normal(0, 1.5, (2, H // s, W // s, 3, 5 + nc)).astype(
        np.float32) for s in (8, 16, 32)]
    tg = np.zeros((2, 10, 5), np.float32)
    boxes = [
        [0, 40.2, 20.3, 12, 18], [1, 41.0, 21.0, 14, 16],   # one cell
        [0, 1.0, 2.0, 8, 10], [1, 127.5, 63.0, 20, 30],     # edges
        [0, 64.0, 32.0, 120, 4],                            # ratio > 4
        [1, 90.5, 40.5, 60, 50], [0, 100.0, 10.0, 30, 30],
        [1, 20.0, 50.0, 10, 10],                            # masked
    ]
    tg[0, :len(boxes)] = boxes
    tg[1, :6] = np.asarray(boxes[2:]) + [0, 3.3, -1.7, 2, 1]
    tg[..., 0] = np.minimum(tg[..., 0], nc - 1)
    mask = np.zeros((2, 10), bool)
    mask[0, :7] = True
    mask[1, :5] = True
    return raw, tg, mask


@pytest.mark.parametrize("nc", [2, 1])
def test_yolo_loss_and_gradients_match(nc):
    raw, tg, mask = _loss_case(nc)

    def jf(r):
        return j_losses.yolo_loss(r, jnp.asarray(tg), jnp.asarray(mask),
                                  ANCHORS, num_classes=nc)

    (jl, jparts), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        [jnp.asarray(r) for r in raw])
    tr = [torch.from_numpy(r).requires_grad_() for r in raw]
    tl, tparts = yolo_loss(tr, torch.from_numpy(tg), torch.from_numpy(mask),
                           ANCHORS, num_classes=nc)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(float(torch.as_tensor(tparts[k]).detach()),
                                   float(jparts[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    gmax = max(float(np.abs(g).max()) for g in jg)
    for t, g in zip(tr, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-5 * gmax)
    # the case holds a matched cell on every scale, and the tie
    assert float(jparts["loss/box"]) > 0


# ------------------------------------------------------------ optimizer
def test_clip_adamw_matches_optax_chain():
    """The JAX trainer's optax.chain(clip_by_global_norm(10), adamw) over
    warmup_cosine_decay_schedule(0, lr, 5, 20) against train/optim.py's
    AdamW(max_grad_norm=10), gradient norms alternating around 10."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 3), (4, 6)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    lr = 1e-2
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, lr, 5, 20),
        weight_decay=5e-4))
    tree = [jnp.asarray(p) for p in params]
    state, update = tx.init(tree), jax.jit(tx.update)
    tp = [torch.tensor(p) for p in params]
    opt = AdamW([(tp, warmup_cosine_decay_schedule(0.0, lr, 5, 20))],
                weight_decay=5e-4, max_grad_norm=10.0)
    norms = []
    for i in range(20):
        g = [(rng.normal(size=s) * (4.0 if i % 2 else 0.3)).astype(
            np.float32) for s in shapes]
        norms.append(np.sqrt(sum(float((a.astype(np.float64) ** 2).sum())
                                 for a in g)))
        u, state = update([jnp.asarray(a) for a in g], state, tree)
        tree = optax.apply_updates(tree, u)
        for p, a in zip(tp, g):
            p.grad = torch.tensor(a)
        opt.step()
    assert min(norms) < 10 < max(norms)
    for got, ref in zip(tp, tree):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=0)


def test_fit_anchors_matches():
    rng = np.random.default_rng(0)
    wh = np.concatenate([rng.uniform(0.5, 40, (200, 2)),
                         rng.uniform(5, 9, (30, 2))]).astype(np.float32)
    for n, seed in ((9, 0), (9, 3), (6, 1)):
        np.testing.assert_array_equal(fit_anchors(wh, n=n, seed=seed),
                                      j_fit_anchors(wh, n=n, seed=seed))
    few = wh[:4]                                 # fewer boxes than anchors
    np.testing.assert_array_equal(fit_anchors(few), j_fit_anchors(few))


# ------------------------------------------------------- one train step
def _cfgs(channels, **kw):
    loc = dict(arch="yolov5n", input_size=W, input_height=H,
               input_channels=channels)
    return (JTrainConfig(localizer=JLocConfig(**loc), **kw),
            LocalizerTrainConfig(localizer=LocalizerConfig(**loc), **kw))


def _models(channels, seed=3):
    """(Flax, torch) float32 yolov5n and the torch init's Flax variables."""
    tm = init_params(create_localizer("yolov5n", 2, in_channels=channels,
                                      dtype=F32), seed)
    variables = jax.tree.map(np.array, state_dict_to_flax(tm.state_dict()))
    return (j_localizer("yolov5n", num_classes=2, dtype=jnp.float32), tm,
            variables)


def _bank(rng, n, channels):
    bank = rng.integers(0, 256, (n, H, W, channels), np.uint8)
    tg, mk = _targets(rng, n, 8, H, W)
    tg[..., 3] = np.minimum(tg[..., 3], 30)
    return bank, tg, mk


def _f64_conv_step(variables, tcfg, channels, *batch):
    """Gradients of the port's bank step with float64 convolutions (and
    detect head) and BatchNorm (layers.BatchNorm keeps float64 input in
    float64): the step's float32 rounding taken out."""
    m = create_localizer("yolov5n", 2, in_channels=channels,
                         dtype=torch.float64)
    m.load_state_dict(flax_to_state_dict(variables))
    m = m.double()
    for mod in m.modules():
        if hasattr(mod, "dtype"):
            mod.dtype = torch.float64
    rec = _GradRecorder(dict(m.named_parameters()))
    make_detector_train_step(m, tcfg, rec, m.anchors, bank_mode=True)(
        *batch)
    return {k: g.double() for k, g in rec.grads.items()}


@pytest.mark.parametrize("channels,augment", [(1, True), (3, False)])
def test_train_step_matches_jax(channels, augment):
    """One JAX program per case (bank mode; augment with the JAX key's
    draws traced into it), held against the port's step in bank mode and
    in stream mode on the gathered batch: loss 1e-5 relative, new
    batch_stats 1e-4 of the largest.  Gradients: within 1e-4 of the
    largest |g| of the same step with float64 convolutions, and within
    2e-3 of JAX's.  (JAX's float32 step on the CPU strays 1e-4 to 1.3e-3
    of the largest |g| from that float64 evaluation on these inputs, the
    port 3e-5 to 6e-5: XLA's convolutions round the early layers'
    long reductions more coarsely.)"""
    rng = np.random.default_rng(channels)
    jcfg, tcfg = _cfgs(channels, augment=augment)
    jm, tm, variables = _models(channels)
    bank, tg, mk = _bank(rng, 6, channels)
    idx = np.asarray([4, 1, 5, 0], np.int32)
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "opt_state": _capture_grads().init(variables["params"])}
    jstep = j_step(jm, jcfg, _capture_grads(), jm.anchors, bank_mode=True)
    args = (bank, tg, mk, idx) + ((np.int32(2),) if augment else ())

    def program(state, *a):
        out = jstep(state, *a)
        if not augment:
            return out, {}
        key = jax.random.fold_in(jax.random.PRNGKey(jcfg.seed + 101), a[-1])
        return out, jax_det_draws(key, 4, H, W, channels, jcfg.aug_flip_p,
                                  jcfg.aug_scale, jcfg.aug_translate)

    (new, jloss, _), draws = jax.jit(program)(state, *args)
    jgrads = flax_to_state_dict({"params": _np(new["opt_state"]["g"])})
    jstats = flax_to_state_dict({"batch_stats": _np(new["batch_stats"])})
    smax = max(float(v.abs().max()) for v in jstats.values())
    tdraws = torch_det_draws(draws) if augment else None
    batch = (torch.from_numpy(bank), torch.from_numpy(tg),
             torch.from_numpy(mk), torch.from_numpy(idx).long(), tdraws)
    ref = _f64_conv_step(variables, tcfg, channels, *batch)
    gmax = max(float(g.abs().max()) for g in ref.values())
    for bank_mode in (True, False):
        tm.load_state_dict(flax_to_state_dict(variables))
        rec = _GradRecorder(dict(tm.named_parameters()))
        step = make_detector_train_step(tm, tcfg, rec, tm.anchors,
                                        bank_mode=bank_mode)
        if bank_mode:
            loss, _ = step(*batch)
        else:
            loss, _ = step(torch.from_numpy(bank[idx]),
                           torch.from_numpy(tg[idx]),
                           torch.from_numpy(mk[idx]), tdraws)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert rec.grads.keys() == jgrads.keys() == ref.keys()
        for k, g in jgrads.items():
            got = rec.grads[k].double()
            np.testing.assert_allclose(got.numpy(), ref[k].numpy(), rtol=0,
                                       atol=1e-4 * gmax, err_msg=k)
            np.testing.assert_allclose(got.numpy(), g.double().numpy(),
                                       rtol=0, atol=2e-3 * gmax, err_msg=k)
        sd = tm.state_dict()
        for k, v in jstats.items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-4 * smax, err_msg=k)


# -------------------------------------------------------------- trainer
def test_trainer_steps_evaluate_resume(corpus, tmp_path):
    """Five bank steps of both trainers (clip + AdamW, warmup 1, lr 2e-3)
    from the same weights: every step's loss within 2e-3 relative of
    JAX's, while a control whose optimizer never steps is off by more
    than 3e-2 from the third on; the update's cosine with JAX's >= 0.95
    and its norm within 1% (Adam turns gradients of rounding-noise size
    into +-lr steps of either sign, element by element, so weights are
    not compared one by one); the optimizer's count and per-step lr
    optax's.  Then evaluate on the same val batches and weights (the AP
    dictionaries equal), and save / resume bit for bit."""
    root, image_dir, coco = corpus
    kw = dict(lr=2e-3, warmup_steps=1, augment=False)
    jcfg, tcfg = _cfgs(1, **kw)
    jm, _, variables = _models(1, seed=4)
    ds_kw = dict(input_size=W, input_height=H, channels=1)
    jds, tds = JDataset(coco, image_dir, **ds_kw), DetectionDataset(
        coco, image_dir, **ds_kw)
    total = 8
    jt = JTrainer(jcfg, jm, str(tmp_path / "jax"), total)
    jt.state = {"params": variables["params"],
                "batch_stats": variables["batch_stats"],
                "opt_state": jt.tx.init(variables["params"])}

    def trainer(d, steps=True):
        t = LocalizerTrainer(tcfg, create_localizer(
            "yolov5n", 2, in_channels=1, dtype=F32), str(tmp_path / d),
            total, device="cpu")
        t.set_variables(variables)
        if not steps:
            t.optimizer.step = lambda: None
        return t

    tt, control = trainer("torch"), trainer("control", steps=False)
    batches = [[0, 2, 4, 6], [1, 3, 5, 7], [8, 9, 0, 1], [2, 3, 8, 9],
               [0, 2, 4, 6]]
    for i, b in enumerate(batches):
        jl = jt.train_step_bank(jds, b)[0]
        tl = float(tt.train_step_bank(tds, b)[0])
        cl = float(control.train_step_bank(tds, b)[0])
        assert abs(tl / jl - 1) <= 2e-3, (i, tl, jl)
        assert i < 2 or abs(cl / jl - 1) > 3e-2, (i, cl, jl)
    assert tt.optimizer.count == 5
    sched = optax.warmup_cosine_decay_schedule(0.0, 2e-3, 1, total)
    lr = tt.optimizer.groups[0][1]
    np.testing.assert_allclose([lr(c) for c in range(5)],
                               [float(sched(c)) for c in range(5)],
                               rtol=1e-6)
    ref = flax_to_state_dict({"params": _np(jt.state["params"])})
    init = flax_to_state_dict(variables)
    sd = tt.model.state_dict()
    dj = torch.cat([(ref[k] - init[k]).flatten() for k in ref]).double()
    dt = torch.cat([(sd[k] - init[k]).flatten() for k in ref]).double()
    assert float(dj.abs().max()) > 1e-3
    assert float(dj @ dt / (dj.norm() * dt.norm())) >= 0.95
    assert abs(float(dt.norm() / dj.norm()) - 1) <= 1e-2

    # evaluate: the same AP dictionary on the same weights
    jt.state["params"] = state_dict_to_flax(
        {k: v for k, v in sd.items() if "running" not in k})["params"]
    jt.state["batch_stats"] = state_dict_to_flax(
        {k: v for k, v in sd.items() if "running" in k})["batch_stats"]
    val = lambda d: [(b[0], b[3]) for b in d.batches(  # noqa: E731
        4, shuffle=False, drop_last=False)]
    jres, tres = jt.evaluate(val(jds)), tt.evaluate(val(tds))
    assert jres == tres, (jres, tres)
    best = tmp_path / "torch" / "best_bbox_mAP.msgpack"
    assert best.exists()
    loaded = ckpt.load_variables(str(best))
    for k, v in flax_to_state_dict(loaded).items():
        assert torch.equal(v, sd[k]), k

    # save / resume: a fresh trainer continues bit for bit
    tt.save()
    resumed = trainer("torch")
    resumed.init_state(123)
    assert resumed.resume()
    for t in (tt, resumed):
        t.train_step_bank(tds, batches[0])
    a, b = tt.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert resumed.optimizer.count == tt.optimizer.count == 6


def test_resume_crosses_packages(corpus, tmp_path):
    """A run started by either package resumes in the other: the JAX
    trainer's last.msgpack after two bank steps (clip + AdamW, warmup 1)
    loads into the port's trainer, which writes it back bit for bit for
    the JAX loader; one step of the port from it against the JAX step
    from its own state, then one JAX step from the port's last.msgpack
    against the port's step from its own state: loss 2e-3 relative, Adam's
    new moments 2e-3 of their largest |value| and the update's cosine
    with JAX's >= 0.95 and its norm within 1% (the tolerances of
    test_trainer_steps_evaluate_resume and of the step test's 2e-3
    against JAX's coarser float32 convolutions), the count equal."""
    root, image_dir, coco = corpus
    jcfg, tcfg = _cfgs(1, lr=2e-3, warmup_steps=1, augment=False)
    jm, _, variables = _models(1, seed=4)
    ds_kw = dict(input_size=W, input_height=H, channels=1)
    jds, tds = JDataset(coco, image_dir, **ds_kw), DetectionDataset(
        coco, image_dir, **ds_kw)
    jt = JTrainer(jcfg, jm, str(tmp_path / "jax"), 8)
    jt.state = {"params": variables["params"],
                "batch_stats": variables["batch_stats"],
                "opt_state": jt.tx.init(variables["params"])}
    batches = [[0, 2, 4, 6], [1, 3, 5, 7], [8, 9, 0, 1], [2, 3, 8, 9]]
    for b in batches[:2]:
        jt.train_step_bank(jds, b)
    jt.save("last")
    tt = LocalizerTrainer(tcfg, create_localizer(
        "yolov5n", 2, in_channels=1, dtype=F32), str(tmp_path / "jax"), 8,
        device="cpu")
    tt.init_state(123)                       # overwritten by the resume
    assert tt.resume() and tt.optimizer.count == 2
    tt.run_dir = str(tmp_path / "torch")
    tt.save("last")
    port_last = str(tmp_path / "torch" / "last.msgpack")
    back = _flat(_np(j_ckpt.load_train_state(jt.state, port_last)))
    orig = _flat(_np(jt.state))
    assert back.keys() == orig.keys()
    for k, v in orig.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k

    def check(jold, told, jloss, tloss):
        assert abs(float(tloss) / jloss - 1) <= 2e-3
        got = _flat(ckpt.train_state(tt.model, tt.optimizer, clip=True))
        want = _flat(_np(jt.state))
        assert got.keys() == want.keys()
        for part in ("/mu/", "/nu/"):
            keys = [k for k in want if part in k]
            vmax = max(float(np.abs(want[k]).max()) for k in keys)
            for k in keys:
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=2e-3 * vmax, err_msg=k)
        assert {int(v) for k, v in want.items() if k.endswith("count")} \
            == {tt.optimizer.count}
        keys = [k for k in want if k.startswith("params/")]
        dj = np.concatenate([(want[k] - jold[k]).ravel() for k in keys])
        dt = np.concatenate([(got[k] - told[k]).ravel() for k in keys])
        assert np.abs(dj).max() > 1e-4
        assert dj @ dt / (np.linalg.norm(dj) * np.linalg.norm(dt)) >= 0.95
        assert abs(np.linalg.norm(dt) / np.linalg.norm(dj) - 1) <= 1e-2

    # the port resumed JAX's file; JAX steps from its own state
    jold = _flat(jt.state)
    told = _flat(ckpt.train_state(tt.model, tt.optimizer, clip=True))
    jloss = jt.train_step_bank(jds, batches[2])[0]
    check(jold, told, jloss, tt.train_step_bank(tds, batches[2])[0])
    # JAX resumes the port's file; the port steps from its own state
    tt.save("last")
    assert _jax_resume(jt, port_last)
    jold = _flat(jt.state)
    told = _flat(ckpt.train_state(tt.model, tt.optimizer, clip=True))
    jloss = jt.train_step_bank(jds, batches[3])[0]
    check(jold, told, jloss, tt.train_step_bank(tds, batches[3])[0])


def _jax_resume(jt, path):
    """The JAX trainer's ``resume`` on a file outside its run dir."""
    run_dir, jt.run_dir = jt.run_dir, os.path.dirname(path)
    try:
        return jt.resume(os.path.splitext(os.path.basename(path))[0])
    finally:
        jt.run_dir = run_dir


def test_trainer_refuses_other_families(tmp_path):
    """The FCOS and two-stage families are no longer refused (their steps
    are held to JAX in test_torch_families.py): the step builds without
    anchors, and the CLI takes ``--arch fcos_s`` / ``rcnn_s``, writes
    model.json with null anchors, and goes on to read its COCO files.
    Without a GPU and without ``--device cpu`` the CLI still raises
    before writing anything."""
    from effocr_torch.cli import train_localizer

    assert callable(make_detector_train_step(None, _cfgs(1)[1], None, None))
    for arch in ("fcos_s", "rcnn_s"):
        run = tmp_path / arch
        with pytest.raises(FileNotFoundError):
            train_localizer.main(["--device", "cpu", "--image_dir", "x",
                                  "--train_coco", str(tmp_path / "a.json"),
                                  "--val_coco", "b", "--run_name", str(run),
                                  "--arch", arch])
        with open(run / "model.json") as f:
            meta = json.load(f)
        assert meta["arch"] == arch and meta["anchors"] is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_localizer.main(["--image_dir", "x", "--train_coco", "a",
                                  "--val_coco", "b", "--run_name",
                                  str(tmp_path / "never")])
        assert not (tmp_path / "never").exists()


# ------------------------------------------------------------------ CLI
def _rec_dir(root):
    """A random mobilenetv3_small_050 recognizer (1 channel, 32 px) with
    a 3-row index."""
    d = os.path.join(root, "rec")
    os.makedirs(d, exist_ok=True)
    enc = init_params(create_encoder("mobilenetv3_small_050",
                                     in_channels=1), 7)
    ckpt.save_variables(state_dict_to_flax(enc.state_dict()),
                        os.path.join(d, "enc_best.msgpack"))
    with open(os.path.join(d, "model.json"), "w") as f:
        json.dump({"arch": "mobilenetv3_small_050", "image_size": 32,
                   "input_channels": 1, "crop_geometry": "tight"}, f)
    PrototypeIndex(np.random.default_rng(8).normal(size=(3, 1024)).astype(
        np.float32), list("abc")).save(d)
    return d


def _f32_engines(monkeypatch):
    """Both load_engines build float32 models (bfloat16 convolutions
    round differently in the two packages, which moves detections near
    the threshold); the JAX one skips its eager Flax init."""
    _skip_flax_init(monkeypatch, jnp.float32)
    j_loc = j_localizer
    monkeypatch.setattr(j_infer_cli, "create_localizer", lambda a, **kw: (
        _FlaxInitProxy(j_loc(a, dtype=jnp.float32, **kw),
                       lambda c: create_localizer(a, in_channels=c, **kw))))
    t_loc, t_enc = t_infer_cli.create_localizer, t_infer_cli.create_encoder
    monkeypatch.setattr(t_infer_cli, "create_localizer",
                        lambda a, **kw: t_loc(a, dtype=F32, **kw))
    monkeypatch.setattr(t_infer_cli, "create_encoder",
                        lambda a, **kw: t_enc(a, dtype=F32, **kw))


def test_cli_train_localizer_matches_jax(corpus, tmp_path, monkeypatch):
    from effocr_tpu.cli import train_localizer as j_cli
    from effocr_torch.cli import train_localizer

    root, image_dir, coco = corpus
    train = _dump({"images": coco["images"][:8], "annotations": [
        a for a in coco["annotations"] if a["image_id"] < 8]},
        str(tmp_path / "train.json"))
    val = _dump({"images": coco["images"][8:], "annotations": [
        a for a in coco["annotations"] if a["image_id"] >= 8]},
        str(tmp_path / "val.json"))
    base = ["--image_dir", image_dir, "--train_coco", train, "--val_coco",
            val, "--arch", "yolov5n", "--input_size", str(W),
            "--multi_height", "32,64", "--input_channels", "1",
            "--fit_anchors", "--batch_size", "4", "--num_epochs", "2",
            "--lr", "2e-3", "--test_coco", val]
    run = str(tmp_path / "resident")
    train_localizer.main(["--device", "cpu", "--run_name", run,
                          "--data_device", "resident", "--augment", *base])
    for name in ("args_log.json", "model.json", "best_bbox_mAP.msgpack",
                 "last.msgpack", "metrics.jsonl"):
        assert os.path.exists(os.path.join(run, name)), name
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["epoch/height"] for r in recs if "epoch/height" in r] == [32,
                                                                       64]
    assert any("test/bbox/AP" in r for r in recs)
    assert all(np.isfinite(r["train/loss"]) for r in recs
               if "train/loss" in r)

    stream = str(tmp_path / "stream")
    train_localizer.main(["--device", "cpu", "--run_name", stream,
                          "--init_ckpt", os.path.join(
                              run, "best_bbox_mAP.msgpack"), *base])

    # the JAX command's model.json for the same flags (its trainer
    # stubbed out: model.json is written before training)
    class NoTrainer:
        def __init__(self, *a, **k):
            raise SystemExit(0)

    monkeypatch.setattr(j_cli, "LocalizerTrainer", NoTrainer)
    jrun = str(tmp_path / "jax")
    monkeypatch.setattr("sys.argv", ["x", "--run_name", jrun, *base])
    with pytest.raises(SystemExit):
        j_cli.main()
    for d in (run, stream):
        with open(os.path.join(d, "model.json")) as f, \
                open(os.path.join(jrun, "model.json")) as g:
            assert json.load(f) == json.load(g)
    with open(os.path.join(run, "args_log.json")) as f:
        args_log = json.load(f)
    with open(os.path.join(jrun, "args_log.json")) as g:
        j_args = json.load(g)
    assert args_log.keys() == j_args.keys()

    # both loaders read the best checkpoint; both engines read the same
    rec = _rec_dir(str(tmp_path))
    flags = ("--localizer_conf_thresh", "0.05")
    _f32_engines(monkeypatch)
    t_engine = t_infer_cli.load_engine(_engine_args(
        t_infer_cli.add_engine_args, rec, run, "--device", "cpu", *flags))
    j_engine = j_infer_cli.load_engine(_engine_args(
        j_infer_cli.add_engine_args, rec, run, *flags))
    tv = {k: v.float() for k, v in t_engine.localizer.state_dict().items()}
    jv = flax_to_state_dict(jax.tree.map(
        lambda x: np.asarray(x, np.float32), j_engine.localizer_vars))
    assert tv.keys() == jv.keys()
    assert all(torch.equal(tv[k], jv[k]) for k in tv)
    paths = [os.path.join(image_dir, im["file_name"])
             for im in coco["images"][:4]]
    assert t_engine.run(paths) == j_engine.run(paths)
