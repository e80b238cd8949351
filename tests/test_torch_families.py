"""effocr_torch's other model families (ViT / XCiT encoders, the FCOS and
Faster R-CNN localizers) against the JAX package, on the CPU at small
sizes, with the same inputs and weights (bridged with
interop/flax_bridge.py):

- the registries: every one of the JAX factory's 11 encoders and 7
  localizers builds, and each new one's Flax variables tree
  (``jax.eval_shape`` of its init) loads into the port's module strictly,
  name for name and shape for shape;
- forwards in float32: XCiT (dim 32, depth 2, heads 4, cls_depth 1, 32 px,
  1 channel), ViT (3 channels), mobilenetv3_small_100 and the
  ``ProjectionHead`` at rtol 1e-4 / atol 1e-5; in bfloat16 (the JAX
  engine casts every float32 leaf, the port casts the module) within 3e-2
  of the largest |embedding|; FCOS and R-CNN (width 0.25, depth 0.33,
  128 px) decoded outputs at 1e-5 on probabilities and 1e-3 px on boxes;
- ``decode_fcos``, ``level_anchors``, ``apply_deltas`` and
  ``boxes_to_deltas`` at 1e-6 (``decode_fcos``'s box coordinates at 4e-6
  relative: the two libraries' softplus differ in the last bit);
  ``roi_align`` at 1e-5, one image and a batch, boxes on all three
  levels and past the canvas;
- the RPN keep mask bit for bit against ``nms_mask(presorted=False)``,
  through both of ``rpn_keep``'s routes (the sort -> ``nms_keep`` ->
  scatter route the card runs, and plain), on synthetic candidates with
  tied scores and degenerate boxes and on the JAX model's own
  candidates, whose proposals then match bit for bit;
- ``fcos_loss`` / ``rcnn_loss`` at 1e-5 relative, their gradients with
  respect to the raw outputs within 1e-5 of the largest;
- one train step per family (FCOS and R-CNN through
  ``make_detector_train_step``, an XCiT recognizer through
  ``make_train_step``), at the localizer tests' tolerances: loss 1e-5
  relative, gradients within 2e-3 of the largest |g| of JAX's and within
  1e-4 of a float64 evaluation of the same step (the R-CNN's at the
  float32 step's proposals and ReLU gates, which rounding moves in
  both packages);
- the bridge both ways, exact, and a port-written checkpoint read by the
  JAX loader;
- the en engine in float32 with each new family (FCOS and R-CNN
  localizers with a tiny encoder; an XCiT recognizer with the oracle
  localizer) on the synthetic DejaVu lines: text identical to the JAX
  engine's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from effocr_tpu.kernels.nms import nms_mask as j_nms_mask
from effocr_tpu.models import factory as j_factory
from effocr_tpu.models import fcos as j_fcos
from effocr_tpu.models import rcnn as j_rcnn
from effocr_tpu.models import vit as j_vit
from effocr_tpu.train import checkpoint as j_ckpt
from effocr_torch.interop.flax_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from effocr_torch.interop.flax_msgpack import write_variables
from effocr_torch.models import factory, fcos, rcnn, vit
from effocr_torch.models.factory import init_params
from test_torch_pipeline import line_paths  # noqa: F401
from test_torch_train import _np, _two_threads  # noqa: F401

F32 = torch.float32
XCIT_KW = dict(patch=8, dim=32, depth=2, heads=4, cls_depth=1)
VIT_KW = dict(patch=8, dim=32, depth=2, heads=4)
DET_KW = dict(depth_multiple=0.33, width_multiple=0.25)
RCNN_KW = dict(num_proposals=32, pre_nms_topk=32)


def port_vars(model, seed):
    """Flax variables of a seeded port-side init of ``model`` (cheaper
    than a JAX init, which compiles), with every bias, BatchNorm and
    LayerNorm affine, BatchNorm statistics, layer scale and XCA
    temperature drawn away from their init, so no leaf is trivial."""
    init_params(model, seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias":
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            elif p.dim() == 1 or leaf in ("temperature",):
                p.copy_(0.5 + torch.rand(p.shape, generator=g))
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    return _np(state_dict_to_flax(model.state_dict()))


def _loaded(model, variables):
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model.eval()


def _bf16(variables):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), variables)


# -------------------------------------------------------------- registry
def _eval_shape_vars(jm, shape):
    tree = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                          jax.ShapeDtypeStruct(shape, jnp.float32))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)


# one width of each architecture this slice ports (the *_tiny / *_n
# twins differ in widths only; the older ones are held at full width by
# test_torch_models.py)
NEW_ARCHS = ["mobilenetv3_small_100", "vit_small_patch16_224",
             "xcit_small_12_p8_224", "fcos_s", "rcnn_s"]


def test_registry_builds_every_arch():
    """The port's registries hold the JAX factory's 11 encoders and 7
    localizers, and each builds (the transformers at 224 px)."""
    assert set(factory.ENCODER_REGISTRY) == set(j_factory.ENCODER_REGISTRY)
    assert set(factory.LOCALIZER_REGISTRY) == set(
        j_factory.LOCALIZER_REGISTRY)
    assert len(factory.ENCODER_REGISTRY) == 11
    assert len(factory.LOCALIZER_REGISTRY) == 7
    for name in factory.ENCODER_REGISTRY:
        assert factory.create_encoder(name, in_channels=1).out_features > 0
    for name in factory.LOCALIZER_REGISTRY:
        m = factory.create_localizer(name, in_channels=1)
        assert hasattr(m, "num_proposals") == name.startswith("rcnn")


@pytest.mark.parametrize("arch", ["fcos_s", "rcnn_s"])
def test_anchor_free_families_refuse_anchors_in_both(arch):
    """``train-localizer --fit_anchors`` passes fitted anchors to the
    constructor; the FCOS and R-CNN constructors take none, in the JAX
    package (a fault of the reference, ROADMAP queue 3) and, mirrored,
    in the port."""
    anchors = ((10, 13, 16, 30, 33, 23),) * 3
    with pytest.raises(TypeError):
        j_factory.create_localizer(arch, anchors=anchors)
    with pytest.raises(TypeError):
        factory.create_localizer(arch, anchors=anchors)


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_registry_arch_loads_flax_tree(name):
    """Each new architecture's Flax variables tree (``jax.eval_shape`` of
    its init: 224 px for the transformers, whose token grid sets ``pos``;
    1 channel) loads into the port's module strictly, name for name and
    shape for shape."""
    if name in j_factory.ENCODER_REGISTRY:
        jm = j_factory.create_encoder(name, dtype=jnp.float32)
        tm = factory.create_encoder(name, in_channels=1, image_size=224)
        shape = (1, 224, 224, 1) if name in factory.SIZED_ENCODERS else (
            1, 32, 32, 1)
    else:
        jm = j_factory.create_localizer(name, dtype=jnp.float32)
        tm = factory.create_localizer(name, in_channels=1)
        shape = (1, 64, 64, 1)
    tm.load_state_dict(flax_to_state_dict(_eval_shape_vars(jm, shape)),
                       strict=True)


# -------------------------------------------------------------- encoders
def _encoder_pair(kind, channels, dtype):
    jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
    if kind == "xcit":
        return (j_vit.XCiT(dtype=jdt, **XCIT_KW),
                vit.XCiT(image_size=32, in_channels=channels, dtype=dtype,
                         **XCIT_KW))
    if kind == "vit":
        return (j_vit.ViT(dtype=jdt, **VIT_KW),
                vit.ViT(image_size=32, in_channels=channels, dtype=dtype,
                        **VIT_KW))
    return (j_factory.create_encoder(kind, dtype=jdt),
            factory.create_encoder(kind, in_channels=channels, dtype=dtype))


@pytest.mark.parametrize("kind,channels,dtype", [
    ("xcit", 1, F32), ("vit", 3, F32), ("mobilenetv3_small_100", 1, F32),
    ("xcit", 3, torch.bfloat16)])
def test_encoder_forward_matches_jax(kind, channels, dtype):
    rng = np.random.default_rng(channels)
    jm, tm = _encoder_pair(kind, channels, dtype)
    variables = port_vars(tm, 3)
    x = rng.uniform(size=(4, 32, 32, channels)).astype(np.float32)
    if dtype == F32:
        ref = np.asarray(jax.jit(jm.apply)(variables, x))
        with torch.no_grad():
            got = _loaded(tm, variables)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
        return
    # bfloat16 as the engines run it: JAX casts every float32 leaf, the
    # port casts the module
    ref = np.asarray(jax.jit(jm.apply)(_bf16(variables), x), np.float32)
    with torch.no_grad():
        got = _loaded(tm, variables).to(torch.bfloat16)(
            torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=3e-2 * np.abs(ref).max())


def test_projection_head_matches_jax():
    rng = np.random.default_rng(0)
    jm = j_factory.ProjectionHead(hidden_dim=16, output_dim=8)
    tm = factory.ProjectionHead(24, hidden_dim=16, output_dim=8)
    variables = port_vars(tm, 1)
    x = rng.normal(size=(5, 24)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(variables, x))
    with torch.no_grad():
        got = _loaded(tm, variables)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_init_params_transformer_leaves():
    """Flax's initialisers for the transformer leaves: ``cls`` and ``pos``
    truncated_normal(0.02) (|x| <= 0.04, no rescale: std ~0.0176),
    ``temperature`` and ``gamma1..3`` ones."""
    m = init_params(factory.create_encoder("xcit_tiny_12_p8_224",
                                           in_channels=1), 0)
    pos = m.pos.detach().double()
    assert pos.abs().max() <= 0.04 and 0.016 < pos.std() < 0.019
    for name, p in m.named_parameters():
        if name.rsplit(".", 1)[-1] in ("temperature", "gamma1", "gamma2",
                                       "gamma3"):
            assert torch.equal(p, torch.ones_like(p)), name


# ------------------------------------------------------------- detectors
@pytest.fixture(scope="module")
def det_pairs():
    """(Flax, torch) float32 FCOS and R-CNN at width 0.25 / depth 0.33, 1
    channel, with the same seeded variables."""
    out = {}
    for kind, jcls, tcls, kw in (
            ("fcos", j_fcos.FCOS, fcos.FCOS, {}),
            ("rcnn", j_rcnn.FasterRCNN, rcnn.FasterRCNN, RCNN_KW)):
        tm = tcls(in_channels=1, dtype=F32, **DET_KW, **kw)
        variables = port_vars(tm, 5)
        out[kind] = (jcls(dtype=jnp.float32, **DET_KW, **kw),
                     _loaded(tm, variables), variables)
    return out


def _canvas(rng, b=2, h=128, w=128, c=1):
    x = rng.uniform(0.85, 1.0, (b, h, w, c)).astype(np.float32)
    for i in range(b):                   # dark glyph-like blocks
        for _ in range(12):
            y0, x0 = rng.integers(0, h - 20), rng.integers(0, w - 12)
            x[i, y0:y0 + rng.integers(8, 20), x0:x0 + rng.integers(4, 12)] \
                = rng.uniform(0.0, 0.2)
    return x


@pytest.fixture(scope="module")
def jax_det_out(det_pairs):
    """The JAX models' (decoded, raw / aux) on one 128 x 128 canvas pair,
    and the canvas (the two programs compile in threads)."""
    from concurrent.futures import ThreadPoolExecutor

    x = _canvas(np.random.default_rng(1))
    with ThreadPoolExecutor(2) as pool:
        applies = {k: (pool.submit(jax.jit(jm.apply).lower(v, x).compile), v)
                   for k, (jm, _, v) in det_pairs.items()}
        return {k: f.result()(v, x) for k, (f, v) in applies.items()}, x


@pytest.mark.parametrize("kind", ["fcos", "rcnn"])
def test_detector_forward_matches_jax(det_pairs, jax_det_out, kind):
    _, tm, _ = det_pairs[kind]
    (jdec, jaux), x = jax_det_out[0][kind], jax_det_out[1]
    with torch.no_grad():
        tdec, taux = tm(torch.from_numpy(x))
    jdec, tdec = np.asarray(jdec), tdec.numpy()
    np.testing.assert_allclose(tdec[..., 4:], jdec[..., 4:], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tdec[..., :4], jdec[..., :4], rtol=0,
                               atol=1e-3)
    if kind == "fcos":
        for t, j in zip(taux, jaux):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                       atol=1e-5)
    else:
        np.testing.assert_array_equal(taux["prop_valid"].numpy(),
                                      np.asarray(jaux["prop_valid"]))
        np.testing.assert_allclose(taux["proposals"].numpy(),
                                   np.asarray(jaux["proposals"]), rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(taux["roi_cls"].numpy(),
                                   np.asarray(jaux["roi_cls"]), rtol=1e-4,
                                   atol=1e-5)


def test_decode_fcos_matches_jax():
    rng = np.random.default_rng(0)
    raw = [rng.normal(0, 4, (2, 128 // s, 256 // s, 7)).astype(np.float32)
           for s in (8, 16, 32)]
    raw[0][0, 0, 0, :4] = [30.0, -30.0, 25.0, -25.0]    # softplus tails
    ref = np.asarray(jax.jit(j_fcos.decode_fcos)(raw))
    got = fcos.decode_fcos([torch.from_numpy(r) for r in raw]).numpy()
    np.testing.assert_allclose(got[..., 4:], ref[..., 4:], rtol=0,
                               atol=1e-6)
    # box coordinates within 4e-6 relative: XLA's and torch's softplus
    # differ by up to 2.3e-7 relative (their exp / log1p round the last
    # bit differently), times the stride, and x1 - x0 cancels
    np.testing.assert_allclose(got[..., :4], ref[..., :4], rtol=4e-6,
                               atol=1e-6)


def test_anchors_and_deltas_match_jax():
    rng = np.random.default_rng(0)
    for (gh, gw), stride, size in zip(((16, 32), (8, 16), (4, 8)),
                                      rcnn.STRIDES, rcnn.ANCHOR_SIZES):
        ref = np.array(jax.jit(j_rcnn.level_anchors, static_argnums=(
            0, 1, 2, 3))(gh, gw, stride, size))
        got = rcnn.level_anchors(gh, gw, stride, size).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    anchors = ref
    deltas = rng.normal(0, 2.5, (3,) + anchors.shape).astype(np.float32)
    deltas[0, :4, 2:] = [[5.0, -5.0], [-9.0, 9.0], [4.0, -4.0], [0, 0]]
    ref = np.asarray(jax.jit(j_rcnn.apply_deltas)(anchors, deltas))
    got = rcnn.apply_deltas(torch.from_numpy(anchors),
                            torch.from_numpy(deltas)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(
        ref).max())
    boxes = ref.copy()
    boxes[0, :3, 2] = boxes[0, :3, 0]           # zero-width boxes
    ref = np.asarray(jax.jit(j_rcnn.boxes_to_deltas)(anchors, boxes))
    got = rcnn.boxes_to_deltas(torch.from_numpy(anchors),
                               torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def _roi_case(rng, b, p, img=128):
    feats = [rng.normal(size=(b, img // s, img // s, 6)).astype(np.float32)
             for s in rcnn.STRIDES]
    side = rng.choice([10.0, 40.0, 90.0, 200.0], size=(b, p))
    x0 = rng.uniform(-30, img, (b, p))
    y0 = rng.uniform(-30, img, (b, p))
    boxes = np.stack([x0, y0, x0 + side * rng.uniform(0.5, 1.5, (b, p)),
                      y0 + side], -1).astype(np.float32)
    boxes[0, 0] = [50.0, 50.0, 50.5, 50.2]      # under 1 px: width 1
    return feats, boxes


def test_roi_align_matches_jax():
    """One image (JAX's signature) and a batch (vmapped), proposals on
    all three levels, some past the canvas; the batch also through
    slices of 5 proposals."""
    rng = np.random.default_rng(0)
    feats, boxes = _roi_case(rng, 3, 24)
    one = np.asarray(jax.jit(j_rcnn.roi_align)(
        [f[0] for f in feats], boxes[0]))
    got = rcnn.roi_align([torch.from_numpy(f[:1]) for f in feats],
                         torch.from_numpy(boxes[:1])).numpy()[0]
    np.testing.assert_allclose(got, one, rtol=0, atol=1e-5)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda f3, f4, f5, bx: j_rcnn.roi_align((f3, f4, f5), bx)))(
            *feats, boxes))
    scale = np.sqrt(np.maximum(boxes[..., 2] - boxes[..., 0], 1)
                    * np.maximum(boxes[..., 3] - boxes[..., 1], 1))
    assert (scale < 64).any() and ((scale >= 64) & (scale < 128)).any() \
        and (scale >= 128).any()
    tf = [torch.from_numpy(f) for f in feats]
    for elems in (rcnn.ROI_SLICE_ELEMS, 5 * 14 * 14 * 6):
        rcnn.ROI_SLICE_ELEMS, saved = elems, rcnn.ROI_SLICE_ELEMS
        try:
            got = rcnn.roi_align(tf, torch.from_numpy(boxes)).numpy()
        finally:
            rcnn.ROI_SLICE_ELEMS = saved
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


# --------------------------------------------------------- RPN keep mask
def _candidates(rng, b=4, k=96, img=128):
    """RPN-like candidates: clipped boxes, some degenerate (< 1 px),
    clusters of near-duplicates, scores quantised so ties are common."""
    cx = rng.uniform(0, img, (b, k))
    cy = rng.uniform(0, img, (b, k))
    cx[:, ::3] = cx[:, 1::3][:, :cx[:, ::3].shape[1]]   # near-duplicates
    w = rng.uniform(0.3, 60, (b, k))
    h = rng.uniform(0.3, 60, (b, k))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    boxes = np.clip(boxes, 0, img).astype(np.float32)
    scores = np.round(rng.normal(0, 1, (b, k)) * 4) / 4
    return boxes, scores.astype(np.float32)


def _keep_both(boxes, scores, thr=0.7):
    bx, sc = torch.from_numpy(boxes), torch.from_numpy(scores)
    valid = ~(((bx[..., 2] - bx[..., 0]) < 1.0)
              | ((bx[..., 3] - bx[..., 1]) < 1.0))
    ref = np.asarray(jax.jit(jax.vmap(
        lambda b, s, v: j_nms_mask(b, s, v, thr)))(boxes, scores,
                                                   valid.numpy()))
    return ref, [rcnn.rpn_keep(bx, sc, valid, thr, k).numpy()
                 for k in ("cuda", "plain")], valid


def test_rpn_keep_mask_matches_jax():
    boxes, scores = _candidates(np.random.default_rng(0))
    ref, got, valid = _keep_both(boxes, scores)
    assert (~valid).any() and len(np.unique(scores)) < scores.size / 3
    assert 0 < ref.sum() < valid.sum()
    for g in got:
        np.testing.assert_array_equal(g, ref)


def test_rpn_on_jax_candidates_matches(det_pairs, jax_det_out):
    """JAX's own RPN candidates (its rpn_raw through its apply_deltas,
    clip and lax.top_k): the keep mask bit for bit, and the proposals and
    their validity from the port's selection equal to the JAX model's."""
    tm = det_pairs["rcnn"][1]
    aux = jax_det_out[0]["rcnn"][1]

    def candidates(rpn_raw, anchors):
        cb, cs = [], []
        for r, anc in zip(rpn_raw, anchors):
            bx = j_rcnn.apply_deltas(anc[None], r[..., 1:])
            bx = jnp.stack([jnp.clip(bx[..., 0], 0, 128),
                            jnp.clip(bx[..., 1], 0, 128),
                            jnp.clip(bx[..., 2], 0, 128),
                            jnp.clip(bx[..., 3], 0, 128)], -1)
            sc, idx = jax.lax.top_k(r[..., 0], min(32, r.shape[1]))
            cb.append(jnp.take_along_axis(bx, idx[..., None], axis=1))
            cs.append(sc)
        return jnp.concatenate(cb, 1), jnp.concatenate(cs, 1)

    cand_b, cand_s = (np.asarray(a) for a in jax.jit(candidates)(
        aux["rpn_raw"], aux["anchors"]))
    ref, got, _ = _keep_both(cand_b, cand_s)
    for g in got:
        np.testing.assert_array_equal(g, ref)
    props, valid = tm._proposals(torch.from_numpy(cand_b),
                                 torch.from_numpy(cand_s))
    np.testing.assert_array_equal(props.numpy(),
                                  np.asarray(aux["proposals"]))
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(aux["prop_valid"]))


# ----------------------------------------------------------------- losses
def _targets_case(nc, b=2, t=10):
    """Targets for a 128 x 128 canvas: boxes in each FCOS size range (one
    past the canvas), two equal-area boxes over one cell (the first-index
    tie rule), a sliver and masked slots."""
    tg = np.zeros((b, t, 5), np.float32)
    boxes = [[0, 40.0, 20.0, 12, 18], [1, 41.0, 21.0, 18, 12],
             [0, 64.0, 64.0, 90, 40], [1, 100.0, 60.0, 60, 150],
             [0, 64.0, 64.0, 300, 260], [1, 8.0, 120.0, 6, 10],
             [0, 20.0, 100.0, 2, 30], [1, 90.0, 30.0, 20, 20]]
    tg[0, :len(boxes)] = boxes
    tg[1, :6] = np.asarray(boxes[2:]) + [0, 3.3, -1.7, 2, 1]
    tg[..., 0] = np.minimum(tg[..., 0], nc - 1)
    mask = np.zeros((b, t), bool)
    mask[0, :7] = True
    mask[1, :5] = True
    return tg, mask


def _assert_loss_grads(tl, tparts, jl, jparts, tgrads, jgrads):
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k].detach()),
                                   float(jparts[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    gmax = max(float(np.abs(g).max()) for g in jgrads)
    for t, g in zip(tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-5 * gmax)


@pytest.mark.parametrize("nc", [2])
def test_fcos_loss_and_gradients_match(nc):
    rng = np.random.default_rng(nc)
    raw = [rng.normal(0, 1.5, (2, 128 // s, 128 // s, 5 + nc)).astype(
        np.float32) for s in fcos.STRIDES]
    tg, mask = _targets_case(nc)
    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        lambda r: j_fcos.fcos_loss(r, tg, mask, num_classes=nc),
        has_aux=True))(raw)
    tr = [torch.from_numpy(r).requires_grad_() for r in raw]
    tl, tparts = fcos.fcos_loss(tr, torch.from_numpy(tg),
                                torch.from_numpy(mask), num_classes=nc)
    tl.backward()
    _assert_loss_grads(tl, tparts, jl, jparts, [t.grad for t in tr], jg)
    assert float(jparts["loss/box"]) > 0


def test_rcnn_loss_and_gradients_match():
    """Random head outputs and proposals (a third of them near a ground
    truth, so the ROI head has positives; a quarter invalid), the JAX
    anchors of a 128 x 128 canvas."""
    rng = np.random.default_rng(0)
    nc, b, p = 2, 2, 48
    tg, mask = _targets_case(nc)
    anchors = [np.array(j_rcnn.level_anchors(128 // s, 128 // s, s, a))
               for s, a in zip(rcnn.STRIDES, rcnn.ANCHOR_SIZES)]
    rpn_raw = [rng.normal(0, 1, (b, len(a), 5)).astype(np.float32)
               for a in anchors]
    gt = np.concatenate([tg[..., 1:3] - tg[..., 3:5] / 2,
                         tg[..., 1:3] + tg[..., 3:5] / 2], -1)
    props = np.concatenate([rng.uniform(0, 64, (b, p, 2)),
                            rng.uniform(64, 128, (b, p, 2))], -1)
    near = gt[:, rng.integers(0, 5, p // 3)] + rng.normal(0, 2,
                                                          (b, p // 3, 4))
    props[:, :p // 3] = near
    props = props.astype(np.float32)
    pvalid = rng.uniform(size=(b, p)) < 0.75
    roi_cls = rng.normal(0, 1, (b, p, nc + 1)).astype(np.float32)
    roi_deltas = rng.normal(0, 0.5, (b, p, nc * 4)).astype(np.float32)

    def jf(rpn_raw, roi_cls, roi_deltas):
        aux = {"rpn_raw": rpn_raw, "anchors": anchors, "proposals": props,
               "prop_valid": pvalid, "roi_cls": roi_cls,
               "roi_deltas": roi_deltas}
        return j_rcnn.rcnn_loss(aux, tg, mask, num_classes=nc)

    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(rpn_raw, roi_cls, roi_deltas)
    t_rpn = [torch.from_numpy(r).requires_grad_() for r in rpn_raw]
    t_cls = torch.from_numpy(roi_cls).requires_grad_()
    t_del = torch.from_numpy(roi_deltas).requires_grad_()
    aux = {"rpn_raw": t_rpn,
           "anchors": [torch.from_numpy(a) for a in anchors],
           "proposals": torch.from_numpy(props),
           "prop_valid": torch.from_numpy(pvalid), "roi_cls": t_cls,
           "roi_deltas": t_del}
    tl, tparts = rcnn.rcnn_loss(aux, torch.from_numpy(tg),
                                torch.from_numpy(mask), num_classes=nc)
    tl.backward()
    _assert_loss_grads(tl, tparts, jl, jparts,
                       [t.grad for t in t_rpn] + [t_cls.grad, t_del.grad],
                       list(jg[0]) + [jg[1], jg[2]])
    assert float(jparts["loss/box"]) > 0


# ----------------------------------------------------------- train steps
def _f64_copy(model, variables):
    """The port model with float64 parameters, convolutions, Dense layers
    (heads included), ROIAlign and BatchNorm (layers.BatchNorm keeps
    float64 input in float64)."""
    m = copy.deepcopy(_loaded(model, variables)).double()
    for mod in m.modules():
        if hasattr(mod, "dtype"):
            mod.dtype = torch.float64
    return m


@pytest.fixture(scope="module")
def jax_det_steps(det_pairs):
    """One JAX bank step (no augmentation) of each family on the same
    batch: {kind: (loss, gradients, new batch_stats as state dicts)}, and
    the batch.  Each step is traced in turn; XLA compiles the first in a
    thread while the second is traced."""
    from concurrent.futures import ThreadPoolExecutor

    from effocr_tpu.train.localizer import make_detector_train_step as j_step
    from test_torch_localizer import _bank, _cfgs
    from test_torch_train import _capture_grads

    rng = np.random.default_rng(7)
    jcfg, _ = _cfgs(1, augment=False)
    bank, tg, mk = _bank(rng, 6, 1)
    idx = np.asarray([4, 1, 5, 0], np.int32)
    states, compiled = {}, {}
    with ThreadPoolExecutor(2) as pool:
        for kind, (jm, _, variables) in det_pairs.items():
            states[kind] = {
                "params": variables["params"],
                "batch_stats": variables["batch_stats"],
                "opt_state": _capture_grads().init(variables["params"])}
            lowered = jax.jit(j_step(jm, jcfg, _capture_grads(), None,
                                     bank_mode=True)).lower(
                states[kind], bank, tg, mk, idx)
            compiled[kind] = pool.submit(lowered.compile)
        compiled = {k: f.result() for k, f in compiled.items()}
    out = {}
    for kind, step in compiled.items():
        new, jloss, _ = step(states[kind], bank, tg, mk, idx)
        out[kind] = (float(jloss),
                     flax_to_state_dict({"params": _np(new["opt_state"]["g"])}),
                     flax_to_state_dict({"batch_stats":
                                         _np(new["batch_stats"])}))
    batch = (torch.from_numpy(bank), torch.from_numpy(tg),
             torch.from_numpy(mk), torch.from_numpy(idx).long(), None)
    return out, batch


@pytest.mark.parametrize("kind", ["fcos", "rcnn"])
def test_detector_train_step_matches_jax(det_pairs, jax_det_steps, kind,
                                         monkeypatch):
    """One bank step of each family against the JAX step (no augmentation:
    test_torch_localizer.py holds it): loss 1e-5 relative, new
    batch_stats 1e-4 of the largest; gradients within 2e-3 of the largest
    |g| of JAX's, and within 1e-4 of a float64 evaluation of the same
    step.  The R-CNN's float64 evaluation takes the float32 step's
    proposals and its box head's ReLU gates: both are functions of the
    scores that the gradient does not pass through, and float32 rounding
    moves them (proposals by up to 3.3e-3 px, which shifts ROIAlign's
    bilinear weights: 2.8e-4 of the largest |g| in float64 alone; one
    gate of 131,072 flips: 1.6e-4), in JAX's step as in the port's
    (2.6e-4 and 3.5e-4 from the float64 step left free)."""
    from effocr_torch.train.localizer import make_detector_train_step
    from test_torch_localizer import _cfgs
    from test_torch_train import _GradRecorder

    _, tm, variables = det_pairs[kind]
    (jloss, jgrads, jstats), batch = jax_det_steps[0][kind], jax_det_steps[1]
    _, tcfg = _cfgs(1, augment=False)
    m32 = copy.deepcopy(_loaded(tm, variables))
    pinned, gates = [], []
    if kind == "rcnn":
        proposals, relu = m32._proposals, torch.relu

        def keep_proposals(boxes, scores):
            pinned.append(proposals(boxes, scores))
            return pinned[-1]

        def keep_gate(x):
            gates.append(x.detach() > 0)
            return relu(x)

        m32._proposals = keep_proposals
        monkeypatch.setattr(torch, "relu", keep_gate)

    rec = _GradRecorder(dict(m32.named_parameters()))
    loss, parts = make_detector_train_step(m32, tcfg, rec, None,
                                           bank_mode=True)(*batch)
    assert set(parts) == {"loss/box", "loss/obj", "loss/cls"}
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    sd = m32.state_dict()
    smax = max(float(v.abs().max()) for v in jstats.values())
    for k, v in jstats.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4 * smax, err_msg=k)

    m64 = _f64_copy(tm, variables)
    if kind == "rcnn":
        assert len(pinned) == 1 and len(gates) == 2
        props, valid = pinned[0]
        m64._proposals = lambda boxes, scores: (props.double(), valid)
        gate = iter(gates)
        monkeypatch.setattr(torch, "relu",
                            lambda x: x * next(gate).to(x.dtype))
    rec64 = _GradRecorder(dict(m64.named_parameters()))
    make_detector_train_step(m64, tcfg, rec64, None, bank_mode=True)(*batch)
    ref = {k: g.double() for k, g in rec64.grads.items()}
    assert rec.grads.keys() == jgrads.keys() == ref.keys()
    gmax = max(float(g.abs().max()) for g in ref.values())
    for k, g in jgrads.items():
        got = rec.grads[k].double()
        np.testing.assert_allclose(got.numpy(), ref[k].numpy(), rtol=0,
                                   atol=1e-4 * gmax, err_msg=k)
        np.testing.assert_allclose(got.numpy(), g.double().numpy(), rtol=0,
                                   atol=2e-3 * gmax, err_msg=k)


def test_xcit_recognizer_step_matches_jax():
    """One recognizer bank step (no_aug: the augmentation is held in
    test_torch_train.py; XCiT -> SupCon + aux cosine CE) against the JAX
    step: loss 1e-5 relative,
    gradients within 1e-4 of the largest |g|, LPI BatchNorm statistics
    1e-4 of the largest."""
    from effocr_tpu.core.config import EncoderConfig as JEncoderConfig
    from effocr_tpu.core.config import RecognizerTrainConfig as JTrainConfig
    from effocr_tpu.train.recognizer import make_train_step as j_make_step
    from effocr_torch.core.config import (
        EncoderConfig,
        RecognizerTrainConfig,
    )
    from effocr_torch.train.recognizer import make_train_step
    from test_torch_train import _capture_grads, _GradRecorder

    rng = np.random.default_rng(0)
    b, size, n_cls = 8, 32, 4
    cfg_kw = dict(batch_size=b, lang="en", no_aug=True, aux_ce_weight=1.0)
    enc = dict(arch="xcit_tiny_12_p8_224", image_size=size,
               input_channels=1)
    jcfg = JTrainConfig(encoder=JEncoderConfig(**enc), **cfg_kw)
    tcfg = RecognizerTrainConfig(encoder=EncoderConfig(**enc), **cfg_kw)
    jm, tm = _encoder_pair("xcit", 1, F32)
    variables = port_vars(tm, 4)
    w = rng.normal(size=(n_cls, XCIT_KW["dim"])).astype(np.float32)
    bank_u8 = rng.integers(0, 256, (12, size, size), np.uint8)
    bank_t = rng.integers(0, n_cls, 12).astype(np.int32)
    bank_p = rng.uniform(size=12) < 0.4
    idx = rng.permutation(12)[:b].astype(np.int32)
    key = jax.random.PRNGKey(5)
    batch = (bank_u8, bank_t, bank_p, idx)
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "aux": {"w": jnp.asarray(w)}}
    state["opt_state"] = _capture_grads().init(
        {"model": state["params"], "aux": state["aux"]})
    jstep = j_make_step(jm, jcfg, _capture_grads(), False, use_aux=True,
                        bank_mode=True)
    new, jloss = jax.jit(jstep)(state, *map(jnp.asarray, batch), key)
    jgrads = _np(new["opt_state"]["g"])

    _loaded(tm, variables)
    aux = torch.tensor(w, requires_grad=True)
    named = dict(tm.named_parameters())
    named["aux"] = aux
    rec = _GradRecorder(named)
    tloss = make_train_step(tm, tcfg, rec, False, aux=aux, bank_mode=True)(
        *(torch.from_numpy(a).long() if a.dtype == np.int32
          else torch.from_numpy(a) for a in batch), None)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    ref = flax_to_state_dict({"params": jgrads["model"]})
    ref["aux"] = torch.from_numpy(np.array(jgrads["aux"]["w"]))
    assert ref.keys() == rec.grads.keys()
    gmax = max(float(g.abs().max()) for g in ref.values())
    for k, g in ref.items():
        np.testing.assert_allclose(rec.grads[k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * gmax, err_msg=k)
    stats = flax_to_state_dict({"batch_stats": _np(new["batch_stats"])})
    smax = max(float(v.abs().max()) for v in stats.values())
    sd = tm.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4 * smax, err_msg=k)


# ----------------------------------------------------------------- bridge
@pytest.mark.parametrize("kind", ["xcit", "vit", "fcos", "rcnn"])
def test_bridge_round_trip_exact(det_pairs, kind, tmp_path):
    """Random variables of each family (whose tree loads into the JAX
    model: the forward tests apply it there; test_registry_arch_loads_
    flax_tree holds the full-width trees) -> the port's module (strict)
    -> back: identical; a checkpoint the port writes reads in the JAX
    loader identically, and one the JAX package writes loads in the
    port."""
    from effocr_torch.train import checkpoint as t_ckpt

    if kind in ("xcit", "vit"):
        tm = _encoder_pair(kind, 1, F32)[1]
        tree = port_vars(tm, 9)
    else:
        tm, tree = copy.deepcopy(det_pairs[kind][1]), det_pairs[kind][2]
    tm.load_state_dict(flax_to_state_dict(tree), strict=True)
    back = state_dict_to_flax(tm.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (p, a), (_, b) in zip(leaves(tree), leaves(back)):
        assert a.shape == b.shape and np.array_equal(a, b), p
    path = str(tmp_path / "port.msgpack")
    write_variables(back, path)
    for (p, a), (_, b) in zip(leaves(tree),
                              leaves(j_ckpt.load_variables(tree, path))):
        assert np.array_equal(a, np.asarray(b)), p
    jpath = str(tmp_path / "jax.msgpack")
    j_ckpt.save_variables(tree, jpath)
    tm2 = copy.deepcopy(tm)
    for prm in tm2.parameters():
        prm.data.zero_()
    tm2.load_state_dict(flax_to_state_dict(t_ckpt.load_variables(jpath)),
                        strict=True)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, tm2.state_dict()[k]), k


# ----------------------------------------------------------------- engine
# detector head offsets for the engine runs, by output channel (FCOS: 4 =
# centerness, 5 = "char", 6 = "word"), per level, added once each head
# has unit output spread: chars from stride 8, words from stride 32
FCOS_OFFSETS = {0: {4: 1.0, 5: 3.0, 6: -3.0}, 1: {4: -8.0},
                2: {4: 3.0, 5: -3.0, 6: 3.0}}
# R-CNN class logits: background unlikely, "char" a little above "word"
RCNN_OFFSETS = np.asarray([-3.0, 0.5, 0.0], np.float32)


def _calibrated(tloc, variables, kind, canvas):
    """A random detector's activations shrink layer by layer, so its
    outputs barely vary: each head (FCOS's per level, the R-CNN's class
    logits) is rescaled to zero mean and unit spread over ``canvas``,
    then the offsets are added, so lines read chars and words."""
    out = jax.tree.map(np.array, variables)
    p = out["params"]
    with torch.no_grad():
        raw = _loaded(tloc, variables)(torch.from_numpy(canvas),
                                       decode=False)
    if kind == "fcos":
        heads = [(p[f"head{i}_out"], r, FCOS_OFFSETS[i])
                 for i, r in enumerate(raw)]
    else:
        heads = [(p["cls"], raw["roi_cls"], dict(enumerate(RCNN_OFFSETS)))]
    for head, r, offsets in heads:
        r = r.reshape(-1, r.shape[-1]).double()
        m, sd = r.mean(0).numpy(), r.std(0).numpy()
        head["kernel"] /= sd.astype(np.float32)
        head["bias"][:] = (head["bias"] - m) / sd
        for ch, v in offsets.items():
            head["bias"][ch] += v
    _loaded(tloc, out)
    return out


def _engines(line_paths, jloc, jloc_vars, tloc, jenc, jenc_vars, tenc,
             protos, chars, **kw):
    """Both en engines (test_torch_pipeline's scaled-down config, float32,
    one canvas shape) on the same models; returns (JAX results, port
    results)."""
    from effocr_tpu.core.config import EncoderConfig as JEncoderConfig
    from effocr_tpu.core.config import LocalizerConfig as JLocalizerConfig
    from effocr_tpu.core.config import PipelineConfig as JPipelineConfig
    from effocr_tpu.pipelines.infer import EffOCRInference as JEngine
    from effocr_tpu.retrieval.index import PrototypeIndex as JIndex
    from effocr_torch.core.config import (
        EncoderConfig,
        LocalizerConfig,
        PipelineConfig,
    )
    from effocr_torch.pipelines.infer import EffOCRInference
    from effocr_torch.retrieval.index import PrototypeIndex
    from test_torch_pipeline import _config

    kw = dict(adaptive_height=False, adaptive_width=False,
              compute_dtype="f32", **kw)
    jcfg = _config(JPipelineConfig, JLocalizerConfig, JEncoderConfig,
                   nms_kernel="pallas", **kw)
    tcfg = _config(PipelineConfig, LocalizerConfig, EncoderConfig,
                   nms_kernel="cuda", **kw)
    jres = JEngine(jcfg, jloc, jloc_vars, jenc, jenc_vars,
                   JIndex(protos, chars)).run(line_paths)
    tres = EffOCRInference(tcfg, tloc, tenc, PrototypeIndex(protos, chars),
                           device="cpu").run(line_paths)
    return jres, tres


@pytest.mark.parametrize("kind", ["fcos", "rcnn", "xcit"])
def test_engine_matches_jax(line_paths, kind):
    """The en engine in float32 on the synthetic DejaVu lines: an FCOS
    or R-CNN localizer (1 channel, width 0.25, random, heads calibrated
    so lines read chars and words) with the tiny encoder, or the oracle
    localizer with an XCiT recognizer at 128 px; the port's text equals
    the JAX engine's line for line."""
    from test_torch_pipeline import (
        CHARS, JaxOracle, TinyEncoder, TorchTinyEncoder, torch_oracle)

    rng = np.random.default_rng(3)
    if kind == "xcit":
        jloc, jloc_vars, tloc = JaxOracle(), {}, torch_oracle
        jenc = j_vit.XCiT(dtype=jnp.float32, **XCIT_KW)
        tenc = vit.XCiT(image_size=128, in_channels=1, dtype=F32,
                        **XCIT_KW)
        jenc_vars = port_vars(tenc, 6)
        protos = rng.normal(size=(len(CHARS), XCIT_KW["dim"]))
    else:
        jcls, tcls, kw = ((j_fcos.FCOS, fcos.FCOS, {}) if kind == "fcos"
                          else (j_rcnn.FasterRCNN, rcnn.FasterRCNN, RCNN_KW))
        jloc = jcls(dtype=jnp.float32, **DET_KW, **kw)
        tloc = tcls(in_channels=1, dtype=F32, **DET_KW, **kw)
        canvas = np.full((2, 96, 512, 1), 0.45, np.float32)
        for i, path in enumerate(line_paths[:2]):
            img = np.asarray(Image.open(path), np.float32)[:96, :512] / 255
            canvas[i, :img.shape[0], :img.shape[1], 0] = img
        jloc_vars = _calibrated(tloc, port_vars(tloc, 6), kind, canvas)
        jenc = TinyEncoder()
        tenc = TorchTinyEncoder(256)
        jenc_vars = {"params": {"Dense_0": {"kernel": rng.normal(
            size=(256, 64)).astype(np.float32)}}}
        protos = rng.normal(size=(len(CHARS), 64))
    _loaded(tenc, jenc_vars)
    jres, tres = _engines(line_paths, jloc, jloc_vars, tloc, jenc,
                          jenc_vars, tenc, protos.astype(np.float32),
                          list(CHARS))
    assert tres == jres
    assert sum(bool(t) for t in tres.values()) >= len(line_paths) // 2, tres
