"""effocr_torch NMS and decode against the JAX package, bit for bit.

The port's plain ``nms_mask`` (the CPU path and oracle of the CUDA kernel)
must give keep masks identical to JAX ``nms_mask`` and to the Pallas
kernel in interpret mode; ``batched_nms`` and ``decode_and_nms`` must give
identical valid-slot outputs.  Inputs come from numpy seeds and reach both
sides as the same arrays.  Tolerance: none (exact equality).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effocr_tpu.kernels import nms as jnms
from effocr_tpu.kernels.pallas_nms import pallas_nms_mask
from effocr_tpu.kernels.yolo_decode import decode_and_nms as j_decode
from effocr_torch.kernels import nms as tnms
from effocr_torch.kernels.cuda_nms import nms_keep
from effocr_torch.kernels.yolo_decode import decode_and_nms as t_decode


def random_boxes(rng, n, size=640):
    xy = rng.uniform(0, size * 0.9, (n, 2))
    wh = rng.uniform(4, size * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def presorted_batch(rng, bsz, n, tie_frac=0.15):
    """top_k-shaped batch (tests/test_nms.py fixture): descending scores
    with runs of exact ties, a valid prefix, 20% class-1 boxes."""
    boxes, scores, classes, valid = [], [], [], []
    for _ in range(bsz):
        nv = int(rng.integers(max(1, n // 4), n))
        sc = np.sort(rng.uniform(0.1, 1.0, nv).astype(np.float32))[::-1]
        k = int(nv * tie_frac)
        if k:
            sc[1:k + 1] = sc[:k]
            sc = np.sort(sc)[::-1]
        scores.append(np.concatenate([sc, np.zeros(n - nv, np.float32)]))
        boxes.append(random_boxes(rng, n))
        classes.append((rng.uniform(size=n) < 0.2).astype(np.int32))
        v = np.zeros(n, bool)
        v[:nv] = True
        valid.append(v)
    return (np.stack(boxes), np.stack(scores), np.stack(classes),
            np.stack(valid))


def chain_boxes(n, step=2.5):
    """Dense horizontal chain: each box overlaps its neighbours, so
    suppression decisions cascade across 128-box tiles."""
    return np.stack([np.arange(n) * step, np.zeros(n),
                     np.arange(n) * step + 20.0, np.full(n, 20.0)],
                    axis=1).astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n", [128, 300, 512])
@pytest.mark.parametrize("iou_thresh", [0.01, 0.25, 0.45])
def test_plain_nms_mask_matches_jax_and_pallas(n, iou_thresh):
    rng = np.random.default_rng(n + int(iou_thresh * 100))
    b, s, _, v = presorted_batch(rng, 3, n)
    got = tnms.nms_mask(t(b), t(s), t(v), iou_thresh, presorted=True).numpy()
    pallas = np.asarray(pallas_nms_mask(jnp.asarray(b), jnp.asarray(v),
                                        iou_thresh, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    for i in range(3):
        ref = np.asarray(jnms.nms_mask(
            jnp.asarray(b[i]), jnp.asarray(s[i]), jnp.asarray(v[i]),
            iou_thresh, presorted=True))
        np.testing.assert_array_equal(got[i], ref)
    # the CPU path of the kernel wrapper is this same plain version
    np.testing.assert_array_equal(nms_keep(t(b), t(v), iou_thresh).numpy(),
                                  got)


def test_plain_nms_cross_tile_chain():
    rng = np.random.default_rng(7)
    n = 384
    boxes = chain_boxes(n)
    scores = np.sort(rng.uniform(0.1, 1.0, n).astype(np.float32))[::-1]
    valid = np.ones(n, bool)
    got = tnms.nms_mask(t(boxes)[None], t(scores.copy())[None],
                        t(valid)[None], 0.3, presorted=True).numpy()[0]
    ref = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                   jnp.asarray(valid), 0.3, presorted=True))
    pallas = np.asarray(pallas_nms_mask(jnp.asarray(boxes)[None],
                                        jnp.asarray(valid)[None], 0.3,
                                        interpret=True))[0]
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    assert 0 < got.sum() < n


@pytest.mark.parametrize("n", [17, 100])
def test_plain_nms_mask_unsorted_matches_jax(n):
    """Rank path (stable argsorts) with ties and an invalid tail."""
    rng = np.random.default_rng(n)
    boxes = random_boxes(rng, n)
    scores = rng.uniform(0.1, 1.0, n).astype(np.float32)
    scores[1::5] = scores[0::5][:len(scores[1::5])]
    valid = rng.uniform(size=n) < 0.8
    got = tnms.nms_mask(t(boxes), t(scores), t(valid), 0.3).numpy()
    ref = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                   jnp.asarray(valid), 0.3))
    np.testing.assert_array_equal(got, ref)


def _assert_valid_slots_equal(ref, got):
    vref = np.asarray(ref[3])
    np.testing.assert_array_equal(vref, got[3].numpy())
    for r, g in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(np.asarray(r)[vref], g.numpy()[vref])


@pytest.mark.parametrize("iou_thresh", [0.01, 0.45])
@pytest.mark.parametrize("presorted", [True, False])
def test_batched_nms_matches_jax(iou_thresh, presorted):
    rng = np.random.default_rng(11)
    b, s, c, v = presorted_batch(rng, 3, 256)
    jargs = (jnp.asarray(b), jnp.asarray(s), jnp.asarray(c), jnp.asarray(v))
    targs = (t(b), t(s), t(c), t(v))
    for max_det in (16, 128, 300):
        ref = jnms.batched_nms(*jargs, iou_thresh=iou_thresh, max_det=max_det,
                               presorted=presorted)
        got = tnms.batched_nms(*targs, iou_thresh=iou_thresh,
                               max_det=max_det, presorted=presorted)
        _assert_valid_slots_equal(ref, got)
        if presorted:
            # the kernel route (plain version on CPU tensors) against the
            # Pallas kernel route in interpret mode
            ref_k = jnms.batched_nms(*jargs, iou_thresh=iou_thresh,
                                     max_det=max_det, presorted=True,
                                     kernel="pallas", interpret=True)
            got_k = tnms.batched_nms(*targs, iou_thresh=iou_thresh,
                                     max_det=max_det, presorted=True,
                                     kernel="cuda")
            _assert_valid_slots_equal(ref_k, got_k)


def _predictions(rng, b, a, nc=2):
    """Decoded-head-shaped predictions with exact confidence ties, most
    anchors below the threshold (ties at the NEG_INF floor of the top-k),
    and anchors passing obj but failing conf."""
    xy = rng.uniform(0, 240, (b, a, 2))
    wh = rng.uniform(4, 40, (b, a, 2))
    obj = rng.uniform(0, 1, (b, a, 1))
    cls = rng.uniform(0, 1, (b, a, nc))
    pred = np.concatenate([xy, wh, obj, cls], -1).astype(np.float32)
    pred[:, ::7, 4] = pred[:, 0:1, 4]   # tied objectness
    pred[:, ::7, 5] = pred[:, 0:1, 5]   # -> tied confidence
    return pred


@pytest.mark.parametrize("kernel", ["plain", "cuda"])
def test_decode_and_nms_matches_jax(kernel):
    rng = np.random.default_rng(5)
    pred = _predictions(rng, 3, 600)
    kw = dict(conf_thresh=0.3, iou_thresh=0.25, max_det=96)
    for max_nms in (64, 1024):    # candidate cap below / above A
        ref = j_decode(jnp.asarray(pred), max_nms=max_nms,
                       nms_kernel="pallas" if kernel == "cuda" else "xla",
                       interpret=kernel == "cuda", **kw)
        got = t_decode(t(pred), max_nms=max_nms, nms_kernel=kernel, **kw)
        _assert_valid_slots_equal(ref, got)
        assert np.asarray(ref[3]).any()


def test_decode_topk_ties_keep_index_order():
    """Equal confidences must come out lower anchor index first (lax.top_k
    order): the presorted NMS contract ranks by position."""
    pred = np.zeros((1, 40, 7), np.float32)
    pred[0, :, :4] = [[10 + 30 * (i % 4), 10, 8, 8] for i in range(40)]
    pred[0, :, 4] = 0.9
    pred[0, :, 5] = 0.8      # every anchor ties on confidence
    kw = dict(conf_thresh=0.3, iou_thresh=0.25, max_nms=16, max_det=16)
    ref = j_decode(jnp.asarray(pred), **kw)
    got = t_decode(t(pred), **kw)
    _assert_valid_slots_equal(ref, got)
    # the four distinct columns survive, from anchors 0..3
    np.testing.assert_array_equal(got[0].numpy()[0, :4, 0],
                                  [6.0, 36.0, 66.0, 96.0])


# ---------------------------------------------------------------------------
# The CUDA kernel's algorithm (csrc/nms.cu), emulated in numpy: it cannot
# run here, so its data flow is held to the plain and JAX versions on the
# CPU, bit for bit.  The emulation uses the wrapper's own geometry and
# threshold helpers (kernels/cuda_nms.py).

from effocr_torch.kernels.cuda_nms import (  # noqa: E402
    MAX_N,
    fast_test_bounds,
    mask_items,
    mask_words,
    scratch_words,
)

_ALL = (1 << 64) - 1


def item_index(r, w, words):
    """Position of item (r, w) in an image's mask (csrc/nms.cu: row-major
    by r, r <= w)."""
    return r * words - r * (r - 1) // 2 + (w - r)


def _pack(bits):
    """bool [64] -> int with bit c = bits[c]."""
    return int(np.packbits(bits, bitorder="little").view("<u8")[0])


def _kernel_decisions(pad, thr):
    """The build kernel's IoU test for every (row i, column j) pair of an
    image: the reference's float32 operations, the division-free test
    where fast_test_bounds allows it and every box of the pair's item (its
    two 64-box blocks) has an area below 1e29, and the division on the
    pairs it leaves open.  Also returns how many pairs needed the
    division."""
    f32 = np.float32
    x0, y0, x1, y1 = pad.T
    with np.errstate(all="ignore"):        # inf areas: a box of 1e20 x 1e20
        area = np.maximum(x1 - x0, f32(0)) * np.maximum(y1 - y0, f32(0))
        iw = np.maximum(np.minimum(x1[:, None], x1[None]) -
                        np.maximum(x0[:, None], x0[None]), f32(0))
        ih = np.maximum(np.minimum(y1[:, None], y1[None]) -
                        np.maximum(y0[:, None], y0[None]), f32(0))
        inter = iw * ih
        d = (area[:, None] + area[None]) - inter + f32(1e-7)
        divided = inter / d > f32(thr)
    lo, hi, fast = fast_test_bounds(thr)
    if not fast:
        return divided, divided.size
    small = np.repeat((area < f32(1e29)).reshape(-1, 64).all(1), 64)
    eligible = small[:, None] & small[None]
    assert (d[eligible] < f32(1e30)).all()
    with np.errstate(all="ignore"):
        above_hi = eligible & (inter > f32(hi) * d)
        above_lo = ~eligible | (inter > f32(lo) * d)
    # the proof in csrc/nms.cu: the division-free outcome is the division's
    np.testing.assert_array_equal(divided[above_hi], True)
    np.testing.assert_array_equal(divided[~above_lo], False)
    open_ = above_lo & ~above_hi
    dec = above_hi | (open_ & divided)
    return dec, int(open_.sum())


def emulate_kernel_keep(boxes, valid, thr):
    """csrc/nms.cu's data flow for boxes [B, N, 4] float32 and valid
    [B, N]: nms_build_kernel fills the triangular items (item_index) of a
    scratch of scratch_words(B, N) words, skipping items whose rows are
    all invalid (left as all-ones garbage here, which the scan must never
    use), and records each block's valid bits; nms_scan_kernel resolves
    each 64-box block's greedy order on one word and ORs the kept rows
    into the later blocks' removed words.  Returns (keep [B, N], pairs
    that took the division)."""
    b, n, _ = boxes.shape
    words, items = mask_words(n), mask_items(n)
    scratch = np.full(scratch_words(b, n), _ALL, np.uint64)
    mask = scratch[:b * items * 64].reshape(b, items, 64)
    vbits_all = scratch[b * items * 64:].reshape(b, words)
    keep = np.zeros((b, n), bool)
    divided = 0
    col = np.arange(words * 64)
    for img in range(b):
        pad = np.zeros((words * 64, 4), np.float32)
        pad[:n] = boxes[img]
        vpad = np.zeros(words * 64, bool)
        vpad[:n] = valid[img]
        dec, nd = _kernel_decisions(pad, thr)
        divided += nd
        sup = dec & vpad[:, None] & vpad[None] & (col[None] > col[:, None])
        # build
        for r in range(words):
            rows = slice(64 * r, 64 * r + 64)
            vbits_all[img, r] = _pack(vpad[rows])
            if not vpad[rows].any():
                continue
            for w in range(r, words):
                block = sup[rows, 64 * w:64 * w + 64]
                mask[img, item_index(r, w, words)] = [_pack(x) for x in block]
        # scan
        vbits = [int(v) for v in vbits_all[img]]
        w_eff = max((r + 1 for r in range(words) if vbits[r]), default=0)
        removed = [0] * words
        kept_img = np.zeros(words * 64, bool)
        for r in range(w_eff):
            diag = [int(x) for x in mask[img, item_index(r, r, words)]]
            rem = removed[r] | (~vbits[r] & _ALL)
            kept = 0
            for c in range(64):
                if not (rem >> c) & 1:
                    kept |= 1 << c
                    rem |= diag[c]
            rows_kept = [c for c in range(64) if (kept >> c) & 1]
            kept_img[64 * r + np.array(rows_kept, int)] = True
            for w in range(r + 1, w_eff):
                words_w = mask[img, item_index(r, w, words)][rows_kept]
                removed[w] |= int(np.bitwise_or.reduce(words_w,
                                                       initial=np.uint64(0)))
        keep[img] = kept_img[:n]
    return keep, divided


def _jax_keep(boxes, valid, thr):
    return np.stack([np.asarray(jnms.nms_mask(
        jnp.asarray(boxes[i]), jnp.zeros(boxes.shape[1], jnp.float32),
        jnp.asarray(valid[i]), thr, presorted=True))
        for i in range(boxes.shape[0])])


def _emulation_vs_references(boxes, valid, thr):
    got, divided = emulate_kernel_keep(boxes, valid, thr)
    plain = tnms.nms_mask(t(boxes), None, t(valid), thr,
                          presorted=True).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, _jax_keep(boxes, valid, thr))
    return got, divided


@pytest.mark.parametrize("n", [1, 64, 65, 1000, 2048])
@pytest.mark.parametrize("iou_thresh", [0.0, 0.01, 0.25])
def test_kernel_emulation_matches_plain_and_jax(n, iou_thresh):
    rng = np.random.default_rng(n * 7 + int(iou_thresh * 100))
    b = 2 if n >= 1000 else 3
    boxes = np.stack([random_boxes(rng, n) for _ in range(b)])
    boxes[:, 1:n // 8 + 1] = boxes[:, :n // 8]           # exact ties
    classes = (rng.uniform(size=(b, n)) < 0.2).astype(np.float32)
    boxes = boxes + classes[..., None] * np.float32(tnms.MAX_WH)
    valid = np.arange(n)[None] < rng.integers(1, n + 1, (b, 1))
    valid[0] = True                                     # one full image
    got, _ = _emulation_vs_references(boxes, valid, iou_thresh)
    assert got.sum() > 0


@pytest.mark.parametrize("iou_thresh", [0.0, 0.01, 0.25])
def test_kernel_emulation_ties_and_chain(iou_thresh):
    """Exact duplicate boxes (ties) and the 384-box chain whose decisions
    cascade across 64-box blocks, with a valid mask that is not a
    prefix."""
    rng = np.random.default_rng(3)
    boxes, _, _, valid = presorted_batch(rng, 2, 300, tie_frac=0.5)
    boxes[:, 1::2] = boxes[:, 0::2]
    valid[1, 40:90] = False
    boxes[0, 70] = [0.0, 0.0, 1e20, 1e20]   # area overflows: the division
    _emulation_vs_references(boxes, valid, iou_thresh)
    chain = chain_boxes(384)[None]
    got, _ = _emulation_vs_references(chain, np.ones((1, 384), bool),
                                      max(iou_thresh, 0.3))
    assert 0 < got.sum() < 384


@pytest.mark.parametrize("iou_thresh", [0.25, 1 / 3, 0.5])
def test_kernel_emulation_near_threshold(iou_thresh):
    """Integer boxes on a small grid: many IoUs equal the threshold
    exactly, so the division-free test must hand them to the division."""
    rng = np.random.default_rng(int(iou_thresh * 1000))
    xy = rng.integers(0, 6, (3, 200, 2))
    wh = rng.integers(1, 5, (3, 200, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.ones((3, 200), bool)
    _, divided = _emulation_vs_references(boxes, valid, iou_thresh)
    assert divided > 0


def test_kernel_geometry_helpers():
    """The wrapper's layout helpers: items enumerate row-major by block
    with no gap, the scratch holds masks then valid bits, N is capped
    where the scan's shared memory would pass 48 KB, and the fast test's
    bounds sit at least 2^-18 (relative) from the threshold."""
    for n in (1, 64, 65, 1024, 4096):
        words = mask_words(n)
        order = [item_index(r, w, words) for r in range(words)
                 for w in range(r, words)]
        assert order == list(range(mask_items(n)))
        assert scratch_words(3, n) == 3 * mask_items(n) * 64 + 3 * words
    assert mask_items(1024) == 136 and mask_items(4096) == 2080
    assert 4 * (2 * mask_words(MAX_N) + 64) * 8 <= 48 * 1024
    for thr in (0.01, 0.25, 1 / 3, 0.5, 1.0):
        lo, hi, fast = fast_test_bounds(thr)
        t32 = float(np.float32(thr))
        assert fast and lo < t32 < hi
        assert (t32 - lo) / t32 > 2.0 ** -18 and (hi - t32) / t32 > 2.0 ** -18
        assert np.float32(lo) == lo and np.float32(hi) == hi
    for thr in (0.0, -0.1, 5.0):
        assert not fast_test_bounds(thr)[2]
