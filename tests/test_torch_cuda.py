"""The CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU with nvcc (sm_90a); every test skips without one.
Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed: ``python -m pytest tests/test_torch_cuda.py``.
Tolerances: NMS keep masks bit-identical (also at the localizer
trainer's evaluation shape, [16, 1024] at IoU 0.45, and on the R-CNN's
RPN route: unsorted candidates sorted, kept and scattered back, against
``nms_mask(presorted=False)``).  The detection
augmentation on the card against the CPU on the same draws: 1e-5.
Top-1 retrieval (any D: the wrapper pads D to a multiple of 4): scores
within 1e-5 (float32 sums in another order), indices identical wherever the
plain top-2 margin exceeds 1e-5, and everywhere on inputs whose products
are exact in float32 (ties, all rows masked).
"""

import numpy as np
import pytest
import torch

from effocr_torch.kernels.cuda_nms import MAX_N, nms_kernel, nms_keep
from effocr_torch.kernels.cuda_top1 import top1, top1_kernel
from effocr_torch.kernels.nms import batched_nms, nms_mask
from effocr_torch.kernels.retrieval import NEG_INF, top1_plain
from effocr_torch.models.rcnn import rpn_keep


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: "
                    "python -m pytest tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _batch(rng, b, n, tie_frac=0.15, size=1024.0):
    boxes, valid = [], []
    for _ in range(b):
        xy = rng.uniform(0, size * 0.9, (n, 2))
        wh = rng.uniform(4, size * 0.3, (n, 2))
        boxes.append(np.concatenate([xy, xy + wh], 1))
        v = np.zeros(n, bool)
        v[:int(rng.integers(1, n + 1))] = True
        valid.append(v)
    boxes = np.stack(boxes).astype(np.float32)
    k = int(n * tie_frac)
    boxes[:, 1:k + 1] = boxes[:, :k]   # exact duplicate boxes
    return torch.from_numpy(boxes), torch.from_numpy(np.stack(valid))


@pytest.mark.parametrize("b,n", [(4, 1024), (3, 300), (2, 64), (5, 1)])
@pytest.mark.parametrize("iou_thresh", [0.01, 0.25, 0.45])
def test_kernel_matches_plain(cuda, b, n, iou_thresh):
    boxes, valid = _batch(np.random.default_rng(n), b, n)
    ref = nms_mask(boxes, None, valid, iou_thresh, presorted=True)
    before = nms_kernel.launches
    got = nms_keep(boxes.to(cuda), valid.to(cuda), iou_thresh)
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 1
    assert torch.equal(got.cpu(), ref)


def test_kernel_at_localizer_eval_shape(cuda):
    """The trainer's mAP evaluation: batch 16, max_nms 1024, IoU 0.45, conf
    0.001, so nearly every slot is valid; char-sized boxes crowded along
    a 96 x 1024 line (many overlaps), two classes offset apart."""
    rng = np.random.default_rng(16)
    b, n = 16, 1024
    cx = rng.uniform(0, 1024, (b, n))
    cy = rng.uniform(20, 76, (b, n))
    w = rng.uniform(6, 40, (b, n))
    h = rng.uniform(10, 60, (b, n))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    boxes += (rng.uniform(size=(b, n, 1)) < 0.3) * 4096.0   # class 1
    valid = np.ones((b, n), bool)
    valid[1000 + rng.integers(0, 24, b)[:, None] <= np.arange(n)] = False
    boxes = torch.from_numpy(boxes.astype(np.float32))
    valid = torch.from_numpy(valid)
    ref = nms_mask(boxes, None, valid, 0.45, presorted=True)
    got = nms_keep(boxes.to(cuda), valid.to(cuda), 0.45)
    assert torch.equal(got.cpu(), ref)
    assert 0 < int(ref.sum()) < int(valid.sum())


def test_detection_augment_card_matches_cpu(cuda):
    from effocr_torch.kernels.det_augment import (
        apply_detection_augment,
        draw_detection_augment,
    )

    rng = np.random.default_rng(7)
    b, h, w, c = 16, 96, 1024, 1
    x = torch.from_numpy(rng.uniform(0, 1, (b, h, w, c)).astype(np.float32))
    tg = np.zeros((b, 64, 5), np.float32)
    tg[..., 1:] = rng.uniform([0, 0, 4, 8], [1024, 96, 60, 80], (b, 64, 4))
    tg = torch.from_numpy(tg)
    mask = torch.from_numpy(rng.uniform(size=(b, 64)) < 0.9)
    draws = draw_detection_augment(torch.Generator().manual_seed(3), b, h,
                                   w, c)
    ref = apply_detection_augment(x, tg, mask, draws)
    got = apply_detection_augment(x.to(cuda), tg.to(cuda), mask.to(cuda),
                                  {k: v.to(cuda) for k, v in draws.items()})
    for r, g in zip(ref[:2], got[:2]):
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=0,
                                   atol=1e-5)
    assert torch.equal(got[2].cpu(), ref[2])


@pytest.mark.parametrize("n", [704, 768])
def test_rpn_keep_route_matches_plain(cuda, n):
    """The R-CNN RPN's keep mask on the card (stable sort by score, K1 on
    the sorted boxes, scatter back) against nms_mask(presorted=False) on
    the CPU: [16, n] candidates at IoU 0.7 (rcnn_s's pre-NMS top-k of 256
    a level: 704 on a 64-high canvas, 768 from 96 up), clipped to the
    canvas, with degenerate (< 1 px) boxes, exact duplicate boxes and
    scores quantised so ties are common."""
    rng = np.random.default_rng(n)
    cxy = rng.uniform(0, 1024, (16, n, 2))
    wh = rng.uniform(0.2, 120, (16, n, 2))
    boxes = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0,
                    1024).astype(np.float32)
    boxes[:, 1::7] = boxes[:, 0::7][:, :boxes[:, 1::7].shape[1]]
    scores = (np.round(rng.normal(0, 1, (16, n)) * 8) / 8).astype(
        np.float32)
    bx, sc = torch.from_numpy(boxes), torch.from_numpy(scores)
    valid = ((bx[..., 2] - bx[..., 0]) >= 1.0) & (
        (bx[..., 3] - bx[..., 1]) >= 1.0)
    ref = nms_mask(bx, sc, valid, 0.7)
    before = nms_kernel.launches
    got = rpn_keep(bx.to(cuda), sc.to(cuda), valid.to(cuda), 0.7)
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 1
    assert (~valid).any() and 0 < int(ref.sum()) < int(valid.sum())
    assert torch.equal(got.cpu(), ref)


def test_kernel_cross_tile_chain(cuda):
    n = 384
    boxes = torch.tensor(np.stack([np.arange(n) * 2.5, np.zeros(n),
                                   np.arange(n) * 2.5 + 20.0,
                                   np.full(n, 20.0)], 1), dtype=torch.float32)
    valid = torch.ones(1, n, dtype=torch.bool)
    ref = nms_mask(boxes[None], None, valid, 0.3, presorted=True)
    got = nms_keep(boxes[None].to(cuda), valid.to(cuda), 0.3)
    assert torch.equal(got.cpu(), ref)


def test_batched_nms_cuda_matches_plain(cuda):
    boxes, valid = _batch(np.random.default_rng(1), 6, 512)
    scores = torch.linspace(1.0, 0.1, 512).expand(6, 512).contiguous()
    classes = (torch.arange(512) % 5 == 0).to(torch.int32).expand(6, 512)
    args = (boxes, scores, classes.contiguous(), valid)
    ref = batched_nms(*args, 0.25, 96, presorted=True, kernel="plain")
    got = batched_nms(*(a.to(cuda) for a in args), 0.25, 96, presorted=True,
                      kernel="cuda")
    for r, g in zip(ref, got):
        assert torch.equal(r, g.cpu())


def test_kernel_rejects_bad_input(cuda):
    """Wrong dtype and strides raise; N = 2048, refused by an earlier
    design (its mask lived in one CTA's shared memory), now runs and
    matches; N past MAX_N raises with the limit named."""
    boxes, valid = _batch(np.random.default_rng(2), 2, 64)
    with pytest.raises(TypeError):
        nms_kernel(boxes.to(cuda).double(), valid.to(cuda), 0.25)
    with pytest.raises(ValueError):
        nms_kernel(boxes.to(cuda)[:, ::2], valid.to(cuda)[:, ::2], 0.25)
    big, bv = _batch(np.random.default_rng(3), 1, 2048)
    got = nms_kernel(big.to(cuda), bv.to(cuda), 0.25)
    assert torch.equal(got.cpu(), nms_mask(big, None, bv, 0.25,
                                           presorted=True))
    n = MAX_N + 1
    with pytest.raises(ValueError, match=str(MAX_N)):
        nms_kernel(torch.zeros(1, n, 4, device=cuda),
                   torch.zeros(1, n, dtype=torch.bool, device=cuda), 0.25)


@pytest.mark.parametrize("b,n,prefix,iou_thresh", [
    (8, 2048, None, 0.25), (8, 2048, None, 0.01), (4, 4096, None, 0.25),
    (4, 4096, None, 0.01), (512, 1024, 1024, 0.25), (120, 1024, 40, 0.01),
    (16, 1024, None, 0.0)])
def test_kernel_large_and_prefix_cases(cuda, b, n, prefix, iou_thresh):
    """N above the earlier design's cap, the English path's all-valid
    [512, 1024] shape, a small valid prefix (the Japanese path's shape),
    and thr = 0.0 (the exact division on every pair)."""
    boxes, valid = _batch(np.random.default_rng(n + b), b, n, size=4096.0)
    if prefix is not None:
        valid = torch.arange(n)[None].expand(b, n) < prefix
    boxes, valid = boxes.to(cuda), valid.to(cuda)
    ref = nms_mask(boxes, None, valid, iou_thresh, presorted=True)
    assert torch.equal(nms_keep(boxes, valid, iou_thresh), ref)


@pytest.mark.parametrize("iou_thresh", [0.25, 1 / 3, 0.5])
def test_kernel_near_threshold(cuda, iou_thresh):
    """Integer boxes on a small grid: many IoUs equal the threshold, so
    the kernel's division-free test must defer them to the division (as
    it must every pair of a 64-box block holding a box of infinite
    area)."""
    rng = np.random.default_rng(int(iou_thresh * 1000))
    xy = rng.integers(0, 6, (6, 300, 2))
    wh = rng.integers(1, 5, (6, 300, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(
        np.float32))
    boxes[0, 7] = torch.tensor([0.0, 0.0, 1e20, 1e20])  # area overflows
    valid = torch.ones(6, 300, dtype=torch.bool)
    ref = nms_mask(boxes, None, valid, iou_thresh, presorted=True)
    got = nms_keep(boxes.to(cuda), valid.to(cuda), iou_thresh)
    assert torch.equal(got.cpu(), ref)


def _unit(rng, n, d):
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    return x / x.norm(dim=1, keepdim=True)


@pytest.mark.parametrize("n,c,d,masked", [(4096, 11051, 320, 0.01),
                                          (1, 300, 320, 0.0),
                                          (200, 1030, 96, 0.05),
                                          (129, 128, 4, 0.0)])
def test_top1_kernel_matches_plain(cuda, n, c, d, masked):
    rng = np.random.default_rng(c)
    q, p = _unit(rng, n, d).to(cuda), _unit(rng, c, d).to(cuda)
    mask = torch.from_numpy(rng.uniform(size=c) >= masked).to(cuda)
    before = top1_kernel.launches
    s, i = top1(q, p, mask)
    torch.cuda.synchronize()
    assert top1_kernel.launches == before + 1
    rs, ri = top1_plain(q, p, mask)
    assert (s - rs).abs().max().item() <= 1e-5
    sims = torch.where(mask[None], q @ p.t(), torch.full((), NEG_INF,
                                                        device=cuda))
    top2 = torch.topk(sims, 2, dim=1).values
    sure = top2[:, 0] - top2[:, 1] > 1e-5
    assert torch.equal(i[sure], ri[sure])


@pytest.mark.parametrize("c", [127, 128, 129])
@pytest.mark.parametrize("d", [4, 324])
def test_top1_kernel_ragged_tiles(cuda, c, d):
    """C around one 128-prototype tile and D past
    the 32-deep ring stages (4: one partial stage; 324: ten full and one
    partial)."""
    rng = np.random.default_rng(c * d)
    q, p = _unit(rng, 300, d).to(cuda), _unit(rng, c, d).to(cuda)
    mask = torch.from_numpy(rng.uniform(size=c) >= 0.1).to(cuda)
    s, i = top1(q, p, mask)
    rs, ri = top1_plain(q, p, mask)
    assert (s - rs).abs().max().item() <= 1e-5
    sims = torch.where(mask[None], q @ p.t(), torch.full((), NEG_INF,
                                                        device=cuda))
    top2 = torch.topk(sims, 2, dim=1).values
    sure = top2[:, 0] - top2[:, 1] > 1e-5
    assert torch.equal(i[sure], ri[sure])


@pytest.mark.parametrize("d", [6, 322])
def test_top1_any_depth(cuda, d):
    """D not a multiple of 4: ``top1`` pads it with zeros before the
    launch (the kernel itself refuses such a D)."""
    rng = np.random.default_rng(d + 1)
    q, p = _unit(rng, 500, d).to(cuda), _unit(rng, 2000, d).to(cuda)
    mask = torch.from_numpy(rng.uniform(size=2000) >= 0.05).to(cuda)
    before = top1_kernel.launches
    s, i = top1(q, p, mask)
    torch.cuda.synchronize()
    assert top1_kernel.launches == before + 1
    rs, ri = top1_plain(q, p, mask)
    assert (s - rs).abs().max().item() <= 1e-5
    sims = torch.where(mask[None], q @ p.t(), torch.full((), NEG_INF,
                                                        device=cuda))
    top2 = torch.topk(sims, 2, dim=1).values
    sure = top2[:, 0] - top2[:, 1] > 1e-5
    assert torch.equal(i[sure], ri[sure])


def _expected_splits(n, c, slots):
    """csrc/top1.cu top1_splits: 128-query by 128-prototype tiles; up to
    one wave's worth of splits, the fewest with the least waves x tiles
    per split."""
    q_tiles, c_tiles = -(-n // 128), -(-c // 128)
    best, cost = 1, None
    for s in range(1, min(c_tiles, -(-slots // q_tiles)) + 1):
        per = -(-c_tiles // s)
        if -(-c_tiles // per) != s:
            continue
        k = -(-q_tiles * s // slots) * per
        if cost is None or k < cost:
            best, cost = s, k
    return best


def test_top1_splits_at_two_blocks_per_sm(cuda):
    """The redesigned kernel fits two blocks per SM, and the split count
    follows from that occupancy: on an H100 (132 SMs), 8 splits for the
    Japanese path's 4096 queries and 11,051 prototypes."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = top1_kernel.splits(4096, 11051)
    assert splits == _expected_splits(4096, 11051, 2 * sms)
    if sms == 132:
        assert splits == 8


@pytest.mark.parametrize("case", ["ties", "ties_masked", "all_masked"])
def test_top1_kernel_exact_cases(cuda, case):
    """Quarter-step values (exact products): ties must go to the first
    index; all rows masked gives (-1e30, 0)."""
    rng = np.random.default_rng(5)
    c, d = 1500, 32
    p = torch.from_numpy(rng.integers(-2, 3, (c, d)).astype(np.float32) / 4)
    dup = torch.from_numpy(rng.integers(0, c, 300))
    p[torch.from_numpy(rng.integers(0, c, 300))] = p[dup]
    q = p[torch.from_numpy(rng.integers(0, c, 700))].clone()
    mask = torch.ones(c, dtype=torch.bool)
    if case == "ties_masked":
        mask[dup[:100]] = False
    elif case == "all_masked":
        mask[:] = False
    q, p, mask = q.to(cuda), p.to(cuda), mask.to(cuda)
    s, i = top1(q, p, mask)
    rs, ri = top1_plain(q, p, mask)
    assert torch.equal(i, ri) and torch.equal(s, rs)
    if case == "all_masked":
        assert (i == 0).all() and (s == NEG_INF).all()


def test_top1_kernel_rejects_bad_input(cuda):
    rng = np.random.default_rng(6)
    q, p = _unit(rng, 8, 64).to(cuda), _unit(rng, 50, 64).to(cuda)
    mask = torch.ones(50, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        top1_kernel(q.double(), p, mask)
    with pytest.raises(ValueError):
        top1_kernel(q[:, :62].contiguous(), p[:, :62].contiguous(), mask)
    with pytest.raises(ValueError):
        top1_kernel(q[:, ::2], p[:, ::2], mask)
    with pytest.raises(ValueError):
        top1_kernel(q, p.cpu(), mask)
