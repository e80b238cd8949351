"""effocr_torch's top-1 retrieval against the JAX package's.

``top1_plain`` (the plain version of the fused top-1 kernel K2) against
JAX ``pallas_top1`` in interpret mode and against JAX ``knn_topk``, on
the same numpy inputs: ragged C (not a multiple of the Pallas kernel's
512-row tiles), N not a multiple of 128, blacklisted rows, exact ties
between duplicate prototype rows, and every row masked.  The CUDA route
(kernels/cuda_top1.py ``top1``) on CPU tensors is the plain version and
launches nothing.

Tolerances: indices identical; scores rtol 1e-5 (float32 products summed
in another order).  The tie cases use values exact in float32 (multiples
of 1/4, D = 32), so every summation order gives the same bits and the
first-index rule decides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effocr_tpu.kernels.pallas_retrieval import pallas_top1
from effocr_tpu.kernels.retrieval import knn_topk as j_knn_topk
from effocr_torch.kernels import cuda_top1
from effocr_torch.kernels.retrieval import NEG_INF, knn_topk, top1_plain


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "ragged":
        q, p, mask = _unit(rng, 77, 64), _unit(rng, 300, 64), None
    elif name == "masked":
        q, p = _unit(rng, 200, 96), _unit(rng, 1030, 96)
        mask = rng.uniform(size=1030) > 0.05
        # some queries' exact matches blacklisted
        q[:20] = p[np.flatnonzero(~mask)[:20]]
    elif name == "single_query":
        q, p, mask = _unit(rng, 1, 64), _unit(rng, 515, 64), None
    elif name in ("duplicates", "duplicates_masked"):
        # exact arithmetic: quarter steps, D = 32
        p = rng.integers(-2, 3, (260, 32)).astype(np.float32) / 4
        dup = rng.integers(0, 260, 40)
        p[rng.integers(0, 260, 40)] = p[dup]       # duplicate rows
        q = p[rng.integers(0, 260, 50)].copy()
        mask = None
        if name == "duplicates_masked":
            mask = np.ones(260, bool)
            mask[dup[:10]] = False
    elif name == "all_masked":
        q, p = _unit(rng, 10, 32), _unit(rng, 140, 32)
        mask = np.zeros(140, bool)
    else:
        raise KeyError(name)
    return q, p, mask


CASES = ["ragged", "masked", "single_query", "duplicates",
         "duplicates_masked", "all_masked"]


@pytest.mark.parametrize("name", CASES)
def test_top1_plain_matches_pallas_top1(name):
    q, p, mask = _case(name)
    jm = None if mask is None else jnp.asarray(mask)
    js, ji = pallas_top1(jnp.asarray(q), jnp.asarray(p), row_mask=jm,
                         interpret=True)
    ts, ti = top1_plain(torch.from_numpy(q), torch.from_numpy(p),
                        None if mask is None else torch.from_numpy(mask))
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    assert ts.shape == ti.shape == (len(q),)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    if name == "all_masked":
        assert (ti.numpy() == 0).all() and (ts.numpy() == NEG_INF).all()


@pytest.mark.parametrize("name", CASES)
def test_top1_plain_matches_knn_topk(name):
    """Against the JAX matmul + lax.top_k route, and the port's own
    knn_topk with the queries taken as normalized."""
    q, p, mask = _case(name)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    js, ji = j_knn_topk(jnp.asarray(q), jnp.asarray(p), k=1, row_mask=jm,
                        normalize_queries=False)
    ts, ti = top1_plain(torch.from_numpy(q), torch.from_numpy(p), tm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji)[:, 0])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js)[:, 0], rtol=1e-5)
    ks, ki = knn_topk(torch.from_numpy(q), torch.from_numpy(p), k=1,
                      row_mask=tm, normalize_queries=False)
    np.testing.assert_array_equal(ti.numpy(), ki[:, 0].numpy())


def test_ties_go_to_the_first_index():
    p = np.zeros((300, 8), np.float32)
    p[:, 0] = 1.0                     # every row ties
    q = np.eye(8, dtype=np.float32)[:3]
    mask = np.ones(300, bool)
    mask[:5] = False
    s, i = top1_plain(torch.from_numpy(q), torch.from_numpy(p),
                      torch.from_numpy(mask))
    assert i.tolist() == [5, 5, 5] and s.tolist() == [1.0, 0.0, 0.0]


def test_cuda_route_on_cpu_tensors_is_the_plain_version():
    q, p, mask = _case("masked")
    before = cuda_top1.top1_kernel.launches
    s, i = cuda_top1.top1(torch.from_numpy(q), torch.from_numpy(p),
                          torch.from_numpy(mask))
    rs, ri = top1_plain(torch.from_numpy(q), torch.from_numpy(p),
                        torch.from_numpy(mask))
    assert cuda_top1.top1_kernel.launches == before
    assert torch.equal(i, ri) and torch.equal(s, rs)


@pytest.mark.parametrize("d", [6, 322])
def test_pad_depth_keeps_top1(d):
    """K2's wrapper zero-pads D to a multiple of 4 (the JAX kernel takes
    any D): top1_plain on the padded rows gives the same scores and
    indices, bit for bit, and pallas_top1 agrees on the indices."""
    rng = np.random.default_rng(d)
    q, p = _unit(rng, 150, d), _unit(rng, 700, d)
    mask = torch.from_numpy(rng.uniform(size=700) > 0.1)
    qt, pt = torch.from_numpy(q), torch.from_numpy(p)
    qp, pp = cuda_top1.pad_depth(qt, pt)
    assert qp.shape[1] == pp.shape[1] == d + (-d % 4)
    assert torch.equal(qp[:, :d], qt) and not qp[:, d:].any()
    s, i = top1_plain(qt, pt, mask)
    sp, ip = top1_plain(qp, pp, mask)
    assert torch.equal(s, sp) and torch.equal(i, ip)
    _, ref = pallas_top1(jnp.asarray(q), jnp.asarray(p),
                         row_mask=jnp.asarray(mask.numpy()), interpret=True)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ref))
