"""kNN retrieval: L2-normalize -> float32 matmul -> top-k (the JAX
package's kernels/retrieval.py), and ``top1_plain``, the plain version of
the fused top-1 kernel (K2, kernels/cuda_top1.py).

The matmul is ``torch.matmul`` in full float32: the port's entry points
turn TF32 off (core/device.py), because retrieval margins between glyph
prototypes are small.  Blacklisted prototype rows get -1e30.

``knn_topk_sharded`` splits the prototype rows over a list of devices
(the JAX package's sharding over the mesh's model axis): each shard takes
its local top-k (with k = 1 on a CUDA device, the fused top-1 kernel,
kernels/cuda_top1.py) and its global offset, and one re-top-k over the
shards' candidates on the first device gives the exact global result,
the first index on ties.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1e30


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


def knn_topk(
    queries: torch.Tensor,
    prototypes: torch.Tensor,
    k: int = 1,
    row_mask: Optional[torch.Tensor] = None,
    normalize_queries: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner-product neighbours.

    queries [N, D]; prototypes [C, D] (pre-normalized at index build);
    row_mask [C] bool, False = blacklisted.  Returns (scores, indices),
    each [N, k]; ties go to the lower prototype index (lax.top_k order).
    """
    q = l2_normalize(queries) if normalize_queries else queries
    sims = torch.matmul(q.float(), prototypes.float().t())
    if row_mask is not None:
        sims = torch.where(row_mask[None, :], sims,
                           torch.full_like(sims, NEG_INF))
    if k == 1:
        # argmax returns the first maximal index
        idx = torch.argmax(sims, dim=1, keepdim=True)
        return torch.gather(sims, 1, idx), idx
    scores, idx = torch.sort(sims, dim=1, descending=True, stable=True)
    return scores[:, :k], idx[:, :k]


def top1_plain(queries: torch.Tensor, prototypes: torch.Tensor,
               row_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [N] float32, indices [N] int32) of the best inner-product
    prototype: the contract of the JAX package's pallas_top1.

    queries [N, D] (already L2-normalized), prototypes [C, D], row_mask
    [C] bool (False = blacklisted, scores -1e30).  Ties go to the first
    index; with every row masked a query gets (-1e30, 0)."""
    sims = torch.matmul(queries.float(), prototypes.float().t())
    if row_mask is not None:
        sims = torch.where(row_mask[None, :], sims,
                           torch.full_like(sims, NEG_INF))
    idx = torch.argmax(sims, dim=1, keepdim=True)   # first maximal index
    return torch.gather(sims, 1, idx)[:, 0], idx[:, 0].to(torch.int32)


def knn_topk_sharded(
    queries: torch.Tensor,
    prototypes: torch.Tensor,
    devices: Sequence,
    k: int = 1,
    row_mask: Optional[torch.Tensor] = None,
    normalize_queries: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k with the prototype rows split over ``devices`` (the
    same device more than once included).

    queries [N, D]; prototypes [C, D]; C is padded to a multiple of the
    number of shards with masked zero rows, as the JAX package pads it.
    Each shard scores its [C/M, D] rows and takes a local top-k (k = 1:
    the top-1 kernel on a CUDA device, its plain version on the CPU),
    offset to global row numbers; the [N, M*k] candidates, shard-major,
    are re-ranked on the first device with a stable sort, so ties go to
    the lower global index.  Returns (scores, indices) [N, k] on the
    first device, the digits of ``knn_topk`` on the unsharded matrix."""
    from effocr_torch.kernels import cuda_top1

    m = len(devices)
    c = prototypes.shape[0]
    if row_mask is None:
        row_mask = torch.ones((c,), dtype=torch.bool,
                              device=prototypes.device)
    pad = -c % m
    if pad:
        prototypes = torch.cat([prototypes, prototypes.new_zeros(
            (pad, prototypes.shape[1]))])
        row_mask = torch.cat([row_mask, row_mask.new_zeros((pad,))])
    c_local = (c + pad) // m
    q = l2_normalize(queries) if normalize_queries else queries
    k_eff = min(k, c_local)
    scores, indices = [], []
    for i, dev in enumerate(devices):
        dev = torch.device(dev)
        qs = q.to(dev)
        ps = prototypes[i * c_local:(i + 1) * c_local].to(dev)
        mask = row_mask[i * c_local:(i + 1) * c_local].to(dev)
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            if k_eff == 1:
                s, j = cuda_top1.top1(qs.float(), ps.float(), mask)
                s, j = s[:, None], j[:, None].long()
            else:
                s, j = knn_topk(qs, ps, k=k_eff, row_mask=mask,
                                normalize_queries=False)
        if k_eff < k:
            s = torch.cat([s, s.new_full((s.shape[0], k - k_eff),
                                         NEG_INF)], 1)
            j = torch.cat([j, j.new_zeros((j.shape[0], k - k_eff))], 1)
        scores.append(s.to(devices[0]))
        indices.append(j.to(devices[0]) + i * c_local)
    flat_s = torch.cat(scores, 1)
    flat_i = torch.cat(indices, 1)
    gs, order = torch.sort(flat_s, dim=1, descending=True, stable=True)
    return gs[:, :k], torch.gather(flat_i, 1, order[:, :k])
