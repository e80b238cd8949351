"""kNN retrieval: L2-normalize -> float32 matmul -> top-k (the JAX
package's kernels/retrieval.py), and ``top1_plain``, the plain version of
the fused top-1 kernel (K2, kernels/cuda_top1.py).

The matmul is ``torch.matmul`` in full float32: the port's entry points
turn TF32 off (core/device.py), because retrieval margins between glyph
prototypes are small.  Blacklisted prototype rows get -1e30.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
