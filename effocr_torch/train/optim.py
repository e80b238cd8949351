"""AdamW and the warmup + cosine learning-rate schedule, written out as
optax 0.2.6 computes them (the JAX package trains with
``optax.adamw`` over ``optax.warmup_cosine_decay_schedule``):

- ``scale_by_adam``: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu,
  bias correction by ``1 - b^(count + 1)``, u = mu_hat / (sqrt(nu_hat) +
  eps) with eps outside the square root;
- ``add_decayed_weights``: u + wd * p on every parameter, no mask, added
  before the learning rate scales it (``torch.optim.AdamW`` multiplies
  the decay in first, which rounds differently);
- ``scale_by_learning_rate``: p += -lr(count) * u, the schedule indexed
  by the update count before its increment (so the first update of a
  warmup has lr 0).

``max_grad_norm`` puts optax's ``clip_by_global_norm`` ahead of it (the
localizer trainer's ``optax.chain(clip_by_global_norm(10.0), adamw)``):
the float32 norm of every gradient taken together, and when it is not
below the limit each gradient becomes ``(g / norm) * limit``, divided
first (``torch.nn.utils.clip_grad_norm_`` multiplies by ``limit / (norm
+ 1e-6)`` instead).

Each parameter group has its own schedule (the JAX trainer's
``multi_transform`` gives the aux head ``aux_lr_mult`` times the model's);
the groups step together, so one count serves all.  Scalars are rounded
to float32 where optax computes them in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], float]]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule (exponent 1) in float32."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got {decay_steps - warmup_steps}")
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)

    def linear(count: int):
        if warmup_steps <= 0:
            return f32(init_value)
        c = min(max(count, 0), warmup_steps)
        frac = f32(1) - f32(f32(c) / f32(warmup_steps))
        return f32(f32(init_value - peak_value) * frac) + f32(peak_value)

    def cosine(count: int):
        c = f32(min(float(count), cos_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(f32(math.pi) * c)
                                            / f32(cos_steps), dtype=f32))
        return f32(peak_value) * (f32(1 - alpha) * decay + f32(alpha))

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return float(linear(count))
        return float(cosine(count - warmup_steps))

    return schedule


def scaled(lr: Schedule, mult: float) -> Schedule:
    """lr times ``mult``: a schedule's float32 value times mult, or the
    constant times mult."""
    if mult == 1.0:
        return lr
    if callable(lr):
        return lambda t: float(np.float32(lr(t)) * np.float32(mult))
    return lr * mult


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place on the device, without a host
    sync: returns the global norm (a float32 device scalar)."""
    norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads)).float())
    keep = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


class AdamW:
    """optax.adamw(lr, b1, b2, eps, weight_decay) over parameter groups
    [(params, lr or schedule), ...], optionally behind
    ``clip_by_global_norm(max_grad_norm)``; ``step()`` reads each
    ``.grad``."""

    def __init__(self, groups: Sequence[Tuple[List[torch.Tensor], Schedule]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4,
                 max_grad_norm: Optional[float] = None):
        self.groups = [(list(ps), lr) for ps, lr in groups]
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.mu = [[torch.zeros_like(p) for p in ps] for ps, _ in self.groups]
        self.nu = [[torch.zeros_like(p) for p in ps] for ps, _ in self.groups]

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for ps, _ in self.groups for p in ps]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def lr(self, group: int) -> float:
        lr = self.groups[group][1]
        return lr(self.count) if callable(lr) else lr

    @torch.no_grad()
    def step(self) -> None:
        f32 = np.float32
        b1, b2 = self.b1, self.b2
        n = self.count + 1
        bc1 = float(f32(1) - f32(b1) ** f32(n))
        bc2 = float(f32(1) - f32(b2) ** f32(n))
        if self.max_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in self.params],
                                 self.max_grad_norm)
        for gi, (ps, _) in enumerate(self.groups):
            lr = float(-f32(self.lr(gi)))
            grads = [p.grad for p in ps]
            mu, nu = self.mu[gi], self.nu[gi]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - b2))
            den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
            torch._foreach_add_(upd, torch._foreach_mul(ps, self.wd))
            torch._foreach_mul_(upd, lr)
            torch._foreach_add_(ps, upd)
        self.count = n

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "mu": [[t.detach().cpu().numpy() for t in g] for g in self.mu],
                "nu": [[t.detach().cpu().numpy() for t in g] for g in self.nu]}

    def load_state_dict(self, state: Dict) -> None:
        shapes = [[tuple(t.shape) for t in g] for g in self.mu]
        got = [[tuple(np.shape(a)) for a in g] for g in state["mu"]]
        if got != shapes:
            raise ValueError("optimizer state does not match the parameters "
                             f"({got} vs {shapes})")
        self.count = int(state["count"])
        for dst, src in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            for tg, ag in zip(dst, src):
                for t, a in zip(tg, ag):
                    t.copy_(torch.as_tensor(np.asarray(a)))
