"""ViT and XCiT encoders, the PyTorch twins of the JAX package's
models/vit.py.

``forward`` takes NHWC images and returns the CLS embedding [B, dim] in
float32.  Numerics follow the Flax modules: convolutions, Dense layers
and attention products in ``dtype`` (bfloat16 by default), LayerNorm in
float32 (eps 1e-6) cast back to ``dtype`` where the Flax code casts it,
the softmax in float32 then cast to ``dtype``, exact (erf) GELU (the
``F.gelu`` default), and the
learned scales (``gamma*``, ``temperature``) and embeddings (``cls``,
``pos``) cast to the activation's dtype before use.  Attention is plain
matmuls and a softmax, as in the JAX package (no fused attention call:
it rounds differently).

Submodule names mirror the Flax scopes, auto-names included
(``LayerNorm_0..2``, ``SelfAttention_0``, ``XCA_0``, ``LPI_0``,
``Mlp_0`` with ``Dense_0`` / ``Dense_1``), so interop/flax_bridge.py maps
checkpoints by name.  The token grid is fixed at construction from
``image_size`` (Flax sizes ``pos`` from the first input it sees).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from effocr_torch.models.layers import BatchNorm, Conv, Dense, LayerNorm


def _inv_sqrt_scale(hd: int, dtype: torch.dtype, device) -> torch.Tensor:
    """sqrt(hd) rounded to float32, then to ``dtype`` (JAX's
    ``jnp.sqrt(hd).astype(x.dtype)``)."""
    return torch.tensor(math.sqrt(hd), dtype=torch.float32,
                        device=device).to(dtype)


def _softmax(attn: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(attn.float(), dim=-1).to(dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, out, dtype=dtype)

    def forward(self, x):
        return self.Dense_1(F.gelu(self.Dense_0(x)))


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x):
        b, n, _ = x.shape
        hd = self.dim // self.heads
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) / _inv_sqrt_scale(
            hd, q.dtype, q.device)
        attn = _softmax(attn, self.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
        return self.proj(out.reshape(b, n, self.dim))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.LayerNorm_0 = LayerNorm(dim)
        self.SelfAttention_0 = SelfAttention(dim, heads, dtype)
        self.LayerNorm_1 = LayerNorm(dim)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio), dim, dtype)

    def forward(self, x):
        x = x + self.SelfAttention_0(self.LayerNorm_0(x).to(self.dtype))
        return x + self.Mlp_0(self.LayerNorm_1(x).to(self.dtype))


class ViT(nn.Module):
    """Classic ViT; returns the CLS embedding [B, dim]."""

    def __init__(self, patch: int = 16, dim: int = 384, depth: int = 12,
                 heads: int = 6, image_size: int = 224, in_channels: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"the patch {patch}")
        self.dim, self.depth, self.dtype = dim, depth, dtype
        n = (image_size // patch) ** 2
        self.patch_embed = Conv(in_channels, dim, patch, patch, 0,
                                dtype=dtype)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos = nn.Parameter(torch.zeros(1, n + 1, dim))
        for i in range(depth):
            setattr(self, f"block{i}", ViTBlock(dim, heads, dtype=dtype))
        self.norm = LayerNorm(dim)
        self.out_features = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, C] float images (NHWC, as in the JAX package)."""
        b = x.shape[0]
        x = self.patch_embed(x.permute(0, 3, 1, 2).to(self.dtype))
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.dim)
        cls = self.cls.to(x.dtype).expand(b, 1, self.dim)
        x = torch.cat([cls, x], dim=1) + self.pos.to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.norm(x)[:, 0].float()


# ---------------------------------------------------------------------- XCiT

class XCA(nn.Module):
    """Cross-covariance attention: softmax over channel-channel
    similarities of Q and K L2-normalised over the token axis (the norm in
    float32, clamped at 1e-6, cast back), times a learned per-head
    ``temperature``."""

    def __init__(self, dim: int, heads: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.proj = Dense(dim, dim, dtype=dtype)

    @staticmethod
    def _normalize(t: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(t.float(), dim=1, keepdim=True)
        return t / torch.clamp(norm, min=1e-6).to(t.dtype)

    def forward(self, x):
        b, n, _ = x.shape
        hd = self.dim // self.heads
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # [b,n,h,d]
        qn, kn = self._normalize(q), self._normalize(k)
        attn = torch.einsum("bnhd,bnhe->bhde", qn, kn) * \
            self.temperature.to(qn.dtype)
        attn = _softmax(attn, self.dtype)
        out = torch.einsum("bhde,bnhe->bnhd", attn, v)
        return self.proj(out.reshape(b, n, self.dim))


class LPI(nn.Module):
    """Local patch interaction: two depthwise 3x3 convs over the token
    grid, exact GELU and a BatchNorm (Flax's defaults: eps 1e-5,
    momentum 0.99) between them."""

    def __init__(self, dim: int, hw: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hw = hw
        self.conv1 = Conv(dim, dim, 3, 1, 1, groups=dim, dtype=dtype)
        self.bn = BatchNorm(dim, eps=1e-5, momentum=0.99)
        self.conv2 = Conv(dim, dim, 3, 1, 1, groups=dim, dtype=dtype)

    def forward(self, x):
        b, n, d = x.shape
        g = x.reshape(b, self.hw, self.hw, d).permute(0, 3, 1, 2)
        g = self.bn(F.gelu(self.conv1(g)))
        return self.conv2(g).permute(0, 2, 3, 1).reshape(b, n, d)


class XCiTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, hw: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.LayerNorm_0 = LayerNorm(dim)
        self.XCA_0 = XCA(dim, heads, dtype)
        self.LayerNorm_1 = LayerNorm(dim)
        self.LPI_0 = LPI(dim, hw, dtype)
        self.LayerNorm_2 = LayerNorm(dim)
        self.Mlp_0 = Mlp(dim, 4 * dim, dim, dtype)
        self.gamma1 = nn.Parameter(torch.ones(dim))
        self.gamma2 = nn.Parameter(torch.ones(dim))
        self.gamma3 = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        dt = self.dtype
        x = x + self.gamma1.to(x.dtype) * self.XCA_0(
            self.LayerNorm_0(x).to(dt))
        x = x + self.gamma3.to(x.dtype) * self.LPI_0(
            self.LayerNorm_1(x).to(dt))
        return x + self.gamma2.to(x.dtype) * self.Mlp_0(
            self.LayerNorm_2(x).to(dt))


class ClassAttentionBlock(nn.Module):
    """CaiT-style class attention with timm's XCiT semantics, two quirks
    included as in the JAX package: the attention residual adds the
    *norm1-ed* non-CLS tokens (times gamma1), and the MLP residual re-adds
    the token stream to itself (non-CLS tokens double each block).  The
    second LayerNorm takes every token (``tokens_norm``, which every timm
    XCiT model and the JAX package's constructors set)."""

    def __init__(self, dim: int, heads: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.LayerNorm_0 = LayerNorm(dim)
        self.q = Dense(dim, dim, dtype=dtype)
        self.k = Dense(dim, dim, dtype=dtype)
        self.v = Dense(dim, dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.gamma1 = nn.Parameter(torch.ones(dim))
        self.LayerNorm_1 = LayerNorm(dim)
        self.gamma2 = nn.Parameter(torch.ones(dim))
        self.Mlp_0 = Mlp(dim, 4 * dim, dim, dtype)

    def forward(self, x):
        b, n, _ = x.shape
        hd = self.dim // self.heads
        h = self.LayerNorm_0(x).to(self.dtype)
        q = self.q(h[:, :1]).reshape(b, 1, self.heads, hd)
        k = self.k(h).reshape(b, n, self.heads, hd)
        v = self.v(h).reshape(b, n, self.heads, hd)
        attn = torch.einsum("bqhd,bnhd->bhqn", q, k) / _inv_sqrt_scale(
            hd, q.dtype, q.device)
        attn = _softmax(attn, self.dtype)
        cls = torch.einsum("bhqn,bnhd->bqhd", attn, v)
        cls = self.proj(cls.reshape(b, 1, self.dim))
        x = x + self.gamma1.to(x.dtype) * torch.cat([cls, h[:, 1:]], dim=1)
        x = self.LayerNorm_1(x).to(self.dtype)
        cls2 = self.gamma2.to(x.dtype) * self.Mlp_0(x[:, :1])
        return x + torch.cat([cls2, x[:, 1:]], dim=1)


class XCiT(nn.Module):
    """XCiT; returns the CLS embedding [B, dim]."""

    def __init__(self, patch: int = 8, dim: int = 384, depth: int = 12,
                 heads: int = 8, cls_depth: int = 2, image_size: int = 224,
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dim, self.depth, self.cls_depth = dim, depth, cls_depth
        self.dtype = dtype
        # conv patch embed: 3x3 stride-2 convs padded (1, 1) on each side
        # (torch Conv2d(padding=1), as timm's checkpoints: not "SAME")
        self.n_convs = {4: 2, 8: 3, 16: 4}[patch]
        f = dim // (2 ** (self.n_convs - 1))
        ch, hw = in_channels, image_size
        for i in range(self.n_convs):
            out = min(f * 2 ** i, dim)
            setattr(self, f"patch_conv{i}", Conv(ch, out, 3, 2, 1,
                                                 dtype=dtype))
            ch, hw = out, -(-hw // 2)
        self.hw = hw
        self.pos = nn.Parameter(torch.zeros(1, hw * hw, dim))
        for i in range(depth):
            setattr(self, f"block{i}", XCiTBlock(dim, heads, hw, dtype))
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        for i in range(cls_depth):
            setattr(self, f"cls_block{i}",
                    ClassAttentionBlock(dim, heads, dtype=dtype))
        self.norm = LayerNorm(dim)
        self.out_features = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, C] float images (NHWC, as in the JAX package)."""
        b = x.shape[0]
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for i in range(self.n_convs):
            x = getattr(self, f"patch_conv{i}")(x)
            if i < self.n_convs - 1:
                x = F.gelu(x)
        if x.shape[2] != self.hw:
            raise ValueError(f"input gives a {x.shape[2]}-token grid side; "
                             f"this model was built for {self.hw}")
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.dim)
        x = x + self.pos.to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        cls = self.cls.to(x.dtype).expand(b, 1, self.dim)
        x = torch.cat([cls, x], dim=1)
        for i in range(self.cls_depth):
            x = getattr(self, f"cls_block{i}")(x)
        return self.norm(x)[:, 0].float()


def vit_small_patch16(**kw):
    return ViT(patch=16, dim=384, depth=12, heads=6, **kw)


def vit_tiny_patch16(**kw):
    return ViT(patch=16, dim=192, depth=12, heads=3, **kw)


def xcit_small_12_p8(**kw):
    return XCiT(patch=8, dim=384, depth=12, heads=8, **kw)


def xcit_tiny_12_p8(**kw):
    return XCiT(patch=8, dim=192, depth=12, heads=4, **kw)
