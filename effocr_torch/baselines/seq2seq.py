"""Seq2seq OCR baseline, the PyTorch twin of the JAX package's
baselines/seq2seq.py: a ViT-style patch encoder over a fixed [H, W]
line canvas and a causal transformer decoder with cross-attention over
a char-level vocabulary, with greedy and beam decoding at a fixed
length.

Numerics follow the Flax modules (float32 by default): LayerNorm with
Flax's epsilon 1e-6 and fast variance, the encoder's attention and MLP
from models/vit.py (exact erf GELU, as the JAX package's vit.Mlp asks),
the decoder's attention scores divided by sqrt(head dim) (a true
division: a device-side divisor, since CUDA multiplies by the reciprocal
of a host scalar), masked with -1e30 and soft-maxed in float32.  uint8
images are divided by 255 on the device.  Submodule and parameter names
mirror the Flax scopes (``patch_embed``, ``enc_pos``, ``enc{i}``,
``enc_norm``, ``tok_embed.embedding``, ``dec_pos``, ``dec{i}`` with
``self_q/k/v/o`` and ``cross_q/k/v/o``, ``dec_norm``, ``head``), so
interop/flax_bridge.py maps ``seq2seq_best.msgpack`` both ways.

Decoding recomputes the whole decoder over ``max_len`` tokens at every
step and never stops early, as the JAX package's ``lax.scan`` programs
do.  Ties: ``greedy_decode`` takes the first maximum (``torch.argmax``,
as ``jnp.argmax``); ``beam_decode`` ranks candidates with a stable
descending sort, so equal scores go to the lower flat index, as
``lax.top_k`` does (``torch.topk`` promises no order).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from effocr_torch.models.factory import _truncated_normal
from effocr_torch.models.factory import init_params as _init_layers
from effocr_torch.models.layers import Conv, Dense, LayerNorm
from effocr_torch.models.vit import Mlp, SelfAttention

PAD, BOS, EOS = 0, 1, 2
# the mask fill of the decoder's attention; the score of a finished
# beam's non-PAD continuations
NEG_INF = -1e30
NEG_INF_BEAM = -1e9


class CharTokenizer:
    """Char-level vocab with PAD/BOS/EOS at 0/1/2."""

    def __init__(self, charset: Sequence[str]):
        self.chars = sorted(set(charset))
        self.char_to_id = {c: i + 3 for i, c in enumerate(self.chars)}
        self.id_to_char = {i + 3: c for i, c in enumerate(self.chars)}

    @property
    def vocab_size(self) -> int:
        return len(self.chars) + 3

    def encode(self, text: str, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        ids = [BOS] + [self.char_to_id[c] for c in text if c in self.char_to_id]
        ids = ids[: max_len - 1] + [EOS]
        out = np.full((max_len,), PAD, np.int32)
        out[: len(ids)] = ids
        mask = np.zeros((max_len,), bool)
        mask[: len(ids)] = True
        return out, mask

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            if i == EOS:
                break
            if i >= 3:
                out.append(self.id_to_char.get(int(i), ""))
        return "".join(out)


class Embed(nn.Module):
    """Flax ``nn.Embed``: an ``embedding`` table [vocab, dim]."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        for name in ("self", "cross"):
            for part in "qkvo":
                setattr(self, f"{name}_{part}", Dense(dim, dim, dtype=dtype))
        self.LayerNorm_0 = LayerNorm(dim)
        self.LayerNorm_1 = LayerNorm(dim)
        self.LayerNorm_2 = LayerNorm(dim)
        self.Mlp_0 = Mlp(dim, 4 * dim, dim, dtype)
        self.register_buffer("sqrt_hd", torch.tensor(math.sqrt(dim // heads)),
                             persistent=False)

    def _mha(self, q_in, kv_in, mask, name):
        b, hd = q_in.shape[0], self.dim // self.heads
        q, k, v = (getattr(self, f"{name}_{p}")(t).reshape(
            b, -1, self.heads, hd) for p, t in (("q", q_in), ("k", kv_in),
                                                ("v", kv_in)))
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) / self.sqrt_hd.to(
            q.dtype)
        if mask is not None:
            attn = attn.masked_fill(~mask, NEG_INF)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, -1, self.dim)
        return getattr(self, f"{name}_o")(o)

    def forward(self, x, memory, causal_mask):
        h = self.LayerNorm_0(x).to(self.dtype)
        x = x + self._mha(h, h, causal_mask, "self")
        h = self.LayerNorm_1(x).to(self.dtype)
        x = x + self._mha(h, memory, None, "cross")
        h = self.LayerNorm_2(x).to(self.dtype)
        return x + self.Mlp_0(h)


class EncBlock(nn.Module):
    """The JAX package's ``_EncBlock``: pre-norm self-attention + MLP."""

    def __init__(self, dim: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.LayerNorm_0 = LayerNorm(dim)
        self.SelfAttention_0 = SelfAttention(dim, heads, dtype)
        self.LayerNorm_1 = LayerNorm(dim)
        self.Mlp_0 = Mlp(dim, 4 * dim, dim, dtype)

    def forward(self, x):
        x = x + self.SelfAttention_0(self.LayerNorm_0(x).to(self.dtype))
        return x + self.Mlp_0(self.LayerNorm_1(x).to(self.dtype))


class Seq2SeqOCR(nn.Module):
    def __init__(self, vocab_size: int, img_h: int = 64, img_w: int = 512,
                 patch: int = 8, dim: int = 256, enc_depth: int = 6,
                 dec_depth: int = 4, heads: int = 8, max_len: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if img_h % patch or img_w % patch:
            # Flax's "SAME" patch conv pads such a canvas, and the JAX
            # model's enc_pos (sized by floor division) then mismatches
            raise ValueError(f"canvas {img_h} x {img_w} is not a multiple "
                             f"of the patch {patch}")
        self.vocab_size, self.max_len = vocab_size, max_len
        self.dim, self.enc_depth, self.dec_depth = dim, enc_depth, dec_depth
        self.dtype = dtype
        self.patch_embed = Conv(3, dim, patch, patch, 0, dtype=dtype)
        n_tokens = (img_h // patch) * (img_w // patch)
        self.enc_pos = nn.Parameter(torch.zeros(1, n_tokens, dim))
        for i in range(enc_depth):
            setattr(self, f"enc{i}", EncBlock(dim, heads, dtype))
        self.enc_norm = LayerNorm(dim)
        self.tok_embed = Embed(vocab_size, dim)
        self.dec_pos = nn.Parameter(torch.zeros(1, max_len, dim))
        for i in range(dec_depth):
            setattr(self, f"dec{i}", DecoderBlock(dim, heads, dtype))
        self.dec_norm = LayerNorm(dim)
        self.head = Dense(dim, vocab_size, dtype=torch.float32)
        self.register_buffer("byte_scale", torch.tensor(255.0),
                             persistent=False)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] uint8 or float in [0, 1] -> memory
        [B, N, D]; uint8 is normalized here, so the host ships bytes."""
        if images.dtype == torch.uint8:
            images = images.float() / self.byte_scale
        x = self.patch_embed(images.permute(0, 3, 1, 2).to(self.dtype))
        b = x.shape[0]
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.dim) + self.enc_pos.to(
            self.dtype)
        for i in range(self.enc_depth):
            x = getattr(self, f"enc{i}")(x)
        return self.enc_norm(x).to(self.dtype)

    def decode_logits(self, memory: torch.Tensor, token_ids: torch.Tensor
                      ) -> torch.Tensor:
        """Teacher-forced logits [B, T, vocab] for input tokens [B, T]."""
        t = token_ids.shape[1]
        x = self.tok_embed(token_ids.long()) + self.dec_pos[:, :t].to(
            self.dtype)
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                       device=x.device))[None, None]
        for i in range(self.dec_depth):
            x = getattr(self, f"dec{i}")(x, memory, causal)
        return self.head(self.dec_norm(x))

    def forward(self, images, token_ids):
        return self.decode_logits(self.encode(images), token_ids)


def init_params(model: Seq2SeqOCR, seed: int) -> Seq2SeqOCR:
    """Seeded random init with Flax's default initializers: Conv and Dense
    kernels lecun_normal (truncated), biases 0, LayerNorm at identity
    (factory.init_params); ``tok_embed`` variance_scaling(1, fan_in,
    normal) over the feature axis, N(0, 1 / dim); ``enc_pos`` and
    ``dec_pos`` truncated_normal(0.02)."""
    _init_layers(model, seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        e = model.tok_embed.embedding
        e.copy_(torch.randn(e.shape, generator=g) / math.sqrt(e.shape[1]))
        for p in (model.enc_pos, model.dec_pos):
            p.copy_(_truncated_normal(p.shape, g) * 0.02)
    return model


def sequence_loss(logits: torch.Tensor, token_ids: torch.Tensor,
                  token_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean next-token cross entropy of teacher-forced logits
    (for input ``token_ids[:, :-1]``)."""
    targets = token_ids[:, 1:].long()
    mask = token_mask[:, 1:].to(torch.float32)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_seq2seq_train_step(model: nn.Module, optimizer,
                            bank_mode: bool = False):
    """CE teacher-forcing step: forward -> loss -> backward ->
    ``optimizer.step()`` (train/optim.py AdamW for optax.adamw); returns
    the loss as a device scalar.  Stream mode: step(images, token_ids,
    token_mask); bank mode: step(bank_imgs, bank_ids, bank_masks, idx),
    gathered on the bank's device."""

    def step(images, token_ids, token_mask):
        optimizer.zero_grad()
        loss = sequence_loss(model(images, token_ids[:, :-1]), token_ids,
                             token_mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def step_bank(bank_imgs, bank_ids, bank_masks, idx):
        return step(bank_imgs[idx], bank_ids[idx], bank_masks[idx])

    return step_bank if bank_mode else step


@torch.no_grad()
def greedy_decode(model: Seq2SeqOCR, images: torch.Tensor,
                  max_len: int = 64) -> torch.Tensor:
    """Fixed-length greedy decode: tokens [B, max_len - 1] (BOS
    stripped), PAD after EOS."""
    memory = model.encode(images)
    b, dev = images.shape[0], images.device
    tokens = torch.full((b, max_len), PAD, dtype=torch.long, device=dev)
    tokens[:, 0] = BOS
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for t in range(max_len - 1):
        logits = model.decode_logits(memory, tokens)
        nxt = torch.argmax(logits[:, t], dim=-1)
        nxt = torch.where(done, PAD, nxt)
        done = done | (nxt == EOS)
        tokens[:, t + 1] = nxt
    return tokens[:, 1:]


@torch.no_grad()
def beam_decode(model: Seq2SeqOCR, images: torch.Tensor, max_len: int = 64,
                beam_size: int = 4) -> torch.Tensor:
    """Fixed-shape beam search; returns the best beam's tokens
    [B, max_len - 1] (BOS stripped)."""
    memory = model.encode(images)
    b, k, dev = memory.shape[0], beam_size, memory.device
    mem_k = torch.repeat_interleave(memory, k, dim=0)       # [B*K, N, D]
    tokens = torch.full((b, k, max_len), PAD, dtype=torch.long, device=dev)
    tokens[:, :, 0] = BOS
    # only beam 0 live at t=0 (all beams identical otherwise)
    scores = torch.full((b, k), NEG_INF_BEAM, dtype=torch.float32,
                        device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros((b, k), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    for t in range(max_len - 1):
        logits = model.decode_logits(mem_k, tokens.reshape(b * k, max_len))
        v = logits.shape[-1]
        logp = torch.log_softmax(logits[:, t].reshape(b, k, v).float(),
                                 dim=-1)
        # finished beams may only extend with PAD at zero cost
        pad_only = torch.full((v,), NEG_INF_BEAM, dtype=torch.float32,
                              device=dev)
        pad_only[PAD] = 0.0
        logp = torch.where(done[:, :, None], pad_only, logp)
        flat = (scores[:, :, None] + logp).reshape(b, k * v)
        top_scores, top_flat = torch.sort(flat, dim=1, descending=True,
                                          stable=True)
        top_scores, top_flat = top_scores[:, :k], top_flat[:, :k]
        beam_src = top_flat // v
        tok = top_flat % v
        tokens = tokens[rows, beam_src]
        tokens[:, :, t + 1] = tok
        done = done[rows, beam_src] | (tok == EOS)
        scores = top_scores
    best = torch.argmax(scores, dim=1)
    return tokens[torch.arange(b, device=dev), best][:, 1:]
