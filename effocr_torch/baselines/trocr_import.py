"""HF TrOCR checkpoints in PyTorch: the JAX package's
baselines/trocr_import.py, name for name.

- Conversion (``TrOCRSpec``, ``fairseq_to_hf_state_dict``,
  ``spec_from_state_dict``, ``convert_state_dict``) is numpy and gives
  the JAX package's flat keys in its [in, out] layout, so the npz
  artifact (``save_trocr_npz`` / ``load_trocr_npz``) is one file for
  both packages.  The fairseq pickle is read through the port's
  allowlist unpickler (interop/torch_pickle.py), ``model.safetensors``
  through interop/safetensors.py.
- ``TrOCR`` is the forward as an ``nn.Module`` over those flat tensors
  (``from_flat`` / ``to_flat``): ViT pre-LN blocks (LayerNorm eps 1e-12,
  exact erf GELU), an optional ``enc_to_dec_proj``, then TrOCR post-LN
  decoder blocks (eps 1e-5; the activation from the spec: ``gelu`` exact,
  ``gelu_new`` the tanh form, ``relu``), learned positions with the
  BART offset of 2, optional embedding scale sqrt(d_model) and
  embedding LayerNorm.  q is multiplied by head_dim ** -0.5 before the
  product, the causal mask fills -1e30, float32 throughout.  Positions
  are rows ``2 .. 2 + t`` of the table; when ``2 + t`` passes its end the
  start moves back so the slice fits, as ``lax.dynamic_slice_in_dim``
  clamps it.
- ``trocr_greedy_decode`` and ``trocr_beam_decode`` are the JAX
  package's fixed-length ``lax.scan`` loops: the whole decoder is
  recomputed at each of ``max_len - 1`` steps, the start token is
  stripped, PAD follows EOS.  Greedy ties go to the first index
  (``torch.argmax``, as ``jnp.argmax``); the beam's ``lax.top_k`` over
  [B, K * V], [B, 2K] and [B, 2K] is a stable descending sort (ties to
  the lower index; ``torch.topk`` promises no order), and the -1e9
  penalties are added term by term, since the early-stop gate compares
  those sums.
- ``make_trocr_finetune_step``: masked cross entropy with teacher forcing
  (decoder input = start + labels[:-1]) and ``optimizer.step()`` (the
  port's train/optim.py AdamW for ``optax.adamw(lr)``); bank mode
  gathers uint8 pixels, labels and masks on the bank's device from int
  indices.  uint8 pixels are normalized on the device, ``(x / 255 - 0.5)
  / 0.5`` with a device-side divisor (CUDA multiplies by the reciprocal
  of a host scalar).

The npz is written uncompressed (``np.savez``; the JAX package writes
``savez_compressed``): ``np.load`` reads either, and float32 weights do
not compress, while deflating the 1.3 GB of a trocr-base checkpoint
takes tens of seconds.

The checks of the JAX package that the port keeps as they are:
``import_hf_checkpoint`` raises ``KeyError`` when the checkpoint lacks
``decoder.output_projection.weight`` (a ``save_pretrained`` with
safetensors drops the tied projection; ROADMAP.md queue 3).  One the
port adds: ``spec_from_state_dict`` refuses a DeiT encoder (a
distillation token, position rows 2 + N), which the JAX forward cannot
run either (its concatenation yields 1 + N tokens).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NEG_MASK = -1e30
NEG_BEAM = -1e9


@dataclasses.dataclass(frozen=True)
class TrOCRSpec:
    """Architecture hyperparameters, inferable from an HF state dict."""

    # encoder (ViT)
    enc_hidden: int
    enc_layers: int
    enc_heads: int
    patch: int
    image_size: int
    # decoder (TrOCR)
    dec_hidden: int
    dec_layers: int
    dec_heads: int
    vocab_size: int
    max_positions: int          # excludes the offset-2 rows
    cross_hidden: int           # kdim/vdim of the cross attention
    # flags (from config.json; not inferable from shapes)
    scale_embedding: bool = False
    layernorm_embedding: bool = True
    activation: str = "gelu"
    has_enc_to_dec_proj: bool = False

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2


def _t(w: np.ndarray) -> np.ndarray:
    """torch Linear weight [out, in] -> the JAX package's [in, out]."""
    return np.ascontiguousarray(np.asarray(w).T)


# --------------------------------------------------------------- fairseq hop
def _fairseq_sinusoidal(n: int, dim: int, padding_idx: int = 1) -> np.ndarray:
    """fairseq SinusoidalPositionalEmbedding.get_embedding: [n, dim]
    float32, half sin and half cos, row ``padding_idx`` zero."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    freq = np.exp(np.arange(half, dtype=np.float64) * -emb)
    pos = np.arange(n, dtype=np.float64)[:, None] * freq[None, :]
    out = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2 == 1:
        out = np.concatenate([out, np.zeros((n, 1))], axis=1)
    if padding_idx is not None:
        out[padding_idx] = 0.0
    return out.astype(np.float32)


def fairseq_to_hf_state_dict(
    sd: Mapping[str, Any]
) -> Dict[str, np.ndarray]:
    """Raw fairseq/unilm TrOCR ``ckpt["model"]`` -> HF-layout state dict:
    the renames and the qkv split of the reference's converter
    (scripts/trocr_fairseq_to_pytorch_chkpt.py), keeping the encoder
    positions, baking sinusoidal decoder positions into the learned
    table (514 rows) and splitting a qkv bias alongside the weight."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    out: Dict[str, np.ndarray] = {}

    enc_renames = {
        "norm1": "layernorm_before",
        "norm2": "layernorm_after",
    }
    for k, v in sd.items():
        if k in ("decoder.version", "encoder.deit.head.weight",
                 "encoder.deit.head.bias"):
            continue
        if k.endswith("embed_positions._float_tensor"):
            continue  # sinusoidal marker; table materialized below
        if k.startswith("encoder.deit.blocks."):
            parts = k.split(".")
            i, rest = parts[3], ".".join(parts[4:])
            base = f"encoder.encoder.layer.{i}"
            wb = parts[-1]  # weight|bias
            if rest.startswith("attn.qkv."):
                h = v.shape[0] // 3
                for j, name in enumerate(("query", "key", "value")):
                    out[f"{base}.attention.attention.{name}.{wb}"] = \
                        v[j * h : (j + 1) * h]
            elif rest.startswith("attn.proj."):
                out[f"{base}.attention.output.dense.{wb}"] = v
            elif parts[4] in enc_renames:
                out[f"{base}.{enc_renames[parts[4]]}.{wb}"] = v
            elif rest.startswith("mlp.fc1."):
                out[f"{base}.intermediate.dense.{wb}"] = v
            elif rest.startswith("mlp.fc2."):
                out[f"{base}.output.dense.{wb}"] = v
            else:
                out[f"{base}.{rest}"] = v
        elif k == "encoder.deit.cls_token":
            out["encoder.embeddings.cls_token"] = v
        elif k == "encoder.deit.pos_embed":
            out["encoder.embeddings.position_embeddings"] = v
        elif k == "encoder.deit.patch_embed.proj.weight":
            out["encoder.embeddings.patch_embeddings.projection.weight"] = v
        elif k == "encoder.deit.patch_embed.proj.bias":
            out["encoder.embeddings.patch_embeddings.projection.bias"] = v
        elif k == "encoder.deit.norm.weight":
            out["encoder.layernorm.weight"] = v
        elif k == "encoder.deit.norm.bias":
            out["encoder.layernorm.bias"] = v
        elif k.startswith("decoder.") and "output_projection" not in k:
            out["decoder.model." + k] = v
        else:
            out[k] = v

    if "decoder.model.decoder.embed_positions.weight" not in out:
        # sinusoidal positions: the fairseq table (padding_idx 1, offset
        # 2: row p + 2 is position p, as in the learned layout)
        tok = out["decoder.model.decoder.embed_tokens.weight"]
        dim = tok.shape[1]
        n = 514  # fairseq's default max_target_positions 512 (+2 offset)
        out["decoder.model.decoder.embed_positions.weight"] = \
            _fairseq_sinusoidal(n, dim)
    return out


def _looks_like_fairseq(sd: Mapping[str, Any]) -> bool:
    return any(k.startswith("encoder.deit.") for k in sd)


def import_fairseq_checkpoint(pt_path: str):
    """Raw fairseq/unilm TrOCR .pt -> (params, spec), read through the
    allowlist unpickler (the cfg / args objects inside become inert
    stubs).  Flags the tensors do not carry take the reference
    converter's values: activation relu, scale_embedding true."""
    from effocr_torch.interop.torch_pickle import _PickleModule

    ckpt = torch.load(pt_path, map_location="cpu", weights_only=False,
                      pickle_module=_PickleModule)
    if not isinstance(ckpt, dict) or "model" not in ckpt:
        raise ValueError(f"{pt_path}: not a fairseq checkpoint "
                         "(no 'model' key)")
    sd = {k: np.asarray(v.detach().float().cpu().numpy())
          for k, v in ckpt["model"].items()
          if hasattr(v, "detach")}
    if not _looks_like_fairseq(sd):
        raise ValueError(
            f"{pt_path}: no encoder.deit.* keys — already HF-layout? "
            "use the --model_dir path instead")
    hf_sd = fairseq_to_hf_state_dict(sd)
    config = {"decoder": {"activation_function": "relu",
                          "scale_embedding": True,
                          "use_learned_position_embeddings": True}}
    spec = spec_from_state_dict(hf_sd, config)
    return convert_state_dict(hf_sd, spec), spec


def spec_from_state_dict(
    sd: Mapping[str, Any], config: Optional[Mapping[str, Any]] = None
) -> TrOCRSpec:
    """The architecture from tensor shapes; only boolean and string flags
    come from ``config`` (the parsed config.json, with "encoder" and
    "decoder" sub-dicts)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    proj = sd["encoder.embeddings.patch_embeddings.projection.weight"]
    enc_hidden, _, patch, _ = proj.shape
    pos = sd["encoder.embeddings.position_embeddings"]
    n_patches = pos.shape[1] - 1
    image_size = patch * int(round(math.sqrt(n_patches)))
    if ("encoder.embeddings.distillation_token" in sd
            or (image_size // patch) ** 2 != n_patches):
        raise ValueError(
            f"encoder position table has {pos.shape[1]} rows, not 1 + a "
            "square patch grid (a DeiT encoder: its distillation token adds "
            "a row); only ViT encoders are supported, as in the JAX package "
            "(trocr-small's DeiT encoder is not)")
    enc_layers = 0
    while f"encoder.encoder.layer.{enc_layers}.layernorm_before.weight" in sd:
        enc_layers += 1
    dec_layers = 0
    while f"decoder.model.decoder.layers.{dec_layers}.final_layer_norm.weight" in sd:
        dec_layers += 1
    tok = sd["decoder.model.decoder.embed_tokens.weight"]
    vocab_size, dec_hidden = tok.shape
    dec_pos = sd["decoder.model.decoder.embed_positions.weight"]
    cross_k = sd["decoder.model.decoder.layers.0.encoder_attn.k_proj.weight"]

    enc_cfg = (config or {}).get("encoder", {})
    dec_cfg = (config or {}).get("decoder", {})
    if not dec_cfg.get("use_learned_position_embeddings", True):
        raise ValueError(
            "only learned decoder position embeddings are supported "
            "(all published TrOCR checkpoints use them)"
        )
    return TrOCRSpec(
        enc_hidden=int(enc_hidden),
        enc_layers=enc_layers,
        enc_heads=int(enc_cfg.get("num_attention_heads",
                               max(1, enc_hidden // 64))),
        patch=int(patch),
        image_size=int(image_size),
        dec_hidden=int(dec_hidden),
        dec_layers=dec_layers,
        dec_heads=int(dec_cfg.get("decoder_attention_heads",
                               max(1, dec_hidden // 64))),
        vocab_size=int(vocab_size),
        max_positions=int(dec_pos.shape[0] - 2),
        cross_hidden=int(cross_k.shape[1]),
        scale_embedding=bool(dec_cfg.get("scale_embedding", False)),
        layernorm_embedding=(
            "decoder.model.decoder.layernorm_embedding.weight" in sd
        ),
        activation=str(dec_cfg.get("activation_function", "gelu")),
        has_enc_to_dec_proj=("enc_to_dec_proj.weight" in sd),
    )


def convert_state_dict(sd: Mapping[str, Any], spec: TrOCRSpec
                       ) -> Dict[str, np.ndarray]:
    """HF VisionEncoderDecoder state dict -> the flat param dict: Linear
    weights transposed to [in, out], the patch conv as a [P * P * 3, D]
    matmul weight (HWIO flattened)."""
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    p: Dict[str, np.ndarray] = {}
    proj = sd["encoder.embeddings.patch_embeddings.projection.weight"]
    # [D, 3, P, P] -> [P, P, 3, D] -> flat [P*P*3, D] matmul form
    p["enc/patch_w"] = np.ascontiguousarray(
        proj.transpose(2, 3, 1, 0).reshape(-1, spec.enc_hidden)
    )
    p["enc/patch_b"] = sd["encoder.embeddings.patch_embeddings.projection.bias"]
    p["enc/cls"] = sd["encoder.embeddings.cls_token"]
    p["enc/pos"] = sd["encoder.embeddings.position_embeddings"]
    for i in range(spec.enc_layers):
        src = f"encoder.encoder.layer.{i}"
        dst = f"enc/L{i}"
        p[f"{dst}/ln1_s"] = sd[f"{src}.layernorm_before.weight"]
        p[f"{dst}/ln1_b"] = sd[f"{src}.layernorm_before.bias"]
        for name, hf in (("q", "query"), ("k", "key"), ("v", "value")):
            p[f"{dst}/{name}_w"] = _t(sd[f"{src}.attention.attention.{hf}.weight"])
            p[f"{dst}/{name}_b"] = sd[f"{src}.attention.attention.{hf}.bias"]
        p[f"{dst}/o_w"] = _t(sd[f"{src}.attention.output.dense.weight"])
        p[f"{dst}/o_b"] = sd[f"{src}.attention.output.dense.bias"]
        p[f"{dst}/ln2_s"] = sd[f"{src}.layernorm_after.weight"]
        p[f"{dst}/ln2_b"] = sd[f"{src}.layernorm_after.bias"]
        p[f"{dst}/fc1_w"] = _t(sd[f"{src}.intermediate.dense.weight"])
        p[f"{dst}/fc1_b"] = sd[f"{src}.intermediate.dense.bias"]
        p[f"{dst}/fc2_w"] = _t(sd[f"{src}.output.dense.weight"])
        p[f"{dst}/fc2_b"] = sd[f"{src}.output.dense.bias"]
    p["enc/final_ln_s"] = sd["encoder.layernorm.weight"]
    p["enc/final_ln_b"] = sd["encoder.layernorm.bias"]
    if spec.has_enc_to_dec_proj:
        p["proj_w"] = _t(sd["enc_to_dec_proj.weight"])
        p["proj_b"] = sd["enc_to_dec_proj.bias"]
    p["dec/tok_embed"] = sd["decoder.model.decoder.embed_tokens.weight"]
    p["dec/pos_embed"] = sd["decoder.model.decoder.embed_positions.weight"]
    if spec.layernorm_embedding:
        p["dec/emb_ln_s"] = sd["decoder.model.decoder.layernorm_embedding.weight"]
        p["dec/emb_ln_b"] = sd["decoder.model.decoder.layernorm_embedding.bias"]
    for i in range(spec.dec_layers):
        src = f"decoder.model.decoder.layers.{i}"
        dst = f"dec/L{i}"
        for blk, hf in (("self", "self_attn"), ("cross", "encoder_attn")):
            for name in ("q", "k", "v"):
                p[f"{dst}/{blk}_{name}_w"] = _t(sd[f"{src}.{hf}.{name}_proj.weight"])
                p[f"{dst}/{blk}_{name}_b"] = sd[f"{src}.{hf}.{name}_proj.bias"]
            p[f"{dst}/{blk}_o_w"] = _t(sd[f"{src}.{hf}.out_proj.weight"])
            p[f"{dst}/{blk}_o_b"] = sd[f"{src}.{hf}.out_proj.bias"]
            p[f"{dst}/{blk}_ln_s"] = sd[f"{src}.{hf}_layer_norm.weight"]
            p[f"{dst}/{blk}_ln_b"] = sd[f"{src}.{hf}_layer_norm.bias"]
        p[f"{dst}/fc1_w"] = _t(sd[f"{src}.fc1.weight"])
        p[f"{dst}/fc1_b"] = sd[f"{src}.fc1.bias"]
        p[f"{dst}/fc2_w"] = _t(sd[f"{src}.fc2.weight"])
        p[f"{dst}/fc2_b"] = sd[f"{src}.fc2.bias"]
        p[f"{dst}/final_ln_s"] = sd[f"{src}.final_layer_norm.weight"]
        p[f"{dst}/final_ln_b"] = sd[f"{src}.final_layer_norm.bias"]
    if "decoder.output_projection.weight" not in sd:
        raise KeyError(
            "decoder.output_projection.weight: the checkpoint has no output "
            "projection (a save_pretrained with safetensors drops the one "
            "tied to decoder.model.decoder.embed_tokens.weight); the JAX "
            "package refuses it too")
    p["dec/out_proj_w"] = _t(sd["decoder.output_projection.weight"])
    return p


# ---------------------------------------------------------------- forward
def _act(name: str):
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    if name == "gelu_new":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(f"unsupported activation {name!r}")


def _module_key(flat: str) -> str:
    """'enc/L3/q_w' -> 'enc.L.3.q_w' (a ModuleList index per layer)."""
    return re.sub(r"/L(\d+)/", r".L.\1.", flat).replace("/", ".")


def _flat_key(name: str) -> str:
    return re.sub(r"\.L\.(\d+)\.", r"/L\1/", name).replace(".", "/")


class _Tensors(nn.Module):
    """Named parameters, with an optional ``L`` list of layers."""


class TrOCR(nn.Module):
    """The forward over the flat tensors (``from_flat``); the parameter
    names are the flat keys with each ``/L{i}/`` as ``.L.{i}.``."""

    def __init__(self, spec: TrOCRSpec, params: Mapping[str, Any]):
        super().__init__()
        self.spec = spec
        self.act = _act(spec.activation)
        for sub in ("enc", "dec"):
            m = _Tensors()
            n = spec.enc_layers if sub == "enc" else spec.dec_layers
            m.L = nn.ModuleList(_Tensors() for _ in range(n))
            setattr(self, sub, m)
        self.top = _Tensors()
        for key, value in params.items():
            t = nn.Parameter(torch.as_tensor(np.array(value, np.float32)))
            parts = _module_key(key).split(".")
            owner = self.top if len(parts) == 1 else getattr(self, parts[0])
            if len(parts) == 4:
                owner = owner.L[int(parts[2])]
            owner.register_parameter(parts[-1], t)
        self.register_buffer("byte_scale", torch.tensor(255.0),
                             persistent=False)
        self.register_buffer("half_", torch.tensor(0.5), persistent=False)

    @classmethod
    def from_flat(cls, params: Mapping[str, Any], spec: TrOCRSpec) -> "TrOCR":
        return cls(spec, params)

    def to_flat(self) -> Dict[str, np.ndarray]:
        out = {}
        for name, p in self.named_parameters():
            key = name[len("top."):] if name.startswith("top.") else name
            out[_flat_key(key)] = p.detach().cpu().numpy()
        return out

    def normalize(self, pixels_u8: torch.Tensor) -> torch.Tensor:
        """TrOCRProcessor: rescale by 1/255, then mean = std = 0.5."""
        return (pixels_u8.float() / self.byte_scale - self.half_) / self.half_

    @staticmethod
    def _attn(q_in, kv_in, p, prefix, heads, causal):
        b, tq, _ = q_in.shape
        tk = kv_in.shape[1]
        w = lambda n: getattr(p, f"{prefix}{n}")  # noqa: E731
        d = w("q_w").shape[1]
        hd = d // heads
        q = q_in @ w("q_w") + w("q_b")
        k = kv_in @ w("k_w") + w("k_b")
        v = kv_in @ w("v_w") + w("v_b")
        q = q.reshape(b, tq, heads, hd).transpose(1, 2) * (hd ** -0.5)
        k = k.reshape(b, tk, heads, hd).transpose(1, 2)
        v = v.reshape(b, tk, heads, hd).transpose(1, 2)
        attn = q @ k.transpose(2, 3)
        if causal:
            mask = torch.tril(torch.ones((tq, tk), dtype=torch.bool,
                                         device=attn.device))
            attn = torch.where(mask, attn, attn.new_tensor(NEG_MASK))
        attn = torch.softmax(attn, dim=-1)
        o = (attn @ v).transpose(1, 2).reshape(b, tq, d)
        return o @ w("o_w") + w("o_b")

    def encode(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B, H, W, 3] float32 (normalized) -> encoder
        memory [B, N + 1, cross_hidden]."""
        s, e = self.spec, self.enc
        b = pixel_values.shape[0]
        g = s.image_size // s.patch
        x = pixel_values.reshape(b, g, s.patch, g, s.patch, 3)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, -1)
        x = x @ e.patch_w + e.patch_b
        cls = e.cls.expand(b, 1, s.enc_hidden)
        x = torch.cat([cls, x], dim=1) + e.pos
        d = (s.enc_hidden,)
        for L in e.L:
            h = F.layer_norm(x, d, L.ln1_s, L.ln1_b, 1e-12)
            x = x + self._attn(h, h, L, "", s.enc_heads, causal=False)
            h = F.layer_norm(x, d, L.ln2_s, L.ln2_b, 1e-12)
            h = F.gelu(h @ L.fc1_w + L.fc1_b, approximate="none")
            x = x + (h @ L.fc2_w + L.fc2_b)
        x = F.layer_norm(x, d, e.final_ln_s, e.final_ln_b, 1e-12)
        if s.has_enc_to_dec_proj:
            x = x @ self.top.proj_w + self.top.proj_b
        return x

    def positions(self, t: int) -> torch.Tensor:
        """Rows 2 .. 2 + t of the position table, the start clamped back
        when 2 + t passes the table's end (``dynamic_slice_in_dim``)."""
        table = self.dec.pos_embed
        if t > table.shape[0]:
            raise ValueError(f"{t} tokens, position table of "
                             f"{table.shape[0]} rows")
        start = min(2, table.shape[0] - t)
        return table[start:start + t]

    def decode_logits(self, memory: torch.Tensor, input_ids: torch.Tensor
                      ) -> torch.Tensor:
        """Teacher-forced decoder logits [B, T, vocab] (causal mask only)."""
        s, dd = self.spec, self.dec
        t = input_ids.shape[1]
        scale = math.sqrt(s.dec_hidden) if s.scale_embedding else 1.0
        x = dd.tok_embed[input_ids.long()] * scale
        x = x + self.positions(t)[None]
        d = (s.dec_hidden,)
        if s.layernorm_embedding:
            x = F.layer_norm(x, d, dd.emb_ln_s, dd.emb_ln_b, 1e-5)
        for L in dd.L:
            h = self._attn(x, x, L, "self_", s.dec_heads, causal=True)
            x = F.layer_norm(x + h, d, L.self_ln_s, L.self_ln_b, 1e-5)
            h = self._attn(x, memory, L, "cross_", s.dec_heads, causal=False)
            x = F.layer_norm(x + h, d, L.cross_ln_s, L.cross_ln_b, 1e-5)
            h = self.act(x @ L.fc1_w + L.fc1_b)
            h = h @ L.fc2_w + L.fc2_b
            x = F.layer_norm(x + h, d, L.final_ln_s, L.final_ln_b, 1e-5)
        return x @ dd.out_proj_w

    def forward(self, pixel_values, input_ids):
        return self.decode_logits(self.encode(pixel_values), input_ids)


@torch.no_grad()
def trocr_greedy_decode(model: TrOCR, pixel_values: torch.Tensor,
                        max_len: int = 64, bos_id: int = 2, eos_id: int = 2,
                        pad_id: int = 1) -> torch.Tensor:
    """Fixed-length greedy generation: tokens [B, max_len - 1], the start
    token stripped, PAD after EOS.  The default ids are published TrOCR
    checkpoints' (decoding starts with </s> = 2, <pad> = 1); the command
    reads them from config.json (cli/import_trocr._special_ids)."""
    memory = model.encode(pixel_values)
    b, dev = pixel_values.shape[0], pixel_values.device
    tokens = torch.full((b, max_len), pad_id, dtype=torch.long, device=dev)
    tokens[:, 0] = bos_id
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for t in range(max_len - 1):
        logits = model.decode_logits(memory, tokens)
        nxt = torch.argmax(logits[:, t], dim=-1)
        nxt = torch.where(done, pad_id, nxt)
        done = done | (nxt == eos_id)
        tokens[:, t + 1] = nxt
    return tokens[:, 1:]


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` on the last axis: ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def trocr_beam_decode(model: TrOCR, pixel_values: torch.Tensor,
                      max_len: int = 64, num_beams: int = 4,
                      bos_id: int = 2, eos_id: int = 2, pad_id: int = 1,
                      length_penalty: float = 1.0) -> torch.Tensor:
    """Fixed-shape beam search with HF ``generate``'s semantics (2K
    candidates a step; EOS candidates in the top K finalized with score /
    generated_len ** length_penalty; running beams from the non-EOS top
    K; HF's early-stop gate for ``early_stopping=False``).  Returns the
    best sequence [B, max_len - 1], start stripped, PAD-filled."""
    memory = model.encode(pixel_values)
    b, dev = memory.shape[0], memory.device
    k, L = num_beams, max_len
    k2 = 2 * k
    mem_k = torch.repeat_interleave(memory, k, dim=0)
    f32 = torch.float32
    neg = torch.tensor(NEG_BEAM, dtype=f32, device=dev)
    lp = torch.tensor(length_penalty, dtype=f32, device=dev)

    run_seq = torch.full((b, k, L), pad_id, dtype=torch.long, device=dev)
    run_seq[:, :, 0] = bos_id
    run_sc = torch.where(torch.arange(k, device=dev)[None, :] == 0,
                         torch.zeros((), dtype=f32, device=dev), neg
                         ) * torch.ones((b, 1), dtype=f32, device=dev)
    fin_seq = run_seq.clone()
    fin_sc = torch.full((b, k), NEG_BEAM, dtype=f32, device=dev)
    fin_done = torch.zeros((b, k), dtype=torch.bool, device=dev)
    heur_ok = torch.ones((b, 1), dtype=torch.bool, device=dev)
    top_mask = (torch.arange(k2, device=dev) < k)[None, :]
    rows = torch.arange(b, device=dev)[:, None]

    for t in range(L - 1):
        logits = model.decode_logits(mem_k, run_seq.reshape(b * k, L))
        v = logits.shape[-1]
        logp = torch.log_softmax(logits[:, t].reshape(b, k, v), dim=-1)
        flat = (logp + run_sc[:, :, None]).reshape(b, k * v)
        top_sc, top_idx = _top_k(flat, k2)                  # [B, 2K]
        src = top_idx // v
        tok = top_idx % v
        cand_seq = run_seq[rows, src].clone()
        cand_seq[:, :, t + 1] = tok
        hits = (tok == eos_id) | (t == L - 2)               # stopping
        # next running beams: top K among the unfinished candidates
        nxt_sc, nxt_i = _top_k(top_sc + hits * neg, k)
        run_seq = cand_seq[rows, nxt_i]
        run_sc = nxt_sc
        # finalize the candidates in the top K, behind the gate
        did_finish = hits & top_mask
        gen_len = torch.tensor(float(t + 1), dtype=f32, device=dev)
        norm_sc = (top_sc / gen_len ** lp + (~heur_ok) * neg
                   + (~did_finish) * neg)
        m_sc = torch.cat([fin_sc, norm_sc], dim=1)
        m_seq = torch.cat([fin_seq, cand_seq], dim=1)
        m_done = torch.cat([fin_done, did_finish], dim=1)
        fin_sc, mi = _top_k(m_sc, k)
        fin_seq = m_seq[rows, mi]
        fin_done = m_done[rows, mi]
        # early-stop heuristic (the early_stopping=False branch)
        best_poss = run_sc[:, :1] / gen_len ** lp
        worst_fin = torch.where(
            fin_done, fin_sc.min(dim=1, keepdim=True).values, neg)
        heur_ok = heur_ok & (best_poss > worst_fin).any(dim=-1, keepdim=True)
    return fin_seq[:, 0, 1:]


# ------------------------------------------------------------- finetuning
def finetune_loss(model: TrOCR, pixels_u8: torch.Tensor,
                  labels: torch.Tensor, label_mask: torch.Tensor,
                  decoder_start: int) -> torch.Tensor:
    """Masked mean cross entropy, teacher forced (HF's
    shift_tokens_right: decoder input = start + labels[:-1])."""
    labels = labels.long()
    inp = torch.cat([torch.full_like(labels[:, :1], decoder_start),
                     labels[:, :-1]], dim=1)
    logits = model(model.normalize(pixels_u8), inp)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    m = label_mask.to(torch.float32)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def make_trocr_finetune_step(model: TrOCR, optimizer, decoder_start: int,
                             bank_mode: bool = False):
    """The CE fine-tuning step of imported weights (the reference's
    trocr/train_trocr.py role): loss -> backward -> ``optimizer.step()``;
    returns the loss as a device scalar.  Stream mode: step(pixels_u8,
    labels, label_mask); bank mode: step(bank_pix, bank_labels,
    bank_masks, idx), gathered on the bank's device."""

    def step(pixels_u8, labels, label_mask):
        optimizer.zero_grad()
        loss = finetune_loss(model, pixels_u8, labels, label_mask,
                             decoder_start)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def step_bank(bank_pix, bank_labels, bank_masks, idx):
        return step(bank_pix[idx], bank_labels[idx], bank_masks[idx])

    return step_bank if bank_mode else step


# ------------------------------------------------------------ persistence
def save_trocr_npz(path: str, params: Dict[str, np.ndarray], spec: TrOCRSpec):
    meta = json.dumps(dataclasses.asdict(spec))
    np.savez(path, __spec__=np.frombuffer(meta.encode(), np.uint8),
             **{k: np.asarray(v) for k, v in params.items()})


def load_trocr_npz(path: str):
    with np.load(path) as z:
        spec = TrOCRSpec(**json.loads(bytes(z["__spec__"]).decode()))
        params = {k: z[k] for k in z.files if k != "__spec__"}
    return params, spec


def read_hf_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    """The weights of an HF checkpoint directory: ``model.safetensors``
    (the port's reader) or ``pytorch_model.bin`` (``weights_only``)."""
    st_path = os.path.join(model_dir, "model.safetensors")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        from effocr_torch.interop.safetensors import load_file

        return load_file(st_path)
    if os.path.exists(bin_path):
        return {k: v.numpy() for k, v in
                torch.load(bin_path, map_location="cpu",
                           weights_only=True).items()}
    raise FileNotFoundError(
        f"no model.safetensors or pytorch_model.bin in {model_dir}")


def import_hf_checkpoint(model_dir: str):
    """An HF TrOCR VisionEncoderDecoder directory (config.json +
    model.safetensors or pytorch_model.bin) -> (params, spec)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        config = json.load(f)
    sd = read_hf_state_dict(model_dir)
    spec = spec_from_state_dict(sd, config)
    return convert_state_dict(sd, spec), spec
