"""Teacher-forced TrOCR logits straight from an HF-layout state dict, in
float64: the reference that ``import-trocr --check`` holds the converted
model to, in place of ``transformers.VisionEncoderDecoderModel`` (which
the port does not import).

It reads the weights under HF's own names and layout (``[out, in]``
Linear weights, ``query`` / ``key`` / ``value``, ``enc_to_dec_proj``, the
patch embedding as a strided convolution) and goes through none of
trocr_import.convert_state_dict, so a conversion fault shows as a gap.
The arithmetic is that of transformers' ``ViTModel`` (pre-LN blocks,
``layer_norm_eps`` and ``hidden_act`` from the encoder config: 1e-12 and
exact GELU by default; scores divided by sqrt(head_dim)) and
``TrOCRForCausalLM`` (post-LN blocks, LayerNorm eps 1e-5, q scaled by
head_dim ** -0.5, learned positions at offset 2, ``scale_embedding``,
``layernorm_embedding``, ``activation_function``).  A checkpoint without
``decoder.output_projection.weight`` uses the token embedding, as HF
ties them.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

_ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def _attention(q, k, v, heads, causal):
    b, tq, d = q.shape
    hd = d // heads
    q = q.reshape(b, tq, heads, hd).transpose(1, 2)
    k = k.reshape(b, k.shape[1], heads, hd).transpose(1, 2)
    v = v.reshape(b, v.shape[1], heads, hd).transpose(1, 2)
    scores = q @ k.transpose(2, 3)
    if causal:
        keep = torch.tril(torch.ones(scores.shape[-2:], dtype=torch.bool,
                                     device=scores.device))
        scores = scores.masked_fill(~keep, float("-inf"))
    o = torch.softmax(scores, dim=-1) @ v
    return o.transpose(1, 2).reshape(b, tq, d)


def hf_reference_logits(sd: Mapping[str, Any],
                        config: Optional[Mapping[str, Any]],
                        pixel_values: np.ndarray, input_ids: np.ndarray,
                        device="cpu") -> np.ndarray:
    """Logits [B, T, vocab] (float64) of ``VisionEncoderDecoderModel(
    pixel_values=NCHW, decoder_input_ids=input_ids)`` for pixel_values
    [B, H, W, 3] (normalized) and ``input_ids`` [B, T]."""
    dev = torch.device(device)
    w = {k: torch.as_tensor(np.asarray(v, np.float64), device=dev)
         for k, v in sd.items()}
    enc_cfg = (config or {}).get("encoder", {})
    dec_cfg = (config or {}).get("decoder", {})

    def lin(x, name, bias=True):
        return F.linear(x, w[f"{name}.weight"],
                        w[f"{name}.bias"] if bias else None)

    # ---- ViT encoder
    x = torch.as_tensor(np.asarray(pixel_values, np.float64),
                        device=dev).permute(0, 3, 1, 2)
    proj = w["encoder.embeddings.patch_embeddings.projection.weight"]
    patch = proj.shape[-1]
    x = F.conv2d(x, proj, w["encoder.embeddings.patch_embeddings."
                            "projection.bias"], stride=patch)
    x = x.flatten(2).transpose(1, 2)
    cls = w["encoder.embeddings.cls_token"].expand(x.shape[0], -1, -1)
    x = torch.cat([cls, x], dim=1) + w["encoder.embeddings.position_embeddings"]
    hidden = x.shape[-1]
    heads = int(enc_cfg.get("num_attention_heads", max(1, hidden // 64)))
    eps = float(enc_cfg.get("layer_norm_eps", 1e-12))
    act = _ACTS[enc_cfg.get("hidden_act", "gelu")]
    ln = lambda x, name, e: F.layer_norm(  # noqa: E731
        x, (x.shape[-1],), w[f"{name}.weight"], w[f"{name}.bias"], e)
    i = 0
    while f"encoder.encoder.layer.{i}.layernorm_before.weight" in w:
        L = f"encoder.encoder.layer.{i}"
        h = ln(x, f"{L}.layernorm_before", eps)
        a = f"{L}.attention.attention"
        q = lin(h, f"{a}.query") / math.sqrt(hidden // heads)
        o = _attention(q, lin(h, f"{a}.key"), lin(h, f"{a}.value"), heads,
                       causal=False)
        x = x + lin(o, f"{L}.attention.output.dense")
        h = ln(x, f"{L}.layernorm_after", eps)
        x = x + lin(act(lin(h, f"{L}.intermediate.dense")),
                    f"{L}.output.dense")
        i += 1
    memory = ln(x, "encoder.layernorm", eps)
    if "enc_to_dec_proj.weight" in w:
        memory = lin(memory, "enc_to_dec_proj")

    # ---- TrOCR decoder
    D = "decoder.model.decoder"
    ids = torch.as_tensor(np.asarray(input_ids, np.int64), device=dev)
    embed = w[f"{D}.embed_tokens.weight"]
    d = embed.shape[1]
    scale = math.sqrt(d) if dec_cfg.get("scale_embedding", False) else 1.0
    t = ids.shape[1]
    x = embed[ids] * scale + w[f"{D}.embed_positions.weight"][2:2 + t]
    if f"{D}.layernorm_embedding.weight" in w:
        x = ln(x, f"{D}.layernorm_embedding", 1e-5)
    dheads = int(dec_cfg.get("decoder_attention_heads", max(1, d // 64)))
    dact = _ACTS[dec_cfg.get("activation_function", "gelu")]
    hd_scale = (d // dheads) ** -0.5
    i = 0
    while f"{D}.layers.{i}.final_layer_norm.weight" in w:
        L = f"{D}.layers.{i}"
        for blk, kv, causal in (("self_attn", None, True),
                                ("encoder_attn", memory, False)):
            src = x if kv is None else kv
            q = lin(x, f"{L}.{blk}.q_proj") * hd_scale
            o = _attention(q, lin(src, f"{L}.{blk}.k_proj"),
                           lin(src, f"{L}.{blk}.v_proj"), dheads, causal)
            x = ln(x + lin(o, f"{L}.{blk}.out_proj"),
                   f"{L}.{blk}_layer_norm", 1e-5)
        h = lin(dact(lin(x, f"{L}.fc1")), f"{L}.fc2")
        x = ln(x + h, f"{L}.final_layer_norm", 1e-5)
        i += 1
    out_w = w.get("decoder.output_projection.weight", embed)
    return F.linear(x, out_w).cpu().numpy()
