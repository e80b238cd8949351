"""Writers of the original EffOCR's artifact formats: the inverse of each
importer, from the Flax-named variables tree of a model of this package.

- ``write_faiss_flat``: a FAISS ``IndexFlatIP`` / ``IndexFlatL2`` file
  (the modern byte layout or the pre-1.7 float one);
- ``onnx_bytes`` / ``write_onnx``: a minimal ONNX ModelProto holding a
  state dict as graph initializers (and, optionally, graph nodes);
- ``timm_convnext_state_dict``, ``timm_mobilenetv3_state_dict``: timm's
  names;
- ``ultralytics_yolov5_state_dict``: ultralytics' v6.0 layer names with
  the anchors in stride units; ``save_module_pickle`` writes a state dict
  as a full module pickle whose classes exist only while saving (as an
  ultralytics ``best.pt`` holds their ``Model`` class);
- ``hf_convnext_state_dict`` / ``write_hf_convnext_dir``: an HF
  ``ConvNextModel`` checkpoint directory (config.json +
  model.safetensors).

Each importer reads what its writer wrote back to the same tree, array
for array.  The card check (chip_smoke.py) and the tests write the
reference's formats with these.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import types
from typing import Any, Dict, Iterable, Mapping, Sequence, Tuple

import numpy as np

# timm's stage grouping of mobilenetv3_small_*: blocks.{stage}.{j}
MNV3_STAGES = ((0,), (1, 2), (3, 4, 5), (6, 7), (8, 9, 10))
YOLO_STRIDES = (8, 16, 32)


def _oihw(k) -> np.ndarray:
    """Flax HWIO conv kernel -> torch OIHW."""
    return np.ascontiguousarray(np.asarray(k, np.float32).transpose(3, 2, 0, 1))


def _linear(k) -> np.ndarray:
    """Flax Dense kernel [in, out] -> torch Linear [out, in]."""
    return np.ascontiguousarray(np.asarray(k, np.float32).T)


def _put_norm(sd: Dict[str, np.ndarray], key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = np.asarray(p["scale"], np.float32)
    sd[f"{key}.bias"] = np.asarray(p["bias"], np.float32)


def _put_bn(sd: Dict[str, np.ndarray], key: str, p: Mapping, s: Mapping
            ) -> None:
    _put_norm(sd, key, p)
    sd[f"{key}.running_mean"] = np.asarray(s["mean"], np.float32)
    sd[f"{key}.running_var"] = np.asarray(s["var"], np.float32)


def _put_conv(sd: Dict[str, np.ndarray], key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _oihw(p["kernel"])
    if "bias" in p:
        sd[f"{key}.bias"] = np.asarray(p["bias"], np.float32)


def _put_dense(sd: Dict[str, np.ndarray], key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _linear(p["kernel"])
    sd[f"{key}.bias"] = np.asarray(p["bias"], np.float32)


# --------------------------------------------------------------------- faiss

def write_faiss_flat(path: str, emb: np.ndarray, metric: int = 0,
                     legacy: bool = False) -> None:
    """[n, d] float32 as ``faiss.write_index`` writes an IndexFlat:
    fourcc, header, vector blob (metric 0 = inner product, 1 = L2)."""
    n, d = emb.shape
    buf = bytearray(b"IxFI" if metric == 0 else b"IxF2")
    buf += struct.pack("<i", d)
    buf += struct.pack("<q", n)
    buf += struct.pack("<qq", 1 << 20, 1 << 20)
    buf += b"\x01"                      # is_trained
    buf += struct.pack("<i", metric)
    buf += struct.pack("<Q", n * d if legacy else n * d * 4)
    buf += np.ascontiguousarray(emb, dtype="<f4").tobytes()
    with open(path, "wb") as f:
        f.write(bytes(buf))


# ---------------------------------------------------------------------- onnx

def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_len(field: int, payload: bytes) -> bytes:
    return _pb_varint((field << 3) | 2) + _pb_varint(len(payload)) + payload


def _pb_int(field: int, val: int) -> bytes:
    return _pb_varint(field << 3) + _pb_varint(val)


_ONNX_CODES = {np.dtype("float32"): 1, np.dtype("int64"): 7,
               np.dtype("float16"): 10, np.dtype("float64"): 11}


def onnx_bytes(inits: Mapping[str, np.ndarray],
               nodes: Iterable[Tuple[str, Sequence[str], Sequence[str]]] = ()
               ) -> bytes:
    """A minimal ModelProto: graph (field 7) holding NodeProtos (1:
    op_type, inputs, outputs) and initializer TensorProtos (5: dims,
    data_type, name, raw_data)."""
    graph = b""
    for op_type, inputs, outputs in nodes:
        node = b"".join(_pb_len(1, i.encode()) for i in inputs)
        node += b"".join(_pb_len(2, o.encode()) for o in outputs)
        node += _pb_len(4, op_type.encode())
        graph += _pb_len(1, node)
    for name, arr in inits.items():
        arr = np.asarray(arr)
        tp = b"".join(_pb_int(1, d) for d in arr.shape)
        tp += _pb_int(2, _ONNX_CODES[arr.dtype])
        tp += _pb_len(8, name.encode())
        tp += _pb_len(9, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
        graph += _pb_len(5, tp)
    return _pb_len(7, graph)


def write_onnx(path: str, sd: Mapping[str, np.ndarray],
               prefix: str = "net.") -> None:
    """A state dict as the initializers of an ``enc_best.onnx``, under the
    exporting wrapper's attribute prefix."""
    with open(path, "wb") as f:
        f.write(onnx_bytes({prefix + k: np.asarray(v, np.float32)
                            for k, v in sd.items()}))


# ------------------------------------------------------------------ encoders

def timm_convnext_state_dict(params: Mapping[str, Any]
                             ) -> Dict[str, np.ndarray]:
    """Our ConvNeXt params -> a timm ConvNeXt state dict (num_classes=0)."""
    sd: Dict[str, np.ndarray] = {}
    _put_conv(sd, "stem.0", params["stem"])
    _put_norm(sd, "stem.1", params["stem_norm"])
    i = 0
    while f"stage{i}_block0" in params:
        if i > 0:
            _put_norm(sd, f"stages.{i}.downsample.0",
                      params[f"downsample_norm{i}"])
            _put_conv(sd, f"stages.{i}.downsample.1", params[f"downsample{i}"])
        j = 0
        while f"stage{i}_block{j}" in params:
            p, b = params[f"stage{i}_block{j}"], f"stages.{i}.blocks.{j}"
            _put_conv(sd, f"{b}.conv_dw", p["dwconv"])
            _put_norm(sd, f"{b}.norm", p["LayerNorm_0"])
            _put_dense(sd, f"{b}.mlp.fc1", p["mlp_up"])
            _put_dense(sd, f"{b}.mlp.fc2", p["mlp_down"])
            sd[f"{b}.gamma"] = np.asarray(p["gamma"], np.float32)
            j += 1
        i += 1
    _put_norm(sd, "head.norm", params["head_norm"])
    return sd


def timm_mobilenetv3_state_dict(params: Mapping[str, Any],
                                stats: Mapping[str, Any]
                                ) -> Dict[str, np.ndarray]:
    """Our MobileNetV3-Small (params, batch_stats) -> a timm state dict."""
    sd: Dict[str, np.ndarray] = {}
    _put_conv(sd, "conv_stem", params["stem"])
    _put_bn(sd, "bn1", params["stem_bn"], stats["stem_bn"])
    for stage, flats in enumerate(MNV3_STAGES):
        for j, flat in enumerate(flats):
            p, s = params[f"block{flat}"], stats[f"block{flat}"]
            b = f"blocks.{stage}.{j}"
            if "expand" in p:                   # InvertedResidual
                _put_conv(sd, f"{b}.conv_pw", p["expand"])
                _put_bn(sd, f"{b}.bn1", p["expand_bn"], s["expand_bn"])
                dw_bn, pr_bn, project = "bn2", "bn3", "conv_pwl"
            else:                               # DepthwiseSeparable
                dw_bn, pr_bn, project = "bn1", "bn2", "conv_pw"
            _put_conv(sd, f"{b}.conv_dw", p["dw"])
            _put_bn(sd, f"{b}.{dw_bn}", p["dw_bn"], s["dw_bn"])
            if "SqueezeExcite_0" in p:
                _put_conv(sd, f"{b}.se.conv_reduce",
                          p["SqueezeExcite_0"]["reduce"])
                _put_conv(sd, f"{b}.se.conv_expand",
                          p["SqueezeExcite_0"]["expand"])
            _put_conv(sd, f"{b}.{project}", p["project"])
            _put_bn(sd, f"{b}.{pr_bn}", p["project_bn"], s["project_bn"])
    last = f"blocks.{len(MNV3_STAGES)}.0"
    _put_conv(sd, f"{last}.conv", params["last_conv"])
    _put_bn(sd, f"{last}.bn1", params["last_bn"], stats["last_bn"])
    sd["conv_head.weight"] = _linear(params["head"]["kernel"])[:, :, None,
                                                                None]
    sd["conv_head.bias"] = np.asarray(params["head"]["bias"], np.float32)
    return sd


def hf_convnext_state_dict(params: Mapping[str, Any]
                           ) -> Dict[str, np.ndarray]:
    """Our ConvNeXt params -> an HF ``ConvNextModel`` state dict."""
    sd: Dict[str, np.ndarray] = {}
    _put_conv(sd, "embeddings.patch_embeddings", params["stem"])
    _put_norm(sd, "embeddings.layernorm", params["stem_norm"])
    i = 0
    while f"stage{i}_block0" in params:
        if i > 0:
            base = f"encoder.stages.{i}.downsampling_layer"
            _put_norm(sd, f"{base}.0", params[f"downsample_norm{i}"])
            _put_conv(sd, f"{base}.1", params[f"downsample{i}"])
        j = 0
        while f"stage{i}_block{j}" in params:
            p, b = params[f"stage{i}_block{j}"], \
                f"encoder.stages.{i}.layers.{j}"
            _put_conv(sd, f"{b}.dwconv", p["dwconv"])
            _put_norm(sd, f"{b}.layernorm", p["LayerNorm_0"])
            _put_dense(sd, f"{b}.pwconv1", p["mlp_up"])
            _put_dense(sd, f"{b}.pwconv2", p["mlp_down"])
            sd[f"{b}.layer_scale_parameter"] = np.asarray(p["gamma"],
                                                          np.float32)
            j += 1
        i += 1
    _put_norm(sd, "layernorm", params["head_norm"])
    return sd


def write_hf_convnext_dir(out_dir: str, params: Mapping[str, Any],
                          image_size: int = 224) -> None:
    """config.json + model.safetensors as ``save_pretrained`` lays them
    out, holding the keys ``import-encoder`` reads."""
    from effocr_torch.interop.safetensors import save_file

    depths, dims = [], []
    i = 0
    while f"stage{i}_block0" in params:
        depths.append(sum(1 for k in params
                          if k.startswith(f"stage{i}_block")))
        dims.append(int(np.shape(params[f"stage{i}_block0"]["gamma"])[0]))
        i += 1
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({"model_type": "convnext", "architectures":
                   ["ConvNextModel"], "depths": depths,
                   "hidden_sizes": dims, "image_size": image_size,
                   "num_channels": int(np.shape(params["stem"]["kernel"])[2]),
                   "patch_size": 4, "layer_norm_eps": 1e-6}, f, indent=2)
    save_file(hf_convnext_state_dict(params),
              os.path.join(out_dir, "model.safetensors"),
              metadata={"format": "pt"})


# ----------------------------------------------------------------- localizer

def ultralytics_yolov5_state_dict(params: Mapping[str, Any],
                                  stats: Mapping[str, Any],
                                  anchors_px: Sequence[Sequence[float]]
                                  ) -> Dict[str, np.ndarray]:
    """Our YOLOv5 (params, batch_stats, pixel anchors) -> an ultralytics
    v6.0 state dict, the anchors in stride units (``model.24.anchors``)."""
    from effocr_torch.interop.yolo_import import _DETECT, _LAYER_MAP

    sd: Dict[str, np.ndarray] = {}

    def cba(key, p, s):
        _put_conv(sd, f"{key}.conv", p["Conv_0"])
        _put_bn(sd, f"{key}.bn", p["BatchNorm_0"], s["BatchNorm_0"])

    for ours, idx in _LAYER_MAP.items():
        p, s, key = params[ours], stats[ours], f"model.{idx}"
        if "ConvBnAct_2" in p:                  # C3
            for k, theirs in enumerate(("cv1", "cv2", "cv3")):
                cba(f"{key}.{theirs}", p[f"ConvBnAct_{k}"],
                    s[f"ConvBnAct_{k}"])
            j = 0
            while f"m{j}" in p:
                for k, theirs in enumerate(("cv1", "cv2")):
                    cba(f"{key}.m.{j}.{theirs}", p[f"m{j}"][f"ConvBnAct_{k}"],
                        s[f"m{j}"][f"ConvBnAct_{k}"])
                j += 1
        elif "ConvBnAct_1" in p:                # SPPF
            cba(f"{key}.cv1", p["ConvBnAct_0"], s["ConvBnAct_0"])
            cba(f"{key}.cv2", p["ConvBnAct_1"], s["ConvBnAct_1"])
        else:
            cba(key, p, s)
    for i in range(3):
        _put_conv(sd, f"model.{_DETECT}.m.{i}", params[f"detect{i}"])
    anchors = np.asarray(anchors_px, np.float32).reshape(3, -1, 2)
    sd[f"model.{_DETECT}.anchors"] = (
        anchors / np.asarray(YOLO_STRIDES, np.float32)[:, None, None])
    return sd


# -------------------------------------------------------------------- pickles

_SAVED_ONLY = "effocr_saved_only_models"


def save_module_pickle(path: str, sd: Mapping[str, np.ndarray],
                       half: bool = False, **extra: Any) -> None:
    """``sd`` as a full module pickle, ``{"model": Model, **extra}``: the
    tree is built from the names' dotted paths out of classes defined in
    a module that exists only while saving (as an ultralytics ``best.pt``
    pickles their ``Model``); ``running_*`` and ``anchors`` are buffers,
    the rest parameters.  ``half`` saves fp16, as ultralytics does."""
    import torch
    from torch import nn

    mod = types.ModuleType(_SAVED_ONLY)

    class Model(nn.Module):
        pass

    class Block(nn.Module):
        pass

    for cls in (Model, Block):
        cls.__module__, cls.__qualname__ = _SAVED_ONLY, cls.__name__
        setattr(mod, cls.__name__, cls)
    root = Model()
    for key, arr in sd.items():
        *scope, leaf = key.split(".")
        m = root
        for part in scope:
            if part not in m._modules:
                m.add_module(part, Block())
            m = m._modules[part]
        t = torch.from_numpy(np.array(arr, np.float32))
        if leaf.startswith("running_") or leaf == "anchors":
            m.register_buffer(leaf, t)
        else:
            m.register_parameter(leaf, nn.Parameter(t, requires_grad=False))
    if half:
        root.half()
    sys.modules[_SAVED_ONLY] = mod
    try:
        torch.save({"model": root, **extra}, path)
    finally:
        del sys.modules[_SAVED_ONLY]
