"""effocr_torch models against the Flax models, weights carried across by
interop/flax_bridge.py.

yolov5s (1 channel, the loc2k fitted anchors, canvas 64x256, batch 2),
yolov5n (3 channels, default anchors, a vertical 128x64 canvas, batch 2),
mobilenetv3_small_050 (128 px, 1 channel, batch 4) and convnext_atto
(3 channels, 64 px, batch 3), all at full width.  Flax variables are
random-init with every BatchNorm's scale, bias, mean and variance, every
LayerNorm's scale and bias, and ConvNeXt's LayerScale ``gamma`` drawn
from a numpy seed, so the bridge's BN/LN mapping is exercised and no
ConvNeXt block is near the identity (Flax initialises ``gamma`` to
1e-6).  Tolerances:

- float32 (Flax ``dtype=float32``): decoded probabilities atol 1e-5, box
  coordinates atol 1e-3 px, embeddings rtol 1e-4 (summation order of the
  two convolution libraries);
- bfloat16 (the default dtype): probabilities within 5e-2 and embedding
  cosine >= 0.99 (bf16 rounds at other points in the two frameworks).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effocr_tpu.models import create_encoder as j_encoder
from effocr_tpu.models import create_localizer as j_localizer
from effocr_torch.interop.flax_bridge import flax_to_state_dict
from effocr_torch.models.factory import create_encoder, create_localizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOC2K = os.path.join(ROOT, "bench_results/r5/runs/loc2k/model.json")


def _randomize_bn(variables, rng):
    """Replace BN/LN scale, BN mean/var, every bias and LayerScale gamma
    with seeded random values."""
    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "gamma"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return np.asarray(x)

    out = {"params": jax.tree_util.tree_map_with_path(leaf,
                                                      variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, x: (rng.normal(0, 0.1, x.shape) if p[-1].key == "mean"
                          else rng.uniform(0.5, 1.5, x.shape)
                          ).astype(np.float32),
            variables["batch_stats"])
    return out


def _anchors():
    with open(LOC2K) as f:
        return tuple(tuple(a) for a in json.load(f)["anchors"])


@pytest.fixture(scope="module")
def yolo_pair():
    jm32 = j_localizer("yolov5s", num_classes=2, dtype=jnp.float32,
                       anchors=_anchors())
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 256, 1)).astype(
        np.float32)
    v = jax.jit(lambda a: jm32.init(jax.random.PRNGKey(0), a))(
        jnp.asarray(x[:1]))
    v = _randomize_bn(jax.tree.map(np.asarray, v),
                      np.random.default_rng(1))
    return v, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_yolov5s_matches_flax(yolo_pair, dtype):
    variables, x = yolo_pair
    jm = j_localizer("yolov5s", num_classes=2, dtype=getattr(jnp, dtype),
                     anchors=_anchors())
    ref, _ = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    ref = np.asarray(ref, np.float32)
    tm = create_localizer("yolov5s", 2, in_channels=1,
                          dtype=getattr(torch, dtype), anchors=_anchors())
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got, raw = tm(torch.from_numpy(x))
    got = got.numpy()
    # A = 3 anchors x (8*32 + 4*16 + 2*8) cells, (gy, gx, anchor) order
    assert got.shape == ref.shape == (2, 3 * (256 + 64 + 16), 7)
    assert [tuple(r.shape) for r in raw] == [(2, 8, 32, 3, 7),
                                             (2, 4, 16, 3, 7),
                                             (2, 2, 8, 3, 7)]
    d_prob = np.abs(got[..., 4:] - ref[..., 4:]).max()
    d_box = np.abs(got[..., :4] - ref[..., :4]).max()
    print(f"yolov5s {dtype}: max|dprob| {d_prob:.3g}, max|dbox| "
          f"{d_box:.3g} px")
    if dtype == "float32":
        assert d_prob <= 1e-5 and d_box <= 1e-3, (d_prob, d_box)
    else:
        assert d_prob <= 5e-2, d_prob


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mobilenetv3_small_050_matches_flax(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (4, 128, 128, 1)).astype(np.float32)
    jm = j_encoder("mobilenetv3_small_050", dtype=getattr(jnp, dtype))
    v = jax.jit(lambda a: j_encoder("mobilenetv3_small_050").init(
        jax.random.PRNGKey(1), a))(jnp.asarray(x[:1]))
    v = _randomize_bn(jax.tree.map(np.asarray, v), rng)
    ref = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        v, jnp.asarray(x)), np.float32)
    tm = create_encoder("mobilenetv3_small_050", in_channels=1,
                        dtype=getattr(torch, dtype))
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (4, 1024)
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1)
                                * np.linalg.norm(ref, axis=1))
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"mobilenetv3_small_050 {dtype}: max rel {rel:.3g}, min cos "
          f"{cos.min():.6f}")
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    else:
        assert cos.min() >= 0.99, cos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_yolov5n_matches_flax(dtype):
    """The jp vertical detector's architecture: 3 channels, a canvas
    taller than wide (128x64 here, 640x96 in the jp config)."""
    x = np.random.default_rng(3).uniform(0, 1, (2, 128, 64, 3)).astype(
        np.float32)
    v = jax.jit(lambda a: j_localizer("yolov5n", num_classes=2).init(
        jax.random.PRNGKey(2), a))(jnp.asarray(x[:1]))
    v = _randomize_bn(jax.tree.map(np.asarray, v), np.random.default_rng(4))
    jm = j_localizer("yolov5n", num_classes=2, dtype=getattr(jnp, dtype))
    ref, _ = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        v, jnp.asarray(x))
    ref = np.asarray(ref, np.float32)
    tm = create_localizer("yolov5n", 2, in_channels=3,
                          dtype=getattr(torch, dtype))
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(x))
    got = got.numpy()
    assert got.shape == ref.shape == (2, 3 * (16 * 8 + 8 * 4 + 4 * 2), 7)
    d_prob = np.abs(got[..., 4:] - ref[..., 4:]).max()
    d_box = np.abs(got[..., :4] - ref[..., :4]).max()
    print(f"yolov5n {dtype}: max|dprob| {d_prob:.3g}, max|dbox| "
          f"{d_box:.3g} px")
    if dtype == "float32":
        assert d_prob <= 1e-5 and d_box <= 1e-3, (d_prob, d_box)
    else:
        assert d_prob <= 5e-2, d_prob


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convnext_atto_matches_flax(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (3, 64, 64, 3)).astype(np.float32)
    v = jax.jit(lambda a: j_encoder("convnext_atto").init(
        jax.random.PRNGKey(3), a))(jnp.asarray(x[:1]))
    v = jax.tree.map(np.asarray, v)
    # the Flax auto-names the bridge maps
    assert set(v["params"]["stage2_block5"]) == {
        "dwconv", "LayerNorm_0", "mlp_up", "mlp_down", "gamma"}
    assert v["params"]["stage0_block0"]["dwconv"]["kernel"].shape == (
        7, 7, 1, 40)
    v = _randomize_bn(v, rng)
    jm = j_encoder("convnext_atto", dtype=getattr(jnp, dtype))
    ref = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        v, jnp.asarray(x)), np.float32)
    tm = create_encoder("convnext_atto", in_channels=3,
                        dtype=getattr(torch, dtype))
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    assert tm.stage0_block0.dwconv.weight.shape == (40, 1, 7, 7)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape == (3, 320)
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1)
                                * np.linalg.norm(ref, axis=1))
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"convnext_atto {dtype}: max rel {rel:.3g}, min cos "
          f"{cos.min():.6f}")
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    else:
        assert cos.min() >= 0.99, cos


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_init_params_draws_flax_lecun_normal(kind):
    """factory.init_params draws conv and Dense weights as Flax's default
    lecun_normal does: a normal truncated at +-2 and rescaled, std within
    2% of 1/sqrt(fan_in) and no |w| past 2.28/sqrt(fan_in), as JAX's own
    draw of the same shape gives."""
    from flax import linen as fnn

    from effocr_torch.models import layers
    from effocr_torch.models.factory import init_params

    if kind == "conv":   # a (3, 3, 64, 256) Flax kernel
        m, shape, fan_in = layers.Conv(64, 256, 3), (3, 3, 64, 256), 576
    else:
        m, shape, fan_in = layers.Dense(512, 384), (512, 384), 512
    w = init_params(m, 0).weight.detach().numpy() * fan_in ** 0.5
    ref = np.asarray(fnn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), shape)) * fan_in ** 0.5
    for a in (w, ref):
        assert abs(a.std() - 1.0) < 0.02
        assert 2.2 < np.abs(a).max() <= 2.28
    assert (m.bias.detach().numpy() == 0).all()
