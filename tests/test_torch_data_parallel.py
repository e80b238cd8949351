"""Data-parallel inference and sharded retrieval against the JAX package,
on the CPU.

- ``EffOCRInference(devices=[cpu, cpu])``: two replicas, each on its
  line_batch / 2 lines with a crop cap of crop_batch // 2, one packed
  segment each: text and COCO JSON bit for bit those of the unsharded
  port and of the JAX engine on a 2-device mesh (tests/conftest.py gives
  JAX 8 host devices; tests/test_pipeline_e2e.py holds JAX's mesh to its
  unsharded engine the same way), with the glyph oracle of
  tests/test_torch_pipeline.py, on the canvas and the bucket transfer;
  a crop cap that makes segments spill lines into a re-dispatch; JAX's
  refusals with JAX's messages;
- ``knn_topk_sharded`` on 4 shards (C not a multiple of 4: padded rows)
  against JAX's on a 4-way model axis: indices exact, scores 1e-6; k = 1
  (the top-1 route) and k = 3.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from effocr_tpu.core.config import (
    EncoderConfig as JEncoderConfig,
    LocalizerConfig as JLocalizerConfig,
    PipelineConfig as JPipelineConfig,
)
from effocr_tpu.core.mesh import make_mesh
from effocr_tpu.kernels.retrieval import knn_topk_sharded as j_sharded
from effocr_tpu.kernels.retrieval import l2_normalize as j_l2
from effocr_tpu.pipelines.infer import EffOCRInference as JEngine
from effocr_tpu.retrieval.index import PrototypeIndex as JIndex
from effocr_torch.core.config import (
    EncoderConfig,
    LocalizerConfig,
    PipelineConfig,
)
from effocr_torch.interop.flax_bridge import flax_to_state_dict
from effocr_torch.kernels.retrieval import knn_topk, knn_topk_sharded
from effocr_torch.pipelines.infer import EffOCRInference
from effocr_torch.retrieval.index import PrototypeIndex
from test_pipeline_e2e import CHARS
from test_torch_pipeline import (  # noqa: F401
    JaxOracle,
    TorchTinyEncoder,
    _config,
    _record_buffers,
    line_paths,
    tiny_parts,
    torch_oracle,
)

CPU2 = ["cpu", "cpu"]


def _port(tiny_parts, devices=None, **kw):  # noqa: F811
    _, variables, protos = tiny_parts
    enc = TorchTinyEncoder(256)
    enc.load_state_dict(flax_to_state_dict(variables), strict=True)
    cfg = _config(PipelineConfig, LocalizerConfig, EncoderConfig,
                  nms_kernel="cuda", **kw)
    return EffOCRInference(cfg, torch_oracle, enc,
                           PrototypeIndex(protos, CHARS), device="cpu",
                           devices=devices)


def _dumps(coco):
    return json.dumps(coco, sort_keys=True)


def _by_line(coco):
    """COCO output keyed by line, free of the order lines finished in
    (a spilled line finishes after its segment's other lines)."""
    out = {}
    for im in coco["images"]:
        anns = [{k: v for k, v in a.items() if k not in ("id", "image_id")}
                for a in coco["annotations"] if a["image_id"] == im["id"]]
        out[im["file_name"]] = json.dumps(
            [{k: v for k, v in im.items() if k != "id"}, anns],
            sort_keys=True)
    return out


@pytest.mark.parametrize("crop_batch,sub", [(64, 32), (32, 16)])
def test_two_replicas_match_unsharded_and_jax_mesh(line_paths,  # noqa: F811
                                                   tiny_parts,  # noqa: F811
                                                   crop_batch, sub):
    """crop_batch 32: a replica's cap of 16 crops holds any one line of
    the corpus (<= 14 glyphs) but not its two lines together, so
    segments spill tail lines into a re-dispatch on both engines."""
    kw = dict(crop_batch=crop_batch, encoder_sub_batch=sub)
    enc, variables, protos = tiny_parts
    jeng = JEngine(_config(JPipelineConfig, JLocalizerConfig, JEncoderConfig,
                           nms_kernel="pallas", **kw),
                   JaxOracle(), {}, enc, variables, JIndex(protos, CHARS),
                   mesh=Mesh(np.array(jax.devices("cpu")[:2]), ("data",)))
    jres, jcoco = jeng.run(line_paths, return_coco=True)
    single, scoco = _port(tiny_parts, **kw).run(line_paths,
                                                return_coco=True)
    sharded = _port(tiny_parts, CPU2, **kw)
    segs = {}
    _record_buffers(sharded, segs)
    res, coco = sharded.run(line_paths, return_coco=True)
    assert sharded._crop_cap == crop_batch // 2
    assert res == single == jres
    # bit for bit with JAX's mesh, lines in the same order; with the
    # unsharded engine line for line
    assert _dumps(coco) == _dumps(jcoco)
    assert _by_line(coco) == _by_line(scoco)
    # 8 lines in chunks of 4: 4 segments of 2 lines, and the spills
    assert len(segs) > 4 if crop_batch == 32 else len(segs) == 4


def test_two_replicas_bucket_transfer(line_paths, tiny_parts):  # noqa: F811
    """The bucket program shards the same way (each replica letterboxes
    its own buckets on its device)."""
    kw = dict(transfer="bucket", bucket_hw=(64, 512), adaptive_width=False,
              transfer_bits=8)
    single = _port(tiny_parts, **kw).run(line_paths, return_coco=True)
    sharded = _port(tiny_parts, CPU2, **kw).run(line_paths,
                                                return_coco=True)
    assert sharded[0] == single[0]
    assert _dumps(sharded[1]) == _dumps(single[1])


@pytest.mark.parametrize("kw,message", [
    (dict(line_batch=3), "line_batch 3 must divide over the data axis"),
    (dict(crop_batch=63), "crop_batch 63 must divide over the data axis"),
    (dict(crop_source="original", input_channels=3),
     "mesh inference supports the fused letterbox path only")])
def test_refusals_match_jax(tiny_parts, kw, message):  # noqa: F811
    enc, variables, protos = tiny_parts
    jcfg = _config(JPipelineConfig, JLocalizerConfig, JEncoderConfig, **kw)
    with pytest.raises(AssertionError, match=message):
        JEngine(jcfg, JaxOracle(), {}, enc, variables, JIndex(protos, CHARS),
                mesh=Mesh(np.array(jax.devices("cpu")[:2]), ("data",)))
    with pytest.raises(ValueError, match=message):
        _port(tiny_parts, CPU2, **kw)


@pytest.mark.parametrize("k", [1, 3])
def test_knn_topk_sharded_matches_jax(k):
    """tests/test_pallas_retrieval.py's case: 96 queries, 1,030 rows over
    4 shards (2 padded), 50 rows masked."""
    rng = np.random.default_rng(k)
    n, c, d = 96, 1030, 64
    q = rng.normal(size=(n, d)).astype(np.float32)
    p = np.array(j_l2(jnp.asarray(rng.normal(size=(c, d)), jnp.float32)))
    p[7] = p[900]                       # a tie across shards
    mask = np.ones((c,), bool)
    mask[rng.integers(0, c, 50)] = False
    mask[900] = mask[7] = True
    js, ji = j_sharded(jnp.asarray(q), jnp.asarray(p),
                       make_mesh(jax.devices("cpu")[:8], model=4), k=k,
                       row_mask=jnp.asarray(mask))
    ts, ti = knn_topk_sharded(torch.from_numpy(q), torch.from_numpy(p),
                              ["cpu"] * 4, k=k,
                              row_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-6)
    us, ui = knn_topk(torch.from_numpy(q), torch.from_numpy(p), k=k,
                      row_mask=torch.from_numpy(mask))
    assert torch.equal(ui, ti)
