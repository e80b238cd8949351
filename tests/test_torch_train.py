"""effocr_torch's recognizer training against the JAX package, on the CPU
at small sizes (mobilenetv3_small_050 / convnext_atto's widths at one
block a stage, 32 px, float32 compute), with the same inputs and weights
(bridged with interop/flax_bridge.py):

- the three losses and their gradients (1e-5); train-mode BatchNorm
  outputs and new batch_stats against Flax's ``mutable=["batch_stats"]``
  apply (1e-5); AdamW + schedule against optax 0.2.6 on identical
  gradients over 20 steps (1e-6 relative);
- one ``make_train_step`` on the draws of the JAX step's key: loss
  (1e-5), gradients and new batch_stats (1e-4 of the largest |value|);
- ``fit`` with no_aug for two epochs at a learning rate that moves the
  embeddings 10x past the tolerance (a control whose optimizer never
  steps fails it): val/accuracy equal, the optimizer's count and
  per-step lr those of JAX's opt_state, ref.txt identical, ref.npz
  within 1e-4; a run resumed after epoch 1 ends with the parameters of
  an uninterrupted run, bit for bit;
- ``--resume`` across packages: the JAX trainer's last.msgpack (aux head
  under optax.multi_transform) loads into the port's trainer and is
  written back bit for bit; a step resumed from the other package's file
  is held to the same package's step (loss 1e-5, moments 1e-4 of the
  largest, the update's direction and norm); the earlier layout loads;
- the CLIs: ``train-recognizer`` then ``build-index --test
  --mine_hardneg 2`` on ``--device cpu``, the run dir loaded by both
  packages' ``load_engine`` (a classifier-mode run too, with its
  class_map.json); ``infer --build_index_from`` against the
  JAX command (ref.txt identical, embeddings within 1e-4, the same 1-NN
  decode); no GPU and no ``--device cpu``: the CLIs raise.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from effocr_tpu.cli import infer as j_infer_cli
from effocr_tpu.core.config import EncoderConfig as JEncoderConfig
from effocr_tpu.core.config import RecognizerTrainConfig as JTrainConfig
from effocr_tpu.data.folder import CharFolderDataset as JDataset
from effocr_tpu.models import create_encoder as j_encoder
from effocr_tpu.models.layers import ConvBnAct as JConvBnAct
from effocr_tpu.retrieval.index import PrototypeIndex as JIndex
from effocr_tpu.train import checkpoint as j_ckpt
from effocr_tpu.train import losses as j_losses
from effocr_tpu.train.recognizer import RecognizerTrainer as JTrainer
from effocr_tpu.train.recognizer import make_train_step as j_make_step
from effocr_torch.cli import infer as t_infer_cli
from effocr_torch.core.config import EncoderConfig, RecognizerTrainConfig
from effocr_torch.data.folder import CharFolderDataset
from effocr_torch.interop.flax_bridge import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from effocr_torch.interop.flax_msgpack import write_variables
from effocr_torch.models.factory import (
    create_encoder,
    create_localizer,
    init_params,
)
from effocr_torch.models.layers import ConvBnAct
from effocr_torch.retrieval.index import PrototypeIndex
from effocr_torch.train import checkpoint as ckpt
from effocr_torch.train import losses
from effocr_torch.train.optim import (
    AdamW,
    scaled,
    warmup_cosine_decay_schedule,
)
from effocr_torch.train.recognizer import RecognizerTrainer, make_train_step
from test_torch_data import char_tree, jax_draws, torch_draws  # noqa: F401

F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small CPU models gain nothing from many threads, and the suite runs
    several workers at once: two intra-op threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture
def cut_mobilenet(monkeypatch):
    """mobilenetv3_small_050 in both packages at 4 of its 11 block specs,
    one of each kind (3x3 and 5x5, SE or not, ReLU and hard-swish,
    stride 2 and residual): the same arithmetic at half the JAX trace and
    compile of one step.  (``fit`` keeps all 11: with 4, the no-step
    control lands within 1e-3 of JAX at the learning rates where the
    port stays within 1e-4.)"""
    from effocr_tpu.models import mobilenetv3 as j_mnv3
    from effocr_torch.models import mobilenetv3 as t_mnv3

    for module in (j_mnv3, t_mnv3):
        monkeypatch.setattr(module, "SMALL_SPECS", tuple(
            module.SMALL_SPECS[i] for i in (0, 1, 3, 4)))


# ---------------------------------------------------------------- losses
@pytest.mark.parametrize("which", ["supcon", "cosine", "ce"])
def test_losses_and_gradients_match(which):
    rng = np.random.default_rng(len(which))
    emb = rng.normal(size=(12, 16)).astype(np.float32)
    labels = rng.integers(0, 4, 12).astype(np.int32)
    valid = rng.uniform(size=12) > 0.2
    w = rng.normal(size=(4, 16)).astype(np.float32)
    for v in (None, valid):
        if which == "supcon":
            jf = lambda e: j_losses.supcon_loss(  # noqa: E731
                e, jnp.asarray(labels), 0.1,
                None if v is None else jnp.asarray(v))
            tf = lambda e: losses.supcon_loss(  # noqa: E731
                e, torch.from_numpy(labels), 0.1,
                None if v is None else torch.from_numpy(v))
        elif which == "cosine":
            jf = lambda e: j_losses.cosine_classifier_loss(  # noqa: E731
                e, jnp.asarray(w), jnp.asarray(labels), 0.07,
                None if v is None else jnp.asarray(v))
            tf = lambda e: losses.cosine_classifier_loss(  # noqa: E731
                e, torch.from_numpy(w), torch.from_numpy(labels), 0.07,
                None if v is None else torch.from_numpy(v))
        else:
            jf = lambda e: j_losses.cross_entropy_loss(  # noqa: E731
                e, jnp.asarray(labels), None if v is None else jnp.asarray(v))
            tf = lambda e: losses.cross_entropy_loss(  # noqa: E731
                e, torch.from_numpy(labels),
                None if v is None else torch.from_numpy(v))
        jl, jg = jax.jit(jax.value_and_grad(jf))(jnp.asarray(emb))
        e = torch.from_numpy(emb).requires_grad_()
        tl = tf(e)
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
        np.testing.assert_allclose(e.grad.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-5 * np.abs(jg).max())


# --------------------------------------------------------- train-mode BN
def _seeded_vars(arch, channels, seed, model=None):
    """Flax variables of a seeded port-side init of ``model`` (default the
    registry's ``arch``; cheaper than a JAX init, which compiles), with
    ConvNeXt's LayerScale off its 1e-6."""
    m = init_params(model or create_encoder(arch, in_channels=channels,
                                            dtype=F32), seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, prm in m.named_parameters():
            if name.endswith("gamma"):
                prm.copy_(0.5 + torch.rand(prm.shape, generator=g))
    return state_dict_to_flax(m.state_dict()), m.out_features


def _train_apply(model, variables, x):
    out, mut = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    return np.asarray(out), flax_to_state_dict(
        {"batch_stats": _np(mut["batch_stats"])})


def _with_stats(variables, rng):
    """Non-trivial running stats, so the momentum update shows."""
    return {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        variables["batch_stats"])}


def test_train_mode_batchnorm_matches_flax():
    """Train-mode BatchNorm: a ConvBnAct (momentum 0.97) and a
    MobileNetV3 inverted-residual block (momentum 0.9, with its SE gate)
    within 1e-5: outputs and the updated batch_stats.  (The whole network
    is held at 1e-4 by test_train_step_matches_jax.)"""
    from effocr_tpu.models.mobilenetv3 import (
        SMALL_SPECS,
        InvertedResidual as JBlock,
    )
    from effocr_torch.models.mobilenetv3 import InvertedResidual

    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 9, 9, 8)).astype(np.float32)
    cases = [
        (JConvBnAct(16, 3, dtype=jnp.float32), ConvBnAct(8, 16, 3, dtype=F32)),
        (JBlock(SMALL_SPECS[4], 0.5, dtype=jnp.float32),
         InvertedResidual(8, SMALL_SPECS[4], 0.5, dtype=F32)),
    ]
    for jm, tm in cases:
        variables = _with_stats(state_dict_to_flax(
            init_params(tm, 1).state_dict()), rng)
        ref, new_stats = _train_apply(jm, variables, x)
        tm.load_state_dict(flax_to_state_dict(variables))
        tm.train()
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).detach().numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        sd = tm.state_dict()
        assert new_stats and all(k in sd for k in new_stats)
        for k, v in new_stats.items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("warmup_frac,mult,schedule", [
    (0.25, 1.0, "cosine"), (0.0, 10.0, "cosine"), (0.05, 3.0, "cosine"),
    (0.0, 1.0, "constant")])
def test_adamw_matches_optax(warmup_frac, mult, schedule):
    """The JAX trainer's _build_optimizer (multi_transform with the aux
    lr multiple) against train/optim.py on the same gradients."""
    rng = np.random.default_rng(int(mult * 10))
    shapes = [(5, 3), (7,), (2, 2, 3), (4, 6)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.integers(-6, 1)).astype(
        np.float32) for s in shapes] for _ in range(20)]
    lr, total = 1e-3, 20
    warmup = int(warmup_frac * total)
    if schedule == "cosine":
        j_lr = optax.warmup_cosine_decay_schedule(
            init_value=0.0 if warmup else lr, peak_value=lr,
            warmup_steps=warmup, decay_steps=total, end_value=lr * 0.1)
        t_lr = warmup_cosine_decay_schedule(0.0 if warmup else lr, lr,
                                            warmup, total, lr * 0.1)
    else:
        j_lr = t_lr = lr

    def adamw(m=1.0):
        s = j_lr if m == 1.0 else ((lambda t: j_lr(t) * m) if callable(j_lr)
                                   else j_lr * m)
        return optax.adamw(s, b2=0.98, weight_decay=5e-4)

    tx = optax.multi_transform({"model": adamw(), "aux": adamw(mult)},
                               param_labels={"model": "model", "aux": "aux"})
    tree = {"model": [jnp.asarray(p) for p in params[:3]],
            "aux": jnp.asarray(params[3])}
    state = tx.init(tree)
    update = jax.jit(tx.update)
    tp = [torch.tensor(p) for p in params]
    opt = AdamW([(tp[:3], t_lr), (tp[3:], scaled(t_lr, mult))], b2=0.98,
                weight_decay=5e-4)
    for g in grads:
        u, state = update({"model": [jnp.asarray(a) for a in g[:3]],
                           "aux": jnp.asarray(g[3])}, state, tree)
        tree = optax.apply_updates(tree, u)
        for p, a in zip(tp, g):
            p.grad = torch.tensor(a)
        opt.step()
    for ref, got in zip(tree["model"] + [tree["aux"]], tp):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=0)


# --------------------------------------------------------- index decode
def test_prototype_index_build_search_decode_match():
    rng = np.random.default_rng(4)
    images = rng.uniform(size=(10, 3, 4)).astype(np.float32)
    chars = list("abcdefghij")

    def embed(x):     # [B, 3, 4] -> [B, 4], zero rows for the padding
        return np.asarray(x).sum(1) - 0.5 * np.asarray(x).max(1)

    ji = JIndex.build(embed, images, chars, batch_size=4)
    ti = PrototypeIndex.build(embed, images, chars, batch_size=4)
    np.testing.assert_allclose(ti.embeddings, ji.embeddings, rtol=1e-6,
                               atol=1e-7)
    ji.blacklist("c")
    ti.blacklist("c")
    q = rng.normal(size=(7, 4)).astype(np.float32)
    for k in (1, 3):
        (js, jx), (ts, tx) = ji.search(q, k=k), ti.search(q, k=k)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-6)
        assert ti.decode(q, k=k) == ji.decode(q, k=k)


# -------------------------------------------------------- one train step
class _GradRecorder:
    """Optimizer stand-in: keeps the gradients, leaves the parameters."""

    def __init__(self, named):
        self.named = named
        self.grads = None

    def zero_grad(self):
        for p in self.named.values():
            p.grad = None

    def step(self):
        self.grads = {k: p.grad.clone() for k, p in self.named.items()}


def _capture_grads():
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(np.zeros_like, p)},
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), {"g": g}))


def _step_models(arch, channels):
    """(Flax, torch) float32 encoders for the one-step test: the registry's
    mobilenetv3_small_050, and convnext_atto's widths at one block a stage
    (atto has 2, 2, 6, 2: the same block arithmetic, a third of the JAX
    trace and compile)."""
    if arch == "convnext_atto":
        from effocr_tpu.models.convnext import ConvNeXt as JConvNeXt
        from effocr_torch.models.convnext import ConvNeXt

        kw = dict(depths=(1, 1, 1, 1), dims=(40, 80, 160, 320))
        return (JConvNeXt(dtype=jnp.float32, **kw),
                ConvNeXt(in_channels=channels, dtype=F32, **kw))
    return (j_encoder(arch, dtype=jnp.float32),
            create_encoder(arch, in_channels=channels, dtype=F32))


@pytest.mark.parametrize("arch,channels,bank,lang", [
    ("mobilenetv3_small_050", 1, True, "en"),
    ("convnext_atto", 3, False, "jp")])
def test_train_step_matches_jax(arch, channels, bank, lang, cut_mobilenet):
    """The JAX step (augment with its key -> forward -> SupCon + aux
    cosine CE) and the port's on the draws of that key (made in the JAX
    step's program)."""
    rng = np.random.default_rng(channels)
    b, size, n_cls = 8, 32, 4
    cfg_kw = dict(batch_size=b, lang=lang, crop_sim=0.5, paired_jitter=0.5,
                  aux_ce_weight=1.0, high_blur=not bank)
    jcfg = JTrainConfig(encoder=JEncoderConfig(arch=arch, image_size=size,
                                               input_channels=channels),
                        **cfg_kw)
    tcfg = RecognizerTrainConfig(encoder=EncoderConfig(
        arch=arch, image_size=size, input_channels=channels), **cfg_kw)
    jm, tm = _step_models(arch, channels)
    variables, dim = _seeded_vars(arch, channels, 3, tm)
    w = rng.normal(size=(n_cls, dim)).astype(np.float32)
    n_bank = 12
    bank_u8 = rng.integers(0, 256, (n_bank, size, size), np.uint8)
    bank_u8[:, :, :6] = 255
    bank_t = rng.integers(0, n_cls, n_bank).astype(np.int32)
    bank_p = rng.uniform(size=n_bank) < 0.4
    idx = rng.permutation(n_bank)[:b].astype(np.int32)
    key = jax.random.PRNGKey(11)
    batch = ((bank_u8, bank_t, bank_p, idx) if bank else
             (np.repeat(bank_u8[idx][..., None], 3, -1), bank_t[idx],
              bank_p[idx]))

    state = {"params": variables["params"],
             "batch_stats": variables.get("batch_stats", {}),
             "aux": {"w": jnp.asarray(w)}}
    state["opt_state"] = _capture_grads().init(
        {"model": state["params"], "aux": state["aux"]})
    jstep = j_make_step(jm, jcfg, _capture_grads(), False, use_aux=True,
                        bank_mode=bank)
    (new, jloss), draws = jax.jit(lambda *a: (jstep(*a), jax_draws(
        a[-1], b, size, lang, not bank, 0.5, 0.5)))(
        state, *map(jnp.asarray, batch), key)
    jgrads = _np(new["opt_state"]["g"])

    tm.load_state_dict(flax_to_state_dict(variables))
    aux = torch.tensor(w, requires_grad=True)
    named = dict(tm.named_parameters())
    named["aux"] = aux
    rec = _GradRecorder(named)
    tstep = make_train_step(tm, tcfg, rec, False, aux=aux, bank_mode=bank)
    tloss = tstep(*(torch.from_numpy(a).long() if a.dtype == np.int32
                    else torch.from_numpy(a) for a in batch),
                  torch_draws(draws))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    ref = flax_to_state_dict({"params": jgrads["model"]})
    ref["aux"] = torch.from_numpy(np.array(jgrads["aux"]["w"]))
    assert ref.keys() == rec.grads.keys()
    # tolerance relative to the largest |g|: a BatchNorm bias ahead of
    # another train-mode BatchNorm has a gradient of rounding noise
    gmax = max(float(g.abs().max()) for g in ref.values())
    for k, g in ref.items():
        np.testing.assert_allclose(rec.grads[k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * gmax, err_msg=k)
    if bank:   # (convnext has no BatchNorm)
        sd = tm.state_dict()
        stats = flax_to_state_dict({"batch_stats": _np(new["batch_stats"])})
        smax = max(float(v.abs().max()) for v in stats.values())
        for k, v in stats.items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-4 * smax, err_msg=k)


# ------------------------------------------------------------------- fit
def _fit_cfg(cls, enc_cls, **kw):
    base = dict(batch_size=6, m_per_class=2, num_epochs=2, lr=2e-6,
                lang="en", no_aug=True, data_device="resident")
    base.update(kw)
    return cls(encoder=enc_cls(arch="mobilenetv3_small_050", image_size=32,
                               input_channels=1), **base)


def _val_acc(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r["val/accuracy"] for r in map(json.loads, f)
                if "val/accuracy" in r]


def _noise_leaves(variables, dataset, indices):
    """Parameters whose gradient at init is rounding noise (below 1e-5 of
    the largest |g|): a BatchNorm bias ahead of another train-mode
    BatchNorm cancels out of every train-mode forward, yet acts in eval
    mode (and a BatchNorm scale can fall below the line too).  Adam turns
    its noise into +-lr steps whose signs differ between the packages."""
    m = create_encoder("mobilenetv3_small_050", in_channels=1, dtype=F32)
    m.load_state_dict(flax_to_state_dict(variables))
    imgs, targets, _ = dataset.load_batch(indices, 32)
    x = torch.from_numpy(imgs.mean(-1, keepdims=True).astype(np.uint8))
    from effocr_torch.kernels.image_ops import normalize_imagenet

    losses.supcon_loss(m.train()(normalize_imagenet(x.float() / 255.0)),
                       torch.from_numpy(targets).long(), 0.1).backward()
    g = {k: float(p.grad.abs().max()) for k, p in m.named_parameters()}
    return {k for k, v in g.items() if v < 1e-5 * max(g.values())}


def _optax_lrs(tx, n):
    """[model, aux] learning rate of each of the first n updates of the
    JAX trainer's optimizer: with gradient 1 and parameters 0 an update
    is -lr(count) * m_hat / (sqrt(v_hat) + eps), where m_hat / sqrt(v_hat)
    is 1 up to the float32 rounding of the bias corrections (1 - 0.999^n
    cancels: ~3e-5 relative)."""
    tree = {"model": jnp.zeros(1), "aux": jnp.zeros(1)}
    state, update, out = tx.init(tree), jax.jit(tx.update), []
    for _ in range(n):
        u, state = update(jax.tree.map(jnp.ones_like, tree), state, tree)
        out.append([-float(u["model"][0]), -float(u["aux"][0])])
    return out


# four steps (2 epochs x 2): cosine with one warmup step, and the aux head
# at 3x lr (the JAX trainer's multi_transform); lr 5e-5 moves the
# embeddings ~30x the 1e-4 tolerance (the control below)
FIT_KW = dict(lr=5e-5, lr_schedule="cosine", warmup_frac=0.25,
              num_passes=2, aux_ce_weight=1.0, aux_lr_mult=3.0)


def test_fit_no_aug_matches_jax(char_tree, tmp_path):  # noqa: F811
    """fit with no_aug on the same sampler seeds: val/accuracy equal,
    the optimizer's count and per-step lr (both groups) those of JAX's
    opt_state, ref.txt identical, ref.npz within 1e-4 and the aux head
    within 1e-5, with the rounding-noise leaves (_noise_leaves) set to
    JAX's values first.  A control run whose optimizer never steps misses
    JAX's ref.npz by more than 10x the tolerance."""
    jds, tds = JDataset(char_tree), CharFolderDataset(char_tree)
    from effocr_tpu.data.folder import split_indices

    idx_train, idx_val, _ = split_indices(jds, ["line0"], ["line1"],
                                          ["line2"])
    renders = jds.render_indices()
    jt = JTrainer(_fit_cfg(JTrainConfig, JEncoderConfig, **FIT_KW),
                  j_encoder("mobilenetv3_small_050", dtype=jnp.float32),
                  str(tmp_path / "jax"))
    variables, _ = _seeded_vars("mobilenetv3_small_050", 1, 0)
    jt.state = {"params": variables["params"],
                "batch_stats": variables["batch_stats"]}
    jt.state["opt_state"] = jt.tx.init(jt.state["params"])

    def trainer(d, steps=True):
        t = RecognizerTrainer(_fit_cfg(RecognizerTrainConfig, EncoderConfig,
                                       **FIT_KW),
                              create_encoder("mobilenetv3_small_050",
                                             in_channels=1, dtype=F32),
                              str(tmp_path / d), device="cpu")
        t.set_variables(variables)
        if not steps:
            build = t._build_optimizer

            def build_without_step(total_steps):
                build(total_steps)
                t.optimizer.step = lambda: None

            t._build_optimizer = build_without_step
        return t

    tt, control = trainer("torch"), trainer("control", steps=False)
    init_emb = control.build_ref_index(tds, renders).embeddings
    ja = jt.fit(jds, idx_train, idx_val, renders)
    assert tt.fit(tds, idx_train, idx_val, renders) == ja
    control.fit(tds, idx_train, idx_val, renders)
    assert _val_acc(str(tmp_path / "torch")) == _val_acc(
        str(tmp_path / "jax"))

    counts = {int(s.count) for s in jax.tree.leaves(
        jt.state["opt_state"],
        is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)}
    assert counts == {tt.optimizer.count} == {4}
    port_lrs = [[tt.optimizer.groups[g][1](t) for g in (0, 1)]
                for t in range(4)]
    assert port_lrs[0] == [0.0, 0.0]        # the warmup's first update
    np.testing.assert_allclose(port_lrs, _optax_lrs(jt.tx, 4), rtol=1e-4,
                               atol=0)

    # the port's enc_best.msgpack reads the same in the JAX loader
    best = str(tmp_path / "torch" / "enc_best.msgpack")
    loaded = j_ckpt.load_variables(jt.variables, best)
    for a, b in zip(jax.tree.leaves(_np(loaded)),
                    jax.tree.leaves(ckpt.load_variables(best))):
        np.testing.assert_array_equal(a, b)

    noise = _noise_leaves(variables, tds, idx_train)
    # every project_bn bias, and (from lecun_normal's truncated draw)
    # block2's expand_bn scale at 3.0e-6 of the largest |g|: BatchNorm
    # leaves all
    assert noise and all(k.endswith(("_bn.bias", "_bn.weight"))
                         for k in noise)
    j_params = flax_to_state_dict({"params": _np(jt.state["params"])})
    for t in (tt, control):
        sd = t.model.state_dict()
        for k in noise:
            sd[k].copy_(j_params[k])
    jt.build_ref_index(jds, renders)
    tt.build_ref_index(tds, renders)
    control.build_ref_index(tds, renders)
    with open(tmp_path / "jax" / "ref.txt") as f, \
            open(tmp_path / "torch" / "ref.txt") as g:
        assert f.read() == g.read()
    jr, tr, cr = (np.load(str(tmp_path / d / "ref.npz"))
                  for d in ("jax", "torch", "control"))
    np.testing.assert_allclose(tr["embeddings"], jr["embeddings"], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(tr["thumbnails"], jr["thumbnails"])
    assert np.abs(jr["embeddings"] - init_emb).max() > 1e-3
    assert np.abs(cr["embeddings"] - jr["embeddings"]).max() > 1e-3
    j_aux = np.asarray(jt.state["aux"]["w"])
    np.testing.assert_allclose(tt.aux.detach().numpy(), j_aux, rtol=0,
                               atol=1e-5)
    assert np.abs(control.aux.detach().numpy() - j_aux).max() > 1e-4


def test_fit_resume_replays_uninterrupted_run(char_tree,  # noqa: F811
                                              tmp_path):
    """Augmentation on, cosine schedule, aux head: a run killed after
    epoch 1 and resumed ends bit for bit where an uninterrupted one does;
    a last.msgpack without this package's format is refused."""
    ds = CharFolderDataset(char_tree)
    from effocr_torch.data.folder import split_indices

    idx_train, idx_val, _ = split_indices(ds, ["line0"], ["line1"],
                                          ["line2"])
    cfg = _fit_cfg(RecognizerTrainConfig, EncoderConfig, no_aug=False,
                   data_device="stream", lr=1e-3, lr_schedule="cosine",
                   warmup_frac=0.5, aux_ce_weight=1.0, paired_jitter=0.3,
                   crop_sim=0.3)

    def trainer(d):
        return RecognizerTrainer(cfg, create_encoder(
            "mobilenetv3_small_050", in_channels=1, dtype=F32),
            str(tmp_path / d), device="cpu")

    full = trainer("full")
    full.fit(ds, idx_train, idx_val, ds.render_indices())

    cut = trainer("cut")
    save_last = cut._save_last

    def killed_after_first(epoch_done, *a):
        save_last(epoch_done, *a)
        raise KeyboardInterrupt

    cut._save_last = killed_after_first
    with pytest.raises(KeyboardInterrupt):
        cut.fit(ds, idx_train, idx_val, ds.render_indices())
    resumed = trainer("cut")
    resumed.init_state(123)              # overwritten by the resume
    resumed.fit(ds, idx_train, idx_val, ds.render_indices(), resume=True)
    a, b = full.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(full.aux, resumed.aux)
    assert full.best_acc == resumed.best_acc

    foreign = trainer("foreign")
    os.makedirs(foreign.run_dir, exist_ok=True)
    j_ckpt.save_train_state({"params": {"x": np.zeros(2, np.float32)}},
                            os.path.join(foreign.run_dir, "last.msgpack"))
    with open(os.path.join(foreign.run_dir, "last_meta.json"), "w") as f:
        json.dump({"epoch": 1, "step": 2, "best_acc": 0.0}, f)
    with pytest.raises(ValueError, match="not a train state written by"):
        foreign.fit(ds, idx_train, idx_val, ds.render_indices(), resume=True)


# ------------------------------------------------------------------ CLIs
def _split_files(root):
    paths = []
    for i, split in enumerate(("train", "val", "test")):
        p = os.path.join(root, f"{split}.json")
        with open(p, "w") as f:
            json.dump({"images": [{"id": 0, "file_name": f"line{i}.png"}],
                       "annotations": []}, f)
        paths.append(p)
    return paths


def _loc_dir(root):
    """A random yolov5n localizer dir (1 channel, 64 x 256 canvas)."""
    d = os.path.join(root, "loc")
    os.makedirs(d, exist_ok=True)
    loc = init_params(create_localizer("yolov5n", 2, in_channels=1), 5)
    ckpt.save_variables(state_dict_to_flax(loc.state_dict()),
                        os.path.join(d, "best_bbox_mAP.msgpack"))
    with open(os.path.join(d, "model.json"), "w") as f:
        json.dump({"arch": "yolov5n", "num_classes": 2, "input_size": 256,
                   "input_height": 64, "input_channels": 1}, f)
    return d


class _FlaxInitProxy:
    """A Flax module minus its eager init (it compiles op by op, tens of
    seconds a model on a CPU).  The JAX load_engine uses init only for the
    template of its checkpoint reader, which the port's twin of the model
    (same Flax scopes) provides."""

    def __init__(self, module, twin):
        self.module, self.twin = module, twin

    def init(self, key, x, train=False):
        return state_dict_to_flax(self.twin(x.shape[-1]).state_dict())

    def __getattr__(self, attr):
        return getattr(self.module, attr)


def _skip_flax_init(monkeypatch, encoder_dtype=jnp.bfloat16):
    """The JAX load_engine's localizer, encoder and classifier factories
    return _FlaxInitProxy modules."""
    import effocr_tpu.models as j_models
    from effocr_torch.models.factory import create_classifier

    j_loc, j_enc = j_infer_cli.create_localizer, j_infer_cli.create_encoder
    j_cls = j_models.create_classifier
    monkeypatch.setattr(j_infer_cli, "create_localizer", lambda a, **kw: (
        _FlaxInitProxy(j_loc(a, **kw), lambda c: create_localizer(
            a, in_channels=c, **kw))))
    monkeypatch.setattr(j_infer_cli, "create_encoder", lambda a: (
        _FlaxInitProxy(j_enc(a, dtype=encoder_dtype),
                       lambda c: create_encoder(a, in_channels=c))))
    monkeypatch.setattr(j_models, "create_classifier", lambda a, n: (
        _FlaxInitProxy(j_cls(a, n), lambda c: create_classifier(
            a, n, in_channels=c))))


def _engine_args(add_args, rec_dir, loc_dir, *extra):
    p = argparse.ArgumentParser()
    add_args(p)
    return p.parse_args(["--recognizer_dir", rec_dir, "--localizer_dir",
                         loc_dir, "--lang", "en", "--line_batch", "2",
                         "--crop_batch", "32", *extra])


def test_cli_train_build_index_load_in_both(char_tree, tmp_path,  # noqa: F811
                                            monkeypatch):
    from effocr_torch.cli import build_index, train_recognizer

    tr, va, te = _split_files(str(tmp_path))
    run = str(tmp_path / "rec")
    train_recognizer.main([
        "--device", "cpu", "--root_dir_path", char_tree,
        "--train_ann_path", tr, "--val_ann_path", va, "--test_ann_path", te,
        "--run_name", run, "--auto_model", "mobilenetv3_small_050",
        "--imsize", "32", "--input_channels", "1", "--batch_size", "6",
        "--m", "2", "--lr", "1e-3", "--lr_schedule", "cosine",
        "--warmup_frac", "0.25", "--aux_ce_weight", "1.0", "--ref_source",
        "centroid", "--paired_jitter", "0.1", "--infer_hardneg_k", "2",
        "--data_device", "resident", "--test_at_end", "--num_epochs", "2",
        "--lang", "en"])
    for name in ("args_log.json", "model.json", "enc_best.msgpack",
                 "ref.npz", "ref.txt", "hns.txt", "last.msgpack"):
        assert os.path.exists(os.path.join(run, name)), name
    os.remove(os.path.join(run, "ref.npz"))
    build_index.main(["--device", "cpu", "--run_dir", run, "--test",
                      "--mine_hardneg", "2"])
    with open(os.path.join(run, "hns.txt")) as f:
        hns = f.read().split("\n")
    assert len(hns) == 3 and all(len(s) == 2 for s in hns)
    loc = _loc_dir(str(tmp_path))
    t_engine = t_infer_cli.load_engine(_engine_args(
        t_infer_cli.add_engine_args, run, loc, "--device", "cpu"))
    _skip_flax_init(monkeypatch)
    j_engine = j_infer_cli.load_engine(_engine_args(
        j_infer_cli.add_engine_args, run, loc))
    assert t_engine.index.chars == j_engine.index.chars and len(
        t_engine.index) == 3
    np.testing.assert_allclose(t_engine.index.embeddings,
                               j_engine.index.embeddings, rtol=0, atol=1e-6)
    res = t_engine.run([np.full((40, 200, 1), 255, np.uint8)])
    assert list(res) == [0]


def test_cli_classifier_run_loads_in_both(char_tree, tmp_path,  # noqa: F811
                                          monkeypatch):
    """Classifier mode (--N_classes, cross-entropy): the run dir's
    class_map.json, model.json and {encoder, head} checkpoint load in
    both packages' load_engine."""
    from effocr_torch.cli import train_recognizer

    tr, va, te = _split_files(str(tmp_path))
    run = str(tmp_path / "cls")
    train_recognizer.main([
        "--device", "cpu", "--root_dir_path", char_tree,
        "--train_ann_path", tr, "--val_ann_path", va, "--test_ann_path", te,
        "--run_name", run, "--auto_model", "mobilenetv3_small_050",
        "--imsize", "32", "--input_channels", "1", "--batch_size", "6",
        "--m", "2", "--lr", "1e-3", "--N_classes", "3", "--num_epochs", "1",
        "--test_at_end", "--lang", "en"])
    with open(os.path.join(run, "class_map.json")) as f:
        assert json.load(f) == {"0": "A", "1": "X", "2": "o"}
    loc = _loc_dir(str(tmp_path))
    t_engine = t_infer_cli.load_engine(_engine_args(
        t_infer_cli.add_engine_args, run, loc, "--device", "cpu"))
    _skip_flax_init(monkeypatch)
    j_engine = j_infer_cli.load_engine(_engine_args(
        j_infer_cli.add_engine_args, run, loc))
    assert t_engine.classifier_mode and j_engine.class_map == \
        t_engine.class_map == {0: "A", 1: "X", 2: "o"}


def test_infer_build_index_from_matches_jax(char_tree, tmp_path,  # noqa: F811
                                            monkeypatch):
    """Both packages' load_engine on a recognizer dir without ref.npz
    and --build_index_from (float32 encoders): the same ref.txt, the
    same embeddings within 1e-4, the same 1-NN chars for the tree's
    paired crops."""
    rec = {}
    enc = init_params(create_encoder("mobilenetv3_small_050", in_channels=1,
                                     dtype=F32), 9)
    for pkg in ("jax", "torch"):
        d = str(tmp_path / pkg)
        os.makedirs(d)
        ckpt.save_variables(state_dict_to_flax(enc.state_dict()),
                            os.path.join(d, "enc_best.msgpack"))
        with open(os.path.join(d, "model.json"), "w") as f:
            json.dump({"arch": "mobilenetv3_small_050", "image_size": 32,
                       "input_channels": 1, "crop_geometry": "tight"}, f)
        rec[pkg] = d
    _skip_flax_init(monkeypatch, jnp.float32)
    monkeypatch.setattr(t_infer_cli, "create_encoder",
                        lambda a, in_channels, **kw: create_encoder(
                            a, in_channels=in_channels, dtype=F32, **kw))
    loc = _loc_dir(str(tmp_path))
    flags = ("--build_index_from", char_tree, "--render_font_name", "Other")
    j_infer_cli.load_engine(_engine_args(j_infer_cli.add_engine_args,
                                         rec["jax"], loc, *flags))
    t_engine = t_infer_cli.load_engine(_engine_args(
        t_infer_cli.add_engine_args, rec["torch"], loc, "--device", "cpu",
        *flags))
    with open(os.path.join(rec["jax"], "ref.txt")) as f, \
            open(os.path.join(rec["torch"], "ref.txt")) as g:
        assert f.read() == g.read() == "A\nX\no"
    ji, ti = JIndex.load(rec["jax"]), PrototypeIndex.load(rec["torch"])
    np.testing.assert_allclose(ti.embeddings, ji.embeddings, rtol=0,
                               atol=1e-4)
    assert t_engine.index.chars == ti.chars
    ds = CharFolderDataset(char_tree)
    paired = [i for i in range(len(ds)) if ds.is_paired(i)]
    imgs, _, _ = ds.load_batch(paired, 32)
    x = torch.from_numpy(imgs.mean(-1, keepdims=True).astype(np.uint8))
    from effocr_torch.kernels.image_ops import normalize_imagenet

    with torch.no_grad():
        q = enc.eval()(normalize_imagenet(x.float() / 255.0)).numpy()
    assert ti.decode(q) == ji.decode(q)


def test_training_clis_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    from effocr_torch.cli import build_index, train_recognizer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_recognizer.main([
            "--root_dir_path", "missing", "--train_ann_path", "a",
            "--val_ann_path", "b", "--test_ann_path", "c", "--run_name",
            str(tmp_path / "never")])
    assert not os.path.exists(tmp_path / "never")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index.main(["--run_dir", "missing"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_recognizer.main([
            "--device", "cpu", "--root_dir_path", "missing",
            "--train_ann_path", "a", "--val_ann_path", "b",
            "--test_ann_path", "c", "--run_name", str(tmp_path / "never"),
            "--adjacent_font_path", "font.ttf"])


# ------------------------------------------------ resume across packages
def _flat(tree):
    """{"a/b/0/mu/...": leaf} of a state tree: optax's own objects (tuple
    indices, namedtuple fields) named as flax.serialization names them."""
    def name(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(k)

    return {"/".join(map(name, path)): np.array(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_resumed_steps_agree(jold, jnew, jloss, tt, tloss, told):
    """One step from the same resumed state: loss 1e-5 relative, the
    optimizer's count equal, Adam's new moments 1e-4 of their largest
    |value|, the parameter update's cosine with JAX's >= 0.999 and its
    norm within 1% (a BatchNorm bias ahead of another train-mode
    BatchNorm has a gradient of rounding noise, which Adam turns into
    +-lr steps of either sign, so weights are not compared one by one)."""
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    got = _flat(ckpt.train_state(tt.model, tt.optimizer,
                                 **tt._state_layout()))
    want = _flat(_np(jnew))
    assert got.keys() == want.keys()
    for part in ("/mu/", "/nu/"):
        keys = [k for k in want if part in k]
        vmax = max(float(np.abs(want[k]).max()) for k in keys)
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-4 * vmax, err_msg=k)
    counts = {int(v) for k, v in want.items() if k.endswith("count")}
    assert counts == {tt.optimizer.count}
    keys = [k for k in want if k.startswith(("params/", "aux/"))]
    dj = np.concatenate([(want[k] - jold[k]).ravel() for k in keys])
    dt = np.concatenate([(got[k] - told[k]).ravel() for k in keys])
    assert np.abs(dj).max() > 1e-4
    assert dj @ dt / (np.linalg.norm(dj) * np.linalg.norm(dt)) >= 0.999
    assert abs(np.linalg.norm(dt) / np.linalg.norm(dj) - 1) <= 1e-2


def test_resume_crosses_packages(cut_mobilenet, tmp_path):
    """A run started by either package resumes in the other.  The JAX
    trainer's last.msgpack after two steps (cosine schedule, aux head at
    3x the rate: optax.multi_transform) loads into the port's trainer,
    which writes it back bit for bit for the JAX loader; the port's step
    from it is held to the JAX step from its own state
    (``_assert_resumed_steps_agree``); then the JAX trainer resumes the
    port's last.msgpack and steps, held to the port's step from its own
    state.  A file of this package's earlier layout (format
    effocr_torch.train_state.v1) still loads, to the same state."""
    rng = np.random.default_rng(5)
    b, size, n_cls = 8, 32, 4
    kw = dict(batch_size=b, lang="en", no_aug=True, aux_ce_weight=1.0,
              aux_lr_mult=3.0, lr=1e-3, lr_schedule="cosine",
              warmup_frac=0.25)
    enc = dict(arch="mobilenetv3_small_050", image_size=size,
               input_channels=1)
    jt = JTrainer(JTrainConfig(encoder=JEncoderConfig(**enc), **kw),
                  j_encoder("mobilenetv3_small_050", dtype=jnp.float32),
                  str(tmp_path / "jax"))
    variables, dim = _seeded_vars("mobilenetv3_small_050", 1, 3)
    jt.state = {"params": variables["params"],
                "batch_stats": variables["batch_stats"],
                "aux": {"w": jnp.asarray(rng.normal(
                    size=(n_cls, dim)).astype(np.float32))}}
    jt._build_optimizer(8)
    batches = []
    for _ in range(4):
        imgs = rng.integers(0, 256, (b, size, size, 3), np.uint8)
        imgs[:, :, :6] = 255
        batches.append((imgs, rng.integers(0, n_cls, b).astype(np.int32),
                        rng.uniform(size=b) < 0.4))
    key = jax.random.PRNGKey(0)
    for batch in batches[:2]:
        jt.state, _ = jt._step_fn(jt.state, *map(jnp.asarray, batch), key)
    jax_last = str(tmp_path / "jax" / "last.msgpack")
    j_ckpt.save_train_state(jt.state, jax_last)

    tt = RecognizerTrainer(
        _fit_cfg(RecognizerTrainConfig, EncoderConfig, **kw),
        create_encoder("mobilenetv3_small_050", in_channels=1, dtype=F32),
        str(tmp_path / "torch"), device="cpu")
    tt.init_state(123)                       # overwritten by the resume
    tt._init_aux(n_cls)
    tt._build_optimizer(8)
    tt._load_last(jax_last)
    assert tt.optimizer.count == 2
    port_last = str(tmp_path / "torch" / "last.msgpack")
    tt._save_last(0, 2, port_last, port_last + ".meta")
    back = _flat(_np(j_ckpt.load_train_state(jt.state, port_last)))
    orig = _flat(_np(jt.state))
    assert back.keys() == orig.keys()
    for k, v in orig.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k

    # a train state of this package's own earlier layout still loads
    v1_path = str(tmp_path / "v1" / "last.msgpack")
    os.makedirs(os.path.dirname(v1_path))
    write_variables({"format": ckpt.TRAIN_STATE_FORMAT_V1,
                     "model": {k: v.numpy() for k, v in
                               tt.model.state_dict().items()},
                     "aux": tt.aux.detach().numpy(),
                     "opt": tt.optimizer.state_dict()}, v1_path)
    t1 = RecognizerTrainer(
        _fit_cfg(RecognizerTrainConfig, EncoderConfig, **kw),
        create_encoder("mobilenetv3_small_050", in_channels=1, dtype=F32),
        str(tmp_path / "v1"), device="cpu")
    t1.init_state(7)
    t1._init_aux(n_cls)
    t1._build_optimizer(8)
    t1._load_last(v1_path)
    a, b = (_flat(ckpt.train_state(t.model, t.optimizer,
                                   **t._state_layout())) for t in (tt, t1))
    assert a.keys() == b.keys()
    for k, v in a.items():
        np.testing.assert_array_equal(b[k], v, err_msg=k)

    def t_batch(batch):
        imgs, targets, paired = batch
        return (torch.from_numpy(imgs), torch.from_numpy(targets).long(),
                torch.from_numpy(paired), None)

    # the port resumes JAX's file; JAX steps from its own state
    told = _flat(ckpt.train_state(tt.model, tt.optimizer,
                                  **tt._state_layout()))
    jold = _flat(jt.state)            # the step donates its state
    jnew, jloss = jt._step_fn(jt.state, *map(jnp.asarray, batches[2]), key)
    tloss = tt._step_fn(*t_batch(batches[2]))
    _assert_resumed_steps_agree(jold, jnew, jloss, tt, tloss, told)
    # JAX resumes the port's file; the port steps from its own state
    tt._save_last(1, 3, port_last, port_last + ".meta")
    jstate = j_ckpt.load_train_state(jt.state, port_last)
    told = _flat(ckpt.train_state(tt.model, tt.optimizer,
                                  **tt._state_layout()))
    jold = _flat(jstate)
    jnew, jloss = jt._step_fn(jstate, *map(jnp.asarray, batches[3]), key)
    tloss = tt._step_fn(*t_batch(batches[3]))
    _assert_resumed_steps_agree(jold, jnew, jloss, tt, tloss, told)
