"""The port's row-sparse word-table AdamW (``train/lazy_emb.py``, ``--opt_impl
lazy_emb``) against the JAX package's, on the CPU.

* ``unique_ids`` and ``row_update`` against JAX's on the same ids, table,
  moments and row gradients, fill slots included (JAX drops their scatters;
  the port writes slot 0's bytes again): float32 moments bit-equal,
  bfloat16 moments within one bfloat16 step of the moment's scale;
* the JAX ``tests/test_lazy_emb.py`` cases through the port's ``TrainStep``
  on the same toy model (a word table and a linear head), each also held
  against JAX's ``make_train_step_fn`` with its ``LazyEmbConfig``: every row
  touched is exact AdamW (rtol 2e-5 / atol 1e-6, as JAX holds it), untouched
  rows and their moments bit-unchanged, bfloat16 moments, the injected rows
  against the dense-gradient fallback (1e-6 / 1e-7); parameters against
  JAX's within 1e-6;
* the word table is found in exactly the families where JAX's
  ``find_word_embedding_path`` finds one (JAX trees from ``jax.eval_shape``);
* one step of the tiny late-fusion model with ITC + TIM (the swap injected,
  dropout 0), the TIM texts' rows injected as ``tim_word_embeds``: the row
  gradients against JAX's dense table gradient at those rows (1e-4 of the
  scale, as ``test_torch_train.py`` holds gradients), the parameters as
  that test holds one step, the untouched rows bit-unchanged;
* ``run_txt`` and ``run_mm_late`` (ITC + TIM) end to end under
  ``--opt_impl lazy_emb``: a run checkpointed after epoch 1 and resumed
  ends bit-identical to the straight run (the lazy moments and count are in
  the checkpoint), and the table's untouched rows never move.
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from socialmedia_textimage_classification_auxlosses_tpu.models import fusion as JF
from socialmedia_textimage_classification_auxlosses_tpu.models import lxmert as JLX
from socialmedia_textimage_classification_auxlosses_tpu.models import mmbt as JMB
from socialmedia_textimage_classification_auxlosses_tpu.models import text as JT
from socialmedia_textimage_classification_auxlosses_tpu.models import vilt as JV
from socialmedia_textimage_classification_auxlosses_tpu.models import vision as JVis
from socialmedia_textimage_classification_auxlosses_tpu.train import lazy_emb as JLE
from socialmedia_textimage_classification_auxlosses_tpu.train import optim as JO
from socialmedia_textimage_classification_auxlosses_tpu.train import steps as JS
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build as TBuild
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_late, run_txt
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import fusion as TF
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import lxmert as TLX
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import mmbt as TMB
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import text as TT
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import vilt as TV
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import vision as TVis
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.encoder import EncoderConfig
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    torch_state_from_jax)
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import lazy_emb as TLE
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import optim as TO
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import steps as TS

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_task_fixture  # noqa: E402
from test_torch_from_jax import TINY, carry, t, text_batch, torch_cfg  # noqa: E402
from test_torch_resnet import _random_variables  # noqa: E402

VOCAB, DIM, NL = 8, 4, 3
LR, WD = 1e-2, 2.5e-4
TABLE = "embeddings.word.weight"


def _n(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_unique_ids_and_row_update_match_jax(moments):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 20, (3, 7)).astype(np.int32)
    juids, jinv = JLE.unique_ids(jnp.asarray(ids))
    uids, inv = TLE.unique_ids(t(ids))
    np.testing.assert_array_equal(uids.numpy(), np.asarray(juids))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    assert (uids == TLE.OOB_ID).sum() > 0  # the fill slots are in the update
    emb = rng.randn(20, 5).astype(np.float32)
    g = rng.randn(uids.shape[0], 5).astype(np.float32)
    jcfg = JLE.LazyEmbConfig(path=("e",), lr=LR, weight_decay=0.1, moment_dtype=moments)
    tcfg = TLE.LazyEmbConfig(name="e", lr=LR, weight_decay=0.1, moment_dtype=moments)
    jemb, jstate = jnp.asarray(emb), JLE.init_lazy_state({"e": jnp.asarray(emb)}, jcfg)
    temb = t(emb).clone()
    tstate = TLE.init_lazy_state(temb, tcfg)
    for _ in range(3):  # the moments and the count carry over
        jemb, jstate = JLE.row_update(jemb, jstate, juids, jnp.asarray(g), jcfg)
        TLE.row_update(temb, tstate, uids, t(g), tcfg)
    assert int(tstate["count"]) == int(jstate["count"]) == 3
    assert tstate["mu"].dtype == getattr(torch, moments)
    tol = 0.0 if moments == "float32" else 2 ** -8
    for got, want in ((temb, jemb), (tstate["mu"], jstate["mu"]), (tstate["nu"], jstate["nu"])):
        want = _n(want)
        assert np.abs(got.float().numpy() - want).max() <= tol * max(1.0, np.abs(want).max())
    untouched = sorted(set(range(20)) - set(ids.reshape(-1).tolist()))
    np.testing.assert_array_equal(temb.numpy()[untouched], emb[untouched])


# -- the JAX test_lazy_emb.py cases on the same toy model ----------------------------


class Toy(nn.Module):
    """The JAX test's model: a word table, mean over the tokens, a linear head."""

    def __init__(self, emb, kernel):
        super().__init__()
        self.embeddings = nn.Module()
        self.embeddings.word = nn.Embedding(VOCAB, DIM)
        self.head = nn.Linear(DIM, NL, bias=False)
        with torch.no_grad():
            self.embeddings.word.weight.copy_(t(emb))
            self.head.weight.copy_(t(kernel.T))

    def forward(self, ids, word_embeds=None):
        emb = F.embedding(ids, self.embeddings.word.weight) if word_embeds is None else word_embeds
        return F.linear(emb.mean(1), self.head.weight)


def _jax_params(seed):
    rng = np.random.RandomState(seed)
    return {"params": {"embeddings": {"word": {"embedding": jnp.asarray(
        rng.randn(VOCAB, DIM), jnp.float32)}},
        "head": {"kernel": jnp.asarray(rng.randn(DIM, NL), jnp.float32)}}}


def _jax_forward(p, batch, tim_inputs, dropout_rng, deterministic):
    emb = p["params"]["embeddings"]["word"]["embedding"][batch["ids"]]
    return {"out_cls": emb.mean(axis=1) @ p["params"]["head"]["kernel"]}


def _jax_forward_inject(p, batch, tim_inputs, dropout_rng, deterministic, word_embeds=None,
                        tim_word_embeds=None):
    emb = (p["params"]["embeddings"]["word"]["embedding"][batch["ids"]]
           if word_embeds is None else word_embeds)
    return {"out_cls": emb.mean(axis=1) @ p["params"]["head"]["kernel"]}


def _batch(ids, rng):
    b = ids.shape[0]
    return {"ids": ids.astype(np.int32), "mask": np.ones_like(ids, np.int32),
            "labels": np.eye(NL, dtype=np.float32)[rng.randint(0, NL, b)],
            "valid": np.ones(b, np.float32)}


def _jax_run(ids, seed, batch_seed, lazy, inject=True, moments="float32", steps=4):
    params = _jax_params(seed)
    cfg = JLE.LazyEmbConfig(path=("params", "embeddings", "word", "embedding"), lr=LR,
                            weight_decay=WD, moment_dtype=moments)
    tx = JO.make_optimizer(LR, WD, JLE.lazy_emb_predicate(cfg) if lazy else None)
    state = tx.init(params)
    if lazy:
        state = {"tx": state, "lazy_emb": JLE.init_lazy_state(params, cfg)}
    step = jax.jit(JS.make_train_step_fn(_jax_forward_inject if inject else _jax_forward,
                                         JS.LossConfig(num_labels=NL), tx, jnp.ones(NL),
                                         lazy_emb_cfg=cfg if lazy else None))
    losses = []
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in _batch(ids, np.random.RandomState(batch_seed + i)).items()}
        params, state, m = step(params, state, batch, jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    p = params["params"]
    return {TABLE: _n(p["embeddings"]["word"]["embedding"]),
            "head.weight": _n(p["head"]["kernel"]).T}, losses, state


def _port_run(ids, seed, batch_seed, lazy, inject=True, moments="float32", steps=4):
    jp = _jax_params(seed)["params"]
    model = Toy(_n(jp["embeddings"]["word"]["embedding"]), _n(jp["head"]["kernel"]))
    args = types.SimpleNamespace(opt_impl="lazy_emb" if lazy else "exact", opt_moments="f32")
    opt, lazy_emb = TBuild.build_optimizer(model, args, types.SimpleNamespace(
        lr=LR, weight_decay=WD))
    if lazy:
        lazy_emb = TLE.LazyEmb(lazy_emb.param, TLE.LazyEmbConfig(
            name=TABLE, lr=LR, weight_decay=WD, moment_dtype=moments))

    if inject:
        def fwd(bt, tim, gen, det, word_embeds=None, tim_word_embeds=None):
            return {"out_cls": model(bt["ids"].long(), word_embeds)}
    else:
        def fwd(bt, tim, gen, det):
            return {"out_cls": model(bt["ids"].long())}

    step = TS.TrainStep(model, fwd, TS.LossConfig(num_labels=NL), opt, torch.ones(NL),
                        lazy=lazy_emb)
    assert step.inject == (lazy and inject)
    losses = []
    for i in range(steps):
        batch = {k: t(v) for k, v in _batch(ids, np.random.RandomState(batch_seed + i)).items()}
        losses.append(float(step(batch, torch.Generator().manual_seed(i))["loss"]))
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}, losses, lazy_emb


def _assert_params(got, want, rtol=0.0, atol=1e-6):
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("inject", [False, True], ids=["dense_grad", "injected"])
def test_lazy_equals_exact_when_all_rows_touched(inject):
    """Every table row in every batch: lazy AdamW is AdamW (the JAX cases
    ``test_lazy_equals_exact_when_all_rows_touched`` and
    ``test_injected_rows_match_exact_adamw``)."""
    ids = np.tile(np.arange(VOCAB), (2, 2))
    exact, exact_losses, _ = _port_run(ids, 0, 100, lazy=False, inject=inject)
    lazy, losses, _ = _port_run(ids, 0, 100, lazy=True, inject=inject)
    np.testing.assert_allclose(losses, exact_losses, rtol=1e-6)
    _assert_params(lazy, exact, rtol=2e-5, atol=1e-6)
    want, jlosses, _ = _jax_run(ids, 0, 100, lazy=True, inject=inject)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)
    _assert_params(lazy, want)


def test_untouched_rows_stay_put():
    ids = np.array([[1, 2, 2, 1], [3, 1, 3, 1]])  # rows 1, 2, 3 only
    before = _n(_jax_params(1)["params"]["embeddings"]["word"]["embedding"])
    after, _, lazy = _port_run(ids, 1, 7, lazy=True, steps=1)
    untouched = [i for i in range(VOCAB) if i not in (1, 2, 3)]
    np.testing.assert_array_equal(after[TABLE][untouched], before[untouched])
    assert all(not np.allclose(before[r], after[TABLE][r]) for r in (1, 2, 3))
    mu = lazy.state["mu"].numpy()
    np.testing.assert_array_equal(mu[untouched], np.zeros_like(mu[untouched]))
    assert int(lazy.state["count"]) == 1
    want, _, jstate = _jax_run(ids, 1, 7, lazy=True, steps=1)
    _assert_params(after, want)
    np.testing.assert_allclose(mu, _n(jstate["lazy_emb"]["mu"]), rtol=0, atol=1e-7)


def test_bf16_moments_mode_runs():
    ids = np.array([[0, 1], [2, 3]])
    got, losses, lazy = _port_run(ids, 2, 8, lazy=True, moments="bfloat16", steps=2)
    assert np.isfinite(losses).all()
    assert lazy.state["mu"].dtype == torch.bfloat16
    want, jlosses, jstate = _jax_run(ids, 2, 8, lazy=True, moments="bfloat16", steps=2)
    assert jstate["lazy_emb"]["mu"].dtype == jnp.bfloat16
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)
    _assert_params(got, want)


def test_injected_matches_dense_grad_mode():
    ids = np.array([[1, 5, 5, 2], [7, 1, 3, 1]])  # partial coverage
    injected, li, _ = _port_run(ids, 3, 300, lazy=True, inject=True, steps=3)
    dense, ld, _ = _port_run(ids, 3, 300, lazy=True, inject=False, steps=3)
    np.testing.assert_allclose(li, ld, rtol=1e-6)
    _assert_params(injected, dense, rtol=1e-6, atol=1e-7)
    want, _, _ = _jax_run(ids, 3, 300, lazy=True, inject=False, steps=3)
    _assert_params(injected, want)


def test_find_word_embedding_path():
    names = ["dual.text.embeddings.word.weight", "dual.text.embeddings.position.weight",
             "dual.text.keyword.weight"]
    assert TLE.find_word_embedding_path(names) == "dual.text.embeddings.word.weight"
    assert TLE.find_word_embedding_path(names + ["other.word.weight"]) is None  # ambiguous
    assert TLE.find_word_embedding_path(names[1:]) is None


# -- which families have a word table: the port finds one where JAX does -------------


def _text_cfgs(**kw):
    jcfg = JT.text_encoder_config("bert", None, dtype="float32", vocab_size=97, **TINY, **kw)
    return jcfg, torch_cfg(jcfg)


def _family(name):
    """(JAX module, its init arguments, the port's module)."""
    ids = jnp.zeros((2, 8), jnp.int32)
    px = jnp.zeros((2, 32, 32, 3), jnp.float32)
    jtext, ttext = _text_cfgs()
    if name == "txt":
        return JT.TextClassifier(jtext, NL), (ids, ids, ids), TT.TextClassifier(ttext, NL)
    if name in ("mm_late", "mm_late_cnn"):
        if name == "mm_late_cnn":
            return (JF.MMCnnModel(jtext, "resnet50", NL), (ids, ids, px, ids),
                    TF.MMCnnModel(ttext, "resnet50", NL))
        jvis = JVis.vision_encoder_config("vit", None, dtype="float32", **TINY)
        kw = dict(fusion_name="attention", patch=16, image_size=32)
        return (JF.MMLateModel(jtext, jvis, NL, **kw), (ids, ids, px),
                TF.MMLateModel(ttext, torch_cfg(jvis), NL, **kw))
    if name == "img":
        return (JVis.build_vision_classifier("vit", NL, **TINY), (jnp.zeros((2, 224, 224, 3)),),
                TVis.build_vision_classifier("vit", NL, **TINY))
    enc = dict(vocab_size=97, hidden=32, layers=1, heads=2, mlp_dim=64, max_positions=40,
               type_vocab=2, dropout=0.0, dtype="float32")
    if name == "vilt":
        jcfg = JV.EncoderConfig(ln_style="pre", **enc)
        return (JV.ViltClassifier(jcfg, NL, patch=32, image_size=64),
                (ids, ids, ids, jnp.zeros((2, 64, 64, 3))),
                TV.ViltClassifier(EncoderConfig(ln_style="pre", **enc), NL, patch=32,
                                  image_size=64))
    if name == "mmbt":
        jcfg = JMB.EncoderConfig(ln_style="post", **enc)
        return (JMB.MmbtClassifier(jcfg, NL, cnn_name="resnet50"), (ids, ids, px),
                TMB.MmbtClassifier(EncoderConfig(ln_style="post", **enc), NL,
                                   cnn_name="resnet50"))
    lx = dict(vocab_size=97, hidden=32, heads=2, mlp_dim=64, max_positions=8, l_layers=1,
              r_layers=1, x_layers=1, visual_feat_dim=24, dropout=0.0)
    return (JLX.LxmertClassifier(JLX.LxmertConfig(**lx), NL),
            (ids, ids, ids, jnp.zeros((2, 5, 24)), jnp.zeros((2, 5, 4))),
            TLX.LxmertClassifier(TLX.LxmertConfig(**lx), NL))


@pytest.mark.parametrize("family", ["txt", "mm_late", "mm_late_cnn", "vilt", "mmbt",
                                    "lxmert", "img"])
def test_word_table_found_where_jax_finds_it(family):
    with torch.device("meta"):
        jm, args, tm = _family(family)
    shapes = jax.eval_shape(lambda k: jm.init(k, *args), jax.random.PRNGKey(0))
    jpath = JLE.find_word_embedding_path(shapes)
    name = TLE.find_word_embedding_path(n for n, _ in tm.named_parameters())
    assert (jpath is None) == (name is None) == (family == "img")
    if name is not None:  # the same leaf: flax "a/b/word/embedding" is torch "a.b.word.weight"
        assert jpath[0] == "params" and jpath[-1] == "embedding"
        assert name == ".".join(jpath[1:-1]) + ".weight"
        leaf = shapes
        for key in jpath:
            leaf = leaf[key]
        assert tuple(dict(tm.named_parameters())[name].shape) == tuple(leaf.shape)


# -- one late-fusion step with ITC + TIM, the TIM rows injected ----------------------


def test_mm_late_lazy_step_matches_jax():
    jvis = JVis.vision_encoder_config("vit", None, dtype="float32", dropout=0.0,
                                      attn_impl="jnp", **TINY)
    jtext = JT.text_encoder_config("bernice", None, dtype="float32", dropout=0.0,
                                   attn_impl="jnp", vocab_size=1000, **TINY)
    kw = dict(fusion_name="attention", patch=16, image_size=32, dropout=0.0)
    jm = JF.MMLateModel(jtext, jvis, NL, **kw)
    tm = TF.MMLateModel(torch_cfg(jtext), torch_cfg(jvis), NL, **kw)
    rng = np.random.RandomState(5)
    b = 4
    ids, mask = text_batch(rng, b=b, vocab=1000, pad_id=1)
    px = rng.randn(b, 32, 32, 3).astype(np.float32)
    a = [jnp.asarray(x) for x in (ids, mask, px)]
    params = _random_variables(jm, *a, tim_ids=a[0], tim_mask=a[1], iadds_task=True, seed=1)
    carry(params, tm)
    batch = {"ids": ids, "mask": mask, "pixel_values": px,
             "labels": np.eye(NL, dtype=np.float32)[[0, 2, 1, 1]],
             "valid": np.array([1, 1, 1, 0], np.float32),
             "tim_src": np.array([2, 1, 0, 3], np.int32),
             "tim_labels": np.array([0, 1, 0, 1], np.int32)}
    cw = np.array([1.0, 0.5, 2.0], np.float32)
    loss_kw = dict(num_labels=NL, use_clip_loss=True, use_tim_loss=True, beta_itc=0.1,
                   beta_itm=0.1)
    lr, wd = 1e-3, 0.01
    path = ("params", "dual", "text", "embeddings", "word", "embedding")
    assert JLE.find_word_embedding_path(params) == path

    def jfwd(p, bt, tim, rng_, det, word_embeds=None, tim_word_embeds=None):
        kw = ({"tim_src": tim["src"]} if det else
              {"tim_ids": tim["ids"], "tim_mask": tim["mask"],
               "tim_word_embeds": tim_word_embeds})
        return jm.apply(p, bt["ids"], bt["mask"], bt["pixel_values"], deterministic=det,
                        word_embeds=word_embeds, **kw)

    jcfg = JS.LossConfig(**loss_kw)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tim, tim_labels = JS._maybe_tim(jcfg, None, jbatch)
    lcfg = JLE.LazyEmbConfig(path=path, lr=lr, weight_decay=wd)
    tx = JO.make_optimizer(lr, wd, JO.any_of(JO.vision_frozen_predicate,
                                             JLE.lazy_emb_predicate(lcfg)), fused=True)
    step = JS.make_train_step_fn(jfwd, jcfg, tx, class_weights=jnp.asarray(cw),
                                 lazy_emb_cfg=lcfg)
    state = {"tx": tx.init(params), "lazy_emb": JLE.init_lazy_state(params, lcfg)}

    @jax.jit
    def grads_and_step(p, st, bt):  # one compile
        g = jax.grad(lambda q: JS.assemble_loss(jcfg, jfwd(q, bt, tim, None, False), bt,
                                                tim_labels, jnp.asarray(cw))[0])(p)
        return g, step(p, st, bt, jax.random.PRNGKey(0))

    jgrads, (jnew, _, jmetrics) = grads_and_step(params, state, jbatch)

    for n, p in tm.named_parameters():
        p.requires_grad_(not TO.vision_frozen(n))
    args = types.SimpleNamespace(opt_impl="lazy_emb", opt_moments="f32")
    opt, lazy = TBuild.build_optimizer(tm, args, types.SimpleNamespace(lr=lr, weight_decay=wd),
                                       TO.vision_frozen)
    name = "dual.text.embeddings.word.weight"
    assert lazy.name == name and name not in opt.names

    def tfwd(bt, tim_, gen, det, word_embeds=None, tim_word_embeds=None):
        kw = ({"tim_src": tim_["src"]} if det else
              {"tim_ids": tim_["ids"], "tim_mask": tim_["mask"],
               "tim_word_embeds": tim_word_embeds})
        return tm(bt["ids"].long(), bt["mask"], bt["pixel_values"], gen=gen,
                  word_embeds=word_embeds, **kw)

    tstep = TS.TrainStep(tm, tfwd, TS.LossConfig(**loss_kw), opt, t(cw), keep_grads=True,
                         lazy=lazy)
    assert tstep.inject
    before = tm.dual.text.embeddings.word.weight.detach().clone()
    metrics = tstep({k: t(v) for k, v in batch.items()}, torch.Generator().manual_seed(0))
    for key in ("loss", "cls_loss", "itc_loss", "itm_loss"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-5,
                                   err_msg=key)
    jg = torch_state_from_jax(jax.tree_util.tree_map(_n, jgrads))
    jp = torch_state_from_jax(jax.tree_util.tree_map(_n, jnew))
    uids, g_rows = tstep.last_grads[name]
    real = uids < 1000
    rows = uids[real].numpy()
    assert sorted(rows.tolist()) == sorted(set(ids.reshape(-1).tolist()))
    grads = {n: np.zeros_like(jg[n]) if g is None else g.numpy()
             for n, g in tstep.last_grads.items() if n != name}
    grads[name] = np.zeros_like(jg[name])
    grads[name][rows] = g_rows[real].numpy()
    gmax = max(np.abs(g).max() for n, g in jg.items() if not TO.vision_frozen(n))
    new = {n: p.detach().numpy() for n, p in tm.named_parameters()}
    for n, g in grads.items():
        want = jg[n]
        assert np.abs(g - want).max() <= 1e-4 * max(1e-3, np.abs(want).max()), n
        firm = np.abs(want) > 1e-4 * gmax
        np.testing.assert_allclose(new[n][firm], jp[n][firm], rtol=0, atol=1e-6, err_msg=n)
        assert np.abs(new[n] - jp[n]).max() <= 2 * lr + 1e-6, n
    untouched = np.setdiff1d(np.arange(1000), rows)
    np.testing.assert_array_equal(new[name][untouched], before.numpy()[untouched])


# -- the runners end to end, with a checkpoint and --resume ---------------------------


LATE = ["--txt_model_name", "bernice", "--img_model_name", "vit", "--fusion_name",
        "attention", "--use_clip_loss", "--use_tim_loss"]
COMMON = ["--task", "3", "--arch", "tiny", "--dtype", "float32", "--log_every", "100",
          "--device", "cpu", "--opt_impl", "lazy_emb"]
TXT_STEM, LATE_STEM = "bernice_task3_seed30_ckpt", "bernice-vit-attention_task3_seed30_itc0.1itm0.1_ckpt"


def _train(main, argv):
    losses = []
    trainer, setup = main(argv, on_step=lambda step, m: losses.append(float(m["loss"])))
    lazy = setup.train_step.lazy
    return {"losses": losses, "trainer": trainer, "lazy": lazy,
            "params": {k: v.clone() for k, v in setup.model.state_dict().items()},
            "lazy_state": lazy.state_dict()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lazy_e2e")
    csv_path, img_fmt, _ = make_task_fixture(root / "data", task=3, n=40)
    mp = pytest.MonkeyPatch()
    mp.setitem(C.PATH, 3, csv_path)
    mp.setitem(C.IMG_FMT, 3, img_fmt)
    mp.setattr(C, "DATA_PATH", str(root / "data") + os.sep)
    for attr in ("results_dir_txt", "results_dir_mm_late"):
        mp.setattr(C, attr, str(root / attr) + os.sep)
    for name in ("bernice", "vit"):
        d = root / "hub" / name
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(
            {"hidden_dropout_prob": 0.1, "vocab_size": 1000, "image_size": 32,
             "patch_size": 16}))
        mp.setitem(C.MODEL_DIR_DICT, name, str(d) + os.sep)
    out = {}
    real = TBuild.build_optimizer

    def build_optimizer(model, *a, **kw):  # the table as the run starts
        opt, lazy = real(model, *a, **kw)
        out.setdefault("initial", lazy.param.detach().clone())
        return opt, lazy

    mp.setattr(TBuild, "build_optimizer", build_optimizer)
    try:
        for family, main, head in (("txt", run_txt.main, ["--model_name", "bernice"]),
                                   ("late", run_mm_late.main, LATE)):
            argv = head + COMMON
            out.pop("initial", None)
            out[family] = _train(main, argv + ["--epochs", "2"])
            out[family]["initial"] = out["initial"]
            _train(main, argv + ["--epochs", "1", "--ckpt_every", "2"])
            out[family + "_resumed"] = _train(main, argv + ["--epochs", "2", "--ckpt_every",
                                                            "2", "--resume"])
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("family", ["txt", "late"])
def test_lazy_run_resumes_bit_identically(runs, family):
    straight, resumed = runs[family], runs[family + "_resumed"]
    table = straight["lazy"].name
    assert table == ("tower." if family == "txt" else "dual.text.") + "embeddings.word.weight"
    assert len(straight["losses"]) == 4 and resumed["losses"] == straight["losses"][2:]
    assert [k for k in straight["params"] if not torch.equal(
        straight["params"][k], resumed["params"][k])] == []
    for key, v in straight["lazy_state"].items():
        assert torch.equal(v, resumed["lazy_state"][key]), key
    assert int(resumed["lazy_state"]["count"]) == 4
    assert int(resumed["trainer"].train_step.optimizer.count) == 4
    # rows no batch touched keep zero moments and never move (a hashed
    # vocabulary of 1,000)
    untouched = straight["lazy_state"]["nu"].abs().sum(1) == 0
    assert 0 < int(untouched.sum()) < untouched.shape[0]
    assert torch.equal(straight["params"][table][untouched], straight["initial"][untouched])
    assert not torch.equal(straight["params"][table], straight["initial"])
