"""Sequence-length bucketing (``--bucket_seq``) and bucket-grouped chunks
(``--bucket_group``) in the PyTorch port, against the JAX package on the CPU.

The cases of the JAX ``tests/test_bucketing.py`` and
``tests/test_bucket_group.py``, each run through the port's
``data/pipeline.py`` beside the JAX pipeline on the same posts (made from a
numpy seed, tokenised by each package's hashing tokenizer):

* the batches sliced to their bucket, unshuffled and shuffled: every array
  equal to JAX's, and a prefix of the full-pad batch with no real token cut;
* chunks sliced to the bucket of the chunk's longest row, and under
  ``--bucket_group`` pure in width, batch for batch JAX's chunks (JAX pads a
  short chunk with ``step_valid`` 0, the port runs ``k_real`` steps): the
  same visit order, composition, tail batch last over 30 shuffle seeds, the
  same step count; sequential order when not shuffled; the shuffle drawn
  once per epoch, and ``skip`` (a resumed epoch) counting batches of the
  grouped order;
* per-example logits of the text classifier (BERT, and RoBERTa's
  pad-offset positions) bucketed against the port's full pad within 1e-6
  and against JAX's bucketed within 1e-5 (float32, tiny); ViLT, MMBT and
  LXMERT the same way, their outputs within 1e-5 of their scale;
* ``run_txt`` with and without ``--bucket_seq``: the predictions equal, the
  metrics within 5e-3 (the JAX test's CPU allowance); grouped K = 3
  training equal to the step-by-step steps over the same grouped batches;
  a grouped run stopped after its first chunk and resumed ends bit for bit
  where the straight run ends;
* the ``--cache_vision`` chunker (``VisionCachedPipe``) over the inner
  pipe's grouped chunks, and ``--opt_impl lazy_emb``'s row update of a
  bucketed batch equal to the full-pad batch's (the same unique ids, fewer
  fill slots).
"""

import csv
import os
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.data import pipeline as JP
from socialmedia_textimage_classification_auxlosses_tpu.data.prep import SplitArrays as JSplit
from socialmedia_textimage_classification_auxlosses_tpu.data.tokenizers import (
    build_tokenizer as jax_tokenizer,
)
from socialmedia_textimage_classification_auxlosses_tpu.models import text as JT
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build as TBuild
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _common as TCommon
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_txt
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import pipeline as TP
from socialmedia_textimage_classification_auxlosses_tpu_torch.data.prep import (
    SplitArrays as TSplit,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.data.tokenizers import (
    build_tokenizer as port_tokenizer,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import text as TT
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import optim as TO
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import steps as TS
from socialmedia_textimage_classification_auxlosses_tpu_torch.train.lazy_emb import (
    OOB_ID, LazyEmb, LazyEmbConfig,
)

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_task_fixture  # noqa: E402
from test_torch_from_jax import carry  # noqa: E402
from test_torch_resnet import _random_variables  # noqa: E402

LABELS, VOCAB = 3, 512
SMALL = dict(vocab_size=VOCAB, hidden=32, layers=2, heads=2, mlp_dim=64)


def _texts(n, mix):
    """``ladder``: 1-10 words (JAX ``test_bucketing``); ``bimodal``: mostly
    2-5 words, every eighth post 20-24 (JAX ``test_bucket_group``)."""
    if mix == "ladder":
        words = [1 + (i % 10) for i in range(n)]
    else:
        words = [2 + (i % 4) if i % 8 else 20 + (i % 5) for i in range(n)]
    return [" ".join(f"w{i}x{j}" for j in range(w)) for i, w in enumerate(words)]


def _pipes(seq_buckets=(8, 16), n=20, mix="ladder", group=False, model="bert",
           max_length=32, bs=4):
    """(JAX pipe, port pipe) over the same posts and labels."""
    texts = np.asarray(_texts(n, mix), object)
    labels = np.eye(LABELS, dtype=np.float32)[np.random.RandomState(0).randint(0, LABELS, n)]
    ids = np.asarray([str(i + 1) for i in range(n)])
    ids_num = np.arange(1, n + 1).astype(np.int64)
    jcfg = JP.PipelineConfig(batch_size=bs, max_length=max_length, with_images=False,
                             seq_buckets=seq_buckets, bucket_group=group)
    tcfg = TP.PipelineConfig(batch_size=bs, max_length=max_length, with_images=False,
                             seq_buckets=seq_buckets, bucket_group=group)
    return (JP.SplitPipeline(JSplit(ids, ids_num, texts, labels), jcfg,
                             tokenizer=jax_tokenizer(model, None, max_length, VOCAB)),
            TP.SplitPipeline(TSplit(ids, ids_num, texts, labels), tcfg,
                             tokenizer=port_tokenizer(model, None, max_length, VOCAB)))


def _same_batch(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(v), err_msg=key)


def test_batches_sliced_to_bucket_as_jax():
    jpipe, tpipe = _pipes()
    _, full = _pipes(None)
    widths = set()
    for jb, tb, fb in zip(jpipe.batches(), tpipe.batches(), full.batches(), strict=True):
        _same_batch(tb, jb)
        w = tb["ids"].shape[1]
        widths.add(w)
        np.testing.assert_array_equal(tb["ids"], fb["ids"][:, :w])
        np.testing.assert_array_equal(tb["mask"], fb["mask"][:, :w])
        assert int(fb["mask"][:, w:].sum()) == 0  # nothing real was cut
    assert widths == {8, 16}


def test_shuffled_order_identical_to_jax():
    jpipe, tpipe = _pipes()
    _, full = _pipes(None)
    rngs = [np.random.RandomState(7) for _ in range(3)]
    for jb, tb, fb in zip(jpipe.batches(shuffle=True, rng=rngs[0]),
                          tpipe.batches(shuffle=True, rng=rngs[1]),
                          full.batches(shuffle=True, rng=rngs[2]), strict=True):
        _same_batch(tb, jb)
        np.testing.assert_array_equal(tb["data_id"], fb["data_id"])
        np.testing.assert_array_equal(tb["ids"], fb["ids"][:, :tb["ids"].shape[1]])


def _chunks(pipe, k, shuffle=True, seed=7, jax_side=False):
    """[(width, [data ids of each real batch's valid rows], k_real)] of an
    epoch's chunks; JAX's padded steps left out."""
    rng = np.random.RandomState(seed)
    it = (pipe.device_iter_chunks(k, shuffle=shuffle, rng=rng) if jax_side
          else pipe.device_iter_chunks("cpu", k, shuffle=shuffle, rng=rng))
    out = []
    for batches, k_real in it:
        assert "_max_len" not in batches
        mask = np.asarray(batches["mask"])
        ids, valid = np.asarray(batches["data_id"]), np.asarray(batches["valid"])
        if jax_side:
            sv = np.asarray(batches["step_valid"])
            assert sv[:k_real].all() and not sv[k_real:].any()
        else:
            assert len(ids) == k_real
        rows = [ids[i][valid[i] > 0].tolist() for i in range(k_real)]
        assert mask[:k_real].sum(-1).max() <= mask.shape[-1]
        out.append((mask.shape[-1], rows, k_real))
    return out


@pytest.mark.parametrize("group", [False, True], ids=["chunk_max", "grouped"])
def test_chunks_as_jax_chunks(group):
    """Ungrouped: each chunk sliced to the bucket of its longest row (the
    JAX ``test_chunked_stacking_uses_chunk_max``). Grouped: the JAX grouped
    chunks batch for batch, each chunk pure in width and sliced to its
    batches' own bucket (``test_grouped_chunks_are_pure_width_and_sliced``)."""
    jpipe, tpipe = _pipes(n=40, mix="bimodal", group=group)
    got, want = _chunks(tpipe, 3), _chunks(jpipe, 3, jax_side=True)
    assert got == want
    if group:
        assert len({w for w, _, _ in got}) >= 2
        lens = tpipe.mask.sum(-1)
        for w, rows, _ in got:  # every batch of the chunk is of the chunk's width
            assert {tpipe.bucket_width(int(lens[np.asarray(r) - 1].max())) for r in rows} == {w}


def test_grouped_epoch_composition_unchanged():
    jpipe, plain = _pipes(n=40, mix="bimodal")
    _, grouped = _pipes(n=40, mix="bimodal", group=True)
    pb = [frozenset(r) for _, rows, _ in _chunks(plain, 3) for r in rows]
    gb = [frozenset(r) for _, rows, _ in _chunks(grouped, 3) for r in rows]
    assert sorted(map(sorted, pb)) == sorted(map(sorted, gb))
    seen = [i for s in gb for i in s]
    assert sorted(seen) == list(range(1, 41))  # each post once an epoch


def test_grouped_tail_batch_composition_matches_jax():
    """n % batch_size != 0: the partial tail batch stays last, every batch
    keeps its rows, and the grouped epoch is JAX's for 30 shuffle seeds."""
    jpipe, tpipe = _pipes(n=10, mix="bimodal", group=True)
    _, plain = _pipes(n=10, mix="bimodal")
    for seed in range(30):
        got = _chunks(tpipe, 3, seed=seed)
        assert got == _chunks(jpipe, 3, seed=seed, jax_side=True), seed
        gb = [sorted(r) for _, rows, _ in got for r in rows]
        pb = [sorted(r) for _, rows, _ in _chunks(plain, 3, seed=seed) for r in rows]
        assert sorted(gb) == sorted(pb), seed
        assert len(gb[-1]) == 10 % 4


@pytest.mark.parametrize("group", [False, True], ids=["plain", "grouped"])
def test_step_counts_match_jax(group):
    jpipe, tpipe = _pipes(n=40, mix="bimodal", group=group)
    got = sum(k for _, _, k in _chunks(tpipe, 4))
    want = sum(k for _, _, k in _chunks(jpipe, 4, jax_side=True))
    assert got == want == 10


def test_group_only_when_shuffled():
    """Evaluation keeps sequential order: the rows of ``preds.csv`` keep
    their order under ``--bucket_group``."""
    _, tpipe = _pipes(n=40, mix="bimodal", group=True)
    seq = [i for _, rows, _ in _chunks(tpipe, 3, shuffle=False) for r in rows for i in r]
    assert seq == list(range(1, 41))
    assert not tpipe.grouping(False) and tpipe.grouping(True)


def test_grouped_order_draws_once_and_skip_counts_grouped_batches():
    """The grouped order consumes the shuffle stream as the plain epoch
    does (JAX ``batches(order=...)``), and ``skip`` leaves out batches of
    the grouped order: the chunks after a chunk boundary are the straight
    run's chunks from there."""
    _, tpipe = _pipes(n=40, mix="bimodal", group=True)
    _, plain = _pipes(n=40, mix="bimodal")
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    list(tpipe.device_iter_chunks("cpu", 3, shuffle=True, rng=a))
    list(plain.batches(shuffle=True, rng=b))
    assert a.randint(1 << 30) == b.randint(1 << 30)
    straight = _chunks(tpipe, 3, seed=5)
    done = 0
    for i, (_, _, k_real) in enumerate(straight[:-1]):
        done += k_real
        rng = np.random.RandomState(5)
        resumed = []
        for batches, k in tpipe.device_iter_chunks("cpu", 3, shuffle=True, rng=rng, skip=done):
            valid, ids = batches["valid"].numpy(), batches["data_id"]
            resumed.append((batches["mask"].shape[-1],
                            [ids[j][valid[j] > 0].tolist() for j in range(k)], k))
        assert resumed == straight[i + 1:], done


def test_bucket_flags_parse_as_jax():
    parser = TCommon.add_common_args(__import__("argparse").ArgumentParser())
    assert TCommon.seq_buckets_from(parser.parse_args(["--bucket_seq"])) == (32, 64, 96)
    assert TCommon.seq_buckets_from(parser.parse_args(["--bucket_seq", "64,16,16"])) == (16, 64)
    assert TCommon.seq_buckets_from(parser.parse_args([])) is None
    for argv, message in ((["--bucket_group"], "requires --bucket_seq"),
                          (["--bucket_seq", "a,b"], "comma-separated ints"),
                          (["--bucket_seq", "1"], ">= 2")):
        with pytest.raises(SystemExit, match=message):
            TCommon.seq_buckets_from(parser.parse_args(argv))
    TCommon.check_training_supported(parser.parse_args(["--bucket_seq", "--bucket_group"]))


# -- the models at the sliced width ----------------------------------------------


@pytest.fixture(scope="module", params=["bert", "roberta"])
def text_models(request):
    """(name, JAX classifier, its variables, the port's classifier)."""
    name = request.param
    layers = 2 if name == "bert" else 1
    jm = JT.build_text_classifier(name, LABELS, None, dropout=0.0, dtype="float32",
                                  attn_impl="jnp", **dict(SMALL, layers=layers))
    ids = jnp.zeros((2, 8), jnp.int32)
    tt = None if name == "roberta" else ids
    variables = _random_variables(jm, ids, ids, tt, deterministic=True, seed=2)
    tm = TT.build_text_classifier(name, LABELS, None, dropout=0.0, dtype="float32",
                                  attn_impl="auto", **dict(SMALL, layers=layers))
    return name, jm, variables, carry(variables, tm)


def test_per_example_logits_bucketed(text_models):
    """The port's bucketed logits equal its full-pad logits within 1e-6 and
    JAX's bucketed logits within 1e-5, batch by batch (for RoBERTa its
    pad-offset position ids, the JAX ``test_roberta_pos_offset_exactly_equal``)."""
    name, jm, variables, tm = text_models
    use_tt = name != "roberta"
    jlogits = jax.jit(lambda p, ids, mask, tt: jm.apply(p, ids, mask, tt, deterministic=True))
    jpipe, tpipe = _pipes(model=name)
    _, full = _pipes(None, model=name)

    def port(b):
        tt = torch.from_numpy(b["token_type_ids"]).long() if use_tt else None
        with torch.no_grad():
            return tm(torch.from_numpy(b["ids"]).long(), torch.from_numpy(b["mask"]), tt).numpy()

    compared = set()
    for jb, tb, fb in zip(jpipe.batches(), tpipe.batches(), full.batches(), strict=True):
        got = port(tb)
        np.testing.assert_allclose(got, port(fb), rtol=0, atol=1e-6)
        want = np.asarray(jlogits(variables, jb["ids"], jb["mask"],
                                  jb["token_type_ids"] if use_tt else None))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        compared.add(tb["ids"].shape[1])
    assert compared == {8, 16}


def _early_batch(length, lens, vocab, rng, sep=None):
    ids = rng.randint(4, vocab, (len(lens), length)).astype(np.int32)
    mask = np.ones_like(ids)
    for i, n in enumerate(lens):
        if sep is not None:
            ids[i, n - 1] = sep
        ids[i, n:] = 0
        mask[i, n:] = 0
    ids[:, 0] = 2
    return ids, mask


def _early_case(model):
    """(JAX module, port module, JAX variables, full-pad inputs, JAX apply,
    port apply, text width, bucket width) at the JAX early tests' sizes."""
    rng = np.random.RandomState(11)
    if model == "vilt":
        from test_torch_vilt import _batch, _jax_forward, _pair, _port_forward

        jm, tm = _pair(exact=False)
        batch = _batch(rng, exact=False)  # 40 text positions, rows of 40 / 17 / 5 tokens
        batch["ids"][0, 30:] = 0
        batch["mask"][0, 30:] = 0
        width, bucket = 40, 32
    elif model == "mmbt":
        from test_torch_mmbt import _jax_forward, _pair, _port_forward

        jm, tm = _pair()
        ids, mask = _early_batch(12, (7, 5, 4), 1000, rng, sep=3)
        batch = {"ids": ids, "mask": mask,
                 "pixel_values": rng.randn(3, 32, 32, 3).astype(np.float32)}
        width, bucket = 12, 8
    else:
        from test_torch_lxmert import _jax_forward, _pair, _port_forward

        jm, tm = _pair()
        ids, mask = _early_batch(12, (7, 5, 4), 97, rng)
        batch = {"ids": ids, "mask": mask, "token_type_ids": np.zeros_like(ids),
                 "roi_features": rng.rand(3, 5, 24).astype(np.float32) * 2,
                 "roi_boxes": np.sort(rng.rand(3, 5, 4).astype(np.float32), -1)}
        width, bucket = 12, 8
    return jm, tm, batch, _jax_forward, _port_forward, width, bucket


@pytest.mark.parametrize("model", ["vilt", "mmbt", "lxmert"])
def test_early_fusion_forward_under_bucketing(model, monkeypatch):
    """The batch sliced to its bucket (ViLT: 40 text positions to 32, its
    joint sequence 32 + image tokens; MMBT: the sentence after the image
    span; LXMERT: the language side) through the port: its outputs equal
    the port's full-pad outputs and JAX's at the sliced width, within 1e-5
    of their scale."""
    from test_torch_mmbt import CNN, JR, TR

    for stages in (JR.STAGE_SIZES, TR.STAGE_SIZES):  # the MMBT tests' two-stage trunk
        monkeypatch.setitem(stages, CNN, (1, 1))
    jm, tm, batch, jax_forward, port_forward, width, bucket = _early_case(model)
    assert batch["mask"].shape[1] == width and batch["mask"].sum(1).max() <= bucket
    a = {k: jnp.asarray(v) for k, v in batch.items()}
    order = {"vilt": ("ids", "mask", "token_type_ids", "pixel_values"),
             "mmbt": ("ids", "mask", "pixel_values"),
             "lxmert": ("ids", "mask", "token_type_ids", "roi_features", "roi_boxes")}[model]
    tim = {"tim_ids": a["ids"], "tim_mask": a["mask"]}
    if "token_type_ids" in a:
        tim["tim_token_type_ids"] = a["token_type_ids"]
    variables = _random_variables(jm, *[a[k] for k in order], seed=4, **tim)
    carry(variables, tm)
    sliced = TP.SplitPipeline.bucket_slice(batch, bucket)
    keys = ("out_cls", "logits_per_text", "mm_features")
    want = jax.jit(lambda p, b: {k: v for k, v in jax_forward(jm, p, b).items() if k in keys})(
        variables, {k: jnp.asarray(v) for k, v in sliced.items()})
    with torch.no_grad():
        got = port_forward(tm, {k: torch.from_numpy(v) for k, v in sliced.items()})
        whole = port_forward(tm, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in keys:
        w = np.asarray(want[key], np.float32)
        scale = max(1.0, np.abs(w).max())
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=1e-5 * scale, err_msg=key)
        np.testing.assert_allclose(got[key].numpy(), whole[key].numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=key)


# -- training ----------------------------------------------------------------------


def _text_step(lazy=False, seed=0, dropout=0.0):
    """A tiny BERT classifier's TrainStep (with ``lazy`` the word table on
    the row update)."""
    model = TT.TextClassifier(TT.text_encoder_config("bert", None, dropout=dropout, **SMALL),
                              LABELS, head_dropout=dropout)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.models.encoder import (
        init_weights)

    init_weights(model, torch.Generator().manual_seed(seed))

    def fwd(batch, tim_inputs, gen, deterministic, word_embeds=None, tim_word_embeds=None):
        return {"out_cls": model(batch["ids"].long(), batch["mask"],
                                 batch["token_type_ids"].long(), gen=gen,
                                 word_embeds=word_embeds)}

    name = "tower.embeddings.word.weight"
    le = (LazyEmb(model.get_parameter(name), LazyEmbConfig(name=name, lr=1e-3,
                                                           weight_decay=0.01))
          if lazy else None)
    opt = TO.AdamW(model.named_parameters(), 1e-3, 0.01,
                   frozen=(lambda n: n == name) if lazy else None)
    return model, TS.TrainStep(model, fwd, TS.LossConfig(num_labels=LABELS), opt,
                               keep_grads=True, lazy=le)


def test_grouped_chunks_train_as_their_steps():
    """Grouped chunks of 3 through ``make_train_many`` take the steps that
    ``train_step`` takes over the same batches one at a time (the JAX
    ``test_grouped_trains_with_scan_dispatch``, held to the step-by-step
    losses and parameters); every width of the epoch trains."""
    _, tpipe = _pipes(n=40, mix="bimodal", group=True)
    model, step = _text_step(dropout=0.1)
    many = TS.make_train_many(step)
    gen = torch.Generator().manual_seed(3)
    losses, widths, chunks = [], set(), []
    for batches, k_real in tpipe.device_iter_chunks("cpu", 3, shuffle=True,
                                                    rng=np.random.RandomState(7)):
        chunks.append((batches, k_real))
        losses += many(batches, k_real, gen)["loss"].tolist()
        widths.add(batches["ids"].shape[-1])
    assert len(losses) == 10 and np.isfinite(losses).all() and len(widths) >= 2
    trained = {k: v.clone() for k, v in model.state_dict().items()}
    model2, step2 = _text_step(dropout=0.1)
    gen = torch.Generator().manual_seed(3)
    eager = [float(step2({k: v[i] for k, v in b.items()}, gen)["loss"])
             for b, k_real in chunks for i in range(k_real)]
    assert eager == losses
    assert all(torch.equal(trained[k], v) for k, v in model2.state_dict().items())


def test_lazy_row_update_bucketed_equals_full_pad():
    """``--opt_impl lazy_emb`` on a batch sliced to its bucket: the same
    unique ids as at full pad (fewer fill slots: N = B·L), the same row
    gradients and the same table and moments after the step."""
    _, tpipe = _pipes()
    _, full = _pipes(None)
    tb, fb = next(tpipe.device_iter("cpu")), next(full.device_iter("cpu"))
    assert tb["ids"].shape[1] < fb["ids"].shape[1]
    out = []
    for batch in (tb, fb):
        model, step = _text_step(lazy=True)
        step(batch, torch.Generator())
        uids, g_rows = step.last_grads[step.lazy.name]
        real = uids != OOB_ID
        assert uids.numel() == batch["ids"].numel()
        out.append((uids[real], g_rows[real], step.lazy.param.detach().clone(),
                    {k: v.clone() for k, v in step.lazy.state.items()}))
    (u1, g1, p1, s1), (u2, g2, p2, s2) = out
    assert torch.equal(u1, u2)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), rtol=0, atol=1e-6)
    for k in s1:
        np.testing.assert_allclose(s1[k].numpy(), s2[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


class _Pixels:
    """Every id's pixels: a constant frame of the id's value."""

    def gather(self, ids):
        return np.stack([np.full((4, 4, 3), int(i) % 256, np.uint8) for i in ids])


def test_vision_cached_chunks_follow_the_inner_pipe():
    """``--cache_vision`` over a grouped pipe (the JAX cached chunker): the
    inner pipe's chunks, width for width, each row's features its image's."""
    jpipe, _ = _pipes(n=40, mix="bimodal", group=True)
    _, inner = _pipes(n=40, mix="bimodal", group=True)
    inner.image_source = _Pixels()
    inner.cfg.with_images = True

    def vision_fn(px):
        v = torch.from_numpy(px).float().mean((1, 2))
        return v[:, None, :].repeat(1, 2, 1), v

    cached = TBuild.VisionCachedPipe(inner, vision_fn)
    got = []
    for batches, k_real in cached.device_iter_chunks("cpu", 3, shuffle=True,
                                                     rng=np.random.RandomState(7)):
        assert "pixel_values" not in batches and "_max_len" not in batches
        ids = np.asarray(batches["data_id"])
        np.testing.assert_array_equal(batches["vision_pooled"][..., 0].numpy(), ids % 256)
        valid = batches["valid"].numpy()
        got.append((batches["mask"].shape[-1],
                    [ids[i][valid[i] > 0].tolist() for i in range(k_real)], k_real))
    assert got == _chunks(jpipe, 3, jax_side=True)
    assert cached.compute_calls == 10


# -- the runner ----------------------------------------------------------------------


FAST = ["--model_name", "bert", "--task", "3", "--arch", "tiny", "--dtype", "float32",
        "--epochs", "1", "--log_every", "1", "--save_preds", "--device", "cpu"]
STEM = "bert_task3_seed30"


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def txt_runs(tmp_path_factory):
    """``run_txt`` on the generated task-3 posts without and with
    ``--bucket_seq``, and on bimodal posts grouped at K = 3: straight, and
    stopped by SIGTERM after its first chunk, then resumed."""
    root = tmp_path_factory.mktemp("bucketing")
    csv_path, img_fmt, _ = make_task_fixture(root / "data", task=3, n=72)
    bimodal = root / "bimodal.csv"
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    for i, row in enumerate(rows[1:]):
        row[1] = _texts(len(rows) - 1, "bimodal")[i]
    with open(bimodal, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    mp = pytest.MonkeyPatch()
    mp.setitem(C.PATH, 3, csv_path)
    mp.setitem(C.IMG_FMT, 3, img_fmt)
    mp.setattr(C, "DATA_PATH", str(root / "data") + os.sep)
    out = {}

    def run(kind, argv, stop_first=False):
        mp.setattr(C, "results_dir_txt", str(root / kind) + os.sep)
        seen = []

        def on_step(step, metrics):
            seen.append(step)
            if stop_first and len(seen) == 1:
                os.kill(os.getpid(), signal.SIGTERM)

        trainer, setup = run_txt.main(FAST + argv, on_step=on_step)
        out[kind] = (str(root / kind) + os.sep, seen,
                     {k: v.clone() for k, v in setup.model.state_dict().items()})

    try:
        run("full", [])
        run("bucketed", ["--bucket_seq", "16,32,64"])
        mp.setitem(C.PATH, 3, str(bimodal))
        grouped = ["--bucket_seq", "8,16", "--bucket_group", "--steps_per_dispatch", "3"]
        run("grouped", grouped)
        run("stopped", grouped + ["--ckpt_every", "100"], stop_first=True)
        run("stopped", grouped + ["--ckpt_every", "100", "--resume"])
    finally:
        mp.undo()
    return out


def test_run_txt_artifacts_with_and_without_bucket_seq(txt_runs):
    a, b = txt_runs["full"][0], txt_runs["bucketed"][0]
    assert _read(a + STEM + "_preds.csv") == _read(b + STEM + "_preds.csv")
    for table in ("_metrics_val.csv", "_metrics_test.csv"):
        got, want = _read(b + STEM + table), _read(a + STEM + table)
        assert [r[0] for r in got] == [r[0] for r in want]
        np.testing.assert_allclose(np.array([r[1:] for r in got[1:]], float),
                                   np.array([r[1:] for r in want[1:]], float),
                                   rtol=5e-3, atol=5e-3, err_msg=table)


def test_grouped_run_resumes_bit_for_bit(txt_runs):
    _, straight_steps, straight = txt_runs["grouped"]
    _, resumed_steps, resumed = txt_runs["stopped"]
    assert straight_steps[-1] == 4 and resumed_steps[-1] == 4  # 64 posts, batch 16
    assert resumed_steps[0] > straight_steps[0]
    assert resumed.keys() == straight.keys()
    assert [k for k in straight if not torch.equal(straight[k], resumed[k])] == []
