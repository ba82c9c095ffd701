"""The PyTorch port's multi-seed sweep, on the CPU at a tiny size: the
seed-stacked model (``models/encoder.py::stack_seed_models``) against each
seed's own model, forward and gradients, in the four fusion heads under
``auto`` and ``fused`` (their plain versions on the CPU), float32, atol 1e-6; one
stacked train and eval step with dropout and TIM drawn against the seeds'
separate steps; one stacked step against the JAX ``EnsembleTrainer``'s
vmapped step on the same per-seed parameters (losses 1e-5 relative,
parameters as ``test_torch_train.py`` holds one step); ``run_seed_sweep``
against separate ``run_mm_late`` runs (metrics rtol 5e-3 / atol 1e-4,
predictions exact, as ``tests/test_ensemble.py`` holds the JAX sweep); the
shared-data mode, and independent seeds seeing different batch orders. The
BEiT tower stacked (its relative-position tables, layer scales, cls token
and patch projection along the seed axis) against each seed's own tower,
and its sweep against separate runs; under ``--bucket_seq`` the JAX
independent sweep's shape error that the port's refusal cites, and the
shared-data sweep bucketed and grouped as its first seed's own run."""

import copy
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.models import fusion as JF
from socialmedia_textimage_classification_auxlosses_tpu.models.text import (
    text_encoder_config as jax_text_cfg,
)
from socialmedia_textimage_classification_auxlosses_tpu.models.vision import (
    vision_encoder_config as jax_vision_cfg,
)
from socialmedia_textimage_classification_auxlosses_tpu.train import ensemble as JE
from socialmedia_textimage_classification_auxlosses_tpu.train import optim as JO
from socialmedia_textimage_classification_auxlosses_tpu.train import steps as JS
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_late as TRun
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_seed_sweep as TSweep
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._build import (
    build_mm_late_setup,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as TC
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import encoder as TE
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import fusion as TF
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    load_jax_params, torch_state_from_jax,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import optim as TO
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import steps as TS
from socialmedia_textimage_classification_auxlosses_tpu_torch.train.checkpoint import (
    load_params,
)

from fixtures import make_task_fixture
from test_torch_from_jax import TINY, t, text_batch, torch_cfg

LABELS, B, SEEDS = 3, 3, (3, 4)
LOSS_KW = dict(num_labels=LABELS, use_clip_loss=True, use_tim_loss=True, beta_itc=0.1,
               beta_itm=0.1)


def _cfgs(impl="auto", dropout=0.0):
    text_cfg = jax_text_cfg("bernice", None, dtype="float32", attn_impl=impl,
                            dropout=dropout, vocab_size=1000, **TINY)
    vis_cfg = jax_vision_cfg("vit", None, dtype="float32", attn_impl=impl,
                             dropout=dropout, **TINY)
    return text_cfg, vis_cfg


def _port_models(fusion="attention", impl="auto", dropout=0.0):
    """One port model per seed, each initialised from its seed; and deep
    copies of them, kept unstacked."""
    text_cfg, vis_cfg = (torch_cfg(c) for c in _cfgs(impl, dropout))
    models = []
    for seed in SEEDS:
        m = TF.MMLateModel(text_cfg, vis_cfg, LABELS, fusion_name=fusion, patch=16,
                           image_size=32, dropout=dropout)
        TE.init_weights(m, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            m.dual.logit_scale.fill_(2.6592)
        models.append(m)
    return models, [copy.deepcopy(m) for m in models]


def _batch(seed=0, pad_id=1):
    """S seeds' batches, seed-major; each with a padded row and a TIM swap."""
    rng = np.random.RandomState(seed)
    ids, mask = text_batch(rng, b=B * len(SEEDS), vocab=1000, pad_id=pad_id)
    return {"ids": t(ids).long(), "mask": t(mask),
            "pixel_values": t(rng.randn(B * len(SEEDS), 32, 32, 3).astype(np.float32)),
            "labels": t(np.eye(LABELS, dtype=np.float32)[
                rng.randint(0, LABELS, B * len(SEEDS))]),
            "valid": t(np.tile(np.array([1, 1, 0], np.float32), len(SEEDS))),
            "tim_src": t(np.tile(np.array([2, 0, 1], np.int32), len(SEEDS))),
            "tim_labels": t(np.tile(np.array([0, 0, 1], np.int32), len(SEEDS)))}


def _rows(batch, i):
    return TS.seed_split(batch, len(SEEDS))[i]


def _forward(model):
    def fwd(bt, tim, gen, det):
        kw = ({"tim_src": tim["src"]} if det else
              {"tim_ids": tim["ids"], "tim_mask": tim["mask"]})
        return model(bt["ids"], bt["mask"], bt["pixel_values"], gen=gen, iadds_task=True, **kw)
    return fwd


def _close(got, want, what, tol=1e-6):
    """Within ``tol`` of the tensor's scale (at least 1): the gradients of
    the stacked LayerNorm's separate affine and of repeated token rows are
    the seed's own up to the order of float32 sums."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), f"{what}: max abs err {err}"


def _same_update(new, want, grads, lr, seed, atol=1e-6):
    """The parameters after one AdamW step: Adam moves an entry by about lr,
    so where its gradient is firm the update agrees to float32 precision,
    and elsewhere (a key bias's exact gradient is zero, all of it rounding
    noise) within 2 lr, as ``test_torch_train.py`` holds one step; the
    frozen ones are unmoved."""
    gmax = max(np.abs(g).max() for g in grads.values())
    for name, got in new.items():
        if name not in grads:
            np.testing.assert_array_equal(got, want[name], err_msg=f"seed {seed} {name}")
            continue
        firm = np.abs(grads[name]) > 1e-4 * gmax
        np.testing.assert_allclose(got[firm], want[name][firm], rtol=0, atol=atol,
                                   err_msg=f"seed {seed} {name}")
        assert np.abs(got - want[name]).max() <= 2 * lr + atol, f"seed {seed} {name}"


@pytest.mark.parametrize("impl", ["auto", "fused"])
@pytest.mark.parametrize("fusion", ["concat", "attention", "aspect-att", "gmu"])
def test_stacked_model_is_each_seeds_own(fusion, impl):
    """Forward and the gradient of every trainable parameter (the vision
    tower frozen, as every step freezes it), per seed, against that seed's
    own model (dropout off; the TIM rows re-encoded)."""
    models, singles = _port_models(fusion, impl)
    for m in models + singles:
        for n, p in m.named_parameters():
            p.requires_grad_(not TO.vision_frozen(n))
    stacked = TE.stack_seed_models(models).train()
    batch = _batch()
    rng = np.random.RandomState(1)
    weights = {k: t(rng.randn(*shape).astype(np.float32)) for k, shape in (
        ("out_cls", (B, LABELS)), ("logits_per_text", (B, B)), ("out_tim", (B, 2)),
        ("out_iadds", (B, 2)), ("mm_features", (B, TINY["hidden"])))}

    def run(model, bt, s):
        src = bt["tim_src"].long()
        out = model(bt["ids"], bt["mask"], bt["pixel_values"], iadds_task=True,
                    tim_ids=bt["ids"][src], tim_mask=bt["mask"][src])
        parts = TS.seed_split(out, s) if s else [out]
        return parts, sum((p[k] * w).sum() for p in parts for k, w in weights.items())

    # tim rows index each seed's own rows: offset them for the stacked batch
    stacked_batch = dict(batch, tim_src=batch["tim_src"].long()
                         + torch.arange(len(SEEDS)).repeat_interleave(B) * B)
    outs, total = run(stacked, stacked_batch, len(SEEDS))
    names = [n for n, p in stacked.named_parameters() if p.requires_grad]
    params = dict(stacked.named_parameters())
    grads = torch.autograd.grad(total, [params[n] for n in names])
    for i, single in enumerate(singles):
        mine, own_total = run(single.train(), _rows(batch, i), 0)
        for key in weights:
            np.testing.assert_allclose(outs[i][key].detach().numpy(),
                                       mine[0][key].detach().numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"seed {i} {key}")
        theirs = dict(single.named_parameters())
        own = dict(zip(names, torch.autograd.grad(own_total, [theirs[n] for n in names])))
        for name, g in zip(names, grads):
            _close(g[i], own[name], f"seed {i} {name}")


def test_stacked_step_with_dropout_and_tim_is_the_separate_steps():
    """Dropout 0.1 everywhere and the TIM swap drawn: one stacked train step
    (each seed's draws from its own generator) and one eval step equal the
    seeds' separate steps."""
    models, singles = _port_models(dropout=0.1)
    stacked = TE.stack_seed_models(models)
    batch = {k: v for k, v in _batch(2).items() if not k.startswith("tim_")}
    cfg = TS.LossConfig(**LOSS_KW)
    cw = t(np.array([1.0, 0.5, 2.0], np.float32))

    def step(model, seeds):
        for n, p in model.named_parameters():
            p.requires_grad_(not TO.vision_frozen(n))
        opt = TO.AdamW(model.named_parameters(), 1e-3, 0.01, frozen=TO.vision_frozen)
        weights = [cw] * seeds if seeds else cw
        return (TS.TrainStep(model, _forward(model), cfg, opt, weights, keep_grads=True,
                             seeds=seeds),
                TS.EvalStep(model, _forward(model), cfg, weights, seeds=seeds))

    train, evaluate = step(stacked, len(SEEDS))
    gens = tuple(torch.Generator().manual_seed(s) for s in SEEDS)
    got = train(batch, gens)
    got_eval = evaluate(batch, tuple(torch.Generator().manual_seed(s + 9) for s in SEEDS))
    for i, (seed, single) in enumerate(zip(SEEDS, singles)):
        own_train, own_eval = step(single, 0)
        want = own_train(_rows(batch, i), torch.Generator().manual_seed(seed))
        want_eval = own_eval(_rows(batch, i), torch.Generator().manual_seed(seed + 9))
        for key, v in want.items():
            np.testing.assert_allclose(float(got[key][i]), float(v), rtol=1e-6, atol=1e-7,
                                       err_msg=key)
        for key in ("loss", "itm_loss", "correct", "n"):
            np.testing.assert_allclose(float(got_eval[key][i]), float(want_eval[key]),
                                       rtol=1e-6, atol=1e-7, err_msg=key)
        assert torch.equal(got_eval["cm"][i], want_eval["cm"])
        assert torch.equal(_rows(got_eval, i)["predictions"], want_eval["predictions"])
        own = dict(single.named_parameters())
        own_grads = {n: np.zeros(own[n].shape, np.float32) if g is None else g.numpy()
                     for n, g in own_train.last_grads.items()}
        for name, g in train.last_grads.items():
            _close(np.zeros(own[name].shape) if g is None else g[i], own_grads[name],
                   f"seed {seed} {name} gradient")
        _same_update({n: p.detach()[i].numpy() for n, p in stacked.named_parameters()},
                     {n: p.detach().numpy() for n, p in own.items()}, own_grads, 1e-3, seed)


def test_stacked_step_matches_the_jax_ensemble_step():
    """One step of the JAX ``EnsembleTrainer`` (independent data: one batch
    per seed, vmapped) and of the port's stacked step from the same per-seed
    parameters, dropout off, ITC + TIM with the swap injected."""
    jcfgs = _cfgs("jnp")
    jm = JF.MMLateModel(*jcfgs, LABELS, fusion_name="attention", patch=16, image_size=32,
                        dropout=0.0)
    batch = _batch(3)
    first = {k: jnp.asarray(v.numpy()[:B]) for k, v in batch.items()}
    p0 = jax.jit(lambda k: JF.init_mm_late_params(jm, k, first["ids"], first["mask"],
                                                  first["pixel_values"]))(
        jax.random.PRNGKey(1))
    # the second seed's parameters: the first's, moved
    params = [p0, jax.tree_util.tree_map(lambda x: x * 0.9 + 0.01, p0)]
    lr, wd = 1e-3, 0.01
    cw = np.array([1.0, 0.5, 2.0], np.float32)

    def jfwd(p, bt, tim, rng_, det):
        kw = ({"tim_src": tim["src"]} if det else
              {"tim_ids": tim["ids"], "tim_mask": tim["mask"]})
        return jm.apply(p, bt["ids"], bt["mask"], bt["pixel_values"], deterministic=det,
                        rngs=None if det else {"dropout": rng_}, **kw)

    tx = JO.make_optimizer(lr, wd, JO.vision_frozen_predicate, fused=True)
    trainer = JE.EnsembleTrainer(jfwd, JS.LossConfig(**LOSS_KW), tx,
                                 jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *params),
                                 list(SEEDS), class_weights=jnp.asarray(cw),
                                 num_labels=LABELS, independent_data=True)
    jbatch = {k: jnp.asarray(v.numpy().reshape(len(SEEDS), B, *v.shape[1:]))
              for k, v in batch.items()}
    new, _, jmetrics = trainer.train_step(trainer.params, trainer.opt_state, jbatch, 0)

    tm_cfg = [torch_cfg(c) for c in jcfgs]
    models = []
    for p in params:
        m = TF.MMLateModel(*tm_cfg, LABELS, fusion_name="attention", patch=16, image_size=32,
                           dropout=0.0)
        models.append(load_jax_params(m, jax.tree_util.tree_map(np.asarray, p)))
    stacked = TE.stack_seed_models(models)
    for n, p in stacked.named_parameters():
        p.requires_grad_(not TO.vision_frozen(n))
    opt = TO.AdamW(stacked.named_parameters(), lr, wd, frozen=TO.vision_frozen)
    step = TS.TrainStep(stacked, _forward(stacked), TS.LossConfig(**LOSS_KW), opt,
                        [t(cw)] * len(SEEDS), keep_grads=True, seeds=len(SEEDS))
    metrics = step(batch, tuple(torch.Generator().manual_seed(s) for s in SEEDS))
    for key in ("loss", "cls_loss", "itc_loss", "itm_loss", "correct", "n"):
        np.testing.assert_allclose(metrics[key].numpy(), np.asarray(jmetrics[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for i in range(len(SEEDS)):
        want = torch_state_from_jax(jax.tree_util.tree_map(lambda x: np.asarray(x[i]), new))
        _same_update({n: p.detach()[i].numpy() for n, p in stacked.named_parameters()}, want,
                     {n: np.zeros(want[n].shape, np.float32) if v is None else v[i].numpy()
                      for n, v in step.last_grads.items()}, lr, SEEDS[i], atol=1e-5)


FAST = ["--arch", "tiny", "--dtype", "float32", "--attn_impl", "jnp", "--epochs", "1",
        "--log_every", "1", "--device", "cpu"]
BASE = ["--txt_model_name", "bert", "--img_model_name", "vit", "--fusion_name", "concat",
        "--task", "3", "--save_preds", "--save_model", "--use_clip_loss",
        "--use_tim_loss"] + FAST
STEM = "bert-vit-concat_task3_seed{}_itc0.1itm0.1_"


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def task3(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    csv_path, img_fmt, _ = make_task_fixture(root / "data", task=3)
    mp = pytest.MonkeyPatch()
    mp.setitem(TC.PATH, 3, csv_path)
    mp.setitem(TC.IMG_FMT, 3, img_fmt)
    mp.setattr(TC, "DATA_PATH", str(root / "data") + os.sep)
    yield root, mp
    mp.undo()


def test_sweep_matches_separate_runs(task3):
    """``run_seed_sweep --seeds 7,8`` (dropout and TIM on) against two
    ``run_mm_late`` runs: the same metric tables, predictions and saved
    parameters per seed."""
    root, mp = task3
    out = {}
    for kind in ("separate", "sweep"):
        mp.setattr(TC, "results_dir_mm_late", str(root / kind) + os.sep)
        if kind == "separate":
            for s in (7, 8):
                TRun.main(BASE + ["--seed", str(s)])
        else:
            TSweep.main(BASE + ["--seeds", "7,8"])
        out[kind] = str(root / kind) + os.sep
    for s in (7, 8):
        stem = STEM.format(s)
        for table in ("metrics_val.csv", "metrics_test.csv"):
            got, want = _read(out["sweep"] + stem + table), _read(out["separate"] + stem + table)
            assert [r[0] for r in got] == [r[0] for r in want] == ["metric"] + TC.metric_names
            np.testing.assert_allclose(np.array([r[1:] for r in got[1:]], float),
                                       np.array([r[1:] for r in want[1:]], float),
                                       rtol=5e-3, atol=1e-4, err_msg=f"seed {s} {table}")
        assert _read(out["sweep"] + stem + "preds.csv") == _read(
            out["separate"] + stem + "preds.csv")
        got = torch.load(out["sweep"] + stem + "net.pth", weights_only=True)
        want = torch.load(out["separate"] + stem + "net.pth", weights_only=True)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)
        # the sweep's artifact loads into a single-seed model
        args = TRun.parse_args(BASE + ["--seed", str(s)])
        load_params(out["sweep"] + stem + "net.pth",
                    build_mm_late_setup(args, TC.serving_config(args)).model)


def test_shared_data_mode_and_independent_batch_orders(task3):
    root, mp = task3
    mp.setattr(TC, "results_dir_mm_late", str(root / "shared") + os.sep)
    trainer, setup = TSweep.main(BASE + ["--seeds", "7,8", "--shared_data"])
    a, b = (_read(str(root / "shared" / (STEM.format(s) + "metrics_val.csv"))) for s in (7, 8))
    loss = [r for r in a if r[0] == "loss"][0][1], [r for r in b if r[0] == "loss"][0][1]
    assert loss[0] != loss[1]  # the seeds are different models on the same data
    assert not isinstance(setup.pipes["train"], list)

    args = TSweep.parse_args(BASE + ["--seeds", "7,8"])
    parts = TSweep.build_seed_setups(args, [7, 8])
    orders = []
    for s, p in zip((7, 8), parts):
        rng = np.random.RandomState(s)
        orders.append([i for bt in p.pipes["train"].batches(shuffle=True, rng=rng)
                       for i in bt["data_id"].tolist()])
    assert sorted(orders[0]) == sorted(orders[1])  # the same data...
    assert orders[0] != orders[1]                  # ...in another order


@pytest.mark.parametrize("extra", [["--ckpt_every", "5"], ["--resume"], ["--profile", "p"],
                                   ["--scan_layers"], ["--bucket_seq", "8,16"],
                                   ["--opt_impl", "lazy_emb"], ["--cache_vision"]],
                         ids=lambda e: e[0].lstrip("-"))
def test_sweep_refuses_what_it_does_not_carry(extra):
    args = TSweep.parse_args(BASE + ["--seeds", "7,8"] + extra)
    with pytest.raises(SystemExit, match="not"):
        TSweep.check_supported(args)
    if extra[0] in ("--opt_impl", "--cache_vision", "--bucket_seq"):  # what the JAX sweep
        with pytest.raises(SystemExit, match="the JAX sweep"):       # drops or fails on
            TSweep.check_supported(args)


def test_sweep_takes_tim_reuse_text():
    TSweep.check_supported(TSweep.parse_args(BASE + ["--seeds", "7,8", "--tim_reuse_text"]))


@pytest.mark.parametrize("extra", [["--img_model_name", "beit"],
                                   ["--shared_data", "--bucket_seq", "--bucket_group"]],
                         ids=lambda e: e[-1].lstrip("-"))
def test_sweep_takes(extra):
    TSweep.check_supported(TSweep.parse_args(BASE + ["--seeds", "7,8"] + extra))


def test_independent_sweep_under_bucketing_fails_in_jax():
    """Why the independent-data sweep refuses ``--bucket_seq``: the JAX
    sweep stacks the seeds' batches of a step (``_stack_batches``), each
    sliced to its own bucket, and two widths do not stack. Its CLI run at
    ``--arch tiny`` on posts that put two seeds' batches in different
    buckets stops with this ValueError."""
    from socialmedia_textimage_classification_auxlosses_tpu.data import pipeline as JP
    from socialmedia_textimage_classification_auxlosses_tpu.data.prep import SplitArrays
    from socialmedia_textimage_classification_auxlosses_tpu.data.tokenizers import (
        build_tokenizer)

    tok = build_tokenizer("bert", None, max_length=32, vocab_size=512)
    cfg = JP.PipelineConfig(batch_size=2, max_length=32, with_images=False,
                            seq_buckets=(8, 16))
    batches = []
    for words in (2, 12):  # one seed's batch of short posts, the other's of long ones
        texts = np.asarray([" ".join(["w"] * words)] * 2, object)
        split = SplitArrays(ids=np.asarray(["1", "2"]), ids_num=np.arange(2, dtype=np.int64),
                            text=texts, labels=np.eye(LABELS, dtype=np.float32)[:2])
        batches.append(next(JP.SplitPipeline(split, cfg, tokenizer=tok).batches()))
    assert [b["ids"].shape[1] for b in batches] == [8, 16]
    with pytest.raises(ValueError, match="same shape"):
        JE.EnsembleTrainer._stack_batches(batches)


def _bimodal_fixture(root):
    """The task-3 fixture with short posts and one long one."""
    csv_path, img_fmt, _ = make_task_fixture(root / "data", task=3, n=40)
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    for i, row in enumerate(rows[1:]):
        row[1] = " ".join(f"w{i}x{j}" for j in range(20 if i == 3 else 2 + i % 4))
    with open(csv_path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return csv_path, img_fmt


def test_shared_data_sweep_buckets_as_the_first_seeds_run(tmp_path, monkeypatch):
    """``--shared_data --bucket_seq --bucket_group`` at K = 2: every seed
    reads the first seed's stream, one width a step; the first seed's
    artifacts are its own ``run_mm_late`` run's under the same flags."""
    csv_path, img_fmt = _bimodal_fixture(tmp_path)
    monkeypatch.setitem(TC.PATH, 3, csv_path)
    monkeypatch.setitem(TC.IMG_FMT, 3, img_fmt)
    monkeypatch.setattr(TC, "DATA_PATH", str(tmp_path / "data") + os.sep)
    flags = ["--bucket_seq", "8,16", "--bucket_group", "--steps_per_dispatch", "2"]
    out = {}
    for kind in ("separate", "sweep"):
        monkeypatch.setattr(TC, "results_dir_mm_late", str(tmp_path / kind) + os.sep)
        steps = []
        if kind == "separate":
            TRun.main(BASE + flags + ["--seed", "7"])
        else:
            trainer, setup = TSweep.main(BASE + flags + ["--seeds", "7,8", "--shared_data"],
                                         on_step=lambda step, m: steps.append(step))
            assert steps == [1, 2]  # one chunk a width: 32 train posts, batch 16
            chunks = setup.pipes["train"].device_iter_chunks("cpu", 2, shuffle=True,
                                                             rng=np.random.RandomState(7))
            assert [b["ids"].shape[-1] for b, _ in chunks] == [8, 128]
        out[kind] = str(tmp_path / kind) + os.sep
    stem = STEM.format(7)
    assert _read(out["sweep"] + stem + "preds.csv") == _read(out["separate"] + stem + "preds.csv")
    for table in ("metrics_val.csv", "metrics_test.csv"):
        got, want = _read(out["sweep"] + stem + table), _read(out["separate"] + stem + table)
        np.testing.assert_allclose(np.array([r[1:] for r in got[1:]], float),
                                   np.array([r[1:] for r in want[1:]], float),
                                   rtol=5e-3, atol=1e-4, err_msg=table)


def test_stacked_beit_tower_is_each_seeds_own():
    """The BEiT tower seed-stacked (its relative-position tables, layer
    scales, cls token and patch projection along the seed axis): forward
    and the gradient of every parameter per seed, against each seed's own
    tower, float32, within 1e-6 of the scale."""
    from socialmedia_textimage_classification_auxlosses_tpu_torch.models.beit import (
        BeitEncoder)

    cfg = TE.EncoderConfig(hidden=32, layers=2, heads=2, mlp_dim=64, dropout=0.0,
                           ln_style="pre", ln_eps=1e-12)
    towers = []
    for seed in SEEDS:
        m = BeitEncoder(cfg, patch=8, image_size=32)
        TE.init_weights(m, torch.Generator().manual_seed(seed))
        with torch.no_grad():  # BEiT's constants drawn too, so the seeds differ there
            for layer in m.layers:
                layer.attention.rel_pos_table.normal_(generator=torch.Generator().manual_seed(
                    seed + 100))
                layer.lambda_1.uniform_(0.05, 0.2)
            m.cls_token.normal_()
        towers.append(m)
    singles = [copy.deepcopy(m) for m in towers]
    stacked = TE.stack_seed_models(towers)
    px = t(np.random.RandomState(5).randn(B * len(SEEDS), 32, 32, 3).astype(np.float32))
    w = np.random.RandomState(6)
    weights = (t(w.randn(B, 17, 32).astype(np.float32)), t(w.randn(B, 32).astype(np.float32)))

    def loss(hidden, pooled):
        return (hidden * weights[0].repeat(len(hidden) // B, 1, 1)).sum() + (
            pooled * weights[1].repeat(len(pooled) // B, 1)).sum()

    hidden, pooled = stacked(px)
    params = dict(stacked.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss(hidden, pooled), list(params.values()))))
    for i, single in enumerate(singles):
        h, p = single(px[i * B:(i + 1) * B])
        _close(hidden[i * B:(i + 1) * B].detach(), h.detach(), f"seed {i} hidden")
        _close(pooled[i * B:(i + 1) * B].detach(), p.detach(), f"seed {i} pooled")
        own = dict(single.named_parameters())
        mine = dict(zip(own, torch.autograd.grad(loss(h, p), list(own.values()))))
        for name, g in grads.items():
            _close(g[i], mine[name], f"seed {i} {name}")


def test_beit_sweep_matches_separate_runs(task3):
    """``run_seed_sweep --img_model_name beit`` (attention fusion, dropout and
    TIM on) against two ``run_mm_late`` runs, at the ViT sweep's tolerances."""
    root, mp = task3
    base = [a for a in BASE]
    base[base.index("vit")] = "beit"
    base[base.index("concat")] = "attention"
    stem = "bert-beit-attention_task3_seed{}_itc0.1itm0.1_"
    out = {}
    for kind in ("beit_separate", "beit_sweep"):
        mp.setattr(TC, "results_dir_mm_late", str(root / kind) + os.sep)
        if kind == "beit_separate":
            for s in (7, 8):
                TRun.main(base + ["--seed", str(s)])
        else:
            TSweep.main(base + ["--seeds", "7,8"])
        out[kind] = str(root / kind) + os.sep
    for s in (7, 8):
        for table in ("metrics_val.csv", "metrics_test.csv"):
            got = _read(out["beit_sweep"] + stem.format(s) + table)
            want = _read(out["beit_separate"] + stem.format(s) + table)
            np.testing.assert_allclose(np.array([r[1:] for r in got[1:]], float),
                                       np.array([r[1:] for r in want[1:]], float),
                                       rtol=5e-3, atol=1e-4, err_msg=f"seed {s} {table}")
        assert _read(out["beit_sweep"] + stem.format(s) + "preds.csv") == _read(
            out["beit_separate"] + stem.format(s) + "preds.csv")
        got = torch.load(out["beit_sweep"] + stem.format(s) + "net.pth", weights_only=True)
        want = torch.load(out["beit_separate"] + stem.format(s) + "net.pth", weights_only=True)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


def _old_seed_product(x3, w, bias):
    """The product before ``SeedProduct``: autograd's own backward of
    ``bmm(x, w.transpose(1, 2))``, which leaves dW as a transposed view."""
    wt = w.transpose(1, 2)
    return torch.bmm(x3, wt) if bias is None else torch.baddbmm(bias[:, None, :], x3, wt)


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_stacked_weight_gradients_keep_their_layout(monkeypatch, impl):
    """After one stacked step's gradients every weight gradient has its
    parameter's strides (so AdamW's multi-tensor ops take each group at
    once; under ``fused`` the blocks' too), with the values of autograd's
    own backward of the stacked product within 1e-6."""
    models, _ = _port_models(impl=impl, dropout=0.1)
    stacked = TE.stack_seed_models(models)
    for n, p in stacked.named_parameters():
        p.requires_grad_(not TO.vision_frozen(n))
    opt = TO.AdamW(stacked.named_parameters(), 1e-3, 0.01, frozen=TO.vision_frozen)
    step = TS.TrainStep(stacked, _forward(stacked), TS.LossConfig(**LOSS_KW), opt,
                        seeds=len(SEEDS))
    batch = {k: v for k, v in _batch(4).items() if not k.startswith("tim_")}

    def grads():
        gens = tuple(torch.Generator().manual_seed(s) for s in SEEDS)
        return step.gradients(batch, gens)[0]

    new = grads()
    params = dict(stacked.named_parameters())
    for name, g in new.items():
        if g is not None:
            assert g.stride() == params[name].stride(), name
    monkeypatch.setattr(TE.SeedProduct, "apply", _old_seed_product)
    old = grads()
    transposed = [n for n, g in old.items() if g is not None and g.stride() != params[n].stride()]
    assert transposed  # what the old backward left
    for name, g in new.items():
        if g is not None:
            np.testing.assert_allclose(g.numpy(), old[name].numpy(), rtol=0, atol=1e-6,
                                       err_msg=name)
