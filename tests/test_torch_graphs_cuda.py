"""The port's CUDA-graph steps, ``--remat`` and launch counting, on the card.

Every test needs an NVIDIA GPU with ``nvcc`` and skips without one. The file
imports no JAX and no pandas, so it also runs on a host that has only
PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_cuda.py -q

* A ``StepGraph`` counts a launch when its replay runs it, never at capture.
* ``cli/run_mm_late.main`` (ITC + TIM), ``cli/run_mm_early.main --model
  vilt --vilt_exact_resize`` (ITC + TIM, L = 402) and ``cli/run_txt.main``
  at ``--arch small`` (4 layers, hidden 256, head dim 64), bf16,
  ``--attn_impl fused``, dropout on: three epochs of 5 steps at
  ``--steps_per_dispatch 3`` (a full chunk and a short one per epoch, each
  step a graph replay) against K = 1 (eager steps) from the same seed:
  every step's loss within 1e-5 relative and every parameter within 1e-6 of
  its scale (the same kernels in the same order, replayed); and the same for
  ``cli/run_seed_sweep.main`` over two seeds (the seed-stacked step, both
  seeds' generators registered in the graph).
* ``--remat`` with dropout on: the first step's gradients equal those
  without it, within 1e-6 of each gradient's scale (the recompute draws the
  masks the forward drew).
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build as B
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import (
    run_mm_early, run_mm_late, run_seed_sweep, run_txt)
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import _cuda
from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A
from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB
from socialmedia_textimage_classification_auxlosses_tpu_torch.train.steps import StepGraph

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")


def test_step_graph_counts_launches_when_they_run(cuda):
    g = torch.Generator("cuda").manual_seed(0)
    q = torch.randn(2, 2, 16, 64, device="cuda", dtype=torch.bfloat16)

    def step(batch):
        return {"o": A.sdpa(batch["q"], batch["q"], batch["q"], impl="auto") * 2
                + torch.rand((), generator=g, device="cuda")}

    graph = StepGraph(step, step, (g,))
    A.launches.reset()
    outs = [graph({"q": q})["o"].clone() for _ in range(3)]
    # the warm-up launched the kernel once, the capture recorded one launch
    # and counted none, each replay counted one
    assert A.launches.count == 1 + 3
    assert not torch.equal(outs[0], outs[1])  # each replay draws anew


def _dataset(root, n_train=80):
    """A task-3 data key and a 224-px uint8 pixel cache, without pandas."""
    rng = np.random.RandomState(7)
    data = os.path.join(root, "data") + os.sep
    os.makedirs(os.path.join(data, "cache", "mvsa_u8_224"))
    words = "rain sun happy sad team win lose love hate coffee city".split()
    splits = ["train"] * n_train + ["val"] * 8 + ["test"] * 8
    ids = [1000 + i for i in range(len(splits))]
    with open(data + "data_key_mvsa.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tweet_id", "text", "label", "split"])
        for i, split in zip(ids, splits):
            w.writerow([i, " ".join(rng.choice(words, size=rng.randint(3, 40))),
                        rng.randint(0, 3), split])
    cache = os.path.join(data, "cache", "mvsa_u8_224")
    np.save(os.path.join(cache, "pixels.npy"),
            rng.randint(0, 256, (len(ids), 224, 224, 3), dtype=np.uint8))
    with open(os.path.join(cache, "meta.json"), "w") as f:
        json.dump({"index": {str(i): r for r, i in enumerate(ids)}, "size": 224,
                   "valid": [True] * len(ids)}, f)
    return data


SMALL = ["--task", "3", "--epochs", "3", "--arch", "small", "--dtype", "bfloat16",
         "--attn_impl", "fused", "--log_every", "100"]
FAMILIES = {
    "late": (run_mm_late.main, ["--txt_model_name", "bernice", "--img_model_name", "vit",
                                "--fusion_name", "attention", "--use_clip_loss",
                                "--use_tim_loss", "--use_saved_features"]),
    "vilt": (run_mm_early.main, ["--model", "vilt", "--vilt_exact_resize",
                                 "--use_clip_loss", "--use_tim_loss"]),
    "txt": (run_txt.main, ["--model_name", "bernice"]),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    root = str(tmp_path_factory.mktemp("graphs"))
    data = _dataset(root)
    mp = pytest.MonkeyPatch()
    mp.setattr(C, "DATA_PATH", data)
    mp.setitem(C.PATH, 3, data + "data_key_mvsa.csv")
    mp.setitem(C.IMG_FMT, 3, data + "none/{}.jpg")  # no photo: ViLT gets zero frames
    for attr in ("results_dir_mm_late", "results_dir_mm_early", "results_dir_txt"):
        mp.setattr(C, attr, os.path.join(root, attr) + os.sep)
    yield root
    mp.undo()


@pytest.fixture
def late(data):
    return SMALL + FAMILIES["late"][1]


def _train(main, argv):
    losses = []

    def on_step(step, metrics):
        losses.extend(metrics["loss"].reshape(-1).tolist())

    trainer, setup = main(argv, on_step=on_step)
    return losses, {k: v.float().clone() for k, v in setup.model.state_dict().items()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_replayed_steps_follow_the_eager_trajectory(data, family):
    main, argv = FAMILIES[family]
    eager_losses, eager = _train(main, SMALL + argv)
    replay_losses, replayed = _train(main, SMALL + argv + ["--steps_per_dispatch", "3"])
    assert len(replay_losses) == len(eager_losses) == 15
    np.testing.assert_allclose(replay_losses, eager_losses, rtol=1e-5)
    for name, want in eager.items():
        err = (replayed[name] - want).abs().max().item()
        assert err <= 1e-6 * max(want.abs().max().item(), 1e-6), name


def test_replayed_sweep_steps_follow_the_eager_sweep(late):
    argv = late + ["--seeds", "30,40"]
    eager_losses, eager = _train(run_seed_sweep.main, argv)
    replay_losses, replayed = _train(run_seed_sweep.main, argv + ["--steps_per_dispatch", "3"])
    assert len(replay_losses) == len(eager_losses) == 2 * 15
    np.testing.assert_allclose(replay_losses, eager_losses, rtol=1e-5)
    for name, want in eager.items():
        err = (replayed[name] - want).abs().max().item()
        assert err <= 1e-6 * max(want.abs().max().item(), 1e-6), name


def test_remat_gradients_equal_the_plain_ones(late):
    grads = {}
    for remat in (False, True):
        args = run_mm_late.parse_args(late + (["--remat"] if remat else []))
        setup = B.build_mm_late_train_setup(args, C.Config(args), torch.device("cuda"),
                                            torch.Generator().manual_seed(30))
        assert setup.model.dual.text.encoder.cfg.remat == remat
        batch = next(setup.pipes["train"].device_iter(setup.device, shuffle=False))
        g, _, _ = setup.train_step.gradients(batch, torch.Generator("cuda").manual_seed(1))
        grads[remat] = {n: v.float() for n, v in g.items() if v is not None}
    for name, want in grads[False].items():
        err = (grads[True][name] - want).abs().max().item()
        assert err <= 1e-6 * max(want.abs().max().item(), 1e-6), name


def test_every_counter_is_registered():
    """``deferred_counts`` defers every wrapper's counter."""
    counters = [A.launches, A.bwd_launches, AB.launches, AB.bwd_launches,
                AB.perhead_launches, AB.perhead_bwd_launches, AB.gemm_launches,
                AB.gemm_nn_launches, AB.wgrad_launches]
    assert all(any(c is r for r in _cuda._counters) for c in counters)
