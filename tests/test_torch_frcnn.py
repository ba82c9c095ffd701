"""The PyTorch port's Faster R-CNN (``models/frcnn.py``) against the JAX
package's, on the CPU at ``TINY``: one JAX detector over parameters drawn with
numpy from ``jax.eval_shape``'s shapes (no ``init`` compile), built once per
module, the port's weights carried by ``models/from_jax.py::
load_jax_frcnn``.

Tolerances: the anchors, ``greedy_nms``, the device NMS's surfaced prefix,
the staged and fused selections' indices and classes exactly; ROIAlign within
rtol 1e-5 (float32 summation order); stages 1 and 2 and the final features
within 1e-4 of each output's scale; the device resize within atol 1e-3 on the
0-255 scale; the bfloat16 trunk within 3e-2 of its scale (bfloat16 rounds at
other places in XLA and PyTorch, see ``test_torch_from_jax.BF16_TOL``).
"""

import dataclasses
import logging
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from socialmedia_textimage_classification_auxlosses_tpu.models import frcnn as J
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import frcnn as T
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    frcnn_state_from_jax, load_jax_frcnn)

sys.path.insert(0, os.path.dirname(__file__))
from ref_frcnn import TwinFrcnn  # noqa: E402
from test_torch_from_jax import BF16_TOL  # noqa: E402

TINY = T.TINY
KEYS = ("roi_features", "normalized_boxes", "scores", "classes")


def _image(h=50, w=80, seed=3):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3), np.uint8)


IMAGES = [_image(seed=1), _image(h=70, w=40, seed=2), _image(seed=3), _image(h=33, w=33, seed=4)]


def _drawn_params(cfg, seed=0):
    """The JAX detector's tree, shapes from ``jax.eval_shape`` of its
    ``init_params``, values drawn with numpy: kernels lecun-scaled (the class
    scores' small, so that no two regions tie at probability 1.0 and the
    ranking is defined), small biases, frozen batch norms away from
    identity."""
    shapes = jax.eval_shape(
        lambda r: J.FrcnnDetector.init_params(SimpleNamespace(cfg=cfg), r), jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
            if path[-2].key == "cls_score":  # unsaturated class scores: no ties at 1.0
                v *= 0.02
        elif name in ("weight", "running_var"):  # frozen batch norm's scale and variance
            v = rng.rand(*shape) + 0.5
        else:  # biases and running means
            v = rng.randn(*shape) * 0.1
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def pair():
    """(JAX detector, the port's detector on the CPU, numpy tree)."""
    tree = _drawn_params(TINY)
    jd = J.FrcnnDetector(TINY, params=jax.tree_util.tree_map(jnp.asarray, tree))
    td = load_jax_frcnn(T.FrcnnDetector(TINY, device="cpu"), tree)
    return jd, td, tree


@pytest.fixture(scope="module")
def jax_results(pair):
    """The JAX detector's staged and fused results over ``IMAGES`` (batch 4,
    one compile each)."""
    jd = pair[0]
    return {"staged": jd.detect_batch(IMAGES, pad_to=4, fused=False),
            "fused": jd.detect_batch(IMAGES, pad_to=4, fused=True)}


def _scaled(got, want, tol, what=""):
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    assert err <= tol * scale, (what, err, scale)


def _same_results(got_all, want_all, feat_tol=1e-4):
    for got, want in zip(got_all, want_all):
        np.testing.assert_array_equal(got["classes"], want["classes"])
        assert got["roi_features"].shape == want["roi_features"].shape
        _scaled(got["roi_features"], want["roi_features"], feat_tol, "features")
        _scaled(got["normalized_boxes"], want["normalized_boxes"], 1e-5, "boxes")
        _scaled(got["scores"], want["scores"], 1e-4, "scores")


# ---- configuration ----------------------------------------------------------

def test_config_matches_jax():
    assert dataclasses.asdict(T.FrcnnConfig()) == dataclasses.asdict(J.FrcnnConfig())
    assert dataclasses.asdict(T.TINY) == dataclasses.asdict(J.TINY)
    assert (T.TINY.num_anchors, T.TINY.res4_features) == (J.TINY.num_anchors,
                                                          J.TINY.res4_features)


@pytest.mark.parametrize("pre,post", [(None, None), (2000, 300), (100, None), (200, 500)])
def test_topk_overrides_match_jax(pre, post, caplog):
    with caplog.at_level(logging.WARNING):
        got = T.apply_topk_overrides(T.FrcnnConfig(), pre, post)
        port_log = [r.getMessage() for r in caplog.records]
        caplog.clear()
        want = J.apply_topk_overrides(J.FrcnnConfig(), pre, post)
        jax_log = [r.getMessage() for r in caplog.records]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert port_log == jax_log and (len(port_log) == 1) == (pre is not None)
    if pre is None and post is None:
        assert got is not None and T.apply_topk_overrides(TINY, None, None) is TINY


@pytest.mark.parametrize("pre,post", [(0, None), (None, 35), (35, None)])
def test_invalid_topk_budgets_raise_the_jax_errors(pre, post):
    with pytest.raises(ValueError) as want:
        J.apply_topk_overrides(J.FrcnnConfig(), pre, post)
    with pytest.raises(ValueError) as got:
        T.apply_topk_overrides(T.FrcnnConfig(), pre, post)
    assert str(got.value) == str(want.value)


# ---- geometry and NMS ---------------------------------------------------------

def test_anchors_match_jax_and_twin():
    ours = T.generate_anchors(TINY, 4, 6)
    np.testing.assert_array_equal(ours, J.generate_anchors(J.TINY, 4, 6))
    np.testing.assert_allclose(ours, TwinFrcnn(TINY).anchors(4, 6), rtol=1e-6)


def test_decode_and_clip_match_jax():
    rng = np.random.RandomState(0)
    anchors = J.generate_anchors(J.TINY, 3, 5)
    deltas = (rng.randn(len(anchors), 4) * 3).astype(np.float32)
    deltas[:4, 2:] = 9.0  # past the scale clamp
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        want = np.asarray(J.decode_boxes(anchors, deltas, weights))
        got = T.decode_boxes(torch.from_numpy(anchors), torch.from_numpy(deltas), weights)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(T.clip_boxes(got, 40.0, 70.0).numpy(),
                                   np.asarray(J.clip_boxes(want, 40.0, 70.0)),
                                   rtol=1e-6, atol=1e-4)


def test_greedy_nms_matches_jax_and_twin():
    rng = np.random.RandomState(5)
    boxes = rng.rand(40, 4) * 50
    boxes[:, 2:] = boxes[:, :2] + rng.rand(40, 2) * 30 + 1
    scores = rng.rand(40)
    for max_out in (None, 6):
        ours = T.greedy_nms(boxes, scores, 0.5, max_out=max_out)
        np.testing.assert_array_equal(ours, J.greedy_nms(boxes, scores, 0.5, max_out=max_out))
        np.testing.assert_array_equal(ours, TwinFrcnn.nms(boxes, scores, 0.5, max_out=max_out))


def _sorted_case(n, seed, grouped, spread=20.0):
    r = np.random.RandomState(seed)
    centers = r.rand(n, 2) * spread
    boxes = np.concatenate([centers, centers + 5 + r.rand(n, 2) * 4], 1)
    scores = r.rand(n).astype(np.float32)
    alive = r.rand(n) > 0.15
    group = r.randint(0, 3, n) if grouped else None
    order = np.argsort(np.where(alive, -scores, np.inf), kind="stable")
    return (boxes[order].astype(np.float32), alive[order],
            None if group is None else group[order])


def _greedy_prefix(sb, sa, sg, max_out):
    """Independent host greedy per group over the alive rows of sorted boxes."""
    n = len(sa)
    ref_keep = np.zeros(n, bool)
    live = np.nonzero(sa)[0]
    groups = [live] if sg is None else [live[sg[live] == g] for g in np.unique(sg[live])]
    for rows in groups:
        kept = J.greedy_nms(sb[rows], -np.arange(len(rows), dtype=np.float32), 0.5, max_out=n)
        ref_keep[rows[kept]] = True
    ref_all = np.nonzero(ref_keep)[0]
    cnt = min(len(ref_all), max_out)
    return ref_all[:cnt], cnt


# the JAX package's blocked-stress cases (tests/test_frcnn.py), plus the
# early stop at the first block and a block of one row
NMS_CASES = [(5, 8, 5, False), (16, 8, 16, False), (37, 8, 37, True), (60, 8, 9, False),
             (120, 16, 120, True), (90, 32, 20, True), (64, 64, 3, False), (9, 1, 9, True)]


@pytest.mark.parametrize("n,block,max_out,grouped", NMS_CASES)
def test_nms_keep_device_surfaces_the_greedy_prefix(n, block, max_out, grouped):
    sb, sa, sg = _sorted_case(n, 100 + n + block, grouped)
    keep, cnt = T.nms_keep_device(torch.from_numpy(sb), torch.from_numpy(sa), 0.5, max_out,
                                  group=None if sg is None else torch.from_numpy(sg),
                                  block=block)
    jkeep, jcnt = J.nms_keep_device(jnp.asarray(sb), jnp.asarray(sa), 0.5, max_out,
                                    group=None if sg is None else jnp.asarray(sg), block=block)
    ref, ref_cnt = _greedy_prefix(sb, sa, sg, max_out)
    assert int(cnt) == int(jcnt) == ref_cnt
    got = np.nonzero(keep.numpy())[0][:max_out]
    np.testing.assert_array_equal(got[:ref_cnt], ref)
    np.testing.assert_array_equal(got[:ref_cnt], np.nonzero(np.asarray(jkeep))[0][:ref_cnt])


def test_nms_keep_device_window_in_lockstep_equals_each_image():
    """Images of a window that stop at different block steps (one dead, one
    early stop, one full pass) give each image's own result."""
    cases = [_sorted_case(48, s, g, spread=sp) for s, g, sp in
             ((1, True, 20.0), (2, False, 60.0), (3, True, 5.0))]
    sb = np.stack([c[0] for c in cases])
    sa = np.stack([c[1] for c in cases])
    sa[0] = False
    sg = np.stack([c[2] if c[2] is not None else np.zeros(48, np.int64) for c in cases])
    keep, cnt = T.nms_keep_device(torch.from_numpy(sb), torch.from_numpy(sa), 0.5, 11,
                                  group=torch.from_numpy(sg), block=8)
    for i in range(3):
        k1, c1 = T.nms_keep_device(torch.from_numpy(sb[i]), torch.from_numpy(sa[i]), 0.5, 11,
                                   group=torch.from_numpy(sg[i]), block=8)
        assert int(cnt[i]) == int(c1)
        np.testing.assert_array_equal(np.nonzero(keep[i].numpy())[0][:int(c1)],
                                      np.nonzero(k1.numpy())[0][:int(c1)])
    assert int(cnt[0]) == 0


# ---- ROIAlign and the max-pool -------------------------------------------------

ROI_BOXES = np.asarray([
    [0.0, 0.0, 40.0, 30.0],
    [10.0, 5.0, 90.0, 60.0],
    [-5.0, -5.0, 20.0, 20.0],    # partially out of range
    [100.0, 80.0, 140.0, 95.0],  # fully out of range
    [7.3, 2.9, 7.9, 3.4],        # sub-bin-size box
], np.float32)


@pytest.mark.parametrize("impl", ["mm", "gather"])
def test_roi_align_matches_jax_and_twin(impl):
    fmap = np.random.RandomState(0).rand(6, 9, 5).astype(np.float32) * 10
    kw = dict(output_size=TINY.pooler_resolution, spatial_scale=1.0 / 16,
              sampling_ratio=TINY.sampling_ratio)
    got = T.roi_align(torch.from_numpy(fmap.transpose(2, 0, 1).copy()),
                      torch.from_numpy(ROI_BOXES), impl=impl, **kw).numpy()
    want = np.asarray(J.roi_align(jnp.asarray(fmap), jnp.asarray(ROI_BOXES), impl=impl, **kw))
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-5)
    twin = TwinFrcnn(TINY).roi_align(fmap.transpose(2, 0, 1).astype(np.float64), ROI_BOXES)
    np.testing.assert_allclose(got, twin, rtol=1e-5, atol=1e-5)


def test_roi_align_chunked_equals_unchunked():
    rng = np.random.RandomState(1)
    fmap = torch.from_numpy(rng.rand(3, 4, 6).astype(np.float32))
    boxes = torch.from_numpy(rng.rand(11, 2).repeat(2, 1).astype(np.float32) * 30)
    boxes[:, 2:] += 10.0
    kw = dict(output_size=2, spatial_scale=1.0 / 16, sampling_ratio=2)
    np.testing.assert_allclose(T.roi_align(fmap, boxes, chunk=4, **kw).numpy(),
                               T.roi_align(fmap, boxes, chunk=64, **kw).numpy(), rtol=1e-6)


@pytest.mark.parametrize("hw", [(16, 16), (15, 17), (9, 10)])
def test_caffe_maxpool_is_the_ceil_mode_pool(hw):
    """The stem's pool: ``F.max_pool2d(3, 2, ceil_mode=True)`` equals padding
    (0, 1) with -inf on each axis and a VALID pool, which is JAX's."""
    import flax.linen as nn

    x = torch.from_numpy(np.random.RandomState(2).randn(2, 3, *hw).astype(np.float32))
    got = F.max_pool2d(x, 3, stride=2, ceil_mode=True)
    padded = F.pad(x, (0, 1, 0, 1), value=float("-inf"))
    np.testing.assert_array_equal(got.numpy(), F.max_pool2d(padded, 3, stride=2).numpy())
    want = nn.max_pool(jnp.asarray(x.numpy().transpose(0, 2, 3, 1)), (3, 3), strides=(2, 2),
                       padding=((0, 1), (0, 1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))


# ---- the stages -----------------------------------------------------------------

def test_stage1_normalizes_on_the_device(pair):
    """The BGR flip, the mean subtraction and the re-zeroed pad region: the
    trunk's input is ``normalize_canvas`` of the uint8 canvas."""
    td = pair[1]
    canvas, size_hw, _ = T.preprocess_image(_image(), TINY)
    assert canvas.dtype == np.uint8 and size_hw != canvas.shape[:2]
    seen = []
    hook = td.stage1.backbone.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    try:
        with torch.no_grad():
            td.stage1(torch.from_numpy(canvas[None]), torch.tensor([size_hw], dtype=torch.float32))
    finally:
        hook.remove()
    want = T.normalize_canvas(canvas, size_hw, TINY)
    np.testing.assert_array_equal(want, J.normalize_canvas(canvas, size_hw, J.TINY))
    np.testing.assert_allclose(seen[0][0].permute(1, 2, 0).numpy(), want, rtol=0, atol=1e-5)
    assert (seen[0][0, :, size_hw[0]:] == 0).all() and (seen[0][0, :, :, size_hw[1]:] == 0).all()


def _stage1_both(pair, img):
    jd, td, _ = pair
    canvas, size_hw, _ = T.preprocess_image(img, TINY)
    jcanvas, jsize, _ = J.preprocess_image(img, J.TINY)
    np.testing.assert_array_equal(canvas, jcanvas)
    assert tuple(size_hw) == tuple(jsize)
    jout = jd._stage1(jd.params["stage1"], canvas[None], jnp.asarray([size_hw], jnp.float32))
    with torch.no_grad():
        tout = td.stage1(torch.from_numpy(canvas[None]),
                         torch.tensor([size_hw], dtype=torch.float32))
    return canvas, size_hw, jout, tout


@pytest.mark.parametrize("img", [IMAGES[0], IMAGES[1]], ids=["landscape", "portrait"])
def test_stage1_matches_jax(pair, img):
    _, _, jout, tout = _stage1_both(pair, img)
    for name, j, t in zip(("fmap", "logits", "deltas"), jout, tout):
        assert t.dtype == torch.float32
        _scaled(t.permute(0, 2, 3, 1).numpy(), np.asarray(j), 1e-4, name)


def test_stage2_matches_jax_on_fixed_proposals(pair):
    """Stage 2 alone, from JAX's feature map, over 12 proposals that reach
    past the image and one degenerate box: features, best score, class and
    decoded box."""
    jd, td, _ = pair
    _, size_hw, jout, _ = _stage1_both(pair, IMAGES[0])
    fmap = np.asarray(jout[0])
    rng = np.random.RandomState(4)
    lo = rng.rand(12, 2) * np.asarray([size_hw[1], size_hw[0]])
    boxes = np.concatenate([lo, lo + rng.rand(12, 2) * 40 + 1], 1).astype(np.float32)
    boxes[-1] = [5.0, 5.0, 5.0, 5.0]
    sizes = np.asarray([size_hw], np.float32)
    jf, jb, jc, jdet = jd._stage2v(jd.params["stage2"], jnp.asarray(fmap), jnp.asarray(boxes[None]),
                                   jnp.asarray(sizes))
    with torch.no_grad():
        tf, tb, tc, tdet = td.stage2(torch.from_numpy(fmap.transpose(0, 3, 1, 2).copy()),
                                     torch.from_numpy(boxes[None]), torch.from_numpy(sizes))
    _scaled(tf.numpy(), np.asarray(jf), 1e-4, "features")
    _scaled(tb.numpy(), np.asarray(jb), 1e-4, "best")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _scaled(tdet.numpy(), np.asarray(jdet), 1e-4, "boxes")
    assert tf.dtype == tb.dtype == tdet.dtype == torch.float32


def test_stage2_chunks_equal_one_pass(pair):
    """``roi_chunk`` bounds the memory of ROIAlign + res5, not the result."""
    td = pair[1]
    rng = np.random.RandomState(6)
    fmap = torch.from_numpy(rng.randn(2, TINY.res4_features, 4, 6).astype(np.float32))
    lo = rng.rand(2, 13, 2) * 60
    boxes = torch.from_numpy(np.concatenate([lo, lo + rng.rand(2, 13, 2) * 30 + 1], -1)
                             .astype(np.float32))
    sizes = torch.tensor([[64.0, 96.0], [60.0, 90.0]])
    with torch.no_grad():
        one = td.stage2(fmap, boxes, sizes)
        td.stage2.roi_chunk = 5
        try:
            chunked = td.stage2(fmap, boxes, sizes)
        finally:
            td.stage2.roi_chunk = 256
    for a, b in zip(one, chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


# ---- whole detections -------------------------------------------------------------

def test_staged_detect_batch_matches_jax(pair, jax_results):
    _same_results(pair[1].detect_batch(IMAGES, pad_to=4, fused=False), jax_results["staged"])


def test_fused_detect_batch_matches_jax_and_staged(pair, jax_results):
    td = pair[1]
    fused = td.detect_batch(IMAGES, pad_to=4, fused=True)
    _same_results(fused, jax_results["fused"])
    _same_results(fused, td.detect_batch(IMAGES, fused=False))
    for out in fused:
        assert out["roi_features"].shape == (TINY.max_detections, TINY.feat_dim)
        assert out["classes"].dtype == np.int64


def test_rpn_proposals_match_jax(pair):
    """The staged path's host RPN half on one image's real logits."""
    jd, td, _ = pair
    _, size_hw, jout, _ = _stage1_both(pair, IMAGES[2])
    logits, deltas = np.asarray(jout[1])[0], np.asarray(jout[2])[0]
    jb, js = jd._rpn_proposals(logits, deltas, size_hw)
    tb, ts = td._rpn_proposals(logits, deltas, size_hw)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tb, jb, rtol=1e-6, atol=1e-4)


def test_device_rpn_nms_matches_greedy(pair):
    """The fused path's device RPN keeps exactly the host greedy's
    proposals, in order, over each image's real candidates."""
    td = pair[1]
    canv, sizes = [], []
    for img in IMAGES[::2]:
        c, s, _ = T.preprocess_image(img, TINY)
        canv.append(c)
        sizes.append(s)
    sizes_t = torch.tensor(sizes, dtype=torch.float32)
    with torch.no_grad():
        _, logits, deltas = td.stage1(torch.from_numpy(np.stack(canv)), sizes_t)
        props, cnt = td._rpn_device(logits, deltas, sizes_t)
    for j in range(len(canv)):
        want, _ = td._rpn_proposals(logits[j].permute(1, 2, 0).numpy(),
                                    deltas[j].permute(1, 2, 0).numpy(), sizes[j])
        assert int(cnt[j]) == len(want) > 0
        np.testing.assert_allclose(props[j, :len(want)].numpy(), want, rtol=1e-6, atol=1e-5)
        assert not props[j, len(want):].any()


def test_async_matches_sync(pair):
    """``detect_batch_async`` with two windows in flight returns what
    ``detect_batch`` returns, bit for bit."""
    td = pair[1]
    a = [_image(seed=11), _image(h=70, w=40, seed=12)]
    b = [_image(seed=13), _image(seed=14), _image(h=70, w=40, seed=15)]
    fetch_a = td.detect_batch_async(a, pad_to=4)
    fetch_b = td.detect_batch_async(b, pad_to=4)
    for imgs, got_all in ((a, fetch_a()), (b, fetch_b())):
        for got, want in zip(got_all, td.detect_batch(imgs, pad_to=4)):
            for k in KEYS:
                np.testing.assert_array_equal(got[k], want[k])


def test_end_to_end_matches_the_torch_twin(tmp_path):
    """The independent twin (``tests/ref_frcnn.py``) on its own weights,
    read by ``load_frcnn``: the same regions."""
    twin = TwinFrcnn(TINY)
    torch.save({"model": twin.state_dict()}, tmp_path / "pytorch_model.bin")
    td = T.load_frcnn(str(tmp_path), TINY, device="cpu")
    raw = _image()
    image, size_hw, _ = T.preprocess_image(raw, TINY)
    ref = twin.detect(T.normalize_canvas(image, size_hw, TINY).transpose(2, 0, 1), size_hw)
    for fused in (True, False):
        ours = td.detect_batch([raw], fused=fused)[0]
        np.testing.assert_array_equal(ours["classes"], ref["classes"])
        np.testing.assert_allclose(ours["normalized_boxes"], ref["normalized_boxes"],
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(ours["roi_features"], ref["roi_features"], rtol=1e-3,
                                   atol=1e-3)


# ---- top-k budgets (the JAX package's tests/test_frcnn_topk.py cases) -----------------

def test_pre_topk_at_anchor_count_is_a_bitwise_noop(pair):
    td = pair[1]
    canvas, _, _ = T.preprocess_image(_image(), TINY)
    n_anch = (canvas.shape[0] // TINY.stride) * (canvas.shape[1] // TINY.stride) * TINY.num_anchors
    assert n_anch <= TINY.rpn_pre_nms_topk
    td2 = T.FrcnnDetector(T.apply_topk_overrides(TINY, n_anch, None), state_dict=td.state_dict(),
                          device="cpu")
    a, b = td.detect(_image()), td2.detect(_image())
    for k in KEYS:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("pre,post", [(8, None), (None, 8), (8, 8)])
def test_reduced_budget_keeps_the_output_contract(pre, post):
    det = T.FrcnnDetector(T.apply_topk_overrides(TINY, pre, post), device="cpu")
    out = det.detect(_image())
    assert out["roi_features"].shape == (TINY.max_detections, TINY.feat_dim)
    assert out["normalized_boxes"].shape == (TINY.max_detections, 4)
    assert np.isfinite(out["roi_features"]).all()
    nb = out["normalized_boxes"]
    assert (nb >= -1e-5).all() and (nb <= 1.0 + 1e-5).all()


def test_reduced_post_topk_keeps_the_score_prefix(pair):
    td = pair[1]
    cut = T.FrcnnDetector(T.apply_topk_overrides(TINY, None, 6), state_dict=td.state_dict(),
                          device="cpu")
    canvas, size_hw, _ = T.preprocess_image(_image(seed=11), TINY)
    with torch.no_grad():
        _, logits, deltas = td.stage1(torch.from_numpy(canvas[None]),
                                      torch.tensor([size_hw], dtype=torch.float32))
    lg, dl = logits[0].permute(1, 2, 0).numpy(), deltas[0].permute(1, 2, 0).numpy()
    full_b, full_s = td._rpn_proposals(lg, dl, size_hw)
    cut_b, cut_s = cut._rpn_proposals(lg, dl, size_hw)
    k = cut_b.shape[0]
    assert 0 < k <= 6 and k <= full_b.shape[0]
    np.testing.assert_array_equal(cut_b, full_b[:k])
    np.testing.assert_array_equal(cut_s, full_s[:k])


# ---- device ingest -------------------------------------------------------------------

@pytest.mark.parametrize("h0,w0,h1,w1", [(17, 23, 31, 42), (40, 60, 20, 30), (24, 24, 24, 24),
                                         (33, 20, 64, 39)])
def test_device_resize_matches_jax(h0, w0, h1, w1):
    img = np.random.RandomState(0).randint(0, 255, (h0, w0, 3), np.uint8)
    padded = np.zeros((h0 + 7, w0 + 5, 3), np.uint8)
    padded[:h0, :w0] = img
    ph, pw = h1 + 9, w1 + 3
    got = T.device_resize_canvas(torch.from_numpy(padded), (h0, w0), (h1, w1), ph, pw).numpy()
    want = np.asarray(J.device_resize_canvas(padded, np.asarray([h0, w0], np.int32),
                                             np.asarray([h1, w1], np.int32), ph, pw))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert not got[h1:].any() and not got[:, w1:].any()


def test_device_ingest_matches_jax(pair):
    """``ingest="device"`` against JAX's device ingest, and within the
    resize's quantization of the PIL path (the bound of
    tests/test_frcnn_ingest.py)."""
    jd, td, _ = pair
    rng = np.random.RandomState(2)
    imgs = [rng.randint(0, 255, (50, 70, 3), np.uint8), rng.randint(0, 255, (96, 64, 3), np.uint8)]
    got = td.detect_batch(imgs, ingest="device")
    _same_results(got, jd.detect_batch(imgs, ingest="device"), feat_tol=1e-3)
    for a, b in zip(got, td.detect_batch(imgs, ingest="pil")):
        scale = max(np.abs(a["roi_features"]).max(), 1e-3)
        assert np.abs(a["roi_features"] - b["roi_features"]).max() < 0.15 * scale
    with pytest.raises(ValueError, match="fused"):
        td.detect_batch(imgs, fused=False, ingest="device")


def test_large_photo_takes_the_pil_path(pair):
    td = pair[1]
    big = np.zeros((4 * TINY.max_size, 4 * TINY.max_size, 3), np.uint8)
    assert T.preprocess_image_original(big, TINY) is None
    assert J.preprocess_image_original(big, J.TINY) is None
    small = np.zeros((TINY.min_size // 2, TINY.min_size // 2, 3), np.uint8)
    got, want = T.preprocess_image_original(small, TINY), J.preprocess_image_original(small, J.TINY)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    mixed = td.detect_batch([_image(200, 200, 8), _image(30, 30, 9)], ingest="device")
    # the large photo's PIL canvas, batched with the small one's resized
    # original (the same results, up to the batch's float32 summation order)
    _same_results(mixed[:1], td.detect_batch([_image(200, 200, 8)], ingest="pil"))
    assert mixed[1]["roi_features"].shape[0] == TINY.max_detections


# ---- bfloat16 and weights --------------------------------------------------------------

def test_bf16_dtype_flow_and_trunk_match_jax(pair):
    """Under ``dtype="bfloat16"`` the trunk computes in bfloat16, the RPN's
    outputs are float32, ROIAlign promotes to float32 and res5's features
    are float32; stage 1 within ``BF16_TOL`` of the JAX bfloat16 stage."""
    _, td, tree = pair
    cfg = dataclasses.replace(TINY, dtype="bfloat16")
    tb = load_jax_frcnn(T.FrcnnDetector(cfg, device="cpu"), tree)
    jb = J.FrcnnDetector(dataclasses.replace(J.TINY, dtype="bfloat16"),
                         params=jax.tree_util.tree_map(jnp.asarray, tree))
    canvas, size_hw, _ = T.preprocess_image(IMAGES[0], TINY)
    sizes = torch.tensor([size_hw], dtype=torch.float32)
    with torch.no_grad():
        fmap, logits, deltas = tb.stage1(torch.from_numpy(canvas[None]), sizes)
        pooled = T.roi_align(fmap[0], torch.tensor([[0.0, 0.0, 30.0, 20.0]]), output_size=4,
                             spatial_scale=1 / 16, sampling_ratio=2)
        feats = tb.stage2.roi_heads.res5(pooled)
    assert (fmap.dtype, logits.dtype, deltas.dtype) == (torch.bfloat16, torch.float32,
                                                       torch.float32)
    assert pooled.dtype == feats.dtype == torch.float32
    jout = jb._stage1(jb.params["stage1"], canvas[None], jnp.asarray([size_hw], jnp.float32))
    for name, j, t in zip(("fmap", "logits", "deltas"), jout, (fmap, logits, deltas)):
        _scaled(t.float().permute(0, 2, 3, 1).numpy(), np.asarray(j, np.float32), BF16_TOL, name)


def test_weights_round_trip_through_load_frcnn(tmp_path):
    """The twin's state dict read by ``load_frcnn`` equals JAX
    ``import_frcnn_state_dict`` carried by ``from_jax``, key for key."""
    sd = TwinFrcnn(TINY).state_dict()
    torch.save(sd, tmp_path / "det.bin")
    td = T.load_frcnn(str(tmp_path / "det.bin"), TINY, device="cpu")
    via_jax = frcnn_state_from_jax(J.import_frcnn_state_dict(sd, J.TINY))
    got = td.state_dict()
    assert set(got) == set(sd) == set(via_jax)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(v.numpy(), via_jax[k], err_msg=k)
    bad = dict(sd)
    bad.pop("roi_heads.box_predictor.cls_score.bias")
    with pytest.raises(RuntimeError, match="cls_score.bias"):
        T.import_frcnn_state_dict(bad, TINY, device="cpu")


def test_random_init_follows_flax(pair):
    """No weights: lecun-normal kernels truncated at two standard
    deviations, zero biases, frozen batch norm at identity, drawn from the
    generator; a random detector still returns the region contract."""
    det = T.FrcnnDetector(TINY, generator=torch.Generator().manual_seed(3), device="cpu")
    again = T.FrcnnDetector(TINY, generator=torch.Generator().manual_seed(3), device="cpu")
    sd = det.state_dict()
    for k, v in sd.items():
        assert torch.equal(v, again.state_dict()[k]), k
    w = sd["backbone.res4.0.conv2.weight"]
    std = (1.0 / w[0].numel()) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.1 and w.abs().max() <= 2 * std / 0.8796 + 1e-6
    assert not sd["proposal_generator.rpn_head.conv.bias"].any()
    assert (sd["backbone.stem.conv1.norm.running_var"] == 1).all()
    out = det.detect(_image(h=70, w=40, seed=5))
    assert out["roi_features"].shape == (TINY.max_detections, TINY.feat_dim)
    assert ((out["normalized_boxes"] >= 0) & (out["normalized_boxes"] <= 1 + 1e-6)).all()
    assert np.isfinite(out["roi_features"]).all()
