"""Loss side of the PyTorch port against the JAX package, in f32 on the CPU:
BCE/focal, CIoU, the device classification metrics, the assigner and the
three-scale detection loss with its gradient w.r.t. the predictions.

Inputs are made with numpy from a seed. Values go through the JAX function
(jitted) and the port's; gradients through jax.grad and a requires_grad
copy in the port. Tolerances: elementwise math 1e-6; the detection loss
and its metrics 1e-5 (reductions in another order); d(loss)/d(preds)
atol 1e-6 / rtol 1e-4.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vision_conglomerate_tpu.losses import DetectionLossConfig as JaxLossConfig
from vision_conglomerate_tpu.losses import detection_loss as jax_detection_loss
from vision_conglomerate_tpu.losses.assigner import assign_targets_to_scale as jax_assign
from vision_conglomerate_tpu.losses.focal import bce_with_logits as jax_bce
from vision_conglomerate_tpu.losses.focal import focal_loss_with_logits as jax_focal
from vision_conglomerate_tpu.losses.focal import softmax_cross_entropy as jax_softmax_ce
from vision_conglomerate_tpu.ops.boxes import compute_ciou as jax_ciou
from vision_conglomerate_tpu.ops.metrics import macro_classification_metrics as jax_macro

from vision_conglomerate_torch.losses import DetectionLossConfig, detection_loss
from vision_conglomerate_torch.losses.assigner import assign_targets_to_scale
from vision_conglomerate_torch.losses.detection_loss import conf_targets
from vision_conglomerate_torch.losses.focal import (
    bce_with_logits, focal_loss_with_logits, softmax_cross_entropy)
from vision_conglomerate_torch.ops.boxes import compute_ciou
from vision_conglomerate_torch.ops.metrics import macro_classification_metrics

NUM_CLASSES = 3
GRIDS = ((8, 8), (4, 4), (2, 2))  # a 64x64 input at strides 8/16/32
ANCHORS = np.asarray([
    [[0.1, 0.1], [0.15, 0.2], [0.25, 0.2]],
    [[0.3, 0.3], [0.4, 0.35], [0.35, 0.5]],
    [[0.5, 0.6], [0.7, 0.6], [0.8, 0.9]],
], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: as fast for these small tensors, and parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grad(fn, x: np.ndarray):
    """(value, d sum(fn(x)) / dx) through the port."""
    t = torch.from_numpy(x.copy()).requires_grad_(True)
    out = fn(t)
    out.sum().backward()
    return out.detach().numpy(), t.grad.numpy()


def _labels():
    """(B=2, M=8, 5) labels and mask that hit every branch of the assigner:
    padded slots, boxes by the borders (the clamp and the mirrored offsets
    fire), a box too large and one too small for every small anchor (the
    ratio filter), and two labels on one cell and anchor with other
    classes and sizes (last write wins)."""
    labels = np.zeros((2, 8, 5), np.float32)
    mask = np.zeros((2, 8), bool)
    rows0 = [
        [0, 0.50, 0.50, 0.20, 0.25],
        [1, 0.02, 0.97, 0.12, 0.10],   # by the left and bottom borders
        [2, 1.00, 0.03, 0.15, 0.15],   # on the right border: its cell is clamped
        [1, 0.40, 0.60, 0.95, 0.90],   # too large for the small anchors
        [0, 0.70, 0.30, 0.004, 0.01],  # too small for every anchor
        [2, 0.53, 0.55, 0.22, 0.18],   # same cells and anchors as row 0
    ]
    rows1 = [
        [2, 0.31, 0.44, 0.30, 0.35],
        [0, 0.31, 0.44, 0.28, 0.30],   # same cells and anchors as row 0
        [1, 0.875, 0.125, 0.10, 0.12],
    ]
    labels[0, :len(rows0)] = rows0
    labels[1, :len(rows1)] = rows1
    mask[0, :len(rows0)] = True
    mask[1, :len(rows1)] = True
    labels[1, 5] = [1, 0.5, 0.5, 0.3, 0.3]  # a padded slot holding a box: masked out
    return labels, mask


def test_bce_focal_and_softmax_ce_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 5)) * 4).astype(np.float32)
    t = rng.uniform(size=(64, 5)).astype(np.float32)
    tt = torch.from_numpy(t)
    for port_fn, jax_fn in ((bce_with_logits, jax_bce),
                            (lambda a, b: focal_loss_with_logits(a, b, 1.5, 0.25),
                             lambda a, b: jax_focal(a, b, 1.5, 0.25))):
        got, got_g = _grad(lambda v: port_fn(v, tt), x)
        want = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(t)))
        want_g = np.asarray(jax.grad(lambda v: jax_fn(v, jnp.asarray(t)).sum())(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got_g, want_g, atol=1e-6, rtol=1e-6)
    labels = rng.integers(0, 5, 64)
    tl = torch.from_numpy(labels)
    got, got_g = _grad(lambda v: softmax_cross_entropy(v, tl), x)
    want = np.asarray(jax_softmax_ce(jnp.asarray(x), jnp.asarray(labels)))
    want_g = np.asarray(jax.grad(lambda v: jax_softmax_ce(v, jnp.asarray(labels)).sum())(
        jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got_g, want_g, atol=1e-6, rtol=1e-6)


def test_ciou_matches_jax():
    rng = np.random.default_rng(1)
    p = np.concatenate([rng.uniform(-0.5, 1.5, (50, 2)), rng.uniform(0.05, 4, (50, 2))],
                       axis=1).astype(np.float32)
    t = np.concatenate([rng.uniform(0, 1, (50, 2)), rng.uniform(0.05, 4, (50, 2))],
                       axis=1).astype(np.float32)
    t[0, 3] = 0.0  # zero height: the clamped denominator keeps it finite
    p[1] = t[1]    # identical boxes
    tt = torch.from_numpy(t)
    got, got_g = _grad(lambda v: compute_ciou(v, tt), p)
    want = np.asarray(jax_ciou(jnp.asarray(p), jnp.asarray(t)))
    want_g = np.asarray(jax.grad(lambda v: jax_ciou(v, jnp.asarray(t)).sum())(jnp.asarray(p)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got_g, want_g, atol=1e-6, rtol=1e-6)
    assert np.isfinite(got_g).all()


@pytest.mark.parametrize("n_valid", [37, 0])
def test_macro_metrics_match_jax(n_valid):
    rng = np.random.default_rng(2)
    pred = rng.integers(0, 5, 60)
    target = rng.integers(0, 4, 60)  # class 4 only predicted, never a target
    valid = np.zeros(60, bool)
    valid[rng.permutation(60)[:n_valid]] = True
    got = macro_classification_metrics(torch.from_numpy(pred), torch.from_numpy(target),
                                       torch.from_numpy(valid), 5)
    want = jax_macro(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(valid), 5)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                   equal_nan=True, err_msg=k)
        assert np.isnan(got[k].item()) == (n_valid == 0), k


@pytest.mark.parametrize("scale", range(3))
def test_assigner_matches_jax(scale):
    labels, mask = _labels()
    grid, anchors = GRIDS[scale], ANCHORS[scale]
    got = assign_targets_to_scale(torch.from_numpy(labels), torch.from_numpy(mask), grid,
                                  torch.from_numpy(anchors))
    want = jax_assign(jnp.asarray(labels), jnp.asarray(mask), grid, jnp.asarray(anchors))
    for field in want._fields:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.shape == w.shape, field
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=field)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6, err_msg=field)
    valid = got.valid.numpy()
    assert 0 < valid.sum() < valid.size
    if scale == 0:  # x = 1.0 gives cell 8 on the 8x8 map, clamped to 7; the
        # target x is relative to the clamped cell
        sel = valid & (got.batch_idx.numpy() == 0) & (got.label_slot.numpy() == 2)
        assert sel.any()
        assert (got.grid_i.numpy()[sel] == 7).all()
        np.testing.assert_allclose(got.t_xywh.numpy()[sel, 0], 1.0)


def test_conf_targets_last_write_wins():
    """Duplicate cells take the value of the highest-priority candidate,
    against a plain loop over the candidates in write order."""
    labels, mask = _labels()
    asn = assign_targets_to_scale(torch.from_numpy(labels), torch.from_numpy(mask),
                                  GRIDS[0], torch.from_numpy(ANCHORS[0]))
    values = torch.from_numpy(np.random.default_rng(3).uniform(
        size=asn.valid.shape[0]).astype(np.float32))
    got = conf_targets(asn, values, (2,) + GRIDS[0] + (3,)).numpy()
    want = np.zeros((2,) + GRIDS[0] + (3,), np.float32)
    cells = {}
    for r in np.argsort(asn.priority.numpy()):
        if asn.valid[r]:
            cell = (int(asn.batch_idx[r]), int(asn.grid_j[r]), int(asn.grid_i[r]),
                    int(asn.anchor_idx[r]))
            want[cell] = values[r]
            cells[cell] = cells.get(cell, 0) + 1
    assert max(cells.values()) >= 2  # some cell is written more than once
    np.testing.assert_array_equal(got, want)


def _preds(seed: int, b: int = 2):
    """Train-decoded per-scale predictions: logits, xy in (-0.5, 1.5), wh in
    (0, 4)."""
    rng = np.random.default_rng(seed)
    out = []
    for ny, nx in GRIDS:
        shape = (b, ny, nx, 3)
        out.append(np.concatenate([
            rng.normal(size=shape + (1 + NUM_CLASSES,)) * 2,
            rng.uniform(-0.5, 1.5, shape + (2,)),
            rng.uniform(0, 4, shape + (2,)),
        ], axis=-1).astype(np.float32))
    return out


# The focal form (1 - exp(-bce))**gamma is NaN where the BCE is negative:
# a negative CIoU conf target meeting a negative logit. The JAX package and
# the reference share this, so the focal case keeps its conf logits positive.
LOSS_CASES = {
    "plain": dict(),
    "image_mask": dict(image_mask=True),
    "label_smoothing": dict(label_smoothing=0.1, box_w=0.1, class_w=0.3),
    "focal": dict(alpha=0.25, gamma=1.5, image_mask=True, positive_conf=True),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_detection_loss_and_grad_match_jax(case):
    kw = dict(LOSS_CASES[case])
    use_mask = kw.pop("image_mask", False)
    positive_conf = kw.pop("positive_conf", False)
    labels, mask = _labels()
    preds = _preds(4)
    if positive_conf:
        for p in preds:
            p[..., 0] = np.abs(p[..., 0])
    image_mask = np.asarray([1.0, 0.0], np.float32) if use_mask else None

    jcfg = JaxLossConfig(num_classes=NUM_CLASSES, **kw)
    j_mask = None if image_mask is None else jnp.asarray(image_mask)

    @jax.jit
    def jax_fn(p):
        return jax_detection_loss(p, jnp.asarray(labels), jnp.asarray(mask),
                                  [jnp.asarray(a) for a in ANCHORS], jcfg, image_mask=j_mask)

    (want_loss, want_m), want_g = jax.value_and_grad(jax_fn, has_aux=True)(
        [jnp.asarray(p) for p in preds])

    tp = [torch.from_numpy(p.copy()).requires_grad_(True) for p in preds]
    loss, got_m = detection_loss(
        tp, torch.from_numpy(labels), torch.from_numpy(mask),
        [torch.from_numpy(a) for a in ANCHORS], DetectionLossConfig(num_classes=NUM_CLASSES, **kw),
        image_mask=None if image_mask is None else torch.from_numpy(image_mask))
    loss.backward()

    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert sorted(got_m) == sorted(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]), rtol=1e-5, atol=1e-7,
                                   equal_nan=True, err_msg=k)
    for t, w in zip(tp, want_g):
        g = t.grad.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=1e-4)
    if use_mask:  # the masked row contributes nothing
        assert all(float(np.abs(t.grad[1].numpy()).max()) == 0.0 for t in tp)
