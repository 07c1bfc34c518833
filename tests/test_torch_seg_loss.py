"""The segmentation loss of the PyTorch port against the JAX package's
`segmentation_loss`, value and gradient, in f32 on the CPU.

Inputs are made with numpy from a seed: train-decoded predictions at the
three scales of a 64x64 input, NCHW protos (NHWC on the JAX side), labels
with inf-padded rows and one image without labels, and target masks at
4x the protos' size, so the half-pixel nearest resize runs. Cases: overlap
masks on and off, crop_mode reference and corrected, cap_policy first and
area with a cap below the candidate count (every candidate of one label
shares its box, so areas tie) and with a cap above it (selected slots
gather padded rows). The "random" policy cannot match JAX's bits and is
held by its properties.

Tolerances: the loss and every metric rtol 1e-5; gradients with respect
to the predictions and the protos atol 1e-6 / rtol 1e-4 (the same f32
arithmetic, summed in another order).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vision_conglomerate_tpu.losses import SegmentationLossConfig as JaxSegLossConfig
from vision_conglomerate_tpu.losses import segmentation_loss as jax_segmentation_loss

from vision_conglomerate_torch.losses import SegmentationLossConfig, segmentation_loss
from vision_conglomerate_torch.losses.segmentation_loss import (
    _candidate_priority, _nearest_to, _select_top_candidates, seg_scale_loss)

from tests.test_torch_weights import ANCHORS

B, M, A, C, K = 3, 6, 3, 2, 4
HP = 16
GRIDS = ((8, 8), (4, 4), (2, 2))


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def make_inputs(seed: int, overlap: bool):
    rng = np.random.default_rng(seed)
    preds = []
    for ny, nx in GRIDS:
        r = rng.normal(size=(B, ny, nx, A, 5 + C + K)).astype(np.float32)
        r[..., 1 + C:3 + C] = _sigmoid(r[..., 1 + C:3 + C]) * 2 - 0.5
        r[..., 3 + C:5 + C] = (_sigmoid(r[..., 3 + C:5 + C]) * 2) ** 2
        r[..., 5 + C:] = np.tanh(r[..., 5 + C:] * 2)
        preds.append(r)
    protos = rng.normal(size=(B, K, HP, HP)).astype(np.float32)
    n_labels = [5, 2, 0]  # the last image has no labels
    labels = np.full((B, M, 5), np.inf, np.float32)
    labels[..., 0] = 0
    mask = np.zeros((B, M), bool)
    for b, n in enumerate(n_labels):
        wh = rng.uniform(0.1, 0.5, size=(n, 2))
        if n:
            wh[1:3] = wh[0]  # equal boxes: their areas tie
        xy = rng.uniform(0.25, 0.75, size=(n, 2))
        labels[b, :n] = np.concatenate([rng.integers(0, C, (n, 1)), xy, wh], 1)
        mask[b, :n] = True
    hm = 4 * HP
    ids = rng.integers(0, M + 1, size=(B, hm, hm)).astype(np.uint8)
    if overlap:
        tmasks = ids
    else:
        tmasks = (ids[:, None] == np.arange(1, M + 1)[None, :, None, None]).astype(np.uint8)
    return preds, protos, labels, mask, tmasks


CASES = {
    "overlap_reference_first": dict(overlap=True, crop_mode="reference", cap_policy="first",
                                    cap=4),
    "overlap_corrected_area": dict(overlap=True, crop_mode="corrected", cap_policy="area", cap=4),
    "no_overlap_reference_area": dict(overlap=False, crop_mode="reference", cap_policy="area",
                                      cap=7),
    "no_overlap_corrected_first": dict(overlap=False, crop_mode="corrected",
                                       cap_policy="first", cap=4),
    "overlap_cap_above_candidates": dict(overlap=True, crop_mode="reference",
                                         cap_policy="first", cap=32),
}
LOSS_KW = dict(num_classes=C, box_w=0.1, class_w=0.3, label_smoothing=0.001, seg_w=1.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_value_and_gradient_match_jax(case):
    spec = CASES[case]
    preds, protos, labels, mask, tmasks = make_inputs(sorted(CASES).index(case), spec["overlap"])
    kw = dict(LOSS_KW, overlap_masks=spec["overlap"], crop_mode=spec["crop_mode"],
              cap_policy=spec["cap_policy"], seg_candidates_per_image=spec["cap"])
    anchors = [np.asarray(ANCHORS[k], np.float32) for k in ("sm", "md", "lg")]

    def jax_loss(p, pr):
        return jax_segmentation_loss(p, jnp.asarray(labels), jnp.asarray(mask), pr,
                                     jnp.asarray(tmasks), [jnp.asarray(a) for a in anchors],
                                     JaxSegLossConfig(**kw))

    jp = [jnp.asarray(p) for p in preds]
    jpr = jnp.asarray(protos.transpose(0, 2, 3, 1))
    (want_loss, want_metrics), (want_gp, want_gpr) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jp, jpr)

    tp = [torch.from_numpy(p).requires_grad_() for p in preds]
    tpr = torch.from_numpy(protos).requires_grad_()
    loss, metrics = segmentation_loss(tp, torch.from_numpy(labels), torch.from_numpy(mask), tpr,
                                      torch.from_numpy(tmasks),
                                      [torch.from_numpy(a) for a in anchors],
                                      SegmentationLossConfig(**kw))
    loss.backward()
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    assert metrics["seg_loss"].item() > 0
    if spec["cap"] == 4:  # the cap is binding
        assert metrics["seg_dropped_candidates"].item() > 0
    for g, w in zip(tp, want_gp):
        assert torch.isfinite(g.grad).all()
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), atol=1e-6, rtol=1e-4)
    assert torch.isfinite(tpr.grad).all() and tpr.grad.abs().sum() > 0
    np.testing.assert_allclose(tpr.grad.numpy(), np.asarray(want_gpr).transpose(0, 3, 1, 2),
                               atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("src,dst", [(64, 16), (10, 16), (48, 20)])
def test_half_pixel_nearest_matches_jax(src, dst):
    """F.interpolate "nearest-exact" is jax.image.resize "nearest":
    source index floor((i + 1/2) * in / out), row 4i + 2 at 64 -> 16."""
    x = np.random.default_rng(src).integers(0, 9, size=(2, src, src + 3)).astype(np.uint8)
    want = np.asarray(jax.image.resize(jnp.asarray(x, jnp.float32), (2, dst, dst + 1),
                                       method="nearest"))
    got = _nearest_to(torch.from_numpy(x), (dst, dst + 1)).numpy()
    np.testing.assert_array_equal(got, want)
    stack = np.stack([x, x + 1], axis=1)
    np.testing.assert_array_equal(_nearest_to(torch.from_numpy(stack), (dst, dst + 1)).numpy(),
                                  np.stack([want, want + 1], axis=1))
    if src == 64:
        np.testing.assert_array_equal(got, x[:, 2::4][:, :, (np.arange(17) * (67 / 17) + 67 / 34)
                                                       .astype(int)])


def _selection(cfg, valid, t_xywh, gen):
    """Which candidate indices each image keeps under cfg's policy."""
    idx = torch.arange(valid.shape[1]).expand(valid.shape)
    (kept,), kept_valid = _select_top_candidates(
        [idx], valid, _candidate_priority(cfg, valid, t_xywh, gen), cfg.seg_candidates_per_image)
    return [set(k[v].tolist()) for k, v in zip(kept, kept_valid)]


def test_random_cap_policy_properties():
    """At most `cap` rows kept per image and only valid ones; over steps
    every valid candidate is kept at some point; the same generator state
    gives the same selection and the same loss."""
    rng = np.random.default_rng(5)
    valid = torch.from_numpy(rng.uniform(size=(2, 40)) < 0.5)
    t_xywh = torch.from_numpy(rng.uniform(size=(2, 40, 4)).astype(np.float32))
    cfg = SegmentationLossConfig(cap_policy="random", seg_candidates_per_image=5)
    gen = torch.Generator().manual_seed(0)
    seen = [set(), set()]
    for _ in range(60):
        for b, kept in enumerate(_selection(cfg, valid, t_xywh, gen)):
            assert len(kept) <= 5 and kept <= set(torch.nonzero(valid[b])[:, 0].tolist())
            seen[b] |= kept
    for b in range(2):
        assert seen[b] == set(torch.nonzero(valid[b])[:, 0].tolist())
    a, b_ = (_selection(cfg, valid, t_xywh, torch.Generator().manual_seed(3)) for _ in range(2))
    assert a == b_

    preds, protos, labels, mask, tmasks = make_inputs(9, True)
    anchors = [torch.tensor(ANCHORS[k]) for k in ("sm", "md", "lg")]
    cfg = SegmentationLossConfig(**LOSS_KW, cap_policy="random", seg_candidates_per_image=3)

    def loss(gen):
        return segmentation_loss([torch.from_numpy(p) for p in preds], torch.from_numpy(labels),
                                 torch.from_numpy(mask), torch.from_numpy(protos),
                                 torch.from_numpy(tmasks), anchors, cfg, generator=gen)[0].item()

    gen = torch.Generator().manual_seed(7)
    first, second = loss(gen), loss(gen)
    assert first != second  # a fresh draw each step
    assert loss(torch.Generator().manual_seed(7)) == first


def test_image_mask_drops_rows_from_the_seg_terms():
    """A masked row contributes nothing, and the per-image means divide by
    the valid rows: the loss of rows (0, 1) with row 2 masked equals the
    loss over a batch of those two rows alone."""
    preds, protos, labels, mask, tmasks = make_inputs(4, True)
    cfg = SegmentationLossConfig(**LOSS_KW, cap_policy="first", seg_candidates_per_image=8)
    anchors = torch.tensor(ANCHORS["sm"])
    t = torch.from_numpy
    full = seg_scale_loss(t(preds[0]), t(labels), t(mask), t(protos), t(tmasks), anchors, cfg,
                          image_mask=torch.tensor([1.0, 1.0, 0.0]))
    two = seg_scale_loss(t(preds[0][:2]), t(labels[:2]), t(mask[:2]), t(protos[:2]),
                         t(tmasks[:2]), anchors, cfg)
    for key in ("seg", "box", "class"):
        np.testing.assert_allclose(full[0][key].item(), two[0][key].item(), rtol=1e-6)
    np.testing.assert_allclose(full[1]["dice_score"].item(), two[1]["dice_score"].item(),
                               rtol=1e-6)
