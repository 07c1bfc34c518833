"""Mask ops, segmentation postprocess and greedy dice of the PyTorch port
against the JAX package, on random inputs made with numpy from a seed.

Tolerances: the crop, the dice functions and the coefficient gather are
exact or 1e-6 (the same f32 arithmetic); the soft masks before the
threshold agree within 1e-6, and the binary masks are equal wherever the
soft value is more than 1e-5 from the 0.5 threshold (over 99.9% of the
pixels).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vision_conglomerate_tpu.ops import masks as jax_masks
from vision_conglomerate_tpu.ops import postprocess as jax_post
from vision_conglomerate_tpu.tools.map_eval import greedy_dice as jax_greedy_dice

from vision_conglomerate_torch.ops import masks
from vision_conglomerate_torch.ops.postprocess import (
    assemble_instance_masks, in_box_grid, postprocess_detections)
from vision_conglomerate_torch.tools.map_eval import greedy_dice


def _mask_inputs(seed: int, b=2, n=5, k=6, hp=16, wp=16):
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(b, hp, wp, k)).astype(np.float32)  # NHWC, as JAX takes them
    coefs = rng.uniform(-1, 1, size=(b, n, k)).astype(np.float32)
    return protos, coefs


def _port_protos(protos_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(protos_nhwc).permute(0, 3, 1, 2)


def _assert_masks_equal_away_from_threshold(got, want, protos, coefs, og_size):
    """The soft masks (sigmoid, then the resize) agree within 1e-6, and the
    binary masks are equal wherever the soft value is more than 1e-5 from
    the 0.5 threshold (there, f32 rounding cannot decide the side)."""
    import jax

    want_soft = np.asarray(jax.image.resize(
        jax.nn.sigmoid(jnp.einsum("bhwk,bnk->bnhw", jnp.asarray(protos), jnp.asarray(coefs))),
        coefs.shape[:2] + tuple(og_size), method="linear"))
    got_soft = torch.nn.functional.interpolate(
        torch.sigmoid(torch.einsum("bkhw,bnk->bnhw", _port_protos(protos),
                                   torch.from_numpy(coefs))),
        size=og_size, mode="bilinear", align_corners=False, antialias=True).numpy()
    np.testing.assert_allclose(got_soft, want_soft, atol=1e-6, rtol=0)
    far = np.abs(want_soft - 0.5) > 1e-5
    assert far.mean() > 0.999
    np.testing.assert_array_equal(got[far], want[far])


@pytest.mark.parametrize("crop", [False, True], ids=["uncropped", "box_crop"])
@pytest.mark.parametrize("og_size", [(45, 80), (12, 9)], ids=["upsample_uneven", "downsample"])
def test_assemble_instance_masks_matches_jax(og_size, crop):
    """16x16 protos to 45x80 (an uneven upsample) and to 12x9 (a shrink,
    antialiased in both), with and without the box crop."""
    protos, coefs = _mask_inputs(0)
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 0.6, size=(2, 5, 2)) * np.asarray(og_size[::-1])
    wh = rng.uniform(0.2, 0.5, size=(2, 5, 2)) * np.asarray(og_size[::-1])
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    want = np.asarray(jax_post.assemble_instance_masks(
        jnp.asarray(protos), jnp.asarray(coefs), og_size=og_size,
        boxes_xyxy=jnp.asarray(boxes) if crop else None))
    got = assemble_instance_masks(_port_protos(protos), torch.from_numpy(coefs), og_size=og_size,
                                  boxes_xyxy=torch.from_numpy(boxes) if crop else None).numpy()
    assert got.shape == want.shape == (2, 5) + og_size and got.dtype == bool
    assert 0 < got.sum() < got.size
    _assert_masks_equal_away_from_threshold(got, want, protos, coefs, og_size)


def test_assemble_kept_rows_alone_equals_the_whole_batch():
    """The runner assembles one image's kept rows at a time: the same masks
    as the batch-wide assembly of every row, sliced."""
    protos, coefs = _mask_inputs(2)
    whole = assemble_instance_masks(_port_protos(protos), torch.from_numpy(coefs),
                                    og_size=(45, 80))
    for i in range(2):
        rows = [0, 3, 4]
        part = assemble_instance_masks(_port_protos(protos[i:i + 1]),
                                       torch.from_numpy(coefs[i:i + 1, rows]), og_size=(45, 80))
        assert torch.equal(part[0], whole[i, rows])


def test_in_box_grid_inclusive_edges():
    boxes = np.asarray([[[2.0, 3.0, 5.0, 6.0], [0.0, 0.0, 7.0, 7.0], [1.5, 1.5, 2.5, 2.5]]],
                       np.float32)
    got = in_box_grid((8, 8), torch.from_numpy(boxes)).numpy()
    want = np.asarray(jax_post.in_box_grid((8, 8), jnp.asarray(boxes)))
    np.testing.assert_array_equal(got, want)
    expect = np.zeros((8, 8), bool)
    expect[3:7, 2:6] = True  # rows 3..6 and columns 2..5, both edges in
    np.testing.assert_array_equal(got[0, 0], expect)
    assert got[0, 1].all()
    assert got[0, 2].sum() == 1 and got[0, 2, 2, 2]


def test_crop_section_and_dice_match_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, size=(6, 12, 10)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0, 10, (6, 2)), rng.uniform(1, 8, (6, 2))],
                           axis=1).astype(np.float32)
    np.testing.assert_array_equal(
        masks.crop_section(torch.from_numpy(img), torch.from_numpy(boxes)).numpy(),
        np.asarray(jax_masks.crop_section(jnp.asarray(img), jnp.asarray(boxes))))
    a = rng.uniform(-0.2, 1.2, size=(4, 3, 9, 7)).astype(np.float32)
    b = (rng.uniform(size=(4, 3, 9, 7)) > 0.5).astype(np.float32)
    valid = np.asarray([True, False, True, True, False, True])
    for rnd in (False, True):
        for x, y in ((a, b), (a[:, 0], b[:, 0])):
            np.testing.assert_allclose(
                masks.compute_dice_score(torch.from_numpy(x), torch.from_numpy(y), rnd).numpy(),
                np.asarray(jax_masks.compute_dice_score(jnp.asarray(x), jnp.asarray(y), rnd)),
                rtol=1e-6)
        p, t = a.reshape(12, 9, 7)[:6], b.reshape(12, 9, 7)[:6]
        for v in (valid, np.zeros(6, bool)):
            np.testing.assert_allclose(
                masks.masked_dice_score(torch.from_numpy(p), torch.from_numpy(t),
                                        torch.from_numpy(v), rnd).numpy(),
                np.asarray(jax_masks.masked_dice_score(jnp.asarray(p), jnp.asarray(t),
                                                       jnp.asarray(v), rnd)), rtol=1e-6)
    protos_khw = rng.normal(size=(5, 6, 4)).astype(np.float32)
    coefs = rng.normal(size=(3, 5)).astype(np.float32)
    np.testing.assert_allclose(
        masks.assemble_masks(torch.from_numpy(protos_khw), torch.from_numpy(coefs)).numpy(),
        np.asarray(jax_masks.assemble_masks(jnp.asarray(protos_khw.transpose(1, 2, 0)),
                                            jnp.asarray(coefs))), rtol=1e-5, atol=1e-6)


def test_postprocess_gathers_the_kept_coefficients():
    rng = np.random.default_rng(7)
    b, m, c, k = 2, 300, 3, 4
    preds = np.concatenate([
        rng.normal(size=(b, m, 1 + c)),
        rng.uniform(20, 200, size=(b, m, 2)),
        rng.uniform(5, 60, size=(b, m, 2)),
        rng.uniform(-1, 1, size=(b, m, k))], axis=-1).astype(np.float32)
    kw = dict(num_classes=c, num_masks=k, iou_threshold=0.35, score_threshold=0.1,
              box_allowance=4.0, max_detections=100)
    want = jax_post.postprocess_detections(jnp.asarray(preds), **kw)
    got = postprocess_detections(torch.from_numpy(preds), **kw)
    v = np.asarray(want.valid)
    assert v.sum() > 10
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert got.mask_coefs.shape == (b, 100, k)
    np.testing.assert_array_equal(got.mask_coefs.numpy()[v], np.asarray(want.mask_coefs)[v])
    none = postprocess_detections(torch.from_numpy(preds[..., :5 + c]), num_classes=c)
    assert none.mask_coefs.shape == none.valid.shape + (0,)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_dice_matches_jax(seed):
    rng = np.random.default_rng(seed)
    per_image = []
    for _ in range(4):
        n, m = int(rng.integers(0, 6)), int(rng.integers(0, 5))
        iou = rng.uniform(size=(n, m)).astype(np.float32)
        dice = (2 * iou / (1 + iou)).astype(np.float32)
        per_image.append((iou, dice, rng.uniform(size=n).astype(np.float32),
                          rng.integers(0, 2, n), rng.integers(0, 2, m)))
    got, want = greedy_dice(per_image), jax_greedy_dice(per_image)
    assert got == want
    assert want["num_gt"] > 0
