"""The keypoint branch of the PyTorch port against the JAX package, module by
module, in f32 on the CPU: labels and their +inf-padded batches, the flip,
the head and its decode (train and deploy forms, in training and at
inference), the og-size rescale, the assigner's extras, the keypoint loss
with its gradients, postprocess, PCK, drawing and the int8 form.

The net is tests/test_torch_weights's small config (width 0.25, depth 0.2,
64x64) with 2 keypoints and keypoints_fmap_depth 2, its weights and
BatchNorm state drawn by the port from a seed and bridged to the JAX
package with `weights.state_dict_to_flax` (the JAX net is applied, never
initialised). Tolerances: elementwise math and the data 1e-6; the loss,
its metrics 1e-5 and its gradients atol 1e-6 / rtol 1e-4 (reductions in
another order); whole nets atol 2e-3 / rtol 1e-3, as
tests/test_torch_detection.py (decoded keypoints are in pixels); PCK and
pixels exactly; int8 as tests/test_torch_int8_detection.py.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from vision_conglomerate_tpu.data import DetectionDataset as JaxDetectionDataset
from vision_conglomerate_tpu.losses import DetectionLossConfig as JaxLossConfig
from vision_conglomerate_tpu.losses import detection_loss as jax_detection_loss
from vision_conglomerate_tpu.losses.assigner import assign_targets_to_scale as jax_assign
from vision_conglomerate_tpu.models import DetectionNet as JaxDetectionNet
from vision_conglomerate_tpu.models import detection as jax_detection
from vision_conglomerate_tpu.nn.blocks import bn_folding, fused_pointwise
from vision_conglomerate_tpu.nn.reparam import deploy_transform as jax_deploy_transform
from vision_conglomerate_tpu.ops.postprocess import postprocess_detections as jax_postprocess
from vision_conglomerate_tpu.ops.preprocess import random_hflip as jax_random_hflip
from vision_conglomerate_tpu.tools import map_eval as jax_map_eval
from vision_conglomerate_tpu.utils.drawing import apply_keypoints as jax_apply_keypoints

from vision_conglomerate_torch.data.detection import DetectionDataset
from vision_conglomerate_torch.losses import DetectionLossConfig, detection_loss
from vision_conglomerate_torch.losses.assigner import assign_targets_to_scale
from vision_conglomerate_torch.models import detection
from vision_conglomerate_torch.models.detection import DetectionNet
from vision_conglomerate_torch.nn import quantize
from vision_conglomerate_torch.nn.blocks import init_weights_, randomize_batchnorm_
from vision_conglomerate_torch.nn.reparam import deploy_transform
from vision_conglomerate_torch.ops.postprocess import postprocess_detections
from vision_conglomerate_torch.ops.preprocess import random_hflip
from vision_conglomerate_torch.tools import map_eval
from vision_conglomerate_torch.utils.drawing import apply_keypoints
from vision_conglomerate_torch.weights import flax_to_state_dict, state_dict_to_flax

from tests import test_torch_int8_detection as int8_tests
from tests.test_torch_loss import ANCHORS as LOSS_ANCHORS
from tests.test_torch_loss import NUM_CLASSES as LOSS_CLASSES
from tests.test_torch_loss import GRIDS, _labels
from tests.test_torch_loss import _preds as _box_preds
from tests.test_torch_weights import ANCHORS, CONFIG, NUM_CLASSES, flat, to_numpy

KP = 2
KP_CONFIG = {**CONFIG, "effidechead_config": {"width_multiple": 0.5, "keypoints_fmap_depth": 2}}
SIZE = 64
NET_TOL = dict(atol=2e-3, rtol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_kp_net(seed: int = 0, **kwargs) -> DetectionNet:
    """The keypoint net with weights and BatchNorm state from a seed."""
    g = torch.Generator().manual_seed(seed)
    net = DetectionNet(NUM_CLASSES, KP_CONFIG, anchors=ANCHORS, num_keypoints=KP, device="cpu",
                       **kwargs)
    return randomize_batchnorm_(init_weights_(net, g), g).eval()


def jax_kp_net(deploy: bool = False) -> JaxDetectionNet:
    return JaxDetectionNet(num_classes=NUM_CLASSES, config=KP_CONFIG, anchors=ANCHORS,
                           num_keypoints=KP, deploy=deploy)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


# ------------------------------------------------------------------ data
KP_ROWS = {
    "kp2": "0 0.5 0.5 0.4 0.4 0.45 0.45 0 0.55 0.55 1\n"
           "1 0.25 0.3 0.2 0.3 0.1 0.1 2 0.3 0.35 2\n",
    "kp1": "1 0.6 0.4 0.3 0.2 0.7 0.45 1\n",
    "none": "",
}


def order_of(first: str):
    return [first] + [k for k in KP_ROWS if k != first]


def _write_kp_dir(root, first: str):
    """Three 64x64 images: rows with 2 keypoints, a file whose one row has
    1 keypoint (ragged), and an empty file; `first` picks which file the
    column sniffing reads first."""
    rows = KP_ROWS
    order = order_of(first)
    os.makedirs(root)
    rng = np.random.default_rng(0)
    for i, key in enumerate(order):
        img = rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"img_{i}.png"))
        with open(os.path.join(root, f"img_{i}.txt"), "w") as f:
            f.write(rows[key])


@pytest.mark.parametrize("first", ["kp2", "kp1"])
def test_dataset_rows_and_padding_match_jax(tmp_path, first):
    """Bbox-relative keypoints clipped to [0, 1], num_keypoints by the
    first non-empty file, and a batch padded with +inf in the keypoint
    columns (0 in the box columns), equal to the JAX package's."""
    root = str(tmp_path / "kp")
    _write_kp_dir(root, first)
    got = DetectionDataset(root, img_wh=(SIZE, SIZE), max_labels=4)
    want = JaxDetectionDataset(root, img_wh=(SIZE, SIZE), max_labels=4)
    assert got.num_label_cols == want.num_label_cols == (11 if first == "kp2" else 8)
    assert got.num_keypoints == want.num_keypoints == (2 if first == "kp2" else 1)
    items = [got[i] for i in range(3)]
    for i, (img, lab) in enumerate(items):
        w_img, w_lab = want[i]
        np.testing.assert_array_equal(img, w_img)
        assert lab.dtype == w_lab.dtype == np.float32
        np.testing.assert_allclose(lab, w_lab, atol=1e-6, rtol=0)
    kp2 = items[order_of(first).index("kp2")][1][:, 5:].reshape(-1, KP, 3)
    # (0.45, 0.45) in the box 0.3..0.7 -> (0.375, 0.375); the second row's
    # first keypoint lies outside its box and is clipped to 0
    np.testing.assert_allclose(kp2[0, 0, :2], [0.375, 0.375], atol=1e-6)
    np.testing.assert_allclose(kp2[1, 0, :2], [0.0, 0.0], atol=1e-6)
    batch, w_batch = got.collate_fn(items), want.collate_fn([want[i] for i in range(3)])
    for g, w in zip(batch, w_batch):
        np.testing.assert_array_equal(g, w)
    labels, mask = batch[1], batch[2]
    assert labels.shape == (3, 4, 11)
    assert np.isinf(labels[..., 5:][~mask]).all() and (labels[..., :5][~mask] == 0).all()
    row = labels[order_of(first).index("kp1"), 0]  # the ragged row: one keypoint
    assert np.isfinite(row[:8]).all() and np.isinf(row[8:]).all()


@pytest.mark.parametrize("prob", [0.0, 1.0])
def test_random_hflip_mirrors_keypoints_as_jax(prob):
    """Box x and each keypoint's bbox-relative x mirror (the +inf padding
    turns into -inf, still dropped by the loss), images flip; at prob 0
    and 1 the draws do not matter."""
    rng = np.random.default_rng(5)
    imgs = rng.uniform(size=(2, 8, 12, 3)).astype(np.float32)
    labels = rng.uniform(size=(2, 4, 5 + 3 * KP)).astype(np.float32)
    labels[1, 2:, 5:] = np.inf
    labels[0, 3, 8:] = np.inf
    got_i, got_l = random_hflip(torch.Generator().manual_seed(0), torch.from_numpy(imgs),
                                torch.from_numpy(labels), prob=prob)
    want_i, want_l = jax_random_hflip(jax.random.PRNGKey(0), jnp.asarray(imgs),
                                      jnp.asarray(labels), prob=prob)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-6, rtol=0)
    if prob == 1.0:
        np.testing.assert_allclose(got_l[0, 0, 5].item(), 1.0 - labels[0, 0, 5], atol=1e-6)
        assert np.isneginf(got_l.numpy()[1, 2:, 5::3]).all()


# --------------------------------------------------------- head and decode
@pytest.fixture(scope="module")
def kp_case():
    """A seeded keypoint net, its bridged JAX variables and a 64x64 batch."""
    net = port_kp_net(seed=21)
    x = np.random.default_rng(22).uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    return net, to_numpy(state_dict_to_flax(net.state_dict())), x


def test_weight_bridge_covers_the_keypoint_branch(kp_case):
    """The bridged tree has the JAX net's keys and shapes
    (keypoints_fmap_layer_i, keypoints_layer), and maps back."""
    net, variables, x = kp_case
    shapes = jax.eval_shape(lambda: jax_kp_net().init(jax.random.PRNGKey(0),
                                                       jnp.zeros((1, SIZE, SIZE, 3)),
                                                       train=False))
    want = {k: v.shape for k, v in flat(to_numpy(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))).items()}
    got = {k: np.shape(v) for k, v in flat(variables).items()}
    assert got == want
    assert ("params", "head_0", "keypoints_fmap_layer_1", "conv", "kernel") in got
    assert want[("params", "head_2", "keypoints_layer", "kernel")][-1] == 3 * 5 * KP
    back = flax_to_state_dict(variables)
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k


def _jax_apply(variables, x, deploy, **kw):
    if not deploy:
        return jax_kp_net().apply(variables, jnp.asarray(x), train=False, **kw)
    dp, ds = jax_deploy_transform(variables["params"], variables["batch_stats"])
    with bn_folding(), fused_pointwise():
        return jax_kp_net(deploy=True).apply(
            {"params": dp, **({"batch_stats": ds} if ds else {})}, jnp.asarray(x),
            train=False, **kw)


def _port_net(net, deploy):
    if not deploy:
        return net
    dep = DetectionNet(NUM_CLASSES, KP_CONFIG, anchors=ANCHORS, num_keypoints=KP, deploy=True,
                       folded=True, device="cpu")
    dep.load_state_dict(deploy_transform(net.state_dict()))
    return dep.eval()


@pytest.mark.parametrize("inference", [False, True], ids=["training", "inference"])
@pytest.mark.parametrize("form", ["train", "deploy"])
def test_keypoint_net_matches_jax(kp_case, form, inference):
    """Per-scale train decodes (inference False) or the flattened
    inference decode, keypoint columns included, in the train form and the
    deploy form (the JAX package's under bn_folding + fused_pointwise)."""
    net, variables, x = kp_case
    deploy = form == "deploy"
    want = _jax_apply(variables, x, deploy, inference=inference)
    with torch.no_grad():
        got = _port_net(net, deploy)(_nchw(x), inference=inference)
    got = [got] if inference else list(got)
    want = [want] if inference else list(want)
    d = 5 + NUM_CLASSES + 5 * KP
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[-1] == d
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **NET_TOL)
    kp = got[0].numpy()[..., 5 + NUM_CLASSES:].reshape(*got[0].shape[:-1], KP, 5)
    if inference:  # inside the decoded box, in pixels
        xy, wh = got[0].numpy()[..., 1 + NUM_CLASSES:3 + NUM_CLASSES], \
            got[0].numpy()[..., 3 + NUM_CLASSES:5 + NUM_CLASSES]
        lo, hi = xy - wh / 2, xy + wh / 2
        assert ((kp[..., :2] >= lo[..., None, :] - 1e-3)
                & (kp[..., :2] <= hi[..., None, :] + 1e-3)).all()
    else:  # bbox-relative
        assert ((kp[..., :2] >= 0) & (kp[..., :2] <= 1)).all()


@pytest.mark.parametrize("og_size", [(80, 96), (64, 96)], ids=["both_differ", "one_differs"])
def test_og_size_rescale_matches_jax(kp_case, og_size):
    """The deploy net's rescale to og_size moves keypoint xy with the boxes
    and leaves the visibility logits; it fires only when both dims differ."""
    net, variables, x = kp_case
    want = np.asarray(_jax_apply(variables, x, True, inference=True, og_size=og_size))
    with torch.no_grad():
        dep = _port_net(net, True)
        got = dep(_nchw(x), inference=True, og_size=og_size).numpy()
        plain = dep(_nchw(x), inference=True).numpy()
    np.testing.assert_allclose(got, want, **NET_TOL)
    kp, kp0 = (a[..., 5 + NUM_CLASSES:].reshape(*a.shape[:-1], KP, 5) for a in (got, plain))
    if og_size == (64, 96):
        np.testing.assert_array_equal(got, plain)
    else:
        np.testing.assert_allclose(kp[..., 0], kp0[..., 0] * 96 / 64, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(kp[..., 1], kp0[..., 1] * 80 / 64, rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(kp[..., 2:], kp0[..., 2:])


@pytest.mark.parametrize("num_masks", [0, 4], ids=["detection", "with_masks"])
@pytest.mark.parametrize("inference", [False, True], ids=["training", "inference"])
def test_decode_and_rescale_functions_match_jax(num_masks, inference):
    """decode_scale and rescale_preds_to_size on a non-square grid (the
    [h/ny, w/nx] stride quirk shows), with mask coefficients between the
    box and the keypoints."""
    rng = np.random.default_rng(7)
    d = 5 + NUM_CLASSES + num_masks + 5 * KP
    pred = (rng.normal(size=(2, 4, 6, 3, d)) * 2).astype(np.float32)
    anchors = np.asarray(ANCHORS["md"], np.float32)
    want = jax_detection.decode_scale(jnp.asarray(pred), jnp.asarray(anchors), (64, 128),
                                      NUM_CLASSES, num_masks=num_masks, num_keypoints=KP,
                                      inference=inference)
    got = detection.decode_scale(torch.from_numpy(pred), torch.from_numpy(anchors), (64, 128),
                                 NUM_CLASSES, num_masks, KP, inference=inference)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)
    flat_pred = got.reshape(2, -1, d)
    want = jax_detection.rescale_preds_to_size(jnp.asarray(flat_pred.numpy()), (128, 64),
                                               (1280, 720), NUM_CLASSES, num_masks=num_masks)
    got = detection.rescale_preds_to_size(flat_pred, (128, 64), (1280, 720), NUM_CLASSES, KP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-5)


# ------------------------------------------------------------------ loss
def _kp_labels(seed: int = 9):
    """test_torch_loss's labels with 2 keypoints a row: bbox-relative xy,
    vis in {0, 1, 2}, one row with its second keypoint +inf (ragged), and
    +inf in every padded slot's keypoint columns."""
    labels, mask = _labels()
    rng = np.random.default_rng(seed)
    kp = np.stack([rng.uniform(size=labels.shape[:2] + (KP,)),
                   rng.uniform(size=labels.shape[:2] + (KP,)),
                   rng.integers(0, 3, labels.shape[:2] + (KP,))], axis=-1).astype(np.float32)
    kp[~mask] = np.inf
    kp[0, 1, 1] = np.inf
    return np.concatenate([labels, kp.reshape(*labels.shape[:2], -1)], axis=-1), mask


def _kp_preds(seed: int):
    """Train-decoded per-scale predictions with keypoints: xy in (0, 1),
    visibility logits."""
    rng = np.random.default_rng(seed + 100)
    out = []
    for p in _box_preds(seed):
        kp = np.concatenate([rng.uniform(size=p.shape[:-1] + (KP, 2)),
                             rng.normal(size=p.shape[:-1] + (KP, 3)) * 2], axis=-1)
        out.append(np.concatenate([p, kp.reshape(*p.shape[:-1], -1)], axis=-1).astype(np.float32))
    return out


@pytest.mark.parametrize("scale", range(3))
def test_assigner_keypoint_extras_match_jax(scale):
    labels, mask = _kp_labels()
    got = assign_targets_to_scale(torch.from_numpy(labels), torch.from_numpy(mask), GRIDS[scale],
                                  torch.from_numpy(LOSS_ANCHORS[scale]))
    want = jax_assign(jnp.asarray(labels), jnp.asarray(mask), GRIDS[scale],
                      jnp.asarray(LOSS_ANCHORS[scale]))
    for field in want._fields:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    # each candidate carries its source row's keypoint columns, +inf included
    src = labels[got.batch_idx.numpy(), got.label_slot.numpy(), 5:]
    np.testing.assert_array_equal(got.keypoints.numpy(), src)
    assert got.valid.numpy().any() and np.isinf(src).any()


KP_LOSS_CASES = {
    "plain": dict(),
    "shipped_weights": dict(keypoints_w=5.0, box_w=0.1, class_w=0.3, label_smoothing=0.001),
    "image_mask": dict(image_mask=True, keypoints_w=2.0),
}


@pytest.mark.parametrize("case", sorted(KP_LOSS_CASES))
def test_keypoint_loss_metrics_and_grad_match_jax(case):
    kw = dict(KP_LOSS_CASES[case])
    image_mask = np.asarray([1.0, 0.0], np.float32) if kw.pop("image_mask", False) else None
    labels, mask = _kp_labels()
    preds = _kp_preds(4)
    jcfg = JaxLossConfig(num_classes=LOSS_CLASSES, num_keypoints=KP, **kw)
    j_mask = None if image_mask is None else jnp.asarray(image_mask)

    @jax.jit
    def jax_fn(p):
        return jax_detection_loss(p, jnp.asarray(labels), jnp.asarray(mask),
                                  [jnp.asarray(a) for a in LOSS_ANCHORS], jcfg, image_mask=j_mask)

    (want_loss, want_m), want_g = jax.value_and_grad(jax_fn, has_aux=True)(
        [jnp.asarray(p) for p in preds])
    tp = [torch.from_numpy(p.copy()).requires_grad_(True) for p in preds]
    loss, got_m = detection_loss(
        tp, torch.from_numpy(labels), torch.from_numpy(mask),
        [torch.from_numpy(a) for a in LOSS_ANCHORS],
        DetectionLossConfig(num_classes=LOSS_CLASSES, num_keypoints=KP, **kw),
        image_mask=None if image_mask is None else torch.from_numpy(image_mask))
    loss.backward()
    assert {"kpv_loss", "kpc_loss", "kp_loss"} <= set(got_m)
    assert sorted(got_m) == sorted(want_m)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]), rtol=1e-5, atol=1e-7,
                                   equal_nan=True, err_msg=k)
    assert got_m["kp_loss"].item() > 0
    for t, w in zip(tp, want_g):
        g = t.grad.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=1e-4)
    # the keypoint columns get gradient (and only from matched cells)
    assert any(np.abs(t.grad.numpy()[..., 5 + LOSS_CLASSES:]).max() > 0 for t in tp)


# ------------------------------------------------------------ postprocess
def test_postprocess_keypoints_match_jax():
    """(x, y, argmax of the visibility logits) of the rows NMS kept."""
    rng = np.random.default_rng(11)
    b, m, c = 2, 300, 3
    preds = np.concatenate([
        rng.normal(size=(b, m, 1 + c)),
        rng.uniform(20, 200, size=(b, m, 2)),
        rng.uniform(5, 60, size=(b, m, 2)),
        rng.normal(size=(b, m, 5 * KP)) * 40], axis=-1).astype(np.float32)
    kw = dict(num_classes=c, num_keypoints=KP, iou_threshold=0.35, score_threshold=0.1,
              box_allowance=4.0, max_detections=100)
    want = jax_postprocess(jnp.asarray(preds), **kw)
    got = postprocess_detections(torch.from_numpy(preds), **kw)
    v = np.asarray(want.valid)
    assert v.sum() > 10
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert got.keypoints.shape == (b, 100, KP, 3) == np.asarray(want.keypoints).shape
    np.testing.assert_array_equal(got.keypoints.numpy()[v], np.asarray(want.keypoints)[v])
    vis = got.keypoints.numpy()[v][..., 2]
    assert set(np.unique(vis)) <= {0.0, 1.0, 2.0} and len(np.unique(vis)) == 3
    none = postprocess_detections(torch.from_numpy(preds[..., :5 + c]), num_classes=c)
    assert none.keypoints.shape == none.valid.shape + (0, 3)


# ------------------------------------------------------------------- PCK
def _pck_rows(seed: int):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(5):
        n, m = int(rng.integers(0, 6)), int(rng.integers(0, 5))
        gkp = np.concatenate([rng.uniform(0, 64, (m, KP, 2)),
                              rng.integers(0, 3, (m, KP, 1))], axis=-1).astype(np.float32)
        if m:
            gkp[0, -1] = np.inf  # a padded slot
        pkp = np.concatenate([rng.uniform(0, 64, (n, KP, 2)),
                              rng.integers(0, 3, (n, KP, 1))], axis=-1).astype(np.float32)
        if n and m:  # some predictions land on their ground truth
            k = min(n, m)
            pkp[:k, :, :2] = gkp[:k, :, :2] + rng.normal(0, 2, (k, KP, 2))
            pkp[:k][~np.isfinite(pkp[:k])] = 0.0
        rows.append((rng.uniform(0, 1, (n, m)).astype(np.float32),
                     rng.uniform(size=n).astype(np.float32), rng.integers(0, 2, n),
                     rng.integers(0, 2, m), pkp, gkp,
                     rng.uniform(10, 40, (m, 2)).astype(np.float32)))
    return rows


@pytest.mark.parametrize("r", [0.1, 0.3])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_compute_pck_matches_jax(seed, r):
    rows = _pck_rows(seed)
    got = map_eval.compute_pck(rows, r=r, iou_threshold=0.5)
    want = jax_map_eval.compute_pck(rows, r=r, iou_threshold=0.5)
    assert got == want
    assert got["num_visible_keypoints"] >= got["num_matched_keypoints"]


def test_compute_pck_oracle_case():
    """The JAX package's oracle (tests/test_keypoints.py): perfect
    keypoints score 1 on the matched instance, 2/3 overall; far ones 0."""
    iou = np.asarray([[0.9, 0.0]], np.float32)
    scores = np.asarray([0.8], np.float32)
    pc, gc = np.asarray([0]), np.asarray([0, 0])
    gkp = np.asarray([[[10.0, 10.0, 2], [20.0, 20.0, 2]],
                      [[50.0, 50.0, 2], [0.0, 0.0, 0]]], np.float32)
    pkp = np.asarray([[[10.5, 10.0, 2], [20.0, 19.5, 2]]], np.float32)
    gwh = np.asarray([[30.0, 30.0], [10.0, 10.0]], np.float32)
    res = map_eval.compute_pck([(iou, scores, pc, gc, pkp, gkp, gwh)], r=0.1)
    assert res == jax_map_eval.compute_pck([(iou, scores, pc, gc, pkp, gkp, gwh)], r=0.1)
    assert res["pck"] == pytest.approx(2 / 3) and res["pck_matched"] == pytest.approx(1.0)
    assert map_eval.compute_pck([(iou, scores, pc, gc, pkp + 25.0, gkp, gwh)])["pck"] == 0.0


# ---------------------------------------------------------------- drawing
def test_apply_keypoints_pixel_equal():
    """Dots of radius 3 coloured by visibility class, class 2 skipped, on
    uint8 and on [0, 1] float images, pixel for pixel the JAX package's."""
    rng = np.random.default_rng(13)
    kps = np.concatenate([rng.uniform(-5, 69, (12, 2)), rng.integers(0, 3, (12, 1))], axis=-1)
    for img in (rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8),
                rng.uniform(size=(SIZE, SIZE, 3)).astype(np.float32)):
        got = apply_keypoints(img.copy(), kps)
        want = jax_apply_keypoints(img.copy(), kps)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    blank = np.zeros((SIZE, SIZE, 3), np.uint8)
    drawn = apply_keypoints(blank, np.asarray([[10, 10, 0], [30, 30, 1], [50, 50, 2]]))
    assert tuple(drawn[10, 10]) == (255, 255, 255) and tuple(drawn[30, 30]) == (255, 255, 100)
    assert not drawn[45:56, 45:56].any()


# ------------------------------------------------------------------- int8
@pytest.fixture(scope="module")
def int8_case():
    train_form = port_kp_net(seed=31)
    x = np.random.default_rng(32).uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    return int8_tests.Case(
        "keypoints",
        lambda: DetectionNet(NUM_CLASSES, KP_CONFIG, anchors=ANCHORS, num_keypoints=KP,
                             deploy=True, folded=True, device="cpu"),
        jax_kp_net(deploy=True), deploy_transform(train_form.state_dict()), x, inference=True)


def test_int8_quantizes_the_keypoint_convs_as_jax(int8_case):
    """The quantized convs are the JAX package's, the keypoint branch's
    3x3 ConvBNorms among them; keypoints_layer stays float like the other
    head 1x1 layers."""
    net, _ = int8_tests.assert_quantized_sets_match(int8_case)
    q = [p for p, m in quantize.quantizable_modules(net).items() if hasattr(m, "q_kernel")]
    assert sum("keypoints_fmap_layer" in p for p in q) == 3 * 2
    assert not any("keypoints_layer" in p for p in q)


@pytest.mark.parametrize("check", ["scales", "layers", "forward", "near_f32", "bridge"])
def test_int8_keypoint_net_matches_jax(int8_case, check):
    """Calibration and q parameters, every int8 conv on the JAX net's own
    input (1e-6), the net run free with the JAX package's q parameters
    (2e-2), the port's int8 against its f32 deploy form (2e-2) and the
    int8 weight bridge, as tests/test_torch_int8_detection.py holds the
    detector."""
    {"scales": int8_tests.assert_scales_match, "layers": int8_tests.assert_layers_match,
     "forward": int8_tests.assert_forward_matches, "near_f32": int8_tests.assert_near_f32,
     "bridge": int8_tests.assert_bridge_roundtrips}[check](int8_case)
