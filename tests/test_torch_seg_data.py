"""Segmentation data of the PyTorch port against the JAX package: the
polygon label functions, SegmentationDataset items and collate_fn (with and
without overlap masks, with mask_store_wh and mask_scale_factor), the
auto-anchors from polygons, and the loader's copy of the four-tensor batch.
Every array must be equal bit for bit.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from vision_conglomerate_tpu.data import SegmentationDataset as JaxSegmentationDataset
from vision_conglomerate_tpu.data.segmentation import _nearest_resize_stack as jax_resize_stack
from vision_conglomerate_tpu.tools.make_anchors import (
    generate_anchors_and_class_weights as jax_generate_anchors)
from vision_conglomerate_tpu.utils import labels as jax_labels

from vision_conglomerate_torch.data.loader import DataLoader, prefetch_to_device
from vision_conglomerate_torch.data.segmentation import (
    SegmentationDataset, _nearest_resize_stack)
from vision_conglomerate_torch.tools.make_anchors import generate_anchors_and_class_weights
from vision_conglomerate_torch.utils import labels

from tests.test_torch_weights import ANCHORS


def write_polygon_dataset(root: str, n: int = 5, size=(64, 48), seed: int = 0,
                          max_polygons: int = 5, num_classes: int = 2, ext: str = "png"):
    """n images (w, h = size) with 0 to max_polygons random star-shaped
    polygons each (YOLO-seg rows `cls x1 y1 x2 y2 ...`, normalised), the
    first image without labels. Returns the file stems."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        img = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"img_{i}.{ext}"))
        rows = []
        for _ in range(0 if i == 0 else int(rng.integers(1, max_polygons + 1))):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            k = int(rng.integers(3, 9))
            ang = np.sort(rng.uniform(0, 2 * np.pi, k))
            rad = rng.uniform(0.05, 0.2, k)
            pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1).clip(0, 1)
            rows.append(" ".join([str(int(rng.integers(0, num_classes)))]
                                 + [f"{v:.6f}" for v in pts.ravel()]))
        with open(os.path.join(root, f"img_{i}.txt"), "w") as f:
            f.write("\n".join(rows) + ("\n" if rows else ""))


@pytest.fixture(scope="module")
def seg_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("segdata") / "train")
    write_polygon_dataset(root, n=6)
    return root


def test_polygon_functions_match_jax(seg_root):
    polys_all = []
    for i in range(1, 6):
        path = os.path.join(seg_root, f"img_{i}.txt")
        got, want = labels.load_polygon_labels(path), jax_labels.load_polygon_labels(path)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        polys = labels.interpolate_polygons([p[1:] for p in got])
        for g, w in zip(polys, jax_labels.interpolate_polygons([p[1:] for p in want])):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(labels.polygons_2_xywh(polys), jax_labels.polygons_2_xywh(polys)):
            np.testing.assert_array_equal(g, w)
        for sf in (1.0, 0.5):
            np.testing.assert_array_equal(labels.polygons_2_masks(polys, 64, 48, sf),
                                          jax_labels.polygons_2_masks(polys, 64, 48, sf))
        polys_all += polys
    # equal areas tie in np.argsort(-areas): the order must be numpy's too
    m = labels.polygons_2_masks(polys_all, 64, 48)
    m = np.concatenate([m, m[:2]])
    got, want = labels.overlap_masks(m), jax_labels.overlap_masks(m)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in zip(labels.get_box_sizes_and_class_weights_from_polygons(seg_root),
                    jax_labels.get_box_sizes_and_class_weights_from_polygons(seg_root)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kwargs", [
    dict(overlap_masks=True),
    dict(overlap_masks=False),
    dict(overlap_masks=True, mask_store_wh=(16, 12)),
    dict(overlap_masks=False, mask_store_wh=(16, 12)),
    dict(overlap_masks=True, mask_scale_factor=0.5),
], ids=["overlap", "no_overlap", "overlap_store", "no_overlap_store", "overlap_scale"])
def test_dataset_items_and_collate_match_jax(seg_root, kwargs):
    common = dict(img_ext="png", img_wh=(64, 48), max_labels=4)
    port = SegmentationDataset(seg_root, **common, **kwargs)
    ref = JaxSegmentationDataset(seg_root, **common, **kwargs)
    assert len(port) == len(ref) == 6
    items = []
    for i in range(len(port)):
        got, want = port[i], ref[i]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        items.append((got, want))
    # one batch holds the label-less image, another one with more polygons
    # than max_labels
    for idx in ([0, 1, 2], [3, 4, 5]):
        got = port.collate_fn([items[i][0] for i in idx])
        if idx[0] == 0 and kwargs == dict(overlap_masks=False, mask_store_wh=(16, 12)):
            # the JAX collate sizes the masks of a label-less first image
            # from the image, and fails; the port takes the stored size
            with pytest.raises(ValueError, match="broadcast"):
                ref.collate_fn([items[i][1] for i in idx])
            assert got[3].shape == (3, 4, 12, 16) and not got[3][0].any()
            want = ref.collate_fn([items[i][1] for i in idx[1:] + idx[:1]])
            got = port.collate_fn([items[i][0] for i in idx[1:] + idx[:1]])
        else:
            want = ref.collate_fn([items[i][1] for i in idx])
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port.get_class_weights(), ref.get_class_weights())


def test_nearest_resize_stack_index_rule():
    """floor(i * in / out), which takes row 4i at 64 -> 16 (half-pixel
    nearest would take 4i + 2)."""
    m = np.arange(2 * 64 * 64, dtype=np.uint32).reshape(2, 64, 64) % 251
    m = m.astype(np.uint8)
    got = _nearest_resize_stack(m, (16, 16))
    np.testing.assert_array_equal(got, jax_resize_stack(m, (16, 16)))
    np.testing.assert_array_equal(got, m[:, ::4, ::4])
    assert _nearest_resize_stack(m[:0], (16, 8)).shape == (0, 8, 16)


def test_anchors_from_polygons_match_jax(seg_root, tmp_path):
    """Tight tolerances force the k-means and mutation path, which rewrites
    the anchors file; both packages run it from numpy's global seed."""
    from vision_conglomerate_torch.utils import load_yaml, save_yaml

    kw = dict(threshold=4.0, score_tol=0.99, bpr_tol=1.0, num_generations=20, kmeans_iter=10,
              verbose=False)
    out = {}
    for name, fn in (("port", generate_anchors_and_class_weights),
                     ("jax", jax_generate_anchors)):
        path = str(tmp_path / f"{name}.yaml")
        save_yaml({"anchors": ANCHORS}, path)
        np.random.seed(0)
        out[name] = fn(seg_root, ANCHORS, anchors_path=path, from_polygons=True, **kw)
        out[name + "_file"] = load_yaml(path)
    for g, w in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(g, w)
    assert out["port_file"] == out["jax_file"]


def test_loader_puts_the_four_tensors_on_the_device(seg_root):
    ds = SegmentationDataset(seg_root, img_wh=(64, 48), max_labels=4, mask_store_wh=(16, 12))
    batches = list(prefetch_to_device(DataLoader(ds, batch_size=4, pad_last="wrap"), "cpu"))
    assert len(batches) == 2
    imgs, lab, valid, tgt = batches[0]
    assert imgs.dtype == torch.uint8 and imgs.shape == (4, 48, 64, 3)
    assert lab.shape == (4, 4, 5) and valid.dtype == torch.bool
    assert tgt.dtype == torch.uint8 and tgt.shape == (4, 12, 16)
    want = ds.collate_fn([ds[i] for i in range(4)])
    for g, w in zip(batches[0], want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_native_decode_raises(seg_root):
    with pytest.raises(NotImplementedError, match="§A.8"):
        SegmentationDataset(seg_root, decode_backend="native")
