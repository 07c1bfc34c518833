"""TrackNet's data side of the PyTorch port against the JAX package, on the
CPU: the heatmap ops (`decode_heatmap_peaks` on the device,
`make_gt_heatmap_np` on the host), `load_and_process_img`, the
TrackNetDataset windows (f32 and uint8, the seeded split and its
handoff), both inference datasets, and the loader's drop_last.

All host arrays must be equal (the same numpy, PIL and cv2 calls); the
decode's centroids and radii are f32 sums in another order, atol 1e-4.
"""
import cv2
import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp
import torch

from vision_conglomerate_tpu.data import DataLoader as JaxDataLoader
from vision_conglomerate_tpu.data import TrackNetDataset as JaxTrackNetDataset
from vision_conglomerate_tpu.data import inference as jax_inference
from vision_conglomerate_tpu.ops import heatmap as jax_heatmap
from vision_conglomerate_tpu.utils.image import load_and_process_img as jax_load

from vision_conglomerate_torch.data import inference
from vision_conglomerate_torch.data.loader import DataLoader
from vision_conglomerate_torch.data.tracknet import TrackNetDataset
from vision_conglomerate_torch.ops import heatmap
from vision_conglomerate_torch.utils.image import load_and_process_img

from tests.test_tracknet import _write_clip


def write_video(path: str, n: int = 9, wh=(64, 32), seed: int = 0):
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, wh)
    rng = np.random.default_rng(seed)
    for _ in range(n):
        writer.write((rng.uniform(size=(wh[1], wh[0], 3)) * 255).astype(np.uint8))
    writer.release()
    return path


def test_decode_heatmap_peaks_matches_jax():
    rng = np.random.default_rng(0)
    hms = rng.integers(0, 120, size=(5, 32, 64)).astype(np.uint8)
    hms[1, 10:14, 20:26] = 200          # one blob
    hms[2, 3:5, 60:64] = 128            # at the threshold, at the edge
    hms[3, 0:2, 0:3] = 255
    hms[3, 30:32, 50:52] = 130          # two blobs: one centroid between
    # hms[0], hms[4]: nothing at or above 128
    for threshold in (128, 100):
        want = jax_heatmap.decode_heatmap_peaks(jnp.asarray(hms), threshold=threshold)
        got = heatmap.decode_heatmap_peaks(torch.from_numpy(hms), threshold=threshold)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-6)
    found = heatmap.decode_heatmap_peaks(torch.from_numpy(hms))[3]
    assert found.tolist() == [False, True, True, True, False]


@pytest.mark.parametrize("x,y,vis", [(20, 10, 1), (0, 0, 1), (63, 31, 2), (70, -3, 1),
                                     (20, 10, 0)])
def test_make_gt_heatmap_np_matches_jax(x, y, vis):
    got = heatmap.make_gt_heatmap_np(x, y, vis, (64, 32), variance=5)
    want = jax_heatmap.make_gt_heatmap_np(x, y, vis, (64, 32), variance=5)
    assert got.dtype == np.uint8 and got.shape == (32, 64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("img_wh,scale", [(None, True), ((20, 12), False), ((20, 12), True)])
def test_load_and_process_img_matches_jax(tmp_path, mode, img_wh, scale):
    arr = (np.random.default_rng(1).uniform(size=(17, 23, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "img.png")
    Image.fromarray(arr).convert(mode).save(path)
    got = load_and_process_img(path, img_wh, scale=scale, convert_to=mode)
    want = jax_load(path, img_wh, scale=scale, convert_to=mode)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("transfer_dtype", ["float32", "uint8"])
def test_tracknet_dataset_matches_jax(tmp_path, transfer_dtype):
    """Windows (newest frame first), labels rescaled to img_wh, the
    heatmaps, the seeded 70/30 split and the handoff of the rest."""
    root = str(tmp_path / "tn")
    _write_clip(root, n_frames=9, size=(80, 40))
    kw = dict(num_stacks=3, img_wh=(64, 32), avg_diameter=5, transfer_dtype=transfer_dtype)
    got = TrackNetDataset(data_path=root, split_percentage=0.7, seed=42, **kw)
    want = JaxTrackNetDataset(data_path=root, split_percentage=0.7, seed=42, **kw)
    assert len(got) == len(want) == 4
    assert got.labels_df.equals(want.labels_df)
    assert got.unused_labels_df.equals(want.unused_labels_df)
    for i in range(len(got)):
        for a, b in zip(got[i], want[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    frames, hm, others = got[0]
    assert frames.shape == (32, 64, 9) and hm.max() > 200
    first = got.labels_df.iloc[0]
    newest = load_and_process_img(first["frame3"], None, scale=transfer_dtype == "float32")
    # (cv2 resizes 9 float channels and 3 in other code paths: last-bit apart)
    np.testing.assert_allclose(
        frames[..., :3], cv2.resize(newest, (64, 32), interpolation=cv2.INTER_LINEAR),
        atol=1e-6)
    # the handed windows are shuffled again, with the seed given (None in
    # the CLIs, as in the JAX package)
    handed = TrackNetDataset(labels_df=got.unused_labels_df, seed=0, **kw)
    jax_handed = JaxTrackNetDataset(labels_df=want.unused_labels_df, seed=0, **kw)
    assert len(handed) == len(jax_handed) == 3
    for a, b in zip(got.collate_fn([handed[i] for i in range(3)]),
                    jax_handed.collate_fn([jax_handed[i] for i in range(3)])):
        np.testing.assert_array_equal(a, b)


def test_tracknet_dataset_cache_and_arguments(tmp_path):
    root = str(tmp_path / "tn")
    _write_clip(root, n_frames=6)
    ds = TrackNetDataset(data_path=root, img_wh=(64, 32), cache=True, seed=0)
    first = ds[1]
    assert ds[1][0] is first[0] and not first[0].flags.writeable
    with pytest.raises(ValueError):
        TrackNetDataset(data_path=root, transfer_dtype="float16")
    with pytest.raises(ValueError):
        TrackNetDataset()


def test_tracknet_inference_img_dataset_matches_jax(tmp_path):
    clip = _write_clip(str(tmp_path / "tn"), n_frames=7, size=(80, 40))
    got = inference.TrackNetInferenceImgDataset(clip, img_ext="jpg", img_wh=(64, 32))
    want = jax_inference.TrackNetInferenceImgDataset(clip, img_ext="jpg", img_wh=(64, 32))
    assert len(got) == len(want) == 5
    for i in range(len(got)):
        for a, b in zip(got[i], want[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        got[len(got)]
    with pytest.raises(FileNotFoundError):
        inference.TrackNetInferenceImgDataset(clip, img_ext="png")


@pytest.mark.parametrize("frame_skips", [0, 1])
def test_tracknet_inference_video_dataset_matches_jax(tmp_path, frame_skips):
    path = write_video(str(tmp_path / "clip.mp4"))
    got = list(inference.TrackNetInferenceVideoDataset(path, img_wh=(48, 24),
                                                       frame_skips=frame_skips))
    want = list(jax_inference.TrackNetInferenceVideoDataset(path, img_wh=(48, 24),
                                                            frame_skips=frame_skips))
    assert len(got) == len(want) == (7 if frame_skips == 0 else 3)
    for (a, oa), (b, ob) in zip(got, want):
        assert a.shape == (24, 48, 9)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(oa, ob)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.asarray([i])

    @staticmethod
    def collate_fn(batch):
        return np.stack(batch)


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_drop_last_matches_jax(shuffle):
    ds = _Items(11)
    got = [b.ravel().tolist() for b in DataLoader(ds, 4, shuffle=shuffle, drop_last=True,
                                                  num_workers=2)]
    want = [b.ravel().tolist() for b in JaxDataLoader(ds, 4, shuffle=shuffle, drop_last=True,
                                                      num_workers=2)]
    assert got == want and len(got) == 2 and all(len(b) == 4 for b in got)
    assert len(DataLoader(ds, 4, drop_last=True)) == 2 and len(DataLoader(ds, 4)) == 3
