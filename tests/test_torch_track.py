"""ByteTrack of the PyTorch port (its own numpy/scipy copy) against the JAX
package's: the two golden fixtures, seeded random detection streams and
the cost-limited assignment. Exact equality throughout: both run the same
float64 arithmetic and scipy's linear_sum_assignment on the same inputs.
"""
import json
import os

import numpy as np
import pytest

from vision_conglomerate_tpu.tools.bytetrack import ByteTrack as JaxByteTrack
from vision_conglomerate_tpu.tools.bytetrack import Detections as JaxDetections

from vision_conglomerate_torch.tools.bytetrack import ByteTrack, Detections

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SERVE_CFG = dict(track_activation_threshold=0.35, lost_track_buffer=30,
                 minimum_matching_threshold=0.85, frame_rate=30, minimum_consecutive_frames=1)
MCF3_CFG = dict(SERVE_CFG, minimum_consecutive_frames=3, lost_track_buffer=5)


@pytest.mark.parametrize("fixture_name", ["bytetrack_golden.json", "bytetrack_golden_mcf3.json"])
def test_golden_fixture(fixture_name):
    """The per-frame track ids and classes of both fixtures (a crossing
    pair, vanish and return, low-score ghosts; the second with
    minimum_consecutive_frames=3)."""
    with open(os.path.join(FIXTURES, fixture_name)) as f:
        data = json.load(f)
    tracker = ByteTrack(**data["config"])
    for fr, exp in zip(data["frames"], data["expected"]):
        out = tracker.update_with_detections(Detections(
            xyxy=np.asarray(fr["xyxy"], np.float32),
            confidence=np.asarray(fr["confidence"], np.float32),
            class_id=np.asarray(fr["class_id"], int)))
        order = np.argsort(out.xyxy[:, 0]) if len(out) else np.asarray([], int)
        assert [int(i) for i in out.tracker_id[order]] == exp["tracker_ids"]
        assert [int(c) for c in out.class_id[order]] == exp["classes"]


def _stream(seed: int, n_frames: int = 60):
    """Per frame (xyxy, scores, classes, keypoints) float32 arrays: 5
    objects moving at constant speed with jitter, each missing from some
    frames and dipping into the low score band (0.1-0.35) at times, plus
    ghost boxes at random places and scores, and a few empty frames."""
    rng = np.random.default_rng(seed)
    n_obj = 5
    pos = rng.uniform(50, 500, (n_obj, 2))
    vel = rng.uniform(-6, 6, (n_obj, 2))
    size = rng.uniform(20, 80, (n_obj, 2))
    cls = rng.integers(0, 3, n_obj)
    frames = []
    for t in range(n_frames):
        if rng.uniform() < 0.05:
            frames.append((np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
                           np.zeros(0, int), np.zeros((0, 2, 3), np.float32)))
            continue
        boxes, scores, classes = [], [], []
        for k in range(n_obj):
            if rng.uniform() < 0.15:
                continue
            c = pos[k] + vel[k] * t + rng.normal(0, 2, 2)
            boxes.append(np.concatenate([c - size[k] / 2, c + size[k] / 2]))
            scores.append(rng.uniform(0.12, 0.34) if rng.uniform() < 0.2 else rng.uniform(0.4, 0.95))
            classes.append(cls[k])
        for _ in range(int(rng.integers(0, 4))):
            c, s = rng.uniform(0, 600, 2), rng.uniform(10, 60, 2)
            boxes.append(np.concatenate([c, c + s]))
            scores.append(rng.uniform(0.05, 0.6))
            classes.append(rng.integers(0, 3))
        n = len(boxes)
        frames.append((np.asarray(boxes, np.float32).reshape(n, 4),
                       np.asarray(scores, np.float32), np.asarray(classes, int),
                       rng.uniform(0, 600, (n, 2, 3)).astype(np.float32)))
    return frames


@pytest.mark.parametrize("cfg", [SERVE_CFG, MCF3_CFG], ids=["serve", "mcf3"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_jax_on_random_streams(seed, cfg):
    """Same ids, boxes, scores, classes and keypoint payload rows per frame."""
    port, ref = ByteTrack(**cfg), JaxByteTrack(**cfg)
    ids = set()
    for xyxy, conf, cls, kp in _stream(seed):
        got = port.update_with_detections(Detections(
            xyxy=xyxy, confidence=conf, class_id=cls, data={"keypoints": kp}))
        want = ref.update_with_detections(JaxDetections(
            xyxy=xyxy, confidence=conf, class_id=cls, data={"keypoints": kp}))
        for key in ("tracker_id", "xyxy", "confidence", "class_id"):
            np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
        np.testing.assert_array_equal(got.data["keypoints"], want.data["keypoints"])
        ids.update(got.tracker_id.tolist())
    assert len(ids) >= 5  # the streams make and lose tracks


@pytest.mark.parametrize("thresh,want", [
    (0.5, ([(0, 0)], [1], [1])),  # the limit takes part: 0 + 0.25 + 0.25 < 0.3 + 0.31
    (10.0, ([(0, 1), (1, 0)], [], [])),  # a loose limit: the global optimum
])
def test_assign_is_cost_limited(thresh, want):
    cost = np.asarray([[0.0, 0.3], [0.31, 1e3]])
    got = ByteTrack._assign(cost, thresh)
    assert got == want == JaxByteTrack._assign(cost, thresh)
