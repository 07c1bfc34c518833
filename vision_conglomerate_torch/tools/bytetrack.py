"""ByteTrack multi-object tracker (host-side, numpy + scipy Hungarian), the
JAX package's tools/bytetrack.py kept as the port's own copy.

The serve loop runs it with the settings of `supervision.ByteTrack` in the
upstream project (track_activation_threshold=0.35, lost_track_buffer=30,
minimum_matching_threshold=0.85, frame_rate=30,
minimum_consecutive_frames=1). It is the ByteTrack association algorithm
(Zhang et al., 2022) aligned rule by rule with the original BYTETracker
that supervision vendors; docs/BYTETRACK_AUDIT.md lists every Kalman std
weight, threshold and state rule, and the deliberate divergences, which
the port keeps. The arithmetic is numpy float64 and the assignment
`scipy.optimize.linear_sum_assignment`, as in the JAX package, so both
packages assign alike bit for bit.

Semantics implemented (original ByteTrack, non-MOT20 path):
- score bands: high = score > track_activation_threshold,
  low = 0.1 < score < track_activation_threshold;
- stage 1: high dets vs activated+lost tracks, cost = 1 - IoU*det_score
  ("fuse_score"), accept at cost <= minimum_matching_threshold;
- stage 2: low dets vs ONLY the stage-1-unmatched tracks that were in the
  Tracked state (lost tracks are not eligible), plain IoU cost, thresh 0.5;
  unmatched become Lost;
- stage 3: tentative (not yet activated) tracks vs leftover high dets,
  fused cost, thresh 0.7; unmatched tentatives are removed immediately;
- births: leftover high dets with score >= track_activation_threshold + 0.1
  (the original's det_thresh = track_thresh + 0.1);
- lost tracks are pruned after max_time_lost =
  int(frame_rate / 30 * lost_track_buffer) frames.

Tracking is sequential per-frame host logic: the device runs everything up
to and including NMS; the (<=K, 6) kept boxes then cross to the host for
association and drawing.
"""
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.linalg import cho_factor, cho_solve
from scipy.optimize import linear_sum_assignment


@dataclass
class Detections:
    """Minimal stand-in for supervision.Detections.

    `data` mirrors supervision's per-detection payload dict (arrays whose
    leading axis is the detection axis): it is sliced together with the
    detections and gathered through `update_with_detections`, which is how
    the upstream project carries keypoints through the tracker for video
    drawing.
    """

    xyxy: np.ndarray                      # (n, 4)
    confidence: Optional[np.ndarray] = None   # (n,)
    class_id: Optional[np.ndarray] = None     # (n,)
    tracker_id: Optional[np.ndarray] = None   # (n,)
    mask: Optional[np.ndarray] = None         # (n, H, W) bool
    data: Optional[Dict[str, np.ndarray]] = None  # per-detection payloads

    def __len__(self):
        return int(self.xyxy.shape[0])

    def __getitem__(self, index):
        take = lambda a: None if a is None else a[index]  # noqa: E731
        return Detections(self.xyxy[index], take(self.confidence),
                          take(self.class_id), take(self.tracker_id),
                          take(self.mask),
                          None if self.data is None
                          else {k: v[index] for k, v in self.data.items()})


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=2)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


class _KalmanFilter:
    """Constant-velocity KF on (cx, cy, aspect, h) + velocities.

    Noise model audited against supervision's vendored KalmanFilter
    (docs/BYTETRACK_AUDIT.md §2): std_weight_position=1/20,
    std_weight_velocity=1/160; initiate/predict/update stds match entry for
    entry. Gain is computed with a plain inverse instead of the Cholesky
    solve — algebraically identical, different rounding only.
    """

    ndim = 4

    def __init__(self):
        self._F = np.eye(8)
        self._F[:4, 4:] = np.eye(4)
        self._H = np.eye(4, 8)
        self._std_weight_pos = 1.0 / 20
        self._std_weight_vel = 1.0 / 160

    def initiate(self, meas):
        mean = np.zeros(8)
        mean[:4] = meas
        std = [
            2 * self._std_weight_pos * meas[3], 2 * self._std_weight_pos * meas[3],
            1e-2, 2 * self._std_weight_pos * meas[3],
            10 * self._std_weight_vel * meas[3], 10 * self._std_weight_vel * meas[3],
            1e-5, 10 * self._std_weight_vel * meas[3],
        ]
        cov = np.diag(np.square(std))
        return mean, cov

    def predict(self, mean, cov):
        std = [
            self._std_weight_pos * mean[3], self._std_weight_pos * mean[3],
            1e-2, self._std_weight_pos * mean[3],
            self._std_weight_vel * mean[3], self._std_weight_vel * mean[3],
            1e-5, self._std_weight_vel * mean[3],
        ]
        q = np.diag(np.square(std))
        mean = self._F @ mean
        cov = self._F @ cov @ self._F.T + q
        return mean, cov

    def update(self, mean, cov, meas):
        std = [
            self._std_weight_pos * mean[3], self._std_weight_pos * mean[3],
            1e-1, self._std_weight_pos * mean[3],
        ]
        r = np.diag(np.square(std))
        s = self._H @ cov @ self._H.T + r
        # same Cholesky solve as the original kalman_filter.py update()
        # (cho_factor/cho_solve), not an explicit inverse — removes the
        # last-ulp gain-rounding caveat from docs/BYTETRACK_AUDIT.md §2
        chol = cho_factor(s, lower=True, check_finite=False)
        k = cho_solve(chol, (cov @ self._H.T).T, check_finite=False).T
        innovation = meas - self._H @ mean
        mean = mean + k @ innovation
        cov = cov - k @ s @ k.T
        return mean, cov


def _xyxy_to_cxcyah(box):
    w = box[2] - box[0]
    h = box[3] - box[1]
    return np.asarray([box[0] + w / 2, box[1] + h / 2, w / max(h, 1e-9), h])


def _cxcyah_to_xyxy(state):
    cx, cy, a, h = state[:4]
    w = a * h
    return np.asarray([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])


# track states (original TrackState enum)
TRACKED = 0
LOST = 1


@dataclass(eq=False)  # identity equality: fields hold numpy arrays
class _Track:
    mean: np.ndarray
    cov: np.ndarray
    score: float
    class_id: int
    track_id: int
    hits: int = 1
    time_since_update: int = 0
    activated: bool = False
    state: int = TRACKED

    @property
    def xyxy(self):
        return _cxcyah_to_xyxy(self.mean)


class ByteTrack:
    def __init__(
        self,
        track_activation_threshold: float = 0.25,
        lost_track_buffer: int = 30,
        minimum_matching_threshold: float = 0.8,
        frame_rate: int = 30,
        minimum_consecutive_frames: int = 1,
        low_score_threshold: float = 0.1,
    ):
        self.track_activation_threshold = track_activation_threshold
        # original: det_thresh = track_thresh + 0.1 gates NEW track births
        self.det_thresh = track_activation_threshold + 0.1
        self.max_time_lost = int(frame_rate / 30.0 * lost_track_buffer)
        self.match_thresh = minimum_matching_threshold
        self.min_consecutive = minimum_consecutive_frames
        self.low_thresh = low_score_threshold
        self.kf = _KalmanFilter()
        self.tracks: List[_Track] = []
        self._next_id = 1

    def reset(self):
        self.tracks = []
        self._next_id = 1

    @staticmethod
    def _assign(cost: np.ndarray, thresh: float
                ) -> Tuple[list, list, list]:
        """Cost-limited assignment, exactly lap.lapjv(cost_limit=thresh).

        The original's cost_limit PARTICIPATES in the optimization (leaving a
        row/column unmatched is priced at thresh/2 a side), which is not the
        same as optimizing globally and dropping over-threshold pairs: e.g.
        cost [[0, .3], [.31, 1e3]] at limit .5 — the global optimum matches
        both mediocre pairs (.3+.31), the cost-limited optimum matches only
        the 0-cost pair and leaves the rest unmatched (0+.25+.25). Solve the
        same extended problem lap builds (lap/lap.py lapjv(extend_cost=True,
        cost_limit=...): slack blocks at cost_limit/2, slack-slack 0) with
        scipy's Hungarian — identical LP, so identical optimum modulo
        degenerate fp ties (docs/BYTETRACK_AUDIT.md §4).
        """
        n_t, n_d = cost.shape
        if cost.size == 0:
            return [], list(range(n_t)), list(range(n_d))
        ext = np.full((n_t + n_d, n_t + n_d), thresh / 2.0, dtype=np.float64)
        ext[n_t:, n_d:] = 0.0
        ext[:n_t, :n_d] = cost
        rows, cols = linear_sum_assignment(ext)
        matches, matched_t, matched_d = [], set(), set()
        for r, c in zip(rows, cols):
            if r < n_t and c < n_d:
                matches.append((int(r), int(c)))
                matched_t.add(int(r))
                matched_d.add(int(c))
        un_t = [i for i in range(n_t) if i not in matched_t]
        un_d = [i for i in range(n_d) if i not in matched_d]
        return matches, un_t, un_d

    def _fused_cost(self, tracks: List[_Track], dets: Detections,
                    scores: np.ndarray) -> np.ndarray:
        """Stage-1/3 cost: 1 - IoU * det_score (original fuse_score)."""
        track_boxes = np.asarray([t.xyxy for t in tracks]).reshape(-1, 4)
        iou = _iou_matrix(track_boxes, dets.xyxy)
        return 1.0 - iou * scores[None, :]

    def _iou_cost(self, tracks: List[_Track], dets: Detections) -> np.ndarray:
        track_boxes = np.asarray([t.xyxy for t in tracks]).reshape(-1, 4)
        return 1.0 - _iou_matrix(track_boxes, dets.xyxy)

    def _hit(self, t: _Track, dets: Detections, scores: np.ndarray, c: int):
        """Matched-track update (covers the original's update + re_activate:
        both run a KF update, reset the lost clock and keep the id)."""
        t.mean, t.cov = self.kf.update(t.mean, t.cov, _xyxy_to_cxcyah(dets.xyxy[c]))
        t.score = float(scores[c])
        t.hits += 1
        t.time_since_update = 0
        t.state = TRACKED
        if t.hits >= self.min_consecutive:
            t.activated = True

    def update_with_detections(self, detections: Detections) -> Detections:
        """Associate detections with tracks; returns detections whose rows are
        the activated matched tracks with tracker_id filled."""
        scores = (detections.confidence if detections.confidence is not None
                  else np.ones(len(detections)))
        # original score bands (both strict): high > thresh, low in (0.1, thresh)
        # — a score EQUAL to the threshold falls in neither band
        high = scores > self.track_activation_threshold
        low = ((scores < self.track_activation_threshold)
               & (scores > self.low_thresh))
        dets_high, s_high = detections[high], scores[high]
        dets_low, s_low = detections[low], scores[low]

        for t in self.tracks:
            t.mean, t.cov = self.kf.predict(t.mean, t.cov)
            t.time_since_update += 1

        # pool = activated (tracked or lost) tracks; tentative tracks are
        # handled separately in stage 3 (original unconfirmed logic)
        pool = [t for t in self.tracks if t.activated]
        tentative = [t for t in self.tracks if not t.activated]

        out_rows = []

        # stage 1: high-score detections vs activated pool, fused cost
        matches, un_t, un_d_high = self._assign(
            self._fused_cost(pool, dets_high, s_high), self.match_thresh)
        for r, c in matches:
            self._hit(pool[r], dets_high, s_high, c)
            out_rows.append((pool[r], dets_high, c))

        # stage 2: low-score detections vs stage-1-unmatched tracks that were
        # TRACKED entering this frame; lost tracks are not eligible (original
        # r_tracked_stracks rule). Plain IoU cost, fixed 0.5 threshold.
        r_tracked = [pool[i] for i in un_t if pool[i].state == TRACKED
                     and pool[i].time_since_update == 1]
        matches2, un_t2, _ = self._assign(
            self._iou_cost(r_tracked, dets_low), 0.5)
        for r, c in matches2:
            self._hit(r_tracked[r], dets_low, s_low, c)
            out_rows.append((r_tracked[r], dets_low, c))
        for i in un_t2:
            r_tracked[i].state = LOST

        # stage-1-unmatched tracks that weren't eligible for stage 2 -> lost
        for i in un_t:
            t = pool[i]
            if t.time_since_update > 0 and t not in r_tracked:
                t.state = LOST

        # stage 3: tentative tracks vs leftover high dets (fused cost, 0.7);
        # unmatched tentatives are removed immediately (original
        # mark_removed on unconfirmed)
        left_high = dets_high[np.asarray(un_d_high, int)]
        s_left = s_high[np.asarray(un_d_high, int)]
        matches3, un_t3, un_d3 = self._assign(
            self._fused_cost(tentative, left_high, s_left), 0.7)
        removed = set()
        for r, c in matches3:
            self._hit(tentative[r], left_high, s_left, c)
            if tentative[r].activated:
                out_rows.append((tentative[r], left_high, c))
        for i in un_t3:
            removed.add(id(tentative[i]))

        # births from still-unmatched high-score dets above det_thresh
        for c in un_d3:
            if s_left[c] < self.det_thresh:
                continue
            mean, cov = self.kf.initiate(_xyxy_to_cxcyah(left_high.xyxy[c]))
            t = _Track(
                mean=mean, cov=cov, score=float(s_left[c]),
                class_id=int(left_high.class_id[c]) if left_high.class_id is not None else -1,
                track_id=self._next_id,
                activated=self.min_consecutive <= 1,
            )
            self._next_id += 1
            self.tracks.append(t)
            if t.activated:
                out_rows.append((t, left_high, c))

        # deaths: expired lost tracks + unmatched tentatives
        self.tracks = [
            t for t in self.tracks
            if id(t) not in removed and t.time_since_update <= self.max_time_lost]

        if not out_rows:
            return Detections(
                xyxy=np.zeros((0, 4), np.float32),
                confidence=np.zeros((0,), np.float32),
                class_id=np.zeros((0,), np.int32),
                tracker_id=np.zeros((0,), np.int32),
                data=None if detections.data is None
                else {k: v[:0] for k, v in detections.data.items()},
            )
        xyxy = np.stack([d.xyxy[c] for _, d, c in out_rows])
        conf = np.asarray([t.score for t, _, _ in out_rows], np.float32)
        cls = np.asarray(
            [d.class_id[c] if d.class_id is not None else t.class_id
             for t, d, c in out_rows], np.int32)
        tid = np.asarray([t.track_id for t, _, _ in out_rows], np.int32)
        masks = None
        if detections.mask is not None:
            masks = np.stack([d.mask[c] for _, d, c in out_rows])
        data = None
        if detections.data is not None:
            # each payload row rides its matched detection (the score-band
            # subsets sliced data along in __getitem__), aligned with the
            # returned rows — supervision's data passthrough semantics
            data = {k: np.stack([d.data[k][c] for _, d, c in out_rows])
                    for k in detections.data}
        return Detections(xyxy=xyxy, confidence=conf, class_id=cls,
                          tracker_id=tid, mask=masks, data=data)
