"""Host-side rendering and summary tables (cv2/pandas), as in the JAX
package's utils/drawing.py. Inputs are HWC numpy images."""
from typing import Any, Dict, List, Optional

import cv2
import numpy as np
import pandas as pd

from .labels import overlap_masks

FONT = cv2.FONT_HERSHEY_SIMPLEX
FONT_SCALE = 0.4


def apply_segments(img: np.ndarray, masks: np.ndarray, alpha: float = 0.5,
                   colormap: Optional[np.ndarray] = None) -> np.ndarray:
    """Overlay instance masks (1 or m, H, W) on an HWC image: a stack of
    several is overlap-compressed first (smaller objects on top), each
    object gets a colour (random unless `colormap` is given), and the
    coloured layer is blended in with weight 1 - alpha."""
    if img.dtype != np.uint8:
        img = (img * 255).astype(np.uint8)
    img = np.ascontiguousarray(img)
    masks = masks.astype(np.uint8)
    colored = np.zeros_like(img)
    if masks.shape[0] > 1:
        masks, _ = overlap_masks(masks)
    masks = masks.squeeze(axis=0)
    if colormap is None:
        colormap = np.random.default_rng().integers(0, 255, size=(int(masks.max()) + 1, 3))
    for obj_id in range(colormap.shape[0]):
        colored[masks == obj_id + 1] = colormap[obj_id]
    return cv2.addWeighted(src1=img, alpha=alpha, src2=colored, beta=1 - alpha, gamma=0)


def apply_bboxes(img: np.ndarray, bboxes: np.ndarray, box_thickness: int = 2,
                 text_thickness: int = 2, colormap: Optional[np.ndarray] = None,
                 classmap: Optional[List[Dict[str, Any]]] = None) -> np.ndarray:
    """Draw (score, class, x1, y1, x2, y2) boxes with labels on an HWC
    image (uint8, or floats in [0, 1])."""
    if img.ndim != 3 or bboxes.ndim != 2 or bboxes.shape[1] != 6:
        raise ValueError(f"expected an HWC image and (n, 6) boxes, got shapes "
                         f"{img.shape} and {bboxes.shape}")
    if img.dtype != np.uint8:
        img = (img * 255).astype(np.uint8)
    img = np.ascontiguousarray(img)
    if colormap is None:
        colormap = np.random.default_rng(0).integers(
            0, 255, size=(int(bboxes[:, 1].max()) + 1, 3))
    for box in bboxes:
        score, class_idx, x1, y1, x2, y2 = box
        class_idx = int(class_idx)
        x1, y1, x2, y2 = (round(float(v)) for v in (x1, y1, x2, y2))
        color = tuple(int(v) for v in colormap[class_idx])
        img = cv2.rectangle(img, (x1, y1), (x2, y2), color, box_thickness)
        name = classmap[class_idx]["name"] if classmap else class_idx
        text = f"({name} {score :.2f})"
        tw, th = cv2.getTextSize(text, FONT, FONT_SCALE, text_thickness)[0]
        img = cv2.rectangle(img, (x1, y1 - th - 4), (x1 + tw + 2, y1), color, cv2.FILLED)
        img = cv2.putText(img, text, (x1, y1 - 2), FONT, FONT_SCALE, (0, 0, 0), text_thickness)
    return img


def apply_keypoints(img: np.ndarray, keypoints: np.ndarray) -> np.ndarray:
    """Filled dots of radius 3 at (k, 3) [x, y, vis] keypoints (truncated
    to int) on an HWC image, coloured by visibility class: 0 white, 1
    light yellow; class 2 is not drawn."""
    if img.dtype != np.uint8:
        img = (img * 255).astype(np.uint8)
    img = np.ascontiguousarray(img)
    for x, y, vis in keypoints.astype(int):
        if vis == 0:
            color = (255, 255, 255)
        elif vis == 1:
            color = (255, 255, 100)
        else:
            continue
        img = cv2.circle(img, (int(x), int(y)), 3, color=color, thickness=-1)
    return img


def apply_bboxes_from_tracks(img: np.ndarray, tracks: np.ndarray, box_thickness: int = 2,
                             text_thickness: int = 2, colormap: Optional[np.ndarray] = None,
                             classmap: Optional[List[Dict[str, Any]]] = None):
    """Draw tracked boxes labelled `id:<track_id>` on an HWC image. tracks:
    (n, 7) [track_id, score, class, x1, y1, x2, y2]; rows with a NaN score
    are skipped. Returns (image, (k, 7) drawn rows with int track ids and
    classes)."""
    if img.dtype != np.uint8:
        img = (img * 255).astype(np.uint8)
    img = np.ascontiguousarray(img)
    drawn = []
    for track_id, score, class_idx, x1, y1, x2, y2 in np.asarray(tracks).reshape(-1, 7):
        if np.isnan(score):
            continue
        class_idx = int(class_idx)
        drawn.append([int(track_id), float(score), class_idx, x1, y1, x2, y2])
        x1, y1, x2, y2 = (round(float(v)) for v in (x1, y1, x2, y2))
        color = tuple(int(v) for v in colormap[class_idx]) if colormap is not None else (0, 255, 0)
        img = cv2.rectangle(img, (x1, y1), (x2, y2), color, box_thickness)
        name = classmap[class_idx]["name"] if classmap else class_idx
        text = f"id:{int(track_id)} ({name} {score :.2f})"
        tw, th = cv2.getTextSize(text, FONT, FONT_SCALE, text_thickness)[0]
        img = cv2.rectangle(img, (x1, y1 - th - 4), (x1 + tw + 2, y1), color, cv2.FILLED)
        img = cv2.putText(img, text, (x1, y1 - 2), FONT, FONT_SCALE, (0, 0, 0), text_thickness)
    return img, np.asarray(drawn)


def detection_summary_df(bboxes: np.ndarray, classmap: Optional[List[Dict[str, Any]]] = None
                         ) -> Optional[pd.DataFrame]:
    """Per-box summary rows of (n, 6) [score, cls, x, y, w, h] boxes or
    (n, 7) [track_id, score, cls, x, y, w, h] tracks, the coordinates
    truncated to int; None for no boxes."""
    data = []
    for box in np.asarray(bboxes):
        row = {}
        if len(box) == 7:
            row["track_id"] = box[0]
            box = box[1:]
        score, class_idx, *coords = box
        class_idx = int(class_idx)
        row.update({"confidence": score,
                    "class": classmap[class_idx]["name"] if classmap else class_idx})
        row.update({k: int(v) for k, v in zip(("X", "Y", "W", "H"), coords)})
        data.append(row)
    return pd.DataFrame(data) if data else None
