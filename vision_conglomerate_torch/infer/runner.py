"""Detection inference for images, the JAX package's infer/runner.py
in PyTorch.

Checkpoint -> deploy form (RepVGG fusion + BN folding, `use_reparam=True`,
the default) -> batched forward, decode and NMS on the device -> boxes to
the host for drawing and the `output.csv` summary. Outputs go to
outputs/detection/<datetime>/ (img_<n>.png and output.csv), as in the JAX
package.

On `cuda` the network runs in bf16 and its BN-folded 1x1 and stride-1 3x3
convs run on the port's CUDA kernels; on `cpu` (only when asked for) it
runs in f32 on the kernels' plain versions. Video with ByteTrack
(ROADMAP §A.9), int8 (§A.10), segmentation (§A.11) and keypoints (§A.13)
are not in the port yet and raise.
"""
import json
import logging
import os
from datetime import datetime
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import pandas as pd
import torch
from PIL import Image

from ..data.inference import InferenceImgDataset, SingleImgSample
from ..device import resolve_device
from ..models.detection import DetectionNet
from ..nn.blocks import cast_conv_weights
from ..nn.reparam import deploy_transform
from ..ops.postprocess import postprocess_detections
from ..train.checkpoint import load_checkpoint
from ..utils.drawing import apply_bboxes, detection_summary_df
from ..utils.labels import xyxy2xywh_np
from ..weights import flax_to_state_dict

logger = logging.getLogger(__name__)

Device = Union[str, torch.device, None]


def load_classmap(path: str) -> Optional[List[Dict[str, Any]]]:
    """classmap/<task>/classmap.json without its first (header) entry."""
    if os.path.isfile(path):
        with open(path, "r") as f:
            return json.load(f)[1:]
    return None


def load_detection_model(weights_path: str, model_config: Dict[str, Any],
                         num_keypoints: Optional[int] = None, use_reparam: bool = True,
                         device: Device = None) -> Tuple[DetectionNet, int]:
    """Rebuild the net from a checkpoint manifest (either package's pickled
    format) and its config, in the deploy form unless `use_reparam=False`,
    with conv weights in bf16 on cuda (what the kernels take) and f32 on
    the CPU. Returns (model in eval mode, num_classes)."""
    dev = resolve_device(device)
    manifest = load_checkpoint(weights_path)
    num_classes = int(manifest["NUM_CLASSES"])
    state = flax_to_state_dict(manifest["NETWORK_PARAMS"])
    # full RepVGG fusion only for canonical (activation-free-branch) blocks;
    # branch-activated blocks deploy by BN folding alone
    neck_cfg = model_config.get(model_config.get("neck", "").lower() + "_config", {}) or {}
    fuse_repvgg = use_reparam and neck_cfg.get("repvgg_branch_act", "silu") is None
    if use_reparam:
        state = deploy_transform(state, fuse_repvgg=fuse_repvgg)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = DetectionNet(num_classes, model_config, num_keypoints=num_keypoints,
                         deploy=fuse_repvgg, folded=use_reparam, dtype=dtype, device=dev)
    model.load_state_dict(state)
    return cast_conv_weights(model, dtype).eval(), num_classes


@torch.no_grad()
def detect(model: DetectionNet, imgs: np.ndarray, og_hw: Tuple[int, int]) -> torch.Tensor:
    """Decoded predictions (B, M, 5 + C) in f32 for a batch of HWC float
    images, with boxes in og_hw pixels."""
    dev = model.sm_anchors.device
    x = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev).permute(0, 3, 1, 2)
    return model(x, inference=True, og_size=tuple(og_hw))


def _image_batches(dataset, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(images, originals) batches; a batch also ends where the original
    size changes, so every batch has one og size."""
    buf_i, buf_o = [], []
    for i in range(len(dataset)):
        img, og = dataset[i]
        if buf_o and og.shape != buf_o[0].shape:
            yield np.stack(buf_i), np.stack(buf_o)
            buf_i, buf_o = [], []
        buf_i.append(img)
        buf_o.append(og)
        if len(buf_i) == batch_size:
            yield np.stack(buf_i), np.stack(buf_o)
            buf_i, buf_o = [], []
    if buf_i:
        yield np.stack(buf_i), np.stack(buf_o)


def run_detection_inference(
    path: str,
    weights_path: str,
    config: Dict[str, Any],
    task: str = "detection",
    batch_size: int = 32,
    iou_threshold: float = 0.35,
    score_threshold: float = 0.3,
    with_summary: bool = False,
    tracked_classes: Optional[List[int]] = None,
    box_allowance: float = 4.0,
    save_og_size: bool = True,
    use_reparam: bool = True,
    max_detections: int = 300,
    storage_path: Optional[str] = None,
    quantize: Optional[str] = None,
    out_ext: str = "png",
    device: Device = None,
) -> str:
    """Serve an image or a directory of images; returns the output
    directory. `save_og_size=False` renders at network resolution."""
    dev = resolve_device(device)
    if task != "detection":
        raise NotImplementedError(f"task {task!r} is not in the port yet (ROADMAP §A.11)")
    if quantize not in (None, "none", "int8"):
        raise ValueError(f"unknown quantize mode: {quantize!r}")
    if quantize == "int8":
        raise NotImplementedError("int8 serving is not in the port yet (ROADMAP §A.10)")
    if out_ext not in ("png", "jpg", "jpeg"):
        raise ValueError(f"unknown out_ext: {out_ext!r} (png|jpg|jpeg)")
    model_config = config["model_config"]
    img_wh = tuple(config["train_config"]["img_config"]["img_wh"])
    if os.path.isdir(path):
        dataset = InferenceImgDataset(path, img_exts=["png", "jpg", "jpeg"], img_wh=img_wh)
    elif os.path.isfile(path):
        if path.endswith(("avi", "mkv", "mp4")):
            raise NotImplementedError(
                "video serving with ByteTrack is not in the port yet (ROADMAP §A.9)")
        if not path.endswith(("png", "jpg", "jpeg")):
            raise OSError(f"unsupported file type: {path}")
        dataset = SingleImgSample(path, img_wh)
    else:
        raise OSError(f"{path} not found")

    model, num_classes = load_detection_model(
        weights_path, model_config, num_keypoints=model_config.get("num_keypoints") or None,
        use_reparam=use_reparam, device=dev)
    storage = storage_path or os.path.join(
        "outputs", task, str(datetime.now()).replace(":", "_"))
    os.makedirs(storage, exist_ok=True)
    classmap = load_classmap(os.path.join("classmap", task, "classmap.json"))
    colormap = np.random.default_rng().integers(0, 255, size=(num_classes, 3))
    summaries = []
    start_idx = 0
    for imgs, ogs in _image_batches(dataset, batch_size):
        og_hw = (ogs.shape[1], ogs.shape[2]) if save_og_size else (imgs.shape[1], imgs.shape[2])
        post = postprocess_detections(
            detect(model, imgs, og_hw), num_classes=num_classes,
            iou_threshold=iou_threshold, score_threshold=score_threshold,
            box_allowance=box_allowance, max_detections=max_detections)
        boxes_np = post.boxes_xyxy.cpu().numpy()
        scores_np = post.scores.cpu().numpy()
        classes_np = post.classes.cpu().numpy()
        valid_np = post.valid.cpu().numpy()
        for i in range(imgs.shape[0]):
            frame_no = start_idx + i
            boxes = np.concatenate(
                [scores_np[i][:, None], classes_np[i][:, None].astype(np.float32),
                 boxes_np[i]], axis=-1)[valid_np[i]]
            if tracked_classes:
                boxes = boxes[np.isin(boxes[:, 1], tracked_classes)]
            if boxes.shape[0] == 0:
                logger.info(f"frame {frame_no} has no detected boxes")
                continue
            img = ogs[i] if save_og_size else (imgs[i] * 255).astype(np.uint8)
            img = apply_bboxes(np.ascontiguousarray(img), boxes, colormap=colormap,
                               box_thickness=2, text_thickness=1, classmap=classmap)
            if with_summary:
                out_boxes = np.array(boxes, dtype=np.float64, copy=True)
                out_boxes[:, -4:] = xyxy2xywh_np(out_boxes[:, -4:])
                df = detection_summary_df(out_boxes, classmap=classmap)
                if df is not None:
                    df.insert(0, "frame", np.full(df.shape[0], frame_no, dtype=int))
                    summaries.append(df)
            Image.fromarray(img).save(
                os.path.join(storage, f"img_{frame_no}.{out_ext}"),
                **({"quality": 90} if out_ext in ("jpg", "jpeg") else {}))
        start_idx += imgs.shape[0]
    if summaries:
        pd.concat(summaries, axis=0).to_csv(os.path.join(storage, "output.csv"), index=False)
    logger.info(f"outputs written to {storage}")
    return storage
