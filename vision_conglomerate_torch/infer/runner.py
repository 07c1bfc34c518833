"""Detection and segmentation inference for images and video, the JAX
package's infer/runner.py in PyTorch.

Checkpoint -> deploy form (RepVGG fusion + BN folding, `use_reparam=True`,
the default) -> batched forward, decode and NMS on the device -> boxes to
the host for drawing and the `output.csv` summary. A video goes through
ByteTrack (`tools.bytetrack`) on the host and is written as video.mp4 with
track ids in output.csv. Outputs go to outputs/<task>/<datetime>/
(img_<n>.png or video.mp4, and output.csv), as in the JAX package.

With task="segmentation" the net is a SegmentationNet: the mask
coefficients of the rows NMS kept are assembled with the protos into
binary masks at the output size (`ops.postprocess.assemble_instance_masks`,
optionally cropped to the boxes with `crop_masks`) and drawn under the
boxes. The JAX runner assembles (B, max_detections, H, W) masks at once;
here only each image's kept rows are assembled, one image at a time, which
gives the same masks in a fraction of the memory.

A decode thread keeps the input `depth` batches ahead of the forward and,
on `cuda`, copies each batch to the card on a side stream
(`_prefetch_batches`); `VCT_INFER_PREFETCH=0` runs decode, copy and
compute one after another instead, as in the JAX package.

A keypoint net (`model_config.num_keypoints`, which the train CLI writes
into the saved config) also draws each kept box's keypoints
(`utils.drawing.apply_keypoints`); on video they ride the tracker as the
detections' `data={"keypoints": ...}` payload, and `tracked_classes`
filters them with the boxes.

On `cuda` the network runs in bf16 and its BN-folded 1x1 and stride-1 3x3
convs run on the port's CUDA kernels; on `cpu` (only when asked for) it
runs in f32 on the kernels' plain versions.

`quantize="int8"` serves the int8 post-training-quantized deploy form, as
the JAX package does: the first batch of the actual input calibrates each
quantizable conv's activation scale (`quantize_model_int8`), the weights
are quantized per output channel from the f32 folded kernels, and every
later batch runs int8 convs (on the card the s8 kernels,
`ops/int8.py`); it needs the deploy form.
"""
import json
import logging
import os
import queue
import threading
from datetime import datetime
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import cv2
import numpy as np
import pandas as pd
import torch
from PIL import Image

from ..data.inference import InferenceImgDataset, InferenceVideoDataset, SingleImgSample
from ..device import resolve_device
from ..models import DetectionNet, SegmentationNet
from ..nn.blocks import cast_conv_weights
from ..nn.quantize import collect_calibration, int8_quantize_
from ..nn.reparam import deploy_transform
from ..ops.postprocess import assemble_instance_masks, postprocess_detections
from ..tools.bytetrack import ByteTrack, Detections
from ..train.checkpoint import load_checkpoint
from ..utils.drawing import (apply_bboxes, apply_bboxes_from_tracks, apply_keypoints,
                             apply_segments, detection_summary_df)
from ..utils.labels import xyxy2xywh_np
from ..weights import flax_to_state_dict

logger = logging.getLogger(__name__)

Device = Union[str, torch.device, None]
VIDEO_EXTS = ("avi", "mkv", "mp4")


def load_classmap(path: str) -> Optional[List[Dict[str, Any]]]:
    """classmap/<task>/classmap.json without its first (header) entry."""
    if os.path.isfile(path):
        with open(path, "r") as f:
            return json.load(f)[1:]
    return None


def check_quantize(quantize: Optional[str], use_reparam: bool) -> bool:
    """True for int8; raises on an unknown mode, and on int8 without the
    deploy form, as the JAX package does."""
    if quantize not in (None, "none", "int8"):
        raise ValueError(f"unknown quantize mode: {quantize!r}")
    if quantize == "int8" and not use_reparam:
        raise ValueError("--quantize int8 requires the deploy (reparam) form; drop --no_reparam")
    return quantize == "int8"


@torch.no_grad()
def quantize_model_int8(model: torch.nn.Module, calib: torch.Tensor, **forward_kwargs
                        ) -> torch.nn.Module:
    """PTQ on one calibration batch, the JAX package's
    infer/runner.quantize_model_int8: `model(calib, **forward_kwargs)`
    records the f32 absmax at each quantizable conv's input, in the served
    compute dtype; the calibrated convs take their int8 form, quantized from
    their f32 folded weights (a loader's `quantize="int8"` keeps them so);
    the other convs' weights are then cast to the compute dtype."""
    int8_quantize_(model, collect_calibration(model, [calib], **forward_kwargs))
    return cast_conv_weights(model, model.dtype)


def load_detection_model(weights_path: str, model_config: Dict[str, Any],
                         task: str = "detection", num_keypoints: Optional[int] = None,
                         use_reparam: bool = True, device: Device = None,
                         quantize: Optional[str] = None) -> Tuple[DetectionNet, int]:
    """Rebuild the net (a SegmentationNet for task="segmentation") from a
    checkpoint manifest (either package's pickled format) and its config,
    in the deploy form unless `use_reparam=False`, with conv weights in bf16
    on cuda (what the kernels take) and f32 on the CPU. With
    `quantize="int8"` the conv weights stay f32 (each conv casts its weight
    at the call) until `quantize_model_int8`. Returns (model in eval mode,
    num_classes)."""
    int8 = check_quantize(quantize, use_reparam)
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
    cls = SegmentationNet if task == "segmentation" else DetectionNet
    model = cls(num_classes, model_config, num_keypoints=num_keypoints,
                deploy=fuse_repvgg, folded=use_reparam, dtype=dtype, device=dev)
    model.load_state_dict(state)
    return (model if int8 else cast_conv_weights(model, dtype)).eval(), num_classes


@torch.no_grad()
def detect(model: DetectionNet, imgs: Union[np.ndarray, torch.Tensor],
           og_hw: Tuple[int, int]):
    """Decoded predictions (B, M, 5 + C [+ K]) in f32 for a batch of HWC
    float images (numpy, or a tensor already on the model's device), with
    boxes in og_hw pixels; a SegmentationNet returns (preds, protos)."""
    x = torch.as_tensor(imgs, device=model.sm_anchors.device).permute(0, 3, 1, 2)
    return model(x, inference=True, og_size=tuple(og_hw))


def _image_batches(items: Iterable[Tuple[np.ndarray, np.ndarray]], batch_size: int
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(images, originals) batches of (image, original) items; a batch also
    ends where the original size changes, so every batch has one og size."""
    buf_i, buf_o = [], []
    for img, og in items:
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


def _to_device_async(imgs: np.ndarray, dev: torch.device, stream: Optional["torch.cuda.Stream"]):
    """(tensor on dev, event or None). On cuda the batch is pinned and
    copied on `stream` without blocking; the event marks the copy's end.
    The pinned block is not reused before the copy ends (the caching host
    allocator records the copy's stream). On the CPU the array is wrapped
    without a copy."""
    host = torch.from_numpy(imgs)
    if stream is None:
        return host, None
    with torch.cuda.stream(stream):
        out = host.pin_memory().to(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def _prefetch_batches(batches: Iterator[Tuple[np.ndarray, np.ndarray]], device: torch.device,
                      depth: int = 2):
    """Overlap host decode and the copy to the device with the forward.

    A background thread pulls (imgs, ogs) batches from `batches` (cv2 and
    PIL decode release the GIL) and starts their copy to `device`, `depth`
    batches ahead of the consumer. Yields (imgs_host, imgs_device, ogs). On
    cuda the copy runs on a side stream: the consumer's stream waits on the
    copy's event, and the tensor is recorded on the consumer's stream, so
    the allocator does not hand its memory to the side stream while the
    forward still reads it.

    With VCT_INFER_PREFETCH=0 decode, copy and compute run one after
    another (the serial baseline; imgs_device is then the host array).

    The worker's puts wait at most 0.1 s at a time and stop once the
    consumer is gone (an error or an early break in the serve loop), so
    the thread ends, closes `batches` (releasing a video capture), and
    drops every batch it staged; a decode error is raised in the consumer.
    """
    if os.environ.get("VCT_INFER_PREFETCH", "1") == "0":
        for imgs, ogs in batches:
            yield imgs, imgs, ogs
        return
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()  # the consumer is gone: unblocks a full-queue put

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            try:
                for imgs, ogs in batches:
                    # the staged tuple is a temporary: once the consumer is
                    # gone nothing here holds its device tensor
                    if not put((imgs, *_to_device_async(imgs, device, stream), ogs)):
                        return
            finally:
                batches.close()
        except BaseException as e:  # surface decode errors in the consumer
            put((end, e, None, None))
            return
        put((end, None, None, None))

    thread = threading.Thread(target=worker, name="vct-infer-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            imgs, dev_imgs, done, ogs = q.get()
            if imgs is end:
                if dev_imgs is not None:
                    raise dev_imgs
                return
            if done is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                dev_imgs.record_stream(current)
            yield imgs, dev_imgs, ogs
            del imgs, dev_imgs, done, ogs
    finally:
        stop.set()

        def drain():
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

        # drain until the worker has exited, then once more: a put already
        # inside its 0.1 s window when `stop` was set can still enqueue one
        # batch
        while thread.is_alive():
            drain()
            thread.join(timeout=0.2)
        drain()


def kept_masks(protos: torch.Tensor, post, i: int, og_hw: Tuple[int, int],
               crop_masks: bool) -> np.ndarray:
    """(n, H, W) bool masks, at og_hw, of the rows NMS kept in image i of a
    batch: `protos` (Km, Hp, Wp) is that image's."""
    valid = post.valid[i]
    boxes = post.boxes_xyxy[i][valid][None] if crop_masks else None
    masks = assemble_instance_masks(protos[None], post.mask_coefs[i][valid][None],
                                    og_size=og_hw, boxes_xyxy=boxes)
    return masks[0].cpu().numpy()


def _open_video_writer(path: str, fps: int, hw: Tuple[int, int]) -> "cv2.VideoWriter":
    """An mp4v writer of (h, w) frames; raises when this cv2 build cannot
    write mp4v (no other codec is tried)."""
    writer = cv2.VideoWriter(path, fourcc=cv2.VideoWriter_fourcc(*"mp4v"), fps=fps,
                             frameSize=(hw[1], hw[0]))
    if not writer.isOpened():
        writer.release()
        raise OSError(f"cv2 cannot write mp4v video to {path}")
    return writer


def run_detection_inference(
    path: str,
    weights_path: str,
    config: Dict[str, Any],
    task: str = "detection",
    batch_size: int = 32,
    iou_threshold: float = 0.35,
    score_threshold: float = 0.3,
    fps: int = 30,
    with_summary: bool = False,
    tracked_classes: Optional[List[int]] = None,
    frame_skips: int = 0,
    box_allowance: float = 4.0,
    save_og_size: bool = True,
    use_reparam: bool = True,
    max_detections: int = 300,
    storage_path: Optional[str] = None,
    quantize: Optional[str] = None,
    crop_masks: bool = False,
    out_ext: str = "png",
    device: Device = None,
) -> str:
    """Serve an image, a directory of images or a video (.mp4/.avi/.mkv);
    returns the output directory. A video keeps every (frame_skips + 1)-th
    frame, is tracked with ByteTrack and written at `fps`, every kept frame
    included. `tracked_classes` keeps only those classes (before the
    tracker). `save_og_size=False` renders at network resolution. With
    task="segmentation" each kept box's mask is drawn under the boxes;
    `crop_masks` zeroes each mask outside its box. `quantize="int8"`
    calibrates on the first batch and serves int8 (needs the deploy form)."""
    dev = resolve_device(device)
    if task not in ("detection", "segmentation"):
        raise ValueError(f"unknown task: {task!r} (detection|segmentation)")
    quantize_pending = check_quantize(quantize, use_reparam)
    if out_ext not in ("png", "jpg", "jpeg"):
        raise ValueError(f"unknown out_ext: {out_ext!r} (png|jpg|jpeg)")
    model_config = config["model_config"]
    img_wh = tuple(config["train_config"]["img_config"]["img_wh"])
    is_video = False
    if os.path.isdir(path):
        dataset = InferenceImgDataset(path, img_exts=["png", "jpg", "jpeg"], img_wh=img_wh)
    elif os.path.isfile(path):
        if path.endswith(VIDEO_EXTS):
            is_video = True
            dataset = InferenceVideoDataset(path, img_wh=img_wh, frame_skips=frame_skips)
        elif path.endswith(("png", "jpg", "jpeg")):
            dataset = SingleImgSample(path, img_wh)
        else:
            raise OSError(f"unsupported file type: {path}")
    else:
        raise OSError(f"{path} not found")

    num_keypoints = model_config.get("num_keypoints") or 0
    model, num_classes = load_detection_model(
        weights_path, model_config, task=task, num_keypoints=num_keypoints or None,
        use_reparam=use_reparam, device=dev, quantize=quantize)
    storage = storage_path or os.path.join(
        "outputs", task, str(datetime.now()).replace(":", "_"))
    os.makedirs(storage, exist_ok=True)
    classmap = load_classmap(os.path.join("classmap", task, "classmap.json"))
    colormap = np.random.default_rng().integers(0, 255, size=(num_classes, 3))
    draw_kwargs = dict(colormap=colormap, box_thickness=2, text_thickness=1, classmap=classmap)
    # the upstream project's supervision.ByteTrack settings
    tracker = ByteTrack(track_activation_threshold=0.35, lost_track_buffer=30,
                        minimum_matching_threshold=0.85, frame_rate=30,
                        minimum_consecutive_frames=1) if is_video else None
    items = dataset if is_video else (dataset[i] for i in range(len(dataset)))
    vwriter = None
    summaries = []
    start_idx = 0
    try:
        for imgs, dev_imgs, ogs in _prefetch_batches(_image_batches(items, batch_size), dev):
            og_hw = (ogs.shape[1], ogs.shape[2]) if save_og_size else (imgs.shape[1], imgs.shape[2])
            if quantize_pending:  # PTQ on the first real batch, then serve int8
                quantize_model_int8(model, torch.as_tensor(dev_imgs, device=dev).permute(
                    0, 3, 1, 2), inference=True)
                quantize_pending = False
            preds = detect(model, dev_imgs, og_hw)
            preds, protos = preds if model.with_proto_seg else (preds, None)
            post = postprocess_detections(
                preds, num_classes=num_classes, num_masks=model.num_masks,
                num_keypoints=num_keypoints, iou_threshold=iou_threshold,
                score_threshold=score_threshold, box_allowance=box_allowance,
                max_detections=max_detections)
            boxes_np = post.boxes_xyxy.cpu().numpy()
            scores_np = post.scores.cpu().numpy()
            classes_np = post.classes.cpu().numpy()
            valid_np = post.valid.cpu().numpy()
            kp_np = post.keypoints.cpu().numpy()
            if is_video and vwriter is None:
                vwriter = _open_video_writer(os.path.join(storage, "video.mp4"), fps, og_hw)
            for i in range(imgs.shape[0]):
                frame_no = start_idx + i
                boxes = np.concatenate(
                    [scores_np[i][:, None], classes_np[i][:, None].astype(np.float32),
                     boxes_np[i]], axis=-1)[valid_np[i]]
                kp = kp_np[i][valid_np[i]]
                masks = None
                if protos is not None:
                    masks = kept_masks(protos[i], post, i, og_hw, crop_masks)
                if tracked_classes:
                    sel = np.isin(boxes[:, 1], tracked_classes)
                    boxes = boxes[sel]
                    kp = kp[sel]
                    masks = None if masks is None else masks[sel]
                img = ogs[i] if save_og_size else (imgs[i] * 255).astype(np.uint8)
                img = np.ascontiguousarray(img)
                if boxes.shape[0] == 0:
                    # as in the JAX package, the tracker skips such a frame
                    logger.info(f"frame {frame_no} has no detected boxes")
                    if vwriter is not None:
                        vwriter.write(cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
                    continue
                if masks is not None and masks.shape[0] > 0:
                    img = apply_segments(img, masks.astype(np.uint8))
                if tracker is None:
                    img = apply_bboxes(img, boxes, **draw_kwargs)
                    out_boxes = boxes
                    if kp.size:
                        img = apply_keypoints(img, kp.reshape(-1, 3))
                else:
                    det = tracker.update_with_detections(Detections(
                        xyxy=boxes[:, 2:], confidence=boxes[:, 0],
                        class_id=boxes[:, 1].astype(int),
                        data={"keypoints": kp} if kp.size else None))
                    if len(det) == 0:
                        logger.info(f"frame {frame_no} has no tracked detections")
                        vwriter.write(cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
                        continue
                    tracks = np.concatenate([
                        det.tracker_id[:, None].astype(np.float32), det.confidence[:, None],
                        det.class_id[:, None].astype(np.float32), det.xyxy], axis=-1)
                    img, out_boxes = apply_bboxes_from_tracks(img, tracks, **draw_kwargs)
                    tracked_kp = (det.data or {}).get("keypoints")
                    if tracked_kp is not None and tracked_kp.size:
                        img = apply_keypoints(img, tracked_kp.reshape(-1, 3))
                if with_summary and len(out_boxes):
                    out_boxes = np.array(out_boxes, dtype=np.float64, copy=True)
                    out_boxes[:, -4:] = xyxy2xywh_np(out_boxes[:, -4:])
                    df = detection_summary_df(out_boxes, classmap=classmap)
                    df.insert(0, "frame", np.full(df.shape[0], frame_no, dtype=int))
                    summaries.append(df)
                if vwriter is None:
                    Image.fromarray(img).save(
                        os.path.join(storage, f"img_{frame_no}.{out_ext}"),
                        **({"quality": 90} if out_ext in ("jpg", "jpeg") else {}))
                else:
                    vwriter.write(cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            start_idx += imgs.shape[0]
    finally:
        if vwriter is not None:
            vwriter.release()
    if summaries:
        pd.concat(summaries, axis=0).to_csv(os.path.join(storage, "output.csv"), index=False)
    logger.info(f"outputs written to {storage}")
    return storage
