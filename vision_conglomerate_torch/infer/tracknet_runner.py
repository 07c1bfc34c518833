"""TrackNet inference for a video or a folder of frames, the JAX package's
infer/tracknet_runner.py in PyTorch.

Checkpoint -> deploy form (BatchNorm folded, and canonical RepVGG blocks
fused, `use_reparam=True`, the default) -> per batch of stacked frames, on the device: the forward, the
argmax heatmap, its antialiased resize to the original size and the
centroid decode (`ops.heatmap`); `decode="hough"` takes the heatmaps to
the host for cv2.HoughCircles instead. Then on the host:
- per-batch gap filling: where at least half of a batch's frames found the
  ball, np.interp fills the others from them;
- the first num_stacks - 1 frames (the lead-in, which no window ends on)
  are written with no track, so the video starts at frame 0;
- each frame gets a fading trace of the last max_num_trace positions,
  thickness max_circle_thickness - j, drawn with cv2;
- video.mp4 (mp4v, at `fps`) and, with `with_summary`, output.csv with
  rows [frame, x, y, r] for the frames with a track, frames numbered from 1.
Outputs go to outputs/tracknet/<datetime>/ unless `storage_path` is given.

A decode thread keeps the stacked frames `depth` batches ahead of the
forward and copies them to the card on a side stream
(`infer.runner._prefetch_batches`; VCT_INFER_PREFETCH=0 runs serially).
On `cuda` the net runs in bf16 and its stride-1 convs run on the kernels
(the base architecture's 18 all on conv3x3; the advanced one's 1x1s on
matmul, its 3x3s on conv3x3); on `cpu` (only when asked for) it runs in
f32 on the kernels' plain versions. `quantize="int8"` calibrates the
int8 form on the first batch of stacked frames and serves int8, as the JAX
package does (`infer.runner.quantize_model_int8`; the deploy form only);
`dec_13` and the advanced net's `deconv4` (no BatchNorm) and its
transpose convs stay in bf16.
"""
import logging
import os
from datetime import datetime
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import cv2
import numpy as np
import pandas as pd
import torch

from ..data.inference import TrackNetInferenceImgDataset, TrackNetInferenceVideoDataset
from ..device import resolve_device
from ..models.tracknet import TrackNet
from ..nn.blocks import cast_conv_weights
from ..nn.reparam import deploy_transform
from ..ops.heatmap import decode_heatmap_peaks, hough_decode
from ..train.checkpoint import load_checkpoint
from ..utils.image import load_and_process_img
from ..weights import flax_to_state_dict
from .runner import (Device, _open_video_writer, _prefetch_batches, check_quantize,
                     quantize_model_int8)

logger = logging.getLogger(__name__)


def adv_repvgg_canonical(model_config: Dict[str, Any]) -> bool:
    """True when every `*repbipan*` module config of the advanced
    architecture has canonical RepVGG blocks (`repvgg_branch_act: null`;
    the default is "silu"), so that each block fuses into one conv."""
    adv = model_config.get("advanced_arch_config", {}) or {}
    for section in ("encoder_config", "decoder_config"):
        for key, cfg in (adv.get(section, {}) or {}).items():
            if "repbipan" in key and (cfg or {}).get("repvgg_branch_act", "silu") is not None:
                return False
    return True


def load_tracknet_model(weights_path: str, model_config: Dict[str, Any], num_stacks: int = 3,
                        use_reparam: bool = True, device: Device = None,
                        quantize: Optional[str] = None) -> TrackNet:
    """The TrackNet of a checkpoint manifest (either package's pickled
    format), in the deploy form unless `use_reparam=False`, with conv
    weights in bf16 on cuda and f32 on the CPU, in eval mode. The deploy
    form folds every BatchNorm into its conv and, for the advanced
    architecture with canonical RepVGG blocks (`adv_repvgg_canonical`),
    fuses each block into one 3x3 conv, as the JAX package does. With
    `quantize="int8"` the conv weights stay f32 until
    `infer.runner.quantize_model_int8`."""
    int8 = check_quantize(quantize, use_reparam)
    dev = resolve_device(device)
    state = flax_to_state_dict(load_checkpoint(weights_path)["NETWORK_PARAMS"])
    fuse_repvgg = (use_reparam and model_config.get("architecture") == "advanced"
                   and adv_repvgg_canonical(model_config))
    if use_reparam:
        state = deploy_transform(state, fuse_repvgg=fuse_repvgg)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = TrackNet(model_config, in_channels=3 * num_stacks, folded=use_reparam,
                     deploy=fuse_repvgg, dtype=dtype, device=dev)
    model.load_state_dict(state)
    return (model if int8 else cast_conv_weights(model, dtype)).eval()


@torch.no_grad()
def track_batch(model: TrackNet, frames, og_hw: Tuple[int, int], threshold: int = 128,
                decode: str = "centroid", hough_grad_config=None) -> np.ndarray:
    """(B, 3) tracks [x, y, r] in og_hw pixels of a batch of stacked NHWC
    frames (numpy, or a tensor already on the model's device), NaN where
    no ball was found."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(frames, device=dev).permute(0, 3, 1, 2)
    heatmaps = model(x, inference=True, og_size=og_hw)
    if decode == "hough":
        return hough_decode(heatmaps.cpu().numpy(), threshold, hough_grad_config)
    cx, cy, r, found = decode_heatmap_peaks(heatmaps, threshold=threshold)
    tracks = torch.stack([cx, cy, r], dim=1).double().cpu().numpy()
    tracks[~found.cpu().numpy()] = np.nan
    return tracks


def fill_gaps(tracks: np.ndarray) -> np.ndarray:
    """np.interp over the batch's missing rows when at least half of them
    were found (in place)."""
    found = ~np.isnan(tracks[:, 0])
    idxs = np.linspace(0, tracks.shape[0] - 1, num=tracks.shape[0])
    if np.any(found) and found.sum() >= found.shape[0] // 2:
        for c in range(3):
            tracks[:, c] = np.interp(idxs, idxs[found], tracks[:, c][found])
    return tracks


def draw_trace(img_rgb: np.ndarray, tracks: np.ndarray, idx: int, max_num_trace: int,
               max_circle_thickness: int) -> np.ndarray:
    """Frame idx as BGR with the trace of tracks[idx - j], j < max_num_trace,
    stopping before frame 0 (as the JAX package does)."""
    img = cv2.cvtColor(np.ascontiguousarray(img_rgb), cv2.COLOR_RGB2BGR)
    for j in range(max_num_trace):
        if idx - j <= 0:
            break
        t = tracks[idx - j]
        if not np.isnan(t[0]):
            img = cv2.circle(img, (int(t[0]), int(t[1])), radius=0, color=(100, 100, 255),
                             thickness=max_circle_thickness - j)
    return img


def _batches(items: Iterable[Tuple[np.ndarray, np.ndarray]], batch_size: int
             ) -> Iterator[Tuple[np.ndarray, list]]:
    buf_i, buf_o = [], []
    for stacked, og in items:
        buf_i.append(stacked)
        buf_o.append(og)
        if len(buf_i) == batch_size:
            yield np.stack(buf_i), buf_o
            buf_i, buf_o = [], []
    if buf_i:
        yield np.stack(buf_i), buf_o


def run_tracknet_inference(
    path: str,
    weights_path: str,
    config: Dict[str, Any],
    batch_size: int = 32,
    fps: int = 30,
    img_ext: str = "jpg",
    frame_skips: int = 0,
    with_summary: bool = False,
    max_num_trace: int = 5,
    max_circle_thickness: int = 10,
    decode: Optional[str] = None,
    use_reparam: bool = True,
    storage_path: Optional[str] = None,
    quantize: Optional[str] = None,
    device: Device = None,
) -> str:
    """Track the ball through a folder of frames or a video (.avi, .mkv,
    .mp4); returns the output directory. `quantize="int8"` calibrates on
    the first batch and serves int8 (needs the deploy form)."""
    dev = resolve_device(device)
    quantize_pending = check_quantize(quantize, use_reparam)
    tc = config["train_config"]
    num_stacks = int(tc["img_config"].get("num_stacks", 3))
    img_wh = tuple(tc["img_config"]["img_wh"])
    threshold = int(tc.get("heatmap_threshold", 128))
    decode = decode or tc.get("heatmap_decode", "centroid")
    if decode not in ("centroid", "hough"):
        raise ValueError(f"unknown decode {decode!r} (centroid|hough)")

    if os.path.isdir(path):
        dataset = TrackNetInferenceImgDataset(path, img_ext=img_ext, img_wh=img_wh,
                                              num_stacks=num_stacks)
        lead_in = [load_and_process_img(p, None, scale=False)
                   for p in dataset.img_files[:num_stacks - 1]]
    elif os.path.isfile(path) and path.endswith(("avi", "mkv", "mp4")):
        dataset = TrackNetInferenceVideoDataset(path, img_wh=img_wh, num_stacks=num_stacks,
                                                frame_skips=frame_skips)
        lead_in = []
        cap = cv2.VideoCapture(path)
        try:
            for _ in range(num_stacks - 1):
                ok, frame = cap.read()
                if ok:
                    lead_in.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        finally:
            cap.release()
    else:
        raise OSError(f"{path} not found or unsupported")

    model = load_tracknet_model(weights_path, config["model_config"], num_stacks,
                                use_reparam=use_reparam, device=dev, quantize=quantize)
    storage = storage_path or os.path.join(
        "outputs", "tracknet", str(datetime.now()).replace(":", "_"))
    os.makedirs(storage, exist_ok=True)

    tracks = [np.full(3, np.nan) for _ in lead_in]
    frames = list(lead_in)
    for _, dev_frames, ogs in _prefetch_batches(_batches(dataset, batch_size), dev):
        if quantize_pending:  # PTQ on the first stacked batch, then serve int8
            quantize_model_int8(model, torch.as_tensor(dev_frames, device=dev).permute(0, 3, 1, 2),
                                inference=True, og_size=ogs[0].shape[:2])
            quantize_pending = False
        batch_tracks = track_batch(model, dev_frames, ogs[0].shape[:2], threshold, decode,
                                   tc.get("hough_grad_config"))
        tracks += list(fill_gaps(batch_tracks))
        frames += ogs

    tracks_arr = np.asarray(tracks) if tracks else np.zeros((0, 3))
    vwriter = None
    try:
        for idx, og in enumerate(frames):
            if vwriter is None:
                vwriter = _open_video_writer(os.path.join(storage, "video.mp4"), fps,
                                             og.shape[:2])
            vwriter.write(draw_trace(og, tracks_arr, idx, max_num_trace, max_circle_thickness))
    finally:
        if vwriter is not None:
            vwriter.release()
    if with_summary:
        df = pd.DataFrame(tracks_arr, columns=["x", "y", "r"])
        df["frame"] = range(1, df.shape[0] + 1)
        df[["frame", "x", "y", "r"]].dropna(axis=0).to_csv(
            os.path.join(storage, "output.csv"), index=False)
    logger.info(f"outputs written to {storage}")
    return storage
