#!/usr/bin/env python3
"""Drive the PyTorch port's detection (with its alternate components),
keypoint detection, segmentation and TrackNet (base and advanced) paths on
one NVIDIA GPU, in bf16 and in the int8 post-training-quantized serve form,
and data-parallel (`--use_ddp` under torchrun, `make_dp_serve`), and hold
its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # also writes torch.profiler tables

Phases (any failure exits non-zero; nothing is caught):
1. build: nvcc compiles every csrc/*.cu of the serve path for sm_90a, one
   process per source, all started together.
2. serve: a DetectionNet at the shipped config (configs/detection, width 0.5,
   depth 0.3, 640x640, canonical RepVGG) with seeded random weights and
   BatchNorm state is written as a JAX-format checkpoint manifest; 8
   synthetic 1280x720 images are served through `run_detection_inference`
   at batch 4 in the deploy form, bf16. Both kernel launch counters are
   zeroed just before and read just after; each must have risen. The
   card's decoded predictions are then compared with the same checkpoint
   served in f32 on the CPU (the kernels' plain versions) within absolute
   limits per field group (MODEL_LIMITS). Warm end-to-end throughput is
   (32 - 8) images over the difference of two later calls on 32 and 8
   images, so each call's model load and first batch cancel.
3. kernels: each kernel runs at every shape the serve forward gave it and
   at ragged shapes (matmul M=1025, and K=20 N=5; conv Cin 3 -> Cout 5 at
   7x300, Cin 40 -> Cout 24 at 20x20), in bf16 on the card, against its
   plain version (f32 math, cast to bf16) within |k - p| <= 1e-2 + 1e-2 |p|:
   both round an f32 value to bf16 after summing in different orders, and
   one bf16 ulp is at most 2^-7 of the value. Kernel, plain and library
   (`torch.addmm`/`F.conv2d` + activation, cuDNN/cuBLAS, timed here and
   never used by the port) times are device times from CUDA events, summed
   per serve batch over the main path's launches, beside the bound
   max(bytes / 3.35 TB/s, bf16 FLOPs / 989 TFLOP/s) of the H100 SXM. Each
   shape's line also gives the achieved rate (TFLOP/s for the conv, TB/s
   for the matmul), the multiples of the bound and of the library time,
   and the output tile the C launcher chose.

4. video: a 1280x720 clip of 48 frames (two shapes sliding on disjoint
   lanes over a fixed textured background, from SEED) is written with cv2
   (mp4v) and served through `run_detection_inference` on the card at
   batch 4 with frame_skips 0 and 1 (ByteTrack, video.mp4, output.csv).
   The checkpoint is the serve phase's, with its conf and class layers
   rescaled on four of the clip's frames so that scores spread over
   ByteTrack's bands (the random net's scores all sit below its 0.35
   activation threshold). Both kernel counters are zeroed before and must
   have risen after; video.mp4 must hold 48 and 24 frames and output.csv
   track ids. The prefetched output must equal the serial one
   (VCT_INFER_PREFETCH=0). Reported: the share of the card's CSV rows that
   agree with the clip served in f32 on the CPU (same frame, track id and
   class, X/Y/W/H within 1 px; bf16 moves scores near a band edge, so it
   is not gated), and warm frames/s with and without the prefetch thread,
   (48 - 16) frames over the difference of a 48- and a 16-frame call.
5. train: 64 train and 16 valid synthetic 640x640 JPEGs (2-6 boxes each,
   YOLO labels, 80 classes) are written from SEED in a temp dir, with temp
   copies of the shipped config and anchors. The port's train_det entry
   point (`run`) trains the shipped model (full width, bf16 compute, f32
   parameters) at batch 16 for 2 epochs with an eval and --map_eval each
   epoch and the lr schedule. Each epoch's mean loss must be finite (so
   every step's is), and the metrics CSVs (eval_metrics.csv with a map50
   column), a snapshot and best_model/ (f32 conv kernels) must exist. The
   second epoch gives the train step time (host clock, the epoch's wall
   time over its steps, loader included) and images/s.
6. card vs CPU: one train step of one seeded net (anchors from the shipped
   configs/detection/anchors.yaml, not the temp copy the CLI's
   auto-anchors may have rewritten, so every machine holds one input; the
   CPU reference loss is printed) on one batch of 2 train images, on the
   card in f32 and in bf16 against the CPU in f32, by the
   loss (relative), the gradient of every parameter (cosine; the conv
   biases in front of a train-mode BatchNorm have no gradient in exact
   arithmetic and are skipped) and the BatchNorm running statistics after
   the step (max |card - cpu|), within TRAIN_LIMITS; the card's bf16
   gradients are held to the CPU's own bf16 step (BF16_COS_RATIO). First
   the reference is checked: the stem's train-mode BatchNorm on the CPU
   and on the card within REF_BN_LIMIT of f64.
7. learning: 20 steps on one fixed batch of 16 on the card; the last loss
   must be below the first. Steps 6-20 give the step time without the
   loader (host clock, synchronized).
8. serve what was trained: best_model/ through `run_detection_inference` on
   8 of the valid images; both kernel counters are zeroed before and must
   have risen after, and output.csv and the images must be written.
9. eval: the eval_det entry point on best_model/ over the 16 valid images,
   and on the net of phase 7, taken on to EVAL_LEARN_STEPS steps and saved
   as a checkpoint, over the 16 images it learned (so that mAP@50 is not
   zero), each on the card (deploy form, bf16,
   both kernels: the counters must rise) and on the CPU (f32, plain
   versions); the JSON line must have the JAX CLI's keys and |mAP@50 card
   - cpu| <= EVAL_MAP50_LIMIT.
10. remat: one seeded net at the shipped config takes one train step on 32
   train images at 640x640 in bf16 with `remat` off and one with it on,
   from the same state. The loss (relative), the gradients (1 - lowest
   cosine) and the BatchNorm running statistics (max |d|) must agree
   within the f32 limits of TRAIN_LIMITS, and remat's peak memory
   allocated must be lower. Both peaks and both step times (3 more steps
   each, host clock, synchronized) are printed.
11. seg serve: a SegmentationNet at the shipped seg config
   (configs/segmentation: the detector's widths, 32 masks, ProtoSegModule
   c_h 256) with seeded weights and BatchNorm state, as a JAX-format
   checkpoint, serves the 8 images through
   `run_detection_inference(task="segmentation")` on the card at batch 4,
   deploy form, bf16; both counters are zeroed before and must have risen
   after, once per routed conv per batch; the peak memory allocated is
   read over that call. Card vs CPU f32 on one batch: decoded logits,
   boxes and mask coefficients and the protos within SEG_MODEL_LIMITS and
   PROTO_LIMITS; the binary masks' IoU on the boxes both sides kept is
   reported. Warm images/s as in phase 2.
12. seg video: the clip once at frame_skips 1 with the seg checkpoint (its
   conf and class layers rescaled as in phase 4): video.mp4 must hold 24
   frames and both counters must rise.
13. seg train: 64 train and 16 valid 640x640 JPEGs with 2-6 filled polygons
   each (YOLO-seg labels, 80 classes) and temp copies of the seg config and
   anchors; `train_seg.run` at batch 16 for 2 epochs with the lr schedule.
   Each epoch's mean loss must be finite, and the metrics CSVs (with
   seg_loss, dice_score, seg_dropped_candidates), the snapshots and
   best_model/ must exist.
14. seg card vs CPU: phase 6 for the seg net with cap_policy "first" and
   the shipped seg anchors, as are phase 15's learned net's
   (SEG_TRAIN_LIMITS, BF16_COS_RATIO).
15. seg eval: the eval_seg entry point on best_model/ over the valid images,
   and on a seg net taken SEG_LEARN_STEPS steps on one batch of 16 over
   those 16 images, each on the card (both counters must rise) and on the
   CPU: the JAX CLI's keys, |card - cpu| of mask mAP@50 and dice within
   SEG_EVAL_LIMITS, and the learned net's mask mAP@50 and dice above 0.
16. tracknet serve: a TrackNet at the shipped config (configs/tracknet: the
   base architecture at width 1.0, 640x352, 3 stacked frames) with the
   uniform init and non-trivial BatchNorm state from SEED, as a JAX-format
   checkpoint, serves a synthetic 1280x720 clip of 40 frames (a ball on a
   parabola over a textured background, mp4v) through
   `run_tracknet_inference` at batch 8 and 32, and the same frames as a
   folder of JPEGs at batch 8; the conv3x3 counter is zeroed before and
   must have risen by 18 a batch after, and a global forward hook records
   the shape of every launch of that run (batches of 32, 8 and the 6-window
   tails); video.mp4 must hold 40 frames and output.csv [frame, x, y, r]
   rows of the 38 windows only. Warm frames/s at batch 32: (40 - 16)
   frames over the difference of a 40- and a 16-frame call, twice. Card
   bf16 vs CPU f32 logits of the first 2 windows of a batch of 32 within
   TN_LOGIT_LIMITS; the argmax agreement is reported, not gated (a random
   net's argmax is fragile).
17. tracknet train: 3 clips of 17 frames (the ball hidden in every 6th)
   with Label.csv under a temp dir and a temp copy of the shipped config;
   `train_tracknet.run` at batch 16 for 2 epochs with the lr schedule
   (Adadelta, bf16 compute, f32 parameters): finite losses, the metrics
   CSVs (every eval window scored once), 2 snapshots and best_model/ with
   18 f32 conv kernels. One train step on 1 window card vs CPU, f32 and
   bf16, as phase 6 (TN_TRAIN_LIMITS, BF16_COS_RATIO).
18. tracknet learning: a fourth clip's 16 windows (heatmaps of variance
   TN_LEARN_DIAMETER) as one fixed batch, the config's Adadelta: the loss
   must fall in 20 steps; the step time (steps 6-20) and the peak memory
   over them; then on until the train form hits the ball in a window (at
   most TN_LEARN_MAX_STEPS steps): the learned net of phase 19.
19. tracknet eval: `eval_tracknet`, train form and --deploy, on best_model/
   over the eval split and on the learned net over its clip's eval split,
   card and CPU: the JAX CLI's keys, |f1 card - cpu| <= TN_EVAL_F1_LIMIT,
   conv3x3 launches in the card's --deploy runs, the learned net's f1 > 0.
20. tracknet adv serve: phase 16 for the advanced architecture
   (configs/tracknet/config_advanced.yaml: CSPNet + RepBiPAN encoder,
   DeconvRepBiPAN + DeconvCSPNet decoder, width 0.5, depth 0.3, canonical
   RepVGG, uniform init), in the fused deploy form: both counters must
   rise by the net's launches a batch (printed) times the batches; then
   the clip once at batch 32 with use_reparam=False (the train form,
   which launches no kernel). Card vs CPU logits within
   TN_ADV_LOGIT_LIMITS.
21. tracknet adv train: phases 17 and 18 for the advanced config (Adam
   1e-3, the warm-restart schedule with eta_min 1e-5): train_tracknet.run,
   one step card vs CPU (TN_ADV_TRAIN_LIMITS), the learning check and the
   learned net.
22. tracknet adv eval: phase 19 on the advanced checkpoints; both kernels
   must launch in the --deploy runs.
23. int8 serve: the serve checkpoint through `run_detection_inference(
   quantize="int8")` on the 8 images at batch 4: the first batch
   calibrates on the card (one bf16 deploy forward), then every batch runs
   int8. All counters are zeroed before and read after: both s8 kernels
   must launch, their launches (the s8 matmul's include the im2col GEMMs
   of the stem and the 3x3/s2 convs) a batch times the batches, as a global
   forward hook records them. Warm int8 images/s as in phase 2 (not for
   seg: its serving is host-bound by mask handling, phase 11). Card vs
   CPU on one batch: the card calibrates and quantizes, the CPU reference
   (f32 activations, plain versions) takes the card's q parameters; the
   decoded predictions within INT8_MODEL_LIMITS, and the calibration
   absmax gap card (bf16) vs CPU (f32) per conv printed. The int8
   forward's ms a batch beside the bf16 deploy form's (phase 2).
24. int8 seg serve: phase 23 for the seg checkpoint (INT8_SEG_MODEL_LIMITS,
   INT8_PROTO_LIMITS).
25. tracknet int8 serve (in phase 16): the clip at batch 32 with
   quantize="int8": the s8 conv kernel and the bf16 conv3x3 kernel (for
   dec_13, which int8 leaves in bf16) must launch, each as recorded;
   warm frames/s in int8; card vs CPU logits with the card's q parameters
   (INT8_TN_LOGIT_LIMITS); int8 forward ms beside bf16.
26. tracknet adv int8 serve (in phase 20): phase 25 for the advanced net
   (both s8 kernels, the bf16 conv3x3 for deconv4; INT8_TN_ADV_LOGIT_LIMITS).
   Phases 9, 15, 19 and 22 also run their CLI with --quantize int8 on the
   learned net, card and CPU: |card - cpu| within the CLI's card-vs-CPU
   limit, |int8 - bf16| (card) within INT8_EVAL_GAP, the s8 conv launched.
27. s8 kernels: as phase 3, every s8 shape of the five int8 serve paths
   (TrackNet's at batch 32 and its 6-window tail) and ragged and
   element-path shapes (Cin or K 8 mod 16, Cin 9 and 126), on random int8
   operands against the plain version (exact f64 sums, the f32 epilogue)
   within |k - p| <= S8_RTOL |p| + S8_ATOL, one bf16 ulp; times of the
   kernel, the plain version and the library call (torch._int_mm on the
   1x1's matrix or the 3x3's im2col, then the epilogue in torch) beside
   the bound max(bytes / 3.35 TB/s, 2 M K N / 1979 TOP/s int8).
28. kp serve: a DetectionNet at the shipped keypoint config
   (configs/detection/config_kp.yaml: the detector's widths, 640x640, 2
   keypoints an object; anchors_kp.yaml; KP_CLASSES classes) with seeded
   weights and BatchNorm state, as a JAX-format checkpoint whose config
   carries num_keypoints, serves the 8 images through
   `run_detection_inference` at batch 4, deploy form, bf16: both counters
   zeroed before and risen after by the forward's launches a batch (the
   keypoint branch's 3x3 ConvBNorms run on conv3x3; its 1x1
   keypoints_layer, like the head's other 1x1 layers, on cuDNN), every
   image's keypoints drawn; warm images/s as in phase 2; card vs CPU f32
   on the first KP_CPU_IMAGES images of a batch, logits, boxes, keypoint
   xy (pixels) and visibility logits within KP_MODEL_LIMITS; the forward's
   ms a batch beside detection's.
29. kp train: N_KP_TRAIN + N_KP_VALID 640x640 PNGs by the rule of
   dev/make_shapes_dataset.py --keypoints and temp copies of config_kp.yaml
   and anchors_kp.yaml; `train_det.run` with --map_eval as in phase 5: the
   saved config must hold num_keypoints, eval_metrics.csv a pck column and
   the keypoint losses. One step card vs CPU as phase 6 (shipped
   anchors_kp.yaml, KP_TRAIN_LIMITS): kp_loss, kpv_loss and kpc_loss in
   f32 within phase 6's relative loss limit; in bf16 the loss and those
   terms, like the gradients, within BF16_COS_RATIO of the CPU's own bf16
   step's distance; the learning check (the loss and kp_loss must fall),
   its net taken on to EVAL_LEARN_STEPS steps.
30. kp eval: phase 9 with eval_det on the keypoint checkpoints: the JAX
   CLI's keys with pck10, pck_matched and num_visible_keypoints; map50
   within EVAL_MAP50_LIMIT and pck10 within KP_EVAL_PCK_LIMIT card vs CPU;
   the learned net's both above 0; and --quantize int8 (INT8_EVAL_GAP),
   int8 PCK printed beside bf16's.
31. kp video: the clip at frame_skips 1 with the kp checkpoint (conf and
   class layers rescaled as in phase 4, class mean KP_CLASS_MEAN), once
   with each class as tracked_classes: video.mp4 24 frames, both counters
   risen, output.csv of that class only, track rows in all, and 2
   keypoint rows drawn for each track row (the tracker's payload).
32. int8 kp serve: phase 23 for the kp checkpoint, keypoint xy and
   visibility logits within INT8_KP_LIMITS.
33. alternates serve: two nets, each configs/detection/config.yaml as
   shipped with keys changed (ALT_NETS) and written as a config file:
   resnet_basichead (ResNetBackBone with the shipped resnetbackbone_config,
   RepBiPAN with upsample_mode bilinear, BasicHead) and csp_s2d (the CSP
   backbone with space_to_depth_stem and early_min_channels 64), with
   seeded weights and BatchNorm state on the shipped anchors, serve the 8
   images at batch 4 as phase 2 does: both counters zeroed before and
   risen after by the forward's launches a batch (the s2d stem, Cin 12,
   and BasicHead's stem_layer run on conv3x3; ResNet's convs keep
   eval-mode BatchNorm on cuDNN), card vs CPU within ALT_MODEL_LIMITS.
34. serve-fast decode: ops/serve_decode.decode_and_postprocess on the
   card on one batch's raw fields of resnet_basichead (BasicHead's packed
   map) against the runner's decode + postprocess_detections: the same
   kept rows in each image up to the order of equal scores (FAST_LIMITS):
   the heads' raw-field maps and their per-anchor packing on the card.
35. alternates train: train_det.run (--map_eval) on the resnet_basichead
   config over phase 5's data, ALT_TRAIN_STEPS steps an epoch for 2
   epochs: the artifacts, the saved config keeping the alternate keys;
   one step card vs CPU of both nets as phase 6 (TRAIN_LIMITS).
36. alternates int8 serve: phase 23 for both nets (ALT_INT8_LIMITS; no
   warm rate): the s2d stem runs on the s8 conv kernel's element path.
37. alternates eval: eval_det on the trained resnet_basichead best_model,
   card and CPU, as phase 9.
38. ddp train: `torchrun --standalone --nproc_per_node 1 -m
   vision_conglomerate_torch.train_det --use_ddp` (NCCL, a world of one,
   through the code a world of many runs) at the shipped config on
   DDP_TRAIN of phase 5's synthetic images, batch 16, 2 epochs, --map_eval:
   finite losses in the CSVs, best_model/, a snapshot an epoch whose lr is
   the config's times the world size. Then one bf16 step on 2 images in a
   world of one against the plain step from one state (DDP_STEP_LIMITS:
   bit for bit on an H100), and the step times at batch 16, plain and DDP in
   turns.
39. ddp serve: the DDP-trained best_model/ through run_detection_inference
   on 8 images: both kernel counters must rise.
40. make_dp_serve: the DDP-trained deploy-form net's serve (forward, decode,
   NMS) wrapped by `parallel.serving.make_dp_serve` in a world of one
   against the plain serve on one batch of 4 (DDP_SERVE_LIMITS); both
   counters must rise.
41. tracknet ddp: train_tracknet's main with --use_ddp in this process (a
   world of one on a free local port) at the shipped TrackNet config on
   phase 17's clips, batch 16, 2 epochs: finite losses, the artifacts, the
   lr times the world size.
decode_backend "native" has no phase: the H100 machine has g++ but not the
libjpeg and libpng headers (jpeglib.h, png.h), so csrc/vct_data.cc cannot
build there; the CPU tests hold it (tests/test_torch_native_decode.py).
The kernel phase (3) runs last, over the shapes of the seven serve paths
(TrackNet's, base and advanced: every shape its serve run launched, at
batch 32, 8 and 6), and prints each kernel's sums per batch of each path
(TrackNet's per batch of 32); then dec_13 at batch 64 (3.7e9 output
elements, past 2^31) against the plain conv of its last image.
With --profile, 3 fixed-batch train steps and 3 int8 serve forwards
(chiprun_out/int8_serve_profile.txt) are profiled too: device-busy share
and the top device ops (chiprun_out/train_profile.txt, and
chiprun_out/tn_train_profile.txt and tn_adv_train_profile.txt for
TrackNet).

Output: per-shape lines, then a `{"kernels": [...]}` JSON line (the two
bf16 kernels with phase 2's launches, the two s8 kernels with phase
23's), the card's
name and power limit, and as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Details go to chiprun_out/chip_smoke.json. Without CUDA, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
NUM_CLASSES = 80
N_IMAGES = 8
VIDEO_FRAMES, VIDEO_SHORT = 48, 16
VIDEO_FPS = 30
VIDEO_HW = (720, 1280)
# the video runs: the CLI's score threshold, at most 20 boxes per frame
VIDEO_KW = dict(batch_size=4, score_threshold=0.3, max_detections=20, with_summary=True)
WARM_IMAGES = 32
BATCH = 4
SEED = 0
KERNEL_RTOL = KERNEL_ATOL = 1e-2
# card bf16 vs CPU f32 decoded predictions of one batch, (max, mean) of
# |card - cpu| per field group: about 3x what this script read on an H100
# (PERF.md), logits (conf and class) 1.18e-3 and 1.70e-4, boxes (pixels of
# the 1280x720 originals) 0.0722 and 0.00365. Absolute, so the boxes' grid
# offset (up to 1280 px, the same on both sides) does not widen them.
MODEL_LIMITS = {"logits": (3.5e-3, 5e-4), "boxes": (0.22, 0.011)}

# One train step at 640x640 on 2 images against the CPU f32 step, for the
# card in f32 (TF32 off) and in bf16: the loss's relative difference, 1 -
# the lowest gradient cosine over the parameters, and max |d| of the
# BatchNorm running statistics, about 3x what this script read on an H100
# (PERF.md): f32 1.02e-6, 2.38e-4, 1.93e-4; bf16 1.43e-3 and 8.92e-2. In
# bf16 single gradients sit far from the f32 ones (the JAX package's too:
# the activations between layers are bf16), so the bf16 gradients are held
# to the CPU's own bf16 step instead: their 1 - cosine from the f32 step,
# all gradients as one vector and the median over parameters, may be at
# most BF16_COS_RATIO times the CPU bf16 step's (read: 1.48 and 1.52).
TRAIN_LIMITS = {
    "f32": {"loss_rel": 3e-6, "one_minus_min_cos": 7e-4, "bn_stats": 6e-4},
    "bf16": {"loss_rel": 4.5e-3, "bn_stats": 0.27},
}
BF16_COS_RATIO = 3.0
# the relative L2 error of the stem's train-mode BatchNorm against f64 on
# the CPU and on the card (reference_batchnorm): f32 rounding is about 2e-7
# (torch's CPU kernel on the phase-6 stem's channels_last map read 2.1e-5,
# the card 9.3e-8; NVIDIA H100 80GB HBM3, 700.00 W)
REF_BN_LIMIT = 1e-6
# |mAP@50 card bf16 - cpu f32| of eval_det, about 3x the larger of the two
# readings on the learned net, 0.00769 and 0.0312 (NVIDIA H100 80GB HBM3,
# 700.00 W). The learned images hold about one box of each class, so a
# class's AP is about 1 / the rank of its one hit: one hit a rank lower
# moves mAP@50 by about 0.008
EVAL_MAP50_LIMIT = 0.1
# the root eval_det.py's JSON keys for a model without keypoints
EVAL_KEYS = ["map50", "iou_threshold", "ap_per_class", "num_gt_per_class", "num_images",
             "weights", "data_dir", "quantize"]
REMAT_BATCH = 32
TRAIN_BATCH = 16
TRAIN_EPOCHS = 2
N_TRAIN, N_VALID = 64, 16
LEARN_STEPS = 20
# the learning phase's net goes on to this many steps before eval_det
# scores it on the images it learned; the seg net takes SEG_LEARN_STEPS
EVAL_LEARN_STEPS = 100
SEG_LEARN_STEPS = 400

# The segmentation phases (configs/segmentation: the detector's widths
# plus 32 masks and a ProtoSegModule of c_h 256). Card bf16 vs CPU f32 on
# one serve batch, (max, mean) |card - cpu|: about 3x what this script read
# on an H100 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): logits 1.13e-3 and
# 1.73e-4, boxes 0.243 and 8.68e-3 px, coefficients 1.11e-3 and 1.90e-4,
# protos 7.44e-4 and 1.09e-4.
SEG_MODEL_LIMITS = {"logits": (3.5e-3, 5e-4), "boxes": (0.75, 0.026), "coefs": (3.5e-3, 6e-4)}
PROTO_LIMITS = (2.3e-3, 3.5e-4)
# one seg train step (cap_policy "first") against the CPU f32 step, about 3x
# the readings: f32 loss rel 1.30e-7, 1 - lowest cosine 5.17e-8, BatchNorm
# 3.12e-5; bf16 loss rel 6.80e-4, BatchNorm 0.111 (bf16 gradients held by
# BF16_COS_RATIO, read 1.13 and 1.14)
SEG_TRAIN_LIMITS = {
    "f32": {"loss_rel": 4e-7, "one_minus_min_cos": 1.6e-7, "bn_stats": 1e-4},
    "bf16": {"loss_rel": 2e-3, "bn_stats": 0.33},
}
# |card bf16 - cpu f32| of eval_seg's mask mAP@50 and dice. Both read 0 on
# both checkpoints; the learned images hold about one instance of each of
# ~64 classes, so one instance matched on one side only moves either by
# about 1/64: the limit is three such flips
SEG_EVAL_LIMITS = {"mask_map50": 0.05, "dice": 0.05}
# the root eval_seg.py's JSON keys
SEG_EVAL_KEYS = ["mask_map50", "dice", "dice_matched", "mask_recall50", "box_map50",
                 "iou_threshold", "mask_ap_per_class", "num_gt_per_class", "num_images",
                 "weights", "data_dir", "quantize", "crop_masks"]

# The keypoint phases (configs/detection/config_kp.yaml: the detector's
# widths with 2 keypoints an object, keypoints_w 5.0, anchors_kp.yaml; the
# shapes data of dev/make_shapes_dataset.py --keypoints has 2 classes).
KP, KP_CLASSES = 2, 2
KP_TERMS = ("kp_loss", "kpv_loss", "kpc_loss")
N_KP_TRAIN, N_KP_VALID = 32, 16
KP_CPU_IMAGES = 2  # the CPU f32 reference of the kp serve batch
# card bf16 vs CPU f32 decoded predictions of the kp serve batch, (max,
# mean) |card - cpu| per field group; logits and boxes as MODEL_LIMITS
# (read 8.72e-4 and 1.95e-4, 0.107 and 3.67e-3 px), keypoint xy (pixels of
# the 1280x720 originals) and visibility logits about 3x the first reading
# on an H100 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): 0.0278 and
# 2.09e-3 px, 1.01e-3 and 1.43e-4
KP_MODEL_LIMITS = {**MODEL_LIMITS, "kp_xy": (0.083, 6.3e-3), "kp_vis": (3e-3, 4.3e-4)}
# one kp train step against the CPU f32 step: f32 as phase 6 (read: loss
# rel 1.17e-6; kp_loss, kpv_loss, kpc_loss rel 1.50e-6, 1.13e-6, 6.59e-7).
# In bf16 the keypoint terms move with the rounding of the head's raw
# visibility logits: the CPU's own bf16 step reads loss rel 1.38e-2, beyond
# phase 6's bf16 loss limit, and the card's 9.28e-3 is nearer f32 than that.
# So the bf16 loss and its keypoint terms are held, as every net's bf16
# gradients are, to the CPU's own bf16 step (BF16_COS_RATIO); the BatchNorm
# statistics keep phase 6's limit.
KP_TRAIN_LIMITS = {"f32": TRAIN_LIMITS["f32"],
                   "bf16": {"bn_stats": TRAIN_LIMITS["bf16"]["bn_stats"]}}
# |PCK@0.1 card bf16 - cpu f32| of eval_det on the kp checkpoints, about 3x
# the first reading, 0.0084 on the learned net: its 16 images hold about
# 119 visible keypoints, so one keypoint judged otherwise moves PCK by 0.0084
KP_EVAL_PCK_LIMIT = 0.025
# the class logits' mean after the video rescale (tracking_checkpoint): with
# 2 classes the larger of two logits of std 2 sits near mean + 1.1, so a mean
# of 3 puts it where the largest of 80 sits at mean 0 (near 4.6), and the
# scores reach ByteTrack's births (0.45)
KP_CLASS_MEAN = 3.0
# the root eval_det.py's JSON keys for a keypoint model
KP_EVAL_KEYS = EVAL_KEYS[:2] + ["pck10", "pck_matched", "num_visible_keypoints"] + EVAL_KEYS[2:]

KERNELS = {
    "matmul": dict(name="matmul_bias_act", route="cuda",
                   source="vision_conglomerate_torch/csrc/matmul_bias_act.cu",
                   replaces="vision_conglomerate_tpu/ops/fused_matmul.py:39"),
    "conv3x3": dict(name="conv3x3_bias_act", route="cuda",
                    source="vision_conglomerate_torch/csrc/conv3x3_bias_act.cu",
                    replaces="vision_conglomerate_tpu/ops/conv_pallas.py:101"),
}
# The s8 kernels of the int8 serve form. They replace no Pallas kernel: the
# JAX package computes its int8 convs as XLA convs in quantized_conv
# (nn/quantize.py:67), which `replaces` names.
S8_KERNELS = {
    "matmul_s8": dict(name="matmul_s8_bias_act", route="cuda",
                      source="vision_conglomerate_torch/csrc/matmul_s8_bias_act.cu",
                      replaces="vision_conglomerate_tpu/nn/quantize.py:67"),
    "conv3x3_s8": dict(name="conv3x3_s8_bias_act", route="cuda",
                       source="vision_conglomerate_torch/csrc/conv3x3_s8_bias_act.cu",
                       replaces="vision_conglomerate_tpu/nn/quantize.py:67"),
}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


@contextlib.contextmanager
def phase_clock(label: str):
    """Prints the host seconds the phases under `label` took."""
    t0 = time.time()
    yield
    print(f"phase time: {label} {time.time() - t0:.1f} s (host clock)")


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms. A sleep kernel holds the stream
    while the host queues all iterations, so host launch overhead between
    them does not count."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak_ops: float = PEAK_BF16_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def counters():
    from vision_conglomerate_torch.ops.conv3x3 import conv3x3_bias_act
    from vision_conglomerate_torch.ops.fused_matmul import matmul_bias_act

    return matmul_bias_act, conv3x3_bias_act


def s8_counters():
    from vision_conglomerate_torch.ops.int8 import conv3x3_s8_bias_act, matmul_s8_bias_act

    return matmul_s8_bias_act, conv3x3_s8_bias_act


def zero_counters():
    from vision_conglomerate_torch.ops.int8 import conv_s8_bias_act

    for fn in counters() + s8_counters():
        fn.launches = 0
    conv_s8_bias_act.calls = 0


def read_counters():
    mm, conv = counters()
    return {"matmul": mm.launches, "conv3x3": conv.launches}


def read_s8_counters():
    """The s8 kernels' launches and the calls of the int8 im2col route
    (`im2col`: the stem and the 3x3/s2 convs, whose GEMM is a launch of
    the s8 matmul kernel)."""
    from vision_conglomerate_torch.ops.int8 import conv_s8_bias_act

    mm, conv = s8_counters()
    return {"matmul_s8": mm.launches, "conv3x3_s8": conv.launches,
            "im2col": conv_s8_bias_act.calls}


def build_kernels():
    from vision_conglomerate_torch.ops import _cuda

    t0 = time.time()
    logs = _cuda.build(["matmul_bias_act", "conv3x3_bias_act", "matmul_s8_bias_act",
                        "conv3x3_s8_bias_act"])
    print(f"build: {time.time() - t0:.1f} s for {len(logs)} kernel sources (nvcc, sm_90a)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")


def make_inputs(root: str):
    """Checkpoint, config and images of the serve phase, from SEED, and the
    train-form net the checkpoint holds (on the CPU)."""
    from vision_conglomerate_torch.models.detection import DetectionNet
    from vision_conglomerate_torch.nn.blocks import init_weights_, randomize_batchnorm_
    from vision_conglomerate_torch.train.checkpoint import save_checkpoint
    from vision_conglomerate_torch.utils import load_yaml
    from vision_conglomerate_torch.weights import state_dict_to_flax
    from PIL import Image

    config = load_yaml(os.path.join(REPO, "configs", "detection", "config.yaml"))
    anchors = load_yaml(os.path.join(REPO, "configs", "detection", "anchors.yaml"))["anchors"]
    g = torch.Generator().manual_seed(SEED)
    net = DetectionNet(NUM_CLASSES, config["model_config"], anchors=anchors, device="cpu")
    randomize_batchnorm_(init_weights_(net, g), g)
    ckpt = os.path.join(root, "DetectionNet.ckpt.tar")
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                           "NETWORK_PARAMS": state_dict_to_flax(net.state_dict())})
    img_dirs = {n: os.path.join(root, f"imgs{n}") for n in (N_IMAGES, WARM_IMAGES)}
    for d in img_dirs.values():
        os.makedirs(d)
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:720, 0:1280]
    for i in range(WARM_IMAGES):
        base = 128 + 100 * np.sin(xx / (40 + 10 * i))[..., None] * np.cos(yy / 60.0)[..., None]
        img = np.clip(base + rng.normal(0, 20, size=(720, 1280, 3)), 0, 255).astype(np.uint8)
        path = os.path.join(img_dirs[WARM_IMAGES], f"img_{i:02d}.png")
        Image.fromarray(img).save(path)
        if i < N_IMAGES:
            os.link(path, os.path.join(img_dirs[N_IMAGES], f"img_{i:02d}.png"))
    return config, ckpt, img_dirs, net


def serve(config, ckpt, img_dir, storage, task="detection", quantize=None):
    """One run_detection_inference call at this script's settings;
    returns (host-clock seconds, output dir)."""
    from vision_conglomerate_torch.infer.runner import run_detection_inference

    t0 = time.time()
    out = run_detection_inference(img_dir, ckpt, config, task=task, batch_size=BATCH,
                                  score_threshold=0.01, with_summary=True, storage_path=storage,
                                  device="cuda", quantize=quantize)
    torch.cuda.synchronize()
    return time.time() - t0, out


def kernel_conv(m):
    """(route, conv) of a deploy-form module whose conv runs on a kernel,
    else None."""
    from vision_conglomerate_torch.nn.blocks import ConvBNorm, RepVGGBlock, kernel_route

    conv = None
    if isinstance(m, ConvBNorm) and m.folded:
        conv = getattr(m, "conv", None)  # none in the int8 form
    elif isinstance(m, RepVGGBlock) and m.deploy:
        conv = getattr(m, "conv_reparam", None)
    route = conv is not None and kernel_route(conv, m.activation)
    return (route, conv) if route else None


def record_kernel_shapes(model):
    """Forward hooks that list (route, NCHW input shape, Cout, activation)
    of every kernel-routed conv the model runs."""
    seen, handles = [], []
    for m in model.modules():
        routed = kernel_conv(m)
        if routed:
            handles.append(m.register_forward_hook(
                lambda mod, inp, out, r=routed[0], c=routed[1]: seen.append(
                    (r, tuple(inp[0].shape), c.out_channels, mod.activation))))
    return seen, handles


@contextlib.contextmanager
def recording_kernel_shapes():
    """Lists, as record_kernel_shapes does, every kernel-routed conv that
    runs inside the block, in any model, and every int8 conv (`int8_conv`):
    a global forward hook, for entry points that build their model
    themselves."""
    seen = []

    def hook(mod, inp, out):
        routed = kernel_conv(mod)
        if routed:
            seen.append((routed[0], tuple(inp[0].shape), routed[1].out_channels, mod.activation))
        elif int8_conv(mod):
            seen.append(int8_conv(mod, tuple(inp[0].shape)))

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def compare_models(config, ckpt, img_dir, limits=MODEL_LIMITS, tag="serve"):
    """Card (bf16, kernels) vs CPU (f32, plain versions) on one batch, by
    field group within `limits`; also the forward's kernel shapes and its
    device throughput. `tag` labels the printed lines."""
    from vision_conglomerate_torch.data.inference import InferenceImgDataset
    from vision_conglomerate_torch.infer.runner import detect, load_detection_model

    mc = config["model_config"]
    img_wh = tuple(config["train_config"]["img_config"]["img_wh"])
    ds = InferenceImgDataset(img_dir, img_wh=img_wh)
    t0 = time.time()
    items = [ds[i] for i in range(BATCH)]
    load_ms = (time.time() - t0) / BATCH * 1e3
    imgs = np.stack([a for a, _ in items])
    og_hw = items[0][1].shape[:2]
    t0 = time.time()
    gpu_model, _ = load_detection_model(ckpt, mc, device="cuda")
    torch.cuda.synchronize()
    print(f"{tag}: model load (checkpoint -> deploy form, bf16 on the card) "
          f"{time.time() - t0:.3f} s")
    cpu_model, _ = load_detection_model(ckpt, mc, device="cpu")
    seen, handles = record_kernel_shapes(gpu_model)
    got = detect(gpu_model, imgs, og_hw)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    want = detect(cpu_model, imgs, og_hw)
    m = 3 * sum((img_wh[0] // s) * (img_wh[1] // s) for s in (8, 16, 32))
    check(tuple(got.shape) == tuple(want.shape) == (BATCH, m, 5 + NUM_CLASSES),
          f"pred shapes {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite predictions on the card")
    stats = {}
    for group, sl in (("logits", slice(0, 1 + NUM_CLASSES)),
                      ("boxes", slice(1 + NUM_CLASSES, 5 + NUM_CLASSES))):
        diff = (got[..., sl].cpu() - want[..., sl]).abs()
        max_lim, mean_lim = limits[group]
        stats[group] = dict(max_abs_err=diff.max().item(), mean_abs_err=diff.mean().item(),
                            max_ref=want[..., sl].abs().max().item())
        print(f"{tag}: card bf16 vs cpu f32 {group}: max |d| {diff.max().item():.6g} "
              f"(limit {max_lim:g}), mean |d| {diff.mean().item():.6g} (limit {mean_lim:g}), "
              f"max |ref| {stats[group]['max_ref']:.6g}")
        check(diff.max().item() <= max_lim and diff.mean().item() <= mean_lim,
              f"{tag}: card predictions differ from the CPU reference in {group}")

    x = torch.from_numpy(imgs).cuda()

    def forward():
        with torch.no_grad():
            gpu_model(x.permute(0, 3, 1, 2), inference=True, og_size=og_hw)

    forward()
    torch.cuda.synchronize()
    iters = 10
    t0 = time.time()
    for _ in range(iters):
        forward()
    torch.cuda.synchronize()
    fwd_ms = (time.time() - t0) / iters * 1e3
    print(f"{tag}: forward + decode at batch {BATCH}: {fwd_ms:.3f} ms/batch "
          f"= {BATCH / fwd_ms * 1e3:.1f} images/s (host clock, synchronized)")
    host = host_phases(got, items[0][1])
    host["decode_resize_ms_per_image"] = load_ms
    print(f"{tag}: host clock, " + ", ".join(f"{k} {v:.3f}" for k, v in host.items()))
    return seen, stats, fwd_ms, host, (gpu_model, forward)


def host_phases(preds, og_img):
    """Host-clock times of the serve loop's other phases, as
    run_detection_inference runs them at this script's settings:
    postprocess + NMS of one batch (on the card, synchronized), and the
    drawing and PNG encode of one image's kept boxes."""
    import io

    from PIL import Image
    from vision_conglomerate_torch.ops.postprocess import postprocess_detections
    from vision_conglomerate_torch.utils.drawing import apply_bboxes

    def post():
        p = postprocess_detections(preds, NUM_CLASSES, iou_threshold=0.35,
                                   score_threshold=0.01, box_allowance=4.0)
        return [t.cpu().numpy() for t in p]

    post()
    t0 = time.time()
    boxes, scores, classes, valid, _, _ = post()
    nms_ms = (time.time() - t0) * 1e3
    kept = np.concatenate([scores[0][:, None], classes[0][:, None].astype(np.float32),
                           boxes[0]], axis=-1)[valid[0]]
    t0 = time.time()
    img = apply_bboxes(og_img.copy(), kept, box_thickness=2, text_thickness=1)
    draw_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    Image.fromarray(img).save(io.BytesIO(), format="png")
    png_ms = (time.time() - t0) * 1e3
    return {"postprocess_nms_ms_per_batch": nms_ms, "boxes_kept_image0": float(len(kept)),
            "draw_ms_per_image": draw_ms, "png_encode_ms_per_image": png_ms}


RAGGED = {
    ("matmul", (1, 64, 1025, 1), 64, "silu"),  # M = 1025, not a multiple of 128
    ("matmul", (1, 20, 100, 1), 5, "relu"),  # K, N not multiples of 8
    ("conv3x3", (1, 3, 7, 300), 5, "silu"),  # Cin, Cout not multiples of 8
    ("conv3x3", (1, 40, 20, 20), 24, "silu"),  # 9 * Cin not a multiple of 64
}
S8_RAGGED = {
    ("matmul_s8", (1, 64, 1025, 1), 64, "silu"),  # M = 1025, not a multiple of 128
    ("matmul_s8", (1, 20, 100, 1), 5, "relu"),  # K, N not multiples of 16
    ("matmul_s8", (1, 24, 300, 1), 40, "silu"),  # K = 24: 8 mod 16, the element path
    ("conv3x3_s8", (1, 3, 7, 300), 5, "silu"),  # Cin, Cout not multiples of 16
    ("conv3x3_s8", (1, 40, 20, 20), 24, "silu"),  # Cin 40: 8 mod 16, the element path
    ("conv3x3_s8", (2, 9, 44, 80), 64, "relu"),  # TrackNet enc_0's Cin 9 at a small map
    ("conv3x3_s8", (2, 126, 22, 40), 128, "relu"),  # dec_8's Cin 126 at a small map
}
# |s8 kernel - plain| <= S8_RTOL |plain| + S8_ATOL: both hold the same
# exact int32 sums and round f32 to bf16 once; the kernel's multiply, add
# and SiLU (__expf) differ from torch's in the last f32 bits, which moves a
# value by at most one bf16 ulp (2^-8..2^-7 of it). First reading on an
# H100 (NVIDIA H100 80GB HBM3, 700.00 W, a build check of 19 shapes):
# max |err| / |plain| 0.0074, exact at 14 of 19 shapes
S8_RTOL, S8_ATOL = 2.0 ** -7, 1e-6


def kernel_cases(paths, extra=(), ragged=RAGGED):
    """Distinct kernel shapes of one batch of each path ({path: shapes
    seen}), each with its launches per batch on every path, plus the
    `extra` shapes (those a path runs in other batches than the one
    listed) and ragged shapes that no path gives."""
    counts = {path: Counter(seen) for path, seen in paths.items()}
    shapes = set().union(*counts.values(), extra) | set(ragged)
    return {shape: {path: c[shape] for path, c in counts.items()} for shape in shapes}


def launcher_tile(route, m, n, k):
    """The (BM, BN) tile the C launcher picks for an M x N x K GEMM on card 0."""
    from vision_conglomerate_torch.ops import _cuda, conv3x3, fused_matmul, int8

    if route in S8_KERNELS:
        name = S8_KERNELS[route]["name"]
        argtypes = int8._MATMUL_ARGTYPES if route == "matmul_s8" else int8._CONV_ARGTYPES
    else:
        name = KERNELS[route]["name"]
        argtypes = (fused_matmul if route == "matmul" else conv3x3)._ARGTYPES
    lib = _cuda.load(name, argtypes, 0)
    return _cuda.tile(lib, name, m, n, k, torch.cuda.get_device_properties(0).multi_processor_count)


def run_case(route, shape, cout, act, g):
    from vision_conglomerate_torch.ops.conv3x3 import conv3x3_bias_act, conv3x3_bias_act_plain
    from vision_conglomerate_torch.ops.fused_matmul import (
        apply_activation, matmul_bias_act, matmul_bias_act_plain)

    b, cin, h, w = shape
    dev = "cuda"
    bias = torch.randn(cout, device=dev, generator=g)
    if route == "matmul":
        m = b * h * w
        x = torch.randn(m, cin, device=dev, generator=g).bfloat16()
        # (Cin, Cout) view of a (Cout, Cin) weight, as the serve path passes it
        wt = (torch.randn(cout, cin, device=dev, generator=g) / cin ** 0.5).bfloat16().t()
        kern = lambda: matmul_bias_act(x, wt, bias, act)  # noqa: E731
        plain = lambda: matmul_bias_act_plain(x, wt, bias, act)  # noqa: E731
        lib = lambda: apply_activation(torch.addmm(bias.bfloat16(), x, wt), act)  # noqa: E731
        nbytes = 2 * (m * cin + cin * cout + m * cout) + 4 * cout
        flops = 2 * m * cin * cout
    else:
        x = torch.randn(b, h, w, cin, device=dev, generator=g).bfloat16()
        # HWIO view of a channels_last OIHW weight, as the serve path passes it
        w_oihw = (torch.randn(cout, 3, 3, cin, device=dev, generator=g) / (9 * cin) ** 0.5
                  ).bfloat16().permute(0, 3, 1, 2)
        wt = w_oihw.permute(2, 3, 1, 0)
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last
        kern = lambda: conv3x3_bias_act(x, wt, bias, act)  # noqa: E731
        plain = lambda: conv3x3_bias_act_plain(x, wt, bias, act)  # noqa: E731
        lib = lambda: apply_activation(  # noqa: E731
            F.conv2d(x_nchw, w_oihw, bias.bfloat16(), padding=1), act)
        nbytes = 2 * (b * h * w * cin + 9 * cin * cout + b * h * w * cout) + 4 * cout
        flops = 2 * b * h * w * 9 * cin * cout
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    ok = bool((err <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs()).all())
    bnd, by = bound_ms(nbytes, flops)
    return dict(route=route, shape=list(shape), cout=cout, act=act, ok=ok,
                max_abs_err=err.max().item(), ms=device_ms(kern), plain_ms=device_ms(plain),
                library_ms=device_ms(lib), bound_ms=bnd, bound_by=by, bytes=nbytes, flops=flops,
                tile=list(launcher_tile(route, b * h * w, cout, cin if route == "matmul" else 9 * cin)))


def run_s8_case(route, shape, cout, act, g):
    """One s8 kernel shape on random int8 operands against its plain
    version (exact f64 sums, the f32 epilogue, bf16), timed with the plain
    version and the library call: torch._int_mm (int8 -> int32) on the
    1x1's matrix, or on the 3x3's im2col, then the same epilogue in torch.
    The bound counts x and w once (int8), y once (bf16), and 2 M K N
    operations at the int8 rate."""
    from vision_conglomerate_torch.ops import int8

    b, cin, h, w = shape
    dev = "cuda"
    taps = 1 if route == "matmul_s8" else 9
    k = taps * cin
    x = torch.randint(-127, 128, (b, h, w, cin), device=dev, generator=g, dtype=torch.int8)
    # HWIO view of a channels_last OIHW q_kernel, as the serve path passes it
    kh = 1 if taps == 1 else 3
    w_hwio = torch.randint(-127, 128, (cout, kh, kh, cin), device=dev, generator=g,
                           dtype=torch.int8).permute(1, 2, 3, 0)
    scale = torch.rand(cout, device=dev, generator=g) * (4.0 / (127 * 127 * k ** 0.5))
    bias = torch.randn(cout, device=dev, generator=g)
    pad = (kh // 2, kh // 2)
    if taps == 1:
        xm, wm = x.reshape(b * h * w, cin), w_hwio.reshape(cin, cout)
        kern = lambda: int8.matmul_s8_bias_act(xm, wm, scale, bias, act)  # noqa: E731
        plain = lambda: int8.matmul_s8_bias_act_plain(  # noqa: E731
            xm, wm, scale, bias, act, torch.bfloat16)
    else:
        kern = lambda: int8.conv3x3_s8_bias_act(x, w_hwio, scale, bias, act)  # noqa: E731
        plain = lambda: int8.conv3x3_s8_bias_act_plain(  # noqa: E731
            x, w_hwio, scale, bias, act, torch.bfloat16)
    if taps == 1:
        cols, wc = xm, wm.contiguous()
    else:
        cols = int8.im2col_s8(x, (kh, kh), (1, 1), pad)
        wc = int8.im2col_weights(w_hwio, cols.shape[1])
    lib = lambda: int8.dequantize(  # noqa: E731
        torch._int_mm(cols, wc), scale, bias, act, torch.bfloat16)
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().reshape(-1)
    ok = bool((err <= S8_ATOL + S8_RTOL * want.float().abs().reshape(-1)).all())
    m = b * h * w
    nbytes = m * cin + k * cout + 2 * m * cout + 8 * cout
    ops = 2 * m * k * cout
    bnd, by = bound_ms(nbytes, ops, PEAK_INT8_OPS)
    try:  # the yardstick only: cuBLAS takes no int8 GEMM of some ragged shapes
        library = device_ms(lib, iters=5)
    except RuntimeError as e:
        print(f"kernel {S8_KERNELS[route]['name']} {list(shape)} -> {cout}: no library time "
              f"({str(e).splitlines()[0][:120]})")
        library = None
    return dict(route=route, shape=list(shape), cout=cout, act=act, ok=ok,
                max_abs_err=err.max().item(), ms=device_ms(kern),
                plain_ms=device_ms(plain, iters=1), library_ms=library,
                bound_ms=bnd, bound_by=by, bytes=nbytes, flops=ops,
                tile=list(launcher_tile(route, m, cout, k)))


def kernel_phase(paths, extra=None, kernels=KERNELS, runner=run_case, ragged=RAGGED,
                 main="serve"):
    """Every shape of every path against the plain version, timed. paths:
    {path: (shapes seen in one batch's forward, launches on the path's
    run)}; `main` is the main path of the JSON line's `launches` and
    per-batch sums, and every other path adds its own under its name.
    extra: {shape: what runs it} for shapes that a path launches in its
    other batches (another batch size, a tail), held and timed too but
    left out of the per-batch sums. `kernels`, `runner` and `ragged`: the
    bf16 kernels (run_case) or the s8 ones (run_s8_case)."""
    extra = extra or {}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    cases = kernel_cases({p: [s for s in v[0] if s[0] in kernels] for p, v in paths.items()},
                         {s: v for s, v in extra.items() if s[0] in kernels}, ragged)
    for (route, shape, cout, act), per_batch in sorted(cases.items()):
        r = runner(route, shape, cout, act, g)
        r["launches_per_batch"] = per_batch
        rows.append(r)
        b, cin, h, w = shape
        if route.startswith("matmul"):
            desc, rate = f"M={b * h * w} K={cin} N={cout}", f"{r['bytes'] / r['ms'] / 1e9:.3f} TB/s"
        else:
            unit = "TOP/s" if route in S8_KERNELS else "TFLOP/s"
            desc, rate = f"B={b} {h}x{w} {cin}->{cout}", f"{r['flops'] / r['ms'] / 1e9:.1f} {unit}"
        uses = ", ".join(f"{p} x{n}" for p, n in per_batch.items() if n)
        uses = uses + " a batch" if uses else extra.get((route, shape, cout, act), "ragged")
        lib = (f"{r['ms'] / r['library_ms']:.2f}x library ({r['library_ms']:.4f})"
               if r["library_ms"] else "no library time")
        print(f"kernel {kernels[route]['name']} {desc} ({uses}): "
              f"{r['ms']:.4f} ms = {rate}, {r['ms'] / r['bound_ms']:.1f}x bound "
              f"({r['bound_ms']:.4f} by {r['bound_by']}), {lib}, "
              f"plain {r['plain_ms']:.4f}, tile {r['tile'][0]}x{r['tile'][1]}, "
              f"max |err| {r['max_abs_err']:.3g} {'ok' if r['ok'] else 'MISMATCH'}")
    for r in rows:
        check(r["ok"], f"{r['route']} kernel disagrees with its plain version at {r['shape']}")
    summary = []
    for route, meta in kernels.items():
        mine = [r for r in rows if r["route"] == route]
        entry = dict(meta)
        for path, (_, launches) in paths.items():
            if route not in launches:  # a path without this kernel (TrackNet: no 1x1 convs)
                continue
            check(any(r["launches_per_batch"][path] for r in mine),
                  f"no {path} shapes for {route}")

            def total(key):
                vals = [r[key] for r in mine if r["launches_per_batch"][path]]
                if None in vals:  # a library call that refused a path's shape
                    return None
                return sum(r[key] * r["launches_per_batch"][path] for r in mine
                           if r["launches_per_batch"][path])

            by_bytes = sum(r["bound_ms"] * r["launches_per_batch"][path] for r in mine
                           if r["bound_by"] == "bytes")
            sums = dict(launches=launches[route], ms=total("ms"), plain_ms=total("plain_ms"),
                        bound_ms=total("bound_ms"),
                        bound_by="bytes" if by_bytes >= total("bound_ms") / 2 else "operations",
                        library_ms=total("library_ms"),
                        batch=max(s[1][0] for s in paths[path][0]))
            lib = "none" if sums["library_ms"] is None else f"{sums['library_ms']:.4f}"
            print(f"kernel {meta['name']}, {path}: per batch of {sums['batch']} {sums['ms']:.4f} "
                  f"ms, bound {sums['bound_ms']:.4f} ({sums['bound_by']}), library {lib}, plain "
                  f"{sums['plain_ms']:.4f}; {sums['launches']} launches on the path's run")
            if path == main:
                entry.update(sums, max_abs_err=max(r["max_abs_err"] for r in mine))
            else:
                entry.update({f"{path}_{k}": v for k, v in sums.items()})
        summary.append(entry)
    return rows, summary


def profile_forward(forward, fwd_ms, path):
    """Device time of the serve forward by kernel; its sum over the forward
    time without the profiler (fwd_ms) is the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    iters = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(iters):
            forward()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    table = events.table(sort_by="cuda_time_total", row_limit=25)
    with open(path, "w") as f:
        f.write(table)
    print(table)
    print(f"profile: device busy {busy_ms / iters:.3f} ms per forward = "
          f"{busy_ms / iters / fwd_ms:.1%} of the {fwd_ms:.3f} ms forward without the "
          f"profiler ({wall_ms / iters:.3f} ms with it)")


def clip_frame(t: int, background: np.ndarray) -> np.ndarray:
    """Frame t of the clip: a square slides right along y=240 and a disk
    slides left along y=500, 20 px a frame, over a fixed background."""
    img = background.copy()
    x0 = 100 + 20 * t
    img[180:300, x0:x0 + 120] = (230, 60, 40)
    yy, xx = np.ogrid[0:VIDEO_HW[0], 0:VIDEO_HW[1]]
    img[(yy - 500) ** 2 + (xx - (1180 - 20 * t)) ** 2 <= 60 ** 2] = (40, 220, 60)
    return img


def write_clips(root):
    """The first VIDEO_FRAMES and VIDEO_SHORT frames of the clip as mp4v
    files, and four of its frames (RGB) for the head's rescale."""
    import cv2

    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:VIDEO_HW[0], 0:VIDEO_HW[1]]
    background = np.stack([60 + 40 * np.sin(xx / 90.0), 110 + 30 * np.cos(yy / 70.0),
                           70 + 20 * np.sin((xx + yy) / 150.0)], axis=-1)
    background = np.clip(background + rng.normal(0, 8, background.shape), 0, 255).astype(np.uint8)
    paths = {}
    for n in (VIDEO_FRAMES, VIDEO_SHORT):
        paths[n] = os.path.join(root, f"clip{n}.mp4")
        writer = cv2.VideoWriter(paths[n], cv2.VideoWriter_fourcc(*"mp4v"), VIDEO_FPS,
                                 (VIDEO_HW[1], VIDEO_HW[0]))
        check(writer.isOpened(), "cv2 cannot write mp4v video on this machine")
        for t in range(n):
            writer.write(cv2.cvtColor(clip_frame(t, background), cv2.COLOR_RGB2BGR))
        writer.release()
    samples = [clip_frame(t, background) for t in (0, 16, 32, VIDEO_FRAMES - 1)]
    return paths, samples


def tracking_checkpoint(root, config, net, frames, name="DetectionNet", class_mean=0.0):
    """The serve-phase net with its conf and class logits standardised on
    `frames` (per head and output channel: conf mean -3 and std 2, class
    mean `class_mean` and std 2; train form, f32, on the card), as a
    checkpoint. The
    random net's logits stay within +-0.3, so its scores never reach
    ByteTrack's activation threshold (0.35) and nothing would be tracked."""
    import cv2
    from vision_conglomerate_torch.train.checkpoint import save_checkpoint
    from vision_conglomerate_torch.weights import state_dict_to_flax

    img_wh = tuple(config["train_config"]["img_config"]["img_wh"])
    x = np.stack([cv2.resize((f / 255.0).astype(np.float32), img_wh,
                             interpolation=cv2.INTER_LINEAR) for f in frames])
    net = net.cuda().eval()
    feats, hooks = {}, []
    for i, head in enumerate(net.head):
        for key in ("regression_fmap_layer", "classification_fmap_layer"):
            hooks.append(getattr(head, key).register_forward_hook(
                lambda m, a, out, k=(key, i): feats.__setitem__(k, out)))
    with torch.no_grad():
        net(torch.from_numpy(x).cuda().permute(0, 3, 1, 2))
        for h in hooks:
            h.remove()
        for i, head in enumerate(net.head):
            for layer, key, mean in ((head.conf_layer, "regression_fmap_layer", -3.0),
                                     (head.cls_layer, "classification_fmap_layer", class_mean)):
                z = F.conv2d(feats[(key, i)], layer.weight, layer.bias)
                gain = 2.0 / z.std(dim=(0, 2, 3))
                layer.bias.copy_((layer.bias - z.mean(dim=(0, 2, 3))) * gain + mean)
                layer.weight.mul_(gain[:, None, None, None])
    ckpt = os.path.join(root, "tracking", f"{name}.ckpt.tar")
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": net.num_classes,
                           "NETWORK_PARAMS": state_dict_to_flax(net.cpu().state_dict())})
    return ckpt


def serve_video(clip, ckpt, config, storage, device="cuda", **kw):
    """One run_detection_inference call on a clip; (host-clock seconds,
    output dir, output.csv as a DataFrame)."""
    import pandas as pd
    from vision_conglomerate_torch.infer.runner import run_detection_inference

    t0 = time.time()
    out = run_detection_inference(clip, ckpt, config, storage_path=storage, device=device,
                                  **{**VIDEO_KW, **kw})
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.time() - t0
    csv = os.path.join(out, "output.csv")
    return seconds, out, (pd.read_csv(csv) if os.path.isfile(csv) else None)


def video_frames(out) -> int:
    import cv2

    cap = cv2.VideoCapture(os.path.join(out, "video.mp4"))
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def csv_agreement(got, want, keys=("frame", "track_id", "class")) -> float:
    """Rows that have a row with the same `keys` in the other table with X,
    Y, W, H within 1 (the smaller of the two sides' counts), over the
    larger table's rows."""
    merged = got.reset_index().merge(want.reset_index(), on=list(keys), suffixes=("", "_ref"))
    close = np.ones(len(merged), bool)
    for c in ("X", "Y", "W", "H"):
        close &= (merged[c] - merged[c + "_ref"]).abs().to_numpy() <= 1
    merged = merged[close]
    matched = min(merged["index"].nunique(), merged["index_ref"].nunique())
    return float(matched) / max(len(got), len(want), 1)


def video_phase(root, config, net, clips, samples):
    """The clip served on the card through both kernels (frame_skips 0 and
    1), against the serial path and the CPU; warm frames/s with and without
    the prefetch thread."""
    ckpt = tracking_checkpoint(root, config, net, samples)
    clip = clips[VIDEO_FRAMES]
    zero_counters()
    runs = {skips: serve_video(clip, ckpt, config, os.path.join(root, f"video_skip{skips}"),
                               frame_skips=skips) for skips in (0, 1)}
    launches = read_counters()
    print(f"video: {VIDEO_FRAMES} frames 1280x720 at batch {VIDEO_KW['batch_size']} through "
          f"run_detection_inference, frame_skips 0 and 1: {runs[0][0]:.2f} s and "
          f"{runs[1][0]:.2f} s (first calls); launches {launches}")
    for route, n in launches.items():
        check(n > 0, f"the {route} kernel never launched serving the video")
    stats = {}
    for skips, want_frames in ((0, VIDEO_FRAMES), (1, VIDEO_FRAMES // 2)):
        _, out, df = runs[skips]
        frames = video_frames(out)
        check(frames == want_frames, f"video.mp4 has {frames} frames, want {want_frames} "
                                     f"(frame_skips {skips})")
        check(df is not None and "track_id" in df.columns and len(df) > 0,
              f"output.csv of the video (frame_skips {skips}) has no tracks")
        stats[skips] = dict(rows=len(df), track_ids=int(df["track_id"].nunique()),
                            frames_with_tracks=int(df["frame"].nunique()))
        print(f"video: frame_skips {skips}: video.mp4 {frames} frames, output.csv {len(df)} rows, "
              f"{stats[skips]['track_ids']} track ids over {stats[skips]['frames_with_tracks']} "
              f"frames")
    card = runs[0][2]
    _, _, cpu = serve_video(clip, ckpt, config, os.path.join(root, "video_cpu"), device="cpu")
    agree = csv_agreement(card, cpu)
    boxes_agree = csv_agreement(card, cpu, keys=("frame", "class"))
    print(f"video: card bf16 vs cpu f32, frame_skips 0: {agree:.4f} of the rows agree "
          f"(frame, track id, class, box), {boxes_agree:.4f} without the track id "
          f"({len(card)} card rows, {len(cpu)} cpu rows; reported, not gated)")
    # warm frames/s, prefetch (1) and serial (0) in turns
    times = {"1": [], "0": []}
    prev = os.environ.get("VCT_INFER_PREFETCH")
    for mode in ("1", "0", "0", "1"):
        os.environ["VCT_INFER_PREFETCH"] = mode
        try:
            t_short, _, _ = serve_video(clips[VIDEO_SHORT], ckpt, config,
                                        os.path.join(root, f"warm{mode}_{len(times[mode])}s"))
            t_long, _, df = serve_video(clip, ckpt, config,
                                        os.path.join(root, f"warm{mode}_{len(times[mode])}l"))
        finally:
            if prev is None:
                del os.environ["VCT_INFER_PREFETCH"]
            else:
                os.environ["VCT_INFER_PREFETCH"] = prev
        check(df.equals(card), f"VCT_INFER_PREFETCH={mode}: output.csv differs from the "
                               f"prefetched first run")
        times[mode].append((VIDEO_FRAMES - VIDEO_SHORT) / (t_long - t_short))
    print(f"video: warm frames/s, (48 - 16) frames over the difference of two calls (host "
          f"clock): prefetch {times['1'][0]:.3f} and {times['1'][1]:.3f}, serial "
          f"(VCT_INFER_PREFETCH=0) {times['0'][0]:.3f} and {times['0'][1]:.3f}; the serial "
          f"output.csv equals the prefetched one")
    return dict(launches=launches, first_call_seconds={k: v[0] for k, v in runs.items()},
                runs=stats, cpu_agreement=agree, cpu_box_agreement=boxes_agree,
                cpu_rows=len(cpu),
                warm_frames_per_s={"prefetch": times["1"], "serial": times["0"]})


def write_train_data(root, n_train=N_TRAIN):
    """`n_train` train (64) and 16 valid 640x640 JPEGs with 2-6 filled
    boxes each and YOLO labels over 80 classes (every class present), plus
    temp copies of the shipped config (data_path pointing here) and
    anchors."""
    import yaml
    from PIL import Image

    rng = np.random.default_rng(SEED)
    box_id = 0
    for split, n in (("train", n_train), ("valid", N_VALID)):
        d = os.path.join(root, "data", split)
        os.makedirs(d)
        for i in range(n):
            img = rng.integers(0, 80, (640, 640, 3), dtype=np.uint8)
            rows = []
            for _ in range(int(rng.integers(2, 7))):
                w, h = rng.uniform(0.05, 0.4, 2)
                cx, cy = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
                cls = box_id % NUM_CLASSES
                box_id += 1
                x0, x1 = int((cx - w / 2) * 640), int((cx + w / 2) * 640)
                y0, y1 = int((cy - h / 2) * 640), int((cy + h / 2) * 640)
                img[y0:y1, x0:x1] = (np.asarray([cls * 3, 255 - cls * 3, 128 + cls]) % 256)
                rows.append(f"{cls} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}")
            Image.fromarray(img).save(os.path.join(d, f"img_{i:03d}.jpg"), quality=90)
            with open(os.path.join(d, f"img_{i:03d}.txt"), "w") as f:
                f.write("\n".join(rows) + "\n")
    with open(os.path.join(REPO, "configs", "detection", "config.yaml")) as f:
        config = yaml.safe_load(f)
    tc = config["train_config"]
    tc["data_path"] = os.path.join(root, "data")
    tc["img_config"]["img_ext"] = "jpg"
    config_path = os.path.join(root, "config.yaml")
    anchors_path = os.path.join(root, "anchors.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
    with open(os.path.join(REPO, "configs", "detection", "anchors.yaml")) as src, \
            open(anchors_path, "w") as dst:
        dst.write(src.read())
    return config, config_path, anchors_path


def run_train_cli(root, config, config_path, anchors_path, task="detection"):
    """The port's train_det `run` (with --map_eval), or train_seg's, at the
    shipped config on the card, cwd in root; returns (pipeline, seconds,
    peak bytes allocated)."""
    from vision_conglomerate_torch import train_det, train_seg

    args = argparse.Namespace(
        batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS, checkpoint_interval=1, eval_interval=1,
        no_verbose=True, lr_schedule=True, lr_schedule_interval=1, use_ddp=False,
        checkpoint_path="", lr=0.0, device="cuda")
    if task == "detection":
        args.profile_dir, args.map_eval = "", True
    cwd = os.getcwd()
    os.chdir(root)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        cli = train_seg if task == "segmentation" else train_det
        pipe = cli.run(args, config, config_path, anchors_path)
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    return pipe, time.time() - t0, torch.cuda.max_memory_allocated()


def check_train_artifacts(root, pipe, task="detection"):
    """What the train CLI of `task` must have written under root: finite
    epoch losses, the metrics CSVs (detection: map50 of --map_eval, and for
    a keypoint net pck and the keypoint losses; seg: seg_loss, dice_score,
    seg_dropped_candidates), a snapshot an epoch, and best_model/ with its
    config (a keypoint net's with num_keypoints) and f32 conv kernels."""
    import pandas as pd
    import yaml
    from vision_conglomerate_torch.train.checkpoint import load_checkpoint

    hist = pipe._train_metrics
    check(len(hist) == TRAIN_EPOCHS and len(pipe._eval_metrics) == TRAIN_EPOCHS,
          f"{task}: {len(hist)} train and {len(pipe._eval_metrics)} eval records")
    for m in hist + pipe._eval_metrics:
        # an epoch's mean loss is finite only if every step's loss was
        check(bool(np.isfinite(m["aggregate_loss"])), f"{task}: non-finite loss in {m}")
    best = f"saved_model/{task}/best_model/{type(pipe.model).__name__}.ckpt.tar"
    for rel in (f"metrics/{task}/train_metrics.csv", f"metrics/{task}/eval_metrics.csv", best,
                f"saved_model/{task}/best_model/config/config.yaml"):
        check(os.path.isfile(os.path.join(root, rel)), f"{task} train artifact missing: {rel}")
    columns = ["map50"] if task == "detection" else [
        "seg_loss", "dice_score", "seg_dropped_candidates"]
    kp = pipe.model.num_keypoints
    if kp:  # --map_eval's PCK, and the keypoint count in the saved config
        columns = columns + ["pck", "kp_loss", "kpv_loss", "kpc_loss"]
        with open(os.path.join(root, f"saved_model/{task}/best_model/config/config.yaml")) as f:
            saved = yaml.safe_load(f)["model_config"].get("num_keypoints")
        check(saved == kp, f"{task}: best_model/config/config.yaml has num_keypoints {saved!r}, "
                           f"want {kp}")
    for mode in ("eval",) if task == "detection" else ("train", "eval"):
        df = pd.read_csv(os.path.join(root, f"metrics/{task}/{mode}_metrics.csv"))
        check(set(columns) <= set(df.columns) and len(df) == TRAIN_EPOCHS
              and bool(np.isfinite(df[columns].to_numpy()).all()),
              f"{task} {mode}_metrics.csv: columns {list(df.columns)}, {len(df)} rows")
    if task == "detection":
        print(f"{'kp train' if kp else 'train'}: --map_eval mAP@50 per epoch "
              f"{df['map50'].tolist()}" + (f", PCK@0.1 {df['pck'].tolist()}" if kp else "")
              + " (eval_metrics.csv)")
    snaps = [f for _, _, fs in os.walk(os.path.join(root, f"saved_model/{task}/checkpoints"))
             for f in fs if f.endswith(".ckpt.tar")]
    check(len(snaps) == TRAIN_EPOCHS, f"{task} snapshots: {snaps}")
    manifest = load_checkpoint(os.path.join(root, best))
    kernels = []

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "kernel":
                kernels.append(v)
    walk(manifest["NETWORK_PARAMS"]["params"])
    n_convs = sum(isinstance(m, torch.nn.Conv2d) for m in pipe.model.modules())
    check(len(kernels) == n_convs and all(k.dtype == np.float32 for k in kernels),
          f"{task} best model: {len(kernels)} conv kernels for {n_convs} convs, dtypes "
          f"{sorted({str(k.dtype) for k in kernels})} (want float32)")


def seeded_net(config, anchors, dtype=torch.float32, device="cpu", state=None,
               task="detection"):
    """A train-form net (a SegmentationNet for task "segmentation"; with
    the config's num_keypoints, a keypoint head) with Xavier init and
    non-trivial BatchNorm state from SEED (or the given state_dict),
    computing in dtype on device."""
    from vision_conglomerate_torch.models import DetectionNet, SegmentationNet
    from vision_conglomerate_torch.nn.blocks import randomize_batchnorm_
    from vision_conglomerate_torch.nn.initializers import xavier_conv_init

    cls = SegmentationNet if task == "segmentation" else DetectionNet
    net = cls(NUM_CLASSES, config["model_config"], anchors=anchors, dtype=dtype, device="cpu",
              num_keypoints=config["model_config"].get("num_keypoints"))
    if state is None:
        g = torch.Generator().manual_seed(SEED)
        randomize_batchnorm_(xavier_conv_init(net, g), g)
    else:
        net.load_state_dict(state)
    return net.to(device)


def trainer(net, config):
    """The train CLI's pipeline for net (detection or segmentation), with
    the config's optimizer and loss, and no re-initialisation."""
    from vision_conglomerate_torch import train_det, train_seg
    from vision_conglomerate_torch.models import SegmentationNet
    from vision_conglomerate_torch.train.detection_trainer import TrainDetectionPipeline
    from vision_conglomerate_torch.train.optim import make_optimizer
    from vision_conglomerate_torch.train.segmentation_trainer import TrainSegmentationPipeline

    opt, _ = make_optimizer(config["train_config"]["optimizer_config"], net)
    if isinstance(net, SegmentationNet):
        pipe = TrainSegmentationPipeline(net, train_seg.make_loss_config(config, NUM_CLASSES),
                                         opt, init_scheme=None)
    else:
        loss_cfg = train_det.make_loss_config(config, NUM_CLASSES, net.num_keypoints or 0)
        pipe = TrainDetectionPipeline(net, loss_cfg, opt, init_scheme=None)
    net.train()
    return pipe


def train_batch(config, n, task="detection"):
    """The first n train images with their padded labels (and target
    masks), as the loader collates them (numpy)."""
    from vision_conglomerate_torch import train_det, train_seg

    ds = (train_seg if task == "segmentation" else train_det).make_dataset(config, "train")
    return ds.collate_fn([ds[i] for i in range(n)])


def no_grad_biases(net):
    """Names of the conv biases in front of a train-mode BatchNorm: their
    gradient is zero in exact arithmetic, so both sides hold rounding noise."""
    from vision_conglomerate_torch.nn.blocks import ConvBNorm

    return {f"{n}.conv.bias" for n, m in net.named_modules()
            if isinstance(m, ConvBNorm) and hasattr(m, "norm") and m.conv.bias is not None}


def train_step_result(net, config, batch):
    """(loss, gradients, BatchNorm running statistics, keypoint loss terms)
    of one train step, copied to the CPU as f32."""
    dev = net.sm_anchors.device
    pipe = trainer(net, config)
    metrics = pipe.train_step(*[torch.from_numpy(a).to(dev) for a in batch])
    grads = {n: p.grad.float().cpu() for n, p in net.named_parameters() if p.requires_grad}
    stats = {n: b.float().cpu() for n, b in net.named_buffers() if "running_" in n}
    terms = {k: metrics[k].item() for k in KP_TERMS if k in metrics}
    return metrics["aggregate_loss"].item(), grads, stats, terms


def compare_steps(a, b, names):
    """How far step result a is from step result b ((loss, gradients,
    BatchNorm statistics[, keypoint loss terms]), as train_step_result
    gives them); the keypoint terms' relative differences as `<term>_rel`."""
    (la, ga, sa, *ta), (lb, gb, sb, *tb) = a, b
    ta, tb = (t[0] if t else {} for t in (ta, tb))
    cos = {n: F.cosine_similarity(ga[n].double().flatten(), gb[n].double().flatten(),
                                  dim=0).item() for n in names}
    worst = min(cos, key=cos.get)
    flat_a = torch.cat([ga[n].double().flatten() for n in names])
    flat_b = torch.cat([gb[n].double().flatten() for n in names])
    return dict(loss=la, loss_ref=lb, loss_rel=abs(la - lb) / abs(lb),
                one_minus_min_cos=1.0 - cos[worst], worst_grad=worst,
                one_minus_median_cos=1.0 - float(np.median(list(cos.values()))),
                one_minus_global_cos=1.0 - F.cosine_similarity(flat_a, flat_b, dim=0).item(),
                bn_stats=max((sa[n] - sb[n]).abs().max().item() for n in sb),
                **{f"{k}_rel": abs(ta[k] - tb[k]) / abs(tb[k]) for k in tb},
                **{k: ta[k] for k in ta}, **{f"{k}_ref": tb[k] for k in tb})


def reference_batchnorm(config, anchors, batch):
    """The train-mode BatchNorm of the phase-6 net's stem (its conv's
    output on the batch, a channels_last map as the train step hands it
    over) on the CPU and on the card against the same normalisation in
    f64. The card-vs-CPU step gates hold the card only as far as the CPU
    reference is at f32 rounding: its error must stay within
    REF_BN_LIMIT."""
    from vision_conglomerate_torch.nn.blocks import conv2d
    from vision_conglomerate_torch.ops.preprocess import normalize_images

    stem = seeded_net(config, anchors).backbone.conv0.train()
    with torch.no_grad():
        y = conv2d(normalize_images(torch.from_numpy(batch[0])).permute(0, 3, 1, 2), stem.conv)
        yd = y.double()
        mean = yd.mean((0, 2, 3), keepdim=True)
        var = yd.var((0, 2, 3), unbiased=False, keepdim=True)
        w, b = (t.double()[:, None, None] for t in (stem.norm.weight, stem.norm.bias))
        want = (yd - mean) / torch.sqrt(var + stem.norm.eps) * w + b
        rel = lambda got: ((got.double().cpu() - want).norm() / want.norm()).item()
        raw = rel(F.batch_norm(y, None, None, stem.norm.weight, stem.norm.bias, True, 0.0,
                               stem.norm.eps))
        err = {dev: rel(stem.norm.to(dev)(y.to(dev))) for dev in ("cpu", "cuda")}
    layout = "channels_last" if y.is_contiguous(memory_format=torch.channels_last) else "NCHW"
    print(f"train: the stem's train-mode BatchNorm on {tuple(y.shape)} ({layout}) against f64, "
          f"relative L2: cpu {err['cpu']:.3e}, card {err['cuda']:.3e} (limit {REF_BN_LIMIT:g}); "
          f"torch's CPU kernel on the {layout} map itself {raw:.3e}")
    for dev, e in err.items():
        check(e <= REF_BN_LIMIT, f"the stem's BatchNorm on {dev} is {e:.3e} from f64")
    return err


def card_vs_cpu_step(config, anchors, task="detection", limits=None, label=None):
    """One seeded net, one batch of 2: the step on the card in f32 and in
    bf16 against the CPU f32 step (`limits`, TRAIN_LIMITS by default). The
    CPU's own bf16 step is measured beside them: how far bf16 alone moves
    the step. The anchors get no gradient, and the conv biases in front of
    a train-mode BatchNorm only rounding noise: both are left out of the
    cosines. A keypoint net's kp_loss, kpv_loss and kpc_loss are held as
    its loss is: by the loss's relative limit, or, where `limits` gives the
    bf16 step none, by their ratio to the CPU's bf16 step. `label` names
    the printed lines."""
    limits = limits or TRAIN_LIMITS
    tag_ = label or ("seg train" if task == "segmentation"
                     else "kp train" if config["model_config"].get("num_keypoints") else "train")
    cpu = seeded_net(config, anchors, task=task)
    state = {k: v.clone() for k, v in cpu.state_dict().items()}
    batch = train_batch(config, 2, task)
    skip = no_grad_biases(cpu)
    ref = train_step_result(cpu, config, batch)
    names = [n for n in ref[1] if n not in skip]
    steps = {tag: train_step_result(seeded_net(config, anchors, dtype, dev, state, task), config,
                                    batch)
             for tag, dtype, dev in (("f32", torch.float32, "cuda"),
                                     ("bf16", torch.bfloat16, "cuda"),
                                     ("cpu_bf16", torch.bfloat16, "cpu"))}
    out = {tag: compare_steps(r, ref, names) for tag, r in steps.items()}
    out["bf16_vs_cpu_bf16"] = compare_steps(steps["bf16"], steps["cpu_bf16"], names)
    for tag, r in out.items():
        print(f"{tag_}: one step on 2 images at 640x640, {tag} vs cpu f32: loss {r['loss']:.6f} vs "
              f"{r['loss_ref']:.6f}, rel {r['loss_rel']:.3e}; 1 - gradient cosine: lowest "
              f"{r['one_minus_min_cos']:.3e} ({r['worst_grad']}), median "
              f"{r['one_minus_median_cos']:.3e}, all as one vector "
              f"{r['one_minus_global_cos']:.3e}; BatchNorm running stats max |d| "
              f"{r['bn_stats']:.3e}".replace("bf16_vs_cpu_bf16 vs cpu f32", "card bf16 vs cpu bf16")
              + (f"; limits {limits[tag]}" if tag in limits else ""))
    print(f"{tag_}: {len(names)} parameters compared; {len(skip)} conv biases before BatchNorm "
          f"and the anchors left out; the cpu f32 reference loss {ref[0]!r} (the seeded net on "
          f"the shipped anchors)")
    # what `limits` leaves unbounded of the bf16 step's distance from f32
    # (its gradients; a kp net's loss and keypoint terms) is held to the
    # CPU's own bf16 step
    ratio_keys = ["one_minus_global_cos", "one_minus_median_cos"] + [
        k for k in ["loss_rel"] + [f"{t}_rel" for t in KP_TERMS]
        if k in out["bf16"] and k not in limits["bf16"]]
    for key in ratio_keys:
        ratio = out["bf16"][key] / out["cpu_bf16"][key]
        out["bf16"][key + "_ratio"] = ratio
        print(f"{tag_}: card bf16 {key} / cpu bf16 {key} = {ratio:.3f} "
              f"(limit {BF16_COS_RATIO:g})")
        check(bool(np.isfinite(ratio)) and ratio <= BF16_COS_RATIO,
              f"{tag_}: the card's bf16 step is {ratio:.3f}x farther from f32 than the CPU's "
              f"bf16 ({key})")
    for tag, lims in limits.items():
        for term in KP_TERMS:
            if f"{term}_rel" in out[tag]:
                v = out[tag][f"{term}_rel"]
                held_by = (f"limit {lims['loss_rel']:g}" if "loss_rel" in lims
                           else "held by the ratio to the cpu bf16 step")
                print(f"{tag_}: {tag} vs cpu f32 {term} {out[tag][term]:.6f} vs "
                      f"{out[tag][term + '_ref']:.6f}, rel {v:.3e} ({held_by})")
                check(bool(np.isfinite(v)) and v <= lims.get("loss_rel", np.inf),
                      f"card {tag} {tag_} step differs from the CPU: {term} rel {v:.3e}")
        for key, lim in lims.items():
            v = out[tag][key]
            check(bool(np.isfinite(v)) and v <= lim,
                  f"card {tag} {tag_} step differs from the CPU: {key} {v:.3e} > {lim:g}")
    return out


def learning_check(config, anchors, task="detection", steps=LEARN_STEPS):
    """`steps` steps of a seeded net on one fixed batch of TRAIN_BATCH on
    the card; the loss (and a keypoint net's kp_loss) must fall. Returns the
    losses, the synchronized step time of steps 6 to the last and
    (pipeline, batch)."""
    pipe = trainer(seeded_net(config, anchors, torch.bfloat16, "cuda", task=task), config)
    batch = [torch.from_numpy(a).cuda() for a in train_batch(config, TRAIN_BATCH, task)]
    keys = ["aggregate_loss"] + (["kp_loss"] if pipe.model.num_keypoints else [])
    losses = []
    for i in range(steps):
        if i == 5:
            torch.cuda.synchronize()
            t0 = time.time()
        metrics = pipe.train_step(*batch)
        losses.append(torch.stack([metrics[k].detach() for k in keys]))
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / (steps - 5) * 1e3
    by_key = dict(zip(keys, torch.stack(losses).T.tolist()))
    losses = by_key["aggregate_loss"]
    tag = ("seg train" if task == "segmentation"
           else "kp train" if pipe.model.num_keypoints else "train")
    print(f"{tag}: {steps} steps on one batch of {TRAIN_BATCH}: " + ", ".join(
        f"{k} {v[0]:.4f} -> {v[-1]:.4f}" for k, v in by_key.items())
        + f"; fixed-batch step {step_ms:.3f} ms = {TRAIN_BATCH / step_ms * 1e3:.1f} images/s "
        f"(host clock, synchronized, steps 6-{steps}, no loader)")
    for k, v in by_key.items():
        check(all(np.isfinite(v)), f"{tag}: non-finite {k} while learning: {v}")
        check(v[-1] < v[0], f"{tag}: {k} did not fall in {steps} steps: {v}")
    return losses, step_ms, (pipe, batch)


def profile_train(pipe, batch, step_ms, path):
    """Device time of 3 fixed-batch train steps by op; its sum over the
    steps' time without the profiler is the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    iters = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            pipe.train_step(*batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3 / iters
    n_kernels = sum(e.count for e in events
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / iters
    table = events.table(sort_by="self_cuda_time_total", row_limit=30)
    with open(path, "w") as f:
        f.write(table)
    print(table)
    print(f"profile: train step at batch {TRAIN_BATCH}: device busy {busy_ms:.3f} ms per step = "
          f"{busy_ms / step_ms:.1%} of the {step_ms:.3f} ms step without the profiler; "
          f"{n_kernels:.0f} device kernels per step")
    return dict(busy_ms=busy_ms, busy_share=busy_ms / step_ms, kernels_per_step=n_kernels)


def serve_trained(root, config, label="train"):
    """best_model/ through run_detection_inference on 8 valid images, with
    both kernel counters read around it."""
    from vision_conglomerate_torch.infer.runner import run_detection_inference
    from vision_conglomerate_torch.utils import load_yaml

    best = os.path.join(root, "saved_model/detection/best_model")
    imgs = os.path.join(root, "serve_imgs")
    os.makedirs(imgs)
    for i in range(N_IMAGES):
        name = f"img_{i:03d}.jpg"
        os.link(os.path.join(root, "data", "valid", name), os.path.join(imgs, name))
    zero_counters()
    out = run_detection_inference(
        imgs, os.path.join(best, "DetectionNet.ckpt.tar"),
        load_yaml(os.path.join(best, "config", "config.yaml")), batch_size=BATCH,
        score_threshold=0.01, with_summary=True, storage_path=os.path.join(root, "served"),
        device="cuda")
    torch.cuda.synchronize()
    launches = read_counters()
    files = sorted(os.listdir(out))
    print(f"{label}: served the trained best_model on {N_IMAGES} images; launches {launches}")
    for route, n in launches.items():
        check(n > 0, f"the {route} kernel never launched serving the trained checkpoint")
    check("output.csv" in files and sum(f.endswith(".png") for f in files) == N_IMAGES,
          f"outputs of the trained checkpoint missing: {files}")
    return launches


def save_learned(root, config, net):
    """A learning phase's net (trained on the first TRAIN_BATCH train
    images) as a checkpoint beside its config, and those images with their
    labels in data/learned/; returns (checkpoint, data dir)."""
    from vision_conglomerate_torch.train.checkpoint import save_checkpoint
    from vision_conglomerate_torch.utils import save_yaml
    from vision_conglomerate_torch.weights import state_dict_to_flax

    ckpt = os.path.join(root, "learned", f"{type(net).__name__}.ckpt.tar")
    state = {k: v.float().cpu() for k, v in net.state_dict().items()}
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": net.num_classes,
                           "NETWORK_PARAMS": state_dict_to_flax(state)})
    os.makedirs(os.path.join(root, "learned", "config"))
    save_yaml(config, os.path.join(root, "learned", "config", "config.yaml"))
    src, dst = os.path.join(root, "data", "train"), os.path.join(root, "data", "learned")
    os.makedirs(dst)
    img_ext = "." + config["train_config"]["img_config"]["img_ext"]
    for name in sorted(f for f in os.listdir(src) if f.endswith(img_ext))[:TRAIN_BATCH]:
        for ext in (img_ext, ".txt"):
            stem = os.path.splitext(name)[0] + ext
            os.link(os.path.join(src, stem), os.path.join(dst, stem))
    return ckpt, dst


def eval_phase(root, learned, task="detection"):
    """The eval CLI of `task` (eval_det for "detection" and "keypoints",
    eval_seg) on best_model/ over the
    valid images and on a learning phase's net over the images it learned
    (`learned`: checkpoint, data dir; None: best_model/ only), each on the
    card (counters zeroed before and read after) and on the CPU: the JAX
    CLI's keys, its metrics card vs CPU within their limits, the learned
    net's above 0."""
    import contextlib
    import io

    from vision_conglomerate_torch import eval_det, eval_seg

    cli, keys, limits = {
        "segmentation": (eval_seg, SEG_EVAL_KEYS, SEG_EVAL_LIMITS),
        "detection": (eval_det, EVAL_KEYS, {"map50": EVAL_MAP50_LIMIT}),
        "keypoints": (eval_det, KP_EVAL_KEYS, {"map50": EVAL_MAP50_LIMIT,
                                               "pck10": KP_EVAL_PCK_LIMIT})}[task]
    name = cli.__name__.rsplit(".", 1)[-1]
    model, folder = (("SegmentationNet", task) if task == "segmentation"
                     else ("DetectionNet", "detection"))
    runs = {"best_model": (os.path.join(root, f"saved_model/{folder}/best_model/{model}.ckpt.tar"),
                           os.path.join(root, "data", "valid"))}
    if learned:
        runs["learned"] = learned
    res = {}
    for tag, (weights, data_dir) in runs.items():
        out, seconds = {}, {}
        for dev in ("cuda", "cpu"):
            argv = ["--weights_path", weights, "--data_dir", data_dir, "--device", dev]
            zero_counters()
            printed = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(printed):
                out[dev] = cli.run(cli.build_parser().parse_args(argv))
            seconds[dev] = time.time() - t0
            if dev == "cuda":
                launches = read_counters()
            line = json.loads(printed.getvalue().strip().splitlines()[-1])
            check(line == out[dev] and list(line) == keys,
                  f"{name} ({tag}, {dev}) printed {list(line)}, want the keys {keys}")
        diffs = {k: abs(out["cuda"][k] - out["cpu"][k]) for k in limits}
        print(f"eval: {name} on {tag} over {out['cuda']['num_images']} images: " + "; ".join(
            f"{k} card bf16 {out['cuda'][k]}, cpu f32 {out['cpu'][k]}, |d| {diffs[k]:.3g} "
            f"(limit {limits[k]:g})" for k in limits)
            + f"; {seconds['cuda']:.2f} s card, {seconds['cpu']:.2f} s cpu; launches {launches}")
        for route, n in launches.items():
            check(n > 0, f"the {route} kernel never launched in {name} ({tag})")
        for k, lim in limits.items():
            check(diffs[k] <= lim, f"{name} ({tag}) {k} card vs cpu differs by {diffs[k]:.3g}")
        if tag == "learned":
            check(all(out["cpu"][k] > 0 for k in limits),
                  f"{name} gives the learned net {list(limits)} "
                  f"{[out['cpu'][k] for k in limits]} on the images it learned")
        res[tag] = dict(cuda={k: out["cuda"][k] for k in keys[:5]},
                        cpu={k: out["cpu"][k] for k in keys[:5]}, abs_diff=diffs,
                        seconds=seconds, launches=launches)
        if tag == "learned":
            def run_int8(dev, weights=weights, data_dir=data_dir):
                argv = ["--weights_path", weights, "--data_dir", data_dir, "--device", dev,
                        "--quantize", "int8"]
                with contextlib.redirect_stdout(io.StringIO()):
                    got = cli.run(cli.build_parser().parse_args(argv))
                check(list(got) == keys and got["quantize"] == "int8",
                      f"{name} --quantize int8 ({dev}) gave {list(got)}")
                return got

            res["learned_int8"] = int8_eval(run_int8, list(limits), out["cuda"], limits,
                                            f"eval: {name} on {tag}")
    return res


def remat_phase(config, anchors):
    """One bf16 train step at batch REMAT_BATCH without and with remat from
    one seeded state: step results within TRAIN_LIMITS["f32"], remat's peak
    memory lower; then 3 more steps each for the step time."""
    import copy
    import gc

    batch = [torch.from_numpy(a).cuda() for a in train_batch(config, REMAT_BATCH)]
    cpu = seeded_net(config, anchors)
    state = {k: v.clone() for k, v in cpu.state_dict().items()}
    skip = no_grad_biases(cpu)
    res = {}
    for remat in (False, True):
        cfg = copy.deepcopy(config)
        cfg["model_config"]["remat"] = remat
        net = seeded_net(cfg, anchors, torch.bfloat16, "cuda", state)
        pipe = trainer(net, cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = pipe.train_step(*batch)["aggregate_loss"].item()
        peak = torch.cuda.max_memory_allocated()
        grads = {n: p.grad.float().cpu() for n, p in net.named_parameters() if p.requires_grad}
        stats = {n: b.float().cpu() for n, b in net.named_buffers() if "running_" in n}
        t0 = time.time()
        for _ in range(3):
            pipe.train_step(*batch)
        torch.cuda.synchronize()
        res[remat] = dict(step=(loss, grads, stats), peak=peak,
                          step_ms=(time.time() - t0) / 3 * 1e3)
        del net, pipe
    names = [n for n in res[False]["step"][1] if n not in skip]
    cmp = compare_steps(res[True]["step"], res[False]["step"], names)
    for remat in (False, True):
        r = res[remat]
        print(f"remat: train step at batch {REMAT_BATCH}, 640x640, bf16, remat {remat}: peak "
              f"memory allocated {r['peak'] / 2 ** 30:.3f} GiB, {r['step_ms']:.3f} ms/step "
              f"(steps 2-4, host clock, synchronized)")
    print(f"remat: remat vs no remat, one step from one state: loss {cmp['loss']:.6f} vs "
          f"{cmp['loss_ref']:.6f}, rel {cmp['loss_rel']:.3e}; 1 - gradient cosine: lowest "
          f"{cmp['one_minus_min_cos']:.3e} ({cmp['worst_grad']}), median "
          f"{cmp['one_minus_median_cos']:.3e}; BatchNorm running stats max |d| "
          f"{cmp['bn_stats']:.3e}; gated in bf16 with the f32 limits {TRAIN_LIMITS['f32']}")
    for key, lim in TRAIN_LIMITS["f32"].items():
        check(bool(np.isfinite(cmp[key])) and cmp[key] <= lim,
              f"the remat step differs from the plain step: {key} {cmp[key]:.3e} > {lim:g}")
    check(res[True]["peak"] < res[False]["peak"],
          f"remat's peak memory {res[True]['peak']} is not below {res[False]['peak']}")
    return dict(compare=cmp, peak_bytes={str(k): v["peak"] for k, v in res.items()},
                step_ms={str(k): v["step_ms"] for k, v in res.items()})


def shipped_anchors(task, suffix=""):
    """The anchors of configs/<task>/anchors<suffix>.yaml. The phases after
    a train CLI take these, not the temp copy that its auto-anchors may
    have rewritten (a k-means and a genetic search on this machine), so
    every machine holds the same inputs."""
    from vision_conglomerate_torch.utils import load_yaml

    return load_yaml(os.path.join(REPO, "configs", task, f"anchors{suffix}.yaml"))["anchors"]


def train_phase(root, out_dir, profile):
    config, config_path, anchors_path = write_train_data(root)
    pipe, seconds, peak = run_train_cli(root, config, config_path, anchors_path)
    check_train_artifacts(root, pipe)
    last = pipe._train_metrics[-1]
    steps = -(-N_TRAIN // TRAIN_BATCH)
    step_ms = TRAIN_BATCH / last["images_per_sec"] * 1e3
    print(f"train: train_det.run, {TRAIN_EPOCHS} epochs of {steps} steps at batch {TRAIN_BATCH}, "
          f"640x640, bf16: {seconds:.2f} s in all; epoch 2: {step_ms:.3f} ms/step = "
          f"{last['images_per_sec']:.1f} images/s (host clock, synchronized, loader included); "
          f"peak memory allocated {peak / 2 ** 30:.3f} GiB; losses "
          f"{[round(m['aggregate_loss'], 4) for m in pipe._train_metrics]}")
    anchors = shipped_anchors("detection")
    reference_batchnorm(config, anchors, train_batch(config, 2))
    parity = card_vs_cpu_step(config, anchors)
    losses, fixed_ms, (lpipe, batch) = learning_check(config, anchors)
    prof = (profile_train(lpipe, batch, fixed_ms, os.path.join(out_dir, "train_profile.txt"))
            if profile else None)
    for _ in range(EVAL_LEARN_STEPS - LEARN_STEPS):
        lpipe.train_step(*batch)
    learned = save_learned(root, config, lpipe.model)
    del lpipe, batch
    launches = serve_trained(root, config)
    evaluated = eval_phase(root, learned)
    remat = remat_phase(config, anchors)
    return dict(cli_seconds=seconds, epoch2_step_ms=step_ms,
                epoch2_images_per_s=last["images_per_sec"], peak_bytes=peak,
                train_metrics=pipe._train_metrics, eval_metrics=pipe._eval_metrics,
                card_vs_cpu=parity, learning_losses=losses, fixed_batch_step_ms=fixed_ms,
                profile=prof, trained_serve_launches=launches, eval=evaluated, remat=remat)


def make_seg_checkpoint(root):
    """A SegmentationNet at the shipped seg config with weights and
    non-trivial BatchNorm state from SEED, as a JAX-format checkpoint;
    returns (config, checkpoint, the train-form net on the CPU)."""
    from vision_conglomerate_torch.models import SegmentationNet
    from vision_conglomerate_torch.nn.blocks import init_weights_, randomize_batchnorm_
    from vision_conglomerate_torch.train.checkpoint import save_checkpoint
    from vision_conglomerate_torch.utils import load_yaml
    from vision_conglomerate_torch.weights import state_dict_to_flax

    config = load_yaml(os.path.join(REPO, "configs", "segmentation", "config.yaml"))
    anchors = load_yaml(os.path.join(REPO, "configs", "segmentation", "anchors.yaml"))["anchors"]
    g = torch.Generator().manual_seed(SEED)
    net = SegmentationNet(NUM_CLASSES, config["model_config"], anchors=anchors, device="cpu")
    randomize_batchnorm_(init_weights_(net, g), g)
    ckpt = os.path.join(root, "seg", "SegmentationNet.ckpt.tar")
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                           "NETWORK_PARAMS": state_dict_to_flax(net.state_dict())})
    return config, ckpt, net


def box_iou(a, b):
    """(n, m) IoU of xyxy boxes (numpy)."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=2)
    area = lambda x: np.prod(np.clip(x[:, 2:] - x[:, :2], 0, None), axis=1)  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-9)


def compare_seg_models(config, ckpt, img_dir):
    """Seg card (bf16, kernels) vs CPU (f32) on one batch: decoded
    predictions by group, protos, and the binary masks of the boxes both
    kept; also the forward's kernel shapes and time."""
    from vision_conglomerate_torch.data.inference import InferenceImgDataset
    from vision_conglomerate_torch.infer.runner import detect, kept_masks, load_detection_model
    from vision_conglomerate_torch.ops.postprocess import postprocess_detections

    mc = config["model_config"]
    img_wh = tuple(config["train_config"]["img_config"]["img_wh"])
    ds = InferenceImgDataset(img_dir, img_wh=img_wh)
    items = [ds[i] for i in range(BATCH)]
    imgs = np.stack([a for a, _ in items])
    og_hw = items[0][1].shape[:2]
    gpu_model, _ = load_detection_model(ckpt, mc, task="segmentation", device="cuda")
    cpu_model, _ = load_detection_model(ckpt, mc, task="segmentation", device="cpu")
    seen, handles = record_kernel_shapes(gpu_model)
    got, got_protos = detect(gpu_model, imgs, og_hw)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    want, want_protos = detect(cpu_model, imgs, og_hw)
    k = gpu_model.num_masks
    m = 3 * sum((img_wh[0] // s) * (img_wh[1] // s) for s in (8, 16, 32))
    check(tuple(got.shape) == tuple(want.shape) == (BATCH, m, 5 + NUM_CLASSES + k),
          f"seg pred shapes {tuple(got.shape)} vs {tuple(want.shape)}")
    check(tuple(got_protos.shape) == tuple(want_protos.shape)
          == (BATCH, k, img_wh[1] // 4, img_wh[0] // 4),
          f"proto shapes {tuple(got_protos.shape)} vs {tuple(want_protos.shape)}")
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(got_protos).all()),
          "non-finite seg predictions or protos on the card")
    stats = {}
    c = NUM_CLASSES
    groups = (("logits", got[..., :1 + c], want[..., :1 + c]),
              ("boxes", got[..., 1 + c:5 + c], want[..., 1 + c:5 + c]),
              ("coefs", got[..., 5 + c:], want[..., 5 + c:]),
              ("protos", got_protos, want_protos))
    for group, g, w in groups:
        diff = (g.float().cpu() - w).abs()
        max_lim, mean_lim = PROTO_LIMITS if group == "protos" else SEG_MODEL_LIMITS[group]
        stats[group] = dict(max_abs_err=diff.max().item(), mean_abs_err=diff.mean().item(),
                            max_ref=w.abs().max().item())
        print(f"seg serve: card bf16 vs cpu f32 {group}: max |d| {diff.max().item():.6g} "
              f"(limit {max_lim:g}), mean |d| {diff.mean().item():.6g} (limit {mean_lim:g}), "
              f"max |ref| {stats[group]['max_ref']:.6g}")
        check(diff.max().item() <= max_lim and diff.mean().item() <= mean_lim,
              f"seg card {group} differ from the CPU reference")
    kw = dict(num_classes=c, num_masks=k, iou_threshold=0.35, score_threshold=0.01,
              box_allowance=4.0)
    post_g = postprocess_detections(got, **kw)
    post_c = postprocess_detections(want, **kw)
    ious, kept = [], 0
    for i in range(BATCH):
        mg = kept_masks(got_protos[i], post_g, i, og_hw, False)
        mc_ = kept_masks(want_protos[i], post_c, i, og_hw, False)
        bg = post_g.boxes_xyxy[i][post_g.valid[i]].cpu().numpy()
        bc = post_c.boxes_xyxy[i][post_c.valid[i]].numpy()
        cg = post_g.classes[i][post_g.valid[i]].cpu().numpy()
        cc = post_c.classes[i][post_c.valid[i]].numpy()
        kept += len(bg)
        if len(bg) == 0 or len(bc) == 0:
            continue
        iou = box_iou(bg, bc) * (cg[:, None] == cc[None, :])
        for j, jc in enumerate(iou.argmax(axis=1)):
            if iou[j, jc] >= 0.95:  # the same box kept on both sides
                union = (mg[j] | mc_[jc]).sum()
                ious.append(float((mg[j] & mc_[jc]).sum() / union) if union else 1.0)
    stats["mask_iou"] = dict(pairs=len(ious), kept_card=kept,
                             mean=float(np.mean(ious)) if ious else None,
                             min=float(np.min(ious)) if ious else None)
    print(f"seg serve: binary masks card vs cpu on {len(ious)} of {kept} kept boxes that both "
          f"kept (box IoU >= 0.95, same class): mask IoU mean {stats['mask_iou']['mean']}, "
          f"lowest {stats['mask_iou']['min']} (reported, not gated: a pixel near 0.5 flips)")

    x = torch.from_numpy(imgs).cuda()

    def forward():
        with torch.no_grad():
            gpu_model(x.permute(0, 3, 1, 2), inference=True, og_size=og_hw)

    forward()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(10):
        forward()
    torch.cuda.synchronize()
    fwd_ms = (time.time() - t0) / 10 * 1e3
    print(f"seg serve: forward + decode at batch {BATCH}: {fwd_ms:.3f} ms/batch (host clock, "
          f"synchronized)")
    return seen, stats, fwd_ms


def seg_serve_phase(root, img_dirs):
    """The seg checkpoint served through run_detection_inference on the
    card (counters zeroed before, read after), its peak memory, the warm
    images/s, and the card against the CPU."""
    config, ckpt, net = make_seg_checkpoint(root)
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    seconds, served = serve(config, ckpt, img_dirs[N_IMAGES], os.path.join(root, "seg_out"),
                            "segmentation")
    peak = torch.cuda.max_memory_allocated()
    launches = read_counters()
    print(f"seg serve: {N_IMAGES} images 1280x720 at batch {BATCH} through "
          f"run_detection_inference(task='segmentation') in {seconds:.2f} s (first call); "
          f"launches {launches}; peak memory allocated {peak / 2 ** 30:.3f} GiB")
    for route, n in launches.items():
        check(n > 0, f"the {route} kernel never launched serving segmentation")
    files = sorted(os.listdir(served))
    check("output.csv" in files and sum(f.endswith(".png") for f in files) == N_IMAGES,
          f"seg serve outputs missing: {files}")
    t_few, _ = serve(config, ckpt, img_dirs[N_IMAGES], os.path.join(root, "seg_few"),
                     "segmentation")
    t_many, _ = serve(config, ckpt, img_dirs[WARM_IMAGES], os.path.join(root, "seg_many"),
                      "segmentation")
    warm = (WARM_IMAGES - N_IMAGES) / (t_many - t_few)
    print(f"seg serve: warm end to end {warm:.3f} images/s = {WARM_IMAGES - N_IMAGES} images / "
          f"({t_many:.3f} s - {t_few:.3f} s); decode, resize, forward, NMS, mask assembly, "
          f"drawing, PNG encode, CSV (host clock)")
    seen, stats, fwd_ms = compare_seg_models(config, ckpt, img_dirs[N_IMAGES])
    n_batches = -(-N_IMAGES // BATCH)
    for route, n in launches.items():
        per_batch = sum(1 for s_ in seen if s_[0] == route)
        check(n == n_batches * per_batch,
              f"seg {route}: {n} launches in {n_batches} batches, the forward routes {per_batch}")
    return dict(first_call_seconds=seconds, launches=launches, peak_bytes=peak,
                warm_images_per_s=warm, warm_seconds={N_IMAGES: t_few, WARM_IMAGES: t_many},
                forward_ms_per_batch=fwd_ms, model_vs_cpu=stats), seen, (config, ckpt, net)


def seg_video_phase(root, clip, samples, seg):
    """The clip served once with the seg checkpoint (its conf and class
    layers rescaled on the clip, as the video phase does) at frame_skips 1:
    24 frames in video.mp4 and both counters risen."""
    config, _, net = seg
    ckpt = tracking_checkpoint(os.path.join(root, "seg"), config, net, samples,
                               name="SegmentationNet")
    zero_counters()
    seconds, out, df = serve_video(clip, ckpt, config, os.path.join(root, "seg_video"),
                                   frame_skips=1, task="segmentation")
    launches = read_counters()
    frames = video_frames(out)
    rows = 0 if df is None else len(df)
    print(f"seg video: {VIDEO_FRAMES} frames 1280x720, frame_skips 1, batch "
          f"{VIDEO_KW['batch_size']}: {seconds:.2f} s (first call); video.mp4 {frames} frames, "
          f"output.csv {rows} track rows; launches {launches}")
    check(frames == VIDEO_FRAMES // 2, f"seg video.mp4 has {frames} frames, want "
                                       f"{VIDEO_FRAMES // 2}")
    for route, n in launches.items():
        check(n > 0, f"the {route} kernel never launched serving the seg video")
    return dict(seconds=seconds, frames=frames, rows=rows, launches=launches)


def write_seg_train_data(root):
    """64 train and 16 valid 640x640 JPEGs with 2-6 filled polygons each
    and YOLO-seg labels over 80 classes, plus temp copies of the shipped
    seg config (data_path pointing here) and anchors."""
    import cv2
    import yaml
    from PIL import Image

    rng = np.random.default_rng(SEED + 1)
    poly_id = 0
    for split, n in (("train", N_TRAIN), ("valid", N_VALID)):
        d = os.path.join(root, "data", split)
        os.makedirs(d)
        for i in range(n):
            img = rng.integers(0, 80, (640, 640, 3), dtype=np.uint8)
            rows = []
            for _ in range(int(rng.integers(2, 7))):
                cls = poly_id % NUM_CLASSES
                poly_id += 1
                k = int(rng.integers(5, 11))
                ang = np.sort(rng.uniform(0, 2 * np.pi, k))
                rad = rng.uniform(0.06, 0.16, k)
                cx, cy = rng.uniform(0.2, 0.8, 2)
                pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1).clip(0, 1)
                color = tuple(int(v) for v in np.asarray([cls * 3, 255 - cls * 3, 128 + cls]) % 256)
                cv2.fillPoly(img, [(pts * 640).astype(np.int32)], color)
                rows.append(" ".join([str(cls)] + [f"{v:.6f}" for v in pts.ravel()]))
            Image.fromarray(img).save(os.path.join(d, f"img_{i:03d}.jpg"), quality=90)
            with open(os.path.join(d, f"img_{i:03d}.txt"), "w") as f:
                f.write("\n".join(rows) + "\n")
    with open(os.path.join(REPO, "configs", "segmentation", "config.yaml")) as f:
        config = yaml.safe_load(f)
    config["train_config"]["data_path"] = os.path.join(root, "data")
    config_path = os.path.join(root, "config.yaml")
    anchors_path = os.path.join(root, "anchors.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
    with open(os.path.join(REPO, "configs", "segmentation", "anchors.yaml")) as src, \
            open(anchors_path, "w") as dst:
        dst.write(src.read())
    return config, config_path, anchors_path


def seg_train_phase(root):
    import copy

    config, config_path, anchors_path = write_seg_train_data(root)
    pipe, seconds, peak = run_train_cli(root, config, config_path, anchors_path, "segmentation")
    check_train_artifacts(root, pipe, "segmentation")
    last = pipe._train_metrics[-1]
    step_ms = TRAIN_BATCH / last["images_per_sec"] * 1e3
    print(f"seg train: train_seg.run, {TRAIN_EPOCHS} epochs of {-(-N_TRAIN // TRAIN_BATCH)} "
          f"steps at batch {TRAIN_BATCH}, 640x640, bf16: {seconds:.2f} s in all; epoch 2: "
          f"{step_ms:.3f} ms/step = {last['images_per_sec']:.1f} images/s (host clock, "
          f"loader included); peak memory allocated {peak / 2 ** 30:.3f} GiB; losses "
          f"{[round(m['aggregate_loss'], 4) for m in pipe._train_metrics]}, seg_loss "
          f"{[round(m['seg_loss'], 4) for m in pipe._train_metrics]}, dice_score "
          f"{[round(m['dice_score'], 4) for m in pipe._train_metrics]}")
    anchors = shipped_anchors("segmentation")
    first = copy.deepcopy(config)
    first["train_config"]["loss_config"]["cap_policy"] = "first"
    parity = card_vs_cpu_step(first, anchors, "segmentation", SEG_TRAIN_LIMITS)
    losses, fixed_ms, (lpipe, _) = learning_check(config, anchors, "segmentation",
                                                  SEG_LEARN_STEPS)
    learned = save_learned(root, config, lpipe.model)
    del lpipe
    evaluated = eval_phase(root, learned, "segmentation")
    return dict(cli_seconds=seconds, epoch2_step_ms=step_ms, peak_bytes=peak,
                train_metrics=pipe._train_metrics, eval_metrics=pipe._eval_metrics,
                card_vs_cpu=parity, learning_losses=losses, fixed_batch_step_ms=fixed_ms,
                eval=evaluated)


# ---------------------------------------------------------------- TrackNet
# The TrackNet phases (configs/tracknet: the base architecture at width
# 1.0, 640x352, 3 stacked frames, bf16 compute, Adadelta). Card bf16 vs CPU
# f32 logits of one serve batch, (max, mean) |card - cpu|: about 3x the
# first reading on an H100 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md):
# 0.0129 and 8.49e-4 (max |ref| 1.07).
TN_LOGIT_LIMITS = (0.04, 2.5e-3)
# one TrackNet train step on 1 window against the CPU f32 step (the conv
# biases in front of a train-mode BatchNorm left out, as in phase 6), about
# 3x the first reading: f32 loss rel 8.66e-8, 1 - lowest cosine 5.43e-5,
# BatchNorm 8.35e-7; bf16 loss rel 3.56e-5, BatchNorm 1.76e-3 (bf16
# gradients held by BF16_COS_RATIO, read 1.11 and 1.02). The f32 loss
# differs by whole ulps (one ulp of 5.5 is 8.7e-8 of it): four runs read 1,
# 1, 1 and 2 ulps, so its limit is 3x the 2-ulp reading. On the first
# window in path order (`tn_batch`), with the CPU's BatchNorm at f32
# rounding: 1 ulp, 1.95e-5, 1.19e-7
TN_TRAIN_LIMITS = {
    "f32": {"loss_rel": 5.2e-7, "one_minus_min_cos": 1.6e-4, "bn_stats": 2.5e-6},
    "bf16": {"loss_rel": 1.1e-4, "bn_stats": 5.3e-3},
}
# |f1 card bf16 - cpu f32| of eval_tracknet: the learned clip's eval split
# holds 5 windows, and one window scored differently moves f1 by up to
# about 0.2
TN_EVAL_F1_LIMIT = 0.25
TN_EVAL_KEYS = ["f1", "precision", "recall", "tp", "tn", "fp", "fn", "eval_loss",
                "num_windows", "decode", "form", "weights"]
TN_FRAMES, TN_SHORT = 40, 16
TN_SERVE_BATCHES = (8, 32)
TN_CPU_IMAGES = 2
TN_BIG_BATCH = 64
TN_CLIPS, TN_CLIP_FRAMES = 3, 17  # 45 windows: 31 train (1 step of 16), 14 eval
TN_LEARN_FRAMES = TRAIN_BATCH + 2  # one clip whose 16 windows are the learning batch
# The learning clip's heatmaps are drawn with variance TN_LEARN_DIAMETER
# (the config's avg_diameter, 5, leaves ~21 of a window's 225,280 pixels
# at or above 128). On the card (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md)
# the shipped Adadelta at variance 20 hit the ball in all 13 windows
# where it is visible at step 200 (at 100: step 550); Adam at lr 1e-3 or
# 1e-2 left 1-9 of the 256 class channels alive behind dec_13's ReLU and hit
# none in 300-400 steps; the advanced net, whose logits end in SiLU, hit
# all 13 with the config's Adam at 1e-3 at step 220 (first reading). f1
# does not depend on the variance
TN_LEARN_DIAMETER, TN_LEARN_MAX_STEPS, TN_LEARN_EVERY = 20, 400, 25
# The advanced TrackNet phases (configs/tracknet/config_advanced.yaml:
# CSPNet + RepBiPAN, DeconvRepBiPAN + DeconvCSPNet at width 0.5, depth 0.3,
# canonical RepVGG, Adam 1e-3; the same clips, batches and learning clip).
# Card bf16 vs CPU f32 logits of one serve batch, (max, mean) |card - cpu|:
# about 3x the first reading on an H100 (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md): 3.21e-4 and 4.97e-5 (max |ref| 0.0614).
TN_ADV_LOGIT_LIMITS = (1e-3, 1.5e-4)
# one train step on 1 window (the first in path order, `tn_batch`) against
# the CPU f32 step, about 3x the readings on that window (two, equal, on
# an H100, NVIDIA H100 80GB HBM3, 700.00 W): f32 loss rel 8.60e-8 (1 ulp of
# 5.54; the limit is the base net's, 3x 2 ulps), 1 - lowest cosine 2.56e-7
# (a decoder CSPSPPF BatchNorm bias), BatchNorm 1.93e-5; bf16 loss rel
# 1.31e-4 (another window 3.5e-5), BatchNorm 0.0715 (bf16 gradients held
# by BF16_COS_RATIO, read 1.34 and 1.23)
TN_ADV_TRAIN_LIMITS = {
    "f32": {"loss_rel": 5.2e-7, "one_minus_min_cos": 8e-7, "bn_stats": 6e-5},
    "bf16": {"loss_rel": 8e-4, "bn_stats": 0.2},
}


def tn_background():
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:VIDEO_HW[0], 0:VIDEO_HW[1]]
    bg = np.stack([70 + 40 * np.sin(xx / 70.0) * np.cos(yy / 90.0), 120 + 30 * np.cos(yy / 50.0),
                   60 + 25 * np.sin((xx - yy) / 120.0)], axis=-1)
    return np.clip(bg + rng.normal(0, 10, bg.shape), 0, 255).astype(np.uint8)


def tn_ball(t: int, lane: int = 0):
    """(x, y) of the ball in frame t of lane `lane`, in 1280x720 pixels: a
    parabola across the frame."""
    x = (90 + 27 * t + 40 * lane) * VIDEO_HW[1] / 1280
    y = (560 - 17 * t + 0.42 * t * t - 60 * lane) * VIDEO_HW[0] / 720
    return float(x), float(y)


def tn_frame(background, xy, visible=True):
    img = background.copy()
    if visible:
        yy, xx = np.ogrid[0:VIDEO_HW[0], 0:VIDEO_HW[1]]
        r = 7 * VIDEO_HW[1] / 1280
        img[(yy - xy[1]) ** 2 + (xx - xy[0]) ** 2 <= r * r] = (240, 235, 70)
    return img


def write_tn_clips(root):
    """The TrackNet serve inputs: mp4v clips of TN_FRAMES and TN_SHORT
    frames (1280x720, a ball on a textured background) and the
    TN_FRAMES frames as a folder of JPEGs."""
    import cv2

    bg = tn_background()
    frames = [tn_frame(bg, tn_ball(t)) for t in range(TN_FRAMES)]
    paths = {}
    for n in (TN_FRAMES, TN_SHORT):
        paths[n] = os.path.join(root, f"tn_clip{n}.mp4")
        writer = cv2.VideoWriter(paths[n], cv2.VideoWriter_fourcc(*"mp4v"), VIDEO_FPS,
                                 (VIDEO_HW[1], VIDEO_HW[0]))
        check(writer.isOpened(), "cv2 cannot write mp4v video on this machine")
        for f in frames[:n]:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
    folder = os.path.join(root, "tn_frames")
    os.makedirs(folder)
    for t, f in enumerate(frames):
        cv2.imwrite(os.path.join(folder, f"{t:04d}.jpg"), cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    return paths, folder


TN_BASE, TN_ADV = "config.yaml", "config_advanced.yaml"


def tn_config(name=TN_BASE):
    from vision_conglomerate_torch.utils import load_yaml

    return load_yaml(os.path.join(REPO, "configs", "tracknet", name))


def tn_label(config):
    """The prefix of a TrackNet phase's lines: "tracknet" for the base
    architecture, "tracknet adv" for the advanced one."""
    return "tracknet adv" if config["model_config"]["architecture"] == "advanced" else "tracknet"


def tn_seeded_net(config, dtype=torch.float32, device="cpu", state=None):
    """A train-form TrackNet with the config's init (uniform in both
    shipped configs) and non-trivial BatchNorm state from SEED (or the
    given state_dict)."""
    from vision_conglomerate_torch.models import TrackNet
    from vision_conglomerate_torch.nn.blocks import randomize_batchnorm_
    from vision_conglomerate_torch.nn.initializers import INIT_SCHEMES

    net = TrackNet(config["model_config"], dtype=dtype, device="cpu")
    if state is None:
        g = torch.Generator().manual_seed(SEED)
        init = INIT_SCHEMES[config["model_config"].get("weight_init", "uniform")]
        randomize_batchnorm_(init(net, g), g)
    else:
        net.load_state_dict(state)
    return net.to(device)


def save_tn_checkpoint(path, net):
    from vision_conglomerate_torch.train.checkpoint import save_checkpoint
    from vision_conglomerate_torch.weights import state_dict_to_flax

    state = {k: v.float().cpu() for k, v in net.state_dict().items()}
    save_checkpoint(path, {"LAST_EPOCH": 0, "NETWORK_PARAMS": state_dict_to_flax(state)})
    return path


def tn_serve(path, ckpt, config, storage, batch_size, device="cuda", use_reparam=True,
             quantize=None):
    """One run_tracknet_inference call; (host-clock seconds, output dir,
    video.mp4 frames, output.csv rows as a DataFrame)."""
    import pandas as pd
    from vision_conglomerate_torch.infer.tracknet_runner import run_tracknet_inference

    t0 = time.time()
    out = run_tracknet_inference(path, ckpt, config, batch_size=batch_size, with_summary=True,
                                 storage_path=storage, device=device, use_reparam=use_reparam,
                                 quantize=quantize)
    if device == "cuda":
        torch.cuda.synchronize()
    return time.time() - t0, out, video_frames(out), pd.read_csv(os.path.join(out, "output.csv"))


def tn_routed(config):
    """({route: launches a batch}, {activations}) of the kernel-routed convs
    of the config's TrackNet in the deploy form that load_tracknet_model
    builds (built on the meta device, no weights)."""
    from vision_conglomerate_torch.infer.tracknet_runner import adv_repvgg_canonical
    from vision_conglomerate_torch.models import TrackNet

    mc = config["model_config"]
    fuse = mc["architecture"] == "advanced" and adv_repvgg_canonical(mc)
    net = TrackNet(mc, folded=True, deploy=fuse, device="meta")
    routed = [(kernel_conv(m)[0], m.activation) for m in net.modules() if kernel_conv(m)]
    return dict(Counter(r for r, _ in routed)), {a for _, a in routed}


def tn_serve_phase(root, name=TN_BASE):
    """The seeded TrackNet of configs/tracknet/<name> served on the card:
    the clip at each of TN_SERVE_BATCHES and the frame folder (counters
    zeroed before, read after: each kernel's launches a batch times the
    batches; base: 18 conv3x3), video.mp4 frames and output.csv; for the
    advanced net the clip once more at batch 32 in the train form
    (`use_reparam=False`, no kernel launch); warm frames/s; then card vs
    CPU at batch TN_SERVE_BATCHES[-1]. Returns the results, the kernel
    shapes of one batch of TN_SERVE_BATCHES[-1] and {shape: launches} of
    the run's other batches."""
    config = tn_config(name)
    label = tn_label(config)
    adv = name == TN_ADV
    net = tn_seeded_net(config)
    ckpt = save_tn_checkpoint(os.path.join(root, "tn", "TrackNet.ckpt.tar"), net)
    clips, folder = write_tn_clips(root)
    per_batch, acts = tn_routed(config)
    windows = TN_FRAMES - 2
    zero_counters()
    runs = {}
    with recording_kernel_shapes() as run_seen:
        for bs in TN_SERVE_BATCHES:
            runs[f"video_b{bs}"] = tn_serve(clips[TN_FRAMES], ckpt, config,
                                            os.path.join(root, f"tn_video_b{bs}"), bs)
        runs["folder_b8"] = tn_serve(folder, ckpt, config, os.path.join(root, "tn_folder"), 8)
    counts = read_counters()
    launches = {route: counts[route] for route in per_batch}
    n_batches = 2 * -(-windows // 8) + -(-windows // 32)
    print(f"{label} serve: {TN_FRAMES} frames 1280x720 through run_tracknet_inference, the clip "
          f"at batch {TN_SERVE_BATCHES} and the frame folder at 8: "
          + ", ".join(f"{k} {v[0]:.2f} s" for k, v in runs.items())
          + f" (first calls); launches {launches} in {n_batches} batches, {per_batch} a batch")
    for route in KERNELS:
        n = per_batch.get(route, 0)
        check(counts[route] == n * n_batches == sum(1 for r in run_seen if r[0] == route),
              f"{label}: {counts[route]} {route} launches "
              f"({sum(1 for r in run_seen if r[0] == route)} recorded) in {n_batches} batches, "
              f"want {n} each")
    check({s[3] for s in run_seen} == acts,
          f"{label} deploy form routes {sorted(set(run_seen))}")
    full = TN_SERVE_BATCHES[-1]
    one_batch = [s for s in run_seen if s[1][0] == full][:sum(per_batch.values())]
    others = Counter(s for s in run_seen if s[1][0] != full)
    print(f"{label} serve: the run's kernel launches by batch size "
          f"{dict(sorted(Counter(s[1][0] for s in run_seen).items()))}")
    if adv:
        zero_counters()
        runs["video_b32_train_form"] = tn_serve(clips[TN_FRAMES], ckpt, config,
                                                os.path.join(root, "tn_train_form"), 32,
                                                use_reparam=False)
        check(read_counters() == {route: 0 for route in KERNELS},
              f"{label}: the train form launched {read_counters()}")
    stats = {}
    for key, (_, _, frames, df) in runs.items():
        check(frames == TN_FRAMES, f"{label} {key}: video.mp4 has {frames} frames, want "
                                   f"{TN_FRAMES}")
        check(list(df.columns) == ["frame", "x", "y", "r"] and len(df) <= windows
              and bool((df["frame"] > 2).all()) and bool(np.isfinite(df.to_numpy()).all()),
              f"{label} {key}: output.csv {list(df.columns)}, {len(df)} rows")
        stats[key] = dict(rows=len(df))
    print(f"{label} serve: output.csv rows " + ", ".join(f"{k} {v['rows']}"
                                                         for k, v in stats.items())
          + f" of {windows} windows (a random net; video.mp4 {TN_FRAMES} frames each)")
    warm = []
    for i in range(2):
        t_short = tn_serve(clips[TN_SHORT], ckpt, config, os.path.join(root, f"tn_ws{i}"), 32)[0]
        t_long = tn_serve(clips[TN_FRAMES], ckpt, config, os.path.join(root, f"tn_wl{i}"), 32)[0]
        warm.append((TN_FRAMES - TN_SHORT) / (t_long - t_short))
    print(f"{label} serve: warm {warm[0]:.3f} and {warm[1]:.3f} frames/s at batch 32, "
          f"({TN_FRAMES} - {TN_SHORT}) frames over the difference of two calls (host clock: "
          f"decode, 9-channel resize, forward, heatmap resize, decode, drawing, mp4 encode)")
    cmp, fwd_ms = tn_compare_models(config, ckpt, folder, full,
                                    TN_ADV_LOGIT_LIMITS if adv else TN_LOGIT_LIMITS)
    path = "tracknet_adv_serve" if adv else "tracknet_serve"
    extra = {shape: f"{path} run x{n}, batch {shape[1][0]}" for shape, n in others.items()}
    int8, int8_batch, int8_tail = tn_int8_serve(
        root, config, ckpt, clips, folder, fwd_ms,
        INT8_TN_ADV_LOGIT_LIMITS if adv else INT8_TN_LOGIT_LIMITS)
    int8["one_batch"] = int8_batch
    int8["extra"] = {shape: f"{path}_int8 run x{n}, batch {shape[1][0]}"
                     for shape, n in int8_tail.items()}
    return dict(first_call_seconds={k: v[0] for k, v in runs.items()}, launches=launches,
                launches_per_batch=per_batch, outputs=stats, warm_frames_per_s=warm,
                model_vs_cpu=cmp, forward_batch=full, forward_ms_per_batch=fwd_ms,
                int8=int8), one_batch, extra


def tn_compare_models(config, ckpt, folder, batch, limits):
    """Card (bf16, the kernels) vs CPU (f32, plain versions) logits of the
    first TN_CPU_IMAGES windows of a batch of `batch` (gated by `limits`,
    (max, mean) |d|), the argmax agreement (reported) and the forward's
    time."""
    from vision_conglomerate_torch.data.inference import TrackNetInferenceImgDataset
    from vision_conglomerate_torch.infer.tracknet_runner import load_tracknet_model

    label = tn_label(config)
    img_wh = tuple(config["train_config"]["img_config"]["img_wh"])
    ds = TrackNetInferenceImgDataset(folder, img_wh=img_wh)
    x = np.stack([ds[i][0] for i in range(batch)])
    gpu = load_tracknet_model(ckpt, config["model_config"], device="cuda")
    cpu = load_tracknet_model(ckpt, config["model_config"], device="cpu")
    xg = torch.from_numpy(x).cuda().permute(0, 3, 1, 2)
    with torch.no_grad():
        got = gpu(xg)
        torch.cuda.synchronize()
        t0 = time.time()
        want = cpu(torch.from_numpy(x[:TN_CPU_IMAGES]).permute(0, 3, 1, 2))
        cpu_s = time.time() - t0
    check(tuple(got.shape) == (batch, 256, img_wh[1], img_wh[0]), f"logits {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite TrackNet logits on the card")
    g = got[:TN_CPU_IMAGES].float().cpu()
    del got
    diff = (g - want).abs()
    agree = (g.argmax(1) == want.argmax(1)).float().mean().item()
    stats = dict(max_abs_err=diff.max().item(), mean_abs_err=diff.mean().item(),
                 max_ref=want.abs().max().item(), argmax_agreement=agree, cpu_seconds=cpu_s)
    print(f"{label} serve: card bf16 (a batch of {batch}) vs cpu f32 logits of the first "
          f"{TN_CPU_IMAGES} windows: max |d| "
          f"{stats['max_abs_err']:.6g} (limit {limits[0]:g}), mean |d| "
          f"{stats['mean_abs_err']:.6g} (limit {limits[1]:g}), max |ref| "
          f"{stats['max_ref']:.6g}; argmax agreement {agree:.4f} of the pixels (reported, not "
          f"gated); cpu forward {cpu_s:.2f} s")
    check(diff.max().item() <= limits[0] and diff.mean().item() <= limits[1],
          f"card {label} logits differ from the CPU reference")

    def forward():
        with torch.no_grad():
            gpu(xg, inference=True, og_size=VIDEO_HW)

    forward()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(10):
        forward()
    torch.cuda.synchronize()
    fwd_ms = (time.time() - t0) / 10 * 1e3
    print(f"{label} serve: forward + argmax + resize to 1280x720 at batch {batch}: "
          f"{fwd_ms:.3f} ms/batch (host clock, synchronized)")
    return stats, fwd_ms


def big_conv_case(g):
    """dec_13 at batch TN_BIG_BATCH: an output of 3.7e9 elements (past
    2^31); the last image held against the plain conv of that image."""
    from vision_conglomerate_torch.ops.conv3x3 import conv3x3_bias_act, conv3x3_bias_act_plain

    b, h, w, cin, cout = TN_BIG_BATCH, 352, 640, 64, 256
    x = torch.randn(b, h, w, cin, device="cuda", generator=g).bfloat16()
    w_oihw = (torch.randn(cout, 3, 3, cin, device="cuda", generator=g) / (9 * cin) ** 0.5
              ).bfloat16().permute(0, 3, 1, 2)
    wt = w_oihw.permute(2, 3, 1, 0)
    bias = torch.randn(cout, device="cuda", generator=g)
    y = conv3x3_bias_act(x, wt, bias, "relu")
    want = conv3x3_bias_act_plain(x[-1:], wt, bias, "relu")
    torch.cuda.synchronize()
    err = (y[-1:].float() - want.float()).abs()
    ok = bool((err <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs()).all())
    ms = device_ms(lambda: conv3x3_bias_act(x, wt, bias, "relu"), iters=5)
    del y
    x_nchw = x.permute(0, 3, 1, 2)
    lib_ms = device_ms(lambda: F.relu(F.conv2d(x_nchw, w_oihw, bias.bfloat16(), padding=1)),
                       iters=5)
    nbytes = 2 * (b * h * w * cin + 9 * cin * cout + b * h * w * cout) + 4 * cout
    flops = 2 * b * h * w * 9 * cin * cout
    bnd, by = bound_ms(nbytes, flops)
    print(f"kernel conv3x3_bias_act B={b} {h}x{w} {cin}->{cout} (dec_13 at batch {b}, "
          f"{b * h * w * cout:.3g} output elements): {ms:.4f} ms = {flops / ms / 1e9:.1f} TFLOP/s, "
          f"{ms / bnd:.1f}x bound ({bnd:.4f} by {by}), {ms / lib_ms:.2f}x library ({lib_ms:.4f}); "
          f"last image vs plain max |err| {err.max().item():.3g} {'ok' if ok else 'MISMATCH'}")
    check(ok, "conv3x3 kernel disagrees with its plain version past 2^31 output elements")
    return dict(shape=[b, cin, h, w], cout=cout, ms=ms, library_ms=lib_ms, bound_ms=bnd,
                bound_by=by, max_abs_err=err.max().item(), output_elements=b * h * w * cout)


def write_tn_train_data(root, name=TN_BASE):
    """TN_CLIPS clips of TN_CLIP_FRAMES 1280x720 JPEG frames under
    data/game1/Clip*/ with Label.csv (the ball hidden, visibility 0, in
    every 6th frame), a clip of TN_LEARN_FRAMES frames under
    learned/game1/Clip1/, and a temp copy of configs/tracknet/<name> with
    data_path pointing here."""
    import cv2
    import pandas as pd
    import yaml

    bg = tn_background()

    def clip(d, n, lane):
        os.makedirs(d)
        rows = []
        for t in range(n):
            xy = tn_ball(t, lane)
            vis = int(t % 6 != 5)
            name = f"{t:04d}.jpg"
            cv2.imwrite(os.path.join(d, name),
                        cv2.cvtColor(tn_frame(bg, xy, bool(vis)), cv2.COLOR_RGB2BGR))
            rows.append({"file name": name, "visibility": vis, "x-coordinate": xy[0] if vis else 0,
                         "y-coordinate": xy[1] if vis else 0, "status": 0})
        pd.DataFrame(rows).to_csv(os.path.join(d, "Label.csv"), index=False)

    for c in range(TN_CLIPS):
        clip(os.path.join(root, "data", "game1", f"Clip{c + 1}"), TN_CLIP_FRAMES, c)
    clip(os.path.join(root, "learned", "game1", "Clip1"), TN_LEARN_FRAMES, 1)
    with open(os.path.join(REPO, "configs", "tracknet", name)) as f:
        config = yaml.safe_load(f)
    config["train_config"]["data_path"] = os.path.join(root, "data")
    config_path = os.path.join(root, "config.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
    return config, config_path


def tn_pipe(net, config):
    from vision_conglomerate_torch.train.optim import make_optimizer
    from vision_conglomerate_torch.train.tracknet_trainer import TrainTrackNetPipeline

    opt, _ = make_optimizer(config["train_config"]["optimizer_config"], net)
    pipe = TrainTrackNetPipeline(net, opt, init_scheme=None)
    net.train()
    return pipe


def tn_batch(config, data_path, n, path_order=False):
    """The first n windows (uint8 frames, heatmaps, others) of the seed-42
    train split of data_path, or with `path_order` of data_path in the
    order of their frames' paths, collated. (The split's shuffle runs over
    the clips in the order glob lists them, which the file system sets: of
    more than one clip it takes other windows on another machine.)"""
    from vision_conglomerate_torch.train_tracknet import make_datasets

    ds, _ = make_datasets(config, data_path, split_percentage=1.0)
    if path_order:
        ds.labels_df = ds.labels_df.sort_values("frame1", ignore_index=True)
    return ds.collate_fn([ds[i] for i in range(n)])


def tn_step_result(net, config, batch):
    dev = next(net.parameters()).device
    loss = tn_pipe(net, config).train_step(
        *[torch.from_numpy(a).to(dev) for a in batch[:2]]).item()
    grads = {n: p.grad.float().cpu() for n, p in net.named_parameters() if p.requires_grad}
    stats = {n: b.float().cpu() for n, b in net.named_buffers() if "running_" in n}
    return loss, grads, stats


def tn_card_vs_cpu_step(config, limits):
    """One seeded TrackNet, one window: the train step on the card in f32
    and bf16 against the CPU f32 step, as phase 6 does, within `limits`."""
    label = tn_label(config)
    cpu = tn_seeded_net(config)
    state = {k: v.clone() for k, v in cpu.state_dict().items()}
    batch = tn_batch(config, config["train_config"]["data_path"], 1, path_order=True)
    skip = no_grad_biases(cpu)
    t0 = time.time()
    ref = tn_step_result(cpu, config, batch)
    cpu_s = time.time() - t0
    names = [n for n in ref[1] if n not in skip]
    steps = {tag: tn_step_result(tn_seeded_net(config, dtype, dev, state), config, batch)
             for tag, dtype, dev in (("f32", torch.float32, "cuda"),
                                     ("bf16", torch.bfloat16, "cuda"),
                                     ("cpu_bf16", torch.bfloat16, "cpu"))}
    out = {tag: compare_steps(r, ref, names) for tag, r in steps.items()}
    for tag, r in out.items():
        print(f"{label} train: one step on 1 window at 640x352, {tag} vs cpu f32: loss "
              f"{r['loss']:.6f} vs {r['loss_ref']:.6f}, rel {r['loss_rel']:.3e}; 1 - gradient "
              f"cosine: lowest {r['one_minus_min_cos']:.3e} ({r['worst_grad']}), median "
              f"{r['one_minus_median_cos']:.3e}, all as one vector "
              f"{r['one_minus_global_cos']:.3e}; BatchNorm running stats max |d| "
              f"{r['bn_stats']:.3e}" + (f"; limits {limits[tag]}" if tag in limits else ""))
    print(f"{label} train: {len(names)} parameters compared, {len(skip)} conv biases before "
          f"BatchNorm left out; the cpu f32 step took {cpu_s:.2f} s")
    # what `limits` leaves unbounded of the bf16 step's distance from f32
    # (its gradients; a kp net's loss and keypoint terms) is held to the
    # CPU's own bf16 step
    ratio_keys = ["one_minus_global_cos", "one_minus_median_cos"] + [
        k for k in ["loss_rel"] + [f"{t}_rel" for t in KP_TERMS]
        if k in out["bf16"] and k not in limits["bf16"]]
    for key in ratio_keys:
        ratio = out["bf16"][key] / out["cpu_bf16"][key]
        out["bf16"][key + "_ratio"] = ratio
        print(f"{label} train: card bf16 {key} / cpu bf16 {key} = {ratio:.3f} "
              f"(limit {BF16_COS_RATIO:g})")
        check(bool(np.isfinite(ratio)) and ratio <= BF16_COS_RATIO,
              f"{label}: card bf16 gradients are {ratio:.3f}x farther from f32 than the CPU's "
              f"bf16 ({key})")
    for tag, lims in limits.items():
        for key, lim in lims.items():
            v = out[tag][key]
            check(bool(np.isfinite(v)) and v <= lim,
                  f"card {tag} {label} step differs from the CPU: {key} {v:.3e} > {lim:g}")
    return out


def tn_hits(pipe, batch):
    """Windows of the batch whose train-form argmax heatmap decodes (the
    centroid of the pixels >= 128) within 4 px of the ball."""
    frames, heatmaps, others = batch
    _, _, cx, cy, found = pipe.eval_step(frames, heatmaps)
    pipe.model.train()
    cx, cy, found, others = cx.cpu().numpy(), cy.cpu().numpy(), found.cpu().numpy(), \
        others.cpu().numpy()
    vis = others[:, 0] > 0
    return int((found & vis & (np.hypot(cx - others[:, 1], cy - others[:, 2]) <= 4)).sum())


def tn_learning(root, config, out_dir, profile):
    """The seeded net on the learning clip's 16 windows (heatmaps of
    variance TN_LEARN_DIAMETER) as one fixed batch on the card, with the
    config's optimizer: the loss must fall in LEARN_STEPS steps (steps 6 on
    give the step time, and the peak memory is read over them); then on
    until its train form hits the ball in a window (at most
    TN_LEARN_MAX_STEPS steps). Returns the stats and the learned net."""
    import copy

    label = tn_label(config)
    wide = copy.deepcopy(config)
    wide["train_config"]["img_config"]["avg_diameter"] = TN_LEARN_DIAMETER
    pipe = tn_pipe(tn_seeded_net(config, torch.bfloat16, "cuda"), config)
    batch = [torch.from_numpy(a).cuda()
             for a in tn_batch(wide, os.path.join(root, "learned"), TRAIN_BATCH)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(LEARN_STEPS):
        if i == 5:
            torch.cuda.synchronize()
            t0 = time.time()
        losses.append(pipe.train_step(*batch[:2]))
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / (LEARN_STEPS - 5) * 1e3
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).tolist()
    print(f"{label} train: {LEARN_STEPS} steps on one batch of {TRAIN_BATCH} windows: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; fixed-batch step {step_ms:.3f} ms = "
          f"{TRAIN_BATCH / step_ms * 1e3:.1f} windows/s (host clock, synchronized, steps 6-"
          f"{LEARN_STEPS}, no loader); peak memory allocated {peak / 2 ** 30:.3f} GiB")
    check(all(np.isfinite(losses)), f"{label}: non-finite loss while learning: {losses}")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall: {losses}")
    prof = (profile_train(pipe, batch[:2], step_ms, os.path.join(
        out_dir, f"{label.replace('tracknet', 'tn').replace(' ', '_')}_train_profile.txt"))
            if profile else None)
    steps, hits = LEARN_STEPS, 0
    t0 = time.time()
    while steps < TN_LEARN_MAX_STEPS:
        for _ in range(TN_LEARN_EVERY):
            pipe.train_step(*batch[:2])
        steps += TN_LEARN_EVERY
        hits = tn_hits(pipe, batch)
        if hits:
            break
    print(f"{label} train: after {steps} steps (the last {steps - LEARN_STEPS} in "
          f"{time.time() - t0:.1f} s) the train form hits the ball in {hits} of {TRAIN_BATCH} "
          f"windows")
    check(hits > 0, f"{label}: no window hit after {steps} steps on one batch")
    return dict(losses=losses, fixed_batch_step_ms=step_ms, peak_bytes=peak, profile=prof,
                learn_steps=steps, hits=hits), pipe.model


def tn_eval_phase(root, config_path, learned_ckpt, label="tracknet", routes=("conv3x3",)):
    """eval_tracknet, train form and --deploy, on best_model/ over the
    data's eval split and on the learned net over the learning clip's,
    each on the card and the CPU: the JAX CLI's keys, |f1 card - cpu| <=
    TN_EVAL_F1_LIMIT, launches of each kernel of `routes` in the card's
    deploy runs, and the learned net's f1 above 0."""
    import contextlib
    import io

    from vision_conglomerate_torch import eval_tracknet

    runs = {"best_model": (os.path.join(root, "saved_model/tracknet/best_model/TrackNet.ckpt.tar"),
                           []),
            "learned": (learned_ckpt, ["--config_path", config_path,
                                       "--data_path", os.path.join(root, "learned")])}
    res = {}
    for tag, (weights, extra) in runs.items():
        for form in ([], ["--deploy"]):
            out, seconds = {}, {}
            for dev in ("cuda", "cpu"):
                argv = ["--weights_path", weights, "--device", dev] + extra + form
                zero_counters()
                printed = io.StringIO()
                t0 = time.time()
                with contextlib.redirect_stdout(printed):
                    out[dev] = eval_tracknet.run(eval_tracknet.build_parser().parse_args(argv))
                seconds[dev] = time.time() - t0
                if dev == "cuda":
                    launches = {r: read_counters()[r] for r in routes}
                line = json.loads(printed.getvalue().strip().splitlines()[-1])
                check(line == out[dev] and list(line) == TN_EVAL_KEYS,
                      f"eval_tracknet ({tag}, {dev}) printed {list(line)}")
            name = f"{tag} {out['cuda']['form']}"
            d = abs(out["cuda"]["f1"] - out["cpu"]["f1"])
            print(f"{label} eval: eval_tracknet on {name} over {out['cuda']['num_windows']} "
                  f"windows: f1 card bf16 {out['cuda']['f1']} (tp {out['cuda']['tp']}, fp "
                  f"{out['cuda']['fp']}, tn {out['cuda']['tn']}, fn {out['cuda']['fn']}), cpu f32 "
                  f"{out['cpu']['f1']} (tp {out['cpu']['tp']}), |d| {d:.3g} (limit "
                  f"{TN_EVAL_F1_LIMIT:g}); eval loss {out['cuda']['eval_loss']} vs "
                  f"{out['cpu']['eval_loss']}; {seconds['cuda']:.2f} s card, {seconds['cpu']:.2f} "
                  f"s cpu; launches {launches}")
            check(d <= TN_EVAL_F1_LIMIT, f"eval_tracknet ({name}) f1 card vs cpu differs by {d}")
            if form:
                for route, n in launches.items():
                    check(n > 0, f"the {route} kernel never launched in {label} eval_tracknet "
                                 f"({name})")
            if tag == "learned":
                check(out["cuda"]["f1"] > 0 and out["cpu"]["f1"] > 0,
                      f"{label} eval_tracknet gives the learned net f1 {out['cuda']['f1']} (card), "
                      f"{out['cpu']['f1']} (cpu)")
            res[name] = dict(cuda=out["cuda"], cpu=out["cpu"], f1_abs_diff=d, seconds=seconds,
                             launches=launches)
            if tag == "learned" and form:
                def run_int8(dev, weights=weights, extra=extra):
                    argv = ["--weights_path", weights, "--device", dev, "--quantize", "int8"]
                    with contextlib.redirect_stdout(io.StringIO()):
                        got = eval_tracknet.run(eval_tracknet.build_parser().parse_args(
                            argv + extra))
                    check(list(got) == TN_EVAL_KEYS and got["form"] == "int8",
                          f"eval_tracknet --quantize int8 ({dev}) gave {got}")
                    return got

                res[f"{tag} int8"] = int8_eval(run_int8, ["f1"], out["cuda"],
                                               {"f1": TN_EVAL_F1_LIMIT},
                                               f"{label} eval: eval_tracknet on {tag}")
    return res


def tn_train_phase(root, out_dir, profile, name=TN_BASE):
    """train_tracknet.run at configs/tracknet/<name> at batch 16 for 2
    epochs on the card, its artifacts; one step card vs CPU; the learning
    check; eval_tracknet."""
    import pandas as pd
    from vision_conglomerate_torch import train_tracknet
    from vision_conglomerate_torch.train.checkpoint import load_checkpoint

    config, config_path = write_tn_train_data(root, name)
    label = tn_label(config)
    adv = name == TN_ADV
    args = train_tracknet.build_parser().parse_args(
        ["--batch_size", str(TRAIN_BATCH), "--epochs", str(TRAIN_EPOCHS), "--checkpoint_interval",
         "1", "--lr_schedule", "--no_verbose", "--config_path", config_path, "--device", "cuda"])
    cwd = os.getcwd()
    os.chdir(root)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        pipe = train_tracknet.run(args, config, config_path)
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    seconds, peak = time.time() - t0, torch.cuda.max_memory_allocated()
    hist, evals = pipe._train_metrics, pipe._eval_metrics
    check(len(hist) == TRAIN_EPOCHS and len(evals) == TRAIN_EPOCHS,
          f"{label}: {len(hist)} train and {len(evals)} eval records")
    check(all(np.isfinite(m["loss"]) for m in hist + evals), f"{label}: losses {hist} {evals}")
    best = os.path.join(root, "saved_model/tracknet/best_model/TrackNet.ckpt.tar")
    for rel in ("metrics/tracknet/train_metrics.csv", "metrics/tracknet/eval_metrics.csv",
                "saved_model/tracknet/best_model/config/config.yaml"):
        check(os.path.isfile(os.path.join(root, rel)), f"{label} train artifact missing: {rel}")
    ev = pd.read_csv(os.path.join(root, "metrics/tracknet/eval_metrics.csv"))
    check(list(ev.columns) == ["loss", "tp", "tn", "fp", "fn", "precision", "recall", "f1"]
          and len(ev) == TRAIN_EPOCHS, f"{label} eval_metrics.csv: {list(ev.columns)}")
    windows = int(ev[["tp", "tn", "fp", "fn"]].iloc[-1].sum())
    n_eval = TN_CLIPS * (TN_CLIP_FRAMES - 2) - int(0.7 * TN_CLIPS * (TN_CLIP_FRAMES - 2))
    check(windows == n_eval, f"{label} eval scored {windows} windows, want {n_eval}")
    snaps = [f for _, _, fs in os.walk(os.path.join(root, "saved_model/tracknet/checkpoints"))
             for f in fs if f.endswith(".ckpt.tar")]
    check(len(snaps) == TRAIN_EPOCHS, f"{label} snapshots: {snaps}")
    kernels = [v for k, v in _leaves(load_checkpoint(best)["NETWORK_PARAMS"]["params"])
               if k == "kernel"]
    n_convs = sum(isinstance(m, torch.nn.Conv2d) for m in pipe.model.modules())
    check(len(kernels) == n_convs and all(k.dtype == np.float32 for k in kernels),
          f"{label} best model: {len(kernels)} conv kernels for {n_convs} convs")
    step_ms = TRAIN_BATCH / hist[-1]["images_per_sec"] * 1e3
    print(f"{label} train: train_tracknet.run, {TRAIN_EPOCHS} epochs at batch {TRAIN_BATCH}, "
          f"640x352, bf16, {type(pipe.optimizer).__name__} (lr {pipe.current_lr():.3g} after "
          f"the schedule's steps), {n_convs} convs: {seconds:.2f} s in all; epoch 2: "
          f"{step_ms:.3f} ms/step (host clock, loader included); peak memory allocated "
          f"{peak / 2 ** 30:.3f} GiB; "
          f"train losses {[round(m['loss'], 4) for m in hist]}, eval losses "
          f"{[round(m['loss'], 4) for m in evals]}, {windows} eval windows scored")
    parity = tn_card_vs_cpu_step(config, TN_ADV_TRAIN_LIMITS if adv else TN_TRAIN_LIMITS)
    learning, net = tn_learning(root, config, out_dir, profile)
    learned = save_tn_checkpoint(os.path.join(root, "learned_ckpt", "TrackNet.ckpt.tar"), net)
    del net
    evaluated = tn_eval_phase(root, config_path, learned, label,
                              tuple(tn_routed(config)[0]))
    return dict(cli_seconds=seconds, epoch2_step_ms=step_ms, peak_bytes=peak,
                train_metrics=hist, eval_metrics=evals, card_vs_cpu=parity, learning=learning,
                eval=evaluated)


# ---------------------------------------------------------------------------
# int8: the post-training-quantized serve form (`quantize="int8"`), calibrated
# on the card in bf16; its 1x1/s1 and 3x3/s1 convs on the s8 kernels, the
# stem and 3x3/s2 convs on im2col + the s8 matmul, the rest in bf16.
#
# Card int8 vs CPU int8 with the card's own q parameters copied to the CPU
# reference (f32 activations, plain versions), (max, mean) |card - cpu| of
# one batch: both sides quantize their own activations, bf16 on the card
# and f32 on the CPU, so x_q differ at some rounding edges. About 3x the
# first reading on the pinned inputs (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md): detection logits 1.45e-3 and 1.98e-4, boxes 0.125 and
# 3.93e-3 px; seg logits 1.64e-3 and 2.18e-4, boxes 0.292 and 9.08e-3,
# coefficients 1.75e-3 and 2.49e-4, protos 2.42e-3 and 2.03e-4; TrackNet
# logits 0.0658 and 3.85e-3 (max |ref| 1.09), advanced 4.57e-4 and
# 5.39e-5 (max |ref| 0.0614).
INT8_MODEL_LIMITS = {"logits": (4.5e-3, 6e-4), "boxes": (0.38, 0.012)}
INT8_SEG_MODEL_LIMITS = {"logits": (5e-3, 6.6e-4), "boxes": (0.9, 0.028),
                         "coefs": (5.3e-3, 7.5e-4)}
INT8_PROTO_LIMITS = (7.3e-3, 6.1e-4)
INT8_TN_LOGIT_LIMITS = (0.2, 0.012)
INT8_TN_ADV_LOGIT_LIMITS = (1.4e-3, 1.6e-4)
# |int8 - bf16 deploy| on the card of the eval CLIs' metrics on the learned
# nets. First readings (NVIDIA H100 80GB HBM3, 700.00 W): detection mAP@50
# 0.373 (bf16 0.644, int8 0.272; the CPU's int8 0.282): per-tensor int8
# activations cost the net overfit for 100 steps on 16 images most of its
# mAP. That is the scheme's, not a port fault: the card's int8 is the
# CPU's, and on the CPU the port's int8 mAP@50 of a trained net is the JAX
# package's (tests/test_torch_int8_trained.py); the limit holds the port
# near that reading. Seg mask mAP@50 0.0242 and dice 0.0232 (limits 3x);
# TrackNet f1 0 and 0 (the learned clip's eval split holds 5 windows: one
# moves f1 by up to 0.2+). Keypoints: the learned kp net's mAP@50 0.0368
# (held by map50's limit) and PCK@0.1 0.252 (bf16 0.933, int8 0.681; the
# CPU's int8 0.689): held near that reading.
INT8_EVAL_GAP = {"map50": 0.45, "mask_map50": 0.075, "dice": 0.07, "f1": 0.25, "pck10": 0.35}
# card int8 vs CPU int8 keypoint fields of the kp serve batch (the card's q
# parameters on both sides), about 3x the first reading on an H100 (NVIDIA
# H100 80GB HBM3, 700.00 W): xy 0.0405 and 2.89e-3 px, visibility logits
# 1.43e-3 and 2.08e-4; logits and boxes within INT8_MODEL_LIMITS
INT8_KP_LIMITS = {"kp_xy": (0.12, 8.7e-3), "kp_vis": (4.3e-3, 6.2e-4)}


def int8_conv(m, shape=None):
    """For a conv module in its int8 form, (route, input shape, Cout,
    activation) as recording_kernel_shapes lists a launch: "matmul_s8" or
    "conv3x3_s8" where an s8 kernel computes the conv, else "im2col", whose
    GEMM launches the s8 matmul at (1, K, M, 1): M = B*Ho*Wo rows, K the
    patch width padded to a multiple of 16. True without `shape`; None for
    every other module."""
    from vision_conglomerate_torch.nn.blocks import geometry_route

    if not hasattr(m, "q_kernel"):
        return None
    if shape is None:
        return True
    stride, padding = m.q_geometry
    cout, cin, kh, kw = m.q_kernel.shape
    route = geometry_route((kh, kw), stride, padding, m.activation)
    if route:
        return f"{route}_s8", shape, cout, m.activation
    b, _, h, w = shape
    ho = (h + 2 * padding[0] - kh) // stride[0] + 1
    wo = (w + 2 * padding[1] - kw) // stride[1] + 1
    return "im2col", (1, -(-kh * kw * cin // 16) * 16, b * ho * wo, 1), cout, m.activation


def as_launches(seen):
    """A recorded list with each im2col conv as the s8 matmul launch it is."""
    return [("matmul_s8", *s[1:]) if s[0] == "im2col" else s for s in seen]


def quantize_on(model, x, **forward_kw):
    """The int8 PTQ of infer.runner.quantize_model_int8 on batch x, for a
    model a loader built with quantize="int8"; returns the calibration
    absmax ({path: 0-d tensor})."""
    from vision_conglomerate_torch.nn.blocks import cast_conv_weights
    from vision_conglomerate_torch.nn.quantize import collect_calibration, int8_quantize_

    absmax = collect_calibration(model, [x], **forward_kw)
    int8_quantize_(model, absmax)
    cast_conv_weights(model, model.dtype)
    return absmax


def copy_int8(src, dst):
    """Put `dst` (the same net on the CPU, f32 weights) in `src`'s int8
    form with `src`'s q parameters."""
    from vision_conglomerate_torch.nn.blocks import set_int8_
    from vision_conglomerate_torch.nn.quantize import quantizable_modules

    mods = quantizable_modules(dst)
    for path, m in quantizable_modules(src).items():
        if hasattr(m, "q_kernel"):
            set_int8_(mods[path], *(getattr(m, k).cpu() for k in
                                    ("q_kernel", "q_wscale", "q_xscale", "q_bias")))


def calibration_gap(card, cpu):
    """|card - cpu| / cpu of the calibration absmax per conv: max, median."""
    gaps = [abs(card[p].item() - cpu[p].item()) / cpu[p].item() for p in cpu]
    return dict(max=max(gaps), median=float(np.median(gaps)), convs=len(gaps))


def host_ms(fn, iters: int = 10) -> float:
    """Host-clock ms of fn() once warm, synchronized."""
    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.time() - t0) / iters * 1e3


def held(label, group, got, want, limits):
    """(max, mean) |got - want| against limits; printed and gated."""
    diff = (got.float().cpu() - want.float()).abs()
    stats = dict(max_abs_err=diff.max().item(), mean_abs_err=diff.mean().item(),
                 max_ref=want.abs().max().item())
    print(f"{label}: card int8 vs cpu int8 {group}: max |d| {stats['max_abs_err']:.6g} (limit "
          f"{limits[0]:g}), mean |d| {stats['mean_abs_err']:.6g} (limit {limits[1]:g}), "
          f"max |ref| {stats['max_ref']:.6g}")
    check(stats["max_abs_err"] <= limits[0] and stats["mean_abs_err"] <= limits[1],
          f"{label}: card int8 {group} differ from the CPU int8 reference")
    return stats


def int8_label(config, task):
    """"int8 serve", "int8 seg serve" or "int8 kp serve"."""
    if task == "segmentation":
        return "int8 seg serve"
    return "int8 kp serve" if config["model_config"].get("num_keypoints") else "int8 serve"


def int8_compare_models(config, ckpt, img_dir, task, bf16_fwd_ms, profile_path=None,
                        label=None, limits=None):
    """One batch: the card calibrates and quantizes (bf16 activations), the
    CPU reference takes the card's q parameters; decoded predictions (and
    seg protos) card vs CPU, the calibration absmax gap, and the int8
    forward's time beside the bf16 deploy form's."""
    from vision_conglomerate_torch.data.inference import InferenceImgDataset
    from vision_conglomerate_torch.infer.runner import detect, load_detection_model
    from vision_conglomerate_torch.nn.quantize import collect_calibration

    seg = task == "segmentation"
    label = label or int8_label(config, task)
    mc = config["model_config"]
    img_wh = tuple(config["train_config"]["img_config"]["img_wh"])
    ds = InferenceImgDataset(img_dir, img_wh=img_wh)
    items = [ds[i] for i in range(BATCH)]
    imgs = np.stack([a for a, _ in items])
    og_hw = items[0][1].shape[:2]
    x = torch.from_numpy(imgs)
    kw = dict(task=task, num_keypoints=mc.get("num_keypoints"), quantize="int8")
    gpu, c = load_detection_model(ckpt, mc, device="cuda", **kw)
    cpu, _ = load_detection_model(ckpt, mc, device="cpu", **kw)
    card_absmax = quantize_on(gpu, x.cuda().permute(0, 3, 1, 2), inference=True)
    gap = calibration_gap(card_absmax, collect_calibration(cpu, [x.permute(0, 3, 1, 2)],
                                                           inference=True))
    copy_int8(gpu, cpu)
    got, want = detect(gpu, imgs, og_hw), detect(cpu, imgs, og_hw)
    torch.cuda.synchronize()
    (got, got_p), (want, want_p) = (got, want) if seg else ((got, None), (want, None))
    check(tuple(got.shape) == tuple(want.shape) and bool(torch.isfinite(got).all()),
          f"{label}: predictions {tuple(got.shape)} vs {tuple(want.shape)}, or not finite")
    groups = {"logits": slice(0, 1 + c), "boxes": slice(1 + c, 5 + c)}
    if seg:
        groups["coefs"] = slice(5 + c, None)
    limits = limits or (INT8_SEG_MODEL_LIMITS if seg else INT8_MODEL_LIMITS)
    stats = {g: held(label, g, got[..., sl], want[..., sl], limits[g]) for g, sl in groups.items()}
    if gpu.num_keypoints:
        for g, got_f, want_f in zip(("kp_xy", "kp_vis"), kp_fields(got, c), kp_fields(want, c)):
            stats[g] = held(label, g, got_f, want_f, INT8_KP_LIMITS[g])
    if seg:
        check(bool(torch.isfinite(got_p).all()), f"{label}: non-finite protos")
        stats["protos"] = held(label, "protos", got_p, want_p, INT8_PROTO_LIMITS)
    stats["calibration_gap"] = gap
    print(f"{label}: calibration absmax card (bf16 activations) vs cpu (f32) over "
          f"{gap['convs']} convs: |d| / cpu max {gap['max']:.4g}, median {gap['median']:.4g} "
          f"(reported)")
    xg = x.cuda()

    def forward():
        with torch.no_grad():
            gpu(xg.permute(0, 3, 1, 2), inference=True, og_size=og_hw)

    fwd_ms = host_ms(forward)
    print(f"{label}: forward + decode at batch {BATCH}: int8 {fwd_ms:.3f} ms/batch, bf16 deploy "
          f"{bf16_fwd_ms:.3f} (host clock, synchronized)")
    if profile_path:
        profile_forward(forward, fwd_ms, profile_path)
    return stats, fwd_ms


def int8_serve_phase(root, config, ckpt, img_dirs, bf16_fwd_ms, task="detection",
                     profile_path=None, label=None, limits=None, measure_warm=True):
    """The checkpoint served in int8 through run_detection_inference on the
    card (counters zeroed before, read after: each s8 kernel must launch,
    its launches a batch times the batches; the first batch's calibration
    runs the bf16 deploy form once), warm images/s in int8 (with
    `measure_warm`),
    and the card against the CPU (`int8_compare_models`, within `limits`).
    `label` names the printed lines (default by task). Returns the results
    and the int8 conv shapes of one batch."""
    seg = task == "segmentation"
    label = label or int8_label(config, task)
    tag = label.replace(" serve", "").replace(" ", "_")
    zero_counters()
    with recording_kernel_shapes() as run_seen:
        seconds, served = serve(config, ckpt, img_dirs[N_IMAGES], os.path.join(root, f"{tag}_out"),
                                task, "int8")
    s8, bf16 = read_s8_counters(), read_counters()
    n_batches = -(-N_IMAGES // BATCH)
    int8_seen = [s for s in run_seen if s[0] in ("matmul_s8", "conv3x3_s8", "im2col")]
    recorded = Counter(s[0] for s in int8_seen)
    per_batch = {r: n // n_batches for r, n in recorded.items()}
    print(f"{label}: {N_IMAGES} images 1280x720 at batch {BATCH} through "
          f"run_detection_inference(quantize='int8') in {seconds:.2f} s (first call, with the "
          f"calibration); launches: s8 {s8}, bf16 {bf16} (the calibration forward); int8 convs "
          f"a batch {per_batch}")
    for route in S8_KERNELS:
        check(s8[route] > 0, f"the {route} kernel never launched on the {label} path")
    check(s8["im2col"] == recorded["im2col"] > 0
          and s8["matmul_s8"] == recorded["matmul_s8"] + recorded["im2col"]
          and s8["conv3x3_s8"] == recorded["conv3x3_s8"]
          and all(n == per_batch[r] * n_batches for r, n in recorded.items()),
          f"{label}: launches {s8}, recorded {dict(recorded)} in {n_batches} batches")
    files = sorted(os.listdir(served))
    check("output.csv" in files and sum(f.endswith(".png") for f in files) == N_IMAGES,
          f"{label} outputs missing: {files}")
    warm = t_few = t_many = None
    if measure_warm and not seg:  # seg serving is host-bound (mask handling): phase 11
        t_few, _ = serve(config, ckpt, img_dirs[N_IMAGES], os.path.join(root, f"{tag}_few"),
                         task, "int8")
        t_many, _ = serve(config, ckpt, img_dirs[WARM_IMAGES], os.path.join(root, f"{tag}_many"),
                          task, "int8")
        warm = (WARM_IMAGES - N_IMAGES) / (t_many - t_few)
        print(f"{label}: warm end to end {warm:.3f} images/s in int8 = {WARM_IMAGES - N_IMAGES} "
              f"images / ({t_many:.3f} s - {t_few:.3f} s) (host clock)")
    stats, fwd_ms = int8_compare_models(config, ckpt, img_dirs[N_IMAGES], task, bf16_fwd_ms,
                                        profile_path, label, limits)
    one_batch = int8_seen[:sum(per_batch.values())]
    return dict(first_call_seconds=seconds, launches=s8, bf16_launches=bf16,
                launches_per_batch=per_batch, warm_images_per_s=warm,
                warm_seconds={N_IMAGES: t_few, WARM_IMAGES: t_many}, forward_ms_per_batch=fwd_ms,
                bf16_forward_ms_per_batch=bf16_fwd_ms, model_vs_cpu=stats), as_launches(one_batch)


def tn_int8_serve(root, config, ckpt, clips, folder, bf16_fwd_ms, limits):
    """The TrackNet checkpoint served in int8 on the clip at batch 32
    (counters zeroed before, read after: the s8 kernels launch, and the
    bf16 conv3x3 kernel too, for the convs int8 leaves in bf16: dec_13, the
    advanced net's deconv4), warm frames/s, and card vs CPU logits with the
    card's q parameters. Returns the results, the int8 and bf16 kernel
    shapes of one batch of 32 and {shape: launches} of the tail batch."""
    from vision_conglomerate_torch.data.inference import TrackNetInferenceImgDataset
    from vision_conglomerate_torch.infer.tracknet_runner import load_tracknet_model
    from vision_conglomerate_torch.nn.quantize import collect_calibration

    label = f"{tn_label(config)} int8"
    full = TN_SERVE_BATCHES[-1]
    zero_counters()
    with recording_kernel_shapes() as run_seen:
        first = tn_serve(clips[TN_FRAMES], ckpt, config, os.path.join(root, "tn_int8"), full,
                         quantize="int8")
    s8, bf16 = read_s8_counters(), read_counters()
    calib = sum(tn_routed(config)[0].values())  # the calibration forward's bf16 launches
    int8_run = run_seen[calib:]
    routes = Counter(s[0] for s in int8_run)
    print(f"{label} serve: the clip at batch {full} through run_tracknet_inference("
          f"quantize='int8') in {first[0]:.2f} s (first call, with the calibration); launches: "
          f"s8 {s8}, bf16 {bf16} ({calib} of them the calibration forward); int8 run "
          f"{dict(routes)}")
    calibration = Counter(s[0] for s in run_seen[:calib])
    check(s8["conv3x3_s8"] > 0 and bf16["conv3x3"] > calibration["conv3x3"],
          f"{label}: s8 {s8}, bf16 {bf16}: int8 needs the s8 conv and the bf16 conv3x3 kernel")
    check(s8["im2col"] == routes["im2col"]
          and s8["matmul_s8"] == routes["matmul_s8"] + routes["im2col"]
          and s8["conv3x3_s8"] == routes["conv3x3_s8"],
          f"{label}: launches {s8}, recorded {dict(routes)}")
    for route in KERNELS:
        check(bf16[route] == calibration[route] + routes[route],
              f"{label}: {bf16[route]} {route} launches, {calibration[route]} + "
              f"{routes[route]} recorded")
    check(first[2] == TN_FRAMES and len(first[3]) <= TN_FRAMES - 2,
          f"{label}: video.mp4 {first[2]} frames, output.csv {len(first[3])} rows")
    t_short = tn_serve(clips[TN_SHORT], ckpt, config, os.path.join(root, "tn_int8_s"), full,
                       quantize="int8")[0]
    t_long = tn_serve(clips[TN_FRAMES], ckpt, config, os.path.join(root, "tn_int8_l"), full,
                      quantize="int8")[0]
    warm = (TN_FRAMES - TN_SHORT) / (t_long - t_short)
    print(f"{label} serve: warm {warm:.3f} frames/s in int8 at batch {full} (host clock)")
    img_wh = tuple(config["train_config"]["img_config"]["img_wh"])
    ds = TrackNetInferenceImgDataset(folder, img_wh=img_wh)
    x = torch.from_numpy(np.stack([ds[i][0] for i in range(full)]))
    gpu = load_tracknet_model(ckpt, config["model_config"], device="cuda", quantize="int8")
    cpu = load_tracknet_model(ckpt, config["model_config"], device="cpu", quantize="int8")
    xg = x.cuda().permute(0, 3, 1, 2)
    xc = x[:TN_CPU_IMAGES].permute(0, 3, 1, 2)
    # the calibration gap on the first windows only (the CPU's forward of
    # a batch of 32 at 640x352 takes minutes)
    gap = calibration_gap(collect_calibration(gpu, [xg[:TN_CPU_IMAGES]]),
                          collect_calibration(cpu, [xc]))
    quantize_on(gpu, xg)
    copy_int8(gpu, cpu)
    with torch.no_grad():
        got = gpu(xg)[:TN_CPU_IMAGES].float().cpu()
        want = cpu(xc)
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits on the card")
    stats = held(f"{label} serve", "logits", got, want, limits)
    stats["argmax_agreement"] = (got.argmax(1) == want.argmax(1)).float().mean().item()
    stats["calibration_gap"] = gap
    print(f"{label} serve: argmax agreement {stats['argmax_agreement']:.4f} (reported); "
          f"calibration absmax card vs cpu on the first {TN_CPU_IMAGES} windows over "
          f"{gap['convs']} convs: |d| / cpu max {gap['max']:.4g}, median {gap['median']:.4g} "
          f"(reported)")

    def forward():
        with torch.no_grad():
            gpu(xg, inference=True, og_size=VIDEO_HW)

    fwd_ms = host_ms(forward)
    print(f"{label} serve: forward + argmax + resize to 1280x720 at batch {full}: int8 "
          f"{fwd_ms:.3f} ms/batch, bf16 deploy {bf16_fwd_ms:.3f} (host clock, synchronized)")
    # the run's two forwards, a batch of 32 and the 6-window tail, in order
    int8_run = as_launches(int8_run)
    half = len(int8_run) // 2
    one_batch, tail = int8_run[:half], Counter(int8_run[half:])
    check(2 * half == len(int8_run) and all(s[1][0] in (1, full) for s in one_batch),
          f"{label}: {len(int8_run)} launches in the int8 run, not two forwards")
    return dict(first_call_seconds=first[0], launches=s8, bf16_launches=bf16,
                launches_per_batch=dict(Counter(s[0] for s in one_batch)),
                warm_frames_per_s=warm, forward_ms_per_batch=fwd_ms,
                bf16_forward_ms_per_batch=bf16_fwd_ms, model_vs_cpu=stats), one_batch, tail


def int8_eval(run_cli, metrics, bf16_card, limits, label):
    """An eval CLI with --quantize int8 on the card and the CPU, against the
    bf16 deploy form's card metrics (`bf16_card`): |card - cpu| within the
    CLI's card-vs-CPU `limits`, |int8 - bf16| within INT8_EVAL_GAP, and
    both s8 kernels' launches on the card (TrackNet base: the conv)."""
    out, launches, seconds = {}, None, {}
    for dev in ("cuda", "cpu"):
        zero_counters()
        t0 = time.time()
        out[dev] = run_cli(dev)
        seconds[dev] = time.time() - t0
        if dev == "cuda":
            launches = read_s8_counters()
    diffs = {k: abs(out["cuda"][k] - out["cpu"][k]) for k in metrics}
    gaps = {k: abs(out["cuda"][k] - bf16_card[k]) for k in metrics}
    print(f"{label} int8: " + "; ".join(
        f"{k} card int8 {out['cuda'][k]}, cpu int8 {out['cpu'][k]} (|d| {diffs[k]:.3g}, limit "
        f"{limits[k]:g}), card bf16 {bf16_card[k]} (|int8 - bf16| {gaps[k]:.3g}, limit "
        f"{INT8_EVAL_GAP[k]:g})" for k in metrics) + f"; {seconds['cuda']:.2f} s card, "
        f"{seconds['cpu']:.2f} s cpu; s8 launches {launches}")
    check(launches["conv3x3_s8"] > 0, f"{label} int8: the s8 conv never launched")
    for k in metrics:
        check(diffs[k] <= limits[k], f"{label} int8 {k} card vs cpu differs by {diffs[k]:.3g}")
        check(gaps[k] <= INT8_EVAL_GAP[k], f"{label} int8 {k} is {gaps[k]:.3g} from bf16")
    return dict(cuda=out["cuda"], cpu=out["cpu"], abs_diff=diffs, gap_to_bf16=gaps,
                launches=launches, seconds=seconds)


# --------------------------------------------------------------- keypoints
def make_kp_checkpoint(root):
    """A DetectionNet at the shipped keypoint config with KP keypoints and
    KP_CLASSES classes, weights and non-trivial BatchNorm state from SEED,
    as a JAX-format checkpoint; returns (the config with num_keypoints, as
    the train CLI saves it, the checkpoint, the train-form net on the
    CPU)."""
    from vision_conglomerate_torch.models import DetectionNet
    from vision_conglomerate_torch.nn.blocks import init_weights_, randomize_batchnorm_
    from vision_conglomerate_torch.train.checkpoint import save_checkpoint
    from vision_conglomerate_torch.utils import load_yaml
    from vision_conglomerate_torch.weights import state_dict_to_flax

    config = load_yaml(os.path.join(REPO, "configs", "detection", "config_kp.yaml"))
    config["model_config"]["num_keypoints"] = KP
    g = torch.Generator().manual_seed(SEED)
    net = DetectionNet(KP_CLASSES, config["model_config"],
                       anchors=shipped_anchors("detection", "_kp"), num_keypoints=KP, device="cpu")
    randomize_batchnorm_(init_weights_(net, g), g)
    ckpt = os.path.join(root, "kp", "DetectionNet.ckpt.tar")
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": KP_CLASSES,
                           "NETWORK_PARAMS": state_dict_to_flax(net.state_dict())})
    return config, ckpt, net


def kp_fields(preds, num_classes):
    """(keypoint xy, visibility logits) of decoded predictions whose last
    KP * 5 columns are the keypoints."""
    kp = preds[..., 5 + num_classes:].unflatten(-1, (KP, 5))
    return kp[..., :2], kp[..., 2:]


@contextlib.contextmanager
def drawn_keypoints():
    """The keypoint rows each call of the runner's apply_keypoints draws."""
    from vision_conglomerate_torch.infer import runner

    rows, draw = [], runner.apply_keypoints

    def recording(img, keypoints):
        rows.append(np.asarray(keypoints))
        return draw(img, keypoints)

    runner.apply_keypoints = recording
    try:
        yield rows
    finally:
        runner.apply_keypoints = draw


def kp_compare_models(config, ckpt, img_dir):
    """kp card (bf16, kernels) on one batch vs the CPU (f32) on its first
    KP_CPU_IMAGES images, by field group (KP_MODEL_LIMITS); also the
    forward's kernel shapes and its time a batch."""
    from vision_conglomerate_torch.data.inference import InferenceImgDataset
    from vision_conglomerate_torch.infer.runner import detect, load_detection_model

    mc = config["model_config"]
    img_wh = tuple(config["train_config"]["img_config"]["img_wh"])
    ds = InferenceImgDataset(img_dir, img_wh=img_wh)
    items = [ds[i] for i in range(BATCH)]
    imgs = np.stack([a for a, _ in items])
    og_hw = items[0][1].shape[:2]
    gpu, c = load_detection_model(ckpt, mc, num_keypoints=KP, device="cuda")
    cpu, _ = load_detection_model(ckpt, mc, num_keypoints=KP, device="cpu")
    seen, handles = record_kernel_shapes(gpu)
    got = detect(gpu, imgs, og_hw)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    want = detect(cpu, imgs[:KP_CPU_IMAGES], og_hw)
    m = 3 * sum((img_wh[0] // s) * (img_wh[1] // s) for s in (8, 16, 32))
    check(tuple(got.shape) == (BATCH, m, 5 + c + 5 * KP)
          and tuple(want.shape) == (KP_CPU_IMAGES,) + tuple(got.shape[1:]),
          f"kp pred shapes {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite kp predictions on the card")
    got = got[:KP_CPU_IMAGES].float().cpu()
    groups = {"logits": (got[..., :1 + c], want[..., :1 + c]),
              "boxes": (got[..., 1 + c:5 + c], want[..., 1 + c:5 + c])}
    for g, got_f, want_f in zip(("kp_xy", "kp_vis"), kp_fields(got, c), kp_fields(want, c)):
        groups[g] = (got_f, want_f)
    stats = {}
    for group, (g, w) in groups.items():
        diff = (g - w).abs()
        max_lim, mean_lim = KP_MODEL_LIMITS[group]
        stats[group] = dict(max_abs_err=diff.max().item(), mean_abs_err=diff.mean().item(),
                            max_ref=w.abs().max().item())
        print(f"kp serve: card bf16 vs cpu f32 {group} on {KP_CPU_IMAGES} images: max |d| "
              f"{stats[group]['max_abs_err']:.6g} (limit {max_lim:g}), mean |d| "
              f"{stats[group]['mean_abs_err']:.6g} (limit {mean_lim:g}), max |ref| "
              f"{stats[group]['max_ref']:.6g}")
        check(stats[group]["max_abs_err"] <= max_lim and stats[group]["mean_abs_err"] <= mean_lim,
              f"kp card predictions differ from the CPU reference in {group}")
    x = torch.from_numpy(imgs).cuda()

    def forward():
        with torch.no_grad():
            gpu(x.permute(0, 3, 1, 2), inference=True, og_size=og_hw)

    return seen, stats, host_ms(forward)


def kp_serve_phase(root, img_dirs, det_fwd_ms):
    """The keypoint checkpoint served through run_detection_inference on
    the card (counters zeroed before, read after: each kernel's launches a
    batch times the batches, as the forward hook records them; every image
    gets its boxes' keypoints drawn), the warm images/s, and the card
    against the CPU."""
    config, ckpt, net = make_kp_checkpoint(root)
    zero_counters()
    with drawn_keypoints() as rows:
        seconds, served = serve(config, ckpt, img_dirs[N_IMAGES], os.path.join(root, "kp_out"))
    launches = read_counters()
    files = sorted(os.listdir(served))
    check("output.csv" in files and sum(f.endswith(".png") for f in files) == N_IMAGES,
          f"kp serve outputs missing: {files}")
    check(len(rows) == N_IMAGES and all(len(r) and len(r) % KP == 0 for r in rows),
          f"kp serve drew keypoints {[len(r) for r in rows]} on {N_IMAGES} images")
    t_few, _ = serve(config, ckpt, img_dirs[N_IMAGES], os.path.join(root, "kp_few"))
    t_many, _ = serve(config, ckpt, img_dirs[WARM_IMAGES], os.path.join(root, "kp_many"))
    warm = (WARM_IMAGES - N_IMAGES) / (t_many - t_few)
    seen, stats, fwd_ms = kp_compare_models(config, ckpt, img_dirs[N_IMAGES])
    n_batches = -(-N_IMAGES // BATCH)
    per_batch = {route: sum(1 for s_ in seen if s_[0] == route) for route in launches}
    print(f"kp serve: {N_IMAGES} images 1280x720 at batch {BATCH} through "
          f"run_detection_inference (config_kp, {KP} keypoints) in {seconds:.2f} s (first call); "
          f"launches {launches}, a batch {per_batch}; keypoints drawn {sum(map(len, rows))}; "
          f"warm {warm:.3f} images/s = {WARM_IMAGES - N_IMAGES} images / ({t_many:.3f} s - "
          f"{t_few:.3f} s); forward + decode at batch {BATCH} {fwd_ms:.3f} ms/batch, detection's "
          f"{det_fwd_ms:.3f} (host clock, synchronized)")
    for route, n in launches.items():
        check(n > 0 and n == n_batches * per_batch[route],
              f"kp {route}: {n} launches in {n_batches} batches, the forward routes "
              f"{per_batch[route]}")
    return dict(first_call_seconds=seconds, launches=launches, launches_per_batch=per_batch,
                keypoint_rows_drawn=sum(map(len, rows)), warm_images_per_s=warm,
                warm_seconds={N_IMAGES: t_few, WARM_IMAGES: t_many}, forward_ms_per_batch=fwd_ms,
                model_vs_cpu=stats), seen, (config, ckpt, net)


def kp_video_phase(root, clip, samples, kp):
    """The clip served with the keypoint checkpoint (its conf and class
    layers rescaled on the clip as the video phase does, class mean
    KP_CLASS_MEAN) at frame_skips 1, once for each class as
    tracked_classes: 24 frames in video.mp4 each time, both counters
    risen, output.csv of that class only, track rows in all, and the
    tracked rows' keypoint payloads drawn: KP rows for each row of
    output.csv."""
    config, _, net = kp
    ckpt = tracking_checkpoint(os.path.join(root, "kp"), config, net, samples,
                               class_mean=KP_CLASS_MEAN)
    zero_counters()
    runs = {}
    for cls in range(KP_CLASSES):
        with drawn_keypoints() as rows:
            seconds, out, df = serve_video(clip, ckpt, config,
                                           os.path.join(root, f"kp_video{cls}"), frame_skips=1,
                                           tracked_classes=[cls])
        runs[cls] = dict(seconds=seconds, frames=video_frames(out),
                         rows=0 if df is None else len(df),
                         classes=[] if df is None else sorted(set(df["class"])),
                         keypoint_rows=sum(map(len, rows)))
    launches = read_counters()
    print(f"kp video: {VIDEO_FRAMES} frames 1280x720, frame_skips 1, batch "
          f"{VIDEO_KW['batch_size']}, tracked_classes [c]: " + "; ".join(
              f"[{c}] {r['seconds']:.2f} s, video.mp4 {r['frames']} frames, output.csv "
              f"{r['rows']} track rows of classes {r['classes']}, {r['keypoint_rows']} keypoint "
              f"rows drawn" for c, r in runs.items()) + f"; launches {launches}")
    for route, n in launches.items():
        check(n > 0, f"the {route} kernel never launched serving the kp video")
    for c, r in runs.items():
        check(r["frames"] == VIDEO_FRAMES // 2,
              f"kp video.mp4 has {r['frames']} frames, want {VIDEO_FRAMES // 2}")
        check(r["classes"] in ([], [c]), f"kp video, tracked_classes [{c}]: {r['classes']}")
        check(r["keypoint_rows"] == KP * r["rows"],
              f"kp video: {r['keypoint_rows']} keypoint rows drawn for {r['rows']} track rows")
    check(sum(r["rows"] for r in runs.values()) > 0, "kp video: no track rows")
    return dict(runs=runs, launches=launches)


def write_kp_train_data(root):
    """N_KP_TRAIN train and N_KP_VALID valid 640x640 PNGs by the rule of
    dev/make_shapes_dataset.py --keypoints (bright balls and tall boxes of
    2 classes on a textured background, a top and a bottom keypoint an
    object, about 10% of them vis 0 and not drawn), from SEED, plus temp
    copies of config_kp.yaml (data_path pointing here) and anchors_kp.yaml."""
    import yaml
    from PIL import Image, ImageDraw

    size = 640
    for split, n, seed in (("train", N_KP_TRAIN, SEED), ("valid", N_KP_VALID, SEED + 1)):
        rng = np.random.default_rng(seed)
        d = os.path.join(root, "data", split)
        os.makedirs(d)
        for i in range(n):
            base = rng.integers(40, 160, size=3)
            im = Image.fromarray((rng.normal(0, 18, (size, size, 3)) + base).clip(0, 255)
                                 .astype(np.uint8))
            draw = ImageDraw.Draw(im)
            rows = []
            for _ in range(int(rng.integers(2, 7))):
                cls = int(rng.integers(0, 2))
                if cls == 0:  # a small bright ball
                    r = rng.uniform(0.012, 0.03) * size
                    cx, cy = rng.uniform(r + 2, size - r - 2, 2)
                    draw.ellipse([cx - r, cy - r, cx + r, cy + r],
                                 fill=tuple(int(v) for v in rng.integers(200, 256, 3)),
                                 outline=(30, 30, 30))
                    w = h = 2 * r
                else:  # a tall box
                    w, h = rng.uniform(0.06, 0.14) * size, rng.uniform(0.15, 0.3) * size
                    cx = rng.uniform(w / 2 + 2, size - w / 2 - 2)
                    cy = rng.uniform(h / 2 + 2, size - h / 2 - 2)
                    draw.rectangle([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                                   fill=tuple(int(v) for v in rng.integers(0, 120, 3)),
                                   outline=(240, 240, 240), width=2)
                row = [cls, cx / size, cy / size, w / size, h / size]
                kr = max(2.0, 0.08 * min(w, h))
                for (kx, ky), col in (((cx, cy - h / 2 + kr), (255, 40, 40)),
                                      ((cx, cy + h / 2 - kr), (40, 40, 255))):
                    vis = 2 if rng.uniform() > 0.1 else 0
                    if vis:
                        draw.ellipse([kx - kr, ky - kr, kx + kr, ky + kr], fill=col)
                    row += [kx / size, ky / size, vis]
                rows.append(" ".join(str(v) if isinstance(v, int) else f"{v:.6f}" for v in row))
            im.save(os.path.join(d, f"img_{i:04d}.png"))
            with open(os.path.join(d, f"img_{i:04d}.txt"), "w") as f:
                f.write("\n".join(rows) + "\n")
    with open(os.path.join(REPO, "configs", "detection", "config_kp.yaml")) as f:
        config = yaml.safe_load(f)
    config["train_config"]["data_path"] = os.path.join(root, "data")
    config_path = os.path.join(root, "config.yaml")
    anchors_path = os.path.join(root, "anchors.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
    with open(os.path.join(REPO, "configs", "detection", "anchors_kp.yaml")) as src, \
            open(anchors_path, "w") as dst:
        dst.write(src.read())
    return config, config_path, anchors_path


def kp_train_phase(root):
    """train_det.run (--map_eval) on keypoint data: its artifacts (the saved
    config with num_keypoints, a pck column); one step card vs CPU with the
    keypoint loss terms (TRAIN_LIMITS); the learning check, whose net goes
    on to EVAL_LEARN_STEPS steps; eval_det on both checkpoints, card and
    CPU, in bf16 and int8 (eval_phase)."""
    config, config_path, anchors_path = write_kp_train_data(root)
    pipe, seconds, peak = run_train_cli(root, config, config_path, anchors_path)
    check_train_artifacts(root, pipe)
    last = pipe._train_metrics[-1]
    print(f"kp train: train_det.run on {N_KP_TRAIN} + {N_KP_VALID} keypoint images, "
          f"{TRAIN_EPOCHS} epochs at batch {TRAIN_BATCH}, 640x640, bf16: {seconds:.2f} s in all; "
          f"epoch 2 {last['images_per_sec']:.1f} images/s (host clock, loader included); peak "
          f"memory allocated {peak / 2 ** 30:.3f} GiB; losses "
          f"{[round(m['aggregate_loss'], 4) for m in pipe._train_metrics]}, kp_loss "
          f"{[round(m['kp_loss'], 4) for m in pipe._train_metrics]}")
    config["model_config"]["num_keypoints"] = KP
    anchors = shipped_anchors("detection", "_kp")
    parity = card_vs_cpu_step(config, anchors, limits=KP_TRAIN_LIMITS)
    losses, fixed_ms, (lpipe, batch) = learning_check(config, anchors)
    for _ in range(EVAL_LEARN_STEPS - LEARN_STEPS):
        lpipe.train_step(*batch)
    learned = save_learned(root, config, lpipe.model)
    del lpipe, batch
    evaluated = eval_phase(root, learned, "keypoints")
    return dict(cli_seconds=seconds, peak_bytes=peak, train_metrics=pipe._train_metrics,
                eval_metrics=pipe._eval_metrics, card_vs_cpu=parity, learning_losses=losses,
                fixed_batch_step_ms=fixed_ms, eval=evaluated)


# The detector's alternate components (phases 33-37): two nets, each
# configs/detection/config.yaml as shipped with the named keys changed (a
# dict updates its block), written as a config file the way a user selects
# them; 640x640, 80 classes, the shipped anchors
ALT_NETS = {
    "resnet_basichead": {"backbone": "ResNetBackBone", "head": "BasicHead",
                         "repbipan_config": {"upsample_mode": "bilinear"}},
    "csp_s2d": {"cspbackbone_config": {"space_to_depth_stem": True, "early_min_channels": 64}},
}
# card bf16 vs CPU f32 decoded predictions of one serve batch, (max, mean)
# |card - cpu| per field group, about 3x the first reading on an H100
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): resnet_basichead logits
# 1.51e-3 and 1.88e-4, boxes 0.123 and 5.43e-3 px; csp_s2d logits 1.23e-3
# and 1.73e-4, boxes 0.0909 and 3.71e-3 px
ALT_MODEL_LIMITS = {"resnet_basichead": {"logits": (4.5e-3, 5.6e-4), "boxes": (0.37, 0.016)},
                    "csp_s2d": {"logits": (3.7e-3, 5.2e-4), "boxes": (0.27, 0.011)}}
# card int8 vs CPU int8 (the card's q parameters on both sides), about 3x
# the first reading: resnet_basichead logits 2.21e-3 and 2.66e-4, boxes
# 0.196 and 7.15e-3 px; csp_s2d logits 1.60e-3 and 2.15e-4, boxes 0.126 and
# 4.57e-3 px
ALT_INT8_LIMITS = {"resnet_basichead": {"logits": (6.6e-3, 8e-4), "boxes": (0.59, 0.021)},
                   "csp_s2d": {"logits": (4.8e-3, 6.5e-4), "boxes": (0.38, 0.014)}}
# one train step of each on 2 images against the CPU f32 step is held to
# phase 6's TRAIN_LIMITS; first readings (NVIDIA H100 80GB HBM3, 700.00 W):
# f32 loss rel 1.26e-7 and 0, 1 - lowest cosine 2.10e-5 and 8.7e-9,
# BatchNorm 2.98e-6 and 7.39e-6; bf16 gradient ratios to the CPU's bf16
# step 0.874-1.093 and 1.331-1.568
ALT_TRAIN_STEPS = 2  # steps an epoch of the alternate train CLI run (32 images)
# the serve-fast decode against the runner's decode + postprocess on one
# batch, max |d| of the kept rows (sorted), set before the first reading:
# scores and boxes (the same decode, rescale and postprocess on the same
# bf16 head outputs, repacked from the raw fields; a few f32 ulps of
# 1280 px at most)
FAST_LIMITS = {"scores": 1e-6, "boxes": 1e-3}


def alt_config(name):
    """The shipped detection config with ALT_NETS[name]'s keys changed."""
    from vision_conglomerate_torch.utils import load_yaml

    config = load_yaml(os.path.join(REPO, "configs", "detection", "config.yaml"))
    mc = config["model_config"]
    for key, val in ALT_NETS[name].items():
        mc[key] = {**mc[key], **val} if isinstance(val, dict) else val
    return config


def write_alt(root, name):
    """The alternate net's config file and a checkpoint of a DetectionNet
    built from it with weights and non-trivial BatchNorm state from SEED
    (JAX format); returns (config as read back from the file, checkpoint,
    the train-form net on the CPU)."""
    from vision_conglomerate_torch.models import DetectionNet
    from vision_conglomerate_torch.nn.blocks import init_weights_, randomize_batchnorm_
    from vision_conglomerate_torch.train.checkpoint import save_checkpoint
    from vision_conglomerate_torch.utils import load_yaml, save_yaml
    from vision_conglomerate_torch.weights import state_dict_to_flax

    d = os.path.join(root, name)
    os.makedirs(d)
    save_yaml(alt_config(name), os.path.join(d, "config.yaml"))
    config = load_yaml(os.path.join(d, "config.yaml"))
    g = torch.Generator().manual_seed(SEED)
    net = DetectionNet(NUM_CLASSES, config["model_config"], anchors=shipped_anchors("detection"),
                       device="cpu")
    randomize_batchnorm_(init_weights_(net, g), g)
    ckpt = os.path.join(d, "DetectionNet.ckpt.tar")
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                           "NETWORK_PARAMS": state_dict_to_flax(net.state_dict())})
    return config, ckpt, net


def alt_serve_phase(root, img_dirs, name, det_fwd_ms):
    """An alternate net served through run_detection_inference on the card
    (counters zeroed before, read after: each kernel's launches a batch, as
    the forward hook records them, times the batches), and the card
    against the CPU on one batch (ALT_MODEL_LIMITS)."""
    config, ckpt, net = write_alt(root, name)
    zero_counters()
    seconds, served = serve(config, ckpt, img_dirs[N_IMAGES], os.path.join(root, f"{name}_out"))
    launches = read_counters()
    files = sorted(os.listdir(served))
    check("output.csv" in files and sum(f.endswith(".png") for f in files) == N_IMAGES,
          f"{name} serve outputs missing: {files}")
    seen, stats, fwd_ms, host, _ = compare_models(config, ckpt, img_dirs[N_IMAGES],
                                                  ALT_MODEL_LIMITS[name], f"{name} serve")
    n_batches = -(-N_IMAGES // BATCH)
    per_batch = {route: sum(1 for s_ in seen if s_[0] == route) for route in launches}
    print(f"{name} serve: {N_IMAGES} images 1280x720 at batch {BATCH} through "
          f"run_detection_inference ({ALT_NETS[name]}) in {seconds:.2f} s (first call); "
          f"launches {launches}, a batch {per_batch}; forward + decode {fwd_ms:.3f} ms/batch, "
          f"the shipped detector's {det_fwd_ms:.3f} (host clock, synchronized)")
    for route, n in launches.items():
        check(n > 0 and n == n_batches * per_batch[route],
              f"{name} {route}: {n} launches in {n_batches} batches, the forward routes "
              f"{per_batch[route]}")
    return dict(first_call_seconds=seconds, launches=launches, launches_per_batch=per_batch,
                forward_ms_per_batch=fwd_ms, host=host, model_vs_cpu=stats), seen, \
        (config, ckpt, net)


def kept_rows(res, i):
    """Image i's kept rows [score, class, x1, y1, x2, y2], sorted by score,
    then class and box: the order of equal scores aside."""
    v = res.valid[i].cpu()
    rows = torch.cat([res.scores[i].cpu()[v, None].double(),
                      res.classes[i].cpu()[v, None].double(),
                      res.boxes_xyxy[i].cpu()[v].double()], dim=1).numpy()
    return rows[np.lexsort(tuple(rows[:, j] for j in range(5, 0, -1)) + (-rows[:, 0],))]


def serve_fast_phase(config, ckpt, img_dir):
    """ops.serve_decode.decode_and_postprocess on the card on one serve
    batch's raw fields (the deploy form, bf16) against the runner's decode
    and postprocess_detections at the runner's settings: the same kept rows
    in every image, up to the order of equal scores (FAST_LIMITS). The
    decode is the runner's own; what this holds is the heads' raw-field
    maps and their repacking per anchor on the card."""
    from vision_conglomerate_torch.data.inference import InferenceImgDataset
    from vision_conglomerate_torch.infer.runner import load_detection_model
    from vision_conglomerate_torch.ops.postprocess import postprocess_detections
    from vision_conglomerate_torch.ops.serve_decode import decode_and_postprocess

    img_wh = tuple(config["train_config"]["img_config"]["img_wh"])
    ds = InferenceImgDataset(img_dir, img_wh=img_wh)
    items = [ds[i] for i in range(BATCH)]
    og_hw = tuple(items[0][1].shape[:2])
    x = torch.from_numpy(np.stack([a for a, _ in items])).cuda().permute(0, 3, 1, 2)
    model, c = load_detection_model(ckpt, config["model_config"], device="cuda")
    kw = dict(iou_threshold=0.35, score_threshold=0.01, box_allowance=4.0, max_detections=300)

    @torch.no_grad()
    def fast():
        return decode_and_postprocess(model(x, raw_fields=True), tuple(x.shape[2:]), c,
                                      og_size=og_hw, **kw)

    @torch.no_grad()
    def runner():
        return postprocess_detections(model(x, inference=True, og_size=og_hw), c, **kw)

    got, want = fast(), runner()
    torch.cuda.synchronize()
    kept, tied, worst = [], [], {"scores": 0.0, "boxes": 0.0}
    for i in range(BATCH):
        g, w = kept_rows(got, i), kept_rows(want, i)
        kept.append(len(w))
        check(len(g) == len(w) > 0, f"serve-fast image {i}: {len(g)} kept rows, the runner's "
                                    f"{len(w)}")
        worst["scores"] = max(worst["scores"], float(np.abs(g[:, 0] - w[:, 0]).max()))
        # rows at the lowest kept score may differ where max_detections cuts
        # through equal scores, which the two candidate orders rank apart
        floor = min(g[:, 0].min(), w[:, 0].min()) + FAST_LIMITS["scores"]
        g, w = g[g[:, 0] > floor], w[w[:, 0] > floor]
        tied.append(kept[-1] - len(w))
        check(len(g) == len(w) and np.array_equal(g[:, 1], w[:, 1]),
              f"serve-fast image {i}: the rows above the lowest kept score differ in number or "
              f"class")
        if len(w):
            worst["boxes"] = max(worst["boxes"], float(np.abs(g[:, 2:] - w[:, 2:]).max()))
    print(f"serve-fast: decode_and_postprocess on the card vs the runner's decode + "
          f"postprocess, batch {BATCH}: kept rows {kept} on both ({tied} at the lowest kept "
          f"score, compared by count and score only); max |d| scores "
          f"{worst['scores']:.3g} (limit {FAST_LIMITS['scores']:g}), boxes {worst['boxes']:.3g} px "
          f"(limit {FAST_LIMITS['boxes']:g})")
    for key, lim in FAST_LIMITS.items():
        check(worst[key] <= lim, f"serve-fast {key} differ from the runner's by {worst[key]:.3g}")
    return dict(kept_rows=kept, tied_at_lowest=tied, max_abs_err=worst)


def alt_train_phase(root):
    """train_det.run (--map_eval, ALT_TRAIN_STEPS steps an epoch) on the
    resnet_basichead config over phase 5's synthetic data (its first 32
    train images): its artifacts,
    the saved config keeping the alternate keys; one step card vs CPU of
    both alternate nets (phase 6's TRAIN_LIMITS, shipped anchors); eval_det on
    the trained best_model/, card and CPU (eval_phase)."""
    import yaml

    base, config_path, anchors_path = write_train_data(root, ALT_TRAIN_STEPS * TRAIN_BATCH)
    configs = {}
    for name in ALT_NETS:
        configs[name] = alt_config(name)
        configs[name]["train_config"] = base["train_config"]
    config = configs["resnet_basichead"]
    with open(config_path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
    pipe, seconds, peak = run_train_cli(root, config, config_path, anchors_path)
    check_train_artifacts(root, pipe)
    with open(os.path.join(root, "saved_model/detection/best_model/config/config.yaml")) as f:
        saved = yaml.safe_load(f)["model_config"]
    for key in ("backbone", "head", "repbipan_config"):
        check(saved[key] == config["model_config"][key],
              f"resnet_basichead best_model/config/config.yaml {key}: {saved[key]!r}")
    print(f"resnet_basichead train: train_det.run, {TRAIN_EPOCHS} epochs of {ALT_TRAIN_STEPS} "
          f"steps at batch {TRAIN_BATCH}, 640x640, bf16: {seconds:.2f} s in all; peak memory "
          f"allocated {peak / 2 ** 30:.3f} GiB; losses "
          f"{[round(m['aggregate_loss'], 4) for m in pipe._train_metrics]}; the saved config "
          f"keeps backbone {saved['backbone']}, head {saved['head']}, upsample_mode "
          f"{saved['repbipan_config']['upsample_mode']}")
    del pipe
    anchors = shipped_anchors("detection")
    parity = {name: card_vs_cpu_step(cfg, anchors, label=f"{name} train")
              for name, cfg in configs.items()}
    evaluated = eval_phase(root, None)
    return dict(cli_seconds=seconds, peak_bytes=peak, card_vs_cpu=parity, eval=evaluated)


def _leaves(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield k, v


# ---------------------------------------------------------------------------
# Data parallelism (`--use_ddp`, parallel/mesh.py and parallel/serving.py):
# torchrun on the one card, NCCL, a world of one, through the same code as
# a world of many.

DDP_TRAIN = 2 * TRAIN_BATCH  # train images of the DDP phases: 2 steps an epoch
DDP_TIMED_STEPS = 10
# One bf16 step in a world of one against the plain step from one state
# (the loss relative, 1 - the lowest gradient cosine, max |d| of the
# BatchNorm statistics and of the parameters after the step), and the DDP
# serve against the plain serve (max |d| of the kept scores and boxes):
# 3x what this script read on an H100 (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md), all 0 but the cosine's f64 rounding, 2.2e-16: the all-reduce of
# one rank and the divide by 1 are exact, and this card repeated the plain
# step bit for bit. A step is also allowed 3x the plain step's own repeat
# in the run, in case a cuDNN backward does not repeat on another card.
DDP_STEP_LIMITS = {"loss_rel": 0.0, "one_minus_min_cos": 6.7e-16, "bn_stats": 0.0,
                   "params": 0.0}
DDP_SERVE_LIMITS = {"scores": 0.0, "boxes": 0.0}


def torchrun(root, module, argv, timeout=600):
    """`torchrun --standalone --nproc_per_node 1 -m
    vision_conglomerate_torch.<module> --use_ddp argv` in root on the card;
    returns its host seconds."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", f"vision_conglomerate_torch.{module}", "--use_ddp", *argv, "--device", "cuda"]
    env = {**os.environ, "PYTHONPATH": REPO}
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                          timeout=timeout)
    seconds = time.time() - t0
    check(proc.returncode == 0, f"torchrun {module} --use_ddp exited {proc.returncode}:\n"
                                f"{(proc.stdout + proc.stderr)[-4000:]}")
    return seconds


def check_ddp_artifacts(root, task, model, lr, loss_key):
    """What a torchrun --use_ddp train CLI must have written under root:
    TRAIN_EPOCHS rows of finite losses in both CSVs, best_model/ with its
    config, a snapshot an epoch whose optimizer runs at the config's lr
    times the world size (1)."""
    import pandas as pd
    from vision_conglomerate_torch.train.checkpoint import load_checkpoint

    for rel in (f"metrics/{task}/train_metrics.csv", f"metrics/{task}/eval_metrics.csv",
                f"saved_model/{task}/best_model/{model}.ckpt.tar",
                f"saved_model/{task}/best_model/config/config.yaml"):
        check(os.path.isfile(os.path.join(root, rel)), f"{task} --use_ddp artifact missing: {rel}")
    hist = {m: pd.read_csv(os.path.join(root, f"metrics/{task}/{m}_metrics.csv"))
            for m in ("train", "eval")}
    for mode, df in hist.items():
        check(len(df) == TRAIN_EPOCHS and bool(np.isfinite(df[loss_key]).all()),
              f"{task} --use_ddp {mode}_metrics.csv: {df.to_dict('list')}")
    snaps = sorted(os.path.join(r, f) for r, _, fs in os.walk(
        os.path.join(root, f"saved_model/{task}/checkpoints")) for f in fs
        if f.endswith(".ckpt.tar"))
    check(len(snaps) == TRAIN_EPOCHS, f"{task} --use_ddp snapshots: {snaps}")
    got = load_checkpoint(snaps[-1])["TORCH_OPTIMIZER_PARAMS"]["param_groups"][0]["lr"]
    check(abs(got - lr) <= 1e-12 * lr, f"{task} --use_ddp lr {got}, want {lr} x 1 rank")
    return {m: df[loss_key].tolist() for m, df in hist.items()}


def timed_steps(pipe, batch, n=DDP_TIMED_STEPS):
    """Mean ms of n synchronized train steps on one batch (host clock),
    after one untimed step."""
    pipe.train_step(*batch)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(n):
        pipe.train_step(*batch)
    torch.cuda.synchronize()
    return (time.time() - t0) / n * 1e3


def ddp_phase(root):
    """Phases 38-40: train_det --use_ddp through torchrun; one DDP step
    against the plain step, and their times; the DDP-trained best model
    served through both kernels; make_dp_serve against the plain serve."""
    from vision_conglomerate_torch.infer.runner import detect, load_detection_model
    from vision_conglomerate_torch.ops.postprocess import postprocess_detections
    from vision_conglomerate_torch.ops.preprocess import normalize_images
    from vision_conglomerate_torch.parallel import make_dp_serve, mesh
    from vision_conglomerate_torch.utils import load_yaml

    config, config_path, anchors_path = write_train_data(root, DDP_TRAIN)
    lr = float(config["train_config"]["optimizer_config"]["lr"])
    seconds = torchrun(root, "train_det", [
        "--config_path", config_path, "--anchors_path", anchors_path, "--batch_size",
        str(TRAIN_BATCH), "--epochs", str(TRAIN_EPOCHS), "--checkpoint_interval", "1",
        "--map_eval", "--no_verbose"])
    losses = check_ddp_artifacts(root, "detection", "DetectionNet", lr, "aggregate_loss")
    print(f"ddp: torchrun --nproc_per_node 1 train_det --use_ddp (NCCL, world 1), "
          f"{TRAIN_EPOCHS} epochs of {DDP_TRAIN // TRAIN_BATCH} steps at batch {TRAIN_BATCH}, "
          f"640x640, bf16, --map_eval: {seconds:.2f} s (host clock, process start included); "
          f"losses {losses}")

    # 38: one step in a world of one against the plain step, from one state
    anchors = shipped_anchors("detection")
    batch = train_batch(config, 2)

    def step():
        net = seeded_net(config, anchors, torch.bfloat16, "cuda")
        res = train_step_result(net, config, batch)
        return res, {n: p.detach().float().cpu() for n, p in net.named_parameters()}, net

    (plain, plain_p, net), (again, again_p, _) = step(), step()
    skip = no_grad_biases(net)
    names = [n for n in plain[1] if n not in skip]
    full = [torch.from_numpy(a).cuda() for a in train_batch(config, TRAIN_BATCH)]
    pipe = trainer(net, config)
    plain_ms = [timed_steps(pipe, full)]
    mesh.maybe_initialize_distributed("cuda")
    try:
        check(mesh.world_size() == 1, f"ddp: world size {mesh.world_size()}")
        ddp, ddp_p, _ = step()
        ddp_ms = [timed_steps(pipe, full), timed_steps(pipe, full)]
    finally:
        mesh.shutdown_distributed()
    plain_ms.append(timed_steps(pipe, full))
    del pipe, net, full
    out = {}
    for tag, (r, p) in (("ddp", (ddp, ddp_p)), ("repeat", (again, again_p))):
        cmp = compare_steps(r, plain, names)
        out[tag] = {k: cmp[k] for k in ("loss_rel", "one_minus_min_cos", "bn_stats")}
        out[tag]["params"] = max((p[n] - plain_p[n]).abs().max().item() for n in plain_p)
    print(f"ddp: one bf16 step on 2 images, 640x640: DDP (world 1) vs plain {out['ddp']}; "
          f"plain vs plain {out['repeat']}; limits {DDP_STEP_LIMITS} or 3x the repeat")
    for key, lim in DDP_STEP_LIMITS.items():
        v = out["ddp"][key]
        check(bool(np.isfinite(v)) and v <= max(lim, 3 * out["repeat"][key]),
              f"ddp: the DDP step differs from the plain step: {key} {v:.3e}")
    print(f"ddp: train step at batch {TRAIN_BATCH}, 640x640, bf16, one batch on the card: plain "
          f"{plain_ms[0]:.3f} / {plain_ms[1]:.3f} ms, DDP world 1 {ddp_ms[0]:.3f} / "
          f"{ddp_ms[1]:.3f} ms (plain, DDP, DDP, plain; {DDP_TIMED_STEPS} steps each, host "
          f"clock, synchronized)")

    # 39: the DDP-trained best model served through both kernels
    launches = serve_trained(root, config, label="ddp")

    # 40: make_dp_serve in a world of one against the plain serve
    best = os.path.join(root, "saved_model/detection/best_model")
    model_config = load_yaml(os.path.join(best, "config", "config.yaml"))["model_config"]
    model, num_classes = load_detection_model(os.path.join(best, "DetectionNet.ckpt.tar"),
                                              model_config, device="cuda")
    imgs = normalize_images(torch.from_numpy(train_batch(config, BATCH)[0]).cuda())

    def serve_fn(x):
        return postprocess_detections(detect(model, x, (640, 640)), num_classes,
                                      iou_threshold=0.35, score_threshold=0.01,
                                      max_detections=300)

    plain_out = serve_fn(imgs)
    mesh.maybe_initialize_distributed("cuda")
    try:
        zero_counters()
        dp_out = make_dp_serve(serve_fn)(imgs)
        torch.cuda.synchronize()
        dp_launches = read_counters()
    finally:
        mesh.shutdown_distributed()
    check(all(n > 0 for n in dp_launches.values()),
          f"make_dp_serve: a kernel never launched: {dp_launches}")
    check(torch.equal(dp_out.valid, plain_out.valid) and torch.equal(
        dp_out.classes[dp_out.valid], plain_out.classes[plain_out.valid]),
        "make_dp_serve: kept rows or classes differ from the plain serve")
    serve_err = {"scores": (dp_out.scores - plain_out.scores).abs().max().item(),
                 "boxes": (dp_out.boxes_xyxy - plain_out.boxes_xyxy).abs().max().item()}
    print(f"ddp: make_dp_serve (world 1) vs the plain serve of the DDP-trained deploy-form "
          f"net, batch {BATCH}: {int(plain_out.valid.sum())} kept rows on both, max |d| "
          f"{serve_err} (limits {DDP_SERVE_LIMITS}); launches {dp_launches}")
    for key, lim in DDP_SERVE_LIMITS.items():
        check(serve_err[key] <= lim, f"make_dp_serve {key} differ by {serve_err[key]:.3g}")
    return dict(cli_seconds=seconds, losses=losses, step_vs_plain=out,
                plain_step_ms=plain_ms, ddp_step_ms=ddp_ms, served_launches=launches,
                dp_serve_launches=dp_launches, dp_serve_err=serve_err)


def tn_ddp_phase(root):
    """Phase 41: train_tracknet's main with --use_ddp in this process (a
    world of one on a free local port, NCCL; phase 38 runs torchrun) at the
    shipped config, batch 16, 2 epochs: finite losses, the artifacts, the
    lr times the world size."""
    from vision_conglomerate_torch import train_tracknet
    from vision_conglomerate_torch.parallel import mesh

    config, config_path = write_tn_train_data(root)
    lr = float(config["train_config"]["optimizer_config"]["lr"])
    cwd = os.getcwd()
    os.chdir(root)
    t0 = time.time()
    try:
        train_tracknet.main(["--use_ddp", "--config_path", config_path, "--batch_size",
                             str(TRAIN_BATCH), "--epochs", str(TRAIN_EPOCHS),
                             "--checkpoint_interval", "1", "--no_verbose", "--device", "cuda"])
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    check(not mesh.is_distributed(), "tracknet ddp: the process group outlived main")
    losses = check_ddp_artifacts(root, "tracknet", "TrackNet", lr, "loss")
    print(f"tracknet ddp: train_tracknet --use_ddp (NCCL, world 1, in this process), "
          f"{TRAIN_EPOCHS} epochs at batch {TRAIN_BATCH}, 640x352, bf16: {seconds:.2f} s (host "
          f"clock); losses {losses}")
    return dict(cli_seconds=seconds, losses=losses)

def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="write torch.profiler tables of 3 serve forwards (bf16 and int8) "
                             "and 3 train steps")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs on the GPU only")
    if not os.path.isdir(os.path.join(REPO, "vision_conglomerate_torch", "csrc")):
        fail("run from a checkout of the repository (vision_conglomerate_torch/ not found)")
    sys.path.insert(0, REPO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    build_kernels()
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as root, phase_clock("serve, video, seg serve (1-4, 11-12)"):
        config, ckpt, img_dirs, net = make_inputs(root)
        zero_counters()
        seconds, served = serve(config, ckpt, img_dirs[N_IMAGES], os.path.join(root, "out"))
        launches = read_counters()
        print(f"serve: {N_IMAGES} images 1280x720 at batch {BATCH} through "
              f"run_detection_inference in {seconds:.2f} s = {N_IMAGES / seconds:.2f} images/s "
              f"(smoke figure: the first call in the process, with model load and first-batch "
              f"set-up); launches {launches}")
        for route, n in launches.items():
            check(n > 0, f"the {route} kernel never launched on the main path")
        files = sorted(os.listdir(served))
        check("output.csv" in files and sum(f.endswith(".png") for f in files) == N_IMAGES,
              f"serve outputs missing: {files}")
        t_few, _ = serve(config, ckpt, img_dirs[N_IMAGES], os.path.join(root, "warm_few"))
        t_many, _ = serve(config, ckpt, img_dirs[WARM_IMAGES], os.path.join(root, "warm_many"))
        warm = (WARM_IMAGES - N_IMAGES) / (t_many - t_few)
        print(f"serve: warm end to end {warm:.3f} images/s = {WARM_IMAGES - N_IMAGES} images / "
              f"({t_many:.3f} s for {WARM_IMAGES} - {t_few:.3f} s for {N_IMAGES}); decode, "
              f"resize, forward, NMS, drawing, PNG encode, CSV (host clock)")
        seen, model_stats, fwd_ms, host, (_, forward) = compare_models(
            config, ckpt, img_dirs[N_IMAGES])
        if args.profile:
            profile_forward(forward, fwd_ms, os.path.join(out_dir, "serve_profile.txt"))
        clips, samples = write_clips(root)
        video = video_phase(root, config, net, clips, samples)
        seg_serve, seg_seen, seg = seg_serve_phase(root, img_dirs)
        seg_video = seg_video_phase(root, clips[VIDEO_FRAMES], samples, seg)
        with phase_clock("int8 serve (23-24; within the phases above)"):
            int8_serve, int8_seen = int8_serve_phase(
                root, config, ckpt, img_dirs, fwd_ms, profile_path=os.path.join(
                    out_dir, "int8_serve_profile.txt") if args.profile else None)
            int8_seg_serve, int8_seg_seen = int8_serve_phase(
                root, seg[0], seg[1], img_dirs, seg_serve["forward_ms_per_batch"], "segmentation")
        with phase_clock("kp serve, kp video, int8 kp serve (28, 31, 32; within the phases "
                         "above)"):
            kp_serve, kp_seen, kp = kp_serve_phase(root, img_dirs, fwd_ms)
            kp_video = kp_video_phase(root, clips[VIDEO_FRAMES], samples, kp)
            kp_int8_serve, kp_int8_seen = int8_serve_phase(
                root, kp[0], kp[1], img_dirs, kp_serve["forward_ms_per_batch"])
        with phase_clock("alternates serve, serve-fast decode, int8 (33, 34, 36; within the "
                         "phases above)"):
            alt_serve, alt_seen, alt = alt_serve_phase(root, img_dirs, "resnet_basichead", fwd_ms)
            serve_fast = serve_fast_phase(alt[0], alt[1], img_dirs[N_IMAGES])
            s2d_serve, s2d_seen, s2d = alt_serve_phase(root, img_dirs, "csp_s2d", fwd_ms)
            alt_int8, alt_int8_seen = int8_serve_phase(
                root, alt[0], alt[1], img_dirs, alt_serve["forward_ms_per_batch"],
                label="resnet_basichead int8 serve", limits=ALT_INT8_LIMITS["resnet_basichead"],
                measure_warm=False)
            s2d_int8, s2d_int8_seen = int8_serve_phase(
                root, s2d[0], s2d[1], img_dirs, s2d_serve["forward_ms_per_batch"],
                label="csp_s2d int8 serve", limits=ALT_INT8_LIMITS["csp_s2d"], measure_warm=False)
    n_batches = -(-N_IMAGES // BATCH)
    for route, n in launches.items():
        per_batch = sum(1 for s in seen if s[0] == route)
        check(n == n_batches * per_batch,
              f"{route}: {n} launches in {n_batches} batches, the forward routes {per_batch}")
    with tempfile.TemporaryDirectory() as root, phase_clock("train (5-10)"):
        train = train_phase(root, out_dir, args.profile)
    with tempfile.TemporaryDirectory() as root, phase_clock("seg train (13-15)"):
        seg_train = seg_train_phase(root)
    with tempfile.TemporaryDirectory() as root, phase_clock("tracknet serve (16)"):
        tn_serve_res, tn_seen, tn_extra = tn_serve_phase(root)
    with tempfile.TemporaryDirectory() as root, phase_clock("tracknet train (17-19)"):
        tn_train = tn_train_phase(root, out_dir, args.profile)
    with tempfile.TemporaryDirectory() as root, phase_clock("tracknet adv serve (20)"):
        tn_adv_serve, tn_adv_seen, tn_adv_extra = tn_serve_phase(root, TN_ADV)
    with tempfile.TemporaryDirectory() as root, phase_clock("tracknet adv train (21-22)"):
        tn_adv_train = tn_train_phase(root, out_dir, args.profile, TN_ADV)
    with tempfile.TemporaryDirectory() as root, phase_clock("kp train, kp eval (29-30, 32)"):
        kp_train = kp_train_phase(root)
    with tempfile.TemporaryDirectory() as root, phase_clock("alternates train, eval (35, 37)"):
        alt_train = alt_train_phase(root)
    with tempfile.TemporaryDirectory() as root, phase_clock("ddp train, step, serve (38-40)"):
        ddp = ddp_phase(root)
    with tempfile.TemporaryDirectory() as root, phase_clock("tracknet ddp (41)"):
        tn_ddp = tn_ddp_phase(root)
    with phase_clock("kernels (3)"):
        rows, summary = kernel_phase({
            "serve": (seen, launches), "seg_serve": (seg_seen, seg_serve["launches"]),
            "tracknet_serve": (tn_seen, tn_serve_res["launches"]),
            "tracknet_adv_serve": (tn_adv_seen, tn_adv_serve["launches"]),
            "kp_serve": (kp_seen, kp_serve["launches"]),
            "alt_serve": (alt_seen, alt_serve["launches"]),
            "s2d_serve": (s2d_seen, s2d_serve["launches"])},
            {**tn_extra, **tn_adv_extra})
        big = big_conv_case(torch.Generator(device="cuda").manual_seed(SEED))
    with phase_clock("s8 kernels (27)"):
        tn_int8, tn_adv_int8 = tn_serve_res["int8"], tn_adv_serve["int8"]

        def s8_launches(res):
            return {r: n for r, n in res["launches"].items() if r in S8_KERNELS and n}

        s8_rows, s8_summary = kernel_phase({
            "int8_serve": (int8_seen, s8_launches(int8_serve)),
            "int8_seg_serve": (int8_seg_seen, s8_launches(int8_seg_serve)),
            "tracknet_int8_serve": (tn_int8.pop("one_batch"), s8_launches(tn_int8)),
            "tracknet_adv_int8_serve": (tn_adv_int8.pop("one_batch"), s8_launches(tn_adv_int8)),
            "kp_int8_serve": (kp_int8_seen, s8_launches(kp_int8_serve)),
            "alt_int8_serve": (alt_int8_seen, s8_launches(alt_int8)),
            "s2d_int8_serve": (s2d_int8_seen, s8_launches(s2d_int8))},
            {**tn_int8.pop("extra"), **tn_adv_int8.pop("extra")}, S8_KERNELS, run_s8_case,
            S8_RAGGED, main="int8_serve")
    summary += s8_summary
    for entry in summary:
        if entry["name"] == "conv3x3_bias_act":
            entry.update({f"tracknet_dec13_b{TN_BIG_BATCH}_{k}": big[k]
                          for k in ("ms", "library_ms", "bound_ms", "max_abs_err")})
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, launches=launches, train=train, serve_seconds=seconds,
                       images=N_IMAGES, batch=BATCH, warm_images_per_s=warm,
                       warm_seconds={N_IMAGES: t_few, WARM_IMAGES: t_many},
                       forward_ms_per_batch=fwd_ms, host=host, video=video,
                       model_vs_cpu=model_stats, seg_serve=seg_serve, seg_video=seg_video,
                       seg_train=seg_train, tracknet_serve=tn_serve_res,
                       tracknet_train=tn_train, tracknet_adv_serve=tn_adv_serve,
                       tracknet_adv_train=tn_adv_train, tracknet_dec13_big=big, cases=rows,
                       int8_serve=int8_serve, int8_seg_serve=int8_seg_serve, s8_cases=s8_rows,
                       kp_serve=kp_serve, kp_video=kp_video, kp_int8_serve=kp_int8_serve,
                       kp_train=kp_train, alt_serve=alt_serve, s2d_serve=s2d_serve,
                       serve_fast=serve_fast, alt_int8_serve=alt_int8, s2d_int8_serve=s2d_int8,
                       alt_train=alt_train, ddp=ddp, tracknet_ddp=tn_ddp, kernels=summary),
                  f, indent=1,
                  default=str)
    print(json.dumps({"kernels": summary}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
