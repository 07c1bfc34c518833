"""SegmentationNet: DetectionNet with the YOLACT-style prototype branch, the
JAX package's models/segmentation.py in PyTorch.

The proto module runs on the neck's stride-8 map (n3) and upsamples x2, so
the protos come out at stride 4. forward returns (preds, protos). The
protos are NCHW (B, K, H/4, W/4) in the port, where the JAX package gives
NHWC (B, H/4, W/4, K); mask assembly contracts over K either way.
"""
from .detection import DetectionNet


class SegmentationNet(DetectionNet):
    with_proto_seg = True
