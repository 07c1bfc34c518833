from .detection_loss import DetectionLossConfig, detection_loss  # noqa: F401
from .segmentation_loss import SegmentationLossConfig, segmentation_loss  # noqa: F401
