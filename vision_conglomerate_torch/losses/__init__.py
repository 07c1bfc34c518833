from .detection_loss import DetectionLossConfig, detection_loss  # noqa: F401
