from .detection import DetectionNet  # noqa: F401
from .segmentation import SegmentationNet  # noqa: F401
from .tracknet import TrackNet  # noqa: F401
