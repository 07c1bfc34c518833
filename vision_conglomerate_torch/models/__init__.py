from .detection import DetectionNet  # noqa: F401
