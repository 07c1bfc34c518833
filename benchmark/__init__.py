"""The benchmark of the PyTorch and CUDA port, `vision_conglomerate_torch`
(README.md)."""
