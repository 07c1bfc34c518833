from .yaml_io import load_yaml, save_yaml  # noqa: F401
