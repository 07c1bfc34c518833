"""YAML config IO (the schema of configs/<task>/{config,anchors}.yaml is the
public API of both packages)."""
from typing import Any, Dict

import yaml


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return yaml.safe_load(f)


def save_yaml(obj: Dict[str, Any], path: str, **kwargs):
    with open(path, "w") as f:
        yaml.safe_dump(obj, f, **kwargs)
