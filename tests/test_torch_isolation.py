"""The PyTorch port imports neither jax nor the JAX package.

A fresh interpreter imports every module of `vision_conglomerate_torch`,
its CLI and chip_smoke.py, and must end with no `jax`, `flax` or
`vision_conglomerate_tpu` module loaded. The sources are also checked for
such imports, which a lazy import inside a function would hide from the
first check.
"""
import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "vision_conglomerate_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vision_conglomerate_tpu")

_PROBE = """
import importlib, pkgutil, sys
import vision_conglomerate_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names + ["vision_conglomerate_torch.inference_det", "vision_conglomerate_torch.eval_det",
                     "vision_conglomerate_torch.train_det", "vision_conglomerate_torch.inference_seg",
                     "vision_conglomerate_torch.eval_seg", "vision_conglomerate_torch.train_seg",
                     "vision_conglomerate_torch.models.segmentation",
                     "vision_conglomerate_torch.losses.segmentation_loss",
                     "vision_conglomerate_torch.data.segmentation",
                     "vision_conglomerate_torch.train.segmentation_trainer",
                     "vision_conglomerate_torch.ops.masks",
                     "vision_conglomerate_torch.train_tracknet",
                     "vision_conglomerate_torch.eval_tracknet",
                     "vision_conglomerate_torch.inference_tracknet",
                     "vision_conglomerate_torch.models.tracknet",
                     "vision_conglomerate_torch.ops.heatmap",
                     "vision_conglomerate_torch.data.tracknet",
                     "vision_conglomerate_torch.train.tracknet_trainer",
                     "vision_conglomerate_torch.infer.tracknet_runner", "chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20, proc.stdout


def test_port_sources_name_no_jax():
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"
