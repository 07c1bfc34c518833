"""Nothing the benchmark runs imports JAX or the JAX package, each module
compared by its whole top-level name; the reference imports nothing of
the port."""
import ast
import os
import subprocess
import sys

from benchmark.harness import guard
from benchmark.harness.spec import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _files(sub=""):
    for d, _, names in os.walk(os.path.join(BENCH, sub)):
        yield from (os.path.join(d, n) for n in names if n.endswith(".py"))


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _files():
        for name in _imports(path):
            assert name.split(".")[0] not in guard.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_port():
    for path in _files("reference"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("vision_conglomerate_torch",) + guard.FORBIDDEN
            assert not name.startswith("benchmark.harness"), (path, name)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    fake = dict(sys.modules)
    for name in ("vision_conglomerate_torch.models", "vision_conglomerate_tpux", "jaxtyping",
                 "flaxen"):
        fake[name] = object()
    monkeypatch.setattr(sys, "modules", fake)
    assert guard.forbidden_modules() == []
    fake["jax.numpy"] = object()
    fake["vision_conglomerate_tpu.ops"] = object()
    assert guard.forbidden_modules() == ["jax", "vision_conglomerate_tpu"]


def test_a_run_loads_no_jax():
    """Importing the harness, every task and the port's timed-path modules
    loads none of them."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.harness.main, benchmark.harness.tasks.tracknet\n"
            "import benchmark.calibrate\n"
            "import vision_conglomerate_torch.infer.tracknet_runner\n"
            "import vision_conglomerate_torch.infer.runner\n"
            "import vision_conglomerate_torch.train.tracknet_trainer\n"
            "from benchmark.harness import guard; print(guard.forbidden_modules())") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
