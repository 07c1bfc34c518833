"""Run one cell of the port's benchmark once (harness/main.py):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The process's build and kernel caches are kept in fixed directories of
the checkout before anything imports torch: Triton's and Inductor's under
benchmark/_cache/, the port's nvcc libraries in
vision_conglomerate_torch/_build/ (the port's own fixed place). The
process runs one intra-op thread: its host work is launching kernels."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", "_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["OMP_NUM_THREADS"] = "1"  # one process, few threads: the host work is dispatch
sys.path.insert(0, ROOT)

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
