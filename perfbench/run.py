"""Run one benchmark cell of the PyTorch/CUDA port on this machine's card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Every cache a run fills lives at a fixed path under the checkout's
``build/``: Python's bytecode (written even where the environment sets
``PYTHONDONTWRITEBYTECODE``), the port's CUDA kernels
(``build/pose3d_tpu_torch``), CUDA's JIT cache, and Triton's and PyTorch's
extension caches should anything use them. Only a cell's first run in a
checkout compiles."""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
sys.pycache_prefix = str(BUILD / "pycache")
sys.dont_write_bytecode = False   # kept even under PYTHONDONTWRITEBYTECODE
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton-cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch-extensions")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda-cache")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
