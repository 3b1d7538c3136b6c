"""The readings a cell's limits are set from, at the cell's own size on
the card, in one process: sound runs of the program on each seed of
``--seeds`` (its lower reading), and the control and the planted faults on
each seed of ``--control`` (its upper readings). The cell's kind
(``perfbench/kinds/<kind>.py``) says what they are, in its ``calibrate``.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        --control 1 2 3 [--look]

Prints one JSON line per reading and a summary line. ``--look`` adds to
each sound run why its worst leaves read what they do."""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.pycache_prefix = str(ROOT / "build" / "pycache")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda-cache")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--look", action="store_true")
    args = ap.parse_args()

    import importlib

    import torch

    from perfbench.harness import cell

    spec = cell(args.workload)
    dev = torch.device("cuda")
    kind = importlib.import_module(
        f"perfbench.kinds.{spec['traffic']['kind']}")
    rows = kind.calibrate(spec, args.seeds, args.control, dev, args.look)
    summary = {}
    for row in rows:
        print(json.dumps(row), flush=True)
        for k, v in row.items():
            if k not in ("seed", "what") and isinstance(v, float):
                summary.setdefault(f"{row['what']}.{k}", []).append(v)
    print(json.dumps({"summary": {k: [min(v), max(v)]
                                  for k, v in summary.items()},
                      "card": torch.cuda.get_device_name(dev)}), flush=True)


if __name__ == "__main__":
    main()
