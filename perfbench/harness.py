"""The benchmark's entry point: finds a cell by name, runs its kind, checks what
the timed path produced, and prints the one result line.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. A cell is an entry of ``BENCHMARK.json``'s ``workloads``;
its configuration is ``perfbench/configs/<config>.json``, its traffic
``perfbench/traffic/<traffic>.json`` (whose ``kind`` names the module of
``perfbench/kinds`` that runs it), its limits
``perfbench/workloads/<cell>.json``, and each per-layer metric
``perfbench/metrics/<metric>.py`` (a ``read(trace)`` that returns a number,
or None where it finds nothing to read). Adding a cell, a traffic mix or a
metric adds files and entries; no file here changes."""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "pose3d_tpu")


def process_age() -> float:
    """Seconds since this process started (the kernel's own clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: Optional[dict] = None) -> dict:
    """Everything a run of cell ``name`` reads: the entry, its
    configuration, traffic and limits, and the metrics it reports."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = load_json(BENCH / "configs" / f"{entry['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(BENCH / "workloads" / f"{name}.json")["limits"]

    def mine(metric):
        return name in metric.get("workloads", [name])
    return {
        "name": name, "entry": entry, "config": cfg, "traffic": traffic,
        "limits": limits,
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def metric_reader(name: str):
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (names compared whole: ``pose3d_tpu_torch`` is not
    ``pose3d_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def checks_of(result: dict, limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit (a reading at or under its
    limit passes; a missing or non-finite one fails)."""
    out = {}
    for name, limit in limits.items():
        value = result["readings"].get(name)
        if value is not None and not math.isfinite(value):
            value = None
        out[name] = {"value": value, "limit": limit}
    return out


def passed(checks: Dict[str, dict]) -> bool:
    ok = True
    for c in checks.values():
        v = c["value"]
        ok &= v is not None and v <= c["limit"]
    return ok


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """Run one cell and return the result object (without printing)."""
    kind = importlib.import_module(f"perfbench.kinds.{spec['traffic']['kind']}")
    run = kind.run(spec, seed=seed, seconds=seconds, trace=trace,
                   device=device)
    checks = checks_of(run, spec["limits"])
    out = {
        "correct": passed(checks) and run["failed"] == 0,
        "attempted": run["attempted"],
        "failed": run["failed"],
        "metrics": {},
        "device": run["device"],
    }
    if trace:
        for m in spec["per_layer"]:
            value = metric_reader(m["name"])(run["trace"])
            if value is not None:
                out["metrics"][m["name"]] = {"value": value,
                                             "unit": m["unit"]}
        out["breakdown"] = run["trace"]["breakdown"]
    else:
        for m in spec["end_to_end"]:
            if m["name"] in run["end_to_end"]:
                out["metrics"][m["name"]] = {
                    "value": run["end_to_end"][m["name"]], "unit": m["unit"]}
    out["checks"] = checks
    out["_notes"] = run.get("notes", [])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell(args.workload)

    import torch

    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for note in out.pop("_notes"):
        print(note, file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
