"""Split the start-up of one process of the PyTorch/CUDA port on the card
into its parts: where the seconds go between ``python -m
pose3d_tpu_torch.cli.<tool>`` and its first step.

Each run starts fresh interpreters (the package of ``--root`` on their
path, the default this checkout) and reads, on the host's clock:
  * ``python -c pass``, ``python -c "import torch"``, ``python -m
    pose3d_tpu_torch.cli.main --help`` and ``python -X importtime -c
    "import pose3d_tpu_torch.cli.main"`` whole (the import's heaviest
    top-level packages, cumulative, from its report);
  * one process that takes the steps a CLI meets, in order, each timed
    alone: ``import torch``; the rest of the CLI's imports; the CUDA
    context (``torch.cuda.init`` and a first allocation); each kernel
    library's load (``load_library``) and its launch plan read back from
    the built library (``library_config`` at the lifter's shape, where the
    module has one); the native decoder's build attempt
    (``data.native.get_lib``: ``g++`` on the checkout's ``native/*.cc``
    when no library of the same sources exists); ``import cv2``; the first
    cuBLAS product and the first cuDNN convolution (bf16, synchronised);
    and the processes it started (``g++``, ``nvcc``) as a child watcher
    counts them;
  * ``cli.main`` training the CNN for one step at batch 2 from the
    committed fixture (``tests/torch_port_fixtures``): a whole CLI process.

The kernels are built first, in this process, so that no child builds
one. The first run finds the host's file cache colder than the later
ones. Prints a line a run and a JSON line of the medians (with the card's
name and power limit); ``--json FILE`` writes every run. Needs one CUDA
card:

    python scripts/torch_startup_split.py [--runs 3] [--root DIR]
        [--keep-bytecode] [--profile TOP] [--json FILE]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
IMPORT_TORCH = "python -c 'import torch'"

# each kernel: its wrapper module, and the plan read back from its built
# library at the lifter's shape (function and arguments), where it has one
KERNEL_PLANS = {
    "flash_attention_fwd": ("flash_attention", "library_config",
                            (8, 1025, 1025, 12, 64, 64, 2)),
    "flash_attention_bwd": ("flash_attention", None, ()),  # read above
    "bn_stats": ("bn_stats", "library_config", (625000, 64, 2, True)),
    "lane_resample": ("lane_resample", None, ()),
    "layer_norm_fwd": ("layer_norm", "fwd_library_config",
                       (8200, 768, 2, True)),
    "layer_norm_bwd": ("layer_norm", "library_config", (8200, 768, 2, True)),
    "mlp_block_fwd": ("mlp_block", "library_config", (8200, 768, 3072, 2)),
    "mlp_block_bwd": ("mlp_block", None, ()),    # read with the forward
}


def _child() -> None:
    steps = {}
    t_all = time.perf_counter()

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        steps[name] = time.perf_counter() - t0
        return out

    torch = step("import torch", lambda: __import__("torch"))
    step("import pose3d_tpu_torch.cli.main (the rest)",
         lambda: __import__("pose3d_tpu_torch.cli.main"))

    def context():
        torch.cuda.init()
        torch.empty(1, device="cuda")
        torch.cuda.synchronize()
    step("CUDA context", context)

    import importlib

    for name, (mod_name, plan, shape) in KERNEL_PLANS.items():
        mod = importlib.import_module(
            f"pose3d_tpu_torch.ops.kernels.{mod_name}")
        step(f"kernel {name} load",
             lambda: mod.load_library(name)
             if mod_name in ("flash_attention", "layer_norm", "mlp_block")
             else mod.load_library())
        if plan is not None:
            step(f"kernel {name} {plan}",
                 lambda: getattr(mod, plan)(*shape))

    from pose3d_tpu_torch.data import native

    step("native decoder build attempt", native.get_lib)
    native_error = native.build_error()
    step("import cv2", lambda: __import__("cv2"))

    def cublas():
        a = torch.randn(512, 512, device="cuda", dtype=torch.bfloat16)
        (a @ a).sum().item()
    step("first cuBLAS product", cublas)

    def cudnn():
        x = torch.randn(1, 3, 64, 64, device="cuda", dtype=torch.bfloat16)
        w = torch.randn(8, 3, 3, 3, device="cuda", dtype=torch.bfloat16)
        torch.nn.functional.conv2d(x, w, padding=1).sum().item()
    step("first cuDNN convolution", cudnn)
    print(json.dumps({"steps": steps,
                      "in_process": time.perf_counter() - t_all,
                      "native_error": (native_error or "")[:300]}))


def _children_named(pid: int, names: tuple) -> set:
    """Descendants of ``pid`` whose command is one of ``names`` (read from
    /proc; empty where /proc is missing)."""
    found = set()
    try:
        entries = os.listdir("/proc")
    except OSError:
        return found
    parents = {}
    for e in entries:
        if not e.isdigit():
            continue
        try:
            stat = Path(f"/proc/{e}/stat").read_text()
            comm = stat[stat.index("(") + 1:stat.rindex(")")]
            ppid = int(stat[stat.rindex(")") + 2:].split()[1])
        except (OSError, ValueError):
            continue
        parents[int(e)] = (ppid, comm)
    for p, (ppid, comm) in parents.items():
        q, seen = ppid, 0
        while q and q != pid and seen < 64:
            q = parents.get(q, (0, ""))[0]
            seen += 1
        if q == pid and any(comm.startswith(n) for n in names):
            found.add((p, comm))
    return found


def _run(argv, root: Path, keep: bool, cwd: Path = None, watch=()) -> tuple:
    """(seconds, stdout, stderr, processes named in ``watch`` it started);
    ``keep``: the bytecode kept under ROOT/build/pycache."""
    env = {**os.environ, "PYTHONPATH": str(root)}
    if keep:
        # as chip_smoke.py's processes: the bytecode kept under build/
        env["PYTHONPYCACHEPREFIX"] = str(root / "build" / "pycache")
        env.pop("PYTHONDONTWRITEBYTECODE", None)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, *argv], cwd=cwd or root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    seen = set()
    if watch:
        while proc.poll() is None:
            seen |= _children_named(proc.pid, watch)
            time.sleep(0.05)
    out, err = proc.communicate()
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"{' '.join(argv[:4])} exited {proc.returncode}:\n"
                         f"{err[-3000:]}")
    return dt, out, err, sorted(c for _, c in seen)


def _importtime(err: str, top: int = 8) -> dict:
    """A ``-X importtime`` report summed by top-level package: each
    package's cumulative seconds where another package (or the statement)
    imported it, its heaviest ``top``, and the whole import."""
    rows = []
    for line in err.splitlines():
        m = re.match(r"import time:\s+\d+ \|\s+(\d+) \|( *)(\S+)", line)
        if m:
            rows.append((len(m.group(2)), m.group(3).split(".")[0],
                         int(m.group(1)) / 1e6))
    cum, total, stack = {}, 0.0, []
    # children come before their parent: read parents first
    for indent, pkg, sec in reversed(rows):
        while stack and stack[-1][0] >= indent:
            stack.pop()
        if not stack:
            total += sec
        if not stack or stack[-1][1] != pkg:
            cum[pkg] = cum.get(pkg, 0.0) + sec
        stack.append((indent, pkg))
    heavy = dict(sorted(cum.items(), key=lambda kv: -kv[1])[:top])
    return {"total": total, "top": heavy}


def _self_heaviest(err: str, top: int) -> dict:
    """The ``top`` modules of a ``-X importtime`` report by their own
    seconds (their imports excluded)."""
    own = {}
    for line in err.splitlines():
        m = re.match(r"import time:\s+(\d+) \|\s+\d+ \| *(\S+)", line)
        if m:
            own[m.group(2)] = own.get(m.group(2), 0) + int(m.group(1)) / 1e6
    return dict(sorted(own.items(), key=lambda kv: -kv[1])[:top])


CLI_STEP = ["-m", "pose3d_tpu_torch.cli.main", "--chunks-dir",
            str(REPO / "tests" / "torch_port_fixtures"), "--model-type", "cnn",
            "--batch-size", "2", "--grad-accum", "1", "--num-steps", "1",
            "--eval-interval", "1000", "--no-tensorboard", "--log-interval",
            "1", "--pixel-dtype", "uint8"]


def profile_cli(root: Path, top: int, keep: bool) -> None:
    """One ``cli.main`` step under ``cProfile`` (its overhead included):
    the functions with the most cumulative seconds, the heaviest modules
    of ``import torch`` by their own seconds, and the CLI's log lines at
    their seconds from the process's start."""
    import pstats

    _, _, err, _ = _run(["-X", "importtime", "-c", "import torch"], root,
                        keep)
    print(f"[startup] import torch, heaviest modules by own seconds: "
          f"{ {k: round(v, 3) for k, v in _self_heaviest(err, top).items()} }",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="startup_profile_") as tmp:
        prof = Path(tmp) / "cli.prof"
        t0 = time.time()
        dt, _, err, _ = _run(["-m", "cProfile", "-o", str(prof), *CLI_STEP,
                              "--cache-dir", str(Path(tmp) / "cache")],
                             root, keep, cwd=Path(tmp))
        print(f"[startup] cli.main 1 step under cProfile: {dt:.2f} s",
              flush=True)
        for line in err.splitlines():
            m = re.match(r"(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3})", line)
            if m:
                at = time.mktime(time.strptime(m.group(1),
                                               "%Y-%m-%d %H:%M:%S"))
                at += int(m.group(2)) / 1e3 - t0
                print(f"[startup]   +{at:6.2f} s {line[24:160]}", flush=True)
        for order in ("cumulative", "tottime"):
            out = io.StringIO()
            pstats.Stats(str(prof), stream=out).sort_stats(
                order).print_stats(top)
            print(out.getvalue(), flush=True)


def one_run(root: Path, keep: bool) -> dict:
    r = {}
    r["python -c pass"] = _run(["-c", "pass"], root, keep)[0]
    r[IMPORT_TORCH] = _run(["-c", "import torch"], root, keep)[0]
    dt, _, _, procs = _run(["-m", "pose3d_tpu_torch.cli.main", "--help"],
                           root, keep, watch=("g++", "cc1plus", "nvcc"))
    r["cli.main --help"] = dt
    r["cli.main --help started"] = procs
    dt, _, err, _ = _run(["-X", "importtime", "-c",
                          "import pose3d_tpu_torch.cli.main"], root, keep)
    r["-X importtime cli.main"] = {"wall": dt, **_importtime(err)}
    dt, out, _, procs = _run([str(Path(__file__).resolve()), "--child"],
                             root, keep, watch=("g++", "cc1plus", "nvcc"))
    r["split"] = {"wall": dt, "started": procs,
                  **json.loads(out.strip().splitlines()[-1])}
    with tempfile.TemporaryDirectory(prefix="startup_split_") as tmp:
        dt, _, _, procs = _run(
            [*CLI_STEP, "--cache-dir", str(Path(tmp) / "cache")], root,
            keep, cwd=Path(tmp), watch=("g++", "cc1plus", "nvcc"))
    r["cli.main cnn 1 step at batch 2 (fixture)"] = {"wall": dt,
                                                     "started": procs}
    return r


def _median(runs, get):
    return statistics.median(get(r) for r in runs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--root", type=Path, default=REPO,
                    help="the checkout whose package the children import")
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--profile", type=int, default=0, metavar="TOP",
                    help="then one cli.main step under cProfile: its TOP "
                    "functions by cumulative time, its log lines' times and "
                    "import torch's TOP heaviest modules")
    ap.add_argument("--keep-bytecode", action="store_true",
                    help="the children keep the bytecode they compile under "
                    "ROOT/build/pycache, as chip_smoke.py's processes do "
                    "(the first run writes it, the later ones read it)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child()
        return 0

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch_startup_split: CUDA is not available (the "
                           "split is of a process on the card)")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from pose3d_tpu_torch.ops.kernels import _build, wrappers

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kept = root / "build" / "pycache" if args.keep_bytecode else "none"
    src = Path(torch.__file__).parent
    print(f"[startup] {root}: PYTHONDONTWRITEBYTECODE "
          f"{os.environ.get('PYTHONDONTWRITEBYTECODE')!r}, bytecode kept "
          f"under {kept}; torch's sources in {src} (writable: "
          f"{os.access(src, os.W_OK)}, __pycache__ "
          f"{(src / '__pycache__').is_dir()})", flush=True)
    t0 = time.perf_counter()
    names = [fn.__name__ for fn in wrappers()]
    with ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(_build.load, names))
    print(f"[startup] kernels built or found in {time.perf_counter() - t0:.1f}"
          f" s before the children start", flush=True)
    runs = []
    for i in range(args.runs):
        r = one_run(root, args.keep_bytecode)
        runs.append(r)
        s, it = r["split"], r["-X importtime cli.main"]
        step = r["cli.main cnn 1 step at batch 2 (fixture)"]
        print(f"[startup] run {i + 1}: pass {r['python -c pass']:.2f} s, "
              f"import torch {r[IMPORT_TORCH]:.2f} s, "
              f"--help {r['cli.main --help']:.2f} s (started "
              f"{r['cli.main --help started'] or 'nothing'}), importtime "
              f"{it['total']:.2f} s "
              f"{ {k: round(v, 2) for k, v in it['top'].items()} }"
              f"; split process {s['wall']:.2f} s (in-process "
              f"{s['in_process']:.2f}; started {s['started'] or 'nothing'}): "
              f"{ {k: round(v, 3) for k, v in s['steps'].items()} }; "
              f"cli.main 1 step {step['wall']:.2f} s (started "
              f"{step['started'] or 'nothing'})  [{card}]", flush=True)
    if runs[0]["split"]["native_error"]:
        print(f"[startup] native decoder: "
              f"{runs[0]['split']['native_error']}", flush=True)
    summary = {
        "card": card, "runs": len(runs),
        "median_s": {
            "python -c pass": _median(runs, lambda r: r["python -c pass"]),
            "import torch": _median(runs, lambda r: r[IMPORT_TORCH]),
            "cli.main --help": _median(runs, lambda r: r["cli.main --help"]),
            "split process": _median(runs, lambda r: r["split"]["wall"]),
            **{k: _median(runs, lambda r, k=k: r["split"]["steps"][k])
               for k in runs[0]["split"]["steps"]},
            "cli.main 1 step": _median(
                runs, lambda r: r["cli.main cnn 1 step at batch 2 (fixture)"]
                ["wall"]),
        },
    }
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"summary": summary, "runs": runs},
                                        indent=1))
    print("STARTUP " + json.dumps(summary), flush=True)
    if args.profile:
        profile_cli(root, args.profile, args.keep_bytecode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
