"""Serving latency of the PyTorch/CUDA port on the card: the exported
``torch.export`` program against the live model, flagship CNN at 500×500
(counterpart of ``scripts/serve_bench.py``).

Times, at one batch (default 10):
  * ``live``: the eval model on device-resident inputs;
  * ``artifact``: the program that ``serve.export_lifter`` traced at that
    batch, saved and loaded back (``serve.load_exported``), on the same
    inputs;
each over ``--calls`` chained calls between two CUDA events (each call
takes the previous output's first element × 0 into its input, so no call
can start before the last one ended), best of ``--reps``; and the
``make_serving_fn`` closure over each (numpy in, numpy out: the copies
both ways and the synchronisation, as ``serve_http`` calls it) on the
host's clock. Prints ms a call, images/s, the artifact's MB and one JSON
line, with the card's name and power limit.

Runs on the card unless ``--device cpu`` is given:
  python scripts/torch_serve_bench.py [--batch 10] [--calls 20]
      [--model-type cnn] [--model-args JSON] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--model-type", choices=("cnn", "transformer"),
                    default="cnn")
    ap.add_argument("--model-args", type=str, default=None,
                    help="JSON model-config overrides (default: the "
                         "published config)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from pose3d_tpu_torch import serve
    from pose3d_tpu_torch.cli.main import resolve_device
    from pose3d_tpu_torch.core.config import GlobalConfig, make_model_config
    from pose3d_tpu_torch.models import build_model
    from pose3d_tpu_torch.utils.profiling import card_label, time_calls

    device = resolve_device(args.device)
    card = card_label(device)
    print(f"card: {card}", flush=True)
    cfg = make_model_config(args.model_type, **json.loads(
        args.model_args or "{}"))
    model = build_model(cfg, device=device,
                        dtype=getattr(torch, GlobalConfig().compute_dtype))
    rng = np.random.default_rng(0)
    b, (h, w), J = args.batch, cfg.image_size, cfg.num_joints
    host = (rng.uniform(size=(b, h, w, 3)).astype(np.float32),
            rng.uniform(1, 8, size=(b, h, w, 1)).astype(np.float32),
            rng.uniform(0.1, 0.9, size=(b, J, 2)).astype(np.float32))
    x = [torch.from_numpy(a).to(device) for a in host]

    def chained(call):
        def run():
            o = None
            for _ in range(args.calls):
                eps = o[0, 0, 0] * 0 if o is not None else 0.0
                o = call(x[0] + eps, x[1], x[2])
            return o
        return run

    def timed(call, label):
        with torch.inference_mode():
            best = min(time_calls(chained(call), device, 1,
                                  warmup=1 if r == 0 else 0)
                       for r in range(args.reps)) / args.calls
        print(f"{label}: {best:.3f} ms/call ({b / best * 1e3:.1f} img/s)",
              flush=True)
        return best

    def timed_host(fn, label):
        fn(*host)
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn(*host)
            best = min(best, (time.perf_counter() - t0) * 1e3 / args.calls)
        print(f"{label}: {best:.3f} ms/call on the host clock", flush=True)
        return best

    t_live = timed(model, f"live b{b}")
    t_live_fn = timed_host(serve.make_serving_fn(model),
                           f"live make_serving_fn b{b}")
    with tempfile.TemporaryDirectory(prefix="serve_bench_") as tmp:
        t0 = time.perf_counter()
        exported = serve.export_lifter(model, batch_size=b)
        art = serve.save_exported(exported, Path(tmp) / "art")
        export_s = time.perf_counter() - t0
        mb = serve.load_exported_meta(art)["payload_bytes"] / 1e6
        print(f"artifact: {mb:.1f} MB, exported in {export_s:.1f} s",
              flush=True)
        program = serve.load_exported(art).module()
    t_art = timed(program, f"exported artifact b{b}")
    t_art_fn = timed_host(serve.make_serving_fn(program),
                          f"artifact make_serving_fn b{b}")
    print(f"overhead: {(t_art / t_live - 1) * 100:+.1f}%", flush=True)
    out = {"card": card, "model_type": args.model_type, "batch": b,
           "live_ms": t_live, "artifact_ms": t_art,
           "live_images_per_sec": b / t_live * 1e3,
           "artifact_images_per_sec": b / t_art * 1e3,
           "live_serving_fn_ms": t_live_fn,
           "artifact_serving_fn_ms": t_art_fn,
           "artifact_mb": mb, "export_s": export_s,
           "timing": ("CUDA events" if device.type == "cuda"
                      else "host clock")}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
