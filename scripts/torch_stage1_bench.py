"""Stage-1 throughput of the PyTorch/CUDA port on the card (counterpart of
``scripts/stage1_bench.py``).

Times the upstream architectures from seeded random weights (timing does
not depend on the weights): YOLO11x-pose at 640² (forward and the
best-person decode) and DepthPro (apple/DepthPro-hf's architecture: three
Dinov2-L encoders over a 35-patch pyramid) at 1,536², in bf16, each with
its attention on the plain PyTorch version (``xla``) and on the
hand-written kernel (``pallas``), between CUDA events. The kernel's
launches a forward are counted. Prints one line a network and backend and
one JSON line, with the card's name and power limit.

Runs on the card unless ``--device cpu`` is given (``--tiny``: YOLO11n at
64² and a two-layer DepthPro at 64², for a run on the CPU):
  python scripts/torch_stage1_bench.py [yolo] [depth] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

BACKENDS = ("xla", "pallas")


def _tiny_depthpro_arch():
    from pose3d_tpu_torch.stage1.depthpro import DepthProArch, ViTArch

    return DepthProArch(
        fusion_hidden_size=16, patch_size=16, intermediate_hook_ids=(1, 0),
        intermediate_feature_dims=(16, 16),
        scaled_images_feature_dims=(32, 32, 16), image_size=64,
        vit=ViTArch(hidden_size=32, num_layers=2, num_heads=2, patch_size=4,
                    image_size=16))


def bench(name, model, x, post, device, reps: int) -> dict:
    """ms a forward (and ``post`` of its output) for each backend, with
    the attention kernel's launches a forward."""
    import torch

    from pose3d_tpu_torch.ops.kernels.flash_attention import \
        flash_attention_fwd
    from pose3d_tpu_torch.stage1.yolo11 import set_attention_backend
    from pose3d_tpu_torch.utils.profiling import time_calls

    n_params = sum(p.numel() for p in model.parameters())
    out = {"params_m": n_params / 1e6, "batch": x.shape[0],
           "size": x.shape[-1]}
    for backend in BACKENDS:
        set_attention_backend(model, backend)
        with torch.inference_mode():
            before = flash_attention_fwd.launches
            post(model(x))
            out[f"{backend}_launches"] = flash_attention_fwd.launches - before
            ms = time_calls(lambda: post(model(x)), device, reps, warmup=1)
        out[f"{backend}_ms"] = ms
        out[f"{backend}_images_per_sec"] = x.shape[0] / ms * 1e3
        print(f"{name} b{x.shape[0]} @{x.shape[-1]} {backend}: {ms:.1f} "
              f"ms/batch ({x.shape[0] / ms * 1e3:.2f} img/s, "
              f"{n_params / 1e6:.1f}M params, "
              f"{out[f'{backend}_launches']} kernel launches)", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="*",
                    help="yolo, depth or both (default: both)")
    ap.add_argument("--yolo-batch", type=int, default=8)
    ap.add_argument("--depth-batch", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tiny", action="store_true",
                    help="YOLO11n at 64² and a two-layer DepthPro at 64²")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    args.which = args.which or ["yolo", "depth"]
    if set(args.which) - {"yolo", "depth"}:
        ap.error(f"unknown network(s) {args.which}: yolo, depth")

    import torch

    from pose3d_tpu_torch.cli.main import resolve_device
    from pose3d_tpu_torch.stage1.depthpro import (
        DepthProArch,
        DepthProDepthEstimator,
    )
    from pose3d_tpu_torch.stage1.yolo11 import (
        YOLO11Pose,
        best_person_keypoints,
        cast_for_inference,
    )
    from pose3d_tpu_torch.utils.profiling import card_label

    device = resolve_device(args.device)
    out = {"card": card_label(device), "dtype": "bfloat16"}
    print(f"card: {out['card']}", flush=True)
    dtype = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(0)
    if "yolo" in args.which:
        size = 64 if args.tiny else 640
        torch.manual_seed(0)
        with torch.device(device):
            model = YOLO11Pose(scale="n" if args.tiny else "x", dtype=dtype)
        cast_for_inference(model, dtype)
        x = torch.rand(args.yolo_batch, 3, size, size, generator=gen,
                       device=device)
        out["yolo"] = bench(f"yolo11{model.scale}-pose", model, x,
                            lambda raw: best_person_keypoints(raw, size),
                            device, args.reps)
        del model, x
    if "depth" in args.which:
        arch = _tiny_depthpro_arch() if args.tiny else DepthProArch()
        torch.manual_seed(0)
        with torch.device(device):
            model = DepthProDepthEstimator(arch, dtype=dtype)
        cast_for_inference(model, dtype)
        x = torch.randn(args.depth_batch, 3, arch.image_size,
                        arch.image_size, generator=gen, device=device)
        out["depthpro"] = bench("DepthPro", model, x, lambda o: o, device,
                                args.reps)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
