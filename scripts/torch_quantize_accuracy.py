"""Weight-only int8 PTQ accuracy of the PyTorch/CUDA port on trained
weights (counterpart of ``scripts/quantize_accuracy.py``).

Exports the checkpoint that ``scripts/torch_overfit_demo.py
--save-checkpoint`` wrote as fp32 and int8 ``torch.export`` programs
(``serve.export_lifter`` / ``quantize_variables``), and the ``--ema`` pair
when the checkpoint holds EMA weights, loads each artifact back, runs it on
the checkpoint's own held-out batch, and prints MPJPE(int8) − MPJPE(fp32).
A transformer checkpoint exports with ``--attention-backend pallas`` by
default, so the attention forward kernel runs inside the program as the
custom operator.

Runs on the card unless ``--device cpu`` is given:
  python scripts/torch_overfit_demo.py --steps 600 --ema-decay 0.999 \\
      --save-checkpoint /tmp/overfit_ckpt
  python scripts/torch_quantize_accuracy.py /tmp/overfit_ckpt
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def accuracy(checkpoint, device, dtype, attention_backend: str = "pallas",
             out_root=None) -> dict:
    """MPJPE (mm) of each variant's loaded artifact on ``held_out.npz``
    (``mpjpe_mm_<variant>``) and the int8 − fp32 differences
    (``delta_mm_<int8 variant>``)."""
    import torch

    from pose3d_tpu_torch import serve
    from pose3d_tpu_torch.checkpoint import load_pose_model
    from pose3d_tpu_torch.cli.main import ATTENTION_IMPL
    from pose3d_tpu_torch.geometry.metrics import mpjpe
    from pose3d_tpu_torch.train.checkpoint import checkpoint_has_ema

    ckpt = Path(checkpoint)
    held = np.load(ckpt / "held_out.npz")
    args = [torch.from_numpy(held[k]).to(device)
            for k in ("image", "depth", "keypoints_2d")]
    gt = torch.from_numpy(held["joints_3d"])
    out_root = Path(out_root or tempfile.mkdtemp(prefix="quant_acc_"))
    # the EMA view loads the averaged weights with the averaged BatchNorm
    # statistics (load_pose_model(ema=True)), as the JAX script pairs them
    variants = [""] + (["ema"] if checkpoint_has_ema(ckpt) else [])
    report = {"attention_backend": attention_backend}
    for tag in variants:
        model, cfg = load_pose_model(
            ckpt, device, dtype=dtype, ema=bool(tag),
            attention_impl=ATTENTION_IMPL[attention_backend])
        for quant in (None, "int8"):
            name = "_".join(x for x in (tag, quant or "f32") if x)
            exported = serve.export_lifter(model, batch_size=args[0].shape[0],
                                           quantize=quant)
            adir = serve.save_exported(exported, out_root / name)
            program = serve.load_exported(adir).module()
            with torch.no_grad():
                pred = program(*args).float().cpu()
            err = float(mpjpe(pred, gt))
            report[f"mpjpe_mm_{name}"] = err
            report[f"artifact_mb_{name}"] = serve.load_exported_meta(adir)[
                "payload_bytes"] / 1e6
            print(f"{name:10s}: MPJPE {err:8.3f} mm (artifact {adir})",
                  flush=True)
    for tag in variants:
        base = "_".join(x for x in (tag, "f32") if x)
        q = "_".join(x for x in (tag, "int8") if x)
        report[f"delta_mm_{q}"] = (report[f"mpjpe_mm_{q}"]
                                   - report[f"mpjpe_mm_{base}"])
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint",
                    help="torch_overfit_demo.py --save-checkpoint directory")
    ap.add_argument("--out", type=str, default=None,
                    help="artifact staging directory (default: a temporary "
                         "one)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--attention-backend", choices=("pallas", "xla"),
                    default="pallas",
                    help="pallas (default): the attention kernel's custom "
                         "operator inside the program; xla: the plain "
                         "attention")
    args = ap.parse_args(argv)

    import torch

    from pose3d_tpu_torch.cli.main import resolve_device
    from pose3d_tpu_torch.core.config import GlobalConfig
    from pose3d_tpu_torch.ops.kernels import launch_counts

    device = resolve_device(args.device)
    report = accuracy(args.checkpoint, device,
                      getattr(torch, GlobalConfig().compute_dtype),
                      args.attention_backend, args.out)
    report["launches"] = launch_counts()
    report["device"] = (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu")
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
