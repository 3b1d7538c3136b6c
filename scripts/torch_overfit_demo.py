"""Full-scale learning-dynamics demonstration of the PyTorch/CUDA port on
the card (counterpart of ``scripts/overfit_demo.py``).

Trains the flagship CNN (``CNNModelConfig()``, 500×500, 21 input channels,
the reference's batch 10 × accumulation 10, grouped ghost BatchNorm) or a
reduced ViT lifter (256 px, embed 192, depth 4, 4 heads: head depth 48, so
the ``wgmma`` attention kernels; accumulation 1 × batch 8) on a small fixed
synthetic task whose 3D joints are a linear function of the 2D keypoints
(``make_task_batch``, the JAX script's arrays bit for bit from the same
seed), and shows that the whole stack learns: the loss falls by orders of
magnitude and MPJPE falls far below the untrained value. The superbatches
stay on the device, so the run times the train step, not the host feed.

Closing JSON line: the untrained held-out MPJPE, the curve (loss, train-
and held-out-batch MPJPE), steady images/s from the second half of the run,
and the kernels' launches. ``--save-checkpoint DIR`` writes a training
checkpoint of the port and ``held_out.npz`` for
``scripts/torch_quantize_accuracy.py``.

Runs on the card unless ``--device cpu`` is given (no fallback):
  python scripts/torch_overfit_demo.py [--model-type cnn|transformer]
      [--steps 600] [--superbatches 4] [--eval-every 50]
      [--ema-decay 0.999] [--save-checkpoint DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the reduced ViT of the JAX script's transformer leg
TRANSFORMER_ARGS = {
    "image_size": [256, 256], "heatmap_size": 64,
    "transformer_embed_dim": 192, "transformer_heads": 4,
    "vit_depth": 4, "vit_heads": 4, "final_encoder_depth": 2,
    "num_cross_modal_layers": 1,
    "regression_hidden_dims": [256, 128],
}


def make_task_batch(rng, a, b, size=500, joints=17):
    """joints_3d = (kpts @ W) · 600, root-centred — learnable from the
    keypoint stream alone; images and depth carry no signal (constant), so
    the model must route information through the heatmap channels."""
    kpts = rng.uniform(0.08, 0.92, size=(a, b, joints, 2)).astype(np.float32)
    W = (np.arange(6).reshape(2, 3).astype(np.float32) - 2.5)
    j = (kpts @ W) * 600.0
    j = j - j[:, :, :1]
    return {
        "image": np.full((a, b, size, size, 3), 0.5, np.float32),
        "depth": np.full((a, b, size, size, 1), 4.0, np.float32),
        "keypoints_2d": kpts,
        "joints_3d": j.astype(np.float32),
    }


def task_data(seed: int, superbatches: int, accum: int, batch: int,
              size: int, joints: int = 17):
    """(train superbatches [A, B, ...], held-out batch [B, ...]) as numpy,
    drawn in the JAX script's order from one generator."""
    rng = np.random.default_rng(seed)
    train = [make_task_batch(rng, accum, batch, size, joints)
             for _ in range(superbatches)]
    held = {k: v[0] for k, v in make_task_batch(rng, 1, batch, size,
                                                joints).items()}
    return train, held


def train_curve(state, train_batches, held_out, steps: int, eval_every: int,
                ema_decay=None, seed: int = 0) -> dict:
    """Train ``state`` on the superbatches in turn (numpy dicts, moved to
    the model's device once) for ``steps`` optimizer steps; evaluate the
    held-out batch and the first microbatch of the first superbatch at
    step 1 and every ``eval_every`` steps. Returns the untrained held-out
    MPJPE, the curve and the device the run took."""
    import torch

    from pose3d_tpu_torch.train.loop import to_device
    from pose3d_tpu_torch.train.step import make_eval_step, make_train_step

    device = next(state.model.parameters()).device
    train = [to_device(sb, device) for sb in train_batches]
    held = to_device(held_out, device)
    train_eval = {k: v[0] for k, v in train[0].items()}
    train_step = make_train_step(ema_decay=ema_decay)
    eval_step = make_eval_step()
    gen = torch.Generator(device=device).manual_seed(seed)

    def mpjpe(batch):
        m, _ = eval_step(state, batch)
        return float(m["mpjpe"].mean())

    base = mpjpe(held)
    print(f"untrained held-out MPJPE: {base:.1f} mm", flush=True)
    curve = []
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        metrics = train_step(state, train[(step - 1) % len(train)], gen)
        if step % eval_every == 0 or step == 1:
            loss = float(metrics["total_loss"])
            val, tr = mpjpe(held), mpjpe(train_eval)
            dt = time.perf_counter() - t0
            curve.append({"step": step, "loss": loss, "train_mpjpe_mm": tr,
                          "held_out_mpjpe_mm": val, "wall_s": dt})
            print(f"step {step:4d}  loss {loss:12.1f}  train MPJPE "
                  f"{tr:7.1f}  held-out {val:7.1f} mm ({dt:6.1f}s)",
                  flush=True)
    return {"untrained_mpjpe_mm": base, "curve": curve, "device": device}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--superbatches", type=int, default=4)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--learning-rate", type=float, default=1e-3)
    ap.add_argument("--save-checkpoint", type=str, default=None,
                    help="Save the trained state (a training checkpoint of "
                         "the port) plus the held-out batch (held_out.npz) "
                         "here, for scripts/torch_quantize_accuracy.py")
    ap.add_argument("--ema-decay", type=float, default=None,
                    help="Track an EMA of the parameters (saved in the "
                         "checkpoint for the --ema export variant)")
    ap.add_argument("--model-type", choices=("cnn", "transformer"),
                    default="cnn",
                    help="cnn = the flagship 500×500 config; transformer = "
                         "a reduced ViT lifter (256 px, embed 192, depth 4)")
    ap.add_argument("--model-args", type=str, default=None,
                    help="JSON model-config overrides")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the task data, the initial weights and "
                         "dropout (the JAX script fixes 0); other seeds "
                         "repeat a run on other draws, as the calibration "
                         "of chip_smoke.py's overfit in PERF.md does")
    args = ap.parse_args(argv)

    import torch

    from pose3d_tpu_torch.cli.main import resolve_device
    from pose3d_tpu_torch.core.config import GlobalConfig, make_model_config
    from pose3d_tpu_torch.models import build_model
    from pose3d_tpu_torch.ops.kernels import launch_counts
    from pose3d_tpu_torch.train.state import create_train_state

    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    margs = json.loads(args.model_args) if args.model_args else {}
    if args.model_type == "transformer" and not margs:
        margs = dict(TRANSFORMER_ARGS)
    cfg = make_model_config(args.model_type, **margs)
    # the CNN runs the reference's 10 x 10 grouped superbatch, the ViT leg
    # accumulation 1 x batch 8
    accum, batch = (10, 10) if args.model_type == "cnn" else (1, 8)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = build_model(cfg, device=device, train=True, generator=gen,
                        dtype=getattr(torch, GlobalConfig().compute_dtype))
    state = create_train_state(model, learning_rate=args.learning_rate,
                               ema=args.ema_decay is not None)
    train, held = task_data(args.seed, args.superbatches, accum, batch,
                            cfg.image_size[0], cfg.num_joints)
    before = launch_counts()
    out = train_curve(state, train, held, args.steps, args.eval_every,
                      args.ema_decay, args.seed)
    after = launch_counts()
    curve = out["curve"]

    if args.save_checkpoint:
        from pose3d_tpu_torch.train.checkpoint import save_checkpoint

        path = Path(args.save_checkpoint)
        save_checkpoint(path, state, args.model_type, cfg.to_dict())
        np.savez(path / "held_out.npz", **held)
        print(f"checkpoint + held_out batch saved to {path}", flush=True)

    # steady throughput over the second half of the run: its first steps
    # carry cuDNN's algorithm search and the allocator's growth
    half = curve[len(curve) // 2]
    ss_imgs = (curve[-1]["step"] - half["step"]) * accum * batch
    ss_wall = max(curve[-1]["wall_s"] - half["wall_s"], 1e-9)
    summary = {
        "model_type": args.model_type,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "untrained_mpjpe_mm": out["untrained_mpjpe_mm"],
        "final_train_mpjpe_mm": curve[-1]["train_mpjpe_mm"],
        "final_held_out_mpjpe_mm": curve[-1]["held_out_mpjpe_mm"],
        "steps": args.steps,
        "effective_images": args.steps * accum * batch,
        "wall_s": curve[-1]["wall_s"],
        "steady_state_images_per_sec": ss_imgs / ss_wall,
        "launches": {k: after[k] - before[k] for k in after},
        "curve": curve,
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
