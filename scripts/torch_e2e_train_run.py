"""End-to-end training run of the PyTorch/CUDA port from the shell on
synthetic learnable chunks (counterpart of ``scripts/e2e_train_run.py``).

Writes full-size 500×500 chunks whose 3D joints are a fixed linear map of
the 2D keypoints (a learnable signal), then makes one run of the training
CLI (``pose3d_tpu_torch.cli.main``: the chunk pipeline, host decode, the
device prefetch, the flagship CNN at batch 10 × accumulation 10, a
validation and a checkpoint at the end). Each logged step is timed as its
line is written; the steady rate is read over the steps after
``--warmup-steps`` (cuDNN's algorithm choice and the allocator's growth are
in the first), so no second warm-up run is needed: eager PyTorch keeps no
compilation cache that one would fill. Prints steady images/s, the loss's
fall and one JSON line, with the card's name and power limit.

Runs on the card unless ``--device cpu`` is given:
  python scripts/torch_e2e_train_run.py [--steps 30] [--samples 180]
      [--chunks 3] [--size 500] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
import re
import sys
import tarfile
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def make_learnable_chunk(out_dir: Path, chunk_idx: int, num_samples: int,
                         size: int, w_map: np.ndarray, prefix: str):
    """A chunk in the reference's container format whose joints are
    W · [x, y, 1] of each keypoint (the JAX script's arrays from the same
    seeds)."""
    import cv2

    rng = np.random.default_rng(100 + chunk_idx)
    chunk_name = f"chunk_{chunk_idx:06d}"
    stage = out_dir / "_stage" / chunk_name
    data_dir = stage / "data"
    samples = []
    for i in range(num_samples):
        sdir = data_dir / f"{i:06d}"
        sdir.mkdir(parents=True, exist_ok=True)
        img = rng.integers(0, 255, size=(size, size, 3), dtype=np.uint8)
        cv2.imwrite(str(sdir / "image.jpg"), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        cv2.imwrite(str(sdir / "depth.png"),
                    rng.integers(0, 255, size=(size, size), dtype=np.uint8))
        kpts = rng.uniform(5, size - 5, size=(17, 2))
        norm = kpts / size
        joints = np.einsum("jab,jb->ja", w_map,
                           np.concatenate([norm, np.ones((17, 1))], 1))
        metadata = {
            "image_size": [size, size], "depth_size": [size, size],
            "keypoints": [[{"x": float(x), "y": float(y)}
                           for x, y in kpts]],
            "depth_min": 1.5, "depth_max": 7.5,
        }
        with open(sdir / "metadata.json", "w") as f:
            json.dump(metadata, f)
        samples.append({
            "image_file": f"data/{i:06d}/image.jpg",
            "depth_file": f"data/{i:06d}/depth.png",
            "metadata_file": f"data/{i:06d}/metadata.json",
            "joints_3d": joints.tolist(),
            "camera_params": {"R": np.eye(3).tolist(), "t": [0, 0, 0],
                              "f": [1000, 1000],
                              "c": [size / 2, size / 2]},
            "bbox": [0, 0, size, size], "action": 2, "subaction": 1,
            "frame_idx": i, "cam_idx": 1, "subject": 1,
            "depth_min": 1.5, "depth_max": 7.5,
            "keypoints": metadata["keypoints"],
            "image_size": [size, size],
        })
    with open(stage / "samples.pkl", "wb") as f:
        pickle.dump(samples, f)
    parent = out_dir / prefix
    parent.mkdir(parents=True, exist_ok=True)
    tar_path = parent / f"dataset_chunk_{chunk_idx:06d}.tar.gz"
    with tarfile.open(tar_path, "w:gz") as tar:
        tar.add(stage, arcname=chunk_name)
    return tar_path


class StepClock(logging.Handler):
    """Host time and loss of each ``Step N: loss X`` line of the loop."""

    def __init__(self):
        super().__init__()
        self.steps = []

    def emit(self, record):
        m = re.match(r"Step (\d+): loss ([-\d.eE+naif]+)", record.getMessage())
        if m:
            self.steps.append((int(m.group(1)), time.perf_counter(),
                               float(m.group(2))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup-steps", type=int, default=3,
                    help="first steps left out of the steady rate")
    ap.add_argument("--samples", type=int, default=180)
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--size", type=int, default=500)
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--grad-accum", type=int, default=10)
    ap.add_argument("--model-args", type=str, default=None,
                    help="JSON model-config overrides")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from pose3d_tpu_torch.cli.main import main as train_main, resolve_device
    from pose3d_tpu_torch.utils.profiling import card_label

    card = card_label(resolve_device(args.device))
    root = Path(tempfile.mkdtemp(prefix="e2e_train_"))
    rng = np.random.default_rng(0)
    w_map = rng.normal(size=(17, 3, 3)) * np.array([300, 300, 50])[:, None]
    t0 = time.perf_counter()
    for c in range(args.chunks):
        make_learnable_chunk(root / "chunks", c, args.samples, args.size,
                             w_map, "train")
    make_learnable_chunk(root / "chunks", args.chunks, args.samples,
                         args.size, w_map, "test")
    print(f"built {args.chunks}+1 chunks of {args.samples} samples at "
          f"{args.size}px in {time.perf_counter() - t0:.1f} s ({root})",
          flush=True)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    clock = StepClock()
    logging.getLogger().addHandler(clock)
    logging.getLogger().setLevel(logging.INFO)   # where handlers pre-exist
    cwd = os.getcwd()
    os.chdir(root)    # checkpoints land in the working directory
    try:
        t0 = time.perf_counter()
        train_main([
            "--chunks-dir", str(root / "chunks"),
            "--train-chunks", *[str(c) for c in range(args.chunks)],
            "--val-chunks", str(args.chunks),
            "--cache-dir", str(root / "cache"),
            "--model-type", "cnn",
            *(["--model-args", args.model_args] if args.model_args else []),
            "--batch-size", str(args.batch_size),
            "--grad-accum", str(args.grad_accum),
            "--num-steps", str(args.steps),
            "--eval-interval", str(args.steps),
            "--log-interval", "1",
            "--no-tensorboard", "--device", args.device,
        ])
        run_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        logging.getLogger().removeHandler(clock)
    steps = clock.steps
    images = args.batch_size * args.grad_accum
    w = min(args.warmup_steps, len(steps) - 2)
    (s0, t_0, _), (s1, t_1, _) = steps[w], steps[-1]
    out = {"card": card, "steps": args.steps, "images_per_step": images,
           "run_s": run_s, "steady_steps": s1 - s0,
           "steady_step_ms": (t_1 - t_0) * 1e3 / (s1 - s0),
           "steady_images_per_sec": (s1 - s0) * images / (t_1 - t_0),
           "end_to_end_images_per_sec": args.steps * images / run_s,
           "first_loss": steps[0][2], "last_loss": steps[-1][2],
           "loss_fall": steps[0][2] / steps[-1][2]}
    print(f"TIMED RUN: {args.steps} steps ({args.steps * images} images) in "
          f"{run_s:.1f} s end to end; steady {out['steady_images_per_sec']:.1f}"
          f" img/s over steps {s0}-{s1}; loss {out['first_loss']:.1f} → "
          f"{out['last_loss']:.1f}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
