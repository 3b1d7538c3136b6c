"""Preprocess CLI (counterpart of ``pose3d_tpu/cli/preprocess.py``).

Walks the subfolders of ``input_base`` (or ``input_base`` itself when it
has none); for every image runs stage 1 (2D keypoints and metric depth)
and writes into the mirrored output folder:

* ``<stem>_depth.png``: the depth map min/max-normalised to uint8;
* ``<stem>.json``: ``{image_size, depth_size, skeleton (COCO edges),
  keypoints (a list of persons, each a list of {x, y, conf} with pixel
  x and y), depth_min, depth_max}``.

The files are those the JAX package writes, byte for byte given the same
stage-1 outputs, so either package's ``CachedStage1``, chunker and
``cli.infer --stage1 cached`` read them. An image whose two outputs exist
is skipped, and a folder with ``finished.txt`` is skipped whole. Images go
through stage 1 in batches of ``--batch-size``; a short batch is padded by
repeating its first image (the results of the copies are dropped), so the
device sees one batch size.

Without ``--kp-weights`` and ``--depth-weights`` the untrained networks
would write noise: that is refused unless ``--allow-untrained`` is given.
Runs on the card (``--device cuda``, the default; without CUDA it raises)
unless ``--device cpu`` is given. ``--data-parallel`` splits stage 1's
batches over every visible card (one replica of each network on each).

Usage:
  python -m pose3d_tpu_torch.cli.preprocess <input_base> <output_base> \\
      --kp-weights yolo11x-pose.pt --depth-weights model.safetensors \\
      [--batch-size 16]
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np

from pose3d_tpu_torch.core.config import CONNECTIONS_COCO

logger = logging.getLogger("Preprocess")

IMAGE_EXTS = (".png", ".jpg", ".jpeg")


def _outputs_for(image_path: Path, out_dir: Path):
    stem = image_path.stem
    return out_dir / f"{stem}_depth.png", out_dir / f"{stem}.json"


def write_artifacts(image_path: Path, out_dir: Path, hw, res) -> None:
    """One image's ``<stem>_depth.png`` and ``<stem>.json`` from its
    Stage1Result (``hw``: the image's height and width)."""
    import cv2

    h, w = hw
    depth_path, meta_path = _outputs_for(image_path, out_dir)
    d = res.depth
    dmin, dmax = float(d.min()), float(d.max())
    rngv = dmax - dmin if dmax > dmin else 1.0
    cv2.imwrite(str(depth_path),
                ((d - dmin) / rngv * 255.0).astype(np.uint8))
    persons = [[
        {"x": int(round(float(x) * w)), "y": int(round(float(y) * h)),
         "conf": float(c)}
        for x, y, c in res.keypoints
    ]]
    meta = {
        "image_size": [w, h],
        "depth_size": [int(d.shape[1]), int(d.shape[0])],
        "skeleton": [list(e) for e in CONNECTIONS_COCO],
        "keypoints": persons,
        "depth_min": dmin,
        "depth_max": dmax,
    }
    with open(meta_path, "w") as fp:
        json.dump(meta, fp)


def process_folder(folder: Path, out_dir: Path, provider, batch_size: int,
                   timings: dict = None) -> int:
    """Stage 1 over ``folder``'s images that lack outputs; returns how many
    were written. ``timings`` (optional) gathers the seconds spent
    decoding (``decode_s``) and in stage 1 (``stage1_s``)."""
    import cv2

    out_dir.mkdir(parents=True, exist_ok=True)
    done_marker = out_dir / "finished.txt"
    if done_marker.exists():
        logger.info("Skipping %s (finished.txt present)", folder.name)
        return 0
    images = sorted(
        f for f in folder.iterdir()
        if f.is_file() and f.suffix.lower() in IMAGE_EXTS
        and not f.stem.endswith("_depth"))
    todo = [f for f in images
            if not all(p.exists() for p in _outputs_for(f, out_dir))]
    logger.info("%s: %d images, %d to process", folder.name, len(images),
                len(todo))
    timings = timings if timings is not None else {}
    n = 0
    for i in range(0, len(todo), batch_size):
        t0 = time.perf_counter()
        rgbs, kept = [], []
        for f in todo[i:i + batch_size]:
            bgr = cv2.imread(str(f), cv2.IMREAD_COLOR)
            if bgr is None:
                logger.error("Unreadable image %s", f)
                continue
            rgbs.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
            kept.append(f)
        t1 = time.perf_counter()
        timings["decode_s"] = timings.get("decode_s", 0.0) + t1 - t0
        if not kept:
            continue
        pad = batch_size - len(kept)
        results = provider.predict_batch(rgbs + [rgbs[0]] * pad)[:len(kept)]
        timings["stage1_s"] = (timings.get("stage1_s", 0.0)
                               + time.perf_counter() - t1)
        for f, rgb, res in zip(kept, rgbs, results):
            write_artifacts(f, out_dir, rgb.shape[:2], res)
            n += 1
    done_marker.write_text("done\n")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Stage-1 preprocess: 2D keypoints and depth per image "
                    "(PyTorch/CUDA)")
    p.add_argument("input_base", type=str)
    p.add_argument("output_base", type=str)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--input-size", type=int, default=512,
                   help="Input size of the untrained native networks")
    p.add_argument("--stage1", type=str, default="jax", choices=["jax"],
                   help="Stage-1 backend: the keypoint and depth networks "
                        "(the JAX package's name for them)")
    p.add_argument("--kp-weights", type=str, default=None,
                   help="Pretrained keypoint weights (ultralytics "
                        "YOLO11-pose .pt/.safetensors); random-init "
                        "KeypointNet otherwise")
    p.add_argument("--depth-weights", type=str, default=None,
                   help="Pretrained depth weights (DepthPro "
                        ".safetensors/.pt); random-init DepthNet otherwise")
    p.add_argument("--allow-untrained", action="store_true",
                   help="Permit running without pretrained stage-1 weights "
                        "(outputs are noise; testing only)")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device (default: cuda; raises without a card)")
    p.add_argument("--data-parallel", action="store_true",
                   help="Stage-1 batches split over every visible card, "
                        "one replica of each network on each")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    parser = build_parser()
    args = parser.parse_args(argv)
    if not (args.kp_weights and args.depth_weights) \
            and not args.allow_untrained:
        missing = [n for n, v in (("--kp-weights", args.kp_weights),
                                  ("--depth-weights", args.depth_weights))
                   if not v]
        raise SystemExit(
            f"preprocess without {'/'.join(missing)} would write noise "
            "artifacts from randomly initialized stage-1 networks. Provide "
            "pretrained weights or pass --allow-untrained.")
    from pose3d_tpu_torch.cli.infer import stage1_mesh
    from pose3d_tpu_torch.cli.main import resolve_device
    from pose3d_tpu_torch.stage1.models import TorchStage1

    device = resolve_device(args.device)
    mesh = None
    if args.data_parallel:
        mesh = stage1_mesh(device)
        logger.info("Data-parallel stage-1 over %s", mesh)
    provider = TorchStage1(
        input_size=args.input_size, kp_weights=args.kp_weights,
        depth_weights=args.depth_weights, device=device, mesh=mesh)
    input_base = Path(args.input_base)
    output_base = Path(args.output_base)
    folders = sorted(d for d in input_base.iterdir() if d.is_dir())
    if not folders:
        folders = [input_base]
    total, timings = 0, {}
    t0 = time.perf_counter()
    for folder in folders:
        rel = folder.relative_to(input_base) if folder != input_base \
            else Path()
        total += process_folder(folder, output_base / rel, provider,
                                args.batch_size, timings)
    seconds = time.perf_counter() - t0
    logger.info("Preprocessing complete: %d images processed in %.3f s "
                "(decode %.3f s, stage 1 %.3f s)", total, seconds,
                timings.get("decode_s", 0.0), timings.get("stage1_s", 0.0))
    return total


def cli(argv=None) -> int:
    """Console-script entry: returns 0 (``main`` returns the images
    processed, which would otherwise become the exit status)."""
    main(argv)
    return 0


if __name__ == "__main__":
    main()
