"""Inference CLI (counterpart of ``pose3d_tpu/cli/infer.py``): load the
lifter from a checkpoint, take each image's stage-1 outputs (2D keypoints
and metric depth), lift a batch of images to 3D at a time, save
``<stem>_pred_joints3d.npy`` and optionally a 2×2 panel (image | 2D
keypoints | depth | 3D pose).

``--checkpoint_path`` takes a training checkpoint directory of the port
(``--ema``: its EMA weights) or a reference-schema ``.pth``, as
``cli.evaluate`` does. Stage 1 is ``--stage1 cached`` (the preprocess
artifacts beside each image) or ``--stage1 jax``: the keypoint and depth
networks (``--kp-weights`` or its reference alias ``--yolo_model_path``,
``--depth-weights``; without both, the untrained networks, which only
``--allow-untrained`` permits). ``--data-parallel`` runs the stage-1
networks with one replica per visible card (``stage1.models``'s
``mesh=``); it applies to ``--stage1 jax`` only and is refused beside
``--stage1 cached``. Runs on the card (``--device cuda``, the default;
without CUDA it raises) unless ``--device cpu`` is given.

Usage:
  python -m pose3d_tpu_torch.cli.infer --checkpoint_path model.pth \\
      --input_folder imgs/ --output_folder out/ [--visualize] [--device cpu]
  python -m pose3d_tpu_torch.cli.infer --checkpoint_path model.pth \\
      --input_folder imgs/ --stage1 jax --kp-weights yolo11x-pose.pt \\
      --depth-weights depthpro/model.safetensors
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from pose3d_tpu_torch.cli.main import resolve_device
from pose3d_tpu_torch.core.config import CONNECTIONS_COCO, GlobalConfig

logger = logging.getLogger("Inference")

VIZ_THUMBNAIL_SIZE = (500, 500)


def stage1_mesh(device) -> list:
    """``--data-parallel``: every visible card of ``device``'s type (the
    CPU is one device), as the JAX CLIs take every device."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _resize_batch(images: List[np.ndarray], size_hw) -> np.ndarray:
    import cv2

    h, w = size_hw
    return np.stack([cv2.resize(im, (w, h), interpolation=cv2.INTER_LINEAR)
                     for im in images])


def compact_inputs(raws, s1s, size_hw):
    """The lifter's compact inputs, as the JAX ``make_lifter`` ships them:
    uint8 images resized to the model's size, each depth map min/max
    scaled to uint8 and resized, its ``[min, max]``, and the keypoints'
    (x, y)."""
    images = _resize_batch(raws, size_hw)                   # uint8 [b,H,W,3]
    dep_u8, scales = [], []
    for s in s1s:
        lo, hi = float(s.depth.min()), float(s.depth.max())
        rng = hi - lo if hi > lo else 1.0
        d01 = (s.depth - lo) / rng
        dep_u8.append(np.clip(d01 * 255.0 + 0.5, 0, 255).astype(np.uint8))
        scales.append([lo, hi])
    depths = _resize_batch([d[..., None] for d in dep_u8], size_hw)
    if depths.ndim == 3:
        depths = depths[..., None]
    kpts = np.stack([s.keypoints[:, :2] for s in s1s]).astype(np.float32)
    return {"image": images, "depth": depths,
            "depth_scale": np.asarray(scales, np.float32),
            "keypoints_2d": kpts}


def make_lifter(model, model_cfg):
    """``lift(raws, s1s) -> [b, J, 3]`` numpy: decoded full-size RGB
    images and their Stage1Results, shipped to the model's device as uint8
    pixels and decoded there by ``train.step.decompact_batch`` (4x less
    host→device traffic than float pixels)."""
    from pose3d_tpu_torch.train.step import decompact_batch

    size_hw = tuple(model_cfg.image_size)
    device = next(model.parameters()).device

    @torch.inference_mode()
    def lift(raws, s1s):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in compact_inputs(raws, s1s, size_hw).items()}
        b = decompact_batch(batch)
        out = model(b["image"], b["depth"], b["keypoints_2d"])
        return out.float().cpu().numpy()

    return lift


def create_depth_viz(depth: np.ndarray) -> np.ndarray:
    """Viridis-coloured uint8 depth panel."""
    import matplotlib.cm as cm

    d = depth.astype(np.float32)
    rng = d.max() - d.min()
    d01 = (d - d.min()) / rng if rng > 0 else np.zeros_like(d)
    rgba = cm.viridis(d01)
    return (rgba[..., :3] * 255).astype(np.uint8)


def create_2d_kpts_viz(image_rgb: np.ndarray, kpts: np.ndarray) -> np.ndarray:
    """Keypoints and the COCO skeleton over the image."""
    import cv2

    img = cv2.cvtColor(image_rgb, cv2.COLOR_RGB2BGR).copy()
    h, w = img.shape[:2]
    px = (kpts[:, 0] * w).astype(int)
    py = (kpts[:, 1] * h).astype(int)
    conf = kpts[:, 2]
    for i in range(len(px)):
        if conf[i] > 0:
            cv2.circle(img, (px[i], py[i]), 5, (0, 0, 255), -1)
    for s, e in CONNECTIONS_COCO:
        if s < len(px) and e < len(px) and conf[s] > 0 and conf[e] > 0:
            cv2.line(img, (px[s], py[s]), (px[e], py[e]), (0, 255, 0), 2)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _thumb(img: np.ndarray, size=VIZ_THUMBNAIL_SIZE) -> np.ndarray:
    import cv2

    th, tw = size
    h, w = img.shape[:2]
    scale = min(th / h, tw / w)
    nh, nw = int(h * scale), int(w * scale)
    canvas = np.full((th, tw, 3), 255, np.uint8)
    canvas[:nh, :nw] = cv2.resize(img, (nw, nh))
    return canvas


def _save_panel(out_dir: Path, f: Path, raw, s1, joints) -> None:
    """The 2×2 panel: image | 2D keypoints over depth's colormap | 3D pose."""
    import cv2

    from pose3d_tpu_torch.viz.plots import (
        fig_to_image,
        pyplot,
        visualize_3d_pose,
    )

    fig = visualize_3d_pose(joints.copy(), title="Predicted 3D Pose")
    pose_img = np.asarray(fig_to_image(fig))
    pyplot().close(fig)
    top = np.concatenate([_thumb(raw),
                          _thumb(create_2d_kpts_viz(raw, s1.keypoints))],
                         axis=1)
    bottom = np.concatenate([_thumb(create_depth_viz(s1.depth)),
                             _thumb(pose_img)], axis=1)
    viz_path = out_dir / f"{f.stem}_combined_viz.png"
    cv2.imwrite(str(viz_path), cv2.cvtColor(
        np.concatenate([top, bottom], axis=0), cv2.COLOR_RGB2BGR))
    logger.info("Saved combined visualization to %s", viz_path)


def run(args) -> int:
    import cv2

    from pose3d_tpu_torch.checkpoint import load_pose_model
    from pose3d_tpu_torch.stage1 import get_stage1_provider

    out_dir = Path(args.output_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = resolve_device(args.device)
    model, model_cfg = load_pose_model(
        args.checkpoint_path, device,
        dtype=getattr(torch, GlobalConfig().compute_dtype),
        model_type=args.model_type, ema=args.ema)
    logger.info("3D Pose Model loaded successfully (%s).",
                model_cfg.model_type)
    provider = get_stage1_provider(args.stage1, num_joints=args.num_joints,
                                   **stage1_kwargs(args, device))

    in_dir = Path(args.input_folder)
    image_files = sorted(
        f for f in in_dir.iterdir()
        if f.is_file() and f.suffix.lower() in (".png", ".jpg", ".jpeg")
        and not f.stem.endswith("_depth"))  # preprocess artifacts
    if not image_files:
        logger.warning("No images found in %s", args.input_folder)
        return 0

    lift = make_lifter(model, model_cfg)
    n_done = 0
    B = args.batch_size
    t0 = time.perf_counter()
    for i in range(0, len(image_files), B):
        decoded, paths = [], []
        for f in image_files[i:i + B]:
            bgr = cv2.imread(str(f), cv2.IMREAD_COLOR)
            if bgr is None:
                logger.error("Could not open image %s", f.name)
                continue
            decoded.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
            paths.append(f)
        if not paths:
            continue
        # stage 1 for the whole batch, padded back to B as the lift is
        real, pad = len(paths), B - len(paths)
        s1_list = provider.predict(
            paths + [paths[0]] * pad,
            images=decoded + [decoded[0]] * pad)[:real]
        raws, s1s, kept = [], [], []
        for f, rgb, s1 in zip(paths, decoded, s1_list):
            if s1 is None:
                logger.warning("Skipping %s: no stage-1 outputs.", f.name)
                continue
            raws.append(rgb)
            s1s.append(s1)
            kept.append(f)
        if not kept:
            continue
        # a short batch is padded back to B (the first element repeated,
        # its results dropped): the device sees one batch size
        pad = B - len(kept)
        preds = lift(raws + [raws[0]] * pad,
                     s1s + [s1s[0]] * pad)[:len(kept)]
        for f, raw, s1, joints in zip(kept, raws, s1s, preds):
            npy_path = out_dir / f"{f.stem}_pred_joints3d.npy"
            np.save(npy_path, joints)
            logger.info("Saved predicted 3D joints to %s", npy_path)
            n_done += 1
            if args.visualize:
                try:
                    _save_panel(out_dir, f, raw, s1, joints)
                except Exception:  # a panel never stops the predictions
                    logger.exception("Failed to create visualization for "
                                     "%s", f.name)
    seconds = time.perf_counter() - t0
    logger.info("Inference processing complete: %d images in %.3f s "
                "(%.2f images/s, decode, stage-1 reads and files included)",
                n_done, seconds, n_done / seconds)
    return n_done


def stage1_kwargs(args, device) -> dict:
    """The stage-1 provider's keyword arguments beyond ``num_joints``, as
    the JAX CLI forms them (``--yolo_model_path`` stands in for a missing
    ``--kp-weights`` and must exist; the untrained gate), plus the device.
    Empty for ``--stage1 cached``."""
    if args.stage1 != "jax":
        return {}
    extra = {"confidence_threshold": args.yolo_confidence_threshold}
    if not args.kp_weights and args.yolo_model_path:
        if not Path(args.yolo_model_path).exists():
            raise SystemExit(f"--yolo_model_path {args.yolo_model_path!r} "
                             "does not exist")
        args.kp_weights = args.yolo_model_path
    if args.kp_weights:
        extra["kp_weights"] = args.kp_weights
        extra["kp_input_size"] = args.kp_input_size
    if args.depth_weights:
        extra["depth_weights"] = args.depth_weights
        extra["depth_input_size"] = args.depth_input_size
    if not (args.kp_weights and args.depth_weights) \
            and not args.allow_untrained:
        missing = [n for n, v in (("--kp-weights", args.kp_weights),
                                  ("--depth-weights", args.depth_weights))
                   if not v]
        raise SystemExit(
            f"--stage1 jax without {'/'.join(missing)} would run with "
            "randomly initialized stage-1 networks and emit noise as "
            "predictions. Provide pretrained weights, pass "
            "--allow-untrained to proceed anyway, or use "
            "--stage1 cached with preprocess artifacts.")
    extra["device"] = device
    if args.data_parallel:
        extra["mesh"] = stage1_mesh(device)
        logger.info("Data-parallel stage-1 over %s", extra["mesh"])
    return extra


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Run 3D human pose inference (PyTorch/CUDA)")
    p.add_argument("--checkpoint_path", type=str, required=True,
                   help="A training checkpoint directory or a "
                        "reference-schema .pth")
    p.add_argument("--input_folder", type=str, required=True)
    p.add_argument("--model-type", type=str,
                   choices=["cnn", "transformer"], default=None,
                   help="Architecture hint for a bare state_dict .pth")
    p.add_argument("--output_folder", type=str, default="inference_output")
    p.add_argument("--num_joints", type=int, default=17)
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--ema", action="store_true",
                   help="Use the checkpoint's EMA weights (recorded by "
                        "training with --ema-decay)")
    p.add_argument("--stage1", type=str, default="cached",
                   choices=["cached", "jax"],
                   help="Stage-1 backend: the cached preprocess artifacts "
                        "or the keypoint and depth networks ('jax')")
    p.add_argument("--batch-size", type=int, default=8,
                   help="Images lifted per device batch")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device (default: cuda; raises without a card)")
    p.add_argument("--data-parallel", action="store_true",
                   help="Stage-1 batches split over every visible card, "
                        "one replica of each network on each (--stage1 "
                        "jax)")
    p.add_argument("--yolo_model_path", type=str, default=None,
                   help="Reference-compatible alias of --kp-weights with "
                        "--stage1 jax (ignored by the cached backend)")
    p.add_argument("--kp-weights", type=str, default=None,
                   help="Keypoint-model weights for --stage1 jax "
                        "(ultralytics YOLO11-pose .pt/.safetensors)")
    p.add_argument("--depth-weights", type=str, default=None,
                   help="Depth-model weights for --stage1 jax (DepthPro "
                        ".safetensors)")
    p.add_argument("--kp-input-size", type=int, default=640,
                   help="Keypoint-model input resolution (upstream 640)")
    p.add_argument("--depth-input-size", type=int, default=1536,
                   help="Depth-model input resolution (upstream 1536)")
    p.add_argument("--allow-untrained", action="store_true",
                   help="Permit --stage1 jax with randomly initialized "
                        "networks (outputs are noise; testing only)")
    p.add_argument("--yolo_confidence_threshold", type=float, default=0.3,
                   help="Keypoints below this confidence are zeroed "
                        "(--stage1 jax)")
    return p


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.data_parallel and args.stage1 != "jax":
        parser.error("--data-parallel splits the stage-1 networks' batches: "
                     "it applies to --stage1 jax only")
    return run(args)


def cli(argv=None) -> int:
    """Console-script entry: returns 0 (``main`` returns the images
    done)."""
    main(argv)
    return 0

if __name__ == "__main__":
    main()
