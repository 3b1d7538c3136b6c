"""Micro-batching HTTP server for a reference ``.pth`` lifter checkpoint
(counterpart of ``pose3d_tpu/serve_http.py``, lifter-only mode).

The transport and batching tier is the JAX package's own, imported rather
than copied (it loads only numpy and the standard library):
``MicroBatcher`` coalesces concurrent requests into power-of-two device
batches and ``_Handler`` serves ``POST /predict`` (npz in, npz out),
``GET /healthz`` and ``GET /meta``. This module supplies the device call:
the port's model on ``device`` (default ``cuda``; there is no fallback to
the CPU when CUDA is absent).

Usage:
  python -m pose3d_tpu_torch.serve_http --checkpoint model.pth
where ``model.pth`` comes from ``pose3d-convert <ckpt_dir> model.pth
--to-torch``.
"""

from __future__ import annotations

import argparse
import logging
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import torch

from pose3d_tpu.serve_http import MicroBatcher, _Handler
from pose3d_tpu_torch.checkpoint import load_pose_model
from pose3d_tpu_torch.ops.kernels import flash_attention
from pose3d_tpu_torch.serve import make_serving_fn

logger = logging.getLogger("pose3d_tpu_torch.serve_http")


def make_server(checkpoint, host: str = "127.0.0.1", port: int = 8000, *,
                device: str = "cuda", dtype=torch.bfloat16,
                max_batch: int = 8, max_wait_ms: float = 5.0,
                request_timeout_s: float = 60.0) -> ThreadingHTTPServer:
    """Build (but do not start) the server; the caller runs
    ``serve_forever()``, then ``shutdown()``, ``batcher.close()`` and
    ``server_close()``. ``dtype`` is the model's compute dtype. A warmup
    batch runs on a background thread and ``/healthz`` turns 200 once it
    has."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               "available")
        # build before any thread can reach the kernel
        flash_attention.load_library("flash_attention_fwd")
    model, cfg = load_pose_model(checkpoint, device, dtype=dtype)
    batcher = MicroBatcher(make_serving_fn(model), max_batch=max_batch,
                           max_wait_ms=max_wait_ms)
    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.batcher = batcher
    srv.image_hw = tuple(cfg.image_size)
    srv.num_joints = cfg.num_joints
    srv.timeout_s = request_timeout_s
    srv.pipeline = False
    srv.artifact_meta = {
        "checkpoint": str(checkpoint),
        "model_type": cfg.model_type,
        "framework": f"torch {torch.__version__}",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "dtype": str(model.dtype).removeprefix("torch."),
    }
    srv.ready = False
    srv.warmup_error = None

    def warmup():
        h, w = srv.image_hw
        try:
            batcher.submit(
                np.zeros((1, h, w, 3), np.float32),
                np.ones((1, h, w, 1), np.float32),
                np.full((1, srv.num_joints, 2), 0.5, np.float32),
            ).result()
        except Exception as e:  # surface via /healthz, not a dead thread
            srv.warmup_error = f"{type(e).__name__}: {e}"
            logger.exception("warmup failed — server will stay unready")
            return
        srv.ready = True
        logger.info("warmup done; serving on %s:%d", host, srv.server_port)

    threading.Thread(target=warmup, daemon=True).start()
    return srv


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Serve a reference-schema .pth lifter checkpoint with "
                    "dynamic micro-batching (POST npz to /predict)")
    p.add_argument("--checkpoint", required=True,
                   help=".pth from pose3d-convert --to-torch")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8,
                   help="device batch cap")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="how long to hold a partial batch for coalescing")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    srv = make_server(args.checkpoint, args.host, args.port,
                      device=args.device, max_batch=args.max_batch,
                      max_wait_ms=args.max_wait_ms)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.batcher.close()
        srv.server_close()


if __name__ == "__main__":
    main()
