"""Micro-batching HTTP server (counterpart of ``pose3d_tpu/serve_http.py``):
the full pipeline of a checkpoint (``--checkpoint``: stage 1 and the
lifter, images in) or the lifter of an exported artifact (``--artifact``,
the output of ``pose3d_tpu_torch.cli.export``).

Requests queue on the host and one dispatcher forms device batches:
``MicroBatcher`` coalesces concurrent requests (up to ``max_batch`` samples
or ``max_wait_ms``) into power-of-two device batches, padded with zeros and
sliced back (a static-batch artifact pads every call to its own size), and
``_Handler`` serves ``POST /predict`` (npz in, npz out, ``X-Batch-*``
timing headers), ``GET /healthz`` (200 once the warmup batch has run) and
``GET /meta`` (an artifact's sidecar, or what the checkpoint is) over the
standard library's ``ThreadingHTTPServer``.

``--checkpoint`` has the JAX package's meaning: the full pipeline
(:func:`make_pipeline_server`). ``POST /predict_image`` takes one encoded
image (JPEG or PNG bytes) and answers ``npz{joints_3d [J, 3], keypoints
[J, 3]}``; ``PipelineBatcher`` coalesces concurrent images into device
batches of stage 1 (``--kp-weights`` YOLO11-pose, ``--depth-weights``
DepthPro; without both, the untrained networks, which only
``--allow-untrained`` permits) and the lifter (``--ema``: a checkpoint
directory's EMA weights); ``/predict`` answers 404 there. It runs on
``--device`` (default ``cuda``; there is no fallback to the CPU when CUDA
is absent). The lifter alone is served from an artifact
(``cli.export --checkpoint model.pth`` then ``--artifact``, as in the JAX
package), or in Python by :func:`make_server` on a ``.pth``; an artifact
runs on the device its weights were exported on.

Usage:
  python -m pose3d_tpu_torch.serve_http --checkpoint model.pth \\
      --kp-weights yolo11x-pose.pt --depth-weights model.safetensors
  python -m pose3d_tpu_torch.serve_http --artifact exported/
where ``model.pth`` comes from ``pose3d-convert <ckpt_dir> model.pth
--to-torch`` and ``exported/`` from ``pose3d_tpu_torch.cli.export``.
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from pose3d_tpu_torch.checkpoint import load_pose_model
from pose3d_tpu_torch.ops.kernels import flash_attention
from pose3d_tpu_torch.serve import (
    load_exported,
    load_exported_meta,
    make_serving_fn,
)

logger = logging.getLogger("pose3d_tpu_torch.serve_http")

INPUT_KEYS = ("image", "depth", "keypoints_2d")


def _bucket(n: int, cap: int) -> int:
    """Smallest power of two ≥ n, capped at ``cap``: the device sees
    log2(cap)+1 batch sizes, whatever the requests' sizes."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class MicroBatcher:
    """Coalesce concurrent predict requests into device batches.

    ``call_fn(image, depth, keypoints_2d) -> joints`` runs one device
    batch (``serve.make_serving_fn``). ``static_batch`` pins every device
    call to that exact size (a static-batch artifact); otherwise calls are
    padded to power-of-two buckets ≤ ``max_batch``.
    """

    def __init__(self, call_fn, *, max_batch: int = 8,
                 max_wait_ms: float = 5.0,
                 static_batch: Optional[int] = None):
        if static_batch is not None:
            max_batch = static_batch
        self._call_fn = call_fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.static_batch = static_batch
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        self.device_calls = 0
        self.samples_served = 0
        self.samples_padded = 0
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="microbatcher", daemon=True
        )
        self._thread.start()

    # -- client side --------------------------------------------------

    def submit(self, image, depth, keypoints_2d) -> Future:
        """Enqueue a [b, ...] request; resolves to joints [b, J, 3]."""
        if self._closed:
            raise RuntimeError("server is shutting down")
        arrays = (np.asarray(image, np.float32),
                  np.asarray(depth, np.float32),
                  np.asarray(keypoints_2d, np.float32))
        b = arrays[0].shape[0]
        if any(a.shape[0] != b for a in arrays):
            raise ValueError("inputs disagree on batch size")
        fut: Future = Future()
        self._queue.put((arrays, fut, time.monotonic()))
        return fut

    def close(self):
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=5)
        # Fail anything still queued (behind the sentinel, or racing a
        # submit) — otherwise their handler threads block on .result()
        # for the full request timeout during shutdown.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(
                    RuntimeError("server shut down before dispatch")
                )

    def stats(self) -> dict:
        return {
            "device_calls": self.device_calls,
            "samples_served": self.samples_served,
            "samples_padded": self.samples_padded,
            "max_batch": self.max_batch,
            "max_wait_ms": self.max_wait_s * 1e3,
            "static_batch": self.static_batch,
        }

    # -- dispatcher ---------------------------------------------------

    @staticmethod
    def _size(payload) -> int:
        """Samples in a request's payload (its arrays' leading axis)."""
        return payload[0].shape[0]

    def _dispatch_loop(self):
        while not self._closed:
            item = self._queue.get()
            if item is None:
                break
            items = [item]
            n = self._size(item[0])
            deadline = time.monotonic() + self.max_wait_s
            while n < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._closed = True
                    break
                items.append(nxt)
                n += self._size(nxt[0])
            try:
                self._run_batch(items)
            except Exception as e:  # resolve futures, keep serving
                logger.exception("batch failed")
                for _, fut, _ in items:
                    if not fut.done():
                        fut.set_exception(e)

    def _run_batch(self, items):
        t0 = time.monotonic()
        arrays = [np.concatenate([it[0][i] for it in items], axis=0)
                  for i in range(3)]
        n = arrays[0].shape[0]
        out_parts = []
        # chunk oversized coalesced batches; pad the final chunk
        for lo in range(0, n, self.max_batch):
            chunk = [a[lo:lo + self.max_batch] for a in arrays]
            cn = chunk[0].shape[0]
            target = (self.static_batch if self.static_batch is not None
                      else _bucket(cn, self.max_batch))
            if cn < target:
                pad = target - cn
                self.samples_padded += pad
                chunk = [
                    np.concatenate(
                        [a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0
                    ) for a in chunk
                ]
            joints = np.asarray(self._call_fn(*chunk))  # forces readback
            self.device_calls += 1
            out_parts.append(joints[:cn])
        joints = np.concatenate(out_parts, axis=0)
        self.samples_served += n
        t1 = time.monotonic()
        lo = 0
        for arrays_i, fut, t_enq in items:
            b = arrays_i[0].shape[0]
            fut.set_result({
                "joints_3d": joints[lo:lo + b],
                "queue_ms": (t0 - t_enq) * 1e3,
                "device_ms": (t1 - t0) * 1e3,
                "batch_size": n,
            })
            lo += b


class PipelineBatcher(MicroBatcher):
    """MicroBatcher over lists of decoded RGB images (any sizes) for the
    full pipeline: ``call_fn(images) -> (joints [n, J, 3], keypoints
    [n, J, 3])`` runs stage 1 and the lifter on one device batch. Batches
    bucket to powers of two as the lifter's do, the list padded by
    repeating its last image (those results dropped). A request counts its
    images (the JAX package's counts the first image's height, so it never
    coalesces two requests: ROADMAP.md Queue 3, F10)."""

    def submit(self, images) -> Future:
        if self._closed:
            raise RuntimeError("server is shutting down")
        if not images:
            raise ValueError("empty image list")
        fut: Future = Future()
        self._queue.put((images, fut, time.monotonic()))
        return fut

    @staticmethod
    def _size(payload) -> int:
        return len(payload)          # images, whatever their sizes

    def _run_batch(self, items):
        t0 = time.monotonic()
        images = [im for imgs, _, _ in items for im in imgs]
        n = len(images)
        joints_parts, kpts_parts = [], []
        for lo in range(0, n, self.max_batch):
            chunk = images[lo:lo + self.max_batch]
            cn = len(chunk)
            target = _bucket(cn, self.max_batch)
            if cn < target:
                self.samples_padded += target - cn
                chunk = chunk + [chunk[-1]] * (target - cn)
            joints, kpts = self._call_fn(chunk)
            self.device_calls += 1
            joints_parts.append(np.asarray(joints)[:cn])
            kpts_parts.append(np.asarray(kpts)[:cn])
        joints = np.concatenate(joints_parts, axis=0)
        kpts = np.concatenate(kpts_parts, axis=0)
        self.samples_served += n
        t1 = time.monotonic()
        lo = 0
        for imgs, fut, t_enq in items:
            b = len(imgs)
            fut.set_result({
                "joints_3d": joints[lo:lo + b],
                "keypoints": kpts[lo:lo + b],
                "queue_ms": (t0 - t_enq) * 1e3,
                "device_ms": (t1 - t0) * 1e3,
                "batch_size": n,
            })
            lo += b


def _load_pipeline_call(checkpoint, stage1_kwargs, ema=False,
                        device="cuda"):
    """The full pipeline as one batched callable: decoded RGB images →
    stage 1 (batched keypoints and depth) → the lifter → (joints,
    keypoints); the serving twin of ``cli.infer``'s batch body. Returns
    (call, the lifter's image size, its joints)."""
    from pose3d_tpu_torch.cli.infer import make_lifter
    from pose3d_tpu_torch.core.config import GlobalConfig
    from pose3d_tpu_torch.stage1 import get_stage1_provider

    device = torch.device(device)
    model, cfg = load_pose_model(
        checkpoint, device, dtype=getattr(torch, GlobalConfig().compute_dtype),
        ema=ema)
    provider = get_stage1_provider("jax", device=device, **stage1_kwargs)
    if device.type == "cuda" and cfg.model_type == "transformer":
        flash_attention.load_library("flash_attention_fwd")
    lift = make_lifter(model, cfg)

    def call(images):
        s1s = provider.predict_batch(images)
        joints = lift(images, s1s)
        kpts = np.stack([s.keypoints for s in s1s]).astype(np.float32)
        return joints, kpts

    return call, tuple(cfg.image_size), cfg.num_joints


class _Handler(BaseHTTPRequestHandler):
    server_version = "pose3d-serve/1"

    # quieter than the default stderr-per-request
    def log_message(self, fmt, *args):
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        srv = self.server
        if self.path == "/healthz":
            err = getattr(srv, "warmup_error", None)
            if srv.ready:
                payload = {"status": "ok"}
            elif err:
                payload = {"status": "failed", "error": err}
            else:
                payload = {"status": "warming up"}
            self._json(200 if srv.ready else 503, payload)
        elif self.path == "/meta":
            self._json(200, {
                "artifact": srv.artifact_meta,
                "batching": srv.batcher.stats(),
                "image_size": list(srv.image_hw),
                "num_joints": srv.num_joints,
            })
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        srv = self.server
        if self.path == "/predict_image" and srv.pipeline:
            self._predict_image()
            return
        if self.path != "/predict" or srv.pipeline:
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            data = np.load(io.BytesIO(self.rfile.read(length)))
            missing = [k for k in INPUT_KEYS if k not in data.files]
            if missing:
                raise ValueError(f"missing npz keys: {missing}")
            args = [data[k] for k in INPUT_KEYS]
            # Validate EVERY array shape up front: a malformed request
            # that reaches the batcher fails np.concatenate for the whole
            # coalesced batch, 500-ing every concurrent well-formed
            # request.
            img, depth, kpts = args
            if img.ndim != 4 or img.shape[3] != 3:
                raise ValueError(f"image must be [b,H,W,3], got {img.shape}")
            b = img.shape[0]
            if b < 1:
                raise ValueError("batch size must be >= 1")
            hw = tuple(img.shape[1:3])
            if hw != srv.image_hw:
                raise ValueError(
                    f"image is {hw}, the model expects {srv.image_hw}"
                )
            if depth.shape != (b,) + srv.image_hw + (1,):
                raise ValueError(
                    f"depth must be {(b,) + srv.image_hw + (1,)}, "
                    f"got {depth.shape}"
                )
            if kpts.shape != (b, srv.num_joints, 2):
                raise ValueError(
                    f"keypoints_2d must be {(b, srv.num_joints, 2)}, "
                    f"got {kpts.shape}"
                )
        except Exception as e:
            self._json(400, {"error": str(e)})
            return
        try:
            result = srv.batcher.submit(*args).result(timeout=srv.timeout_s)
        except Exception as e:
            self._json(500, {"error": str(e)})
            return
        buf = io.BytesIO()
        np.savez(buf, joints_3d=result["joints_3d"])
        body = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Batch-Size", str(result["batch_size"]))
        self.send_header("X-Queue-Ms", f"{result['queue_ms']:.2f}")
        self.send_header("X-Device-Ms", f"{result['device_ms']:.2f}")
        self.end_headers()
        self.wfile.write(body)

    def _predict_image(self):
        """The full pipeline: an encoded image in, npz{joints_3d [J, 3],
        keypoints [J, 3]} out."""
        import cv2

        srv = self.server
        try:
            length = int(self.headers.get("Content-Length", "0"))
            raw = np.frombuffer(self.rfile.read(length), np.uint8)
            bgr = cv2.imdecode(raw, cv2.IMREAD_COLOR)
            if bgr is None:
                raise ValueError("body is not a decodable image")
            rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        except Exception as e:
            self._json(400, {"error": str(e)})
            return
        try:
            result = srv.batcher.submit([rgb]).result(timeout=srv.timeout_s)
        except Exception as e:
            self._json(500, {"error": str(e)})
            return
        buf = io.BytesIO()
        np.savez(buf, joints_3d=result["joints_3d"][0],
                 keypoints=result["keypoints"][0])
        body = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Batch-Size", str(result["batch_size"]))
        self.send_header("X-Queue-Ms", f"{result['queue_ms']:.2f}")
        self.send_header("X-Device-Ms", f"{result['device_ms']:.2f}")
        self.end_headers()
        self.wfile.write(body)


def _serve(batcher, warmup_args, image_hw, num_joints, artifact_meta, host,
           port, *, request_timeout_s, pipeline=False) -> ThreadingHTTPServer:
    """The server around a batcher, and a warmup request
    (``batcher.submit(*warmup_args)``) on a background thread
    (``/healthz`` turns 200 once it has run)."""
    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.batcher = batcher
    srv.image_hw = tuple(image_hw)
    srv.num_joints = num_joints
    srv.timeout_s = request_timeout_s
    srv.artifact_meta = artifact_meta
    srv.pipeline = pipeline
    srv.ready = False
    srv.warmup_error = None

    def warmup():
        try:
            batcher.submit(*warmup_args).result()
        except Exception as e:  # surface via /healthz, not a dead thread
            srv.warmup_error = f"{type(e).__name__}: {e}"
            logger.exception("warmup failed — server will stay unready")
            return
        srv.ready = True
        logger.info("warmup done; serving on %s:%d", host, srv.server_port)

    threading.Thread(target=warmup, daemon=True).start()
    return srv


def _start(call_fn, image_hw, num_joints, artifact_meta, host, port, *,
           max_batch, max_wait_ms, request_timeout_s,
           static_batch=None) -> ThreadingHTTPServer:
    """The server around one device call: its batcher, the request
    contract, and a warmup batch on a background thread (``/healthz``
    turns 200 once it has run)."""
    batcher = MicroBatcher(call_fn, max_batch=max_batch,
                           max_wait_ms=max_wait_ms, static_batch=static_batch)
    h, w = image_hw
    warmup = (np.zeros((1, h, w, 3), np.float32),
              np.ones((1, h, w, 1), np.float32),
              np.full((1, num_joints, 2), 0.5, np.float32))
    return _serve(batcher, warmup, image_hw, num_joints, artifact_meta, host,
                  port, request_timeout_s=request_timeout_s)


def make_server(checkpoint, host: str = "127.0.0.1", port: int = 8000, *,
                device: str = "cuda", dtype=torch.bfloat16,
                max_batch: int = 8, max_wait_ms: float = 5.0,
                request_timeout_s: float = 60.0) -> ThreadingHTTPServer:
    """Build (but do not start) the lifter-only server of a ``.pth``
    checkpoint (``POST /predict``; the CLI's ``--checkpoint`` serves the
    full pipeline instead); the caller runs ``serve_forever()``, then
    ``shutdown()``, ``batcher.close()`` and ``server_close()``. ``dtype`` is
    the model's compute dtype."""
    device = torch.device(device)  # "cuda" without a card raises in the load
    model, cfg = load_pose_model(checkpoint, device, dtype=dtype)
    if device.type == "cuda" and cfg.model_type == "transformer":
        # build before any thread can reach the kernel (the CNN's eval
        # forward runs none: its BatchNorms read their running statistics)
        flash_attention.load_library("flash_attention_fwd")
    meta = {
        "checkpoint": str(checkpoint),
        "model_type": cfg.model_type,
        "framework": f"torch {torch.__version__}",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "dtype": str(model.dtype).removeprefix("torch."),
    }
    return _start(make_serving_fn(model), cfg.image_size, cfg.num_joints,
                  meta, host, port, max_batch=max_batch,
                  max_wait_ms=max_wait_ms,
                  request_timeout_s=request_timeout_s)


def make_pipeline_server(checkpoint, host: str = "127.0.0.1",
                         port: int = 8000, *, device: str = "cuda",
                         max_batch: int = 8, max_wait_ms: float = 5.0,
                         request_timeout_s: float = 600.0,
                         stage1_kwargs: Optional[dict] = None,
                         ema: bool = False) -> ThreadingHTTPServer:
    """Build (but do not start) the full-pipeline server: POST an encoded
    image to ``/predict_image``, get ``npz{joints_3d, keypoints}`` back.
    ``stage1_kwargs`` go to the stage-1 provider (``kp_weights``,
    ``depth_weights``, ``confidence_threshold``, ...); ``ema`` takes a
    checkpoint directory's EMA weights."""
    call, image_hw, num_joints = _load_pipeline_call(
        checkpoint, stage1_kwargs or {}, ema=ema, device=device)
    batcher = PipelineBatcher(call, max_batch=max_batch,
                              max_wait_ms=max_wait_ms)
    h, w = image_hw
    return _serve(batcher, ([np.zeros((h, w, 3), np.uint8)],), image_hw,
                  num_joints, {"mode": "pipeline",
                               "checkpoint": str(checkpoint)},
                  host, port, request_timeout_s=request_timeout_s,
                  pipeline=True)


def load_artifact_call(artifact_dir):
    """(call_fn, static_batch, image_hw, num_joints, device) of an exported
    artifact: the contract read from the program's input shapes (a
    symbolic batch: ``static_batch`` None)."""
    exported = load_exported(artifact_dir)
    sig = exported.graph_signature
    shapes = [n.meta["val"].shape for n in exported.graph.nodes
              if n.op == "placeholder" and n.name in sig.user_inputs]
    img, kpts = shapes[0], shapes[2]
    static_batch = img[0] if isinstance(img[0], int) else None
    module = exported.module()
    device = next(module.buffers()).device
    return (make_serving_fn(module), static_batch,
            (int(img[1]), int(img[2])), int(kpts[1]), device)


def make_artifact_server(artifact_dir, host: str = "127.0.0.1",
                         port: int = 8000, *, max_batch: int = 8,
                         max_wait_ms: float = 5.0,
                         request_timeout_s: float = 60.0
                         ) -> ThreadingHTTPServer:
    """Build (but do not start) the server of an exported artifact (the
    JAX package's ``make_server``): a static-batch artifact pins every
    device call to its own size; ``/meta`` serves its sidecar."""
    meta = load_exported_meta(artifact_dir)
    call_fn, static_batch, image_hw, num_joints, device = \
        load_artifact_call(artifact_dir)
    if device.type == "cuda" and "pose3d_torch::flash_attention_fwd" in \
            meta.get("custom_ops", ()):
        flash_attention.load_library("flash_attention_fwd")
    return _start(call_fn, image_hw, num_joints, meta, host, port,
                  max_batch=max_batch, max_wait_ms=max_wait_ms,
                  request_timeout_s=request_timeout_s,
                  static_batch=static_batch)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Serve with dynamic micro-batching: the FULL pipeline "
                    "of a checkpoint (--checkpoint, stage 1 + lifter; POST "
                    "an encoded image to /predict_image) or the lifter of "
                    "an exported artifact (--artifact; POST npz to "
                    "/predict). The lifter of a .pth alone: cli.export it, "
                    "then --artifact")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--artifact",
                      help="pose3d_tpu_torch.cli.export output directory "
                           "(lifter-only npz serving; a .pth's lifter alone "
                           "is served by exporting it first)")
    mode.add_argument("--checkpoint",
                      help="checkpoint directory or reference .pth: serve "
                           "the full image->joints pipeline (stage 1 + "
                           "lifter), as the JAX package does; for the "
                           "lifter alone use cli.export, then --artifact")
    p.add_argument("--kp-weights", default=None,
                   help="pipeline mode: ultralytics yolo11-pose .pt")
    p.add_argument("--depth-weights", default=None,
                   help="pipeline mode: DepthPro safetensors")
    p.add_argument("--confidence-threshold", type=float, default=0.0)
    p.add_argument("--ema", action="store_true",
                   help="Serve the checkpoint's EMA weights (recorded by "
                        "training with --ema-decay); pipeline mode only")
    p.add_argument("--allow-untrained", action="store_true",
                   help="pipeline mode: allow randomly initialized "
                        "stage-1 networks (noise output; testing only)")
    p.add_argument("--device", default=None,
                   help="--checkpoint: device (default cuda); an artifact "
                        "runs where its weights were exported")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8,
                   help="device batch cap (a static-batch artifact pins "
                        "its own size)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="how long to hold a partial batch for coalescing")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.artifact:
        if args.ema:
            raise SystemExit(
                "--ema applies to --checkpoint pipeline mode; for artifact "
                "mode export the averaged weights with cli.export --ema")
        if args.device is not None:
            p.error("--device: an artifact runs on the device its weights "
                    "were exported on (cli.export --device)")
        if not Path(args.artifact).exists():
            raise SystemExit(f"artifact not found: {args.artifact}")
        srv = make_artifact_server(args.artifact, args.host, args.port,
                                   max_batch=args.max_batch,
                                   max_wait_ms=args.max_wait_ms)
    else:
        # the untrained gate of cli.infer: random stage-1 networks emit
        # noise, not predictions
        if not (args.kp_weights and args.depth_weights) \
                and not args.allow_untrained:
            raise SystemExit(
                "pipeline serving without --kp-weights/--depth-weights "
                "would run randomly initialized stage-1 networks; provide "
                "weights or pass --allow-untrained")
        s1 = {"confidence_threshold": args.confidence_threshold}
        if args.kp_weights:
            s1["kp_weights"] = args.kp_weights
        if args.depth_weights:
            s1["depth_weights"] = args.depth_weights
        srv = make_pipeline_server(
            args.checkpoint, args.host, args.port,
            device=args.device or "cuda", max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, stage1_kwargs=s1, ema=args.ema)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.batcher.close()
        srv.server_close()


if __name__ == "__main__":
    main()
