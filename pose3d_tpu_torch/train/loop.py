"""Training orchestration (counterpart of ``pose3d_tpu/train/loop.py``).

``train_model`` groups the loader's batches into [A, B, ...] superbatches
(uint8-compact on the host, decoded on the device) and feeds them through
a device prefetch: a feeder thread stacks the next superbatches and sends
pinned copies to the card on a copy stream while the current step
computes, and the step's stream waits on each copy's event. It makes one
optimizer step per
superbatch with dropout and augmentation generators seeded from (seed,
step), so a resumed run draws what an uninterrupted one draws; reads the
metrics back once every ``log_interval_steps`` steps; writes a validation
preview every ``preview_interval_steps``; runs the exact validation and
writes a checkpoint (:mod:`pose3d_tpu_torch.train.checkpoint`, with the
data position reached) every ``eval_interval_steps``, tracking the best by
validation MPJPE and keeping the newest ``keep_checkpoints``; stops
gracefully on ``stop_event``; and on any exit writes a last checkpoint and
the reference-schema ``.pth`` (:mod:`pose3d_tpu_torch.checkpoint`) of the
live weights, and of the EMA weights when ``ema_decay`` is set.

Not ported yet (ROADMAP.md): meshes and multi-process runs (the JAX
loop's ``mesh=``, ``param_sharding=`` and process gating).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import queue
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from pose3d_tpu_torch.checkpoint import save_pose_model
from pose3d_tpu_torch.data.collate import compact_batch
from pose3d_tpu_torch.ops.losses import LossWeights
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train.state import TrainState, with_ema_params
from pose3d_tpu_torch.train.step import make_eval_step, make_train_step
from pose3d_tpu_torch.train.tb import NullWriter
from pose3d_tpu_torch.utils import profiling

logger = logging.getLogger("pose3d_tpu_torch.train")

BATCH_KEYS = ("image", "depth", "keypoints_2d", "joints_3d", "depth_scale")
# 0x617567 = "aug": the augmentation stream, apart from the dropout's
AUG_STREAM = 0x617567
_MASK64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    """A generator seed for optimizer step ``step`` of a run seeded
    ``seed`` (splitmix64 of the pair; the counterpart of JAX's
    ``fold_in(rng, step)``): each step draws from a stream of its own, and
    a run resumed at step t draws what an uninterrupted run draws there."""
    x = (seed * 0x9E3779B97F4A7C15 + step + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def ema_pth_path(path) -> Path:
    """Where ``train_model`` writes the EMA weights' ``.pth`` beside the
    live weights' ``path``: ``model.pth`` → ``model_ema.pth``."""
    path = Path(path)
    return path.with_name(f"{path.stem}_ema{path.suffix}")


def _superbatches(loader: Iterable[Dict], accum: int):
    """Group raw numpy batches into [A, B, ...] superbatches, dropping a
    ragged tail, with pixels re-encoded as uint8 + depth scale for the
    host→device copy. The last microbatch's ``_pos`` (data-stream
    position) rides along."""
    it = iter(loader)
    while True:
        group = list(itertools.islice(it, accum))
        if len(group) < accum:
            return
        group = [compact_batch(g) for g in group]
        out = {k: np.stack([g[k] for g in group])
               for k in BATCH_KEYS if k in group[0]}
        if "_pos" in group[-1]:
            out["_pos"] = group[-1]["_pos"]
        yield out


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy arrays → tensors on ``device`` (uint8 stays uint8); keys
    starting with "_" are host metadata and are dropped."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                device, non_blocking=True)
            for k, v in batch.items() if not k.startswith("_")}


def _device_prefetch(iterator: Iterable[Dict], device, depth: int = 2):
    """Yield the items of ``iterator`` as tensors on ``device``, as the JAX
    loop's ``_device_prefetch``: an item is handed out once the next one
    has been read (or the stream has ended), so an error raised while the
    stream is read surfaces at the same step as there.

    A feeder thread reads the stream (the superbatches' stacking included)
    up to ``depth`` items ahead of the consumer. On a card it copies each
    item into pinned host memory and sends it on a copy stream of its own,
    so the host's work and the copy of the next superbatches overlap the
    current step; when an item is handed out, the consumer's stream waits
    on its copy's event, and its tensors are marked as used by that stream
    for the caching allocator. Keys starting with "_" stay on the host."""
    device = torch.device(device)
    copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                   else None)

    def put(item):
        host = {k: v for k, v in item.items() if k.startswith("_")}
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in item.items() if not k.startswith("_")}
        if copy_stream is None:
            return arrays, host, None
        with torch.cuda.stream(copy_stream):
            dev = {k: v.pin_memory().to(device, non_blocking=True)
                   for k, v in arrays.items()}
            return dev, host, copy_stream.record_event()

    def take(entry):
        dev, host, event = entry
        if event is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for t in dev.values():
                t.record_stream(stream)
        return {**dev, **host}

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def offer(msg) -> bool:
        while not stop.is_set():
            try:
                q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def feeder():
        try:
            for item in iterator:
                if not offer(("item", put(item))):
                    return
            offer(("end", None))
        except BaseException as e:  # handed to the consumer, raised there
            offer(("error", e))

    thread = threading.Thread(target=feeder, name="device_prefetch",
                              daemon=True)
    thread.start()
    try:
        kind, entry = q.get()
        while kind == "item":
            nxt = q.get()
            if nxt[0] == "error":
                raise nxt[1]
            yield take(entry)
            kind, entry = nxt
        if kind == "error":
            raise entry
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5)


def evaluate(eval_step, state: TrainState, val_loader: Iterable[Dict],
             per_action: bool = False) -> Dict[str, float]:
    """Sample-weighted averages of the loss components, MPJPE and PA-MPJPE
    over the whole loader, with ``eval_step`` from ``make_eval_step``
    (per-sample metrics). Eager PyTorch runs a ragged last batch at its
    own size, so the averages are exact without the JAX package's
    padding and mask.

    ``per_action`` adds ``"per_action"``: {action: {mpjpe, pa_mpjpe,
    count}} from each batch's ``action`` list (samples without one are
    left out), the Human3.6M per-action protocol."""
    device = next(state.model.parameters()).device
    totals: Dict[str, torch.Tensor] = {}
    count = 0
    action_totals: Dict[str, Dict[str, float]] = {}
    for batch in val_loader:
        bs = batch["image"].shape[0]
        db = {k: batch[k] for k in BATCH_KEYS if k in batch}
        metrics, _ = eval_step(state, to_device(db, device))
        for k, v in metrics.items():
            s = v.double().sum()
            totals[k] = totals[k] + s if k in totals else s
        count += bs
        if per_action and batch.get("action") is not None:
            mpjpe = metrics["mpjpe"].double().cpu().numpy()
            pa = metrics["pa_mpjpe"].double().cpu().numpy()
            for i, a in enumerate(batch["action"]):
                if a is None:
                    continue
                acc = action_totals.setdefault(
                    str(a), {"mpjpe": 0.0, "pa_mpjpe": 0.0, "count": 0})
                acc["mpjpe"] += float(mpjpe[i])
                acc["pa_mpjpe"] += float(pa[i])
                acc["count"] += 1
    if count == 0:
        raise RuntimeError("Validation loader yielded no batches — check "
                           "--val-chunks / --chunks-dir (an empty validation "
                           "would otherwise be silent)")
    out = {k: float(v) / count for k, v in totals.items()}
    if per_action:
        out["per_action"] = {
            a: {"mpjpe": acc["mpjpe"] / acc["count"],
                "pa_mpjpe": acc["pa_mpjpe"] / acc["count"],
                "count": acc["count"]}
            for a, acc in sorted(action_totals.items())
        }
    return out


def _preview(writer, eval_step, state, eval_view, preview, step) -> None:
    """One validation batch through the eval step; its first sample's
    image | prediction | ground truth as ``Val_Preview/comparison``."""
    device = next(state.model.parameters()).device
    db = {k: preview[k] for k in BATCH_KEYS if k in preview}
    with eval_view():
        _, preds = eval_step(state, to_device(db, device))
    try:
        from pose3d_tpu_torch.viz.plots import (
            fig_to_image,
            pyplot,
            visualize_comparison,
        )

        fig = visualize_comparison(
            preview["image"][0], preds[0].float().cpu().numpy(),
            preview["joints_3d"][0], title=f"Val Preview Step {step}")
        writer.add_image("Val_Preview/comparison",
                         np.asarray(fig_to_image(fig)), step)
        pyplot().close(fig)
    except Exception:
        logger.exception("Preview visualization failed")


def train_model(
    state: TrainState,
    train_loader: Iterable[Dict],
    val_loader: Optional[Iterable[Dict]] = None,
    *,
    writer=None,
    loss_weights: LossWeights = LossWeights(),
    gradient_accumulation_steps: int = 1,
    num_steps: Optional[int] = None,
    eval_interval_steps: int = 5000,
    log_interval_steps: int = 10,
    max_epochs: int = 10_000,
    generator: Optional[torch.Generator] = None,
    accum_mode: str = "grouped",
    ema_decay: Optional[float] = None,
    checkpoint_path=None,
    augment=None,
    augment_generator: Optional[torch.Generator] = None,
    compat_pa_metric: bool = False,
    start_step: Optional[int] = None,
    checkpoint_prefix: Optional[str] = None,
    model_type: Optional[str] = None,
    model_args: Optional[Dict] = None,
    preview_interval_steps: int = 50,
    data_state: Optional[Dict] = None,
    stop_event=None,
    keep_checkpoints: Optional[int] = None,
    profile: Optional[tuple] = None,
    memory_report: bool = False,
):
    """Train ``state`` in place over ``train_loader`` (numpy batches of
    ``image``, ``depth``, ``keypoints_2d``, ``joints_3d``); returns
    ``(state, global_step)``.

    Random streams: ``generator`` draws the dropout masks (default: a
    generator on the model's device seeded 42, the config's
    ``random_seed``) and ``augment`` (``ops.augment_device.
    make_device_augment(cfg)``) draws from ``augment_generator`` (default:
    seeded 42 + 0x617567), never from ``generator``. Before step t each is
    reseeded with :func:`step_seed` of its initial seed and t.

    Validation runs on the EMA weights when ``ema_decay`` is set.
    ``writer`` receives ``Loss/train_step`` and ``Loss_Components/*`` per
    step, ``Perf/step_time_ms`` and ``Perf/images_per_sec`` per log window
    after the first, ``Train/learning_rate`` per log window when the state
    has a schedule, ``Val_Preview/comparison`` every
    ``preview_interval_steps`` (a validation batch's first sample), and at
    a validation ``Loss/validation_epoch_avg``,
    ``Metrics/MPJPE_validation_epoch_avg``,
    ``Metrics/PA_MPJPE_validation_epoch_avg`` (``compat_pa_metric`` selects
    the reference's transposed Procrustes rotation) and
    ``Loss_Components_Val/*`` for every loss component.

    Checkpoints: with ``checkpoint_prefix``, one at every
    ``eval_interval_steps`` and one on any exit after the last, named by
    ``checkpoint.checkpoint_path(prefix, model_type, step)`` (``model_type``
    and ``model_args`` default to the model's config), with ``data_state``
    {epoch, samples_consumed} from the loader's ``_pos`` in the meta; the
    best by validation MPJPE is recorded, and ``keep_checkpoints`` keeps
    only the newest N besides it. ``checkpoint_path``: where the live
    weights' ``.pth`` is written when training ends, if any step ran, and
    with ``ema_decay`` the EMA view's beside it (:func:`ema_pth_path`).

    Resume: ``start_step`` (default ``state.step``) numbers the steps;
    ``data_state`` seeds the position bookkeeping (the caller fast-forwards
    the dataset through ``set_epoch`` / ``skip_next_samples``).
    ``stop_event`` (``threading.Event``) asks for a graceful stop at the
    next step; Ctrl-C ends training the same way.

    ``max_epochs`` bounds the passes over ``train_loader``; a loader that
    loops by itself and stamps its batches with ``_pos`` (epoch, index) is
    stopped once that epoch counter reaches ``max_epochs``.

    ``profile`` (start_at_step, num_steps, log_dir) writes a
    ``torch.profiler`` trace of steps start_at+1 .. start_at+num_steps;
    ``memory_report`` logs the card's allocator peak after the first
    step."""
    writer = writer or NullWriter()
    model = state.model
    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(42)
    if augment is not None and augment_generator is None:
        augment_generator = torch.Generator(device=device).manual_seed(
            42 + AUG_STREAM)
    drop_seed = generator.initial_seed()
    aug_seed = (augment_generator.initial_seed()
                if augment_generator is not None else None)
    cfg = model.config.to_dict()
    model_type = model_type or cfg["model_type"]
    model_args = cfg if model_args is None else model_args
    train_step = make_train_step(loss_weights, accum_mode=accum_mode,
                                 ema_decay=ema_decay, augment=augment)
    eval_step = make_eval_step(loss_weights, compat_pa=compat_pa_metric)

    def eval_view():
        return (with_ema_params(state) if ema_decay is not None
                else contextlib.nullcontext(state))

    target = num_steps if num_steps is not None else float("inf")
    global_step = first_step = (state.step if start_step is None
                                else int(start_step))
    last_ckpt_step = global_step
    last_pos = None
    if data_state:
        last_pos = (int(data_state["epoch"]),
                    int(data_state["samples_consumed"]))
    val_preview_iter = None

    pending_steps: list = []
    pending_metrics: list = []
    pending_images = 0
    flushes = 0
    stopped = False
    window_t0 = time.perf_counter()

    def flush_metrics():
        nonlocal pending_images, window_t0, flushes
        if not pending_metrics:
            return
        keys = sorted(pending_metrics[0])
        vals = torch.stack([torch.stack([m[k].float() for k in keys])
                            for m in pending_metrics]).cpu().numpy()
        dt = time.perf_counter() - window_t0
        for i, step_i in enumerate(pending_steps):
            writer.add_scalar("Loss/train_step",
                              float(vals[i, keys.index("total_loss")]),
                              step_i)
            for j, k in enumerate(keys):
                writer.add_scalar(f"Loss_Components/{k}", float(vals[i, j]),
                                  step_i)
        if state.scheduler is not None:
            # the rate the next update will use, as optax's schedule gives it
            # at this count
            writer.add_scalar("Train/learning_rate",
                              float(state.optimizer.param_groups[0]["lr"]),
                              pending_steps[-1])
        flushes += 1
        rate = ""
        if flushes > 1:  # the first window holds the kernels' builds
            writer.add_scalar("Perf/step_time_ms",
                              dt / len(pending_steps) * 1e3,
                              pending_steps[-1])
            writer.add_scalar("Perf/images_per_sec", pending_images / dt,
                              pending_steps[-1])
            rate = f", {pending_images / dt:.1f} img/s"
        logger.info("Step %d: loss %.4f%s", pending_steps[-1],
                    float(vals[-1, keys.index("total_loss")]), rate)
        pending_steps.clear()
        pending_metrics.clear()
        pending_images = 0
        window_t0 = time.perf_counter()

    def save(step: int) -> Path:
        meta = None if last_pos is None else {"data_state": {
            "epoch": last_pos[0], "samples_consumed": last_pos[1]}}
        return ckpt.save_checkpoint(
            ckpt.checkpoint_path(checkpoint_prefix, model_type, step),
            state, model_type, model_args, extra_meta=meta)

    prof = None
    if profile is not None:
        prof_at, prof_n, prof_dir = profile
        prof = {"at": int(prof_at), "until": int(prof_at) + int(prof_n),
                "dir": str(prof_dir), "window": contextlib.ExitStack()}

    try:
        for _epoch in range(max_epochs):
            if global_step >= target or stopped:
                break
            for batch in _device_prefetch(
                    _superbatches(train_loader, gradient_accumulation_steps),
                    device):
                if global_step >= target or stopped:
                    break
                if stop_event is not None and stop_event.is_set():
                    logger.warning("Graceful stop requested — checkpointing "
                                   "at step %d and exiting.", global_step)
                    stopped = True
                    break
                pos = batch.pop("_pos", None)
                if prof and global_step == prof["at"]:
                    logger.info("Starting profiler trace (steps %d..%d) -> %s",
                                prof["at"] + 1, prof["until"], prof["dir"])
                    prof["window"].enter_context(profiling.trace(prof["dir"]))
                generator.manual_seed(step_seed(drop_seed, global_step))
                if augment_generator is not None:
                    augment_generator.manual_seed(
                        step_seed(aug_seed, global_step))
                if memory_report and device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
                metrics = train_step(state, batch, generator,
                                     augment_generator)
                global_step += 1
                if memory_report:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    logger.info("Train-step memory: %s",
                                profiling.format_memory_report(
                                    profiling.memory_report(device)))
                    memory_report = False
                if prof and global_step >= prof["until"]:
                    prof["window"].close()
                    prof = None
                    logger.info("Profiler trace written to %s", profile[2])
                if pos is not None:
                    last_pos = (int(pos[0]), int(pos[1]))
                    if last_pos[0] >= max_epochs and not stopped:
                        # a looping loader never ends a pass: the cap comes
                        # from the stream's own epoch counter; the stop waits
                        # for the loop head so that this step is still logged
                        logger.warning("max_epochs=%d reached at step %d: "
                                       "stopping.", max_epochs, global_step)
                        stopped = True
                pending_steps.append(global_step)
                pending_metrics.append(metrics)
                pending_images += (batch["image"].shape[0]
                                   * batch["image"].shape[1])
                if (len(pending_steps) >= log_interval_steps
                        or global_step % preview_interval_steps == 0
                        or global_step % eval_interval_steps == 0):
                    flush_metrics()
                if (val_loader is not None
                        and global_step % preview_interval_steps == 0):
                    if val_preview_iter is None:
                        val_preview_iter = iter(val_loader)
                    preview = next(val_preview_iter, None)
                    if preview is None:
                        val_preview_iter = iter(val_loader)
                        preview = next(val_preview_iter, None)
                    if preview is None:
                        raise RuntimeError(
                            "Validation loader yielded no batches — check "
                            "--val-chunks / --chunks-dir.")
                    _preview(writer, eval_step, state, eval_view, preview,
                             global_step)
                if global_step % eval_interval_steps == 0:
                    val_mpjpe = None
                    if val_loader is not None:
                        with eval_view():
                            val = evaluate(eval_step, state, val_loader)
                        writer.add_scalar("Loss/validation_epoch_avg",
                                          val["total_loss"], global_step)
                        writer.add_scalar(
                            "Metrics/MPJPE_validation_epoch_avg",
                            val["mpjpe"], global_step)
                        writer.add_scalar(
                            "Metrics/PA_MPJPE_validation_epoch_avg",
                            val["pa_mpjpe"], global_step)
                        for k, v in val.items():
                            if k not in ("mpjpe", "pa_mpjpe"):
                                writer.add_scalar(f"Loss_Components_Val/{k}",
                                                  v, global_step)
                        logger.info("Step %d: Val Loss: %.4f, MPJPE: %.2f mm, "
                                    "PA-MPJPE: %.2f mm", global_step,
                                    val["total_loss"], val["mpjpe"],
                                    val["pa_mpjpe"])
                        val_mpjpe = val["mpjpe"]
                    if checkpoint_prefix is not None:
                        path = save(global_step)
                        if val_mpjpe is not None:
                            ckpt.record_best(checkpoint_prefix, model_type,
                                             global_step, val_mpjpe, path)
                        ckpt.apply_retention(checkpoint_prefix, model_type,
                                             keep_checkpoints)
                        last_ckpt_step = global_step
                    # validation and checkpoint time stay out of the next
                    # Perf/* window
                    window_t0 = time.perf_counter()
                elif global_step % preview_interval_steps == 0:
                    window_t0 = time.perf_counter()
    except KeyboardInterrupt:
        logger.warning("Interrupted at step %d: saving what was reached.",
                       global_step)
    finally:
        # every exit flushes the metrics and keeps what was reached
        if prof is not None:
            prof["window"].close()
        if val_preview_iter is not None and hasattr(val_preview_iter,
                                                    "close"):
            val_preview_iter.close()
        flush_metrics()
        if checkpoint_prefix is not None and global_step > last_ckpt_step:
            save(global_step)
            ckpt.apply_retention(checkpoint_prefix, model_type,
                                 keep_checkpoints)
        if checkpoint_path is not None and global_step > first_step:
            save_pose_model(model, checkpoint_path, step=global_step)
            if ema_decay is not None:
                with with_ema_params(state):
                    save_pose_model(model, ema_pth_path(checkpoint_path),
                                    step=global_step)
        writer.flush()
    return state, global_step
