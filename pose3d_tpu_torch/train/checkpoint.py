"""Training-state checkpoints (counterpart of
``pose3d_tpu/train/checkpoint.py``).

A checkpoint is one directory per step, ``{prefix}_{model_type}_step_{N}``
as in the JAX package, holding

* ``state.pt`` (``torch.save``, CPU tensors): ``step``, the model's
  ``state_dict`` (parameters and buffers: the BatchNorm running statistics
  are the JAX state's ``batch_stats``), the AdamW ``state_dict`` (moments
  and counts), the LR scheduler's, and ``ema_params`` / ``ema_batch_stats``
  when the state carries them;
* ``meta.json``: ``step``, ``model_type``, ``model_args``, ``format``
  (``"pose3d_tpu_torch/v1"``) and whatever ``extra_meta`` adds (the
  training loop's ``data_state``, the data position to resume at).

``state.pt`` is written first and ``meta.json`` last, each under a
temporary name renamed into place, so a directory without ``meta.json``
is an unfinished save, which :func:`latest_checkpoint` and retention
ignore. The JAX package's orbax directories are not read here.

The reference-schema ``.pth`` (:mod:`pose3d_tpu_torch.checkpoint`) stays
the export format for serving and evaluation.

Multi-process runs: a replicated state is written by process 0 alone (the
training loop calls :func:`save_checkpoint` there only). A sharded state
(``parallel.shard_state_for_*``) is gathered collectively, every rank
calling :func:`save_checkpoint`, and written by process 0 in the same
format as a one-process run; :func:`restore_train_state` reads the file on
every rank and cuts each tensor to the rank's shard. So a checkpoint
written by two ranks resumes in one process, and the reverse.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from pose3d_tpu_torch.parallel.shard import full_state, shard_full_state
from pose3d_tpu_torch.train.state import TrainState, batch_stats

logger = logging.getLogger("pose3d_tpu_torch.train")

FORMAT = "pose3d_tpu_torch/v1"


def checkpoint_path(prefix: str, model_type: str, step: int) -> Path:
    return Path(f"{prefix}_{model_type}_step_{step}")


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def _write_atomic(path: Path, write) -> None:
    fd, tmp = tempfile.mkstemp(prefix=path.name + ".", suffix=".tmp",
                               dir=path.parent)
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(path, state: TrainState, model_type: str,
                    model_args: Dict, extra_meta: Optional[Dict] = None
                    ) -> Path:
    """Write ``state`` and its architecture to the directory ``path``;
    returns its absolute path. A sharded state is gathered first: every
    rank calls this, and process 0 writes."""
    path = Path(path).absolute()
    model_sd, opt_sd, ema = full_state(state)
    if dist.is_initialized() and dist.get_rank() != 0:
        return path
    path.mkdir(parents=True, exist_ok=True)
    tree = {
        "step": int(state.step),
        "model": _cpu(model_sd),
        "optimizer": opt_sd,
        "scheduler": (state.scheduler.state_dict()
                      if state.scheduler is not None else None),
    }
    if ema is not None:
        tree["ema_params"] = _cpu(ema)
    if state.ema_batch_stats is not None:
        tree["ema_batch_stats"] = _cpu(state.ema_batch_stats)
    _write_atomic(path / "state.pt", lambda tmp: torch.save(tree, tmp))
    meta = {
        "step": int(state.step),
        "model_type": model_type,
        "model_args": model_args,
        "format": FORMAT,
        **(extra_meta or {}),
    }

    def write_meta(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)

    _write_atomic(path / "meta.json", write_meta)
    logger.info("Saved checkpoint to %s", path)
    return path


def _sibling_checkpoints(prefix: str, model_type: str):
    """Every finished checkpoint directory ``{prefix}_{model_type}_step_*``
    (one with its ``meta.json``), as (step, path) sorted by step:
    retention never touches anything this module did not write."""
    base = Path(f"{prefix}_{model_type}_step_0").absolute().parent
    name = Path(f"{prefix}_{model_type}_step_").name
    pat = re.compile(re.escape(name) + r"(\d+)$")
    if not base.exists():
        return []
    out = []
    for p in base.iterdir():
        m = pat.fullmatch(p.name)
        if m and p.is_dir() and (p / "meta.json").exists():
            out.append((int(m.group(1)), p))
    return sorted(out)


def latest_checkpoint(prefix: str, model_type: str) -> Optional[Path]:
    """Newest (highest-step) checkpoint for this prefix and model type, or
    None: what ``--checkpoint auto`` resumes from."""
    ckpts = _sibling_checkpoints(prefix, model_type)
    return ckpts[-1][1] if ckpts else None


def best_checkpoint_path(prefix: str, model_type: str) -> Path:
    return Path(f"{prefix}_{model_type}_best.json").absolute()


def record_best(prefix: str, model_type: str, step: int, mpjpe: float,
                ckpt_path) -> bool:
    """Record the checkpoint as the best by validation MPJPE in a sidecar
    JSON when ``mpjpe`` improves on the recorded one; returns whether it
    did."""
    bp = best_checkpoint_path(prefix, model_type)
    best = None
    if bp.exists():
        try:
            with open(bp) as f:
                best = json.load(f)
        except (OSError, ValueError):
            logger.warning("Unreadable best-checkpoint record %s", bp)
    if best is not None and float(best.get("mpjpe", float("inf"))) <= mpjpe:
        return False
    with open(bp, "w") as f:
        json.dump({"step": int(step), "mpjpe": float(mpjpe),
                   "path": str(Path(ckpt_path).absolute())}, f, indent=2)
    logger.info("New best checkpoint at step %d (MPJPE %.2f mm)", step, mpjpe)
    return True


def apply_retention(prefix: str, model_type: str, keep_last: int) -> None:
    """Delete all but the newest ``keep_last`` checkpoints for this prefix
    and model type; the recorded best is always kept."""
    if keep_last is None or keep_last < 1:
        return
    protect = set()
    bp = best_checkpoint_path(prefix, model_type)
    if bp.exists():
        try:
            with open(bp) as f:
                protect.add(Path(json.load(f)["path"]).absolute())
        except (OSError, ValueError, KeyError):
            logger.warning("Unreadable best-checkpoint record %s", bp)
    for _step, p in _sibling_checkpoints(prefix, model_type)[:-keep_last]:
        if p.absolute() in protect:
            continue
        logger.info("Retention: removing old checkpoint %s", p)
        shutil.rmtree(p, ignore_errors=True)


def load_checkpoint_meta(path) -> Dict:
    with open(Path(path) / "meta.json") as f:
        return json.load(f)


def load_checkpoint(path) -> Tuple[Dict, Dict]:
    """(tree, meta) with every tensor on the CPU."""
    path = Path(path).absolute()
    meta = load_checkpoint_meta(path)
    tree = torch.load(path / "state.pt", map_location="cpu",
                      weights_only=True)
    return tree, meta


def checkpoint_has_ema(path) -> bool:
    """Whether the checkpoint carries EMA weights (memory-mapped: no tensor
    is read)."""
    tree = torch.load(Path(path) / "state.pt", map_location="cpu",
                      weights_only=True, mmap=True)
    return "ema_params" in tree


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]
               ) -> None:
    if set(dst) != set(src):
        raise KeyError(f"EMA entries differ: {sorted(set(dst) ^ set(src))}")
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(src[k])


def restore_train_state(state: TrainState, path) -> Tuple[TrainState, Dict]:
    """Load the checkpoint at ``path`` into ``state`` in place; returns
    ``(state, meta)``.

    The model's parameters and buffers load strictly. The optimizer and
    the scheduler load when they fit the state's; when they do not (a
    changed freeze mask) a warning says that the AdamW moments start
    afresh, as the JAX package's params-only fallback does. The EMA slots
    the state carries are filled: ``ema_batch_stats`` from the checkpoint,
    or, when it has none (a checkpoint of parameters-only EMA), seeded
    from the restored running statistics."""
    tree, meta = load_checkpoint(path)
    # a sharded state keeps this rank's part of each tensor
    model_sd, opt_sd, ema = shard_full_state(
        state, tree["model"], tree["optimizer"], tree.get("ema_params"))
    state.model.load_state_dict(model_sd, strict=True)
    try:
        state.optimizer.load_state_dict(opt_sd)
        if state.scheduler is not None and tree.get("scheduler") is not None:
            state.scheduler.load_state_dict(tree["scheduler"])
    except (ValueError, KeyError):
        logger.warning(
            "Optimizer state of %s does not fit this state; the OPTIMIZER "
            "STATE IS RE-INITIALIZED (fresh AdamW moments). Cause:", path,
            exc_info=True)
    state.step = int(tree["step"])
    if state.ema_params is not None and ema is not None:
        _copy_into(state.ema_params, ema)
        if state.ema_batch_stats is not None:
            _copy_into(state.ema_batch_stats,
                       tree.get("ema_batch_stats")
                       or _cpu(batch_stats(state.model)))
    return state, meta
