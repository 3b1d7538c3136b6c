"""pose3d_tpu_torch — the PyTorch/CUDA port of ``pose3d_tpu``.

The package mirrors ``pose3d_tpu``'s module paths, so each module's JAX
counterpart sits at the same relative path. It imports ``torch`` and never
``jax``, ``flax`` or any module of ``pose3d_tpu``: what it needs from a
host-side module there (the weight bridge's key walk, the HTTP batching
tier) it keeps as its own copy (:mod:`pose3d_tpu_torch.compat_export`,
:mod:`pose3d_tpu_torch.serve_http`).

Ported: everything the JAX package does, module for module, except
what ROADMAP.md lists as not to port. Both lifters (transformer and CNN)
are served — reference ``.pth`` checkpoint →
:func:`pose3d_tpu_torch.checkpoint.load_pose_model` →
:mod:`pose3d_tpu_torch.serve_http` — and trained —
:mod:`pose3d_tpu_torch.train` (losses, metrics, AdamW, grouped/scan
accumulation with grouped BatchNorm, EMA of weights and BatchNorm
statistics, evaluation, ``train_model`` with a device prefetch,
checkpoints and resume) writing a ``.pth`` the server loads, from the
shell too: :mod:`pose3d_tpu_torch.cli.main` trains on chunk files
(:mod:`pose3d_tpu_torch.data`: the chunk stores, the native decoder built
from ``native/*.cc``, the streaming pipeline, host augmentation with
``--augment``; device augmentation with ``--augment-device``) and
:mod:`pose3d_tpu_torch.cli.evaluate` evaluates; the dataset tools
(``cli.chunker``, ``cli.split``, ``cli.rechunker``) write the chunk
archives from a preprocessed Human3.6M layout; stage 1
(:mod:`pose3d_tpu_torch.stage1`: YOLO11-pose and DepthPro with their
weight loaders) runs in ``cli.preprocess``, ``cli.infer`` and pipeline
serving; ``cli.export`` writes a ``torch.export`` program
(:mod:`pose3d_tpu_torch.serve`, optionally int8) that ``serve_http
--artifact`` serves, and ``cli.convert`` turns a ``.pth`` into a training
checkpoint and back; :mod:`pose3d_tpu_torch.parallel` holds data, FSDP,
tensor, sequence and pipeline parallelism over ``torch.distributed``;
``cli.doctor`` checks a machine. Every Pallas kernel of the JAX package
has a hand-written Hopper counterpart under ``csrc/``
(:mod:`pose3d_tpu_torch.ops.kernels`): the flash-attention forward (also
as the custom operator ``pose3d_torch::flash_attention_fwd``) and
backward, ``bn_stats``, ``lane_resample``, the ``layer_norm`` forward and
backward and the fused ``mlp_block`` forward and backward, each taking
the shapes its TPU kernel takes.

Importing the package loads no submodule: import what you need, e.g.
``from pose3d_tpu_torch.models import build_model``. The subpackages
re-export the names their JAX counterparts' ``__init__`` export (``from
pose3d_tpu_torch.train import create_train_state``), each loaded at its
first use, so that importing a package loads none of its modules (and so
no OpenCV, matplotlib, PIL or TensorBoard).
"""

import importlib as _importlib

__version__ = "0.1.0"


def lazy_exports(package: str, exports: dict):
    """``(__getattr__, __all__)`` for a package that re-exports ``exports``
    (name → submodule) and imports the submodule when a name is first
    read."""

    def __getattr__(name):
        if name not in exports:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        module = _importlib.import_module(f"{package}.{exports[name]}")
        return getattr(module, name)

    return __getattr__, sorted(exports)
