"""pose3d_tpu_torch — the PyTorch/CUDA port of ``pose3d_tpu``.

The package mirrors ``pose3d_tpu``'s module paths, so each module's JAX
counterpart sits at the same relative path. It imports ``torch`` and never
``jax``, ``flax`` or any module of ``pose3d_tpu``: what it needs from a
host-side module there (the weight bridge's key walk, the HTTP batching
tier) it keeps as its own copy (:mod:`pose3d_tpu_torch.compat_export`,
:mod:`pose3d_tpu_torch.serve_http`).

Ported so far: both lifters (transformer and CNN), served — reference
``.pth`` checkpoint → :func:`pose3d_tpu_torch.checkpoint.load_pose_model` →
:mod:`pose3d_tpu_torch.serve_http` — and trained —
:mod:`pose3d_tpu_torch.train` (losses, metrics, AdamW, grouped/scan
accumulation with grouped BatchNorm, EMA of weights and BatchNorm
statistics, evaluation, ``train_model`` with a device prefetch,
checkpoints and resume) writing a ``.pth`` the server loads, from the
shell too: :mod:`pose3d_tpu_torch.cli.main` trains on chunk files
(:mod:`pose3d_tpu_torch.data`: the chunk stores, the native decoder built
from ``native/*.cc``, the streaming pipeline, host augmentation with
``--augment``) and :mod:`pose3d_tpu_torch.cli.evaluate` evaluates; the
dataset tools (``cli.chunker``, ``cli.split``, ``cli.rechunker``) write the
chunk archives from a preprocessed Human3.6M layout; ``cli.infer`` lifts
images with cached stage-1 artifacts (:mod:`pose3d_tpu_torch.stage1`),
``cli.export`` writes a ``torch.export`` program (:mod:`pose3d_tpu_torch.
serve`, optionally int8) that ``serve_http --artifact`` serves, and
``cli.convert`` turns a ``.pth`` into a training checkpoint and back.
Attention runs through hand-written Hopper flash-attention forward and
backward kernels (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``; the forward as the custom operator
``pose3d_torch::flash_attention_fwd``); the CNN's ``normalization=
"batch_pallas"`` BatchNorm takes its statistics from the hand-written
``csrc/bn_stats.cu``.

Importing the package loads no submodule: import what you need, e.g.
``from pose3d_tpu_torch.models import build_model``.
"""

__version__ = "0.1.0"
