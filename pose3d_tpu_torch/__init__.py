"""pose3d_tpu_torch — the PyTorch/CUDA port of ``pose3d_tpu``.

The package mirrors ``pose3d_tpu``'s module paths, so each module's JAX
counterpart sits at the same relative path. It imports ``torch`` and never
``jax`` or ``flax``; the only modules it borrows from the JAX package are
the two host-side ones that load neither (``pose3d_tpu.compat_export`` for
the weight bridge and ``pose3d_tpu.serve_http`` for the HTTP tier).

Ported so far: the transformer lifter's serving path — reference ``.pth``
checkpoint → :func:`pose3d_tpu_torch.checkpoint.load_pose_model` →
:mod:`pose3d_tpu_torch.serve_http` — and its training path —
:mod:`pose3d_tpu_torch.train` (losses, metrics, AdamW, grouped/scan
accumulation, EMA, evaluation, ``train_model``) writing a ``.pth`` the
server loads. Attention runs through hand-written Hopper flash-attention
forward and backward kernels (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``).

Importing the package loads no submodule: import what you need, e.g.
``from pose3d_tpu_torch.models import build_model``.
"""

__version__ = "0.1.0"
