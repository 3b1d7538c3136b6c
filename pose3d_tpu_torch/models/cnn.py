"""CNN lifting model (counterpart of ``pose3d_tpu/models/cnn.py``).

SE / ECA / CoordAttention channel-spatial attention, ConvBnAct,
depthwise-separable convs, MobileNet-style inverted residuals, dual-path
(residual + dense) blocks, a weighted atrous spatial pyramid (WASP),
global feature aggregation and an MLP regression head, assembled stage by
stage as the JAX model is (``compat_export.iter_cnn_stage_blocks``).

Submodules are registered under the reference checkpoint's names
(``conv1.0.conv.weight``, ``stages.2.0.residual_path.1.depthwise.norm.
running_mean``, ``wasp.weights``, ``pose_head.decoder.0.0.weight`` ...), so
a reference ``.pth`` state_dict strict-loads.

Layout: activations are ``[B, H, W, C]`` tensors (NHWC, as in the JAX
package) that are dense in memory. A convolution sees the free NCHW view
of such a tensor, which is PyTorch's ``channels_last`` memory format, and
its output is viewed back; BatchNorm statistics read the free ``[B·H·W,
C]`` view. Compute runs in ``dtype`` (bf16) over fp32 parameters, which are
cast at use; BatchNorm statistics are fp32.

Two BatchNorm numerics, each matched to its JAX counterpart:
:class:`BatchNorm` (flax ``nn.BatchNorm``, ``normalization="batch"``)
normalises in fp32 and casts at the end; :class:`DotStatsBatchNorm`
(``"batch_pallas"``, ``"batch_pallas:N"`` and ``"batch_dot"``) takes Σx
and Σx² from the hand-written ``bn_stats`` kernel or as plain fp32 sums
and normalises in the compute dtype. Both use the biased variance
``max(E[x²] − E[x]², 0)`` for the batch and for the running statistics,
and ``running = 0.9·running + 0.1·batch``. In a data-parallel step both
take their sums over every rank's rows (``sync_group``, set by
``train.ghost_bn.cross_rank_batchnorm``): all-reduced in the forward, and
in the backward Σdy and Σdy·x (``_BatchNormTrain``) or the upstream
gradient of the sums (``DotStatsBatchNorm``) too.

The per-sample normalisations (``normalization`` "instance", "layer" and
"group") are :class:`GroupNorm` with flax ``nn.GroupNorm``'s numerics, and
"identity" has no module; a CNN with these keeps only the coordinate
attention's fixed BatchNorms.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pose3d_tpu_torch.compat_export import iter_cnn_stage_blocks
from pose3d_tpu_torch.core.comm import AllReduceSum, all_reduce_, group_size
from pose3d_tpu_torch.core.config import CNNModelConfig
from pose3d_tpu_torch.models.common import PoseRegressionHead
from pose3d_tpu_torch.models.transformer import HeatmapGrid
from pose3d_tpu_torch.ops.activations import get_activation
from pose3d_tpu_torch.ops.heatmap import gaussian_heatmaps
from pose3d_tpu_torch.ops.kernels.bn_stats import BnStats

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The statistics' dtype: fp32, or x's own when it is wider (a
    float64 model, the parity tests' exact reference)."""
    return torch.promote_types(x.dtype, torch.float32)


def ema_chain(r0: torch.Tensor, increments: torch.Tensor,
              momentum: float) -> torch.Tensor:
    """Closed form of the A-fold sequential chain r_{i+1} = m·r_i + inc_i:

        r_A = m^A·r_0 + Σ_i m^(A−1−i)·inc_i.

    ``increments`` is stacked ``[A, ...]``; the grouped BatchNorm passes
    inc_i = (1−m)·s_i."""
    g = increments.shape[0]
    w = momentum ** torch.arange(g - 1, -1, -1, dtype=r0.dtype,
                                 device=r0.device)
    return (momentum ** g) * r0 \
        + (increments * w.view(g, *[1] * r0.dim())).sum(0)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode forward of :class:`BatchNorm` over ``groups`` groups of
    the leading axis, with a closed-form backward, so that autograd keeps x
    in its own dtype and no fp32 copy of the activation. The reductions
    read x in its own dtype and accumulate in fp32.

    ``apply(x [N, ..., C], weight, bias, groups, out_dtype)`` →
    ``(y, means [G, C], vars [G, C])``; the statistics are fp32 and carry
    no gradient (they feed the running averages)."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups: int, out_dtype, sync=None):
        C = x.shape[-1]
        xg = x.view(groups, -1, C)          # a view: never a copy of x
        n = xg.shape[1]
        f32 = _acc_dtype(x)
        if sync is None:
            mean = xg.sum(1, dtype=f32) / n
            mean2 = torch.linalg.vector_norm(
                xg, dim=1, dtype=f32).square() / n
        else:
            # each group's Σx and Σx² over every rank's rows: one [2, G, C]
            # all-reduce
            sums = all_reduce_(torch.stack([
                xg.sum(1, dtype=f32),
                torch.linalg.vector_norm(xg, dim=1, dtype=f32).square()]),
                sync)
            n *= group_size(sync)
            mean, mean2 = sums[0] / n, sums[1] / n
        raw = mean2 - mean * mean
        var = raw.clamp_min(0.0)
        inv = torch.rsqrt(var + BN_EPS)
        # (x − mean)·(inv·weight) + bias in fp32, cast at the end
        y = torch.addcmul(bias, xg - mean[:, None, :],
                          (inv * weight)[:, None, :])
        ctx.save_for_backward(x, weight, mean, inv, raw > 0)
        ctx.groups, ctx.n, ctx.sync = groups, n, sync
        ctx.mark_non_differentiable(mean, var)
        return y.to(out_dtype).view(x.shape), mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _dmean, _dvar):
        # With x̂ = (x − mean)·inv, db = Σdy and ds = Σdy·x̂ per group:
        #   dx = weight·inv·(dy − db/n − x̂·ds/n) = k·dy + c1·x + c0,
        # per-channel coefficients, so dy and x are read in their own dtype.
        x, weight, mean, inv, positive = ctx.saved_tensors
        C, n = x.shape[-1], ctx.n
        xg = x.view(ctx.groups, -1, C)
        dyg = dy.reshape(ctx.groups, -1, C)
        f32 = _acc_dtype(x)
        db = dyg.sum(1, dtype=f32)                             # [G, C]
        dyx = dyg.to(f32, copy=True).mul_(xg).sum(1)           # Σ dy·x
        ds = (dyx - mean * db) * inv
        # dx reads the sums over every rank's rows (each rank's loss moved
        # the shared statistics); weight and bias keep this rank's part,
        # which the gradient all-reduce adds up
        gdb, gds = db, ds
        if ctx.sync is not None:
            sums = all_reduce_(torch.stack([db, dyx]), ctx.sync)
            gdb, gds = sums[0], (sums[1] - mean * sums[0]) * inv
        k = weight * inv
        # a variance clamped at 0 is a constant: its term drops out
        c1 = -(k * inv * gds * positive) / n
        c0 = -(k * gdb) / n - c1 * mean
        dx = torch.addcmul(c0[:, None, :], dyg, k[:, None, :])
        dx.addcmul_(xg, c1[:, None, :])
        return (dx.to(x.dtype).view(x.shape), ds.sum(0), db.sum(0), None,
                None, None)


class _BatchNormBase(nn.Module):
    """Parameters and buffers under ``torch.nn.BatchNorm2d``'s names (the
    reference ``.pth`` holds them), with the JAX package's arithmetic in
    the subclasses' own forwards. ``num_batches_tracked`` is carried for
    the checkpoint and stays 0, as the JAX exporter writes it."""

    # False while a rematerialised block is recomputed in the backward
    # pass: the block's first run already moved the running statistics.
    track_running_stats = True
    # the process group whose ranks share the batch statistics (set for a
    # data-parallel train step by ``train.ghost_bn.cross_rank_batchnorm``)
    sync_group = None

    def __init__(self, features: int, *, device=None):
        super().__init__()
        self.features = features
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    @torch.no_grad()
    def _update_running(self, means: torch.Tensor, vars_: torch.Tensor):
        """Fold the ``[G, C]`` statistics of G sequential groups into the
        running averages (G = 1: ``0.9·running + 0.1·batch``)."""
        if not self.track_running_stats:
            return
        m = BN_MOMENTUM
        self.running_mean.copy_(
            ema_chain(self.running_mean, (1 - m) * means, m))
        self.running_var.copy_(
            ema_chain(self.running_var, (1 - m) * vars_, m))


class BatchNorm(_BatchNormBase):
    """flax ``nn.BatchNorm`` numerics over the last axis of ``[N, ..., C]``:
    fp32 statistics, ``(x − mean)·rsqrt(var + eps)·weight + bias`` in fp32,
    cast to ``dtype`` at the end.

    ``groups`` > 1 (set for the duration of a grouped train step by
    ``train.ghost_bn.grouped_batchnorm``) computes the statistics and the
    normalisation per group of ``N / groups`` consecutive samples and moves
    the running averages by the closed-form chain of that many sequential
    updates."""

    groups = 1

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if not self.training:
            mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
            return ((x.float() - self.running_mean) * mul
                    + self.bias).to(dtype)
        if x.shape[0] % self.groups:
            raise ValueError(f"grouped BatchNorm: batch {x.shape[0]} not "
                             f"divisible by {self.groups} groups")
        y, means, vars_ = _BatchNormTrain.apply(
            x, self.weight, self.bias, self.groups, dtype, self.sync_group)
        self._update_running(means, vars_)
        return y


class DotStatsBatchNorm(_BatchNormBase):
    """The JAX package's ``DotStatsBatchNorm``: fp32 Σx and Σx² of the
    ``[N·H·W, C]`` view, then mean and ``rsqrt(var + eps)·weight`` cast to
    ``dtype`` and the normalisation done in ``dtype``.

    ``stats_impl``: "auto" launches the Hopper kernel for CUDA tensors and
    runs the plain version for CPU tensors; "reference" runs the plain
    version everywhere. ``"batch_dot"`` is built with "reference": its TPU
    statistics path is a compiler workaround and is not ported. The plain
    sums square x in fp32, so in bf16 they differ from JAX's ``batch_dot``,
    which squares x in bf16 before its fp32 contraction.

    ``min_pixels`` (the N of ``"batch_pallas:N"``): a layer with fewer
    pixels per sample takes the plain sums and launches nothing, as the JAX
    gate does; ``gated`` records that decision at the last train-mode
    forward (None before)."""

    def __init__(self, features: int, *, min_pixels: int = 0,
                 stats_impl: str = "auto", device=None):
        super().__init__(features, device=device)
        if stats_impl not in ("auto", "reference"):
            raise ValueError(f"unknown stats_impl {stats_impl!r}")
        self.min_pixels = min_pixels
        self.stats_impl = stats_impl
        self.gated = None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype)
        if self.training:
            C = x.shape[-1]
            n = x.numel() // C
            self.gated = n // x.shape[0] < self.min_pixels
            launch = (not self.gated and x.is_cuda
                      and self.stats_impl == "auto")
            # a view, never a copy of x
            s1, s2 = BnStats.apply(x.view(n, C), launch)
            if self.sync_group is not None:
                # this rank's [2, C] sums over every rank's rows; the
                # backward all-reduces the upstream ds1, ds2 the same way
                s1, s2 = AllReduceSum.apply(torch.stack([s1, s2]),
                                            self.sync_group)
                n *= group_size(self.sync_group)
            mean = s1 / n
            var = (s2 / n - mean * mean).clamp_min(0.0)
            self._update_running(mean.detach()[None], var.detach()[None])
        else:
            mean, var = self.running_mean, self.running_var
        inv = (torch.rsqrt(var + BN_EPS) * self.weight).to(dtype)
        return (x - mean.to(dtype)) * inv + self.bias.to(dtype)


GN_EPS = 1e-6      # flax nn.GroupNorm's epsilon


class _GroupNormFn(torch.autograd.Function):
    """flax ``nn.GroupNorm`` over ``x [N, ..., C]`` in G groups of C/G
    channels, with a closed-form backward, so that autograd keeps x in its
    own dtype and no fp32 copy of the activation. Per sample and group:
    fp32 mean and E[x²] over the spatial axes and the group's channels,
    ``var = max(E[x²] − mean², 0)`` (flax's ``use_fast_variance``), then
    ``(x − mean)·(rsqrt(var + 1e-6)·weight) + bias`` in fp32, cast to
    ``out_dtype``.

    ``apply(x, weight, bias, groups, out_dtype)`` → y of x's shape."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups: int, out_dtype):
        N, C = x.shape[0], x.shape[-1]
        xg = x.view(N, -1, groups, C // groups)   # a view: never a copy
        m = xg.shape[1] * xg.shape[3]
        f32 = _acc_dtype(x)
        mean = xg.sum((1, 3), dtype=f32) / m                     # [N, G]
        mean2 = torch.linalg.vector_norm(
            xg, dim=(1, 3), dtype=f32).square() / m
        raw = mean2 - mean * mean
        inv = torch.rsqrt(raw.clamp_min(0.0) + GN_EPS)           # [N, G]
        w = weight.view(groups, C // groups)
        k = inv[:, None, :, None] * w                     # [N, 1, G, C/G]
        y = torch.addcmul(bias.view(groups, C // groups),
                          xg - mean[:, None, :, None], k)
        ctx.save_for_backward(x, weight, mean, inv, raw > 0)
        ctx.groups, ctx.m = groups, m
        return y.to(out_dtype).view(x.shape)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        # With x̂ = (x − mean)·inv and a = weight·dy, per sample and group:
        #   dx = inv·a − inv·Σa/m − x̂·inv·Σ(a·x̂)/m = k·dy + c1·x + c0,
        # k = inv·weight per channel, c1 and c0 per sample and group, so
        # dy and x are read in their own dtype.
        x, weight, mean, inv, positive = ctx.saved_tensors
        G, m = ctx.groups, ctx.m
        N, C = x.shape[0], x.shape[-1]
        f32 = _acc_dtype(x)
        xg = x.view(N, -1, G, C // G)
        dyg = dy.reshape(N, -1, G, C // G)
        w = weight.view(G, C // G)
        sdy = dyg.sum(1, dtype=f32)                              # [N, G, C/G]
        sdyx = dyg.to(f32, copy=True).mul_(xg).sum(1)            # Σ dy·x
        a1 = (sdy * w).sum(-1)                                   # Σ a
        a2 = (sdyx * w).sum(-1)                                  # Σ a·x
        sax = (a2 - mean * a1) * inv                             # Σ a·x̂
        # a variance clamped at 0 is a constant: its term drops out
        c1 = -(inv * inv * sax * positive) / m
        c0 = -(inv * a1) / m - c1 * mean
        k = inv[:, None, :, None] * w
        dx = torch.addcmul(c0[:, None, :, None], dyg, k)
        dx.addcmul_(xg, c1[:, None, :, None])
        dw = ((sdyx - mean[..., None] * sdy) * inv[..., None]).sum(0)
        return (dx.to(x.dtype).view(x.shape), dw.reshape(C),
                sdy.sum(0).reshape(C), None, None)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` (epsilon 1e-6, fast variance, fp32 statistics
    and affine, output in the compute dtype) over the last axis of a dense
    ``[N, ..., C]`` tensor, in ``groups`` groups; the same arithmetic in
    train and eval mode. Parameters under ``torch.nn.GroupNorm``'s names
    (``weight``, ``bias``)."""

    def __init__(self, features: int, groups: int, *, device=None):
        super().__init__()
        if groups <= 0 or features % groups:
            raise ValueError(f"Number of groups ({groups}) does not divide "
                             f"the number of channels ({features}).")
        self.features = features
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _GroupNormFn.apply(x, self.weight, self.bias, self.groups,
                                  dtype)


class Identity(nn.Module):
    """``normalization="identity"``: no parameters, x in ``dtype``."""

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return x.to(dtype)


def _norm(name: str, features: int, *, stats_impl: str = "auto", device=None):
    """Normalisation factory. Ported: "batch", "batch_dot", "batch_pallas",
    "batch_pallas:N", and the JAX factory's "identity", "instance" (one
    group a channel: what the JAX factory means by ``group_size=1``, which
    the installed flax refuses to build), "layer" (one group) and "group"
    (``min(32, C)`` groups); any other name raises (the JAX factory's
    fallthrough to BatchNorm would hide a typo)."""
    if name == "identity":
        return Identity()
    if name in ("instance", "layer", "group"):
        groups = {"instance": features, "layer": 1,
                  "group": min(32, features)}[name]
        return GroupNorm(features, groups, device=device)
    if name == "batch":
        return BatchNorm(features, device=device)
    if name == "batch_dot":
        return DotStatsBatchNorm(features, stats_impl="reference",
                                 device=device)
    if name == "batch_pallas" or name.startswith("batch_pallas:"):
        min_pixels = int(name.split(":")[1]) if ":" in name else 0
        return DotStatsBatchNorm(features, min_pixels=min_pixels,
                                 stats_impl=stats_impl, device=device)
    raise NotImplementedError(
        f"normalization {name!r} is not ported (ported: batch, batch_dot, "
        "batch_pallas, batch_pallas:N, identity, instance, layer, group)")


def _conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """``conv`` on an NHWC activation in ``dtype`` (weights cast at use):
    the NCHW view of a dense NHWC tensor is channels_last, and so is the
    output, whose NHWC view is dense again. Nothing here copies: should a
    backend hand back another layout, the BatchNorm that follows raises on
    its ``view`` instead of paying for a hidden copy of the activation."""
    w = conv.weight.to(dtype=dtype, memory_format=torch.channels_last)
    b = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w, b, conv.stride,
                 conv.padding, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1)


def _pointwise(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """A 1×1 ``conv`` (weight ``[O, I, 1, 1]``) over the last axis of any
    ``[..., I]`` tensor, as a matrix product."""
    b = None if conv.bias is None else conv.bias.to(dtype)
    return F.linear(x.to(dtype), conv.weight.to(dtype).flatten(1), b)


class ConvBnAct(nn.Module):
    """Conv → norm → activation, padding ``(k − 1)//2 · dilation`` on both
    sides, no conv bias."""

    def __init__(self, c_in: int, features: int, kernel_size: int = 3,
                 stride: int = 1, *, groups: int = 1, dilation: int = 1,
                 activation: Optional[str] = "silu",
                 normalization: str = "batch", stats_impl: str = "auto",
                 device=None):
        super().__init__()
        pad = (kernel_size - 1) // 2 * dilation
        self.conv = nn.Conv2d(c_in, features, kernel_size, stride, pad,
                              dilation, groups, bias=False, device=device)
        self.norm = _norm(normalization, features, stats_impl=stats_impl,
                          device=device)
        self.act = get_activation(activation) if activation else None

    def forward(self, x, dtype):
        x = self.norm(_conv2d(x, self.conv, dtype), dtype)
        return self.act(x) if self.act else x


class SEBlock(nn.Module):
    """Squeeze-and-Excitation: pooled descriptor → bias-free Linear →
    activation → bias-free Linear → sigmoid gate (``fc.0``, ``fc.2``)."""

    def __init__(self, channels: int, reduction: int = 16,
                 activation: str = "silu", *, device=None):
        super().__init__()
        mid = max(1, channels // reduction)
        self.fc = nn.ModuleDict({
            "0": nn.Linear(channels, mid, bias=False, device=device),
            "2": nn.Linear(mid, channels, bias=False, device=device),
        })
        self.act = get_activation(activation)

    def forward(self, x, dtype):
        y = x.mean(dim=(1, 2))                                   # [B, C]
        y = self.act(F.linear(y, self.fc["0"].weight.to(dtype)))
        y = torch.sigmoid(F.linear(y, self.fc["2"].weight.to(dtype)))
        return x * y[:, None, None, :]


class ECABlock(nn.Module):
    """Efficient Channel Attention: a bias-free 1-D conv along the channel
    axis of the pooled descriptor, kernel size adapted to C."""

    def __init__(self, channels: int, gamma: int = 2, b: int = 1, *,
                 device=None):
        super().__init__()
        t = int(abs(math.log2(channels) + b) / gamma)
        k = t if t % 2 else t + 1
        self.conv = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False,
                              device=device)

    def forward(self, x, dtype):
        y = x.mean(dim=(1, 2))[:, None, :]                    # [B, 1, C]
        y = F.conv1d(y, self.conv.weight.to(dtype),
                     padding=self.conv.padding)
        return x * torch.sigmoid(y[:, 0])[:, None, None, :]


class CoordAttention(nn.Module):
    """Coordinate attention: H and W pooled separately, a shared 1×1
    bottleneck with BatchNorm (always the plain flavour) and SiLU, one
    sigmoid gate per axis."""

    def __init__(self, channels: int, out_features: int,
                 reduction: int = 32, *, device=None):
        super().__init__()
        mid = max(8, channels // reduction)
        self.conv1 = nn.Conv2d(channels, mid, 1, device=device)
        self.bn1 = BatchNorm(mid, device=device)
        self.conv_h = nn.Conv2d(mid, out_features, 1, device=device)
        self.conv_w = nn.Conv2d(mid, out_features, 1, device=device)

    def forward(self, x, dtype):
        H = x.shape[1]
        y = torch.cat([x.mean(dim=2), x.mean(dim=1)], dim=1)  # [B, H+W, C]
        y = F.silu(self.bn1(_pointwise(y, self.conv1, dtype), dtype))
        a_h = torch.sigmoid(_pointwise(y[:, :H], self.conv_h, dtype))
        a_w = torch.sigmoid(_pointwise(y[:, H:], self.conv_w, dtype))
        return x * a_h[:, :, None, :] * a_w[:, None, :, :]


def _attention_block(attention_type, channels, se_reduction, activation,
                     device):
    if attention_type == "se":
        return SEBlock(channels, se_reduction, activation, device=device)
    if attention_type == "eca":
        return ECABlock(channels, device=device)
    if attention_type == "coord":
        return CoordAttention(channels, channels, device=device)
    return None


class DepthwiseSeparableConv(nn.Module):
    """Depthwise + pointwise ConvBnAct pair."""

    def __init__(self, c_in: int, features: int, kernel_size: int = 3,
                 stride: int = 1, **kw):
        super().__init__()
        self.depthwise = ConvBnAct(c_in, c_in, kernel_size, stride,
                                   groups=c_in, **kw)
        self.pointwise = ConvBnAct(c_in, features, 1, 1, **kw)

    def forward(self, x, dtype):
        return self.pointwise(self.depthwise(x, dtype), dtype)


class InvertedResidual(nn.Module):
    """MobileNet-style inverted residual: ``conv`` holds, at the reference
    Sequential's indices, [expand 1×1 when expand_ratio != 1,] depthwise
    3×3, the attention block, the projection 1×1 (no activation)."""

    def __init__(self, c_in: int, features: int, stride: int = 1,
                 expand_ratio: int = 6, *, use_se: bool = True,
                 se_reduction: int = 16, activation: str = "silu",
                 residual_scale: float = 1.0,
                 attention_type: Optional[str] = None, device=None, **kw):
        super().__init__()
        self.use_residual = c_in == features and stride == 1
        self.residual_scale = residual_scale
        hidden = int(c_in * expand_ratio)
        kw = dict(activation=activation, device=device, **kw)
        if attention_type is None and use_se:
            attention_type = "se"
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBnAct(c_in, hidden, 1, **kw))
        layers.append(ConvBnAct(hidden, hidden, 3, stride, groups=hidden,
                                **kw))
        layers.append(_attention_block(attention_type, hidden, se_reduction,
                                       activation, device))
        layers.append(ConvBnAct(hidden, features, 1,
                                **{**kw, "activation": None}))
        self.conv = nn.ModuleDict({str(i): m for i, m in enumerate(layers)
                                   if m is not None})

    def forward(self, x, dtype):
        y = x
        for layer in self.conv.values():
            y = layer(y, dtype)
        return x + y * self.residual_scale if self.use_residual else y


class DualPathBlock(nn.Module):
    """Residual + dense dual-path block with concat fusion; registration
    order residual_path, dense_path, attention, fusion, shortcut."""

    def __init__(self, c_in: int, features: int, stride: int = 1, *,
                 activation: str = "silu", residual_scale: float = 1.0,
                 attention_type: Optional[str] = None, device=None, **kw):
        super().__init__()
        self.residual_scale = residual_scale
        kw = dict(activation=activation, device=device, **kw)
        no_act = {**kw, "activation": None}
        dense_c = features // 2
        self.residual_path = nn.ModuleDict({
            "0": ConvBnAct(c_in, features, 1, **kw),
            "1": DepthwiseSeparableConv(features, features, stride=stride,
                                        **kw),
            "2": ConvBnAct(features, features, 1, **no_act),
        })
        self.dense_path = nn.ModuleDict({
            "0": ConvBnAct(c_in, dense_c, 1, **kw),
            "1": DepthwiseSeparableConv(dense_c, dense_c, stride=stride,
                                        **kw),
        })
        att = _attention_block(attention_type, features, 16, activation,
                               device)
        if att is not None:
            self.attention = att
        self.fusion = ConvBnAct(features + dense_c, features, 1, **kw)
        if stride != 1 or c_in != features:
            self.shortcut = ConvBnAct(c_in, features, 1, stride, **no_act)

    def forward(self, x, dtype):
        res = x
        for layer in self.residual_path.values():
            res = layer(res, dtype)
        dense = x
        for layer in self.dense_path.values():
            dense = layer(dense, dtype)
        sc = self.shortcut(x, dtype) if hasattr(self, "shortcut") else x
        res = res + sc * self.residual_scale
        out = self.fusion(torch.cat([res, dense], dim=-1), dtype)
        return self.attention(out, dtype) if hasattr(self, "attention") \
            else out


class WASPModule(nn.Module):
    """Weighted Atrous Spatial Pyramid: a 1×1 branch, dilated 3×3 branches
    and a global-context branch, summed with softmax-learned ``weights``,
    then a 1×1 fusion."""

    def __init__(self, c_in: int, features: int,
                 dilations: Sequence[int] = (1, 6, 12, 18), **kw):
        super().__init__()
        device = kw.get("device")
        n = len(dilations) + 2
        self.weights = nn.Parameter(torch.full((n,), 1.0 / n, device=device))
        self.conv1x1 = ConvBnAct(c_in, features, 1, **kw)
        self.atrous_branches = nn.ModuleList(
            ConvBnAct(c_in, features, 3, dilation=d, **kw)
            for d in dilations)
        # index 1 of the reference's Sequential[pool, ConvBnAct]
        self.global_branch = nn.ModuleDict(
            {"1": ConvBnAct(c_in, features, 1, **kw)})
        self.fusion = ConvBnAct(features, features, 1, **kw)

    def forward(self, x, dtype):
        w = torch.softmax(self.weights.to(_acc_dtype(self.weights)),
                          dim=0).to(dtype)
        out = self.conv1x1(x, dtype) * w[0]
        for i, branch in enumerate(self.atrous_branches):
            out = out + branch(x, dtype) * w[i + 1]
        g = x.mean(dim=(1, 2), keepdim=True)                # [B, 1, 1, C]
        out = out + self.global_branch["1"](g, dtype) * w[-1]
        return self.fusion(out, dtype)


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """NHWC adaptive average pooling to (out_size, out_size): an exact
    reshape-mean when the size divides, else ``AdaptiveAvgPool2d``'s bin
    boundaries (start = floor(i·H/O), end = ceil((i+1)·H/O))."""
    B, H, W, C = x.shape
    if H % out_size == 0 and W % out_size == 0:
        kh, kw = H // out_size, W // out_size
        return x.reshape(B, out_size, kh, out_size, kw, C).mean(dim=(2, 4))
    rows = []
    for i in range(out_size):
        h0, h1 = (i * H) // out_size, -(-((i + 1) * H) // out_size)
        cols = []
        for j in range(out_size):
            w0, w1 = (j * W) // out_size, -(-((j + 1) * W) // out_size)
            cols.append(x[:, h0:h1, w0:w1, :].mean(dim=(1, 2)))
        rows.append(torch.stack(cols, dim=1))
    return torch.stack(rows, dim=1)


class CNNPoseEstimation(nn.Module):
    """forward(image [B,H,W,3], depth [B,H,W,1], keypoints_2d [B,J,2],
    generator=None) → joints_3d [B,J,3] fp32.

    ``dtype`` is the compute dtype. ``stats_impl`` reaches every
    :class:`DotStatsBatchNorm` ("auto": the ``bn_stats`` kernel on CUDA,
    the plain version on CPU; "reference": the plain version everywhere).
    ``remat`` recomputes each backbone block and the WASP module in the
    backward pass (``torch.utils.checkpoint``) instead of keeping their
    activations; a runtime knob, not stored in ``model_args``. In train
    mode with dropout above 0, ``generator`` (on the model's device) is
    required and draws the head's dropout masks."""

    def __init__(self, config: CNNModelConfig, *, dtype=torch.bfloat16,
                 stats_impl: str = "auto", remat: bool = False, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.remat = remat
        kw = dict(activation=cfg.activation,
                  normalization=cfg.normalization, stats_impl=stats_impl,
                  device=device)
        c0 = cfg.initial_channels
        self.conv1 = nn.ModuleList([
            ConvBnAct(cfg.in_channels, c0, cfg.initial_kernel_size,
                      cfg.initial_stride, **kw),
            ConvBnAct(c0, c0, 3, 1, **kw),
        ])
        self.heatmap_generator = HeatmapGrid(cfg.heatmap_size, device=device)
        self.stages = nn.ModuleList(
            nn.ModuleList() for _ in cfg.stage_channels)
        for prefix, _, is_dual, att, expand, _, stride, block_in \
                in iter_cnn_stage_blocks(cfg):
            i = int(prefix.split(".")[1])
            out_c = cfg.stage_channels[i]
            if is_dual:
                block = DualPathBlock(
                    block_in, out_c, stride,
                    residual_scale=cfg.residual_scale, attention_type=att,
                    **kw)
            else:
                block = InvertedResidual(
                    block_in, out_c, stride, expand,
                    use_se=cfg.use_se_blocks, se_reduction=cfg.se_reduction,
                    residual_scale=cfg.residual_scale, attention_type=att,
                    **kw)
            self.stages[i].append(block)
        c_last = cfg.stage_channels[-1]
        self.wasp = WASPModule(c_last, c_last, **kw)
        # indices 1 and 2 of the reference's Sequential[pool, ConvBnAct,
        # ECA, pool]
        self.global_features = nn.ModuleDict({
            "1": ConvBnAct(c_last, cfg.global_feature_dim, 1, **kw),
            "2": ECABlock(cfg.global_feature_dim, device=device),
        })
        self.pose_head = PoseRegressionHead(
            cfg.global_feature_dim, cfg.num_joints, cfg.regression_dims,
            cfg.activation, dropout=cfg.regression_dropout, nested=True,
            device=device)

    def _block(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            return block(x, self.dtype)
        norms = [m for m in block.modules() if isinstance(m, _BatchNormBase)]
        runs = 0

        def run(x):
            nonlocal runs
            runs += 1
            for m in norms:          # only the first run moves the statistics
                m.track_running_stats = runs == 1
            try:
                return block(x, self.dtype)
            finally:
                for m in norms:
                    m.track_running_stats = True
        return checkpoint(run, x, use_reentrant=False)

    def forward(self, image, depth, keypoints_2d, *,
                generator: Optional[torch.Generator] = None):
        cfg, dt = self.config, self.dtype
        gen = generator if self.training else None
        if self.training and gen is None and cfg.regression_dropout:
            raise ValueError(
                "train mode with dropout needs a torch.Generator: pass "
                "forward(..., generator=torch.Generator(device))")
        heatmaps = gaussian_heatmaps(keypoints_2d, cfg.heatmap_size,
                                     cfg.heatmap_sigma, dtype=dt)
        x = torch.cat([image.to(dt), depth.to(dt), heatmaps], dim=-1)
        for layer in self.conv1:
            x = layer(x, dt)
        for stage in self.stages:
            for block in stage:
                x = self._block(block, x)
        x = self._block(self.wasp, x)
        x = adaptive_avg_pool(x, cfg.global_pool_size)
        x = self.global_features["1"](x, dt)
        x = self.global_features["2"](x, dt)
        return self.pose_head(x.mean(dim=(1, 2)), dt, gen)
